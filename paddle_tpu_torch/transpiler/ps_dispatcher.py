"""Parameter-placement dispatchers (counterpart of
``paddle_tpu/transpiler/ps_dispatcher.py``, copied; reference
``python/paddle/fluid/transpiler/ps_dispatcher.py:1``: RoundRobin /
HashName decide which pserver endpoint owns each sliced param block).

Role in the mesh runtime: there is no server process — the "endpoints" are the
shard owners of the ZeRO/kReduce plan (dp ranks, or literal endpoint
strings passed for API parity), and the dispatcher decides which owner
each ``slice_variable`` block lands on.  ``DistributeTranspiler``
consults ``config.split_method`` and exposes the result as
``placement()`` for transpiler-inspection tests.

``HashName`` hashes with crc32, not the builtin ``hash``: Python 3
salts string hashes per process, which would scatter the same program's
params differently on every trainer — a silent divergence the reference
(Python 2 era) never had to consider.
"""

import zlib

__all__ = ["PSDispatcher", "RoundRobin", "HashName"]


class PSDispatcher(object):
    """Base: holds the endpoint list; subclasses implement dispatch()."""

    def __init__(self, pserver_endpoints):
        self._eps = list(pserver_endpoints)
        self._step = 0

    @property
    def eps(self):
        return self._eps

    def reset(self):
        self._step = 0

    def dispatch(self, varlist):
        """Map each var/block in ``varlist`` to an endpoint; returns a
        list of endpoints aligned with ``varlist``."""
        raise NotImplementedError("use RoundRobin or HashName")


class RoundRobin(PSDispatcher):
    """Cycle through endpoints in order (reference ps_dispatcher.py
    RoundRobin) — balanced block counts regardless of names."""

    def dispatch(self, varlist):
        out = []
        for _ in varlist:
            out.append(self._eps[self._step % len(self._eps)])
            self._step += 1
        return out


class HashName(PSDispatcher):
    """Stable name-hash placement (reference ps_dispatcher.py HashName):
    the same var name always lands on the same endpoint, so a var can be
    located without a directory — at the cost of balance."""

    def _hash_block(self, name):
        return zlib.crc32(str(name).encode("utf-8")) % len(self._eps)

    def dispatch(self, varlist):
        return [self._eps[self._hash_block(getattr(v, "name", v))]
                for v in varlist]
