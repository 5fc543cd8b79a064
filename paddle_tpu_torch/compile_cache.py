"""Program fingerprints, the capture identity and the process-global entry
cache (counterpart of ``paddle_tpu/compile_cache.py``).

* ``program_fingerprint``: the JAX package's structural digest (sha1 over
  ``Program.to_json()``, a repr walk where an attr does not serialize,
  and the AMP policy's repr), memoized on the program per ``(_version,
  AMP policy)``.  Step records, spans, program profiles and the tuner's
  decision tables all key a program by it
  (``monitor.program_profile.program_fingerprint`` delegates here), and a
  program without an AMP policy gets the JAX package's digest.
* ``trace_flag_values``: what decides how a captured step computes
  besides its program and feeds: the AMP policy, the guardian's skip
  guard, the health probe and ``autotune.trace_token()`` (the kernel
  rulings).  Every executor entry is keyed by it, so a ruling installed
  between two runs sends the next run to a new entry, which captures once,
  instead of replaying a graph captured with the other arm.
* ``lookup`` / ``store`` / ``stats`` / ``reset_stats`` / ``clear``: the
  part of an executor entry that does not depend on its scope's tensors
  (the analysis: state, write-back, live ops, releases, segment plan),
  keyed by ``trace_key``.  A second ``Executor`` over the same program and
  signature takes it from here and skips ``executor/analyze``.  The CUDA
  graphs stay with each executor and scope, whose buffers they are bound
  to.  Every lookup marks ``compile_cache/hit`` or ``compile_cache/miss``.
* ``enable_persistent_cache(dir)`` (``FLAGS_compile_cache_dir``): the
  port's compiled artifacts are the kernel libraries, so ``ops/cuda/
  build.py`` builds into and loads from ``dir``, each library still named
  by its source digest; a second process with the same directory builds
  nothing.  ``rescope_persistent_cache(world_size)`` scopes ``world_dir()``
  to the world's shape and leaves the libraries shared.
"""

import collections
import hashlib
import os
import threading

__all__ = [
    "program_fingerprint", "trace_key", "trace_flag_values", "lookup",
    "store", "stats", "reset_stats", "clear", "enable_persistent_cache",
    "rescope_persistent_cache", "world_dir",
]


def trace_flag_values(program=None):
    """The capture identity besides the program's structure and the feeds
    (see the module docstring); with ``program``, its AMP policy leads.
    Read on every executor run."""
    if not _MODS:
        # imported at the first run, not with this module: flags imports
        # it while the package loads
        from . import autotune, guardian
        from .monitor import health

        _MODS.extend((autotune, guardian, health))
    autotune, guardian, health = _MODS
    return (None if program is None else program._amp_policy,
            guardian.skip_guard_enabled(), health._ENABLED,
            autotune.trace_token())


_MODS = []


_mu = threading.Lock()
# an LRU of analyses: each is a few lists of names a program
_MAX_ENTRIES = 256
_CACHE = collections.OrderedDict()
_STATS = {"trace_hits": 0, "trace_misses": 0, "lowerings": 0}
# analyses stored per short fingerprint: a churning program shows by name
_LOWERINGS_BY_FP = {}
_persistent_dir = [None]
_persistent_base = [None]
_world_dir = [None]


# ---------------------------------------------------------------------------
# program fingerprint
# ---------------------------------------------------------------------------

def program_fingerprint(program):
    """Structural sha1 of ``program`` (see the module docstring), the JAX
    package's algorithm."""
    amp = getattr(program, "_amp_policy", None)
    memo_key = (program._version, None if amp is None else repr(amp))
    cached = getattr(program, "_fp_cache", None)
    if cached is not None and cached[0] == memo_key:
        return cached[1]
    h = hashlib.sha1()
    try:
        h.update(program.to_json().encode())
    except (TypeError, ValueError):
        # an attr that does not serialize: its repr, stable in a process
        for blk in program.blocks:
            for op in blk.ops:
                h.update(repr((op.type, sorted(op.inputs.items()),
                               sorted(op.outputs.items()),
                               sorted((k, repr(v))
                                      for k, v in op.attrs.items()))
                              ).encode())
            for n, v in blk.vars.items():
                h.update(repr((n, v.shape, str(v.dtype), v.persistable,
                               v.lod_level)).encode())
        h.update(repr(program.random_seed).encode())
    if amp is not None:
        h.update(repr(amp).encode())
    fp = h.hexdigest()
    program._fp_cache = (memo_key, fp)
    return fp


def trace_key(program, feed_sig, state_sig, fetch_names, *extras):
    """The cache key of an entry's analysis: the fingerprint, the feed
    signature, the state names, the fetch names and the caller's
    ``extras`` (whether it captures, ``trace_flag_values``)."""
    return (program_fingerprint(program), tuple(feed_sig),
            tuple(state_sig), tuple(fetch_names)) + tuple(extras)


# ---------------------------------------------------------------------------
# the entry cache
# ---------------------------------------------------------------------------

def _mark(name):
    from .profiler import mark_event

    mark_event(name)


def lookup(key):
    with _mu:
        entry = _CACHE.get(key)
        if entry is not None:
            _CACHE.move_to_end(key)
            _STATS["trace_hits"] += 1
        else:
            _STATS["trace_misses"] += 1
    _mark("compile_cache/hit" if entry is not None else "compile_cache/miss")
    return entry


def store(key, entry):
    with _mu:
        _STATS["lowerings"] += 1
        if key and isinstance(key[0], str):
            fp12 = key[0][:12]
            _LOWERINGS_BY_FP[fp12] = _LOWERINGS_BY_FP.get(fp12, 0) + 1
        _CACHE[key] = entry
        _CACHE.move_to_end(key)
        while len(_CACHE) > _MAX_ENTRIES:
            _CACHE.popitem(last=False)
    return entry


def stats():
    """Counters since the start or ``reset_stats``: hits, misses, the
    analyses stored (``lowerings``, the JAX name) in all and by program,
    ``hit_ratio``, the cached entries and the persistent directory."""
    with _mu:
        out = dict(_STATS)
        out["lowerings_by_program"] = dict(_LOWERINGS_BY_FP)
        out["entries"] = len(_CACHE)
    lookups = out["trace_hits"] + out["trace_misses"]
    out["hit_ratio"] = round(out["trace_hits"] / lookups, 4) if lookups \
        else 0.0
    out["persistent_dir"] = _persistent_dir[0]
    return out


def reset_stats():
    with _mu:
        for k in _STATS:
            _STATS[k] = 0
        _LOWERINGS_BY_FP.clear()


def clear():
    """Drop every cached analysis."""
    with _mu:
        _CACHE.clear()


# ---------------------------------------------------------------------------
# the persistent kernel libraries
# ---------------------------------------------------------------------------

def persistent_dir():
    """The directory the kernel libraries build into, or None (the
    package's own ``_build``)."""
    return _persistent_dir[0]


def world_dir():
    """The world-scoped subdirectory of the persistent cache
    (``<dir>/world_<N>`` in a world of N > 1 processes, the base directory
    in a process of its own; None without a persistent cache): where what
    depends on the world's shape would go, as the JAX package keeps its
    N-process executables apart."""
    return _world_dir[0]


def rescope_persistent_cache(world_size=1):
    """Scope the persistent cache to a world of ``world_size`` processes
    (``parallel.distributed.init_distributed`` calls it once the world is
    joined): ``world_dir()`` becomes ``<dir>/world_<N>`` for N > 1, as in
    the JAX package.  The kernel libraries stay in the base directory,
    shared by every world shape: a library is a function of its source
    digest alone, never of the world it runs in."""
    base = _persistent_base[0]
    if base:
        enable_persistent_cache(base)
        if int(world_size) > 1:
            _world_dir[0] = os.path.join(base, "world_%d" % int(world_size))


def enable_persistent_cache(cache_dir):
    """Build the kernel libraries into ``cache_dir`` and load them from
    there (empty or None: the package's ``_build``).  A library is named
    by its source digest, so another process with the same directory
    loads it and builds nothing."""
    cache_dir = os.path.abspath(cache_dir) if cache_dir else None
    _persistent_base[0] = cache_dir
    _persistent_dir[0] = cache_dir
    _world_dir[0] = cache_dir
