"""The device mesh (counterpart of ``paddle_tpu/parallel/mesh.py``).

The JAX package names the axes of a ``jax.sharding.Mesh`` over the devices
one process drives.  The port runs one process a device, under the world
``distributed.init_distributed`` joins, so a :class:`Mesh` here is a plain
description — axis names, shape, and the world ranks laid out on it in
row-major order — that needs no world to exist: ``SpecLayout.resolve``
and the transpiler read it in any process.  Its process groups (one for
each tuple of axes, the ranks that differ only along those axes) are made
from the world the first time a plan asks, by every rank in the same
order.  Axis convention, as in the JAX package:

* ``dp``   — data parallel (batch sharding, gradient sum)
* ``fsdp`` — fully-sharded data parallel (batch sharding and ZeRO
  parameter / optimizer-state sharding)
* ``tp``   — tensor parallel (weight sharding)
* ``pp``   — pipeline stages (``pipeline.py``, the ``pipeline_region`` op)
* ``sp``   — sequence / context parallel (``ring_attention.py``)
* ``ep``   — expert parallel (sharded embedding tables)
"""

import itertools

import numpy as np

__all__ = ["Mesh", "PartitionSpec", "make_mesh", "AXIS_DP", "AXIS_FSDP",
           "AXIS_TP", "AXIS_PP", "AXIS_SP", "AXIS_EP"]

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
AXIS_PP = "pp"
AXIS_SP = "sp"
AXIS_EP = "ep"


class PartitionSpec(tuple):
    """Per-dimension mesh axes of an array, as ``jax.sharding.
    PartitionSpec``: each entry None (replicated), an axis name, or a tuple
    of axis names (the dim split over their product, the first axis
    major).  Trailing Nones are dropped, so ``P("fsdp", None) ==
    P("fsdp")``, and ``P()`` is replicated."""

    def __new__(cls, *entries):
        entries = list(entries)
        while entries and entries[-1] is None:
            entries.pop()
        return super().__new__(cls, (
            tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)

    def axes(self, dim):
        """The mesh axes dim ``dim`` is split over, as a tuple (() when
        replicated or past the spec's end)."""
        e = self[dim] if dim < len(self) else None
        if e is None:
            return ()
        return tuple(e) if isinstance(e, tuple) else (e,)


class Mesh:
    """Axis names and shape over the world ranks ``ranks`` (row-major, the
    first axis major).  ``devices.shape`` mirrors the JAX mesh's, so code
    that reads a mesh's extent reads either."""

    def __init__(self, shape, axis_names, ranks=None):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError("axis_names length must match mesh shape rank")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError("mesh axis names repeat: %r"
                             % (self.axis_names,))
        n = int(np.prod(self.shape))
        self.ranks = tuple(range(n)) if ranks is None else tuple(ranks)
        if len(self.ranks) != n:
            raise ValueError("mesh shape %r holds %d ranks, got %d"
                             % (self.shape, n, len(self.ranks)))
        self.devices = np.asarray(self.ranks).reshape(self.shape)
        self._groups = {}

    @property
    def size(self):
        return len(self.ranks)

    def axis_size(self, axis):
        """The extent of ``axis`` (1 for an axis the mesh lacks)."""
        if axis not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(axis)]

    def extent(self, axes):
        n = 1
        for a in axes:
            n *= self.axis_size(a)
        return n

    def coords(self, rank):
        """{axis: index} of world rank ``rank``."""
        idx = np.unravel_index(self.ranks.index(int(rank)), self.shape)
        return dict(zip(self.axis_names, (int(i) for i in idx)))

    def index(self, rank, axes):
        """Rank ``rank``'s position along ``axes`` combined, the first axis
        major: which block of a dim split over ``axes`` it holds."""
        c = self.coords(rank)
        i = 0
        for a in axes:
            i = i * self.axis_size(a) + c.get(a, 0)
        return i

    def group_ranks(self, axes):
        """The world ranks of every group along ``axes``: one list a
        position of the other axes, each ordered by ``index``."""
        live = [a for a in axes if a in self.axis_names]
        rest = [a for a in self.axis_names if a not in live]
        out = []
        for other in itertools.product(*(range(self.axis_size(a))
                                          for a in rest)):
            fixed = dict(zip(rest, other))
            ranks = []
            for pos in itertools.product(*(range(self.axis_size(a))
                                           for a in live)):
                c = dict(fixed, **dict(zip(live, pos)))
                ranks.append(int(self.devices[tuple(
                    c[a] for a in self.axis_names)]))
            out.append(ranks)
        return out

    def group(self, axes, rank):
        """The process group of ``rank`` along ``axes`` (None when it holds
        one rank).  The first call for ``axes`` makes every group along
        them, so every rank must make the same calls in the same order."""
        axes = tuple(a for a in axes if self.axis_size(a) > 1)
        if not axes:
            return None
        if axes not in self._groups:
            import torch.distributed as dist

            made = {}
            for ranks in self.group_ranks(axes):
                g = dist.new_group(ranks)
                for r in ranks:
                    made[r] = g
            self._groups[axes] = made
        return self._groups[axes][int(rank)]

    def _key(self):
        return (self.axis_names, self.shape, self.ranks)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return "Mesh(%s)" % ", ".join(
            "%s=%d" % (a, s) for a, s in zip(self.axis_names, self.shape))


def _world_size():
    from . import distributed

    return distributed.process_count()


def make_mesh(shape=None, axis_names=None, devices=None):
    """Build a Mesh over the world's ranks.

    ``make_mesh()``                  -> 1-D dp mesh over every rank (one
                                        rank without ``init_distributed``)
    ``make_mesh(8)``                 -> dp mesh over 8 ranks
    ``make_mesh((4, 2))``            -> (dp, tp) mesh
    ``make_mesh((1, 2, 2), ("dp", "fsdp", "tp"))``

    ``devices`` (the world ranks to lay out; default all) plays the JAX
    argument's part.  A shape that needs more ranks than the world holds
    raises once a world exists; without one any shape describes a mesh
    (``SpecLayout.resolve`` reads it), and only a run on it needs the
    world."""
    from . import distributed

    world = _world_size()
    ranks = list(devices) if devices is not None else list(range(world))
    if shape is None:
        shape = (len(ranks),)
    elif isinstance(shape, int):
        shape = (shape,)
    n = int(np.prod(shape))
    if distributed.is_initialized() or devices is not None:
        if n > len(ranks):
            raise ValueError("mesh shape %r needs %d ranks, have %d"
                             % (tuple(shape), n, len(ranks)))
        ranks = ranks[:n]
    else:
        ranks = list(range(n))
    if axis_names is None:
        axis_names = (AXIS_DP, AXIS_TP, AXIS_PP, AXIS_SP, AXIS_EP)[:len(shape)]
    if len(axis_names) != len(shape):
        raise ValueError("axis_names length must match mesh shape rank")
    return Mesh(shape, axis_names, ranks)
