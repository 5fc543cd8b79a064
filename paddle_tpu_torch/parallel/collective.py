"""The collectives of the mesh runtime: a rank's view of its mesh
(:class:`MeshRuntime`) and the ops ``ParallelExecutor``'s plan inserts
into the program it runs (``parallel/plan.py``).

Every op here takes its axes from its attrs and its process groups from
the run's ``ComputeContext.mesh`` (the rewritten program carries the
runtime, ``registry.ComputeContext``); a collective over axes whose
extent is 1 is no collective at all (the op copies nothing and calls
nothing), so a world of one runs the plan's program with no collective.
The ops have no gradient makers: the plan inserts them into a program
whose backward is already built, and places each one where the single
device program's arithmetic needs it.

* ``c_allreduce`` (X -> Out, in place): sum (or max) over ``axes``;
* ``c_allgather`` (X -> Out): concatenation along ``dim`` over ``axes``,
  in the ranks' order along them;
* ``c_slice`` (X -> Out): this rank's block along ``dim`` over ``axes``
  (no communication);
* ``c_reshard`` (X -> Out): from the spec ``src`` to the spec ``dst``
  (gathers the dims ``src`` splits and ``dst`` does not, then slices);
* ``c_reduce_shard`` (X -> Out): a partial gradient summed over
  ``reduce_axes`` and cut to the spec ``dst``: a reduce-scatter where
  ``dst`` splits one dim over exactly the reduced axes, else an all-reduce
  and a slice;
* ``c_sparse_allgather`` (X -> Out): a SelectedRows gradient's rows and
  values concatenated over ``axes`` (a replicated ``is_sparse`` table's
  gradient under data parallelism).

``MeshRuntime`` also holds what the sequence and pipeline axes move
inside their ops: ``exchange`` (one ``batch_isend_irecv`` round of
point-to-point transfers along an axis), ``shift`` (a ring rotation: the
``sp`` ring's K/V blocks) and ``broadcast`` (the last pipeline stage's
outputs to every ``pp`` rank).
"""

import warnings

import torch

from ..ops.selected_rows import SelectedRows
from ..registry import in_var, register_op, set_output

__all__ = ["MeshRuntime", "PLAN_OPS"]

# the op types of this module: what only a plan inserts
PLAN_OPS = ("c_allreduce", "c_allgather", "c_slice", "c_reshard",
            "c_reduce_shard", "c_sparse_allgather")


def _dist():
    import torch.distributed as dist

    return dist


class MeshRuntime:
    """A rank's view of its mesh: its coordinates, the extent and index
    along any axes, and the collectives over them.  ``rank`` is the world
    rank; without a world (a mesh of one) no group is ever made."""

    def __init__(self, mesh, rank, device):
        self.mesh = mesh
        self.rank = int(rank)
        self.device = device
        self._peers = {}

    def extent(self, axes):
        return self.mesh.extent(axes)

    def index(self, axes):
        return self.mesh.index(self.rank, axes)

    def group(self, axes):
        return self.mesh.group(tuple(axes), self.rank)

    def prepare(self, axes_list):
        """Make the groups of every axes tuple in ``axes_list`` (every rank
        calls this with the same list, in the same order)."""
        for axes in axes_list:
            self.group(axes)

    # -- collectives -----------------------------------------------------
    def all_reduce(self, t, axes, op="sum"):
        """``t`` summed (or maxed) over ``axes``, in place."""
        if self.extent(axes) <= 1:
            return t
        dist = _dist()
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}[op]
        dist.all_reduce(t, op=red, group=self.group(axes))
        return t

    def all_gather(self, t, axes, dim=0):
        """The blocks of ``t`` along ``dim`` over ``axes``, concatenated in
        the ranks' order."""
        k = self.extent(axes)
        if k <= 1:
            return t
        dist = _dist()
        t = t.contiguous()
        if dim == 0:
            out = torch.empty((k * t.shape[0],) + tuple(t.shape[1:]),
                              dtype=t.dtype, device=t.device)
            _all_gather_into(dist, out, t, self.group(axes))
            return out
        moved = t.movedim(dim, 0).contiguous()
        out = torch.empty((k * moved.shape[0],) + tuple(moved.shape[1:]),
                          dtype=t.dtype, device=t.device)
        _all_gather_into(dist, out, moved, self.group(axes))
        return out.movedim(0, dim).contiguous()

    def slice(self, t, axes, dim=0):
        """This rank's block of ``t`` along ``dim`` over ``axes``."""
        k = self.extent(axes)
        if k <= 1:
            return t
        n = t.shape[dim]
        if n % k:
            raise ValueError("dim %d of %s does not split %d ways over %r"
                             % (dim, tuple(t.shape), k, tuple(axes)))
        return t.narrow(dim, self.index(axes) * (n // k), n // k) \
            .contiguous()

    def reduce_scatter(self, t, axes, dim=0):
        """``t`` summed over ``axes`` and this rank's block along ``dim``
        kept."""
        k = self.extent(axes)
        if k <= 1:
            return t
        dist = _dist()
        moved = t.movedim(dim, 0).contiguous()
        if moved.shape[0] % k:
            raise ValueError("dim %d of %s does not split %d ways over %r"
                             % (dim, tuple(t.shape), k, tuple(axes)))
        out = torch.empty((moved.shape[0] // k,) + tuple(moved.shape[1:]),
                          dtype=t.dtype, device=t.device)
        _reduce_scatter_into(dist, out, moved, self.group(axes))
        return out.movedim(0, dim).contiguous()

    def reshard(self, t, src, dst):
        """``t`` held at spec ``src`` as held at spec ``dst``."""
        for dim in range(t.dim()):
            a, b = src.axes(dim), dst.axes(dim)
            if a != b:
                t = self.all_gather(t, a, dim)
                t = self.slice(t, b, dim)
        return t

    def peer(self, axes, index):
        """The world rank at position ``index`` along ``axes`` in this
        rank's group (the other axes' coordinates kept)."""
        axes = tuple(axes)
        ranks = self._peers.get(axes)
        if ranks is None:
            ranks = self._peers[axes] = next(
                g for g in self.mesh.group_ranks(axes) if self.rank in g)
        return ranks[int(index) % len(ranks)]

    def exchange(self, axes, sends=(), recvs=()):
        """One round of point-to-point transfers along ``axes``: ``sends``
        are (tensor, position along axes) pairs, ``recvs`` (buffer,
        position) pairs, posted together in one ``batch_isend_irecv`` and
        waited on.  Every rank posts its round in the same order, so a
        ring's transfers (each rank sending and receiving at once) cannot
        wait on each other.  Returns how many transfers this rank
        posted."""
        ops = []
        if not sends and not recvs:
            return 0
        dist = _dist()
        group = self.group(axes)
        for t, pos in sends:
            ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                  self.peer(axes, pos), group))
        for t, pos in recvs:
            ops.append(dist.P2POp(dist.irecv, t, self.peer(axes, pos),
                                  group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return len(ops)

    def shift(self, tensors, axes, offset=-1):
        """Each of ``tensors`` sent to the rank ``offset`` places along
        ``axes`` (cyclically) and replaced by what the rank ``-offset``
        places along sends: one ring rotation.  Returns the received
        tensors."""
        k = self.extent(axes)
        if k <= 1:
            return list(tensors)
        i = self.index(axes)
        outs = [torch.empty_like(t) for t in tensors]
        self.exchange(axes, [(t, (i + offset) % k) for t in tensors],
                      [(o, (i - offset) % k) for o in outs])
        return outs

    def broadcast(self, t, axes, src_index):
        """``t`` from the rank at position ``src_index`` along ``axes`` on
        every rank of the group, in place."""
        if self.extent(axes) <= 1:
            return t
        _dist().broadcast(t, src=self.peer(axes, src_index),
                          group=self.group(axes))
        return t


def _quiet(fn, *args, **kwargs):
    # some releases call the tensor collectives deprecated in favour of
    # names other releases lack
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kwargs)


def _all_gather_into(dist, out, t, group):
    _quiet(dist.all_gather_into_tensor, out, t, group=group)


def _reduce_scatter_into(dist, out, t, group):
    _quiet(dist.reduce_scatter_tensor, out, t, group=group)


class _Replicated(torch.autograd.Function):
    """An all-reduce whose result every rank consumes alike: the cotangent
    arriving on each rank is already the whole one and passes through
    (a row-sharded table's lookup)."""

    @staticmethod
    def forward(ctx, x, rt, axes):
        return rt.all_reduce(x.clone(), axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def replicated_sum(rt, x, axes):
    """``x`` summed over ``axes`` for replicated consumers."""
    if rt is None or rt.extent(axes) <= 1:
        return x
    return _Replicated.apply(x, rt, tuple(axes))


class _SliceReplicated(torch.autograd.Function):
    """The rank's block of a tensor every rank holds alike; the whole
    tensor's cotangent is the ranks' block cotangents gathered."""

    @staticmethod
    def forward(ctx, x, rt, axes, dim):
        ctx.cfg = (rt, axes, dim)
        return rt.slice(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        rt, axes, dim = ctx.cfg
        return rt.all_gather(g.contiguous(), axes, dim), None, None, None


class _GatherReplicated(torch.autograd.Function):
    """The ranks' blocks gathered for consumers every rank runs alike:
    each rank's cotangent is already the whole one, and its block's is
    its slice."""

    @staticmethod
    def forward(ctx, x, rt, axes, dim):
        ctx.cfg = (rt, axes, dim)
        return rt.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        rt, axes, dim = ctx.cfg
        return rt.slice(g, axes, dim), None, None, None


def slice_replicated(rt, x, axes, dim):
    """This rank's block along ``dim`` over ``axes`` of a replicated
    ``x``, differentiable (the backward gathers)."""
    if rt.extent(axes) <= 1:
        return x
    return _SliceReplicated.apply(x, rt, tuple(axes), int(dim))


def gather_replicated(rt, x, axes, dim):
    """The blocks of ``x`` along ``dim`` over ``axes`` gathered for
    replicated consumers, differentiable (the backward slices)."""
    if rt.extent(axes) <= 1:
        return x
    return _GatherReplicated.apply(x, rt, tuple(axes), int(dim))


# ---------------------------------------------------------------------------
# the plan's ops
# ---------------------------------------------------------------------------

def _spec(entries):
    from .mesh import PartitionSpec

    return PartitionSpec(*[tuple(e) if isinstance(e, list) else e
                           for e in (entries or [])])


def _rt(ctx):
    rt = getattr(ctx, "mesh", None)
    if rt is None:
        raise RuntimeError("a collective op runs only in a program a "
                           "ParallelExecutor planned")
    return rt


def _infer_like_x(op, block):
    x = in_var(op, block, "X")
    if x is not None:
        for n in op.outputs.get("Out", []):
            if block._find_var_recursive(n) is None:
                set_output(op, block, "Out", x.shape, x.dtype, x.lod_level)


def _c_allreduce(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    return {"Out": _rt(ctx).all_reduce(x, attrs["axes"],
                                       attrs.get("op", "sum"))}


def _c_allgather(ins, attrs, ctx, op_index):
    return {"Out": _rt(ctx).all_gather(ins["X"][0], attrs["axes"],
                                       attrs.get("dim", 0))}


def _c_slice(ins, attrs, ctx, op_index):
    return {"Out": _rt(ctx).slice(ins["X"][0], attrs["axes"],
                                  attrs.get("dim", 0))}


def _c_reshard(ins, attrs, ctx, op_index):
    return {"Out": _rt(ctx).reshard(ins["X"][0], _spec(attrs["src"]),
                                    _spec(attrs["dst"]))}


def _c_reduce_shard(ins, attrs, ctx, op_index):
    """A partial gradient (full or already at ``src``) summed over
    ``reduce_axes`` and cut to ``dst``."""
    rt = _rt(ctx)
    x = ins["X"][0]
    red = tuple(attrs.get("reduce_axes", ()))
    src, dst = _spec(attrs.get("src")), _spec(attrs["dst"])
    split = [d for d in range(x.dim()) if src.axes(d) != dst.axes(d)]
    # a reduce-scatter where dst splits one dim over exactly the reduced
    # axes (ZeRO on the data axes) and src holds it whole
    if len(split) == 1 and not src.axes(split[0]) \
            and set(dst.axes(split[0])) == set(a for a in red
                                               if rt.extent((a,)) > 1) \
            and rt.extent(red) > 1:
        return {"Out": rt.reduce_scatter(x, dst.axes(split[0]), split[0])}
    if red:
        x = rt.all_reduce(x, red)
    return {"Out": rt.reshard(x, src, dst)}


def _c_sparse_allgather(ins, attrs, ctx, op_index):
    sr = ins["X"][0]
    rt = _rt(ctx)
    axes = attrs["axes"]
    return {"Out": SelectedRows(rt.all_gather(sr.rows, axes, 0),
                                rt.all_gather(sr.values, axes, 0),
                                sr.height)}


for _type, _fn in zip(PLAN_OPS, (_c_allreduce, _c_allgather, _c_slice,
                                 _c_reshard, _c_reduce_shard,
                                 _c_sparse_allgather)):
    register_op(_type, ["X"], ["Out"], infer=_infer_like_x, compute=_fn,
                grad=None)
