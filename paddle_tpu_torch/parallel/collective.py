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
