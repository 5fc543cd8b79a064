"""Sharded embedding tables on the mesh (counterpart of
``paddle_tpu/parallel/embedding.py``; the reference's distributed lookup
tables, ``transpiler/distribute_transpiler.py`` with remote prefetch and
``split_ids_op.cc`` / ``merge_ids_op.cc``).

A table marked ``is_distributed`` by ``layers.embedding`` is row-sharded
over a mesh axis (``distributed_embedding_sharding_fn``), and each rank
holds only its rows.  ``ParallelExecutor``'s plan marks the table's
``lookup_table`` and its optimizer op with the table's axes
(``__table_axes__``) and the batch axes its gradient crosses
(``__batch_axes__``), and the ops call here:

* ``sharded_sparse_lookup`` (``ops/manipulation.py``'s ``lookup_table``):
  each rank reads only its local rows (ids outside them read zeros) and
  the [N, D] activations are summed over the table axes;
* ``sharded_sparse_update`` (``ops/optimizer_ops.py``'s lazy updates): an
  ``is_sparse`` table's SelectedRows gradient — ids and value slices,
  O(batch x seq x D) — is gathered over the batch axes, and its rows are
  made local: an id of another rank's rows becomes the sentinel row past
  the local height, whose value is zero, so each rank updates only its
  own rows.

No rank ever holds the whole table or a dense [vocab, D] gradient of it.
"""

from .collective import replicated_sum
from .mesh import AXIS_DP, AXIS_EP
from .mesh import PartitionSpec as P

__all__ = ["distributed_embedding_sharding_fn", "sharded_sparse_lookup",
           "sharded_sparse_update", "dim0_axes", "distributed_tables"]


def distributed_tables(program):
    """{table var name: Variable} of every ``lookup_table`` W whose op sets
    ``is_distributed``, across all blocks."""
    out = {}
    for blk in program.blocks:
        for op in blk.ops:
            if op.type != "lookup_table" or \
                    not op.attrs.get("is_distributed", False):
                continue
            for w in op.inputs.get("W", []):
                v = blk._find_var_recursive(w)
                if v is not None and v.shape and w not in out:
                    out[w] = v
    return out


def distributed_embedding_sharding_fn(program, mesh, axis=None):
    """A ``BuildStrategy.param_sharding_fn`` that row-shards every
    ``is_distributed`` embedding table over ``axis`` (default: the mesh's
    ``ep`` axis if present, else ``dp``).

    The optimizer slot vars of a sharded table (``<table>_moment1_0``
    etc., told apart by their slot name and a leading dim equal to the
    table's height) take the row sharding too: a lazy sparse Adam over a
    1e6-row table must not keep replicated [vocab, D] moments.  Other
    params get None, so a wrapper can fall through to another policy."""
    from ..ops.selected_rows import is_row_slot_of

    if axis is None:
        axis = AXIS_EP if AXIS_EP in mesh.axis_names else AXIS_DP
    if axis not in mesh.axis_names:
        raise ValueError(
            "mesh %r has no %r axis to shard embedding tables over; pass "
            "axis= naming one of its axes" % (tuple(mesh.axis_names), axis))
    size = mesh.axis_size(axis)
    heights = {w: int(v.shape[0])
               for w, v in distributed_tables(program).items()}

    def fn(name, shape):
        if name in heights and shape and shape[0] % size == 0:
            return P(axis)
        for t, h in heights.items():
            if is_row_slot_of(name, t) and shape and len(shape) >= 1 \
                    and shape[0] == h and h % size == 0:
                return P(axis)     # optimizer slot var of a sharded table
        return None

    return fn


def dim0_axes(spec):
    """The mesh axes sharding dim 0 of ``spec`` as a flat tuple (() =
    unsharded)."""
    entries = tuple(spec) if spec is not None else ()
    if not entries or entries[0] is None:
        return ()
    e = entries[0]
    return tuple(e) if isinstance(e, tuple) else (e,)


def _table_axes(ctx, attrs):
    axes = tuple(attrs.get("__table_axes__") or ())
    rt = getattr(ctx, "mesh", None)
    if not axes or rt is None or rt.extent(axes) <= 1:
        return None, None
    return rt, axes


def sharded_sparse_lookup(ctx, w, flat_ids, attrs):
    """The [N, D] lookup of ``flat_ids`` in a row-sharded table whose local
    rows are ``w``: local rows gathered, the rest zeros, summed over the
    table axes.  None when the op's table is not row-sharded (the caller
    runs the whole-table lookup)."""
    import torch

    from ..ops.manipulation import gather_rows

    rt, axes = _table_axes(ctx, attrs)
    if rt is None:
        return None
    local = int(w.shape[0])
    lo = rt.index(axes) * local
    loc = flat_ids.long() - lo
    ok = (loc >= 0) & (loc < local)
    out = gather_rows(w, torch.where(ok, loc, 0))
    out = out * ok[:, None].to(out.dtype)
    return replicated_sum(rt, out, axes)


def sharded_sparse_update(ctx, attrs, g):
    """A row-sharded table's SelectedRows gradient as this rank's rows
    see it: gathered over the batch axes, each id outside the local rows
    sent to the sentinel row (the local height) with a zero value.  ``g``
    itself when the op's table is not row-sharded."""
    import torch

    from ..ops.selected_rows import SelectedRows

    rt, axes = _table_axes(ctx, attrs)
    if rt is None:
        return g
    batch = tuple(attrs.get("__batch_axes__") or ())
    rows = rt.all_gather(g.rows, batch, 0)
    values = rt.all_gather(g.values, batch, 0)
    local = int(attrs["__table_rows__"]) // rt.extent(axes)
    lo = rt.index(axes) * local
    loc = rows.long() - lo
    ok = (loc >= 0) & (loc < local)
    loc = torch.where(ok, loc, local).to(rows.dtype)
    values = values * ok.reshape((-1,) + (1,) * (values.dim() - 1)) \
        .to(values.dtype)
    return SelectedRows(loc, values, local)
