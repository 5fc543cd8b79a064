"""SelectedRows: sparse row-slice gradients (counterpart of
``paddle_tpu/ops/selected_rows.py``).

A SelectedRows value is ``(rows int64[N], values [N, ...])`` with the
table height beside it, held in the run's environment like any other
value.  ``N`` is the number of looked-up ids, never the table height: the
backward of a lookup touches O(batch·seq) rows, not O(vocab).  Rows stay
int64, the port's id dtype (the JAX package holds them as int32).

Every shape here is static, so a step that carries a SelectedRows is
captured in a CUDA graph like any other:

* ``merge_rows`` dedupes with a stable sort, a "new row" flag from
  adjacent differences and a ``cumsum`` for segment ids, never
  ``torch.unique`` (whose size depends on the data).  Its output has N
  slots: the unique rows ascending, then the sentinel ``height``.  The
  duplicates are summed by ``index_put_(accumulate=True)``, the primitive
  the dense lookup backward sums with (``manipulation._Gather``): both add
  an id's rows in the order they were looked up, so the merged gradient
  and the dense gradient hold the same bits.
* The sentinel row is out of bounds, which XLA's ``mode="drop"`` scatter
  ignores and a CUDA ``index_put_`` does not.  So every scatter of merged
  rows keeps the real rows' bits by construction: ``to_dense`` sums into a
  spare row past the table, an accumulating update adds ``-0.0`` to row 0
  for a sentinel slot (``x + -0.0`` is ``x`` for every ``x``, ``+0.0``
  would turn a ``-0.0`` into ``+0.0``), and ``scatter_update_rows`` points
  each sentinel slot at the last real slot, whose new value it repeats.

The optimizer updates built on these are lazy: a row that a step does not
touch keeps its parameter and every row-slot accumulator bit for bit.
"""

import re

import torch

from ..core import VarType
from ..framework import grad_var_name
from ..registry import _auto_grad_maker, in_var, register_op, set_output

__all__ = ["SelectedRows", "merge_rows", "to_dense", "merged_sumsq",
           "map_values", "scatter_update_rows", "scatter_add_rows",
           "sparse_lookup_tables", "is_row_slot_of", "mask_to"]

# the Optimizer._add_accumulator slot strings whose vars are per-row state
# (shape [height, ...] like the table); scalar accumulators (beta1_pow_acc
# ...) are told apart by the callers' shape check (the JAX package's list)
_ROW_SLOT_STRS = ("velocity", "momentum", "moment1", "moment2", "moment",
                  "mean_square", "mean_grad", "squared", "linear",
                  "inf_norm", "_avg_squared_grad", "_avg_squared_update")


def is_row_slot_of(name, table):
    """True when ``name`` is an optimizer accumulator var of ``table``
    (``<table>_<slot>_<uid>``, ``Optimizer._add_accumulator``'s naming),
    so a parameter that merely shares the table's prefix is not taken for
    its optimizer state."""
    if not name.startswith(table + "_"):
        return False
    return re.fullmatch(
        re.escape(table) + "_(%s)_\\d+" % "|".join(_ROW_SLOT_STRS),
        name) is not None


def sparse_lookup_tables(program):
    """{table var name: Variable} of every ``lookup_table`` W whose op sets
    ``is_sparse``, across all blocks."""
    out = {}
    for blk in program.blocks:
        for op in blk.ops:
            if op.type != "lookup_table" or not op.attrs.get("is_sparse",
                                                              False):
                continue
            for w in op.inputs.get("W", []):
                v = blk._find_var_recursive(w)
                if v is not None and v.shape and w not in out:
                    out[w] = v
    return out


class SelectedRows:
    """rows: int64[N] indices into dim 0 of a [height, ...] table; values:
    [N, ...] gradient slices; height: the table's height."""

    def __init__(self, rows, values, height):
        self.rows = rows
        self.values = values
        self.height = int(height)

    def __repr__(self):
        return "SelectedRows(rows=%s, values=%s, height=%d)" % (
            tuple(self.rows.shape), tuple(self.values.shape), self.height)


def mask_to(valid, like):
    """A [N] mask shaped to broadcast against a [N, ...] tensor."""
    return valid.reshape((-1,) + (1,) * (like.dim() - 1))


def merge_rows(sr):
    """Combine duplicate rows with static shapes: (unique rows int64[N]
    ascending, then the sentinel ``height``; the merged values [N, ...];
    valid bool[N] = rows < height)."""
    rows = sr.rows
    n = rows.shape[0]
    srt, perm = torch.sort(rows, stable=True)
    new = torch.ones(n, dtype=torch.bool, device=rows.device)
    new[1:] = srt[1:] != srt[:-1]
    seg = torch.cumsum(new, 0) - 1          # each sorted slot's unique index
    inv = torch.empty_like(seg)
    inv[perm] = seg                         # each looked-up slot's
    uniq = torch.full((n,), sr.height, dtype=rows.dtype, device=rows.device)
    uniq[seg] = srt                         # a segment writes one value
    merged = torch.zeros_like(sr.values).index_put_(
        (inv,), sr.values, accumulate=True)
    return uniq, merged, uniq < sr.height


def to_dense(sr):
    """The dense [height, ...] tensor: the rows summed into a zero table
    (sentinel rows land in a spare row past its end)."""
    dense = sr.values.new_zeros((sr.height + 1,) + tuple(sr.values.shape[1:]))
    dense.index_put_((sr.rows,), sr.values, accumulate=True)
    return dense[:sr.height]


def map_values(sr, fn):
    """A new SelectedRows with ``fn`` applied to the values (same rows);
    only for functions that commute with merging duplicates (a scale)."""
    return SelectedRows(sr.rows, fn(sr.values), sr.height)


def merged_sumsq(sr):
    """sum(dense(sr) ** 2) without the dense gradient: duplicates merge
    before they are squared; padded slots merge to zero."""
    _, merged, _ = merge_rows(sr)
    return torch.sum(merged * merged)


def scatter_add_rows(table, rows, deltas):
    """``table[rows] += deltas`` in place, duplicates added one by one in
    their order; a sentinel row adds ``-0.0`` to row 0."""
    valid = rows < table.shape[0]
    table.index_put_(
        (torch.where(valid, rows, 0),),
        torch.where(mask_to(valid, deltas), deltas, -0.0),
        accumulate=True)
    return table


def scatter_update_rows(table, uniq, valid, new_rows):
    """``table[uniq] = new_rows`` for the valid slots, in place.  The valid
    slots are ``merge_rows``' first ones; each sentinel slot repeats the
    last valid slot (its row and its new value), so every index is in
    range and no row gets two different values.  With no valid slot (a
    row shard none of whose rows the step touched) every slot writes the
    table's last row back unchanged."""
    last = valid.sum() - 1
    src = torch.minimum(torch.arange(uniq.shape[0], device=uniq.device),
                        last.clamp(min=0))
    rows = uniq[src].clamp(max=table.shape[0] - 1)
    table.index_put_((rows,), torch.where(
        mask_to(valid.any().expand(rows.shape), new_rows), new_rows[src],
        table[rows]))
    return table


# ---------------------------------------------------------------------------
# lookup_table's sparse gradient (the grad maker the embedding's is_sparse
# attr selects)
# ---------------------------------------------------------------------------

def lookup_table_grad_maker(op, no_grad_set):
    """``lookup_table``'s grad ops: ``lookup_table_sparse_grad`` when the
    op is sparse, else the generic grad."""
    if not op.attrs.get("is_sparse", False):
        return _auto_grad_maker(op, no_grad_set)
    w_name = op.inputs["W"][0]
    if w_name in no_grad_set:
        return []
    return [dict(
        type="lookup_table_sparse_grad",
        inputs={"W": list(op.inputs["W"]),
                "Ids": list(op.inputs["Ids"]),
                "GRAD::Out": [grad_var_name(n) for n in op.outputs["Out"]]},
        outputs={"GRAD::W": [grad_var_name(w_name)]},
        attrs=dict(op.attrs))]


def _lookup_sparse_grad_infer(op, block):
    w = in_var(op, block, "W")
    for g_name in op.outputs.get("GRAD::W", []):
        if g_name:
            # typed SELECTED_ROWS, so that the clip and regularizer
            # appenders keep the gradient sparse
            block.create_var(name=g_name, shape=w.shape, dtype=w.dtype,
                             persistable=False, type=VarType.SELECTED_ROWS)


def _lookup_sparse_grad_compute(ins, attrs, ctx, op_index):
    w, ids, gout = ins["W"][0], ins["Ids"][0], ins["GRAD::Out"][0]
    flat = ids.reshape(-1)
    values = gout.reshape(flat.shape[0], w.shape[1])
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad != -1:
        values = values * (flat != pad)[:, None].to(values.dtype)
    return {"GRAD::W": SelectedRows(flat, values, w.shape[0])}


register_op("lookup_table_sparse_grad", ["W", "Ids", "GRAD::Out"],
            ["GRAD::W"], infer=_lookup_sparse_grad_infer,
            compute=_lookup_sparse_grad_compute, grad=None,
            no_grad_inputs=("Ids",))


def _get_tensor_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    return {"Out": to_dense(x) if isinstance(x, SelectedRows) else x}


register_op(
    "get_tensor_from_selected_rows", ["X"], ["Out"],
    infer=lambda op, block: set_output(
        op, block, "Out", in_var(op, block, "X").shape,
        in_var(op, block, "X").dtype),
    compute=_get_tensor_compute, grad=None)


# ---------------------------------------------------------------------------
# sparse_weight_decay: L1/L2 decay of the touched rows of a SelectedRows
# gradient (the dense leg's full-table scale + sum would make an O(vocab)
# gradient and un-lazy the update)
# ---------------------------------------------------------------------------

def _sparse_decay_infer(op, block):
    g = in_var(op, block, "Grad")
    for name in op.outputs.get("Out", []):
        if name:
            block.create_var(name=name, shape=g.shape, dtype=g.dtype,
                             persistable=False, type=VarType.SELECTED_ROWS)


def _sparse_decay_compute(ins, attrs, ctx, op_index):
    g, p = ins["Grad"][0], ins["Param"][0]
    coeff = attrs["coeff"]
    mode = attrs.get("mode", "l2")
    if not isinstance(g, SelectedRows):
        term = p if mode == "l2" else torch.sign(p)
        return {"Out": g + coeff * term.to(g.dtype)}
    # duplicates merge first: the decay applies once a touched row, as the
    # dense gradient's per-row term does
    uniq, merged, valid = merge_rows(g)
    rows = p[torch.where(valid, uniq, 0)]
    term = rows if mode == "l2" else torch.sign(rows)
    mask = mask_to(valid, merged).to(merged.dtype)
    vals = merged + coeff * term.to(merged.dtype) * mask
    return {"Out": SelectedRows(uniq, vals, g.height)}


register_op("sparse_weight_decay", ["Grad", "Param"], ["Out"],
            infer=_sparse_decay_infer, compute=_sparse_decay_compute,
            grad=None, no_grad_inputs=("Grad", "Param"))
