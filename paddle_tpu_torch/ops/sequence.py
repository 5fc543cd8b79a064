"""Sequence ops (counterpart of the ``add_position_encoding``,
``padding_mask``, ``sequence_pool``, ``sequence_softmax`` and
``sequence_expand`` ops of ``paddle_tpu/ops/sequence.py``).  Sequences are padded [B, T, ...]
tensors with a [B] length companion; positions at or past a row's length
are masked, and the gradient through the mask is zero there."""

import torch

from ..core import convert_dtype
from ..registry import in_var, register_op, set_output


def _add_pos_enc_compute(ins, attrs, ctx, op_index):
    # X [B, T, D] + Table[:T] (T is the run's pad length)
    x, table = ins["X"][0], ins["Table"][0]
    return {"Out": x + table[:x.shape[1]][None]}


register_op(
    "add_position_encoding", ["X", "Table"], ["Out"],
    infer=lambda op, block: set_output(
        op, block, "Out", in_var(op, block, "X").shape,
        in_var(op, block, "X").dtype),
    compute=_add_pos_enc_compute, no_grad_inputs=("Table",))


def _padding_mask_infer(op, block):
    ref = in_var(op, block, "Ref")
    set_output(op, block, "Out", (ref.shape[0], ref.shape[1]),
               op.attrs.get("dtype", "float32"))


def _padding_mask_compute(ins, attrs, ctx, op_index):
    # [B] lengths + Ref [B, T, ...] -> [B, T] 0/1
    length, ref = ins["Length"][0], ins["Ref"][0]
    t = ref.shape[1]
    valid = torch.arange(t, device=ref.device)[None, :] \
        < length.to(ref.device).reshape(-1, 1)
    return {"Out": valid.to(convert_dtype(attrs.get("dtype", "float32")))}


register_op("padding_mask", ["Length", "Ref"], ["Out"],
            infer=_padding_mask_infer, compute=_padding_mask_compute,
            grad=None)


def _time_mask(length, t, extra_dims):
    """[B, T] (+ trailing singleton dims) validity mask."""
    m = torch.arange(t, device=length.device)[None, :] < length[:, None]
    return m.reshape(tuple(m.shape) + (1,) * extra_dims)


def _seq_pool_infer(op, block):
    x = in_var(op, block, "X")
    out_shape = (x.shape[0],) + tuple(x.shape[2:])
    set_output(op, block, "Out", out_shape, x.dtype)
    set_output(op, block, "MaxIndex", out_shape, "int32")


def _seq_pool_compute(ins, attrs, ctx, op_index):
    """Pool [B, T, ...] over the first ``length`` steps of each row:
    AVERAGE, SUM, SQRT (sum / sqrt(length)), MAX (with ``MaxIndex``, the
    first maximum's step), LAST, FIRST.  An empty row pools to 0."""
    x, length = ins["X"][0], ins["Length"][0]
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    length = length.to(x.device)
    mask = _time_mask(length, x.shape[1], x.dim() - 2)
    lead = (-1,) + (1,) * (x.dim() - 2)
    denom = torch.clamp_min(length, 1).to(x.dtype).reshape(lead)
    nonempty = (length > 0).reshape(lead)
    res = {}
    if ptype in ("AVERAGE", "SUM", "SQRT"):
        out = torch.where(mask, x, 0).sum(dim=1)
        if ptype == "AVERAGE":
            out = out / denom
        elif ptype == "SQRT":
            out = out / torch.sqrt(denom)
    elif ptype == "MAX":
        masked = torch.where(mask, x, torch.finfo(x.dtype).min
                             if x.is_floating_point()
                             else torch.iinfo(x.dtype).min)
        # amax spreads the gradient over tied maxima, as jnp.max does
        out = torch.where(nonempty, torch.amax(masked, dim=1), 0)
        res["MaxIndex"] = torch.argmax(masked, dim=1).to(torch.int32)
    elif ptype == "LAST":
        last = torch.clamp_min(length - 1, 0).to(torch.int64).reshape(
            (-1, 1) + (1,) * (x.dim() - 2))
        out = torch.take_along_dim(
            x, last.expand((-1, 1) + tuple(x.shape[2:])), dim=1).squeeze(1)
        out = torch.where(nonempty, out, 0)
    elif ptype == "FIRST":
        out = torch.where(nonempty, x[:, 0], 0)
    else:
        raise ValueError("unknown pooltype %r" % ptype)
    res["Out"] = out
    return res


register_op("sequence_pool", ["X", "Length"], ["Out", "MaxIndex"],
            infer=_seq_pool_infer, compute=_seq_pool_compute,
            no_grad_inputs=("Length",))


def _seq_softmax_compute(ins, attrs, ctx, op_index):
    """Softmax over the time axis of [B, T, ...] within each row's length;
    positions at or past it are 0."""
    x, length = ins["X"][0], ins["Length"][0]
    mask = _time_mask(length.to(x.device), x.shape[1], x.dim() - 2)
    sm = torch.softmax(torch.where(mask, x, torch.finfo(x.dtype).min), dim=1)
    return {"Out": torch.where(mask, sm, 0)}


register_op(
    "sequence_softmax", ["X", "Length"], ["Out"],
    infer=lambda op, block: set_output(
        op, block, "Out", in_var(op, block, "X").shape,
        in_var(op, block, "X").dtype),
    compute=_seq_softmax_compute, no_grad_inputs=("Length",))


def _seq_expand_infer(op, block):
    x, y = in_var(op, block, "X"), in_var(op, block, "Y")
    set_output(op, block, "Out",
               (x.shape[0], y.shape[1]) + tuple(x.shape[1:]), x.dtype)


def _seq_expand_compute(ins, attrs, ctx, op_index):
    """Repeat row b of X [B, ...] over the first length[b] steps of Y's
    time axis; 0 past it."""
    x, y, length = ins["X"][0], ins["Y"][0], ins["Length"][0]
    t = y.shape[1]
    expanded = x[:, None].expand((x.shape[0], t) + tuple(x.shape[1:]))
    mask = _time_mask(length.to(x.device), t, expanded.dim() - 2)
    return {"Out": torch.where(mask, expanded, 0)}


register_op("sequence_expand", ["X", "Y", "Length"], ["Out"],
            infer=_seq_expand_infer, compute=_seq_expand_compute,
            no_grad_inputs=("Y", "Length"))
