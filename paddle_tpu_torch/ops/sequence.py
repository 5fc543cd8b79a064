"""Sequence ops (counterpart of ``paddle_tpu/ops/sequence.py``).
Sequences are padded [B, T, ...] tensors with a [B] length companion;
positions at or past a row's length are masked, and the gradient through
the mask is zero there.

The ops that compact or scatter positions (``sequence_concat``,
``sequence_erase``, ``sequence_scatter``), where the JAX ops scatter with
``mode="drop"``, scatter into a copy with one spare slot a row: a unit
that the JAX op drops writes the spare slot, which is then cut off, so no
index out of range reaches a kernel.  ``sequence_concat`` and
``sequence_erase`` write each kept position once (``index_put`` without
accumulation); ``sequence_scatter`` adds repeated ids in order.  A
gather (``sequence_reverse``, ``sequence_slice``) clamps its indices into
the time axis.  No op reads a value on the host: ``max_sequence_len``'s
output stays a 0-d device tensor.

The rank-table family (``lod_rank_table``, ``max_sequence_len``,
``reorder_lod_tensor_by_rank``, ``lod_tensor_to_array``,
``array_to_lod_tensor``) keeps the JAX package's static shapes: the table
is a [B, 2] int64 tensor of (index, length) rows sorted by length,
longest first and ties in batch order, reorders are batch gathers, and
the "array" of time-major step batches is one [T, B, ...] tensor whose
steps stay full width (masked by ``OutLength``, not shrunk)."""

import numpy as np
import torch
import torch.nn.functional as F

from ..core import convert_dtype
from ..registry import in_var, register_op, set_output
from .creation import device_constant
from .manipulation import add_at


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



def _lead(x, mask):
    """[B, T] ``mask`` shaped to broadcast against [B, T, ...] ``x``."""
    return mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - 2))


def _same_shape(slot_in, slot_out):
    def infer(op, block):
        x = in_var(op, block, slot_in)
        set_output(op, block, slot_out, x.shape, x.dtype)
    return infer


def _row_lengths(op, block, slot, dtype):
    set_output(op, block, slot, (in_var(op, block, "X").shape[0],), dtype)


# -- sequence_mask ----------------------------------------------------------

def _seq_mask_infer(op, block):
    x = in_var(op, block, "X")
    maxlen = op.attrs.get("maxlen", -1)
    set_output(op, block, "Y", tuple(x.shape) + (maxlen if maxlen > 0
                                                  else -1,),
               op.attrs.get("out_dtype", "float32"))


def _seq_mask_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    maxlen = attrs.get("maxlen", -1)
    if maxlen <= 0:
        raise ValueError("sequence_mask needs a static maxlen (got %r)"
                         % maxlen)
    mask = torch.arange(maxlen, device=x.device) < x[..., None]
    return {"Y": mask.to(convert_dtype(attrs.get("out_dtype", "float32")))}


register_op("sequence_mask", ["X"], ["Y"], infer=_seq_mask_infer,
            compute=_seq_mask_compute, grad=None)


# -- sequence_concat (along time) -------------------------------------------

def _seq_concat_infer(op, block):
    xs = [block._find_var_recursive(n) for n in op.inputs["X"]]
    dims = [v.shape[1] for v in xs]
    t = -1 if any(d is None or d < 0 for d in dims) else sum(dims)
    set_output(op, block, "Out",
               (xs[0].shape[0], t) + tuple(xs[0].shape[2:]), xs[0].dtype)
    set_output(op, block, "OutLength", (xs[0].shape[0],), "int32")


def _seq_concat_compute(ins, attrs, ctx, op_index):
    """Each row's sequences one after another: sequence i's valid steps
    at its running offset, zeros after the total length."""
    xs, lens = ins["X"], [ln.long() for ln in ins["Length"]]
    b = xs[0].shape[0]
    total = sum(x.shape[1] for x in xs)
    dev = xs[0].device
    rows = torch.arange(b, device=dev)[:, None]
    buf = xs[0].new_zeros((b, total + 1) + tuple(xs[0].shape[2:]))
    offset = torch.zeros(b, dtype=torch.long, device=dev)
    pos, vals = [], []
    for x, ln in zip(xs, lens):
        steps = torch.arange(x.shape[1], device=dev)[None, :]
        valid = steps < ln[:, None]
        pos.append(torch.where(valid, offset[:, None] + steps, total))
        vals.append(x)
        offset = offset + ln
    pos = torch.cat(pos, dim=1)
    out = buf.index_put((rows.expand_as(pos), pos), torch.cat(vals, dim=1))
    return {"Out": out[:, :total], "OutLength": offset.to(torch.int32)}


register_op("sequence_concat", ["X", "Length"], ["Out", "OutLength"],
            infer=_seq_concat_infer, compute=_seq_concat_compute,
            no_grad_inputs=("Length",))


# -- sequence_reverse -------------------------------------------------------

def _seq_reverse_compute(ins, attrs, ctx, op_index):
    x, length = ins["X"][0], ins["Length"][0].long()
    t = x.shape[1]
    ar = torch.arange(t, device=x.device)[None, :]
    idx = torch.where(ar < length[:, None], length[:, None] - 1 - ar, ar)
    idx = _lead(x, idx.clamp(0, t - 1)).expand(x.shape)
    return {"Out": torch.take_along_dim(x, idx, dim=1)}


register_op("sequence_reverse", ["X", "Length"], ["Out"],
            infer=_same_shape("X", "Out"), compute=_seq_reverse_compute,
            no_grad_inputs=("Length",))


# -- sequence_conv (a context-window fc) and row_conv (lookahead) -----------

def _shifted(xm, shift):
    """[B, T, D] ``xm`` moved ``shift`` steps earlier along time, zeros
    where step t + shift falls outside [0, T)."""
    t = xm.shape[1]
    ar = torch.arange(t, device=xm.device)
    valid = (ar + shift >= 0) & (ar + shift < t)
    return torch.where(valid[None, :, None], torch.roll(xm, -shift, dims=1),
                       0)


def _seq_conv_infer(op, block):
    x, w = in_var(op, block, "X"), in_var(op, block, "Filter")
    set_output(op, block, "Out", (x.shape[0], x.shape[1], w.shape[1]),
               x.dtype)


def _seq_conv_compute(ins, attrs, ctx, op_index):
    x, w = ins["X"][0], ins["Filter"][0]         # [B, T, D], [ctx*D, O]
    ctx_len = attrs.get("contextLength", 3)
    start = attrs.get("contextStart", -((ctx_len - 1) // 2))
    mask = _time_mask(ins["Length"][0].long(), x.shape[1], 1)
    xm = torch.where(mask, x, 0)
    cols = torch.cat([_shifted(xm, start + j) for j in range(ctx_len)],
                     dim=-1)
    return {"Out": torch.where(mask, cols @ w, 0)}


register_op("sequence_conv", ["X", "Filter", "Length"], ["Out"],
            infer=_seq_conv_infer, compute=_seq_conv_compute,
            no_grad_inputs=("Length",))


def _row_conv_compute(ins, attrs, ctx, op_index):
    x, w = ins["X"][0], ins["Filter"][0]         # [B, T, D], [k, D]
    mask = _time_mask(ins["Length"][0].long(), x.shape[1], 1)
    xm = torch.where(mask, x, 0)
    out = torch.zeros_like(x)
    for j in range(w.shape[0]):
        out = out + _shifted(xm, j) * w[j][None, None]
    return {"Out": torch.where(mask, out, 0)}


register_op("row_conv", ["X", "Filter", "Length"], ["Out"],
            infer=_same_shape("X", "Out"), compute=_row_conv_compute,
            no_grad_inputs=("Length",))


# -- sequence_erase ---------------------------------------------------------

def _seq_erase_infer(op, block):
    _same_shape("X", "Out")(op, block)
    _row_lengths(op, block, "OutLength", "int32")


def _seq_erase_compute(ins, attrs, ctx, op_index):
    """Drop the ``tokens`` from each row, the kept ones moved left in
    order; zeros after the new length."""
    x, length = ins["X"][0], ins["Length"][0].long()
    squeeze = x.dim() == 3 and x.shape[-1] == 1      # [B, T, 1] ids
    if squeeze:
        x = x[..., 0]
    b, t = x.shape
    keep = _time_mask(length, t, 0)
    for tok in attrs.get("tokens", []):
        keep = keep & (x != tok)
    pos = torch.where(keep, torch.cumsum(keep.long(), dim=1) - 1, t)
    rows = torch.arange(b, device=x.device)[:, None].expand(b, t)
    out = x.new_zeros((b, t + 1)).index_put((rows, pos), x)[:, :t]
    if squeeze:
        out = out[..., None]
    return {"Out": out, "OutLength": keep.sum(dim=1).to(torch.int32)}


register_op("sequence_erase", ["X", "Length"], ["Out", "OutLength"],
            infer=_seq_erase_infer, compute=_seq_erase_compute, grad=None)


# -- sequence_enumerate -----------------------------------------------------

def _seq_enum_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "Out",
               tuple(x.shape[:2]) + (op.attrs.get("win_size", 2),), x.dtype)


def _seq_enum_compute(ins, attrs, ctx, op_index):
    x, length = ins["X"][0], ins["Length"][0].long()
    if x.dim() == 3 and x.shape[-1] == 1:             # [B, T, 1] ids
        x = x[..., 0]
    pad = attrs.get("pad_value", 0)
    ar = torch.arange(x.shape[1], device=x.device)[None, :]
    outs = [torch.where(ar + j < length[:, None],
                        torch.roll(x, -j, dims=1), pad)
            for j in range(attrs.get("win_size", 2))]
    return {"Out": torch.stack(outs, dim=-1).to(x.dtype)}


register_op("sequence_enumerate", ["X", "Length"], ["Out"],
            infer=_seq_enum_infer, compute=_seq_enum_compute, grad=None)


# -- sequence_slice ---------------------------------------------------------

def _seq_slice_infer(op, block):
    _same_shape("X", "Out")(op, block)
    _row_lengths(op, block, "OutLength", "int32")


def _seq_slice_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    off = ins["Offset"][0].reshape(-1).long()
    size = ins["Size"][0].reshape(-1).to(torch.int32)
    t = x.shape[1]
    ar = torch.arange(t, device=x.device)[None, :]
    idx = _lead(x, (off[:, None] + ar).clamp(0, t - 1))
    got = torch.take_along_dim(x, idx.expand((-1, -1) + tuple(x.shape[2:])),
                               dim=1)
    return {"Out": torch.where(_lead(x, ar < size[:, None]), got, 0),
            "OutLength": size}


register_op("sequence_slice", ["X", "Offset", "Size", "Length"],
            ["Out", "OutLength"], infer=_seq_slice_infer,
            compute=_seq_slice_compute,
            no_grad_inputs=("Offset", "Size", "Length"))


# -- causal_mask and padding_attn_bias: attention biases --------------------

def _causal_mask_infer(op, block):
    t = op.attrs.get("seq_len", -1)
    if op.inputs.get("Ref"):
        t = in_var(op, block, "Ref").shape[1]
    set_output(op, block, "Out", (t, t), op.attrs.get("dtype", "float32"))


def _causal_mask_compute(ins, attrs, ctx, op_index):
    ref = (ins.get("Ref") or [None])[0]
    t = ref.shape[1] if ref is not None else attrs["seq_len"]
    full = torch.full((t, t), attrs.get("mask_value", -1e9),
                      dtype=convert_dtype(attrs.get("dtype", "float32")),
                      device=ctx.device)
    return {"Out": torch.triu(full, diagonal=1)}


register_op("causal_mask", ["Ref"], ["Out"], infer=_causal_mask_infer,
            compute=_causal_mask_compute, grad=None)


def _pad_bias_infer(op, block):
    ref = in_var(op, block, "Ref")
    set_output(op, block, "Out", (ref.shape[0], 1, 1, ref.shape[1]),
               op.attrs.get("dtype", "float32"))


def _pad_bias_compute(ins, attrs, ctx, op_index):
    length, ref = ins["Length"][0], ins["Ref"][0]
    valid = _time_mask(length.to(ref.device), ref.shape[1], 0)
    bias = torch.where(valid, 0.0, attrs.get("mask_value", -1e9))
    return {"Out": bias.to(convert_dtype(attrs.get("dtype", "float32")))
            [:, None, None, :]}


register_op("padding_attn_bias", ["Length", "Ref"], ["Out"],
            infer=_pad_bias_infer, compute=_pad_bias_compute, grad=None)


# -- sequence_pad / sequence_unpad / sequence_reshape -----------------------

def _seq_pad_infer(op, block):
    x = in_var(op, block, "X")
    maxlen = op.attrs.get("padded_length", -1)
    t = maxlen if maxlen and maxlen > 0 else x.shape[1]
    set_output(op, block, "Out", (x.shape[0], t) + tuple(x.shape[2:]),
               x.dtype)
    set_output(op, block, "SeqLength", (x.shape[0],), "int64")


def _seq_pad_compute(ins, attrs, ctx, op_index):
    """The padded batch re-timed to ``padded_length`` (cut or extended)
    with ``PadValue`` (0 without one) past each row's length, and the
    lengths."""
    x, length = ins["X"][0], ins["Length"][0]
    pad = (ins.get("PadValue") or [None])[0]
    t_in = x.shape[1]
    target = int(attrs.get("padded_length", -1))
    target = t_in if target <= 0 else target
    if target > t_in:
        x = torch.cat([x, x.new_zeros((x.shape[0], target - t_in)
                                      + tuple(x.shape[2:]))], dim=1)
    x = x[:, :target]
    mask = _time_mask(length.long(), target, x.dim() - 2)
    pad = pad.to(x.dtype) if pad is not None else 0
    return {"Out": torch.where(mask, x, pad),
            "SeqLength": length.to(torch.int64)}


register_op("sequence_pad", ["X", "Length", "PadValue"],
            ["Out", "SeqLength"], infer=_seq_pad_infer,
            compute=_seq_pad_compute, no_grad_inputs=("Length", "PadValue"))


def _seq_unpad_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "Out", x.shape, x.dtype, lod_level=1)


def _seq_unpad_compute(ins, attrs, ctx, op_index):
    x, length = ins["X"][0], ins["Length"][0]
    mask = _time_mask(length.long(), x.shape[1], x.dim() - 2)
    return {"Out": torch.where(mask, x, 0),
            "OutLength": length.to(torch.int32)}


register_op("sequence_unpad", ["X", "Length"], ["Out", "OutLength"],
            infer=_seq_unpad_infer, compute=_seq_unpad_compute,
            no_grad_inputs=("Length",))


def _seq_reshape_infer(op, block):
    x = in_var(op, block, "X")
    new_dim = int(op.attrs["new_dim"])
    t, d = x.shape[1], x.shape[-1]
    known = t not in (-1, None) and d not in (-1, None)
    if known and (t * d) % new_dim:
        raise ValueError(
            "sequence_reshape: T*D = %d*%d is not divisible by new_dim %d"
            % (t, d, new_dim))
    set_output(op, block, "Out",
               (x.shape[0], (t * d) // new_dim if known else -1, new_dim),
               x.dtype, lod_level=1)


def _seq_reshape_compute(ins, attrs, ctx, op_index):
    """Each sequence's len * D values re-chunked into rows of
    ``new_dim``: a plain reshape, since a row's steps are contiguous and
    its tail is zeros."""
    x, length = ins["X"][0], ins["Length"][0]
    b, t, d = x.shape
    new_dim = int(attrs["new_dim"])
    return {"Out": x.reshape(b, (t * d) // new_dim, new_dim),
            "OutLength": ((length.long() * d) // new_dim).to(torch.int32)}


register_op("sequence_reshape", ["X", "Length"], ["Out", "OutLength"],
            infer=_seq_reshape_infer, compute=_seq_reshape_compute,
            no_grad_inputs=("Length",))


# -- sequence_expand_as / sequence_scatter ----------------------------------

def _seq_expand_as_infer(op, block):
    x, y = in_var(op, block, "X"), in_var(op, block, "Y")
    set_output(op, block, "Out", (x.shape[0], y.shape[1])
               + tuple(x.shape[1:]), x.dtype, lod_level=1)


def _seq_expand_as_compute(ins, attrs, ctx, op_index):
    """Row b of X [B, ...] repeated over Y's sequence b: [B, Ty, ...],
    zeros past its length."""
    x, y_len = ins["X"][0], ins["YLength"][0]
    t = ins["Y"][0].shape[1]
    out = x[:, None].expand((x.shape[0], t) + tuple(x.shape[1:]))
    mask = _time_mask(y_len.long().to(x.device), t, out.dim() - 2)
    return {"Out": torch.where(mask, out, 0),
            "OutLength": y_len.to(torch.int32)}


register_op("sequence_expand_as", ["X", "Y", "YLength"],
            ["Out", "OutLength"], infer=_seq_expand_as_infer,
            compute=_seq_expand_as_compute,
            no_grad_inputs=("Y", "YLength"))


def _seq_scatter_compute(ins, attrs, ctx, op_index):
    """out[b, ids[b, u]] += updates[b, u] for u below row b's length; a
    negative id counts from the end of the row, one out of the row is
    dropped.  Repeated ids add in the order of their units."""
    x = ins["X"][0]                                   # [B, D]
    ids, upd = ins["Ids"][0], ins["Updates"][0]
    if ids.dim() == 3:
        ids = ids[:, :, 0]
    if upd.dim() == 3:
        upd = upd[:, :, 0]
    b, d = x.shape
    ids = ids.long()
    ids = torch.where(ids < 0, ids + d, ids)
    valid = (ids >= 0) & (ids < d) & _time_mask(
        ins["Length"][0].long(), ids.shape[1], 0)
    # [B, D + 1] flattened: a dropped unit adds to its row's spare slot
    rows = torch.arange(b, device=x.device)[:, None]
    target = (rows * (d + 1) + torch.where(valid, ids, d)).reshape(-1)
    buf = torch.cat([x, x.new_zeros((b, 1))], dim=1).reshape(-1)
    upd = upd.to(x.dtype).reshape(-1)
    out = add_at(buf, target, upd)
    return {"Out": out.reshape(b, d + 1)[:, :d]}


register_op("sequence_scatter", ["X", "Ids", "Updates", "Length"], ["Out"],
            infer=_same_shape("X", "Out"), compute=_seq_scatter_compute,
            no_grad_inputs=("Ids", "Length"))


# -- im2sequence ------------------------------------------------------------

def _im2sequence_infer(op, block):
    x = in_var(op, block, "X")
    b, c, h, w = x.shape
    kh, kw = op.attrs["kernels"]
    sh, sw = op.attrs.get("strides", [1, 1])
    p = op.attrs.get("paddings", [0, 0, 0, 0])
    if h in (-1, None) or w in (-1, None):
        t = -1
    else:
        t = ((h + p[0] + p[2] - kh) // sh + 1) \
            * ((w + p[1] + p[3] - kw) // sw + 1)
    d = None if c in (-1, None) else c * kh * kw
    set_output(op, block, "Out", (b, t, d), x.dtype, lod_level=1)


def _im2sequence_compute(ins, attrs, ctx, op_index):
    """[B, C, H, W] -> [B, oh * ow, C * kh * kw] patches (features in
    (C, kh, kw) order); paddings are (top, left, bottom, right)."""
    x = ins["X"][0]
    p = attrs.get("paddings", [0, 0, 0, 0])
    x = F.pad(x, (p[1], p[3], p[0], p[2]))
    patches = F.unfold(x, tuple(attrs["kernels"]),
                       stride=tuple(attrs.get("strides", [1, 1])))
    out = patches.transpose(1, 2)
    return {"Out": out, "OutLength": torch.full(
        (x.shape[0],), out.shape[1], dtype=torch.int32, device=x.device)}


register_op("im2sequence", ["X"], ["Out", "OutLength"],
            infer=_im2sequence_infer, compute=_im2sequence_compute)


# -- lod_reset --------------------------------------------------------------

def _lod_reset_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "Out", x.shape, x.dtype, lod_level=1)
    _row_lengths(op, block, "Length", "int64")


def _lod_reset_compute(ins, attrs, ctx, op_index):
    """X as it is, with new lengths: the differences of Y's level-0
    offsets, or of the ``target_lod`` attr's (a constant of the op)."""
    x = ins["X"][0]
    y = (ins.get("Y") or [None])[0]
    if y is not None:
        offsets = y.reshape(-1).long()
        lengths = offsets[1:] - offsets[:-1]
    else:
        tl = attrs.get("target_lod")
        if not tl:
            raise ValueError("lod_reset needs input Y or attr target_lod")
        lengths = device_constant(np.diff(np.asarray(tl, np.int64)),
                                  x.device)
    if lengths.shape[0] != x.shape[0]:
        raise ValueError(
            "lod_reset: %d target sequences but the padded batch has %d "
            "rows; the padded representation cannot change the sequence "
            "count" % (lengths.shape[0], x.shape[0]))
    return {"Out": x, "Length": lengths}


register_op("lod_reset", ["X", "Y"], ["Out", "Length"],
            infer=_lod_reset_infer, compute=_lod_reset_compute,
            no_grad_inputs=("Y",))


# -- the rank-table family --------------------------------------------------

def _lod_rank_table_infer(op, block):
    set_output(op, block, "Out", (in_var(op, block, "Length").shape[0], 2),
               "int64")


def _lod_rank_table_compute(ins, attrs, ctx, op_index):
    lens = ins["Length"][0].reshape(-1).long()
    order = torch.sort(lens, descending=True, stable=True).indices
    return {"Out": torch.stack([order, lens[order]], dim=1)}


register_op("lod_rank_table", ["Length"], ["Out"],
            infer=_lod_rank_table_infer, compute=_lod_rank_table_compute,
            grad=None)


register_op(
    "max_sequence_len", ["RankTable"], ["Out"],
    infer=lambda op, block: set_output(op, block, "Out", (), "int64"),
    compute=lambda ins, attrs, ctx, op_index: {
        "Out": ins["RankTable"][0][0, 1]},
    grad=None)


def _reorder_by_rank_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "Out", x.shape, x.dtype,
               lod_level=getattr(x, "lod_level", 0))
    _row_lengths(op, block, "OutLength", "int64")


def _reorder_by_rank_compute(ins, attrs, ctx, op_index):
    table = ins["RankTable"][0].long()
    return {"Out": torch.index_select(ins["X"][0], 0, table[:, 0]),
            "OutLength": table[:, 1]}


register_op("reorder_lod_tensor_by_rank", ["X", "RankTable"],
            ["Out", "OutLength"], infer=_reorder_by_rank_infer,
            compute=_reorder_by_rank_compute, no_grad_inputs=("RankTable",))


def _lod_tensor_to_array_infer(op, block):
    x = in_var(op, block, "X")
    t = x.shape[1] if len(x.shape) > 1 else -1
    set_output(op, block, "Out", (t, x.shape[0]) + tuple(x.shape[2:]),
               x.dtype)
    _row_lengths(op, block, "OutLength", "int64")


def _lod_tensor_to_array_compute(ins, attrs, ctx, op_index):
    """[B, T, ...] -> time-major step batches [T, B, ...] in rank
    order."""
    table = ins["RankTable"][0].long()
    ranked = torch.index_select(ins["X"][0], 0, table[:, 0])
    return {"Out": ranked.transpose(0, 1), "OutLength": table[:, 1]}


register_op("lod_tensor_to_array", ["X", "RankTable"],
            ["Out", "OutLength"], infer=_lod_tensor_to_array_infer,
            compute=_lod_tensor_to_array_compute,
            no_grad_inputs=("RankTable",))


def _array_to_lod_tensor_infer(op, block):
    x = in_var(op, block, "X")
    b = x.shape[1] if len(x.shape) > 1 else -1
    set_output(op, block, "Out", (b, x.shape[0]) + tuple(x.shape[2:]),
               x.dtype, lod_level=1)
    set_output(op, block, "OutLength", (b,), "int64")


def _array_to_lod_tensor_compute(ins, attrs, ctx, op_index):
    """The inverse of ``lod_tensor_to_array``: the batch and its lengths
    back in batch order."""
    table = ins["RankTable"][0].long()
    inv = torch.argsort(table[:, 0], stable=True)
    return {"Out": torch.index_select(ins["X"][0].transpose(0, 1), 0, inv),
            "OutLength": torch.index_select(table[:, 1], 0, inv)}


register_op("array_to_lod_tensor", ["X", "RankTable"],
            ["Out", "OutLength"], infer=_array_to_lod_tensor_infer,
            compute=_array_to_lod_tensor_compute,
            no_grad_inputs=("RankTable",))
