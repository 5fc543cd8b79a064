"""``reshape``, ``transpose``, ``squeeze``, ``unsqueeze``, ``slice``,
``lookup_table``, ``concat``, ``top_k`` and the plain op library's
``flatten``, ``split``, ``stack``, ``unstack``, ``expand``, ``reverse``,
``pad``, ``pad2d``, ``pad_constant_like``, ``crop``, ``gather``,
``scatter``, ``one_hot``, ``label_smooth``, ``multiplex``, ``argsort``,
``is_empty``, ``fill`` and ``scale_sub_region`` (counterpart of
``paddle_tpu/ops/manipulation.py``).

Indices out of range never reach a CUDA indexing kernel (which would
assert); each op reproduces what the JAX op returns for them on the
host: ``gather`` is ``jnp.take``: a negative id counts from the end and
an id still out of range gives a row of NaN (an integer table's least
value, True for bool).  ``scatter`` is ``.at[ids].set`` / ``.add``: a
negative id counts from the end, an id still out of range is dropped;
with ``overwrite`` and a repeated id the last update wins (XLA's order on
the host), on both devices, and without it the repeated ids' updates sum
in their order, on both devices: ``index_put_(accumulate=True)`` sorts
by row and adds each row's units in order on the card, ``index_add``
adds them one by one on the host.  ``multiplex`` is ``take_along_axis`` over [n, batch,
d] candidates (NaN past the end) and, for other ranks, jnp indexing,
which clamps the id and gives the clamped row no gradient.  ``argsort`` is stable (ties keep their order, NaN
last).  ``crop`` takes a negative offset from the end and then clamps
the start into the input, as ``lax.dynamic_slice`` does, also when the
offsets come at run time.
``transpose`` returns a strided view; consumers that need contiguous
memory (the kernels) make it so.  ``lookup_table``'s dense table gradient
sums the rows of repeated ids in a fixed order (``_Gather``), so that two
runs of a step give the same bits, as XLA's scatter-add does on the TPU;
with ``is_sparse`` its gradient is a SelectedRows
(``selected_rows.lookup_table_grad_maker``)."""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core import convert_dtype
from ..registry import in_var, register_op, set_output
from .creation import device_constant
from .selected_rows import lookup_table_grad_maker


class _Gather(torch.autograd.Function):
    """``w.index_select(0, ids)`` whose backward accumulates with
    ``index_put_(accumulate=True)``: on the card a sort by id, then each
    id's rows summed in their order, where ``index_select``'s own backward
    (``index_add_``) adds them with atomics in whatever order they land."""

    @staticmethod
    def forward(ctx, w, ids):
        ctx.save_for_backward(ids)
        ctx.rows = w.shape[0]
        return w.index_select(0, ids)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        dw = grad.new_zeros((ctx.rows,) + tuple(grad.shape[1:]))
        return dw.index_put_((ids,), grad, accumulate=True), None


def _resolve_reshape(in_shape, spec):
    out = [in_shape[i] if s == 0 else s for i, s in enumerate(spec)]
    if -1 in out:
        known = 1
        for s in out:
            if s != -1:
                known *= s
        total = 1
        for s in in_shape:
            total *= s
        out[out.index(-1)] = total // known
    return tuple(out)


def _reshape_infer(op, block):
    x = in_var(op, block, "X")
    spec = list(op.attrs["shape"])
    if -1 not in x.shape:
        out = _resolve_reshape(x.shape, spec)
    else:
        # dynamic dims present: 0 copies the input dim (possibly -1),
        # -1 stays symbolic
        out = tuple(
            (x.shape[i] if i < len(x.shape) else -1) if s == 0 else s
            for i, s in enumerate(spec))
    set_output(op, block, "Out", out, x.dtype)


def _reshape_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    return {"Out": x.reshape(_resolve_reshape(tuple(x.shape),
                                              list(attrs["shape"])))}


register_op("reshape", ["X"], ["Out"], infer=_reshape_infer,
            compute=_reshape_compute)


def _transpose_infer(op, block):
    x = in_var(op, block, "X")
    perm = op.attrs["axis"]
    set_output(op, block, "Out", tuple(x.shape[p] for p in perm), x.dtype)


register_op(
    "transpose", ["X"], ["Out"], infer=_transpose_infer,
    compute=lambda ins, attrs, ctx, op_index: {
        "Out": ins["X"][0].permute(*attrs["axis"])},
)


def _lookup_table_infer(op, block):
    w = in_var(op, block, "W")
    ids = in_var(op, block, "Ids")
    shape = tuple(ids.shape[:-1]) + (w.shape[1],) if ids.shape[-1] == 1 \
        else tuple(ids.shape) + (w.shape[1],)
    set_output(op, block, "Out", shape, w.dtype)


def _lookup_table_compute(ins, attrs, ctx, op_index):
    w, ids = ins["W"][0], ins["Ids"][0]
    squeeze = ids.dim() > 0 and ids.shape[-1] == 1
    flat = ids.reshape(-1)
    out = _Gather.apply(w, flat)
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad != -1:
        out = out * (flat != pad)[:, None].to(out.dtype)
    shape = (tuple(ids.shape[:-1]) if squeeze else tuple(ids.shape)) \
        + (w.shape[1],)
    return {"Out": out.reshape(shape)}


register_op("lookup_table", ["W", "Ids"], ["Out"], infer=_lookup_table_infer,
            compute=_lookup_table_compute, grad=lookup_table_grad_maker,
            no_grad_inputs=("Ids",))


def _concat_infer(op, block):
    xs = [block.var_recursive(n) for n in op.inputs["X"]]
    axis = op.attrs.get("axis", 0) % len(xs[0].shape)
    out = list(xs[0].shape)
    sizes = [v.shape[axis] for v in xs]
    # an unknown (-1) part makes the result unknown
    out[axis] = -1 if any(s < 0 for s in sizes) else sum(sizes)
    set_output(op, block, "Out", out, xs[0].dtype)


register_op("concat", ["X"], ["Out"], infer=_concat_infer,
            compute=lambda ins, attrs, ctx, op_index: {
                "Out": torch.cat(ins["X"], dim=attrs.get("axis", 0))})


def _squeeze_infer(op, block):
    x = in_var(op, block, "X")
    axes = [a % len(x.shape) for a in op.attrs.get("axes", [])]
    if axes:
        out = tuple(s for i, s in enumerate(x.shape)
                    if i not in axes or s != 1)
    else:
        out = tuple(s for s in x.shape if s != 1)
    set_output(op, block, "Out", out, x.dtype)


def _squeeze_compute(ins, attrs, ctx, op_index):
    """Drop the size-1 dims among ``axes`` (a listed dim of another size
    stays), or every size-1 dim when ``axes`` is empty."""
    x = ins["X"][0]
    axes = attrs.get("axes", [])
    if not axes:
        return {"Out": x.squeeze()}
    keep = [s for i, s in enumerate(x.shape)
            if s != 1 or i not in {a % x.dim() for a in axes}]
    return {"Out": x.reshape(keep)}


register_op("squeeze", ["X"], ["Out"], infer=_squeeze_infer,
            compute=_squeeze_compute)


def _unsqueeze_infer(op, block):
    x = in_var(op, block, "X")
    out = list(x.shape)
    for a in sorted(op.attrs["axes"]):
        out.insert(a if a >= 0 else a + len(out) + 1, 1)
    set_output(op, block, "Out", out, x.dtype)


def _unsqueeze_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    for a in sorted(attrs["axes"]):
        x = x.unsqueeze(a if a >= 0 else a + x.dim() + 1)
    return {"Out": x}


register_op("unsqueeze", ["X"], ["Out"], infer=_unsqueeze_infer,
            compute=_unsqueeze_compute)


def _slice_infer(op, block):
    x = in_var(op, block, "Input")
    shape = list(x.shape)
    for ax, st, en in zip(op.attrs["axes"], op.attrs["starts"],
                          op.attrs["ends"]):
        dim = shape[ax]
        st2 = max(st + dim, 0) if st < 0 else min(st, dim)
        en2 = max(en + dim, 0) if en < 0 else min(en, dim)
        shape[ax] = max(en2 - st2, 0)
    set_output(op, block, "Out", shape, x.dtype)


def _slice_compute(ins, attrs, ctx, op_index):
    x = ins["Input"][0]
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        idx[ax] = slice(st, en)
    return {"Out": x[tuple(idx)]}


register_op("slice", ["Input"], ["Out"], infer=_slice_infer,
            compute=_slice_compute)


def _top_k_infer(op, block):
    x = in_var(op, block, "X")
    out = tuple(x.shape[:-1]) + (op.attrs["k"],)
    set_output(op, block, "Out", out, x.dtype)
    set_output(op, block, "Indices", out, "int64")


def _top_k_compute(ins, attrs, ctx, op_index):
    """The k largest of the last axis, largest first; equal values in the
    order of their index, lowest first, as ``jax.lax.top_k`` gives them
    (``torch.topk`` promises no order among ties on the card)."""
    vals, idx = torch.sort(ins["X"][0], dim=-1, descending=True,
                           stable=True)
    k = attrs["k"]
    return {"Out": vals[..., :k], "Indices": idx[..., :k]}


register_op("top_k", ["X"], ["Out", "Indices"], infer=_top_k_infer,
            compute=_top_k_compute, grad=None)



def _same_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "Out", x.shape, x.dtype)


def _flatten_infer(op, block):
    x = in_var(op, block, "X")
    axis = op.attrs.get("axis", 1)
    set_output(op, block, "Out", (math.prod(x.shape[:axis]),
                                  math.prod(x.shape[axis:])), x.dtype)


register_op("flatten", ["X"], ["Out"], infer=_flatten_infer,
            compute=lambda ins, attrs, ctx, op_index: {
                "Out": ins["X"][0].reshape(
                    math.prod(ins["X"][0].shape[:attrs.get("axis", 1)]),
                    -1)})


def _split_infer(op, block):
    x = in_var(op, block, "X")
    axis = op.attrs.get("axis", 0) % len(x.shape)
    outs = op.outputs["Out"]
    sizes = op.attrs.get("sections", []) or \
        [x.shape[axis] // (op.attrs.get("num", 0) or len(outs))] * len(outs)
    for name, size in zip(outs, sizes):
        shape = list(x.shape)
        shape[axis] = size
        v = block._find_var_recursive(name) or block.create_var(name=name)
        v.shape, v.dtype = tuple(shape), x.dtype


def _split_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    axis = attrs.get("axis", 0) % x.dim()
    sizes = attrs.get("sections", [])
    if not sizes:
        n = attrs.get("num", 0) or attrs["__num_outputs__"]
        sizes = [x.shape[axis] // n] * n
    return {"Out": list(torch.split(x, list(sizes), dim=axis))}


register_op("split", ["X"], ["Out"], infer=_split_infer,
            compute=_split_compute)


def _stack_infer(op, block):
    xs = [block.var_recursive(n) for n in op.inputs["X"]]
    axis = op.attrs.get("axis", 0)
    out = list(xs[0].shape)
    out.insert(axis if axis >= 0 else axis + len(out) + 1, len(xs))
    set_output(op, block, "Y", out, xs[0].dtype)


register_op("stack", ["X"], ["Y"], infer=_stack_infer,
            compute=lambda ins, attrs, ctx, op_index: {
                "Y": torch.stack(ins["X"], dim=attrs.get("axis", 0))})


def _unstack_infer(op, block):
    x = in_var(op, block, "X")
    axis = op.attrs.get("axis", 0) % len(x.shape)
    for name in op.outputs.get("Y", []):
        v = block._find_var_recursive(name) or block.create_var(name=name)
        v.shape = tuple(x.shape[:axis]) + tuple(x.shape[axis + 1:])
        v.dtype = x.dtype


register_op("unstack", ["X"], ["Y"], infer=_unstack_infer,
            compute=lambda ins, attrs, ctx, op_index: {
                "Y": list(torch.unbind(ins["X"][0],
                                       dim=attrs.get("axis", 0)))})


def _expand_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "Out", tuple(s * t for s, t in zip(
        x.shape, op.attrs["expand_times"])), x.dtype)


def _expand_compute(ins, attrs, ctx, op_index):
    # jnp.tile: fewer reps than dims repeat the trailing dims
    x, times = ins["X"][0], list(attrs["expand_times"])
    return {"Out": x.repeat(*([1] * (x.dim() - len(times)) + times))}


register_op("expand", ["X"], ["Out"], infer=_expand_infer,
            compute=_expand_compute)

register_op("reverse", ["X"], ["Out"], infer=_same_infer,
            compute=lambda ins, attrs, ctx, op_index: {
                "Out": torch.flip(ins["X"][0], dims=tuple(attrs["axis"]))})


def _pad_infer(op, block):
    x = in_var(op, block, "X")
    p = op.attrs["paddings"]
    set_output(op, block, "Out", [s + p[2 * i] + p[2 * i + 1]
                                  for i, s in enumerate(x.shape)], x.dtype)


def _torch_pads(pairs):
    """[(before, after)] a dim, first dim first, as F.pad's flat list
    (last dim first)."""
    return [p for pair in reversed(pairs) for p in pair]


register_op("pad", ["X"], ["Out"], infer=_pad_infer,
            compute=lambda ins, attrs, ctx, op_index: {
                "Out": F.pad(ins["X"][0], _torch_pads(
                    list(zip(attrs["paddings"][0::2],
                             attrs["paddings"][1::2]))),
                    value=attrs.get("pad_value", 0.0))})


def _pad2d_infer(op, block):
    x = in_var(op, block, "X")
    p = op.attrs["paddings"]   # [top, bottom, left, right]
    n, a, b, c = x.shape
    if op.attrs.get("data_format", "NCHW") == "NCHW":
        out = (n, a, b + p[0] + p[1], c + p[2] + p[3])
    else:
        out = (n, a + p[0] + p[1], b + p[2] + p[3], c)
    set_output(op, block, "Out", out, x.dtype)


_PAD2D_MODES = {"constant": "constant", "reflect": "reflect",
                "edge": "replicate"}


def _pad2d_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    mode = attrs.get("mode", "constant")
    if mode not in _PAD2D_MODES:
        raise ValueError("pad2d: unknown mode %r" % mode)
    nhwc = attrs.get("data_format", "NCHW") != "NCHW"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    t, b, l, r = attrs["paddings"]
    kw = {"value": attrs.get("pad_value", 0.0)} if mode == "constant" \
        else {}
    out = F.pad(x, [l, r, t, b], mode=_PAD2D_MODES[mode], **kw)
    return {"Out": out.permute(0, 2, 3, 1) if nhwc else out}


register_op("pad2d", ["X"], ["Out"], infer=_pad2d_infer,
            compute=_pad2d_compute)


def _pad_constant_like_infer(op, block):
    set_output(op, block, "Out", in_var(op, block, "X").shape,
               in_var(op, block, "Y").dtype)


def _pad_constant_like_compute(ins, attrs, ctx, op_index):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": F.pad(y, _torch_pads(
        [(0, sx - sy) for sx, sy in zip(x.shape, y.shape)]),
        value=attrs.get("pad_value", 0.0))}


register_op("pad_constant_like", ["X", "Y"], ["Out"],
            infer=_pad_constant_like_infer,
            compute=_pad_constant_like_compute, no_grad_inputs=("X",))


def _crop_infer(op, block):
    x = in_var(op, block, "X")
    shape = op.attrs.get("shape") or in_var(op, block, "Y").shape
    set_output(op, block, "Out", tuple(shape), x.dtype)


def _crop_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    shape = list(attrs.get("shape") or ins["Y"][0].shape)
    offsets = ins.get("Offsets", [None])[0]
    if offsets is None:
        offs = list(attrs.get("offsets") or [0] * x.dim())
        # -1: the rest of the dim from its offset
        shape = [x.shape[i] - offs[i] if s == -1 else s
                 for i, s in enumerate(shape)]
        # lax.dynamic_slice: a negative start counts from the end, then
        # the start clamps so the window fits
        starts = [min(max(o + d if o < 0 else o, 0), d - s)
                  for o, s, d in zip(offs, shape, x.shape)]
        return {"Out": x[tuple(slice(st, st + s)
                               for st, s in zip(starts, shape))]}
    if attrs.get("offsets"):
        raise ValueError(
            "crop: runtime input Offsets and attr offsets are mutually "
            "exclusive (crop_op.cc contract)")
    if any(s == -1 for s in shape):
        raise ValueError(
            "crop: shape dims of -1 require attr offsets, not the runtime "
            "Offsets input (the window's size must be known)")
    # the offsets stay on the device: one index vector a dim, broadcast
    offsets = offsets.reshape(-1).long()
    idx = []
    for d, (s, dim) in enumerate(zip(shape, x.shape)):
        start = offsets[d:d + 1]
        start = torch.where(start < 0, start + dim, start).clamp(0, dim - s)
        view = [1] * x.dim()
        view[d] = s
        idx.append((start + torch.arange(s, device=x.device)).reshape(view))
    return {"Out": x[tuple(idx)]}


register_op("crop", ["X", "Y", "Offsets"], ["Out"], infer=_crop_infer,
            compute=_crop_compute, no_grad_inputs=("Y", "Offsets"))


def _fill_value(dtype):
    """``jnp.take``'s fill for an out-of-range index."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.max if dtype == torch.uint8 else info.min


def _wrap(ids, n):
    """Negative ids counted from the end, and which ids are then in
    [0, n)."""
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids)
    return ids, (ids >= 0) & (ids < n)


def _gather_infer(op, block):
    x, ids = in_var(op, block, "X"), in_var(op, block, "Index")
    set_output(op, block, "Out", (ids.shape[0],) + tuple(x.shape[1:]),
               x.dtype)


def _gather_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    ids, valid = _wrap(ins["Index"][0].reshape(-1), x.shape[0])
    out = _Gather.apply(x, torch.where(valid, ids, torch.zeros_like(ids)))
    valid = valid.reshape((-1,) + (1,) * (x.dim() - 1))
    return {"Out": torch.where(valid, out, _fill_value(x.dtype))}


register_op("gather", ["X", "Index"], ["Out"], infer=_gather_infer,
            compute=_gather_compute, no_grad_inputs=("Index",))


def add_at(buf, idx, vals):
    """``buf`` with ``vals`` added at rows ``idx`` (in range), each row's
    units summed in their order: on the card ``index_put`` sorts by row;
    on the host ``index_add`` adds unit by unit (the host's
    ``index_put_`` adds with atomics across threads)."""
    if buf.device.type == "cuda":
        return buf.index_put((idx,), vals.to(buf.dtype), accumulate=True)
    return buf.index_add(0, idx, vals.to(buf.dtype))


def _scatter_compute(ins, attrs, ctx, op_index):
    """Rows of a [H + 1, ...] copy of X: the dropped units (and, with
    ``overwrite``, the units a later one overrides) write the extra row,
    which is cut off, so each kept row is written by one unit or summed
    in a fixed order."""
    x, upd = ins["X"][0], ins["Updates"][0]
    h = x.shape[0]
    ids, valid = _wrap(ins["Ids"][0].reshape(-1), h)
    spill = torch.full_like(ids, h)
    target = torch.where(valid, ids, spill)
    buf = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    if attrs.get("overwrite", True):
        # the last unit that names a row is the one that writes it
        pos = torch.arange(ids.shape[0], device=ids.device)
        last = torch.full((h + 1,), -1, dtype=torch.long,
                          device=ids.device).scatter_reduce(
            0, target, pos, reduce="amax")
        target = torch.where(last[target] == pos, target, spill)
        out = buf.index_put((target,), upd.to(x.dtype))
    else:
        out = add_at(buf, target, upd)
    return {"Out": out[:h]}


register_op("scatter", ["X", "Ids", "Updates"], ["Out"], infer=_same_infer,
            compute=_scatter_compute, no_grad_inputs=("Ids",))


def _one_hot_infer(op, block):
    x = in_var(op, block, "X")
    depth = op.attrs["depth"]
    shape = tuple(x.shape[:-1]) + (depth,) if x.shape[-1] == 1 \
        else tuple(x.shape) + (depth,)
    set_output(op, block, "Out", shape, "float32")


def _one_hot_compute(ins, attrs, ctx, op_index):
    # an id outside [0, depth) matches no column: a row of zeros, as in
    # jax.nn.one_hot
    x = ins["X"][0]
    if x.dim() and x.shape[-1] == 1:
        x = x.reshape(x.shape[:-1])
    cols = torch.arange(attrs["depth"], device=x.device)
    return {"Out": (x.long()[..., None] == cols).to(torch.float32)}


register_op("one_hot", ["X"], ["Out"], infer=_one_hot_infer,
            compute=_one_hot_compute, grad=None)


def _label_smooth_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    eps = attrs.get("epsilon", 0.0)
    prior = ins.get("PriorDist", [None])[0]
    if prior is not None:
        return {"Out": (1 - eps) * x + eps * prior}
    return {"Out": (1 - eps) * x + eps / x.shape[-1]}


register_op("label_smooth", ["X", "PriorDist"], ["Out"], infer=_same_infer,
            compute=_label_smooth_compute)


def _multiplex_compute(ins, attrs, ctx, op_index):
    stacked = torch.stack(ins["X"], dim=0)        # [n, batch, ...]
    n, b = stacked.shape[:2]
    ids, valid = _wrap(ins["Ids"][0].reshape(-1), n)
    out = stacked[ids.clamp(0, n - 1), torch.arange(b, device=ids.device)]
    valid = valid.reshape((b,) + (1,) * (out.dim() - 1))
    if stacked.dim() == 3:
        return {"Out": torch.where(valid, out, _fill_value(out.dtype))}
    # XLA clamps the gather but drops the scatter of its gradient
    return {"Out": torch.where(valid, out, out.detach())}


register_op("multiplex", ["X", "Ids"], ["Out"], infer=_same_infer,
            compute=_multiplex_compute, no_grad_inputs=("Ids",))


def _argsort_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "Out", x.shape, x.dtype)
    set_output(op, block, "Indices", x.shape, "int64")


def _argsort_compute(ins, attrs, ctx, op_index):
    vals, idx = torch.sort(ins["X"][0], dim=attrs.get("axis", -1),
                           stable=True)
    return {"Out": vals, "Indices": idx}


register_op("argsort", ["X"], ["Out", "Indices"], infer=_argsort_infer,
            compute=_argsort_compute, grad=None)

register_op(
    "is_empty", ["X"], ["Out"],
    infer=lambda op, block: set_output(op, block, "Out", (1,), "bool"),
    # the shape is known on the host: a fill, no device value read
    compute=lambda ins, attrs, ctx, op_index: {
        "Out": torch.full((1,), ins["X"][0].numel() == 0, dtype=torch.bool,
                          device=ins["X"][0].device)},
    grad=None)


def _fill_infer(op, block):
    set_output(op, block, "Out", op.attrs["shape"],
               op.attrs.get("dtype", "float32"))


def _fill_compute(ins, attrs, ctx, op_index):
    dtype = convert_dtype(attrs.get("dtype", "float32"))
    vals = np.asarray(attrs["value"], dtype=np.float64).reshape(
        tuple(attrs["shape"]))
    return {"Out": device_constant(vals, ctx.device).to(dtype)}


register_op("fill", [], ["Out"], infer=_fill_infer, compute=_fill_compute,
            grad=None)


def _scale_sub_region_compute(ins, attrs, ctx, op_index):
    """Scale each sample's [c0..c1, h0..h1, w0..w1] block (``Indices``
    [B, 6], 1-based and inclusive) of an NCHW X by ``value``."""
    x, idx = ins["X"][0], ins["Indices"][0].long()
    b = x.shape[0]
    lo, hi = idx[:, 0::2] - 1, idx[:, 1::2]           # [B, 3]
    mask = torch.ones_like(x, dtype=torch.bool)
    for d in range(3):
        view = [1, 1, 1, 1]
        view[d + 1] = x.shape[d + 1]
        pos = torch.arange(x.shape[d + 1], device=x.device).reshape(view)
        mask = mask & (pos >= lo[:, d].reshape(b, 1, 1, 1)) \
            & (pos < hi[:, d].reshape(b, 1, 1, 1))
    return {"Out": torch.where(mask, x * attrs.get("value", 1.0), x)}


register_op("scale_sub_region", ["X", "Indices"], ["Out"],
            infer=_same_infer, compute=_scale_sub_region_compute,
            no_grad_inputs=("Indices",))
