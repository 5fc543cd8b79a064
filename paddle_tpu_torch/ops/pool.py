"""Pooling (counterpart of ``paddle_tpu/ops/pool.py``): ``pool2d`` and
``pool3d`` (max and avg, ``global_pooling``, ``adaptive``, ``exclusive``
avg counting, ``ceil_mode``; ``pool2d`` also NHWC under ``data_format``),
``max_pool2d_with_index`` / ``max_pool3d_with_index`` with their grad op
``max_pool_with_index_grad``, ``spp`` and ``unpool``.

The JAX package pools with ``lax.reduce_window`` over explicit (lo, hi)
padding, where ``ceil_mode`` extends hi so the last window fits; max
padding counts as -inf (the reduction's init) and the exclusive avg
divides by the number of in-bounds elements of each window.  Here the
common case (no ceil extension, padding within half the window) is
``F.max_pool{2,3}d`` / ``F.avg_pool{2,3}d`` with the same semantics
(``count_include_pad=not exclusive``); any other padding is applied
explicitly first.  NHWC pools a channels-last view of the NHWC memory.
Adaptive pooling reduces one spatial axis at a time, cell i covering
``[floor(i L / out), ceil((i + 1) L / out))``, as the JAX package does (an
average is then a mean of means: equal to the window's mean up to
rounding).

``max_pool*_with_index``'s ``Mask`` is int32: each window's flat offset
into the unpadded input plane of its first maximum (a window wholly in the
padding gives ``finfo.min`` and -1, as the JAX reduction's init does).  It
is computed from the unfolded windows with ``argmax`` (the first maximum
in window order), not ``F.max_pool*d(return_indices=True)``, whose indices
are int64 with a tie order of their own.  ``unpool`` scatters into a spare
slot past each plane for an index the JAX package's ``mode="drop"`` drops
(``ops/selected_rows.py``'s way: a CUDA scatter never sees an index out of
range).  The other gradients are the generic ``<type>_grad``."""

import torch
import torch.nn.functional as F

from ..framework import grad_var_name
from ..registry import in_var, int_list, register_op, set_output


def _pool_out_dim(in_size, k, pad, stride, ceil_mode):
    if in_size is None or in_size < 0:
        return -1
    if ceil_mode:
        return -(-(in_size + 2 * pad - k) // stride) + 1
    return (in_size + 2 * pad - k) // stride + 1


def _pool_infer_nd(nd):
    def infer(op, block):
        x = in_var(op, block, "X")
        attrs = op.attrs
        nhwc = attrs.get("data_format", "NCHW") == "NHWC" and nd == 2
        sp0 = 1 if nhwc else 2
        if attrs.get("global_pooling", False):
            spatial = [1] * nd
        elif attrs.get("adaptive", False):
            spatial = int_list(attrs.get("ksize"), nd)
        else:
            ks = int_list(attrs.get("ksize"), nd)
            strides = int_list(attrs.get("strides", 1), nd)
            pads = int_list(attrs.get("paddings", 0), nd)
            ceil = attrs.get("ceil_mode", False)
            spatial = [_pool_out_dim(x.shape[sp0 + i], ks[i], pads[i],
                                     strides[i], ceil) for i in range(nd)]
        if nhwc:
            shape = (x.shape[0], *spatial, x.shape[3])
        else:
            shape = (*x.shape[:2], *spatial)
        set_output(op, block, "Out", shape, x.dtype)
    return infer


def adaptive_pool(x, out_sizes, nd, is_max, sp0=2):
    """Adaptive pooling, one spatial axis at a time: output cell i covers
    ``[floor(i L / out), ceil((i + 1) L / out))`` of an axis of length L."""
    for d in range(nd):
        axis = sp0 + d
        size, out = x.shape[axis], out_sizes[d]
        pieces = []
        for i in range(out):
            lo, hi = (i * size) // out, -(-((i + 1) * size) // out)
            part = x.narrow(axis, lo, hi - lo)
            pieces.append(torch.amax(part, dim=axis, keepdim=True) if is_max
                          else torch.mean(part, dim=axis, keepdim=True))
        x = torch.cat(pieces, dim=axis)
    return x


_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_channels_first(x, attrs, is_max, nd):
    ks = int_list(attrs.get("ksize"), nd)
    strides = int_list(attrs.get("strides", 1), nd)
    pads = int_list(attrs.get("paddings", 0), nd)
    ceil = attrs.get("ceil_mode", False)
    exclusive = attrs.get("exclusive", True)
    his = []
    for i in range(nd):
        in_size = x.shape[2 + i]
        out = _pool_out_dim(in_size, ks[i], pads[i], strides[i], ceil)
        his.append(max((out - 1) * strides[i] + ks[i] - in_size - pads[i],
                       pads[i]))
    max_pool, avg_pool = _MAX_POOL[nd], _AVG_POOL[nd]
    if his == pads and all(2 * p <= k for p, k in zip(pads, ks)):
        if is_max:
            return max_pool(x, ks, strides, pads)
        return avg_pool(x, ks, strides, pads,
                        count_include_pad=not exclusive)
    # F.pad lists the last axis first
    pad = [p for i in reversed(range(nd)) for p in (pads[i], his[i])]
    if is_max:
        return max_pool(F.pad(x, pad, value=float("-inf")), ks, strides)
    summed = avg_pool(F.pad(x, pad), ks, strides, divisor_override=1)
    if not exclusive:
        n = 1
        for k in ks:
            n *= k
        return summed / float(n)
    ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                            device=x.device), pad)
    cnt = avg_pool(ones, ks, strides, divisor_override=1)
    return summed / torch.clamp(cnt, min=1.0)


def _pool_compute_nd(nd):
    def compute(ins, attrs, ctx, op_index):
        x = ins["X"][0]
        is_max = attrs.get("pooling_type", "max") == "max"
        nhwc = attrs.get("data_format", "NCHW") == "NHWC" and nd == 2
        sp0 = 1 if nhwc else 2
        if attrs.get("global_pooling", False):
            axes = tuple(range(sp0, sp0 + nd))
            out = (torch.amax(x, dim=axes, keepdim=True) if is_max
                   else torch.mean(x, dim=axes, keepdim=True))
            return {"Out": out}
        if attrs.get("adaptive", False):
            return {"Out": adaptive_pool(x, int_list(attrs.get("ksize"), nd),
                                         nd, is_max, sp0=sp0)}
        if nhwc:
            x = x.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
        out = _pool_channels_first(x, attrs, is_max, nd)
        return {"Out": out.permute(0, 2, 3, 1) if nhwc else out}
    return compute


for _nd in (2, 3):
    register_op("pool%dd" % _nd, ["X"], ["Out"], infer=_pool_infer_nd(_nd),
                compute=_pool_compute_nd(_nd))


# -- max pooling with the argmax index ---------------------------------------

def _pool_idx_infer_nd(nd):
    def infer(op, block):
        x = in_var(op, block, "X")
        if op.attrs.get("global_pooling", False):
            spatial = [1] * nd
        else:
            ks = int_list(op.attrs.get("ksize"), nd)
            strides = int_list(op.attrs.get("strides", 1), nd)
            pads = int_list(op.attrs.get("paddings", 0), nd)
            spatial = [_pool_out_dim(x.shape[2 + i], ks[i], pads[i],
                                     strides[i], False) for i in range(nd)]
        shape = (*x.shape[:2], *spatial)
        set_output(op, block, "Out", shape, x.dtype)
        set_output(op, block, "Mask", shape, "int32")
    return infer


def _pool_idx_compute_nd(nd):
    def compute(ins, attrs, ctx, op_index):
        x = ins["X"][0]
        spatial = tuple(x.shape[2:])
        if attrs.get("global_pooling", False):
            ks, strides, pads = list(spatial), list(spatial), [0] * nd
        else:
            ks = int_list(attrs.get("ksize"), nd)
            strides = int_list(attrs.get("strides", 1), nd)
            pads = int_list(attrs.get("paddings", 0), nd)
        n_pos = 1
        for s in spatial:
            n_pos *= s
        idx = torch.arange(n_pos, dtype=torch.int32,
                           device=x.device).reshape((1, 1) + spatial)
        idx = idx.expand(x.shape)
        neg = (torch.finfo(x.dtype).min if x.is_floating_point()
               else torch.iinfo(x.dtype).min)
        pad = [p for i in reversed(range(nd)) for p in (pads[i], pads[i])]
        xw, iw = F.pad(x, pad, value=neg), F.pad(idx, pad, value=-1)
        for i in range(nd):
            xw = xw.unfold(2 + i, ks[i], strides[i])
            iw = iw.unfold(2 + i, ks[i], strides[i])
        # [N, C, *out, k0 * k1 (* k2)]: argmax gives the first maximum
        xw, iw = xw.flatten(-nd), iw.flatten(-nd)
        pick = torch.argmax(xw, dim=-1, keepdim=True)
        return {"Out": torch.gather(xw, -1, pick).squeeze(-1),
                "Mask": torch.gather(iw, -1, pick).squeeze(-1)}
    return compute


def _pool_idx_grad(op, no_grad_set):
    x = op.inputs["X"][0]
    if x in no_grad_set:
        return []
    return [dict(
        type="max_pool_with_index_grad",
        inputs={"X": [x], "Mask": list(op.outputs["Mask"]),
                "GRAD::Out": [grad_var_name(op.outputs["Out"][0])]},
        outputs={"GRAD::X": [grad_var_name(x)]},
        attrs=dict(op.attrs))]


def _pool_idx_grad_infer(gop, block):
    x = in_var(gop, block, "X")
    set_output(gop, block, "GRAD::X", x.shape, x.dtype)


def _pool_idx_grad_compute(ins, attrs, ctx, op_index):
    """Each output cotangent added at its ``Mask`` offset; entries of -1
    (windows wholly in the padding) add nothing."""
    x, mask, og = ins["X"][0], ins["Mask"][0], ins["GRAD::Out"][0]
    n, c = x.shape[:2]
    m = mask.reshape(n, c, -1).long()
    g = og.reshape(n, c, -1).to(x.dtype)
    valid = m >= 0
    flat = torch.zeros((n, c, x[0, 0].numel()), dtype=x.dtype,
                       device=x.device)
    flat.scatter_add_(2, torch.where(valid, m, 0),
                      torch.where(valid, g, torch.zeros_like(g)))
    return {"GRAD::X": flat.reshape(x.shape)}


for _nd in (2, 3):
    register_op("max_pool%dd_with_index" % _nd, ["X"], ["Out", "Mask"],
                infer=_pool_idx_infer_nd(_nd),
                compute=_pool_idx_compute_nd(_nd), grad=_pool_idx_grad)
register_op("max_pool_with_index_grad", ["X", "Mask", "GRAD::Out"],
            ["GRAD::X"], infer=_pool_idx_grad_infer,
            compute=_pool_idx_grad_compute, grad=None)


# -- spp: spatial pyramid pooling --------------------------------------------

def _spp_infer(op, block):
    x = in_var(op, block, "X")
    levels = int(op.attrs.get("pyramid_height", 1))
    c = x.shape[1]
    d = None if c in (None, -1) else c * sum(4 ** lv for lv in range(levels))
    set_output(op, block, "Out", (x.shape[0], d), x.dtype)


def _spp_compute(ins, attrs, ctx, op_index):
    """Adaptive 2^l x 2^l poolings of each level l, flattened and
    concatenated."""
    x = ins["X"][0]
    is_max = attrs.get("pooling_type", "max") == "max"
    outs = [adaptive_pool(x, (2 ** lv, 2 ** lv), 2, is_max).flatten(1)
            for lv in range(int(attrs.get("pyramid_height", 1)))]
    return {"Out": torch.cat(outs, dim=1)}


register_op("spp", ["X"], ["Out"], infer=_spp_infer, compute=_spp_compute)


# -- unpool: max unpooling by the argmax indices -----------------------------

def _unpool_out_hw(shape, attrs):
    ks = attrs.get("ksize", [2, 2])
    st = attrs.get("strides", ks)
    pads = attrs.get("paddings", [0, 0])
    return [None if shape[2 + i] in (None, -1)
            else (shape[2 + i] - 1) * st[i] - 2 * pads[i] + ks[i]
            for i in range(2)]


def _unpool_infer(op, block):
    x = in_var(op, block, "X")
    h, w = _unpool_out_hw(x.shape, op.attrs)
    set_output(op, block, "Out", (x.shape[0], x.shape[1], h, w), x.dtype)


def _unpool_compute(ins, attrs, ctx, op_index):
    """Each pooled value written at its flat offset (``Indices``, as
    ``max_pool2d_with_index`` gives them) into a zero plane.  An offset in
    [-size, 0) counts from the end and any other offset out of the plane
    is dropped, as XLA's ``mode="drop"`` scatter does: it lands in a
    spare slot past the plane, cut off after."""
    x = ins["X"][0]
    n, c = x.shape[:2]
    oh, ow = _unpool_out_hw(x.shape, attrs)
    size = oh * ow
    idx = ins["Indices"][0].reshape(n, c, -1).long()
    idx = torch.where(idx < 0, idx + size, idx)
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    out = torch.zeros((n, c, size + 1), dtype=x.dtype, device=x.device)
    out.scatter_(2, idx, x.reshape(n, c, -1))
    return {"Out": out[:, :, :size].reshape(n, c, oh, ow)}


register_op("unpool", ["X", "Indices"], ["Out"], infer=_unpool_infer,
            compute=_unpool_compute, no_grad_inputs=("Indices",))
