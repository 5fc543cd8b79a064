"""``pool2d`` (counterpart of ``paddle_tpu/ops/pool.py``): max and avg
pooling, ``global_pooling``, ``exclusive`` avg counting, ``ceil_mode``,
NCHW or NHWC (``data_format``).

The JAX package pools with ``lax.reduce_window`` over explicit (lo, hi)
padding, where ``ceil_mode`` extends hi so the last window fits; max
padding counts as -inf (the reduction's init) and the exclusive avg
divides by the number of in-bounds elements of each window.  Here the
common case (no ceil extension, padding within half the window) is
``F.max_pool2d`` / ``F.avg_pool2d`` with the same semantics
(``count_include_pad=not exclusive``); any other padding is applied
explicitly first.  NHWC pools a channels-last view of the NHWC memory.
The gradient is the generic ``pool2d_grad``."""

import torch
import torch.nn.functional as F

from ..registry import in_var, int_list, register_op, set_output


def _pool_out_dim(in_size, k, pad, stride, ceil_mode):
    if in_size is None or in_size < 0:
        return -1
    if ceil_mode:
        return -(-(in_size + 2 * pad - k) // stride) + 1
    return (in_size + 2 * pad - k) // stride + 1


def _pool_infer(op, block):
    x = in_var(op, block, "X")
    attrs = op.attrs
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    sp0 = 1 if nhwc else 2
    if attrs.get("global_pooling", False):
        spatial = [1, 1]
    else:
        ks = int_list(attrs.get("ksize"), 2)
        strides = int_list(attrs.get("strides", 1), 2)
        pads = int_list(attrs.get("paddings", 0), 2)
        ceil = attrs.get("ceil_mode", False)
        spatial = [_pool_out_dim(x.shape[sp0 + i], ks[i], pads[i],
                                 strides[i], ceil) for i in range(2)]
    if nhwc:
        shape = (x.shape[0], *spatial, x.shape[3])
    else:
        shape = (*x.shape[:2], *spatial)
    set_output(op, block, "Out", shape, x.dtype)


def _pool_nchw(x, attrs, is_max):
    ks = int_list(attrs.get("ksize"), 2)
    strides = int_list(attrs.get("strides", 1), 2)
    pads = int_list(attrs.get("paddings", 0), 2)
    ceil = attrs.get("ceil_mode", False)
    exclusive = attrs.get("exclusive", True)
    his = []
    for i in range(2):
        in_size = x.shape[2 + i]
        out = _pool_out_dim(in_size, ks[i], pads[i], strides[i], ceil)
        his.append(max((out - 1) * strides[i] + ks[i] - in_size - pads[i],
                       pads[i]))
    if his == pads and all(2 * p <= k for p, k in zip(pads, ks)):
        if is_max:
            return F.max_pool2d(x, ks, strides, pads)
        return F.avg_pool2d(x, ks, strides, pads,
                            count_include_pad=not exclusive)
    pad = (pads[1], his[1], pads[0], his[0])
    if is_max:
        return F.max_pool2d(F.pad(x, pad, value=float("-inf")), ks, strides)
    summed = F.avg_pool2d(F.pad(x, pad), ks, strides,
                          divisor_override=1)
    if not exclusive:
        return summed / float(ks[0] * ks[1])
    ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                            device=x.device), pad)
    cnt = F.avg_pool2d(ones, ks, strides, divisor_override=1)
    return summed / torch.clamp(cnt, min=1.0)


def _pool_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    if attrs.get("adaptive", False):
        raise NotImplementedError(
            "adaptive pool2d is not ported to paddle_tpu_torch yet "
            "(ROADMAP Queue A)")
    is_max = attrs.get("pooling_type", "max") == "max"
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    if attrs.get("global_pooling", False):
        axes = (1, 2) if nhwc else (2, 3)
        out = (torch.amax(x, dim=axes, keepdim=True) if is_max
               else torch.mean(x, dim=axes, keepdim=True))
        return {"Out": out}
    if nhwc:
        x = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
    out = _pool_nchw(x, attrs, is_max)
    return {"Out": out.permute(0, 2, 3, 1) if nhwc else out}


register_op("pool2d", ["X"], ["Out"], infer=_pool_infer,
            compute=_pool_compute)
