"""Convolutions (counterpart of ``paddle_tpu/ops/conv.py``): ``conv2d`` and
``depthwise_conv2d`` (its grouped form), ``conv3d``, the transposed
``conv2d_transpose`` / ``conv3d_transpose`` /
``depthwise_conv2d_transpose``, and ``conv_shift``.  OIHW (OIDHW) filters,
strides, paddings, dilations and groups; NCHW activations, or NHWC under
``data_format="NHWC"`` (the trunk ``transpiler.convert_to_nhwc`` rewrites;
2-D only).

The products are ``F.conv2d`` / ``F.conv3d`` / ``F.conv_transpose2d`` /
``F.conv_transpose3d`` (cuDNN on the card): the JAX package leaves every
convolution to XLA's ``lax.conv_general_dilated``, not to a Pallas kernel.
For NHWC the activation is handed to ``F.conv2d`` as a channels-last view
of its NHWC memory (``x.permute(0, 3, 1, 2)``), so no transpose
materializes inside the trunk and the output comes back channels-last: its
``permute(0, 2, 3, 1)`` is contiguous NHWC.

A transposed filter is ``[in_c, out_c / groups, *k]``, the layout
``F.conv_transpose{2,3}d`` takes; the groups split the input channels and
the per-group outputs concatenate, as the JAX package's loop does.  The
output size is ``(in - 1) stride - 2 pad + dil (k - 1) + 1``, so
``output_padding`` is 0.  Every gradient is the generic ``<type>_grad``:
the forward rerun under autograd."""

import torch
import torch.nn.functional as F

from ..registry import in_var, int_list, register_op, set_output


def _conv_out_dim(in_size, k, pad, stride, dilation):
    if in_size is None or in_size < 0:
        return -1
    return (in_size + 2 * pad - (dilation * (k - 1) + 1)) // stride + 1


def _conv_infer_nd(nd):
    def infer(op, block):
        x = in_var(op, block, "Input")
        w = in_var(op, block, "Filter")
        strides = int_list(op.attrs.get("strides", 1), nd)
        pads = int_list(op.attrs.get("paddings", 0), nd)
        dils = int_list(op.attrs.get("dilations", 1), nd)
        nhwc = op.attrs.get("data_format", "NCHW") == "NHWC" and nd == 2
        sp0 = 1 if nhwc else 2
        spatial = [_conv_out_dim(x.shape[sp0 + i], w.shape[2 + i], pads[i],
                                 strides[i], dils[i]) for i in range(nd)]
        if nhwc:
            shape = (x.shape[0], *spatial, w.shape[0])
        else:
            shape = (x.shape[0], w.shape[0], *spatial)
        set_output(op, block, "Output", shape, x.dtype)
    return infer


def _conv_compute_nd(nd):
    conv = F.conv2d if nd == 2 else F.conv3d

    def compute(ins, attrs, ctx, op_index):
        x, w = ins["Input"][0], ins["Filter"][0]
        nhwc = attrs.get("data_format", "NCHW") == "NHWC" and nd == 2
        if nhwc:
            x = x.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
        out = conv(x, w, stride=int_list(attrs.get("strides", 1), nd),
                   padding=int_list(attrs.get("paddings", 0), nd),
                   dilation=int_list(attrs.get("dilations", 1), nd),
                   groups=attrs.get("groups", 1) or 1)
        return {"Output": out.permute(0, 2, 3, 1) if nhwc else out}
    return compute


for _type, _nd in (("conv2d", 2), ("depthwise_conv2d", 2), ("conv3d", 3)):
    register_op(_type, ["Input", "Filter"], ["Output"],
                infer=_conv_infer_nd(_nd), compute=_conv_compute_nd(_nd))


# -- transposed convolutions ------------------------------------------------

def _convt_infer_nd(nd):
    def infer(op, block):
        x = in_var(op, block, "Input")
        w = in_var(op, block, "Filter")      # [in_c, out_c / groups, *k]
        strides = int_list(op.attrs.get("strides", 1), nd)
        pads = int_list(op.attrs.get("paddings", 0), nd)
        dils = int_list(op.attrs.get("dilations", 1), nd)
        groups = op.attrs.get("groups", 1) or 1
        spatial = [-1 if x.shape[2 + i] is None or x.shape[2 + i] < 0
                   else (x.shape[2 + i] - 1) * strides[i] - 2 * pads[i]
                   + dils[i] * (w.shape[2 + i] - 1) + 1 for i in range(nd)]
        set_output(op, block, "Output",
                   (x.shape[0], w.shape[1] * groups, *spatial), x.dtype)
    return infer


def _convt_compute_nd(nd):
    conv_t = F.conv_transpose2d if nd == 2 else F.conv_transpose3d

    def compute(ins, attrs, ctx, op_index):
        out = conv_t(ins["Input"][0], ins["Filter"][0],
                     stride=int_list(attrs.get("strides", 1), nd),
                     padding=int_list(attrs.get("paddings", 0), nd),
                     dilation=int_list(attrs.get("dilations", 1), nd),
                     groups=attrs.get("groups", 1) or 1)
        return {"Output": out}
    return compute


for _type, _nd in (("conv2d_transpose", 2), ("conv3d_transpose", 3),
                   ("depthwise_conv2d_transpose", 2)):
    register_op(_type, ["Input", "Filter"], ["Output"],
                infer=_convt_infer_nd(_nd), compute=_convt_compute_nd(_nd))


# -- conv_shift: circular 1-D correlation ------------------------------------

def _conv_shift_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "Out", x.shape, x.dtype)


def _conv_shift_compute(ins, attrs, ctx, op_index):
    """``out[b, i] = sum_j x[b, (i + j - N // 2) mod M] y[b, j]`` for x
    [B, M] and y [B, N] (N odd, N <= M)."""
    x, y = ins["X"][0], ins["Y"][0]
    m, n = x.shape[1], y.shape[1]
    idx = (torch.arange(m, device=x.device)[:, None]
           + torch.arange(n, device=x.device)[None, :] - n // 2) % m
    return {"Out": torch.einsum("bmn,bn->bm", x[:, idx], y)}


register_op("conv_shift", ["X", "Y"], ["Out"], infer=_conv_shift_infer,
            compute=_conv_shift_compute)
