"""``conv2d`` (and ``depthwise_conv2d``, its grouped form) (counterpart of
``paddle_tpu/ops/conv.py``).  OIHW filters, strides, paddings, dilations
and groups; NCHW activations, or NHWC under ``data_format="NHWC"`` (the
trunk ``transpiler.convert_to_nhwc`` rewrites).

The product is ``F.conv2d`` (cuDNN on the card): the JAX package leaves
the convolution to XLA's ``lax.conv_general_dilated``, not to a Pallas
kernel.  For NHWC the activation is handed to it as a channels-last view
of its NHWC memory (``x.permute(0, 3, 1, 2)``), so no transpose
materializes inside the trunk and the output comes back channels-last: its
``permute(0, 2, 3, 1)`` is contiguous NHWC.  The gradient is the generic
``conv2d_grad``: the forward rerun under autograd."""

import torch
import torch.nn.functional as F

from ..registry import in_var, int_list, register_op, set_output


def _conv_out_dim(in_size, k, pad, stride, dilation):
    if in_size is None or in_size < 0:
        return -1
    return (in_size + 2 * pad - (dilation * (k - 1) + 1)) // stride + 1


def _conv_infer(op, block):
    x = in_var(op, block, "Input")
    w = in_var(op, block, "Filter")
    strides = int_list(op.attrs.get("strides", 1), 2)
    pads = int_list(op.attrs.get("paddings", 0), 2)
    dils = int_list(op.attrs.get("dilations", 1), 2)
    nhwc = op.attrs.get("data_format", "NCHW") == "NHWC"
    sp0 = 1 if nhwc else 2
    spatial = [_conv_out_dim(x.shape[sp0 + i], w.shape[2 + i], pads[i],
                             strides[i], dils[i]) for i in range(2)]
    if nhwc:
        shape = (x.shape[0], *spatial, w.shape[0])
    else:
        shape = (x.shape[0], w.shape[0], *spatial)
    set_output(op, block, "Output", shape, x.dtype)


def _conv_compute(ins, attrs, ctx, op_index):
    x, w = ins["Input"][0], ins["Filter"][0]
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
    out = F.conv2d(x, w, stride=int_list(attrs.get("strides", 1), 2),
                   padding=int_list(attrs.get("paddings", 0), 2),
                   dilation=int_list(attrs.get("dilations", 1), 2),
                   groups=attrs.get("groups", 1) or 1)
    return {"Output": out.permute(0, 2, 3, 1) if nhwc else out}


for _type in ("conv2d", "depthwise_conv2d"):
    register_op(_type, ["Input", "Filter"], ["Output"], infer=_conv_infer,
                compute=_conv_compute)
