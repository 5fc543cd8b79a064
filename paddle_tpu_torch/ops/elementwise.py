"""``elementwise_{add,sub,mul,div,min}`` with Fluid's axis-broadcast semantics
(counterpart of ``paddle_tpu/ops/elementwise.py``): a lower-rank Y aligns
against X starting at ``axis``, reproduced by right-padding Y with
singleton dims."""

import torch

from ..registry import broadcast_shapes, in_var, register_op, set_output


def _align_y(x, y, axis):
    if y.dim() == x.dim():
        return y
    if axis == -1 or axis is None:
        axis = x.dim() - y.dim()
    pad = x.dim() - axis - y.dim()
    if pad > 0:
        y = y.reshape(tuple(y.shape) + (1,) * pad)
    return y


def _ew_infer(op, block):
    x = in_var(op, block, "X")
    y = in_var(op, block, "Y")
    axis = op.attrs.get("axis", -1)
    ys = list(y.shape)
    if len(ys) < len(x.shape):
        a = axis if axis != -1 else len(x.shape) - len(ys)
        ys = [1] * a + ys + [1] * (len(x.shape) - a - len(ys))
    out = broadcast_shapes(tuple(x.shape), tuple(ys))
    set_output(op, block, "Out", out, x.dtype)


def _make_ew(name, fn):
    def compute(ins, attrs, ctx, op_index):
        x, y = ins["X"][0], ins["Y"][0]
        return {"Out": fn(x, _align_y(x, y, attrs.get("axis", -1)))}

    register_op(name, ["X", "Y"], ["Out"], infer=_ew_infer, compute=compute)


_make_ew("elementwise_add", torch.add)
_make_ew("elementwise_sub", torch.sub)
_make_ew("elementwise_mul", torch.mul)
_make_ew("elementwise_div", torch.div)
_make_ew("elementwise_min", torch.minimum)
