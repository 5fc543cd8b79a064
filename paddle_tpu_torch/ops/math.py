"""``mul``, ``matmul``, ``sum``, ``scale`` and ``mean`` (counterpart of
``paddle_tpu/ops/math.py``).  ``mul`` is fc's matmul: flatten both
operands to 2-D, one product; ``matmul`` is the batched product with
transpose flags.  The products go to ``torch.matmul``, as the JAX package
leaves them to XLA outside any kernel: operands of two dtypes are promoted
as ``jnp.matmul`` promotes them, and the result takes X's dtype.  For
float32 inputs the product runs in full float32 on the card as long as
``torch.backends.cuda.matmul.allow_tf32`` stays False.  bfloat16 products
sum in float32: importing this module turns off cuBLAS's reduced-precision
reduction of bfloat16 split-K partial sums, which PyTorch allows by
default."""

import torch

from ..registry import in_var, register_op, same_shape_infer, set_output

torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _flatten_to_2d(x, num_col_dims):
    lead = 1
    for s in x.shape[:num_col_dims]:
        lead *= s
    rest = 1
    for s in x.shape[num_col_dims:]:
        rest *= s
    return x.reshape(lead, rest)


def _mul_infer(op, block):
    x = in_var(op, block, "X")
    y = in_var(op, block, "Y")
    xnc = op.attrs.get("x_num_col_dims", 1)
    ync = op.attrs.get("y_num_col_dims", 1)
    out_shape = tuple(x.shape[:xnc]) + tuple(y.shape[ync:])
    set_output(op, block, "Out", out_shape, x.dtype)


def _product(a, b):
    """``a @ b`` in the promoted dtype of its operands."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _mul_compute(ins, attrs, ctx, op_index):
    x, y = ins["X"][0], ins["Y"][0]
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    out = _product(_flatten_to_2d(x, xnc), _flatten_to_2d(y, ync)).to(x.dtype)
    return {"Out": out.reshape(tuple(x.shape[:xnc]) + tuple(y.shape[ync:]))}


register_op("mul", ["X", "Y"], ["Out"], infer=_mul_infer, compute=_mul_compute)


def _matmul_infer(op, block):
    x = in_var(op, block, "X")
    y = in_var(op, block, "Y")
    xs, ys = list(x.shape), list(y.shape)
    if len(xs) == 1:
        xs = [1, xs[0]]
    if len(ys) == 1:
        ys = [ys[0], 1]
    if op.attrs.get("transpose_X", False):
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if op.attrs.get("transpose_Y", False):
        ys[-1], ys[-2] = ys[-2], ys[-1]
    batch = xs[:-2] if len(xs) > len(ys) else ys[:-2]
    out = tuple(batch) + (xs[-2], ys[-1])
    if len(x.shape) == 1 and len(y.shape) == 1:
        out = (1,)
    set_output(op, block, "Out", out, x.dtype)


def _matmul_compute(ins, attrs, ctx, op_index):
    x, y = ins["X"][0], ins["Y"][0]
    dtype = x.dtype
    squeeze = x.dim() == 1 and y.dim() == 1
    if x.dim() == 1:
        x = x[None, :]
    if y.dim() == 1:
        y = y[:, None]
    if attrs.get("transpose_X", False):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False):
        y = y.transpose(-1, -2)
    out = _product(x, y).to(dtype)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out.reshape(1) if squeeze else out}


register_op("matmul", ["X", "Y"], ["Out"], infer=_matmul_infer,
            compute=_matmul_compute)


def _sum_compute(ins, attrs, ctx, op_index):
    # variadic add (backward's gradient accumulation)
    xs = [x for x in ins["X"] if x is not None]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


register_op("sum", ["X"], ["Out"], infer=same_shape_infer("X", "Out"),
            compute=_sum_compute)


def _scale_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    scale, bias = attrs.get("scale", 1.0), attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": x * scale + bias}
    return {"Out": (x + bias) * scale}


register_op("scale", ["X"], ["Out"], infer=same_shape_infer("X", "Out"),
            compute=_scale_compute)


def _mean_infer(op, block):
    set_output(op, block, "Out", (1,), in_var(op, block, "X").dtype)


register_op("mean", ["X"], ["Out"], infer=_mean_infer,
            compute=lambda ins, attrs, ctx, op_index: {
                "Out": ins["X"][0].mean().reshape(1)})
