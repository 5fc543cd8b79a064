"""``mul``, ``sum``, ``scale`` and ``mean`` (counterpart of
``paddle_tpu/ops/math.py``).  ``mul`` is fc's matmul: flatten both
operands to 2-D, one product.  The product goes to ``torch.matmul``, as
the JAX package leaves it to XLA outside any kernel.  For float32 inputs
it runs in full float32 on the card as long as
``torch.backends.cuda.matmul.allow_tf32`` stays False."""

from ..registry import in_var, register_op, same_shape_infer, set_output


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


def _mul_compute(ins, attrs, ctx, op_index):
    x, y = ins["X"][0], ins["Y"][0]
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    out = _flatten_to_2d(x, xnc) @ _flatten_to_2d(y, ync)
    return {"Out": out.reshape(tuple(x.shape[:xnc]) + tuple(y.shape[ync:]))}


register_op("mul", ["X", "Y"], ["Out"], infer=_mul_infer, compute=_mul_compute)


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
