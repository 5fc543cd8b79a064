"""``mul``, ``matmul``, ``sum``, ``scale``, ``mean``, ``sign``, ``minus``,
``cos_sim``, the clip family ``clip``, ``clip_by_norm``,
``squared_l2_norm``, the norms ``l1_norm`` and ``squared_l2_distance``,
the checks ``isfinite``, ``has_inf`` and ``has_nan`` (one bool over every
input of the X slot), and
``piecewise_lr``, ``layers.piecewise_decay``'s step-function rate
(counterpart of ``paddle_tpu/ops/math.py``).  ``sum``, ``scale`` and the
clip family take SelectedRows gradients and keep them sparse where the JAX package does.  ``mul`` is fc's matmul: flatten both
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
from .selected_rows import (SelectedRows, map_values, mask_to, merge_rows,
                            merged_sumsq, to_dense)

torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def jnp_abs(x):
    """``|x|`` with ``jnp.abs``'s gradient: +1 at 0 (``torch.abs`` gives
    0 there)."""
    return torch.where(x >= 0, x, -x)


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
    sparse = [x for x in xs if isinstance(x, SelectedRows)]
    dense = [x for x in xs if not isinstance(x, SelectedRows)]
    if sparse and not dense:
        # all sparse: concatenating the row lists is the addition
        return {"Out": SelectedRows(
            torch.cat([x.rows for x in sparse]),
            torch.cat([x.values for x in sparse]), sparse[0].height)}
    dense += [to_dense(x) for x in sparse]
    out = dense[0]
    for x in dense[1:]:
        out = out + x
    return {"Out": out}


register_op("sum", ["X"], ["Out"], infer=same_shape_infer("X", "Out"),
            compute=_sum_compute)


def _scale_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    scale, bias = attrs.get("scale", 1.0), attrs.get("bias", 0.0)
    if isinstance(x, SelectedRows):
        # a scale without bias commutes with merging duplicates; a bias
        # would be added once a duplicate, so that case densifies
        if bias == 0.0:
            return {"Out": map_values(x, lambda v: v * scale)}
        x = to_dense(x)
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


register_op("sign", ["X"], ["Out"], infer=same_shape_infer("X", "Out"),
            compute=lambda ins, attrs, ctx, op_index: {
                "Out": torch.sign(ins["X"][0])})


def _cos_sim_infer(op, block):
    x, y = in_var(op, block, "X"), in_var(op, block, "Y")
    set_output(op, block, "Out", (x.shape[0], 1), x.dtype)
    set_output(op, block, "XNorm", (x.shape[0], 1), x.dtype)
    set_output(op, block, "YNorm", (y.shape[0], 1), y.dtype)


def _cos_sim_compute(ins, attrs, ctx, op_index):
    """Row-wise cosine similarity of X and Y [B, D] (Y may be [1, D])."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    out = torch.sum(x * y, dim=-1, keepdim=True) / (xn * yn)
    return {"Out": out, "XNorm": xn, "YNorm": yn}


register_op("cos_sim", ["X", "Y"], ["Out", "XNorm", "YNorm"],
            infer=_cos_sim_infer, compute=_cos_sim_compute)


def _clip_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    if isinstance(x, SelectedRows):
        # the clip applies to each row's summed gradient, so duplicates
        # merge first; the padded slots go back to zero (clip(0) is not 0
        # when min > 0)
        uniq, merged, valid = merge_rows(x)
        clipped = torch.clamp(merged, attrs["min"], attrs["max"])
        clipped = clipped * mask_to(valid, clipped).to(clipped.dtype)
        return {"Out": SelectedRows(uniq, clipped, x.height)}
    return {"Out": torch.clamp(x, attrs["min"], attrs["max"])}


register_op("clip", ["X"], ["Out"], infer=same_shape_infer("X", "Out"),
            compute=_clip_compute)


def _norm_scale(sumsq, max_norm):
    """clip_by_norm's factor: max_norm / norm where the norm exceeds it."""
    norm = torch.sqrt(sumsq)
    limit = torch.full_like(norm, max_norm)
    return torch.where(norm > max_norm,
                       limit / torch.clamp_min(norm, 1e-12),
                       torch.ones_like(norm))


def _clip_by_norm_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    if isinstance(x, SelectedRows):
        # the norm of the merged rows (the dense gradient's); the scale is
        # uniform, so it applies to the unmerged values
        scale = _norm_scale(merged_sumsq(x), attrs["max_norm"])
        return {"Out": map_values(x, lambda v: v * scale.to(v.dtype))}
    scale = _norm_scale(torch.sum(x * x), attrs["max_norm"])
    return {"Out": x * scale.to(x.dtype)}


register_op("clip_by_norm", ["X"], ["Out"],
            infer=same_shape_infer("X", "Out"),
            compute=_clip_by_norm_compute)


def _squared_l2_norm_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    if isinstance(x, SelectedRows):
        # global-norm clipping's term: ||dense(x)||^2 without the dense x
        return {"Out": merged_sumsq(x).reshape(1)}
    return {"Out": torch.sum(x * x).reshape(1)}


register_op("squared_l2_norm", ["X"], ["Out"], infer=_mean_infer,
            compute=_squared_l2_norm_compute)


def _piecewise_lr_compute(ins, attrs, ctx, op_index):
    step = ins["Step"][0]
    out = torch.full_like(step, attrs["values"][-1])
    # from the right, so that the earliest boundary the step is below wins
    for b, v in zip(reversed(attrs["boundaries"]),
                    reversed(attrs["values"][:-1])):
        out = torch.where(step < b, torch.full_like(step, v), out)
    return {"Out": out}


register_op(
    "piecewise_lr", ["Step"], ["Out"],
    infer=lambda op, block: set_output(
        op, block, "Out", in_var(op, block, "Step").shape, "float32"),
    compute=_piecewise_lr_compute, grad=None)


register_op("minus", ["X", "Y"], ["Out"], infer=same_shape_infer("X", "Out"),
            compute=lambda ins, attrs, ctx, op_index: {
                "Out": ins["X"][0] - ins["Y"][0]})

register_op("l1_norm", ["X"], ["Out"], infer=_mean_infer,
            compute=lambda ins, attrs, ctx, op_index: {
                "Out": torch.sum(jnp_abs(ins["X"][0])).reshape(1)})


def _squared_l2_distance_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "sub_result", x.shape, x.dtype)
    set_output(op, block, "Out", (x.shape[0], 1), x.dtype)


def _squared_l2_distance_compute(ins, attrs, ctx, op_index):
    """Row-wise ||x - y||^2 of X [N, ...] and Y (N or 1 rows)."""
    sub = ins["X"][0] - ins["Y"][0]
    sq = sub * sub
    # an empty dim tuple would sum everything in torch, nothing in jnp
    if sub.dim() > 1:
        sq = torch.sum(sq, dim=tuple(range(1, sub.dim())))
    return {"sub_result": sub, "Out": sq.reshape(-1, 1)}


register_op("squared_l2_distance", ["X", "Y"], ["sub_result", "Out"],
            infer=_squared_l2_distance_infer,
            compute=_squared_l2_distance_compute)


def _make_check(name, test, combine):
    # one [1] bool over every tensor of the X slot, never read on the host
    def compute(ins, attrs, ctx, op_index):
        return {"Out": combine(torch.stack(
            [combine(test(x)) for x in ins["X"]])).reshape(1)}

    register_op(name, ["X"], ["Out"],
                infer=lambda op, block: set_output(op, block, "Out", (1,),
                                                   "bool"),
                compute=compute, grad=None)


_make_check("isfinite", torch.isfinite, torch.all)
_make_check("has_inf", torch.isinf, torch.any)
_make_check("has_nan", torch.isnan, torch.any)
