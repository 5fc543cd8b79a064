"""``layer_norm``, ``batch_norm`` and ``lrn`` (counterpart of
``paddle_tpu/ops/norm.py``).

``layer_norm``: rows are the dims before ``begin_norm_axis``; the op
flattens x to [rows, D] and calls ``ops.cuda.layer_norm``: kernels #3
(forward) and #4 (backward) on the card, their plain versions on the CPU.
Where the JAX package makes the Pallas kernel opt-in behind
``FLAGS_pallas_kernels``, here the kernel is the path on the card, with no
fallback.  Mean/Variance come out in x's dtype, computed in float32, and
have no gradient: a nonzero cotangent on them raises in the generic grad.

``batch_norm``: train mode (batch statistics, the momentum update of the
running mean and variance) and ``is_test`` / ``use_global_stats``, NCHW
or NHWC (``data_layout``).  Statistics are float32 whatever x's dtype, in
one pass shifted by the running mean (``shifted_one_pass_stats``, shared
with the fused conv+BN ops) or, under ``FLAGS_bn_two_pass``, in the exact
two-pass form.  MeanOut/VarianceOut are new tensors, never the running
stats updated in place: a fused conv's grad op reads back the running
mean its forward saw.  The gradient is the hand-written three-term
``batch_norm_grad`` from the saved batch statistics.

``lrn``: the cross-channel local response norm of NCHW ``x``,
``x * (k + alpha * S)^-beta`` where S sums ``x^2`` over a window of ``n``
channels padded ``(n // 2, n - 1 - n // 2)`` as the JAX package's
``reduce_window`` pads it (asymmetric for an even n); ``MidOut`` is ``k +
alpha * S``.  Its gradient is the generic ``lrn_grad``.
"""

import torch

from ..flags import flag
from ..registry import in_var, register_op, set_output
from .cuda import layer_norm as ln


def _ln_infer(op, block):
    x = in_var(op, block, "X")
    axis = op.attrs.get("begin_norm_axis", 1)
    rows = x.shape[:axis]
    set_output(op, block, "Y", x.shape, x.dtype)
    set_output(op, block, "Mean", rows, x.dtype)
    set_output(op, block, "Variance", rows, x.dtype)


def _ln_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    axis = attrs.get("begin_norm_axis", 1)
    eps = attrs.get("epsilon", 1e-5)
    rows = tuple(x.shape[:axis])
    d = 1
    for s in x.shape[axis:]:
        d *= s
    scale = ins.get("Scale", [None])[0]
    bias = ins.get("Bias", [None])[0]
    scale = (torch.ones(d, dtype=x.dtype, device=x.device) if scale is None
             else scale.reshape(d))
    bias = (torch.zeros(d, dtype=x.dtype, device=x.device) if bias is None
            else bias.reshape(d))
    y, mean, var = ln.layer_norm(x.reshape(-1, d).contiguous(),
                                 scale.contiguous(), bias.contiguous(),
                                 float(eps))
    return {"Y": y.reshape(x.shape), "Mean": mean.reshape(rows).to(x.dtype),
            "Variance": var.reshape(rows).to(x.dtype)}


register_op("layer_norm", ["X", "Scale", "Bias"], ["Y", "Mean", "Variance"],
            infer=_ln_infer, compute=_ln_compute)


# -- batch_norm -------------------------------------------------------------

def _bn_infer(op, block):
    x = in_var(op, block, "X")
    c = x.shape[1] if op.attrs.get("data_layout", "NCHW") == "NCHW" \
        else x.shape[-1]
    set_output(op, block, "Y", x.shape, x.dtype)
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        set_output(op, block, slot, (c,), x.dtype)


def shifted_one_pass_stats(xf, shift, red_axes, bshape):
    """Per-channel (mean, var) of float32 ``xf`` over ``red_axes`` in one
    pass: E[(x-s)^2] - (E[x-s])^2, shifted by ``shift`` (float32 [C], the
    running mean; None for no shift) against the cancellation of the
    unshifted form, clamped at 0."""
    if shift is not None:
        s32 = shift.float()
        xs = xf - s32.view(bshape)
    else:
        s32, xs = 0.0, xf
    m1 = xs.mean(dim=red_axes)
    var = torch.clamp((xs * xs).mean(dim=red_axes) - m1 * m1, min=0.0)
    return m1 + s32, var


def bn_axes(x, layout):
    """(reduction axes, broadcast shape of a [C] vector) under
    ``layout``."""
    c_axis = 1 if layout == "NCHW" else x.dim() - 1
    bshape = [1] * x.dim()
    bshape[c_axis] = x.shape[c_axis]
    return tuple(i for i in range(x.dim()) if i != c_axis), bshape


def _is_test(attrs):
    return attrs.get("is_test", False) or attrs.get("use_global_stats", False)


def _bn_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    red, bshape = bn_axes(x, attrs.get("data_layout", "NCHW"))
    xf = x.float()
    if _is_test(attrs):
        use_mean, use_var = mean, var
        mean_out, var_out = mean, var
    else:
        if flag("bn_two_pass"):
            use_mean = xf.mean(dim=red)
            d = xf - use_mean.view(bshape)
            use_var = (d * d).mean(dim=red)
        else:
            use_mean, use_var = shifted_one_pass_stats(xf, mean, red, bshape)
        mean_out = momentum * mean + (1.0 - momentum) * use_mean
        var_out = momentum * var + (1.0 - momentum) * use_var
    inv_std = torch.rsqrt(use_var.float() + eps)
    y = (xf - use_mean.float().view(bshape)) \
        * (inv_std * scale.float()).view(bshape) + bias.float().view(bshape)
    return {"Y": y.to(x.dtype), "MeanOut": mean_out, "VarianceOut": var_out,
            "SavedMean": use_mean, "SavedVariance": use_var}


def _bn_grad_maker(op, no_grad_set):
    """The hand-written three-term backward (the JAX package's
    ``_bn_grad_maker``), from the saved batch statistics."""
    from ..framework import grad_var_name

    outs = {}
    for slot in ("X", "Scale", "Bias"):
        outs["GRAD::" + slot] = ["" if n in no_grad_set else grad_var_name(n)
                                 for n in op.inputs[slot]]
    if not any(n for ns in outs.values() for n in ns):
        return []
    return [dict(
        type="batch_norm_grad",
        inputs={"X": [op.inputs["X"][0]], "Scale": op.inputs["Scale"],
                "Out::SavedMean": op.outputs["SavedMean"],
                "Out::SavedVariance": op.outputs["SavedVariance"],
                "GRAD::Y": [grad_var_name(op.outputs["Y"][0])]},
        outputs=outs, attrs=dict(op.attrs))]


def _bn_grad_infer(gop, block):
    x = in_var(gop, block, "X")
    scale = in_var(gop, block, "Scale")
    for slot, ref in (("GRAD::X", x), ("GRAD::Scale", scale),
                      ("GRAD::Bias", scale)):
        for name in gop.outputs.get(slot, []):
            if name:
                block.create_var(name=name, shape=ref.shape, dtype=ref.dtype,
                                 persistable=False)


def _bn_grad_compute(ins, attrs, ctx, op_index):
    x, scale = ins["X"][0], ins["Scale"][0]
    mean = ins["Out::SavedMean"][0]
    var = ins["Out::SavedVariance"][0]
    dy = ins["GRAD::Y"][0]
    eps = attrs.get("epsilon", 1e-5)
    red, bshape = bn_axes(x, attrs.get("data_layout", "NCHW"))
    n = 1
    for i in red:
        n *= x.shape[i]
    xf, dyf = x.float(), dy.float()
    rstd = torch.rsqrt(var.float() + eps).view(bshape)
    xhat = (xf - mean.float().view(bshape)) * rstd
    dbeta = dyf.sum(dim=red)
    dgamma = (dyf * xhat).sum(dim=red)
    g = scale.float().view(bshape) * rstd
    if _is_test(attrs):
        dx = g * dyf
    else:
        dx = g * (dyf - (dbeta / n).view(bshape)
                  - xhat * (dgamma / n).view(bshape))
    return {"GRAD::X": dx.to(x.dtype), "GRAD::Scale": dgamma.to(scale.dtype),
            "GRAD::Bias": dbeta.to(scale.dtype)}


register_op("batch_norm", ["X", "Scale", "Bias", "Mean", "Variance"],
            ["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"],
            infer=_bn_infer, compute=_bn_compute, grad=_bn_grad_maker,
            no_grad_inputs=("Mean", "Variance"))
register_op("batch_norm_grad",
            ["X", "Scale", "Out::SavedMean", "Out::SavedVariance", "GRAD::Y"],
            ["GRAD::X", "GRAD::Scale", "GRAD::Bias"], infer=_bn_grad_infer,
            compute=_bn_grad_compute, grad=None)


def _lrn_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "Out", x.shape, x.dtype)
    set_output(op, block, "MidOut", x.shape, x.dtype)


def _lrn_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    n = attrs.get("n", 5)
    k = attrs.get("k", 2.0)
    alpha = attrs.get("alpha", 1e-4)
    beta = attrs.get("beta", 0.75)
    half = n // 2
    sq = torch.nn.functional.pad(x * x, (0, 0, 0, 0, half, n - 1 - half))
    c = x.shape[1]
    window = sq[:, 0:c]
    for i in range(1, n):
        window = window + sq[:, i:i + c]
    mid = k + alpha * window
    return {"Out": x * torch.pow(mid, -beta), "MidOut": mid}


register_op("lrn", ["X"], ["Out", "MidOut"], infer=_lrn_infer,
            compute=_lrn_compute)
