"""``layer_norm``, ``batch_norm``, ``lrn``, ``group_norm``, ``norm`` and the
image resizes ``bilinear_interp`` / ``nearest_interp`` (counterpart of
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

``group_norm``: NCHW or NHWC (``data_layout``), ``Mean`` / ``Variance`` of
shape [N, groups], the variance the mean of squared deviations.  ``norm``:
``x / sqrt(sum(x^2, axis) + epsilon)`` (epsilon inside the root), ``Norm``
the root.  ``bilinear_interp`` / ``nearest_interp`` resize NCHW to the
static ``out_h`` x ``out_w`` with align-corners ratios ``(in - 1) / (out -
1)``, as the JAX package does (a dynamic ``OutSize`` raises there too);
nearest rounds ``i * ratio`` half to even in float32 (``jnp.round``), where
``F.interpolate(mode="nearest")`` would floor.  Their gradients are the
generic ``<type>_grad``.
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


# -- group_norm ---------------------------------------------------------------

def _gn_infer(op, block):
    x = in_var(op, block, "X")
    g = op.attrs.get("groups", 1)
    set_output(op, block, "Y", x.shape, x.dtype)
    set_output(op, block, "Mean", (x.shape[0], g), x.dtype)
    set_output(op, block, "Variance", (x.shape[0], g), x.dtype)


def _gn_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    scale = (ins.get("Scale") or [None])[0]
    bias = (ins.get("Bias") or [None])[0]
    g = attrs.get("groups", 1)
    eps = attrs.get("epsilon", 1e-5)
    nhwc = attrs.get("data_layout", "NCHW") == "NHWC"
    if nhwc:
        x = torch.movedim(x, -1, 1)
    n, c = x.shape[:2]
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    red = tuple(range(2, xg.dim()))
    mean = torch.mean(xg, dim=red, keepdim=True)
    var = torch.mean(torch.square(xg - mean), dim=red, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    bshape = (1, c) + (1,) * (x.dim() - 2)
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    if nhwc:
        y = torch.movedim(y, 1, -1)
    return {"Y": y, "Mean": mean.reshape(n, g),
            "Variance": var.reshape(n, g)}


register_op("group_norm", ["X", "Scale", "Bias"], ["Y", "Mean", "Variance"],
            infer=_gn_infer, compute=_gn_compute)


# -- norm: L2 normalisation along an axis -------------------------------------

def _norm_infer(op, block):
    x = in_var(op, block, "X")
    nshape = list(x.shape)
    nshape[op.attrs.get("axis", 1)] = 1
    set_output(op, block, "Out", x.shape, x.dtype)
    set_output(op, block, "Norm", tuple(nshape), x.dtype)


def _norm_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    norm = torch.sqrt(torch.sum(torch.square(x), dim=attrs.get("axis", 1),
                                keepdim=True) + attrs.get("epsilon", 1e-10))
    return {"Out": x / norm, "Norm": norm}


register_op("norm", ["X"], ["Out", "Norm"], infer=_norm_infer,
            compute=_norm_compute)


# -- bilinear_interp / nearest_interp (align corners) -------------------------

def _interp_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "Out", (x.shape[0], x.shape[1],
                                  op.attrs.get("out_h", -1),
                                  op.attrs.get("out_w", -1)), x.dtype)


def _align_corners_pos(size, out, device):
    """``i (size - 1) / (out - 1)`` for i < out, in float32."""
    ratio = (size - 1.0) / (out - 1.0) if out > 1 else 0.0
    return torch.arange(out, dtype=torch.float32, device=device) * ratio


def _static_out(ins, attrs):
    if ins.get("OutSize") and ins["OutSize"][0] is not None:
        raise NotImplementedError(
            "a dynamic OutSize is not supported (as in the JAX package); "
            "set out_h / out_w")
    return attrs["out_h"], attrs["out_w"]


def _bilinear_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    oh, ow = _static_out(ins, attrs)
    h, w = x.shape[2:]
    ys = _align_corners_pos(h, oh, x.device)
    xs = _align_corners_pos(w, ow, x.device)
    y0, x0 = torch.floor(ys).long(), torch.floor(xs).long()
    y1, x1 = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
    wy, wx = (ys - y0).to(x.dtype), (xs - x0).to(x.dtype)
    top = x[:, :, y0, :][:, :, :, x0] * (1 - wx) + \
        x[:, :, y0, :][:, :, :, x1] * wx
    bot = x[:, :, y1, :][:, :, :, x0] * (1 - wx) + \
        x[:, :, y1, :][:, :, :, x1] * wx
    return {"Out": top * (1 - wy)[None, None, :, None]
            + bot * wy[None, None, :, None]}


def _nearest_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    oh, ow = _static_out(ins, attrs)
    ys = torch.round(_align_corners_pos(x.shape[2], oh, x.device)).long()
    xs = torch.round(_align_corners_pos(x.shape[3], ow, x.device)).long()
    return {"Out": x[:, :, ys, :][:, :, :, xs]}


for _type, _compute in (("bilinear_interp", _bilinear_compute),
                        ("nearest_interp", _nearest_compute)):
    register_op(_type, ["X", "OutSize"], ["Out"], infer=_interp_infer,
                compute=_compute, no_grad_inputs=("OutSize",))
