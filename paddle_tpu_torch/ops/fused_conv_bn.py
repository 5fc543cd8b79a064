"""The fused conv+BN op family, targets of ``transpiler.fuse_conv_bn``
(counterpart of ``paddle_tpu/ops/fused_conv_bn.py``, same slots, attrs and
``no_grad_inputs``):

* ``batch_stats``      float32 per-channel mean/var of a raw activation,
                       one pass shifted by the BN's running mean
                       (``Shift``), or two-pass under ``FLAGS_bn_two_pass``;
* ``stats_finalize``   mean/var from a producer's fused sum/sumsq ([C]
                       arithmetic, no activation pass);
* ``bn_update_stats``  the momentum update of the running mean/variance
                       (new tensors, never updated in place);
* ``bn_apply``         normalize(+act) from explicit batch stats, for the
                       consumers that stay un-fused;
* ``bn_act_conv2d``    normalize(+act) -> 1x1 conv -> output stats, and
                       its hand-written grad op ``bn_act_conv2d_grad``.

On a CUDA tensor ``bn_act_conv2d`` launches kernel #8 (NCHW) or #10 (NHWC)
and its grad op #9 or #11, for every shape: the JAX package's shape gate
(``conv_bn.supported``) is a TPU VMEM budget, with an XLA fallback the
port does not have.  On the CPU they run the plain versions.

The grad op folds the stats' cotangents with the shift its forward
accumulated with.  The fusion pass wires ``StatsShift`` to the consumer
BN's running mean, which ``bn_update_stats`` rewrites under the same name
(the ``layers.batch_norm`` same-name output); by the time the grad op runs,
the program's variable holds the updated mean.  So the forward keeps the
tensor it read in ``ctx.saved`` under its op index, and the grad op reads
that one back through ``__fwd_op_index__``.  (The JAX package's grad op
reads the variable, and its gradient is off by 2 (shift_old - shift_new)
dvar / count an element when the running mean moves.)
"""

import torch

from ..flags import flag
from ..registry import in_var, register_op, set_output
from .cuda import conv_bn as cb
from .norm import bn_axes, shifted_one_pass_stats


def _layout(attrs):
    return attrs.get("data_layout", "NCHW")


def _c_axis(attrs, ndim):
    return ndim - 1 if _layout(attrs) == "NHWC" else 1


# -- batch_stats ------------------------------------------------------------

def _batch_stats_infer(op, block):
    x = in_var(op, block, "X")
    c = x.shape[_c_axis(op.attrs, len(x.shape))]
    set_output(op, block, "BatchMean", (c,), "float32")
    set_output(op, block, "BatchVar", (c,), "float32")


def _batch_stats_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    red, bshape = bn_axes(x, _layout(attrs))
    xf = x.float()
    if flag("bn_two_pass"):
        mean = xf.mean(dim=red)
        d = xf - mean.view(bshape)
        return {"BatchMean": mean, "BatchVar": (d * d).mean(dim=red)}
    mean, var = shifted_one_pass_stats(xf, ins.get("Shift", [None])[0], red,
                                       bshape)
    return {"BatchMean": mean, "BatchVar": var}


register_op("batch_stats", ["X", "Shift"], ["BatchMean", "BatchVar"],
            infer=_batch_stats_infer, compute=_batch_stats_compute,
            no_grad_inputs=("Shift",))


# -- stats_finalize ---------------------------------------------------------

def _stats_finalize_infer(op, block):
    s = in_var(op, block, "Sum")
    set_output(op, block, "BatchMean", s.shape, "float32")
    set_output(op, block, "BatchVar", s.shape, "float32")


def _stats_finalize_compute(ins, attrs, ctx, op_index):
    # sum/sumsq were accumulated shifted by the BN's running mean
    s, ss = ins["Sum"][0].float(), ins["SumSq"][0].float()
    shift = ins.get("Shift", [None])[0]
    ref = ins.get("CountFrom", [None])[0]
    if ref is not None:
        ca = _c_axis(attrs, ref.dim())
        cnt = 1.0
        for i, d in enumerate(ref.shape):
            if i != ca:
                cnt *= d
    else:
        cnt = float(attrs["count"])
    m1 = s / cnt
    var = torch.clamp(ss / cnt - m1 * m1, min=0.0)
    mean = m1 + shift.float() if shift is not None else m1
    return {"BatchMean": mean, "BatchVar": var}


register_op("stats_finalize", ["Sum", "SumSq", "CountFrom", "Shift"],
            ["BatchMean", "BatchVar"], infer=_stats_finalize_infer,
            compute=_stats_finalize_compute,
            no_grad_inputs=("CountFrom", "Shift"))


# -- bn_update_stats --------------------------------------------------------

def _update_stats_infer(op, block):
    m = in_var(op, block, "Mean")
    set_output(op, block, "MeanOut", m.shape, m.dtype)
    set_output(op, block, "VarianceOut", m.shape, m.dtype)


def _update_stats_compute(ins, attrs, ctx, op_index):
    mean, var = ins["Mean"][0], ins["Variance"][0]
    bm, bv = ins["BatchMean"][0], ins["BatchVar"][0]
    mom = attrs.get("momentum", 0.9)
    return {"MeanOut": mom * mean + (1.0 - mom) * bm.to(mean.dtype),
            "VarianceOut": mom * var + (1.0 - mom) * bv.to(var.dtype)}


register_op("bn_update_stats", ["Mean", "Variance", "BatchMean", "BatchVar"],
            ["MeanOut", "VarianceOut"], infer=_update_stats_infer,
            compute=_update_stats_compute, grad=None,
            no_grad_inputs=("Mean", "Variance", "BatchMean", "BatchVar"))


# -- bn_apply ---------------------------------------------------------------

def _bn_apply_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "Y", x.shape, x.dtype)


def _bn_apply_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    _, bshape = bn_axes(x, _layout(attrs))
    mean = ins["BatchMean"][0].float().view(bshape)
    rstd = torch.rsqrt(ins["BatchVar"][0].float()
                       + attrs.get("epsilon", 1e-5))
    g = (rstd * ins["Scale"][0].float()).view(bshape)
    y = (x.float() - mean) * g + ins["Bias"][0].float().view(bshape)
    if attrs.get("act", "") == "relu":
        y = torch.relu(y)
    return {"Y": y.to(x.dtype)}


register_op("bn_apply", ["X", "BatchMean", "BatchVar", "Scale", "Bias"],
            ["Y"], infer=_bn_apply_infer, compute=_bn_apply_compute)


# -- bn_act_conv2d ----------------------------------------------------------

def _nhwc(attrs):
    return attrs.get("data_format", "NCHW") == "NHWC"


def _bac_infer(op, block):
    x = in_var(op, block, "X")
    o = in_var(op, block, "Filter").shape[0]
    if _nhwc(op.attrs):
        out_shape = (x.shape[0], x.shape[1], x.shape[2], o)
    else:
        out_shape = (x.shape[0], o, x.shape[2], x.shape[3])
    set_output(op, block, "Out", out_shape, x.dtype)
    set_output(op, block, "SumOut", (o,), "float32")
    set_output(op, block, "SumSqOut", (o,), "float32")


def _bac_args(ins, attrs):
    """(x as the kernels' [B, C, HW] or [M, C], W [O, C], mean, rstd,
    gamma, beta (float32 [C], None without apply_bn), the 4-D output
    shape)."""
    x = ins["X"][0]
    filt = ins["Filter"][0]
    o = filt.shape[0]
    if _nhwc(attrs):
        b, h, wd, c = x.shape
        x2 = x.reshape(b * h * wd, c).contiguous()
        out_shape = (b, h, wd, o)
    else:
        b, c, h, wd = x.shape
        x2 = x.reshape(b, c, h * wd).contiguous()
        out_shape = (b, o, h, wd)
    w = filt.reshape(o, c).to(x.dtype).contiguous()
    if not attrs.get("apply_bn", True):
        return x2, w, None, None, None, None, out_shape
    rstd = torch.rsqrt(ins["BatchVar"][0].float() + attrs.get("epsilon", 1e-5))
    return (x2, w, ins["BatchMean"][0].float().contiguous(), rstd,
            ins["Scale"][0].float().contiguous(),
            ins["Bias"][0].float().contiguous(), out_shape)


def _bac_compute(ins, attrs, ctx, op_index):
    x, w, mean, rstd, gamma, beta, out_shape = _bac_args(ins, attrs)
    o = w.shape[0]
    shift = ins.get("StatsShift", [None])[0]
    shift = (torch.zeros(o, dtype=torch.float32, device=x.device)
             if shift is None else shift.detach().float().contiguous())
    # the grad op folds with this tensor, not with the variable's value
    # after bn_update_stats has rewritten it
    ctx.saved[(op_index, "StatsShift")] = shift
    z, s, ss = cb.forward(x, w, mean, rstd, gamma, beta, shift,
                          attrs.get("act", ""),
                          bool(attrs.get("apply_bn", True)),
                          bool(attrs.get("with_stats", True)),
                          _nhwc(attrs))
    return {"Out": z.reshape(out_shape), "SumOut": s, "SumSqOut": ss}


def _bac_grad_maker(op, no_grad_set):
    """One ``bn_act_conv2d_grad`` reading the saved forward output (the z
    the stats cotangents fold over); no forward recompute."""
    from ..framework import grad_var_name

    outs = {}
    for slot in ("X", "Filter", "BatchMean", "BatchVar", "Scale", "Bias"):
        outs["GRAD::" + slot] = ["" if n in no_grad_set else grad_var_name(n)
                                 for n in op.inputs.get(slot, [])]
    if not any(n for ns in outs.values() for n in ns):
        return []
    g_inputs = {slot: list(op.inputs.get(slot, []))
                for slot in ("X", "Filter", "BatchMean", "BatchVar",
                             "Scale", "Bias", "StatsShift")}
    g_inputs["Out::Out"] = list(op.outputs["Out"])
    g_inputs["GRAD::Out"] = [grad_var_name(n) for n in op.outputs["Out"]]
    if op.attrs.get("with_stats", True):
        # a with_stats=False op's SumOut is dead zeros with no gradient
        for slot in ("SumOut", "SumSqOut"):
            g_inputs["GRAD::" + slot] = [grad_var_name(n)
                                         for n in op.outputs[slot]]
    return [dict(type="bn_act_conv2d_grad", inputs=g_inputs, outputs=outs,
                 attrs=dict(op.attrs))]


def _bac_grad_infer(gop, block):
    for slot in ("X", "Filter", "BatchMean", "BatchVar", "Scale", "Bias"):
        for n, g in zip(gop.inputs.get(slot, []),
                        gop.outputs.get("GRAD::" + slot, [])):
            v = block._find_var_recursive(n) if g else None
            if v is not None:
                block.create_var(name=g, shape=v.shape, dtype=v.dtype,
                                 persistable=False)


def _bac_grad_compute(ins, attrs, ctx, op_index):
    x, w, mean, rstd, gamma, beta, _ = _bac_args(ins, attrs)
    o, c = w.shape
    apply_bn = bool(attrs.get("apply_bn", True))
    filt = ins["Filter"][0]
    z = ins["Out::Out"][0]
    dz = ins["GRAD::Out"][0]
    dsum = ins.get("GRAD::SumOut", [None])[0]
    dsumsq = ins.get("GRAD::SumSqOut", [None])[0]
    fold = bool(attrs.get("with_stats", True)) \
        and (dsum is not None or dsumsq is not None)
    shift = None
    if fold:
        key = (attrs["__fwd_op_index__"], "StatsShift")
        if key not in ctx.saved:
            raise RuntimeError(
                "bn_act_conv2d_grad: the forward bn_act_conv2d (op %d) did "
                "not run in this Executor.run, so the stats shift it "
                "accumulated with is unknown" % key[0])
        shift = ctx.saved[key]
        zeros = torch.zeros(o, dtype=torch.float32, device=x.device)
        dsum = zeros if dsum is None else dsum.float().contiguous()
        dsumsq = zeros if dsumsq is None else dsumsq.float().contiguous()
    dz = torch.zeros_like(z) if dz is None else dz
    nhwc = _nhwc(attrs)

    def kernel_layout(t):
        """A 4-D activation of O channels in the kernels' layout."""
        t = t.reshape(-1, o) if nhwc else t.reshape(x.shape[0], o, -1)
        return t.to(x.dtype).contiguous()

    dx, dw, dgamma, dbeta = cb.backward(
        x, w, kernel_layout(z), kernel_layout(dz), dsum, dsumsq, mean, rstd,
        gamma, beta, shift, attrs.get("act", ""), apply_bn, fold, nhwc)
    out = {"GRAD::X": dx.reshape(ins["X"][0].shape),
           "GRAD::Filter": dw.reshape(o, c, 1, 1).to(filt.dtype)}
    if apply_bn:
        sdt = ins["Scale"][0].dtype
        dmean, dvar = cb.stats_grads(True, gamma, rstd, dgamma, dbeta)
        out.update({"GRAD::BatchMean": dmean.to(sdt),
                    "GRAD::BatchVar": dvar.to(sdt),
                    "GRAD::Scale": dgamma.to(sdt),
                    "GRAD::Bias": dbeta.to(sdt)})
    return out


register_op("bn_act_conv2d",
            ["X", "Filter", "BatchMean", "BatchVar", "Scale", "Bias",
             "StatsShift"], ["Out", "SumOut", "SumSqOut"],
            infer=_bac_infer, compute=_bac_compute, grad=_bac_grad_maker,
            no_grad_inputs=("StatsShift",))
register_op("bn_act_conv2d_grad",
            ["X", "Filter", "BatchMean", "BatchVar", "Scale", "Bias",
             "StatsShift", "Out::Out", "GRAD::Out", "GRAD::SumOut",
             "GRAD::SumSqOut"],
            ["GRAD::X", "GRAD::Filter", "GRAD::BatchMean", "GRAD::BatchVar",
             "GRAD::Scale", "GRAD::Bias"],
            infer=_bac_grad_infer, compute=_bac_grad_compute, grad=None)
