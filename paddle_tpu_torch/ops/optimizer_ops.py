"""Optimizer update ops (counterpart of ``paddle_tpu/ops/optimizer_ops.py``):
``sgd``, ``momentum``, ``adam`` and ``adagrad``, dense and SelectedRows;
``adamax``, ``adadelta``, ``rmsprop`` (centered or not, with momentum),
``decayed_adagrad``, ``ftrl``, ``proximal_gd`` and ``proximal_adagrad``,
dense only; and ``average_accumulates``, ModelAverage's window of
parameter sums.

Each updates the parameter and moment tensors IN PLACE and returns them:
the JAX package gets the same effect from buffer donation, and at
Transformer-base size it saves one parameter-sized allocation per output.
The arithmetic is the JAX package's, in the same order.

With a SelectedRows gradient (``selected_rows``) the updates are lazy, as
the JAX package's: only the touched rows move, and a row a step does not
touch keeps its parameter and accumulators bit for bit.  Sparse SGD adds
the unmerged rows one by one (``p + (-lr v1) + (-lr v2)``); Momentum, Adam
and Adagrad merge duplicates first, update the touched rows gathered from
the tables and write them back.  The JAX package writes them back as
``p + (p_new - p)``; the port writes ``p_new`` itself, so a touched row is
exactly what the dense update computes from the same merged gradient.  A
table the mesh runtime row-shards (the JAX package's
``_maybe_sharded_rows``; the op's ``__table_axes__`` attr, set by
``ParallelExecutor``'s plan) takes its gradient through
``parallel.embedding.sharded_sparse_update`` first: the rows of every
rank's batch, made local, so each rank updates only its own rows.

The moments round as the JAX package's compiled step does on the CPU:
XLA contracts ``b1 * m + (1 - b1) * g`` into one fused multiply-add,
``fma(b1, m, (1 - b1) * g)`` (``_fma``), and so Adam's ``m`` and ``v``,
Momentum's ``mu * v + g`` and its ``p - lr * v`` (``_fms``), Adamax's
moment, RMSProp's mean square, mean gradient and momentum, and Adagrad's
``mom + g * g``.  Rounded twice, as eager arithmetic does, a third of
the float32 moments sit one ulp off the reference's; a step that divides
by ``sqrt(v)`` shows that ulp in the parameter near a zero gradient.
The square roots are correctly rounded (``_sqrt``): the CPU's vectorized
float32 ``sqrt`` is not (0.7% of a random ``v`` one ulp off).  RMSProp
divides by a square root as XLA rewrites it, ``x * rsqrt(y)``
(``_over_sqrt``), and still differs in an ulp here and there: the CPU's
``rsqrt`` in the JAX package is an estimate refined by one Newton step
(one ulp off the correctly rounded value for about 12% of inputs), which
the port does not copy.  All of this holds for CPU
tensors only: on the card the state updates in place in float32,
rounded twice, since the float64 temporaries would add kernels to every
parameter's step there, and what the card rounds is a compiler's choice
in both packages.

The JAX package gives the dense-only updates no SelectedRows leg: an
``is_sparse`` gradient reaching one fails there inside the op's
arithmetic.  Here it raises a TypeError naming the op
(``_dense_grad``)."""

import numpy as np
import torch

from ..registry import in_var, register_op, set_output
from .selected_rows import (SelectedRows, merge_rows, scatter_add_rows,
                            scatter_update_rows)


def _mirror_infer(*pairs):
    """Each output slot takes the shape and dtype of its input slot."""

    def infer(op, block):
        for in_slot, out_slot in pairs:
            v = in_var(op, block, in_slot)
            if v is not None and out_slot in op.outputs:
                set_output(op, block, out_slot, v.shape, v.dtype)

    return infer


def _touched(g, *tables):
    """(unique rows, their merged gradient, valid, safe row indices) of a
    SelectedRows and each table's touched rows (gathered, so a copy)."""
    uniq, gm, valid = merge_rows(g)
    safe = torch.where(valid, uniq, 0)
    return (uniq, gm, valid) + tuple(t[safe] for t in tables)


def _fma(a, x, y):
    """``a * x + y`` rounded once (a fused multiply-add) for float32 CPU
    tensors ``x`` and ``y``; ``a`` is a Python number (taken as float32)
    or a float32 tensor.  The product of two float32 values is exact in
    float64, so the float64 sum rounds once more only where it lands on a
    float32 tie.  Other dtypes, and tensors on the card, round twice."""
    if x.dtype != torch.float32 or x.is_cuda:
        return a * x + y
    a = a.double() if isinstance(a, torch.Tensor) \
        else float(np.float32(a))
    return (a * x.double() + y.double()).float()


def _fms(y, a, x):
    """``y - a * x`` rounded once, as ``_fma``: XLA contracts a difference
    of a product as it does a sum."""
    if x.dtype != torch.float32 or x.is_cuda:
        return y - a * x
    return _fma(-a if isinstance(a, torch.Tensor) else -np.float32(a),
                x, y)


def _moment(m, b, u):
    """``m = b * m + u`` in place: in one float32 step on the card, rounded
    once through ``_fma`` on the CPU."""
    if m.is_cuda:
        m.mul_(b).add_(u)
    else:
        m.copy_(_fma(b, m, u))


def _sqrt(x):
    """Correctly rounded square root: the card's float32 ``sqrt`` is IEEE;
    the CPU's vectorized one is not, so a CPU float32 tensor takes it in
    float64 (one rounding to float32 after an exact-enough root)."""
    if x.dtype == torch.float32 and not x.is_cuda:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _over_sqrt(x, y):
    """``x / sqrt(y)``; for float32 CPU tensors as XLA computes it there,
    ``x * rsqrt(y)``, with the reciprocal square root rounded correctly
    (XLA's CPU estimate is not, see the module's docstring)."""
    if y.dtype == torch.float32 and not y.is_cuda:
        return x * (1.0 / torch.sqrt(y.double())).float()
    return x / torch.sqrt(y)


def _sgd_compute(ins, attrs, ctx, op_index):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    lr = lr.to(p.dtype)
    g = _sharded_rows(ctx, attrs, g)
    if isinstance(g, SelectedRows):
        scatter_add_rows(p, g.rows, -lr * g.values.to(p.dtype))
    else:
        p.sub_(lr * g.to(p.dtype))
    return {"ParamOut": p}


register_op("sgd", ["Param", "Grad", "LearningRate"], ["ParamOut"],
            infer=_mirror_infer(("Param", "ParamOut")), compute=_sgd_compute,
            grad=None)


def _momentum_compute(ins, attrs, ctx, op_index):
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    lr = ins["LearningRate"][0].to(p.dtype)
    mu = attrs["mu"]
    nesterov = attrs.get("use_nesterov", False)
    g = _sharded_rows(ctx, attrs, g)
    if isinstance(g, SelectedRows):
        uniq, gm, valid, p_r, v_r = _touched(g, p, v)
        v_new = mu * v_r + gm
        if nesterov:
            p_new = p_r - (gm + mu * v_new) * lr
        else:
            p_new = p_r - lr * v_new
        scatter_update_rows(p, uniq, valid, p_new)
        scatter_update_rows(v, uniq, valid, v_new)
        return {"ParamOut": p, "VelocityOut": v}
    _moment(v, mu, g)                # v = mu * v + g
    if p.is_cuda:
        p.sub_((g + mu * v) * lr if nesterov else lr * v)
    elif nesterov:
        p.copy_(_fms(p, _fma(mu, v, g), lr))
    else:
        p.copy_(_fms(p, lr, v))
    return {"ParamOut": p, "VelocityOut": v}


register_op(
    "momentum", ["Param", "Grad", "Velocity", "LearningRate"],
    ["ParamOut", "VelocityOut"],
    infer=_mirror_infer(("Param", "ParamOut"), ("Velocity", "VelocityOut")),
    compute=_momentum_compute, grad=None)


def _adam_compute(ins, attrs, ctx, op_index):
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    lr = ins["LearningRate"][0].to(p.dtype)
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr_t = lr * _sqrt(1 - b2p) / (1 - b1p)
    g = _sharded_rows(ctx, attrs, g)
    if isinstance(g, SelectedRows):
        uniq, gm, valid, p_r, m1_r, m2_r = _touched(g, p, m1, m2)
        m1_new = _fma(b1, m1_r, (1 - b1) * gm)
        m2_new = _fma(b2, m2_r, (1 - b2) * gm * gm)
        p_new = p_r - lr_t * m1_new / (_sqrt(m2_new) + eps)
        scatter_update_rows(p, uniq, valid, p_new)
        scatter_update_rows(m1, uniq, valid, m1_new)
        scatter_update_rows(m2, uniq, valid, m2_new)
        return {"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2}
    # m1 = b1 * m1 + (1 - b1) * g;  m2 = b2 * m2 + (1 - b2) * g * g
    _moment(m1, b1, (1 - b1) * g)
    _moment(m2, b2, (1 - b2) * g * g)
    p.sub_(lr_t * m1 / (_sqrt(m2) + eps))
    return {"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2}


register_op(
    "adam",
    ["Param", "Grad", "LearningRate", "Moment1", "Moment2", "Beta1Pow",
     "Beta2Pow"],
    ["ParamOut", "Moment1Out", "Moment2Out"],
    infer=_mirror_infer(("Param", "ParamOut"), ("Moment1", "Moment1Out"),
                        ("Moment2", "Moment2Out")),
    compute=_adam_compute, grad=None)


def _adagrad_compute(ins, attrs, ctx, op_index):
    p, g, mom = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    lr = ins["LearningRate"][0].to(p.dtype)
    eps = attrs.get("epsilon", 1e-6)
    g = _sharded_rows(ctx, attrs, g)
    if isinstance(g, SelectedRows):
        uniq, gm, valid, p_r, mom_r = _touched(g, p, mom)
        mom_new = mom_r + gm * gm
        p_new = p_r - lr * gm / (torch.sqrt(mom_new) + eps)
        scatter_update_rows(p, uniq, valid, p_new)
        scatter_update_rows(mom, uniq, valid, mom_new)
        return {"ParamOut": p, "MomentOut": mom}
    if mom.is_cuda:
        mom.add_(g * g)              # mom = mom + g * g
    else:
        mom.copy_(_fma(g, g, mom))
    p.sub_(lr * g / (_sqrt(mom) + eps))
    return {"ParamOut": p, "MomentOut": mom}


register_op(
    "adagrad", ["Param", "Grad", "Moment", "LearningRate"],
    ["ParamOut", "MomentOut"],
    infer=_mirror_infer(("Param", "ParamOut"), ("Moment", "MomentOut")),
    compute=_adagrad_compute, grad=None)


def _sharded_rows(ctx, attrs, g):
    """A row-sharded table's SelectedRows gradient made local
    (``parallel.embedding.sharded_sparse_update``); ``g`` otherwise."""
    if isinstance(g, SelectedRows) and ctx.mesh is not None \
            and attrs.get("__table_axes__"):
        from ..parallel import embedding

        return embedding.sharded_sparse_update(ctx, attrs, g)
    return g


def _dense_grad(op_type, g):
    if isinstance(g, SelectedRows):
        raise TypeError(
            "%s takes a dense gradient: the JAX package gives it no "
            "SelectedRows update either (build the embedding with "
            "is_sparse=False, or use sgd, momentum, adam or adagrad)"
            % op_type)
    return g


def _write(**pairs):
    """Copy each new value into its state tensor (in place, as the
    updates above) and return {slot: state tensor}."""
    return {slot: dst.copy_(val) for slot, (dst, val) in pairs.items()}


def _adamax_compute(ins, attrs, ctx, op_index):
    p, g = ins["Param"][0], _dense_grad("adamax", ins["Grad"][0])
    m, inf_norm = ins["Moment"][0], ins["InfNorm"][0]
    b1p = ins["Beta1Pow"][0]
    lr = ins["LearningRate"][0].to(p.dtype)
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_out = _fma(b1, m, (1 - b1) * g)
    inf_out = torch.maximum(b2 * inf_norm, torch.abs(g) + eps)
    lr_t = lr / (1 - b1p)
    p_out = p - lr_t * m_out / inf_out
    return _write(ParamOut=(p, p_out), MomentOut=(m, m_out),
                  InfNormOut=(inf_norm, inf_out))


register_op(
    "adamax",
    ["Param", "Grad", "LearningRate", "Moment", "InfNorm", "Beta1Pow"],
    ["ParamOut", "MomentOut", "InfNormOut"],
    infer=_mirror_infer(("Param", "ParamOut"), ("Moment", "MomentOut"),
                        ("InfNorm", "InfNormOut")),
    compute=_adamax_compute, grad=None)


def _adadelta_compute(ins, attrs, ctx, op_index):
    p, g = ins["Param"][0], _dense_grad("adadelta", ins["Grad"][0])
    avg_sq_g, avg_sq_u = ins["AvgSquaredGrad"][0], ins["AvgSquaredUpdate"][0]
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g2 = rho * avg_sq_g + (1 - rho) * g * g
    # epsilon inside both square roots, as the JAX package takes it
    update = -torch.sqrt((avg_sq_u + eps) / (g2 + eps)) * g
    u2 = rho * avg_sq_u + (1 - rho) * update * update
    return _write(ParamOut=(p, p + update), AvgSquaredGradOut=(avg_sq_g, g2),
                  AvgSquaredUpdateOut=(avg_sq_u, u2))


register_op(
    "adadelta", ["Param", "Grad", "AvgSquaredGrad", "AvgSquaredUpdate"],
    ["ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"],
    infer=_mirror_infer(("Param", "ParamOut"),
                        ("AvgSquaredGrad", "AvgSquaredGradOut"),
                        ("AvgSquaredUpdate", "AvgSquaredUpdateOut")),
    compute=_adadelta_compute, grad=None)


def _rmsprop_compute(ins, attrs, ctx, op_index):
    p, g = ins["Param"][0], _dense_grad("rmsprop", ins["Grad"][0])
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    lr = ins["LearningRate"][0].to(p.dtype)
    rho = attrs.get("decay", 0.9)
    eps = attrs.get("epsilon", 1e-10)
    momentum = attrs.get("momentum", 0.0)
    ms_out = _fma(rho, ms, (1 - rho) * g * g)
    if attrs.get("centered", False):
        mg = ins["MeanGrad"][0]
        mg_out = _fma(rho, mg, (1 - rho) * g)
        mom_out = _fma(momentum, mom, _over_sqrt(
            lr * g, _fms(ms_out, mg_out, mg_out) + eps))
        return _write(ParamOut=(p, p - mom_out), MeanSquareOut=(ms, ms_out),
                      MomentOut=(mom, mom_out), MeanGradOut=(mg, mg_out))
    mom_out = _fma(momentum, mom, _over_sqrt(lr * g, ms_out + eps))
    return _write(ParamOut=(p, p - mom_out), MeanSquareOut=(ms, ms_out),
                  MomentOut=(mom, mom_out))


register_op(
    "rmsprop",
    ["Param", "Grad", "MeanSquare", "MeanGrad", "Moment", "LearningRate"],
    ["ParamOut", "MeanSquareOut", "MomentOut", "MeanGradOut"],
    infer=_mirror_infer(("Param", "ParamOut"), ("MeanSquare", "MeanSquareOut"),
                        ("Moment", "MomentOut"), ("MeanGrad", "MeanGradOut")),
    compute=_rmsprop_compute, grad=None)


def _decayed_adagrad_compute(ins, attrs, ctx, op_index):
    p, mom = ins["Param"][0], ins["Moment"][0]
    g = _dense_grad("decayed_adagrad", ins["Grad"][0])
    lr = ins["LearningRate"][0].to(p.dtype)
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mom_out = decay * mom + (1 - decay) * g * g
    p_out = p - lr * g / (torch.sqrt(mom_out) + eps)
    return _write(ParamOut=(p, p_out), MomentOut=(mom, mom_out))


register_op(
    "decayed_adagrad", ["Param", "Grad", "Moment", "LearningRate"],
    ["ParamOut", "MomentOut"],
    infer=_mirror_infer(("Param", "ParamOut"), ("Moment", "MomentOut")),
    compute=_decayed_adagrad_compute, grad=None)


def _ftrl_compute(ins, attrs, ctx, op_index):
    p, g = ins["Param"][0], _dense_grad("ftrl", ins["Grad"][0])
    sq_accum = ins["SquaredAccumulator"][0]
    lin_accum = ins["LinearAccumulator"][0]
    lr = ins["LearningRate"][0].to(p.dtype)
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    lr_power = attrs.get("lr_power", -0.5)
    new_accum = sq_accum + g * g
    if lr_power == -0.5:
        lin_out = lin_accum + g - (
            torch.sqrt(new_accum) - torch.sqrt(sq_accum)) / lr * p
        y = torch.sqrt(new_accum) / lr + 2 * l2
    else:
        lin_out = lin_accum + g - (
            torch.pow(new_accum, -lr_power) - torch.pow(sq_accum, -lr_power)
        ) / lr * p
        y = torch.pow(new_accum, -lr_power) / lr + 2 * l2
    x = l1 * torch.sign(lin_out) - lin_out
    p_out = torch.where(torch.abs(lin_out) > l1, x / y, torch.zeros_like(p))
    return _write(ParamOut=(p, p_out), SquaredAccumOut=(sq_accum, new_accum),
                  LinearAccumOut=(lin_accum, lin_out))


register_op(
    "ftrl",
    ["Param", "SquaredAccumulator", "LinearAccumulator", "Grad",
     "LearningRate"],
    ["ParamOut", "SquaredAccumOut", "LinearAccumOut"],
    infer=_mirror_infer(("Param", "ParamOut"),
                        ("SquaredAccumulator", "SquaredAccumOut"),
                        ("LinearAccumulator", "LinearAccumOut")),
    compute=_ftrl_compute, grad=None)


def _soft_threshold(prox, lr_t, l1, l2):
    return torch.sign(prox) * torch.clamp(
        torch.abs(prox) - lr_t * l1, min=0.0) / (1.0 + lr_t * l2)


def _proximal_gd_compute(ins, attrs, ctx, op_index):
    p, g = ins["Param"][0], _dense_grad("proximal_gd", ins["Grad"][0])
    lr = ins["LearningRate"][0].to(p.dtype)
    p_out = _soft_threshold(p - lr * g, lr, attrs.get("l1", 0.0),
                            attrs.get("l2", 0.0))
    return _write(ParamOut=(p, p_out))


register_op(
    "proximal_gd", ["Param", "Grad", "LearningRate"], ["ParamOut"],
    infer=_mirror_infer(("Param", "ParamOut")), compute=_proximal_gd_compute,
    grad=None)


def _proximal_adagrad_compute(ins, attrs, ctx, op_index):
    p, mom = ins["Param"][0], ins["Moment"][0]
    g = _dense_grad("proximal_adagrad", ins["Grad"][0])
    lr = ins["LearningRate"][0].to(p.dtype)
    mom_out = mom + g * g
    lr_t = lr / torch.sqrt(mom_out)
    p_out = _soft_threshold(p - lr_t * g, lr_t, attrs.get("l1", 0.0),
                            attrs.get("l2", 0.0))
    return _write(ParamOut=(p, p_out), MomentOut=(mom, mom_out))


register_op(
    "proximal_adagrad", ["Param", "Moment", "Grad", "LearningRate"],
    ["ParamOut", "MomentOut"],
    infer=_mirror_infer(("Param", "ParamOut"), ("Moment", "MomentOut")),
    compute=_proximal_adagrad_compute, grad=None)


# ModelAverage's accumulator protocol: three staggered sum buffers (sum_1
# rolls into sum_2 every _K_MAX_NUM_ACCUMULATES updates, against float32
# precision loss over long runs) and a trailing window that restarts once
# it holds min(max_average_window, num_updates * average_window) updates
# (and at least min_average_window), keeping the last window's sum in
# sum_3 and its length in old_num_accumulates.  The counters are int64.
_K_MAX_NUM_ACCUMULATES = 16384


def _avg_acc_compute(ins, attrs, ctx, op_index):
    param = ins["param"][0]
    s1, s2, s3 = ins["in_sum_1"][0], ins["in_sum_2"][0], ins["in_sum_3"][0]
    num_acc = ins["in_num_accumulates"][0]
    old_num_acc = ins["in_old_num_accumulates"][0]
    num_upd = ins["in_num_updates"][0]
    avg_window = attrs.get("average_window", 0.0)
    max_w = attrs["max_average_window"]
    min_w = attrs.get("min_average_window", 10000)

    num_upd_out = num_upd + 1
    num_acc_out = num_acc + 1
    out1 = s1 + param
    # the roll moves the buffers as they were before this update
    roll = (num_upd_out % _K_MAX_NUM_ACCUMULATES) == 0
    out2 = torch.where(roll, s2 + s1, s2)
    out1 = torch.where(roll, torch.zeros_like(out1), out1)

    limit = torch.clamp(
        (num_upd_out.to(torch.float32) * avg_window).to(num_acc.dtype),
        max=max_w)
    done = (num_acc_out >= min_w) & (num_acc_out >= limit)
    out3 = torch.where(done, s1 + s2, s3)
    out1 = torch.where(done, torch.zeros_like(out1), out1)
    out2 = torch.where(done, torch.zeros_like(out2), out2)
    old_out = torch.where(done, num_acc_out, old_num_acc)
    num_acc_out = torch.where(done, torch.zeros_like(num_acc_out),
                              num_acc_out)
    return _write(out_sum_1=(s1, out1), out_sum_2=(s2, out2),
                  out_sum_3=(s3, out3),
                  out_num_accumulates=(num_acc, num_acc_out),
                  out_old_num_accumulates=(old_num_acc, old_out),
                  out_num_updates=(num_upd, num_upd_out))


register_op(
    "average_accumulates",
    ["param", "in_sum_1", "in_sum_2", "in_sum_3", "in_num_accumulates",
     "in_old_num_accumulates", "in_num_updates"],
    ["out_sum_1", "out_sum_2", "out_sum_3", "out_num_accumulates",
     "out_old_num_accumulates", "out_num_updates"],
    infer=_mirror_infer(
        ("in_sum_1", "out_sum_1"), ("in_sum_2", "out_sum_2"),
        ("in_sum_3", "out_sum_3"),
        ("in_num_accumulates", "out_num_accumulates"),
        ("in_old_num_accumulates", "out_old_num_accumulates"),
        ("in_num_updates", "out_num_updates")),
    compute=_avg_acc_compute, grad=None)
