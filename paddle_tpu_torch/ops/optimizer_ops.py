"""Optimizer update ops ``sgd``, ``momentum``, ``adam`` and ``adagrad``,
dense and SelectedRows (counterpart of ``paddle_tpu/ops/optimizer_ops.py``;
the other optimizers wait).

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
table sharded over a mesh (the JAX package's ``_maybe_sharded_rows``)
waits for ROADMAP A7; on one device both packages take this route."""

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


def _sgd_compute(ins, attrs, ctx, op_index):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    lr = lr.to(p.dtype)
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
    v.mul_(mu).add_(g)               # v = mu * v + g
    if nesterov:
        p.sub_((g + mu * v) * lr)
    else:
        p.sub_(lr * v)
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
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    if isinstance(g, SelectedRows):
        uniq, gm, valid, p_r, m1_r, m2_r = _touched(g, p, m1, m2)
        m1_new = b1 * m1_r + (1 - b1) * gm
        m2_new = b2 * m2_r + (1 - b2) * gm * gm
        p_new = p_r - lr_t * m1_new / (torch.sqrt(m2_new) + eps)
        scatter_update_rows(p, uniq, valid, p_new)
        scatter_update_rows(m1, uniq, valid, m1_new)
        scatter_update_rows(m2, uniq, valid, m2_new)
        return {"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2}
    # m1 = b1 * m1 + (1 - b1) * g;  m2 = b2 * m2 + (1 - b2) * g * g
    m1.mul_(b1).add_((1 - b1) * g)
    m2.mul_(b2).add_((1 - b2) * g * g)
    p.sub_(lr_t * m1 / (torch.sqrt(m2) + eps))
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
    if isinstance(g, SelectedRows):
        uniq, gm, valid, p_r, mom_r = _touched(g, p, mom)
        mom_new = mom_r + gm * gm
        p_new = p_r - lr * gm / (torch.sqrt(mom_new) + eps)
        scatter_update_rows(p, uniq, valid, p_new)
        scatter_update_rows(mom, uniq, valid, mom_new)
        return {"ParamOut": p, "MomentOut": mom}
    mom.add_(g * g)                  # mom = mom + g * g
    p.sub_(lr * g / (torch.sqrt(mom) + eps))
    return {"ParamOut": p, "MomentOut": mom}


register_op(
    "adagrad", ["Param", "Grad", "Moment", "LearningRate"],
    ["ParamOut", "MomentOut"],
    infer=_mirror_infer(("Param", "ParamOut"), ("Moment", "MomentOut")),
    compute=_adagrad_compute, grad=None)
