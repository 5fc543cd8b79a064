"""Dense optimizer update ops ``sgd``, ``momentum`` and ``adam``
(counterpart of ``paddle_tpu/ops/optimizer_ops.py``; the SelectedRows
branch and the other optimizers wait).

All three update the parameter and moment tensors IN PLACE and return them:
the JAX package gets the same effect from buffer donation, and at
Transformer-base size it saves one parameter-sized allocation per output.
The arithmetic is the JAX package's, in the same order."""

import torch

from ..registry import in_var, register_op, set_output


def _mirror_infer(*pairs):
    """Each output slot takes the shape and dtype of its input slot."""

    def infer(op, block):
        for in_slot, out_slot in pairs:
            v = in_var(op, block, in_slot)
            if v is not None and out_slot in op.outputs:
                set_output(op, block, out_slot, v.shape, v.dtype)

    return infer


def _dense(g, op_type):
    if not isinstance(g, torch.Tensor):
        raise NotImplementedError(
            "%s on a SelectedRows gradient is not ported to "
            "paddle_tpu_torch yet (ROADMAP Queue A4)" % op_type)
    return g


def _sgd_compute(ins, attrs, ctx, op_index):
    p, lr = ins["Param"][0], ins["LearningRate"][0]
    g = _dense(ins["Grad"][0], "sgd")
    p.sub_(lr.to(p.dtype) * g.to(p.dtype))
    return {"ParamOut": p}


register_op("sgd", ["Param", "Grad", "LearningRate"], ["ParamOut"],
            infer=_mirror_infer(("Param", "ParamOut")), compute=_sgd_compute,
            grad=None)


def _adam_compute(ins, attrs, ctx, op_index):
    p, g = ins["Param"][0], _dense(ins["Grad"][0], "adam")
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    lr = ins["LearningRate"][0].to(p.dtype)
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    # m1 = b1 * m1 + (1 - b1) * g;  m2 = b2 * m2 + (1 - b2) * g * g
    m1.mul_(b1).add_((1 - b1) * g)
    m2.mul_(b2).add_((1 - b2) * g * g)
    p.sub_(lr_t * m1 / (torch.sqrt(m2) + eps))
    return {"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2}


def _momentum_compute(ins, attrs, ctx, op_index):
    p, v = ins["Param"][0], ins["Velocity"][0]
    g = _dense(ins["Grad"][0], "momentum")
    lr = ins["LearningRate"][0].to(p.dtype)
    mu = attrs["mu"]
    v.mul_(mu).add_(g)               # v = mu * v + g
    if attrs.get("use_nesterov", False):
        p.sub_((g + mu * v) * lr)
    else:
        p.sub_(lr * v)
    return {"ParamOut": p, "VelocityOut": v}


register_op(
    "momentum", ["Param", "Grad", "Velocity", "LearningRate"],
    ["ParamOut", "VelocityOut"],
    infer=_mirror_infer(("Param", "ParamOut"), ("Velocity", "VelocityOut")),
    compute=_momentum_compute, grad=None)


register_op(
    "adam",
    ["Param", "Grad", "LearningRate", "Moment1", "Moment2", "Beta1Pow",
     "Beta2Pow"],
    ["ParamOut", "Moment1Out", "Moment2Out"],
    infer=_mirror_infer(("Param", "ParamOut"), ("Moment1", "Moment1Out"),
                        ("Moment2", "Moment2Out")),
    compute=_adam_compute, grad=None)
