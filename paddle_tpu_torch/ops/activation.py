"""Activation ops (counterpart of ``paddle_tpu/ops/activation.py``): the
JAX package's table of one-line activations, each with the same attrs and
defaults, then ``prelu``, ``softmax`` and ``log_softmax`` (over ``axis``,
the last by default) and ``maxout``.  Their gradients are the generic
``<type>_grad``: the forward rerun under autograd."""

import torch
import torch.nn.functional as F

from ..registry import in_var, register_op, same_shape_infer, set_output


def _softshrink(x, a):
    lam = a.get("lambda", 0.5)
    return torch.where(x > lam, x - lam,
                       torch.where(x < -lam, x + lam, torch.zeros_like(x)))


def _zero_where_not(cond, x):
    return torch.where(cond, x, torch.zeros_like(x))


_SIMPLE = {
    "relu": lambda x, a: torch.relu(x),
    "sigmoid": lambda x, a: torch.sigmoid(x),
    "logsigmoid": lambda x, a: F.logsigmoid(x),
    "tanh": lambda x, a: torch.tanh(x),
    "tanh_shrink": lambda x, a: x - torch.tanh(x),
    "exp": lambda x, a: torch.exp(x),
    "log": lambda x, a: torch.log(x),
    "sqrt": lambda x, a: torch.sqrt(x),
    "rsqrt": lambda x, a: torch.rsqrt(x),
    "abs": lambda x, a: torch.abs(x),
    "ceil": lambda x, a: torch.ceil(x),
    "floor": lambda x, a: torch.floor(x),
    # half to even, as jnp.round
    "round": lambda x, a: torch.round(x),
    "cos": lambda x, a: torch.cos(x),
    "sin": lambda x, a: torch.sin(x),
    "square": lambda x, a: x * x,
    "reciprocal": lambda x, a: 1.0 / x,
    # log(1 + e^x) without F.softplus's linear cut-off above 20
    "softplus": lambda x, a: torch.logaddexp(x, torch.zeros_like(x)),
    "softsign": lambda x, a: x / (1 + torch.abs(x)),
    "relu6": lambda x, a: torch.clamp(x, 0.0, a.get("threshold", 6.0)),
    "leaky_relu": lambda x, a: torch.where(x >= 0, x,
                                           a.get("alpha", 0.02) * x),
    "elu": lambda x, a: torch.where(
        x >= 0, x,
        a.get("alpha", 1.0) * (torch.exp(torch.clamp(x, max=0.0)) - 1)),
    "brelu": lambda x, a: torch.clamp(x, a.get("t_min", 0.0),
                                      a.get("t_max", 24.0)),
    "soft_relu": lambda x, a: torch.log(1 + torch.exp(torch.clamp(
        x, -a.get("threshold", 40.0), a.get("threshold", 40.0)))),
    "pow": lambda x, a: torch.pow(x, a.get("factor", 1.0)),
    "stanh": lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
        a.get("scale_a", 2.0 / 3.0) * x),
    "hard_sigmoid": lambda x, a: torch.clamp(
        a.get("slope", 0.2) * x + a.get("offset", 0.5), 0.0, 1.0),
    "swish": lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x),
    "gelu": lambda x, a: F.gelu(x),
    "thresholded_relu": lambda x, a: _zero_where_not(
        x > a.get("threshold", 1.0), x),
    "hard_shrink": lambda x, a: _zero_where_not(
        torch.abs(x) > a.get("threshold", 0.5), x),
    "softshrink": _softshrink,
}

for _name, _fn in _SIMPLE.items():
    register_op(
        _name, ["X"], ["Out"], infer=same_shape_infer("X", "Out"),
        compute=lambda ins, attrs, ctx, op_index, fn=_fn: {
            "Out": fn(ins["X"][0], attrs)},
    )


def _prelu_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "Out", x.shape, x.dtype)


def _prelu_compute(ins, attrs, ctx, op_index):
    x, alpha = ins["X"][0], ins["Alpha"][0]
    mode = attrs.get("mode", "all")
    if mode == "channel":
        a = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    elif mode == "element":
        a = alpha.reshape((1,) + tuple(x.shape[1:]))
    else:
        a = alpha.reshape(())
    return {"Out": torch.where(x >= 0, x, a * x)}


register_op("prelu", ["X", "Alpha"], ["Out"], infer=_prelu_infer,
            compute=_prelu_compute)

register_op("softmax", ["X"], ["Out"], infer=same_shape_infer("X", "Out"),
            compute=lambda ins, attrs, ctx, op_index: {
                "Out": torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))})

register_op("log_softmax", ["X"], ["Out"],
            infer=same_shape_infer("X", "Out"),
            compute=lambda ins, attrs, ctx, op_index: {
                "Out": torch.log_softmax(ins["X"][0],
                                         dim=attrs.get("axis", -1))})


def _maxout_infer(op, block):
    x = in_var(op, block, "X")
    groups = op.attrs["groups"]
    n, c = x.shape[0], x.shape[1]
    set_output(op, block, "Out", (n, c // groups) + tuple(x.shape[2:]),
               x.dtype)


def _maxout_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    g = attrs["groups"]
    n, c = x.shape[0], x.shape[1]
    x = x.reshape((n, c // g, g) + tuple(x.shape[2:]))
    return {"Out": torch.amax(x, dim=2)}


register_op("maxout", ["X"], ["Out"], infer=_maxout_infer,
            compute=_maxout_compute)
