"""In-graph learning-rate schedules (counterpart of
``paddle_tpu/layers/learning_rate_scheduler.py``): a schedule is ops over
a persistable step counter, advanced once per step, so the learning rate
updates inside the same ``Executor.run`` as the step (and inside its CUDA
graph).  ``exponential_decay``, ``natural_exp_decay``,
``inverse_time_decay`` (each with ``staircase``), ``polynomial_decay``
(with ``cycle``), ``piecewise_decay``, ``noam_decay``, and
``append_LARS``, the layer-wise rate written into each parameter's
``optimize_attr``; the same ops with the same attrs as the JAX package."""

import math

from ..layer_helper import LayerHelper

__all__ = [
    "exponential_decay",
    "natural_exp_decay",
    "inverse_time_decay",
    "polynomial_decay",
    "piecewise_decay",
    "noam_decay",
    "append_LARS",
]


def _decay_step_counter(begin=0):
    # one counter per `begin` value: schedules with different origins
    # (noam starts at 1) must not share a var
    from .nn import autoincreased_step_counter
    counter_name = "@LR_DECAY_COUNTER@" if begin == 0 else \
        "@LR_DECAY_COUNTER@begin=%d" % begin
    return autoincreased_step_counter(counter_name, begin=begin, step=1,
                                      dtype="float32")


def _scalar(helper, value, like):
    out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(
        type="fill_constant", outputs={"Out": [out]},
        attrs={"shape": [1], "value": float(value), "dtype": "float32",
               "force_cpu": False})
    out.stop_gradient = True
    return out


def _binary(helper, op_type, x, y):
    out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": -1})
    out.stop_gradient = True
    return out


def _unary(helper, op_type, x, **attrs):
    out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(type=op_type, inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs=attrs)
    out.stop_gradient = True
    return out


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * decay_rate ^ (step / decay_steps)"""
    helper = LayerHelper("exponential_decay")
    step = _decay_step_counter()
    div = _unary(helper, "scale", step, scale=1.0 / decay_steps, bias=0.0,
                 bias_after_scale=True)
    if staircase:
        div = _unary(helper, "floor", div)
    # rate^x = exp(x * ln rate)
    expo = _unary(helper, "scale", div, scale=math.log(decay_rate), bias=0.0,
                  bias_after_scale=True)
    factor = _unary(helper, "exp", expo)
    return _unary(helper, "scale", factor, scale=float(learning_rate),
                  bias=0.0, bias_after_scale=True)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * exp(-decay_rate * step / decay_steps)"""
    helper = LayerHelper("natural_exp_decay")
    step = _decay_step_counter()
    div = _unary(helper, "scale", step, scale=1.0 / decay_steps, bias=0.0,
                 bias_after_scale=True)
    if staircase:
        div = _unary(helper, "floor", div)
    expo = _unary(helper, "scale", div, scale=-float(decay_rate), bias=0.0,
                  bias_after_scale=True)
    factor = _unary(helper, "exp", expo)
    return _unary(helper, "scale", factor, scale=float(learning_rate),
                  bias=0.0, bias_after_scale=True)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + decay_rate * step / decay_steps)"""
    helper = LayerHelper("inverse_time_decay")
    step = _decay_step_counter()
    div = _unary(helper, "scale", step, scale=1.0 / decay_steps, bias=0.0,
                 bias_after_scale=True)
    if staircase:
        div = _unary(helper, "floor", div)
    denom = _unary(helper, "scale", div, scale=float(decay_rate), bias=1.0,
                   bias_after_scale=True)
    recip = _unary(helper, "reciprocal", denom)
    return _unary(helper, "scale", recip, scale=float(learning_rate),
                  bias=0.0, bias_after_scale=True)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    """(lr - end_lr) * (1 - min(step, decay_steps)/decay_steps)^power + end_lr
    (cycle=True restarts with a growing decay_steps)"""
    helper = LayerHelper("polynomial_decay")
    step = _decay_step_counter()
    if cycle:
        ratio = _unary(helper, "scale", step, scale=1.0 / decay_steps,
                       bias=0.0, bias_after_scale=True)
        ceilv = _unary(helper, "ceil", ratio)
        # ensure at least one period after step 0: max(ceil(ratio), 1)
        one = _scalar(helper, 1.0, step)
        ceilv = _binary(helper, "elementwise_max", ceilv, one)
        cur_decay = _unary(helper, "scale", ceilv, scale=float(decay_steps),
                           bias=0.0, bias_after_scale=True)
        frac = _binary(helper, "elementwise_div", step, cur_decay)
    else:
        cap = _scalar(helper, float(decay_steps), step)
        capped = _binary(helper, "elementwise_min", step, cap)
        frac = _unary(helper, "scale", capped, scale=1.0 / decay_steps,
                      bias=0.0, bias_after_scale=True)
    base = _unary(helper, "scale", frac, scale=-1.0, bias=1.0,
                  bias_after_scale=True)
    # clamp: float rounding can push 1 - step/decay_steps a hair below 0,
    # and power of a negative base is NaN
    base = _unary(helper, "clip", base, min=0.0, max=1.0)
    powed = _binary(helper, "elementwise_pow", base,
                    _scalar(helper, float(power), step))
    return _unary(helper, "scale", powed,
                  scale=float(learning_rate) - float(end_learning_rate),
                  bias=float(end_learning_rate), bias_after_scale=True)


def piecewise_decay(boundaries, values):
    """Step-function schedule: ``values[i]`` while the step is below
    ``boundaries[i]``, ``values[-1]`` after the last."""
    if len(values) != len(boundaries) + 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    helper = LayerHelper("piecewise_decay")
    step = _decay_step_counter()
    out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(
        type="piecewise_lr", inputs={"Step": [step]},
        outputs={"Out": [out]},
        attrs={"boundaries": [float(b) for b in boundaries],
               "values": [float(v) for v in values]})
    out.stop_gradient = True
    return out


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    """learning_rate * d_model^-0.5 * min(step^-0.5, step *
    warmup^-1.5), the Transformer's schedule."""
    helper = LayerHelper("noam_decay")
    step = _decay_step_counter(begin=1)
    a = _unary(helper, "rsqrt", step)
    b = _unary(helper, "scale", step, scale=float(warmup_steps) ** -1.5,
               bias=0.0, bias_after_scale=True)
    m = _binary(helper, "elementwise_min", a, b)
    return _unary(helper, "scale", m,
                  scale=float(learning_rate) * float(d_model) ** -0.5,
                  bias=0.0, bias_after_scale=True)


def append_LARS(params_grads, learning_rate, weight_decay):
    """Layer-wise adaptive rate scaling: per-parameter
    ``lr * ||w|| / (||g|| + wd * ||w||)``, written into each parameter's
    ``optimize_attr['learning_rate']`` so the optimizer's per-param LR
    multiplier picks it up.  ``learning_rate`` may be a Variable or a
    plain float (materialized as a constant)."""
    from ..framework import Variable
    helper = LayerHelper("lars")
    if not isinstance(learning_rate, Variable):
        learning_rate = _scalar(helper, float(learning_rate), None)

    def _balanced_weight(param_norm, grad_norm):
        if weight_decay == 1.0:
            return _binary(helper, "elementwise_add", grad_norm, param_norm)
        scaled = _unary(helper, "scale", param_norm,
                        scale=float(weight_decay), bias=0.0,
                        bias_after_scale=True)
        return _binary(helper, "elementwise_add", grad_norm, scaled)

    decayed = []
    for param, grad in params_grads:
        if grad is None:
            decayed.append(None)
            continue
        param_lr = param.optimize_attr.get("learning_rate", 1.0)
        p_norm = _unary(helper, "sqrt",
                        _unary(helper, "reduce_sum",
                               _unary(helper, "square", param),
                               reduce_all=True))
        g_norm = _unary(helper, "sqrt",
                        _unary(helper, "reduce_sum",
                               _unary(helper, "square", grad),
                               reduce_all=True))
        num = _binary(helper, "elementwise_mul", learning_rate, p_norm)
        if not (isinstance(param_lr, float) and param_lr == 1.0):
            num = _unary(helper, "scale", num, scale=float(param_lr),
                         bias=0.0, bias_after_scale=True)
        decayed_lr = _binary(helper, "elementwise_div", num,
                             _balanced_weight(p_norm, g_norm))
        param.optimize_attr["learning_rate"] = decayed_lr
        decayed.append(decayed_lr)
    return decayed
