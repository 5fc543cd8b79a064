"""In-graph learning-rate schedules (counterpart of
``paddle_tpu/layers/learning_rate_scheduler.py``): a schedule is ops over
a persistable step counter, advanced once per step, so the learning rate
updates inside the same ``Executor.run`` as the step.  Ported:
``noam_decay``; the other schedules wait (ROADMAP Queue A)."""

from ..layer_helper import LayerHelper

__all__ = ["noam_decay"]


def _decay_step_counter(begin=0):
    # one counter per `begin` value: schedules with different origins
    # (noam starts at 1) must not share a var
    from .nn import autoincreased_step_counter
    counter_name = "@LR_DECAY_COUNTER@" if begin == 0 else \
        "@LR_DECAY_COUNTER@begin=%d" % begin
    return autoincreased_step_counter(counter_name, begin=begin, step=1,
                                      dtype="float32")


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
