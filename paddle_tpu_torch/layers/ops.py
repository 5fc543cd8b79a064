"""``scale`` and ``square`` (counterpart of ``paddle_tpu/layers/ops.py``;
the other activation layers come with the slices that use them)."""

from ..layer_helper import LayerHelper

__all__ = ["scale", "square"]


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"scale": float(scale), "bias": float(bias),
               "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def square(x, name=None):
    helper = LayerHelper("square", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="square", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out
