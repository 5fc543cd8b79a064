"""The unary activation layers, generated from one list as the JAX
package's are, and ``scale`` (counterpart of ``paddle_tpu/layers/ops.py``).
Each appends its op with the keyword attrs it is given.  ``relu`` and
``log``, which the JAX package writes out in ``layers/nn.py``, are
generated here too."""

from ..layer_helper import LayerHelper

_ACT_OPS = [
    "sigmoid", "logsigmoid", "exp", "tanh", "tanh_shrink", "softshrink",
    "sqrt", "rsqrt", "abs", "ceil", "floor", "cos", "sin", "round",
    "reciprocal", "square", "softplus", "softsign", "brelu", "leaky_relu",
    "soft_relu", "elu", "relu6", "pow", "stanh", "hard_sigmoid", "swish",
    "gelu", "thresholded_relu", "hard_shrink", "log_softmax",
]

__all__ = list(_ACT_OPS) + ["relu", "log", "scale"]


def _make(op_type):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    layer.__name__ = op_type
    layer.__doc__ = "%s activation" % op_type
    return layer


for _op in _ACT_OPS + ["relu", "log"]:
    globals()[_op] = _make(_op)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"scale": float(scale), "bias": float(bias),
               "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)
