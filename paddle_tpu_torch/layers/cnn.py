"""CNN layers ``conv2d``, ``pool2d``, ``batch_norm``, ``layer_norm`` and
``lrn``
(counterpart of ``paddle_tpu/layers/cnn.py``): NCHW activations, OIHW
filters with the MSRA-style default Normal(0, sqrt(2 / fan_in)), the same
ops and attrs as the JAX package, so the programs serialize alike."""

from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from ..registry import int_list as _pair

__all__ = ["conv2d", "pool2d", "batch_norm", "layer_norm", "lrn"]


def _channel_bias(helper, input_var):
    """Per-output-channel bias on axis 1 (NCHW)."""
    b = helper.create_parameter(attr=helper.bias_attr,
                                shape=[input_var.shape[1]],
                                dtype=input_var.dtype, is_bias=True)
    tmp = helper.create_variable_for_type_inference(dtype=input_var.dtype)
    helper.append_op(type="elementwise_add",
                     inputs={"X": [input_var], "Y": [b]},
                     outputs={"Out": [tmp]}, attrs={"axis": 1})
    return tmp


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    op_type = "depthwise_conv2d" if (
        groups and input.shape[1] == groups and groups == num_filters
    ) else "conv2d"
    helper = LayerHelper(op_type, input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    num_channels = input.shape[1]
    groups = groups or 1
    if num_channels is not None and num_channels > 0 and \
            num_channels % groups != 0:
        raise ValueError("num_channels must be divisible by groups")
    filter_size = _pair(filter_size, 2)
    fan_in = num_channels // groups
    for k in filter_size:
        fan_in *= k
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[num_filters, num_channels // groups] + filter_size,
        dtype=dtype,
        default_initializer=NormalInitializer(0.0, (2.0 / fan_in) ** 0.5))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type=op_type, inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": _pair(stride, 2), "paddings": _pair(padding, 2),
               "dilations": _pair(dilation, 2), "groups": groups,
               "use_cudnn": use_cudnn})
    if helper.bias_attr is not None and \
            helper.kwargs.get("bias_attr") is not False:
        pre_bias = _channel_bias(helper, pre_bias)
    return helper.append_activation(pre_bias)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None):
    if pool_type not in ("max", "avg"):
        raise ValueError("pool_type must be 'max' or 'avg'")
    helper = LayerHelper("pool2d", input=input, name=name)
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op(
        type="pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": _pair(pool_size, 2),
               "global_pooling": global_pooling,
               "strides": _pair(pool_stride, 2),
               "paddings": _pair(pool_padding, 2), "use_cudnn": use_cudnn,
               "ceil_mode": ceil_mode, "exclusive": exclusive})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False, fuse_with_relu=False,
               use_global_stats=False):
    """Batch norm with scale/bias parameters and running mean/variance.
    MeanOut/VarianceOut are written under the running stats' own names,
    so each run updates them in the scope.  ``in_place`` is accepted and
    never aliases (as in the JAX package)."""
    helper = LayerHelper("batch_norm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(
        attr=helper.param_attr, shape=[c], dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(attr=helper.bias_attr, shape=[c],
                                   dtype=dtype, is_bias=True)
    mean = helper.create_parameter(
        attr=ParamAttr(name=moving_mean_name,
                       initializer=ConstantInitializer(0.0), trainable=False),
        shape=[c], dtype=dtype)
    variance = helper.create_parameter(
        attr=ParamAttr(name=moving_variance_name,
                       initializer=ConstantInitializer(1.0), trainable=False),
        shape=[c], dtype=dtype)
    mean.stop_gradient = True
    variance.stop_gradient = True
    saved_mean = helper.create_variable_for_type_inference(dtype)
    saved_variance = helper.create_variable_for_type_inference(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean],
                 "SavedVariance": [saved_variance]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    param_shape = [1]
    for s in input.shape[begin_norm_axis:]:
        param_shape[0] *= s
    inputs = {"X": [input]}
    if scale:
        inputs["Scale"] = [helper.create_parameter(
            attr=helper.param_attr, shape=param_shape, dtype=dtype,
            default_initializer=ConstantInitializer(1.0))]
    if shift:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=param_shape, dtype=dtype,
            is_bias=True)]
    mean_out = helper.create_variable_for_type_inference(dtype)
    var_out = helper.create_variable_for_type_inference(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="layer_norm", inputs=inputs,
        outputs={"Y": [out], "Mean": [mean_out], "Variance": [var_out]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis},
    )
    return helper.append_activation(out)


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    """Local response norm across channels (``ops/norm.py``)."""
    helper = LayerHelper("lrn", input=input, name=name)
    dtype = helper.input_dtype()
    mid = helper.create_variable_for_type_inference(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="lrn", inputs={"X": [input]},
        outputs={"Out": [out], "MidOut": [mid]},
        attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out
