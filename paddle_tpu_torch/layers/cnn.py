"""CNN layers ``conv2d`` / ``conv3d``, ``conv2d_transpose`` /
``conv3d_transpose``, ``pool2d`` / ``pool3d``, ``batch_norm``,
``layer_norm``, ``group_norm``, ``lrn`` and ``image_resize`` /
``resize_bilinear`` (counterpart of ``paddle_tpu/layers/cnn.py``): NCHW
activations, OIHW filters with the MSRA-style default Normal(0, sqrt(2 /
fan_in)), the same ops and attrs as the JAX package, so the programs
serialize alike."""

from ..framework import Variable
from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from ..registry import int_list as _pair

__all__ = ["conv2d", "conv3d", "conv2d_transpose", "conv3d_transpose",
           "pool2d", "pool3d", "batch_norm", "layer_norm", "group_norm",
           "lrn", "image_resize", "resize_bilinear"]


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


def _conv_nd(nd, op_type, input, num_filters, filter_size, stride, padding,
             dilation, groups, param_attr, bias_attr, use_cudnn, act, name):
    helper = LayerHelper(op_type, input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    num_channels = input.shape[1]
    groups = groups or 1
    if num_channels is not None and num_channels > 0 and \
            num_channels % groups != 0:
        raise ValueError("num_channels must be divisible by groups")
    filter_size = _pair(filter_size, nd)
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
        attrs={"strides": _pair(stride, nd), "paddings": _pair(padding, nd),
               "dilations": _pair(dilation, nd), "groups": groups,
               "use_cudnn": use_cudnn})
    if helper.bias_attr is not None and \
            helper.kwargs.get("bias_attr") is not False:
        pre_bias = _channel_bias(helper, pre_bias)
    return helper.append_activation(pre_bias)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    op_type = "depthwise_conv2d" if (
        groups and input.shape[1] == groups and groups == num_filters
    ) else "conv2d"
    return _conv_nd(2, op_type, input, num_filters, filter_size, stride,
                    padding, dilation, groups, param_attr, bias_attr,
                    use_cudnn, act, name)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    return _conv_nd(3, "conv3d", input, num_filters, filter_size, stride,
                    padding, dilation, groups, param_attr, bias_attr,
                    use_cudnn, act, name)


def _conv_transpose_nd(nd, op_type, input, num_filters, output_size,
                       filter_size, padding, stride, dilation, groups,
                       param_attr, bias_attr, use_cudnn, act, name):
    """A transposed convolution; with no ``filter_size`` the filter is
    sized so the output is ``output_size``."""
    helper = LayerHelper(op_type, input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    groups = groups or 1
    stride = _pair(stride, nd)
    padding = _pair(padding, nd)
    dilation = _pair(dilation, nd)
    if filter_size is None:
        if output_size is None:
            raise ValueError("output_size or filter_size must be set")
        output_size = _pair(output_size, nd)
        filter_size = [(output_size[i] - (input.shape[2 + i] - 1) * stride[i]
                        + 2 * padding[i] - 1) // dilation[i] + 1
                       for i in range(nd)]
    else:
        filter_size = _pair(filter_size, nd)
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[input.shape[1], num_filters // groups] + filter_size,
        dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type=op_type, inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": stride, "paddings": padding,
               "dilations": dilation, "groups": groups,
               "use_cudnn": use_cudnn})
    if helper.bias_attr is not None and \
            helper.kwargs.get("bias_attr") is not False:
        pre_bias = _channel_bias(helper, pre_bias)
    return helper.append_activation(pre_bias)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    return _conv_transpose_nd(2, "conv2d_transpose", input, num_filters,
                              output_size, filter_size, padding, stride,
                              dilation, groups, param_attr, bias_attr,
                              use_cudnn, act, name)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    return _conv_transpose_nd(3, "conv3d_transpose", input, num_filters,
                              output_size, filter_size, padding, stride,
                              dilation, groups, param_attr, bias_attr,
                              use_cudnn, act, name)


def _pool_nd(nd, input, pool_size, pool_type, pool_stride, pool_padding,
             global_pooling, use_cudnn, ceil_mode, exclusive, name):
    if pool_type not in ("max", "avg"):
        raise ValueError("pool_type must be 'max' or 'avg'")
    op_type = "pool%dd" % nd
    helper = LayerHelper(op_type, input=input, name=name)
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op(
        type=op_type, inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": _pair(pool_size, nd),
               "global_pooling": global_pooling,
               "strides": _pair(pool_stride, nd),
               "paddings": _pair(pool_padding, nd), "use_cudnn": use_cudnn,
               "ceil_mode": ceil_mode, "exclusive": exclusive})
    return out


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None):
    return _pool_nd(2, input, pool_size, pool_type, pool_stride, pool_padding,
                    global_pooling, use_cudnn, ceil_mode, exclusive, name)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None):
    return _pool_nd(3, input, pool_size, pool_type, pool_stride, pool_padding,
                    global_pooling, use_cudnn, ceil_mode, exclusive, name)


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


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    helper = LayerHelper("group_norm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(
        attr=helper.param_attr, shape=[c], dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(attr=helper.bias_attr, shape=[c],
                                   dtype=dtype, is_bias=True)
    mean_out = helper.create_variable_for_type_inference(dtype)
    var_out = helper.create_variable_for_type_inference(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="group_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias]},
        outputs={"Y": [out], "Mean": [mean_out], "Variance": [var_out]},
        attrs={"epsilon": epsilon, "groups": groups,
               "data_layout": data_layout})
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


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR"):
    """Resize NCHW ``input`` to ``out_shape`` (h, w) or by ``scale``
    (``bilinear_interp`` / ``nearest_interp``, align corners)."""
    ops = {"BILINEAR": "bilinear_interp", "NEAREST": "nearest_interp"}
    if resample not in ops:
        raise ValueError("resample must be BILINEAR or NEAREST")
    if out_shape is None and scale is None:
        raise ValueError("one of out_shape and scale must be set")
    if out_shape is not None:
        if isinstance(out_shape, Variable):
            raise NotImplementedError(
                "a dynamic out_shape is not supported (as in the JAX "
                "package); pass a static (h, w)")
        out_h, out_w = int(out_shape[0]), int(out_shape[1])
    else:
        out_h, out_w = int(input.shape[2] * scale), int(input.shape[3] * scale)
    helper = LayerHelper("image_resize", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type=ops[resample], inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"out_h": out_h, "out_w": out_w})
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None):
    return image_resize(input, out_shape, scale, name, "BILINEAR")
