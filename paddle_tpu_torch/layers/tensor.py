"""Tensor creation and manipulation layers (counterpart of
``paddle_tpu/layers/tensor.py``, every name of its ``__all__``): each
appends the op of the same name, with the JAX layer's attrs, so the
programs serialize alike."""

import numpy as np

from ..core import dtype_name
from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = [
    "create_tensor", "create_global_var", "cast", "concat", "sums",
    "assign", "fill_constant", "fill_constant_batch_size_like", "argmin",
    "argmax", "argsort", "ones", "zeros", "reverse", "reshape", "squeeze",
    "unsqueeze", "transpose", "split", "stack", "expand", "slice", "shape",
    "reduce_sum", "reduce_mean", "reduce_max", "reduce_min", "reduce_prod",
    "gather", "scatter", "pad", "pad2d", "pad_constant_like", "crop",
    "random_crop", "unstack", "uniform_random_batch_size_like",
    "gaussian_random_batch_size_like", "cumsum", "increment", "isfinite",
    "has_inf", "has_nan", "create_parameter", "less_than", "equal",
    "less_equal", "greater_than", "greater_equal", "not_equal",
    "logical_and", "logical_or", "logical_xor", "logical_not",
]


def reshape(x, shape, act=None, name=None):
    helper = LayerHelper("reshape", name=name, act=act)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="reshape", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"shape": list(shape)})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="transpose", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": list(perm)})
    return out


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="squeeze", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axes": list(axes)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="unsqueeze", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axes": list(axes)})
    return out


def _reduce_layer(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype=input.dtype)
        if dim is None:
            attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
        else:
            attrs = {"dim": [dim] if isinstance(dim, int) else list(dim),
                     "keep_dim": keep_dim, "reduce_all": False}
        helper.append_op(type=op_type, inputs={"X": [input]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    layer.__name__ = op_type
    return layer


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")
reduce_prod = _reduce_layer("reduce_prod")


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"out_dtype": dtype_name(dtype)})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    helper.append_op(type="concat", inputs={"X": input},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


def sums(input, out=None):
    """The elementwise sum of the Variables in ``input`` (a ``sum`` op)."""
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": [out]})
    return out


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype_name(dtype),
                            "value": float(value)})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    """A ``value``-filled tensor of ``shape`` whose dim ``output_dim_idx``
    is ``input``'s dim ``input_dim_idx`` at run time."""
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype_name(dtype),
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    out.stop_gradient = True
    return out


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_global_variable(
        name=helper.name + ".tensor", dtype=dtype, persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A bare learnable parameter, for hand-built operator graphs."""
    from ..param_attr import ParamAttr

    helper = LayerHelper("create_parameter")
    if attr is None:
        attr = ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    from ..initializer import ConstantInitializer

    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        name=name or helper.name, shape=shape, dtype=dtype,
        persistable=persistable)
    helper.set_variable_initializer(var, ConstantInitializer(value))
    return var


def assign(input, output=None):
    """``output`` = ``input`` (a Variable: an ``assign`` op; a numpy array:
    an ``assign_value`` op holding its values)."""
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=input.dtype)
        helper.append_op(type="assign", inputs={"X": [input]},
                         outputs={"Out": [output]})
    elif isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=str(input.dtype))
        helper.append_op(type="assign_value", outputs={"Out": [output]},
                         attrs={"shape": list(input.shape),
                                "dtype": str(input.dtype),
                                "values": input.reshape(-1).tolist()})
    else:
        raise TypeError("assign accepts Variable or numpy array")
    return output


def _arg_layer(op_type):
    def layer(x, axis=0):
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(dtype="int64")
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        return out

    return layer


argmin = _arg_layer("arg_min")
argmax = _arg_layer("arg_max")


def argsort(input, axis=-1, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    ids = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(type="argsort", inputs={"X": [input]},
                     outputs={"Out": [out], "Indices": [ids]},
                     attrs={"axis": axis})
    return out, ids


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=0.0)


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="reverse", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"axis": [axis] if isinstance(axis, int)
                            else axis})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        num, sections = num_or_sections, []
    else:
        num, sections = len(num_or_sections), list(num_or_sections)
    outs = [helper.create_variable_for_type_inference(dtype=input.dtype)
            for _ in range(num)]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs},
                     attrs={"axis": dim, "sections": sections, "num": num})
    return outs


def stack(x, axis=0):
    if not isinstance(x, (list, tuple)):
        x = [x]
    helper = LayerHelper("stack")
    out = helper.create_variable_for_type_inference(dtype=x[0].dtype)
    helper.append_op(type="stack", inputs={"X": x}, outputs={"Y": [out]},
                     attrs={"axis": axis})
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="expand", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"expand_times": list(expand_times)})
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(type="shape", inputs={"Input": [input]},
                     outputs={"Out": [out]})
    return out


def gather(input, index):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def scatter(input, index, updates, overwrite=True, name=None):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="scatter",
                     inputs={"X": [input], "Ids": [index],
                             "Updates": [updates]},
                     outputs={"Out": [out]}, attrs={"overwrite": overwrite})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="pad", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"paddings": list(paddings),
                            "pad_value": float(pad_value)})
    return out


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    """Pad images [top, bottom, left, right] in constant, reflect or edge
    mode."""
    helper = LayerHelper("pad2d", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="pad2d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"paddings": list(paddings), "mode": mode,
                            "pad_value": float(pad_value),
                            "data_format": data_format})
    return out


def pad_constant_like(x, y, pad_value=0.0, name=None):
    """``y`` padded at the end of each dim up to the shape of ``x``."""
    helper = LayerHelper("pad_constant_like", name=name)
    out = helper.create_variable_for_type_inference(dtype=y.dtype)
    helper.append_op(type="pad_constant_like", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"pad_value": float(pad_value)})
    return out


def crop(x, shape=None, offsets=None, name=None):
    """``x`` cropped to ``shape`` at ``offsets`` (lists, or Variables read
    at run time)."""
    helper = LayerHelper("crop", name=name)
    inputs, attrs = {"X": [x]}, {}
    if isinstance(shape, Variable):
        inputs["Y"] = [shape]
    elif shape is not None:
        attrs["shape"] = list(shape)
    if isinstance(offsets, Variable):
        inputs["Offsets"] = [offsets]
    elif offsets is not None:
        attrs["offsets"] = list(offsets)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="crop", inputs=inputs, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def random_crop(x, shape, seed=None):
    """Each instance cropped to ``shape`` at random offsets; ``seed`` is
    kept for the API (the executor's generator draws)."""
    helper = LayerHelper("random_crop")
    inputs = {"X": [x]}
    outputs = {"Out": [helper.create_variable_for_type_inference(x.dtype)]}
    if isinstance(seed, Variable):
        inputs["Seed"] = [seed]
        outputs["SeedOut"] = [
            helper.create_variable_for_type_inference("int64")]
    helper.append_op(type="random_crop", inputs=inputs, outputs=outputs,
                     attrs={"shape": list(shape),
                            "startup_seed": seed if isinstance(seed, int)
                            else 0})
    return outputs["Out"][0]


def unstack(x, axis=0, num=None):
    """``x`` split into its ``num`` slices along ``axis``."""
    helper = LayerHelper("unstack")
    if num is None:
        num = x.shape[axis]
    if num is None or num < 0:
        raise ValueError("unstack: dim %d of %r is dynamic; pass num= "
                         "explicitly" % (axis, x.name))
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(num)]
    helper.append_op(type="unstack", inputs={"X": [x]}, outputs={"Y": outs},
                     attrs={"axis": axis, "num": num})
    return outs


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    """A uniform random tensor whose batch dim is ``input``'s."""
    helper = LayerHelper("uniform_random_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="uniform_random_batch_size_like", inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx, "min": float(min),
               "max": float(max), "seed": seed, "dtype": dtype})
    return out


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    """A normal random tensor whose batch dim is ``input``'s."""
    helper = LayerHelper("gaussian_random_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="gaussian_random_batch_size_like", inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx, "mean": float(mean),
               "std": float(std), "seed": seed, "dtype": dtype})
    return out


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    helper = LayerHelper("cumsum")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="cumsum", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"axis": axis, "exclusive": exclusive,
                            "reverse": reverse})
    return out


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        dtype=x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def _check_layer(op_type):
    def layer(x):
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(dtype="bool")
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]})
        return out

    layer.__name__ = op_type
    return layer


isfinite = _check_layer("isfinite")
has_inf = _check_layer("has_inf")
has_nan = _check_layer("has_nan")


def _cmp_layer(op_type):
    def layer(x, y, cond=None):
        helper = LayerHelper(op_type)
        if cond is None:
            cond = helper.create_variable_for_type_inference(dtype="bool")
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [cond]})
        return cond

    layer.__name__ = op_type
    return layer


less_than = _cmp_layer("less_than")
equal = _cmp_layer("equal")
less_equal = _cmp_layer("less_equal")
greater_than = _cmp_layer("greater_than")
greater_equal = _cmp_layer("greater_equal")
not_equal = _cmp_layer("not_equal")


def _logical_layer(op_type, binary=True):
    def layer(x, y=None, out=None, name=None):
        helper = LayerHelper(op_type, name=name)
        if out is None:
            out = helper.create_variable_for_type_inference(dtype="bool")
        inputs = {"X": [x], "Y": [y]} if binary else {"X": [x]}
        helper.append_op(type=op_type, inputs=inputs, outputs={"Out": [out]})
        return out

    layer.__name__ = op_type
    return layer


logical_and = _logical_layer("logical_and")
logical_or = _logical_layer("logical_or")
logical_xor = _logical_layer("logical_xor")
logical_not = _logical_layer("logical_not", binary=False)
