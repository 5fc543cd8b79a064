"""Layer functions generated from the op registry (counterpart of
``paddle_tpu/layers/layer_function_generator.py``): a layer's inputs in
the op's slot order, its attrs as keywords, its docstring the op's
``OpDef.doc``."""

from ..layer_helper import LayerHelper
from ..registry import OPS

__all__ = ["deprecated", "generate_layer_fn", "generate_layer_fn_noattr",
           "autodoc", "templatedoc"]


def _op_doc(op_type):
    op = OPS.get(op_type)
    return (op.doc if op is not None and op.doc else
            "%s layer (generated from the op registry)" % op_type)


def deprecated(since, instead, extra_message=""):
    """A decorator that adds a deprecation notice to the docstring and
    warns at each call (``annotations.deprecated``)."""
    from ..annotations import deprecated as _deprecated

    return _deprecated(since, instead, extra_message)


def generate_layer_fn(op_type):
    """A layer for a registered op: tensor inputs by position in slot
    order (or by slot name), attrs as keywords, ``name`` and ``act`` as
    in every layer; returns the first output (after ``act``), or all of
    them when the op has several."""
    op = OPS.get(op_type)
    if op is None:
        raise ValueError("op %r is not registered" % op_type)
    in_slots = [s for s in op.input_slots if not s.startswith("GRAD::")]
    out_slots = [s for s in op.output_slots if not s.startswith("GRAD::")]

    def layer(*args, **kwargs):
        helper = LayerHelper(op_type, name=kwargs.pop("name", None),
                             act=kwargs.pop("act", None))
        inputs = {}
        for slot, arg in zip(in_slots, args):
            inputs[slot] = list(arg) if isinstance(arg, (list, tuple)) \
                else [arg]
        for slot in in_slots[len(args):]:
            if slot in kwargs:
                arg = kwargs.pop(slot)
                inputs[slot] = list(arg) if isinstance(arg, (list, tuple)) \
                    else [arg]
        # the outputs take the dtype of the first input that has one
        dtype = next((v.dtype for vs in inputs.values() for v in vs
                      if getattr(v, "dtype", None) is not None), None)
        outs = {s: [helper.create_variable_for_type_inference(dtype=dtype)]
                for s in out_slots}
        helper.append_op(type=op_type, inputs=inputs, outputs=outs,
                         attrs=kwargs)
        result = [outs[s][0] for s in out_slots]
        first = helper.append_activation(result[0])
        return first if len(result) == 1 else (first, *result[1:])

    layer.__name__ = op_type
    layer.__doc__ = _op_doc(op_type)
    return layer


def generate_layer_fn_noattr(op_type):
    """A one-input, one-output layer with no attrs (an activation's)."""
    def layer(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]})
        return out

    layer.__name__ = op_type
    layer.__doc__ = _op_doc(op_type)
    return layer


def autodoc(comment=""):
    """A decorator setting the docstring to ``comment`` and the doc of the
    op named like the function."""
    def decorator(func):
        func.__doc__ = comment + _op_doc(func.__name__)
        return func

    return decorator


def templatedoc(op_type=None):
    """A decorator filling ``${comment}`` in the docstring with the op's
    doc."""
    def decorator(func):
        func.__doc__ = (func.__doc__ or "").replace(
            "${comment}", _op_doc(op_type or func.__name__))
        return func

    return decorator
