"""Operators on ``Variable`` (counterpart of
``paddle_tpu/layers/math_op_patch.py``): ``a + b``, ``a - 1.0``,
``2 * a``, ``a / b``, ``a ** b``, ``-a``, ``a < b`` and the other
orderings, and ``a.astype(dtype)``, each appending the ops the JAX patch
appends, so the programs serialize alike.  A Python number on the other
side becomes a ``scale`` op for ``+``, ``-`` (number on the right) and
``*``, and otherwise a ``fill_constant`` of shape [1] (or, when the
Variable's batch dim is -1, a ``fill_constant_batch_size_like`` of its
shape) that the elementwise op broadcasts.  ``==`` and ``hash`` stay
Python's: Variables are dict keys.  ``layers`` installs the patch when it
is imported, as the JAX package does."""

from ..core import dtype_name
from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = ["monkey_patch_variable"]


def _create_scalar_broadcast(block, value, ref_var):
    helper = LayerHelper("scalar")
    out = helper.create_variable_for_type_inference(dtype=ref_var.dtype)
    batched = bool(ref_var.shape) and ref_var.shape[0] == -1
    helper.append_op(
        type="fill_constant_batch_size_like" if batched else "fill_constant",
        inputs={"Input": [ref_var]} if batched else {},
        outputs={"Out": [out]},
        attrs={"shape": list(ref_var.shape) if batched else [1],
               "value": float(value), "dtype": dtype_name(ref_var.dtype)})
    return out


def _binary(op_type, reverse=False):
    def impl(self, other):
        from .ops import scale

        helper = LayerHelper(op_type)
        if isinstance(other, (int, float)):
            if op_type == "elementwise_add":
                return scale(self, scale=1.0, bias=float(other))
            if op_type == "elementwise_sub" and not reverse:
                return scale(self, scale=1.0, bias=-float(other))
            if op_type == "elementwise_mul":
                return scale(self, scale=float(other))
            other = _create_scalar_broadcast(self.block, other, self)
        x, y = (other, self) if reverse else (self, other)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": -1})
        return out

    return impl


def _astype(self, dtype):
    """This variable cast to ``dtype`` by a ``cast`` op."""
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type="cast", inputs={"X": [self]},
                     outputs={"Out": [out]},
                     attrs={"out_dtype": dtype_name(dtype)})
    return out


def _neg(self):
    from .ops import scale

    return scale(self, scale=-1.0)


def monkey_patch_variable():
    Variable.__add__ = _binary("elementwise_add")
    Variable.__radd__ = _binary("elementwise_add")
    Variable.__sub__ = _binary("elementwise_sub")
    Variable.__rsub__ = _binary("elementwise_sub", reverse=True)
    Variable.__mul__ = _binary("elementwise_mul")
    Variable.__rmul__ = _binary("elementwise_mul")
    Variable.__truediv__ = _binary("elementwise_div")
    Variable.__rtruediv__ = _binary("elementwise_div", reverse=True)
    Variable.__pow__ = _binary("elementwise_pow")
    Variable.__lt__ = _binary("less_than")
    Variable.__le__ = _binary("less_equal")
    Variable.__gt__ = _binary("greater_than")
    Variable.__ge__ = _binary("greater_equal")
    Variable.__neg__ = _neg
    Variable.astype = _astype
