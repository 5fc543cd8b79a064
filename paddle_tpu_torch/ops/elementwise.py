"""``elementwise_{add,sub,mul,div,max,min,pow,mod,floordiv}`` with
Fluid's axis-broadcast semantics, the comparisons and the logical ops
(counterpart of ``paddle_tpu/ops/elementwise.py``): a lower-rank Y aligns
against X starting at ``axis``, reproduced by right-padding Y with
singleton dims.  A SelectedRows X times a one-element Y (the global-norm
clip's scale) stays sparse; any other SelectedRows X is made dense first,
as in the JAX package.

``elementwise_mod`` and ``elementwise_floordiv`` are ``jnp.mod`` and
``jnp.floor_divide`` step for step: the result follows the divisor's
sign (Python's ``%`` and ``//``), a float floor division is
``round((x - fmod(x, y)) / y)`` less one where the remainder's sign is
not the divisor's, and an integer division by zero gives what XLA
defines (``x / 0 = -1`` and ``x rem 0 = x``, so ``x mod 0 = 0`` and
``x // 0 = -2`` for x > 0) instead of the host error of torch's integer
division; no integer is ever divided by zero, on either device.  Their
gradients are the JAX package's: the floor division's is zero, the
remainder's is 1 for X and ``-trunc(x / y)`` (plus 1 where the remainder
took the divisor's sign) for Y.

The six comparisons and the four logical ops broadcast X and Y as numpy
does (no ``axis``), output bool and have no gradient."""

import torch

from ..registry import broadcast_shapes, in_var, register_op, set_output
from .selected_rows import SelectedRows, map_values, to_dense


def _align_y(x, y, axis):
    if y.dim() == x.dim():
        return y
    if axis == -1 or axis is None:
        axis = x.dim() - y.dim()
    pad = x.dim() - axis - y.dim()
    if pad > 0:
        y = y.reshape(tuple(y.shape) + (1,) * pad)
    return y


def _ew_infer(op, block):
    x = in_var(op, block, "X")
    y = in_var(op, block, "Y")
    axis = op.attrs.get("axis", -1)
    ys = list(y.shape)
    if len(ys) < len(x.shape):
        a = axis if axis != -1 else len(x.shape) - len(ys)
        ys = [1] * a + ys + [1] * (len(x.shape) - a - len(ys))
    out = broadcast_shapes(tuple(x.shape), tuple(ys))
    set_output(op, block, "Out", out, x.dtype)


def _make_ew(name, fn):
    def compute(ins, attrs, ctx, op_index):
        x, y = ins["X"][0], ins["Y"][0]
        if isinstance(x, SelectedRows):
            # a uniform scale commutes with merging duplicate rows
            if name == "elementwise_mul" and y.numel() == 1:
                return {"Out": map_values(
                    x, lambda v: v * y.reshape(()).to(v.dtype))}
            x = to_dense(x)
        return {"Out": fn(x, _align_y(x, y, attrs.get("axis", -1)))}

    register_op(name, ["X", "Y"], ["Out"], infer=_ew_infer, compute=compute)


_make_ew("elementwise_add", torch.add)
_make_ew("elementwise_sub", torch.sub)
_make_ew("elementwise_mul", torch.mul)
_make_ew("elementwise_div", torch.div)
_make_ew("elementwise_max", torch.maximum)
_make_ew("elementwise_min", torch.minimum)
_make_ew("elementwise_pow", torch.pow)


def _int_rem_div(x, y):
    """XLA's truncating integer division and remainder, with ``x / 0 =
    -1`` and ``x rem 0 = x``."""
    zero = y == 0
    safe = torch.where(zero, torch.ones_like(y), y)
    q = torch.div(x, safe, rounding_mode="trunc")
    return (torch.where(zero, torch.full_like(q, -1), q),
            torch.where(zero, x, torch.fmod(x, safe)))


def _mod(x, y):
    """``jnp.mod``: the truncated remainder moved to the divisor's sign
    (an integer divisor of 0 counts as 1)."""
    x, y = torch.broadcast_tensors(*_promote(x, y))
    if x.is_floating_point():
        rem = torch.fmod(x, y)
    else:
        y = torch.where(y == 0, torch.ones_like(y), y)
        rem = torch.fmod(x, y)
    plus = ((rem < 0) != (y < 0)) & (rem != 0)
    return torch.where(plus, rem + y, rem)


def _floordiv(x, y):
    """``jnp.floor_divide``."""
    x, y = torch.broadcast_tensors(*_promote(x, y))
    if not x.is_floating_point():
        q, rem = _int_rem_div(x, y)
        low = (torch.sign(x) != torch.sign(y)) & (rem != 0)
        return torch.where(low, q - 1, q)
    # _float_divmod (CPython's float_divmod), rounded half away from zero
    # as lax.round
    rem = torch.fmod(x, y)
    div = (x - rem) / y
    low = (rem != 0) & (torch.sign(y) != torch.sign(rem))
    div = torch.where(low, div - 1, div)
    return torch.sign(div) * torch.floor(torch.abs(div) + 0.5)


def _promote(x, y):
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


_make_ew("elementwise_mod", _mod)
_make_ew("elementwise_floordiv", _floordiv)


def _cmp_infer(op, block):
    x, y = in_var(op, block, "X"), in_var(op, block, "Y")
    set_output(op, block, "Out",
               broadcast_shapes(tuple(x.shape), tuple(y.shape)), "bool")


def _make_cmp(name, fn):
    register_op(name, ["X", "Y"], ["Out"], infer=_cmp_infer,
                compute=lambda ins, attrs, ctx, op_index: {
                    "Out": fn(ins["X"][0], ins["Y"][0])},
                grad=None)


for _name, _fn in (("less_than", torch.lt), ("less_equal", torch.le),
                   ("greater_than", torch.gt),
                   ("greater_equal", torch.ge), ("equal", torch.eq),
                   ("not_equal", torch.ne), ("logical_and",
                                             torch.logical_and),
                   ("logical_or", torch.logical_or),
                   ("logical_xor", torch.logical_xor)):
    _make_cmp(_name, _fn)

register_op(
    "logical_not", ["X"], ["Out"],
    infer=lambda op, block: set_output(
        op, block, "Out", in_var(op, block, "X").shape, "bool"),
    compute=lambda ins, attrs, ctx, op_index: {
        "Out": torch.logical_not(ins["X"][0])},
    grad=None)
