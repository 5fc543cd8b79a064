"""``reduce_{sum,mean,max,min,prod}``, ``arg_max`` / ``arg_min`` and
``cumsum`` (counterpart of ``paddle_tpu/ops/reduction.py``).

``reduce_max`` / ``reduce_min`` are ``torch.amax`` / ``torch.amin``,
whose gradient splits evenly over tied extremes as ``jnp.max``'s does
(``torch.max(dim)``'s would go to one of them).  ``reduce_prod``'s
gradient is exact at zeros (with one zero the product of the others
reaches it and the rest get 0, with two every entry gets 0) and reads
nothing on the host (``_ProdLast``).  ``arg_max``
and ``arg_min`` return the first index of a tie (a NaN counts as the
extreme, as in ``jnp.argmax``), as int64.  ``cumsum`` takes ``exclusive``
(shifted by one, 0 first) and ``reverse``; an integer sum keeps its
dtype.  On the card the scan sums in another order than on the host, so
its floats agree within rounding, not bit for bit."""

import torch

from ..registry import in_var, register_op, set_output


def _reduce_infer(op, block):
    x = in_var(op, block, "X")
    dims = op.attrs.get("dim", [0])
    keep = op.attrs.get("keep_dim", False)
    if op.attrs.get("reduce_all", False):
        out = (1,) if not keep else (1,) * len(x.shape)
    else:
        dims = [d % len(x.shape) for d in dims]
        if keep:
            out = tuple(1 if i in dims else s for i, s in enumerate(x.shape))
        else:
            out = tuple(s for i, s in enumerate(x.shape) if i not in dims)
            if not out:
                out = (1,)
    set_output(op, block, "Out", out, x.dtype)


def _make_reduce(name, fn):
    def compute(ins, attrs, ctx, op_index):
        x = ins["X"][0]
        keep = attrs.get("keep_dim", False)
        if attrs.get("reduce_all", False):
            out = fn(x)
            return {"Out": out.reshape((1,) * x.dim()) if keep
                    else out.reshape(1)}
        dims = tuple(d % x.dim() for d in attrs.get("dim", [0]))
        out = fn(x, dim=dims, keepdim=keep)
        return {"Out": out.reshape(1) if out.dim() == 0 else out}

    register_op(name, ["X"], ["Out"], infer=_reduce_infer, compute=compute)


class _ProdLast(torch.autograd.Function):
    """``x.prod(-1)`` whose gradient reads nothing on the host: each
    entry's cotangent times the product of the others, as the exclusive
    products from the left and from the right (exact at zeros).
    ``torch.prod``'s own backward counts the zeros on the host, which a
    CUDA graph cannot capture."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.prod(-1)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        ones = torch.ones_like(x[..., :1])
        left = torch.cat([ones, torch.cumprod(x[..., :-1], -1)], -1)
        right = torch.cat([ones, torch.cumprod(x.flip(-1)[..., :-1], -1)],
                          -1).flip(-1)
        return g.unsqueeze(-1) * left * right


def _prod(x, dim=None, keepdim=False):
    """``jnp.prod`` over ``dim`` (a tuple; None: every dim)."""
    if dim is None:
        return _ProdLast.apply(x.reshape(-1))
    rest = [d for d in range(x.dim()) if d not in dim]
    out = _ProdLast.apply(x.permute(*rest, *dim).reshape(
        [x.shape[d] for d in rest] + [-1]))
    if keepdim:
        out = out.reshape([1 if d in dim else s
                           for d, s in enumerate(x.shape)])
    return out


_make_reduce("reduce_sum", torch.sum)
_make_reduce("reduce_mean", torch.mean)
_make_reduce("reduce_max", torch.amax)
_make_reduce("reduce_min", torch.amin)
_make_reduce("reduce_prod", _prod)


def _arg_infer(op, block):
    x = in_var(op, block, "X")
    axis = op.attrs.get("axis", 0) % len(x.shape)
    out = tuple(s for i, s in enumerate(x.shape) if i != axis)
    set_output(op, block, "Out", out or (1,), "int64")


def _make_arg(name, fn):
    register_op(name, ["X"], ["Out"], infer=_arg_infer,
                compute=lambda ins, attrs, ctx, op_index: {
                    "Out": fn(ins["X"][0], dim=attrs.get("axis", 0))},
                grad=None)


_make_arg("arg_max", torch.argmax)
_make_arg("arg_min", torch.argmin)


def _cumsum_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    axis = attrs.get("axis", -1) % x.dim()
    if attrs.get("reverse", False):
        x = torch.flip(x, dims=(axis,))
    out = torch.cumsum(x, dim=axis, dtype=x.dtype)
    if attrs.get("exclusive", False):
        out = torch.cat([torch.zeros_like(out.narrow(axis, 0, 1)),
                         out.narrow(axis, 0, x.shape[axis] - 1)], dim=axis)
    if attrs.get("reverse", False):
        out = torch.flip(out, dims=(axis,))
    return {"Out": out}


register_op(
    "cumsum", ["X"], ["Out"],
    infer=lambda op, block: set_output(
        op, block, "Out", in_var(op, block, "X").shape,
        in_var(op, block, "X").dtype),
    compute=_cumsum_compute)
