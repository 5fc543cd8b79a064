"""``reduce_sum`` and ``reduce_mean`` (counterpart of
``paddle_tpu/ops/reduction.py``; the other reductions come with the slices
that use them)."""

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


_make_reduce("reduce_sum", torch.sum)
_make_reduce("reduce_mean", torch.mean)
