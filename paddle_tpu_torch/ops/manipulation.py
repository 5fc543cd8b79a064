"""``reshape``, ``transpose``, ``unsqueeze`` and ``lookup_table``
(counterpart of ``paddle_tpu/ops/manipulation.py``).  ``transpose``
returns a strided view; consumers that need contiguous memory (the
kernels) make it so.  ``lookup_table``'s table gradient sums the rows of
repeated ids in a fixed order (``_Gather``), so that two runs of a step
give the same bits, as XLA's scatter-add does on the TPU."""

import torch

from ..registry import _auto_grad_maker, in_var, register_op, set_output


class _Gather(torch.autograd.Function):
    """``w.index_select(0, ids)`` whose backward accumulates with
    ``index_put_(accumulate=True)``: on the card a sort by id, then each
    id's rows summed in their order, where ``index_select``'s own backward
    (``index_add_``) adds them with atomics in whatever order they land."""

    @staticmethod
    def forward(ctx, w, ids):
        ctx.save_for_backward(ids)
        ctx.rows = w.shape[0]
        return w.index_select(0, ids)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        dw = grad.new_zeros((ctx.rows,) + tuple(grad.shape[1:]))
        return dw.index_put_((ids,), grad, accumulate=True), None


def _resolve_reshape(in_shape, spec):
    out = [in_shape[i] if s == 0 else s for i, s in enumerate(spec)]
    if -1 in out:
        known = 1
        for s in out:
            if s != -1:
                known *= s
        total = 1
        for s in in_shape:
            total *= s
        out[out.index(-1)] = total // known
    return tuple(out)


def _reshape_infer(op, block):
    x = in_var(op, block, "X")
    spec = list(op.attrs["shape"])
    if -1 not in x.shape:
        out = _resolve_reshape(x.shape, spec)
    else:
        # dynamic dims present: 0 copies the input dim (possibly -1),
        # -1 stays symbolic
        out = tuple(
            (x.shape[i] if i < len(x.shape) else -1) if s == 0 else s
            for i, s in enumerate(spec))
    set_output(op, block, "Out", out, x.dtype)


def _reshape_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    return {"Out": x.reshape(_resolve_reshape(tuple(x.shape),
                                              list(attrs["shape"])))}


register_op("reshape", ["X"], ["Out"], infer=_reshape_infer,
            compute=_reshape_compute)


def _transpose_infer(op, block):
    x = in_var(op, block, "X")
    perm = op.attrs["axis"]
    set_output(op, block, "Out", tuple(x.shape[p] for p in perm), x.dtype)


register_op(
    "transpose", ["X"], ["Out"], infer=_transpose_infer,
    compute=lambda ins, attrs, ctx, op_index: {
        "Out": ins["X"][0].permute(*attrs["axis"])},
)


def _lookup_table_infer(op, block):
    w = in_var(op, block, "W")
    ids = in_var(op, block, "Ids")
    shape = tuple(ids.shape[:-1]) + (w.shape[1],) if ids.shape[-1] == 1 \
        else tuple(ids.shape) + (w.shape[1],)
    set_output(op, block, "Out", shape, w.dtype)


def _lookup_table_compute(ins, attrs, ctx, op_index):
    w, ids = ins["W"][0], ins["Ids"][0]
    squeeze = ids.dim() > 0 and ids.shape[-1] == 1
    flat = ids.reshape(-1)
    out = _Gather.apply(w, flat)
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad != -1:
        out = out * (flat != pad)[:, None].to(out.dtype)
    shape = (tuple(ids.shape[:-1]) if squeeze else tuple(ids.shape)) \
        + (w.shape[1],)
    return {"Out": out.reshape(shape)}


def _lookup_table_grad(op, no_grad_set):
    if op.attrs.get("is_sparse", False):
        raise NotImplementedError(
            "lookup_table(is_sparse=True): the SelectedRows gradient is not "
            "ported to paddle_tpu_torch yet (ROADMAP Queue A4)")
    return _auto_grad_maker(op, no_grad_set)


register_op("lookup_table", ["W", "Ids"], ["Out"], infer=_lookup_table_infer,
            compute=_lookup_table_compute, grad=_lookup_table_grad,
            no_grad_inputs=("Ids",))


def _unsqueeze_infer(op, block):
    x = in_var(op, block, "X")
    out = list(x.shape)
    for a in sorted(op.attrs["axes"]):
        out.insert(a if a >= 0 else a + len(out) + 1, 1)
    set_output(op, block, "Out", out, x.dtype)


def _unsqueeze_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    for a in sorted(attrs["axes"]):
        x = x.unsqueeze(a if a >= 0 else a + x.dim() + 1)
    return {"Out": x}


register_op("unsqueeze", ["X"], ["Out"], infer=_unsqueeze_infer,
            compute=_unsqueeze_compute)
