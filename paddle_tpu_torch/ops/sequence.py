"""The Transformer's sequence ops (counterpart of the ``add_position_
encoding`` and ``padding_mask`` ops of ``paddle_tpu/ops/sequence.py``).
Sequences are padded [B, T, ...] tensors with a [B] length companion."""

import torch

from ..core import convert_dtype
from ..registry import in_var, register_op, set_output


def _add_pos_enc_compute(ins, attrs, ctx, op_index):
    # X [B, T, D] + Table[:T] (T is the run's pad length)
    x, table = ins["X"][0], ins["Table"][0]
    return {"Out": x + table[:x.shape[1]][None]}


register_op(
    "add_position_encoding", ["X", "Table"], ["Out"],
    infer=lambda op, block: set_output(
        op, block, "Out", in_var(op, block, "X").shape,
        in_var(op, block, "X").dtype),
    compute=_add_pos_enc_compute, no_grad_inputs=("Table",))


def _padding_mask_infer(op, block):
    ref = in_var(op, block, "Ref")
    set_output(op, block, "Out", (ref.shape[0], ref.shape[1]),
               op.attrs.get("dtype", "float32"))


def _padding_mask_compute(ins, attrs, ctx, op_index):
    # [B] lengths + Ref [B, T, ...] -> [B, T] 0/1
    length, ref = ins["Length"][0], ins["Ref"][0]
    t = ref.shape[1]
    valid = torch.arange(t, device=ref.device)[None, :] \
        < length.to(ref.device).reshape(-1, 1)
    return {"Out": valid.to(convert_dtype(attrs.get("dtype", "float32")))}


register_op("padding_mask", ["Length", "Ref"], ["Out"],
            infer=_padding_mask_infer, compute=_padding_mask_compute,
            grad=None)
