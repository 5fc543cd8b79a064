"""``relu`` (counterpart of ``paddle_tpu/ops/activation.py``; the other
activations come with the slices that use them)."""

import torch

from ..registry import register_op, same_shape_infer

register_op(
    "relu", ["X"], ["Out"], infer=same_shape_infer("X", "Out"),
    compute=lambda ins, attrs, ctx, op_index: {"Out": torch.relu(ins["X"][0])},
)
