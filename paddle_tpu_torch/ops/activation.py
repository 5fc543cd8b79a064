"""``relu``, ``sqrt``, ``rsqrt``, ``square`` and ``softmax`` (over
``axis``, the last by default) (counterpart of
``paddle_tpu/ops/activation.py``; the other activations come with the
slices that use them)."""

import torch

from ..registry import register_op, same_shape_infer

for _name, _fn in (("relu", torch.relu), ("sqrt", torch.sqrt),
                   ("rsqrt", torch.rsqrt),
                   ("square", lambda x: x * x)):
    register_op(
        _name, ["X"], ["Out"], infer=same_shape_infer("X", "Out"),
        compute=lambda ins, attrs, ctx, op_index, fn=_fn: {
            "Out": fn(ins["X"][0])},
    )

register_op("softmax", ["X"], ["Out"], infer=same_shape_infer("X", "Out"),
            compute=lambda ins, attrs, ctx, op_index: {
                "Out": torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))})
