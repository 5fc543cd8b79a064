"""``accuracy`` (counterpart of ``paddle_tpu/ops/metric.py:18-38``): the
share of rows whose label is among their top-k indices, computed inside
the step (no host read, so a captured step keeps it).  ``auc`` and the
other metric ops wait for ROADMAP Queue A4a / A4."""

import torch

from ..registry import register_op, set_output


def _accuracy_infer(op, block):
    set_output(op, block, "Accuracy", (1,), "float32")
    set_output(op, block, "Correct", (1,), "int32")
    set_output(op, block, "Total", (1,), "int32")


def _accuracy_compute(ins, attrs, ctx, op_index):
    indices = ins["Indices"][0]  # [N, k] from top_k
    label = ins["Label"][0]      # [N, 1]
    hit = (indices == label.to(indices.dtype)).any(dim=-1)
    correct = hit.sum(dtype=torch.int32).reshape(1)
    total = torch.full((1,), indices.shape[0], dtype=torch.int32,
                       device=indices.device)
    # divided by a tensor: PyTorch on the card turns a division by a
    # Python number into a product with its reciprocal
    acc = correct.to(torch.float32) / total.to(torch.float32)
    return {"Accuracy": acc, "Correct": correct, "Total": total}


register_op("accuracy", ["Out", "Indices", "Label"],
            ["Accuracy", "Correct", "Total"], infer=_accuracy_infer,
            compute=_accuracy_compute, grad=None)
