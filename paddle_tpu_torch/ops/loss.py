"""``cross_entropy`` and ``softmax_with_cross_entropy`` (counterpart of
``paddle_tpu/ops/loss.py``).

``cross_entropy`` takes probabilities: -log(x[label]) for hard labels
(the ResNet head's loss), -sum(label log x) for soft ones; plain torch.

``softmax_with_cross_entropy`` takes the case the hand-written kernels take:
hard labels with no ignore index (``ignore_index == -100``), uniform label
smoothing ``label_smooth_eps`` fused into the loss.  The op flattens the
logits to [N, C] and calls ``ops.cuda.softmax_xent``: kernels #5/#6 on the
card, their plain versions on the CPU.  Soft labels and an ignore index
raise; nothing falls back."""

import torch

from ..registry import in_var, register_op, set_output
from .cuda import softmax_xent as sx


def _swce_infer(op, block):
    logits = in_var(op, block, "Logits")
    set_output(op, block, "Softmax", logits.shape, logits.dtype)
    set_output(op, block, "Loss", tuple(logits.shape[:-1]) + (1,),
               logits.dtype)


def _swce_compute(ins, attrs, ctx, op_index):
    if attrs.get("soft_label", False) or \
            attrs.get("ignore_index", -100) != -100:
        raise NotImplementedError(
            "softmax_with_cross_entropy with soft_label=%s, ignore_index=%s:"
            " only hard labels with no ignore index are ported to "
            "paddle_tpu_torch (ROADMAP Queue A4)"
            % (attrs.get("soft_label", False),
               attrs.get("ignore_index", -100)))
    logits, label = ins["Logits"][0], ins["Label"][0]
    c = logits.shape[-1]
    loss, softmax = sx.softmax_xent(
        logits.reshape(-1, c).contiguous(), label.reshape(-1).long(),
        float(attrs.get("label_smooth_eps", 0.0)))
    return {"Softmax": softmax.reshape(logits.shape),
            "Loss": loss.reshape(tuple(logits.shape[:-1]) + (1,))}


register_op("softmax_with_cross_entropy", ["Logits", "Label"],
            ["Softmax", "Loss"], infer=_swce_infer, compute=_swce_compute,
            no_grad_inputs=("Label",))


def _cross_entropy_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "Y", tuple(x.shape[:-1]) + (1,), x.dtype)


def _cross_entropy_compute(ins, attrs, ctx, op_index):
    x, label = ins["X"][0], ins["Label"][0]
    if attrs.get("soft_label", False):
        return {"Y": -(label * torch.log(x)).sum(dim=-1, keepdim=True)}
    idx = label.reshape(tuple(x.shape[:-1]) + (1,)).long()
    return {"Y": -torch.log(torch.gather(x, -1, idx))}


register_op("cross_entropy", ["X", "Label"], ["Y"],
            infer=_cross_entropy_infer, compute=_cross_entropy_compute,
            no_grad_inputs=("Label",))
