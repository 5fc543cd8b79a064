"""``cross_entropy``, ``softmax_with_cross_entropy`` and
``margin_rank_loss`` (counterpart of ``paddle_tpu/ops/loss.py``).

``cross_entropy`` takes probabilities: -log(x[label]) for hard labels
(the ResNet head's loss), -sum(label log x) for soft ones; plain torch.

``softmax_with_cross_entropy`` sends the case the hand-written kernels
take, hard labels with no ignore index (``ignore_index == -100``) and
uniform label smoothing ``label_smooth_eps`` fused into the loss, to
``ops.cuda.softmax_xent``: the op flattens the logits to [N, C] and calls
kernels #5/#6 on the card, their plain versions on the CPU.  Soft labels
and an ignore index go to plain torch, as the JAX package sends them to
XLA rather than to its Pallas kernel: a row whose label equals
``ignore_index`` (any value, -1 included) has loss 0 and no gradient.

``margin_rank_loss`` is the pairwise hinge max(0, -label (x1 - x2) +
margin)."""

import torch

from ..registry import in_var, register_op, set_output
from .cuda import softmax_xent as sx


def _swce_infer(op, block):
    logits = in_var(op, block, "Logits")
    set_output(op, block, "Softmax", logits.shape, logits.dtype)
    set_output(op, block, "Loss", tuple(logits.shape[:-1]) + (1,),
               logits.dtype)


def _swce_compute(ins, attrs, ctx, op_index):
    logits, label = ins["Logits"][0], ins["Label"][0]
    eps = float(attrs.get("label_smooth_eps", 0.0))
    soft = attrs.get("soft_label", False)
    ignore = attrs.get("ignore_index", -100)
    if not soft and ignore == -100:
        c = logits.shape[-1]
        loss, softmax = sx.softmax_xent(
            logits.reshape(-1, c).contiguous(), label.reshape(-1).long(),
            eps)
        return {"Softmax": softmax.reshape(logits.shape),
                "Loss": loss.reshape(tuple(logits.shape[:-1]) + (1,))}
    log_sm = torch.log_softmax(logits, dim=-1)
    if soft:
        return {"Softmax": torch.exp(log_sm),
                "Loss": -(label * log_sm).sum(dim=-1, keepdim=True)}
    idx = label.reshape(tuple(logits.shape[:-1]) + (1,)).long()
    ignored = idx == ignore
    # an ignored label may lie outside [0, C): its row's pick is discarded
    picked = torch.gather(log_sm, -1, torch.where(ignored, 0, idx))
    loss = -picked
    if eps:
        # (1 - eps) nll + eps (lse - mean(logits)), the smoothed target
        # (1 - eps) onehot + eps / C without the [N, C] soft label
        uniform = torch.logsumexp(logits, dim=-1, keepdim=True) \
            - logits.mean(dim=-1, keepdim=True)
        loss = (1.0 - eps) * loss + eps * uniform
    return {"Softmax": torch.exp(log_sm),
            "Loss": torch.where(ignored, 0.0, loss)}


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


def _margin_rank_loss_infer(op, block):
    x1 = in_var(op, block, "X1")
    set_output(op, block, "Out", x1.shape, x1.dtype)
    set_output(op, block, "Activated", x1.shape, x1.dtype)


def _margin_rank_loss_compute(ins, attrs, ctx, op_index):
    label, x1, x2 = ins["Label"][0], ins["X1"][0], ins["X2"][0]
    hinge = -label * (x1 - x2) + attrs.get("margin", 0.0)
    # torch.maximum splits the gradient of a tie as jnp.maximum does
    out = torch.maximum(hinge, torch.zeros_like(hinge))
    return {"Out": out, "Activated": (out > 0).to(x1.dtype)}


register_op("margin_rank_loss", ["Label", "X1", "X2"], ["Out", "Activated"],
            infer=_margin_rank_loss_infer, compute=_margin_rank_loss_compute,
            no_grad_inputs=("Label",))
