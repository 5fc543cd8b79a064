"""``cross_entropy``, ``softmax_with_cross_entropy``, ``margin_rank_loss``
and the plain losses ``sigmoid_cross_entropy_with_logits``,
``huber_loss``, ``smooth_l1_loss``, ``hinge_loss``, ``log_loss``,
``rank_loss``, ``modified_huber_loss`` and ``lambda_cost`` (counterpart
of ``paddle_tpu/ops/loss.py``; plain torch, formula for formula).  Where
the JAX op takes ``jnp.maximum(x, 0)`` the port takes ``torch.maximum``
against zeros, which splits the gradient of a tie at 0 as jnp does, and
where it takes ``jnp.abs`` the port takes ``math.jnp_abs``, whose
gradient at 0 is +1 as jnp's.
``lambda_cost`` ranks each list by a stable sort of the negated scores
(the argsort of an argsort), as the JAX op's stable ``jnp.argsort``: the
masked entries all tie at -1e9 and keep their order.

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
from .math import jnp_abs


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


def _zero_max(x):
    return torch.maximum(x, torch.zeros_like(x))


def _scewl_compute(ins, attrs, ctx, op_index):
    x, label = ins["X"][0], ins["Label"][0]
    # max(x, 0) - x z + log(1 + exp(-|x|)), stable for large |x|
    loss = _zero_max(x) - x * label + torch.log1p(torch.exp(-jnp_abs(x)))
    ignore = attrs.get("ignore_index", -100)
    if ignore != -100:
        loss = torch.where(label == ignore, torch.zeros_like(loss), loss)
    return {"Out": loss}


def _same_out_infer(out_slot, in_slot):
    def infer(op, block):
        x = in_var(op, block, in_slot)
        set_output(op, block, out_slot, x.shape, x.dtype)

    return infer


register_op("sigmoid_cross_entropy_with_logits", ["X", "Label"], ["Out"],
            infer=_same_out_infer("Out", "X"), compute=_scewl_compute,
            no_grad_inputs=("Label",))


def _huber_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "Residual", x.shape, x.dtype)
    set_output(op, block, "Out", x.shape, x.dtype)


def _huber_compute(ins, attrs, ctx, op_index):
    x, y = ins["X"][0], ins["Y"][0]
    d = attrs.get("delta", 1.0)
    r = y - x
    a = jnp_abs(r)
    return {"Residual": r,
            "Out": torch.where(a <= d, 0.5 * r * r, d * (a - 0.5 * d))}


register_op("huber_loss", ["X", "Y"], ["Residual", "Out"],
            infer=_huber_infer, compute=_huber_compute,
            no_grad_inputs=("Y",))


def _smooth_l1_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "Diff", x.shape, x.dtype)
    set_output(op, block, "Out", (x.shape[0], 1), x.dtype)


def _smooth_l1_compute(ins, attrs, ctx, op_index):
    x, y = ins["X"][0], ins["Y"][0]
    s2 = attrs.get("sigma", 1.0) ** 2
    diff = x - y
    inside = ins.get("InsideWeight", [None])[0]
    if inside is not None:
        diff = diff * inside
    ad = jnp_abs(diff)
    loss = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)
    outside = ins.get("OutsideWeight", [None])[0]
    if outside is not None:
        loss = loss * outside
    return {"Diff": diff, "Out": torch.sum(loss.reshape(x.shape[0], -1),
                                           dim=1, keepdim=True)}


register_op("smooth_l1_loss", ["X", "Y", "InsideWeight", "OutsideWeight"],
            ["Diff", "Out"], infer=_smooth_l1_infer,
            compute=_smooth_l1_compute,
            no_grad_inputs=("Y", "InsideWeight", "OutsideWeight"))

register_op("hinge_loss", ["Logits", "Labels"], ["Loss"],
            infer=_same_out_infer("Loss", "Logits"),
            compute=lambda ins, attrs, ctx, op_index: {"Loss": _zero_max(
                1.0 - (2.0 * ins["Labels"][0] - 1.0) * ins["Logits"][0])},
            no_grad_inputs=("Labels",))


def _log_loss_compute(ins, attrs, ctx, op_index):
    p, label = ins["Predicted"][0], ins["Labels"][0]
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": -label * torch.log(p + eps)
            - (1 - label) * torch.log(1 - p + eps)}


register_op("log_loss", ["Predicted", "Labels"], ["Loss"],
            infer=_same_out_infer("Loss", "Predicted"),
            compute=_log_loss_compute, no_grad_inputs=("Labels",))


def _rank_loss_compute(ins, attrs, ctx, op_index):
    d = ins["Left"][0] - ins["Right"][0]
    return {"Out": torch.log1p(torch.exp(d)) - ins["Label"][0] * d}


register_op("rank_loss", ["Label", "Left", "Right"], ["Out"],
            infer=_same_out_infer("Out", "Left"), compute=_rank_loss_compute,
            no_grad_inputs=("Label",))


def _mhl_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "IntermediateVal", x.shape, x.dtype)
    set_output(op, block, "Out", x.shape, x.dtype)


def _mhl_compute(ins, attrs, ctx, op_index):
    x, y = ins["X"][0], ins["Y"][0]       # y in {0, 1}
    inter = x * (2.0 * y - 1.0)
    zero = torch.zeros_like(inter)
    loss = torch.where(inter < -1.0, -4.0 * inter,
                       torch.where(inter < 1.0, (1.0 - inter) ** 2, zero))
    return {"IntermediateVal": inter, "Out": loss}


register_op("modified_huber_loss", ["X", "Y"], ["IntermediateVal", "Out"],
            infer=_mhl_infer, compute=_mhl_compute, no_grad_inputs=("Y",))


def _lambda_cost_infer(op, block):
    x = in_var(op, block, "Score")
    set_output(op, block, "Out", (x.shape[0], 1), x.dtype)


def _lambda_cost_compute(ins, attrs, ctx, op_index):
    """LambdaRank, list by list: for each pair (i, j) with rel_i > rel_j,
    |delta NDCG_ij| log(1 + exp(-(s_i - s_j))).  Score and Rel [B, T, 1]
    padded, ``Length`` masks the pad; delta NDCG swaps i and j in the
    DCG of the model's ranking, over the ideal DCG of the top
    ``ndcg_num`` true relevances."""
    score = ins["Score"][0].reshape(ins["Score"][0].shape[0], -1)
    rel = ins["Rel"][0].reshape(score.shape).to(score.dtype)
    length = ins.get("Length", [None])[0]
    b, t = score.shape
    pos = torch.arange(t, device=score.device)
    valid = torch.ones((b, t), dtype=torch.bool, device=score.device) \
        if length is None else pos[None, :] < length.reshape(b, 1)
    s = torch.where(valid, score, torch.full_like(score, -1e9))
    r = torch.where(valid, rel, torch.zeros_like(rel))
    # each doc's rank under the scores (0 best), ties in index order
    order = torch.sort(-s, dim=1, stable=True)[1]
    rank = torch.sort(order, dim=1, stable=True)[1]
    disc = 1.0 / torch.log2(2.0 + rank.to(score.dtype))
    gain = 2.0 ** r - 1.0
    r_sorted = -torch.sort(-r, dim=1)[0]
    ideal = 1.0 / torch.log2(2.0 + pos.to(score.dtype))
    top = (pos < int(attrs.get("ndcg_num", 5))).to(score.dtype)
    idcg = torch.clamp_min(torch.sum((2.0 ** r_sorted - 1.0) * ideal * top,
                                     dim=1, keepdim=True), 1e-8)
    delta = torch.abs(gain[:, :, None] - gain[:, None, :]) \
        * torch.abs(disc[:, :, None] - disc[:, None, :]) / idcg[:, :, None]
    diff = score[:, :, None] - score[:, None, :]
    pair = torch.log1p(torch.exp(-torch.clamp(diff, -30.0, 30.0)))
    better = (rel[:, :, None] > rel[:, None, :]) \
        & valid[:, :, None] & valid[:, None, :]
    out = torch.sum(torch.where(better, delta * pair,
                                torch.zeros_like(pair)), dim=(1, 2))
    return {"Out": out.reshape(b, 1)}


register_op("lambda_cost", ["Score", "Rel", "Length"], ["Out"],
            infer=_lambda_cost_infer, compute=_lambda_cost_compute,
            no_grad_inputs=("Rel", "Length"))
