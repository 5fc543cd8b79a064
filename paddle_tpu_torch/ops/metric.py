"""``accuracy`` and ``auc`` (counterpart of ``paddle_tpu/ops/metric.py``),
computed inside the step (no host read, so a captured step keeps them).
``accuracy``: the share of rows whose label is among their top-k indices.
``auc``: the streaming ROC AUC from threshold-bucketed histograms of
positives and negatives, kept in persistable int64 vars and updated in
place; the trapezoid is integrated in float64.  The JAX package runs with
x64 off, so its histograms are int32 and its AUC float32; the port keeps
the dtypes the program declares.  The other metric ops wait for A4."""

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


def _auc_infer(op, block):
    set_output(op, block, "AUC", (1,), "float64")
    bins = op.attrs.get("num_thresholds", 4095) + 1
    set_output(op, block, "StatPosOut", (bins,), "int64")
    set_output(op, block, "StatNegOut", (bins,), "int64")


def _auc_compute(ins, attrs, ctx, op_index):
    preds = ins["Predict"][0]  # [N, 2] binary probabilities
    label = ins["Label"][0].reshape(-1)
    stat_pos, stat_neg = ins["StatPos"][0], ins["StatNeg"][0]
    n_bins = stat_pos.shape[0]
    p = preds[:, 1] if preds.dim() == 2 and preds.shape[1] == 2 \
        else preds.reshape(-1)
    idx = torch.clamp((p * (n_bins - 1)).to(torch.int64), 0, n_bins - 1)
    pos = (label > 0).to(stat_pos.dtype)
    stat_pos.index_put_((idx,), pos, accumulate=True)
    stat_neg.index_put_((idx,), 1 - pos, accumulate=True)
    # the ROC curve from the histograms, threshold descending
    tp = torch.cumsum(stat_pos.flip(0), 0).to(torch.float64)
    fp = torch.cumsum(stat_neg.flip(0), 0).to(torch.float64)
    tpr = tp / torch.clamp_min(tp[-1], 1)
    fpr = fp / torch.clamp_min(fp[-1], 1)
    auc = torch.trapezoid(tpr, fpr).reshape(1)
    return {"AUC": auc, "StatPosOut": stat_pos, "StatNegOut": stat_neg}


register_op("auc", ["Predict", "Label", "StatPos", "StatNeg"],
            ["AUC", "StatPosOut", "StatNegOut"], infer=_auc_infer,
            compute=_auc_compute, grad=None)
