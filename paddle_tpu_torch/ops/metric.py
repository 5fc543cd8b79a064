"""``accuracy`` and ``auc`` (counterpart of ``paddle_tpu/ops/metric.py``),
computed inside the step (no host read, so a captured step keeps them).
``accuracy``: the share of rows whose label is among their top-k indices.
``auc``: the streaming ROC AUC from threshold-bucketed histograms of
positives and negatives, kept in persistable int64 vars and updated in
place; the trapezoid is integrated in float64.  The JAX package runs with
x64 off, so its histograms are int32 and its AUC float32; the port keeps
the dtypes the program declares.

``mean_iou``, ``precision_recall``, ``positive_negative_pair`` and
``detection_map`` follow the rest of the JAX module.  A count or weight
added at an index lands in a buffer with one spare slot, where an index
out of range (which the JAX scatter drops) goes, so none reaches a CUDA
kernel; float sums at an index go through ``manipulation.add_at``
(sorted on the card, unit by unit on the host), so a captured run
repeats the eager bits.
``detection_map`` evaluates one mini-batch in the graph: each image's
greedy matching is a loop over its score-sorted detections for the whole
batch at once (the JAX op's ``fori_loop``), each class's precision /
recall curve a cumulative sum over the batch's score-sorted detections
(stable sorts: the JAX ``argsort``), and the AP sums run in float64 before
the float32 result, so the card and the host give the same bits."""

import numpy as np
import torch

from ..registry import in_var, optional, register_op, set_output
from .manipulation import _wrap, add_at


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


def recip(c):
    """float32(1 / c).  The JAX ops divide by trace-time constants, which
    XLA turns into a product with the float32 reciprocal (and PyTorch on
    the card does for a division by a Python number, the host does not):
    the port multiplies by it on both devices."""
    return float(np.float32(1.0) / np.float32(c))


def _spare(idx, n):
    """Indices into a buffer of n + 1 rows: negatives counted from the
    end (``.at``'s rule), any still outside [0, n) at the spare row n."""
    idx, ok = _wrap(idx, n)
    return torch.where(ok, idx, n)


# -- mean_iou ---------------------------------------------------------------

def _mean_iou_compute(ins, attrs, ctx, op_index):
    pred = ins["Predictions"][0].reshape(-1).long()
    label = ins["Labels"][0].reshape(-1).long()
    n = int(attrs["num_classes"])
    hit = pred == label

    def count(idx, vals):
        buf = torch.zeros(n + 1, dtype=torch.int64, device=pred.device)
        return buf.index_add(0, _spare(idx, n), vals)[:n]

    ones = torch.ones_like(pred)
    inter = count(torch.where(hit, pred, n - 1), hit.long())
    label_cnt = count(label, ones)
    union = count(pred, ones) + label_cnt - inter
    iou = inter.to(torch.float32) / torch.clamp_min(union, 1).to(
        torch.float32)
    valid = (union > 0).to(torch.float32)
    miou = ((iou * valid).sum() / torch.clamp_min(valid.sum(), 1)) \
        .reshape(1)
    return {"OutMeanIou": miou,
            "OutWrong": (label_cnt - inter).to(torch.int32),
            "OutCorrect": inter.to(torch.int32)}


def _mean_iou_infer(op, block):
    n = op.attrs["num_classes"]
    set_output(op, block, "OutMeanIou", (1,), "float32")
    set_output(op, block, "OutWrong", (n,), "int32")
    set_output(op, block, "OutCorrect", (n,), "int32")


register_op("mean_iou", ["Predictions", "Labels"],
            ["OutMeanIou", "OutWrong", "OutCorrect"], infer=_mean_iou_infer,
            compute=_mean_iou_compute, grad=None)


# -- precision_recall -------------------------------------------------------

def _pr_metrics(states):
    """Macro and micro precision, recall and F1 from [C, 4] TP / FP / TN /
    FN counts."""
    tp, fp, fn = states[:, 0], states[:, 1], states[:, 3]

    def calc(num, extra):
        return torch.where((num > 0) | (extra > 0),
                           num / torch.clamp_min(num + extra, 1e-20), 1.0)

    def f1(p, r):
        return torch.where((p > 0) | (r > 0),
                           2 * p * r / torch.clamp_min(p + r, 1e-20), 0.0)

    macro_p, macro_r = calc(tp, fp).mean(), calc(tp, fn).mean()
    t_tp, t_fp, t_fn = tp.sum(), fp.sum(), fn.sum()
    micro_p, micro_r = calc(t_tp, t_fp), calc(t_tp, t_fn)
    return torch.stack([macro_p, macro_r, f1(macro_p, macro_r),
                        micro_p, micro_r, f1(micro_p, micro_r)])


def _precision_recall_infer(op, block):
    c = int(op.attrs["class_number"])
    set_output(op, block, "BatchMetrics", (6,), "float32")
    set_output(op, block, "AccumMetrics", (6,), "float32")
    set_output(op, block, "AccumStatesInfo", (c, 4), "float32")


def _precision_recall_compute(ins, attrs, ctx, op_index):
    """Per-sample TP / FP / TN / FN added at their classes; the batch's
    metrics, and the metrics after adding ``StatesInfo``."""
    ids = ins["Indices"][0].reshape(-1).long()
    labels = ins["Labels"][0].reshape(-1).long()
    w = optional(ins, "Weights")
    w = w.reshape(-1).to(torch.float32) if w is not None \
        else torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
    c = int(attrs["class_number"])
    ok = ids == labels
    zero = torch.zeros_like(w)
    cols = torch.arange(4, device=ids.device)
    # every (class, column, value) the JAX op adds, in its order
    idx = torch.cat([_spare(ids, c) * 4, _spare(ids, c) * 4 + 1,
                     _spare(labels, c) * 4 + 3, _spare(ids, c) * 4 + 2,
                     _spare(labels, c) * 4 + 2])
    vals = torch.cat([torch.where(ok, w, zero), torch.where(ok, zero, w),
                      torch.where(ok, zero, w), -w, torch.where(ok, zero,
                                                                -w)])
    # TN: every class gets the batch's weight first, then loses it at the
    # classes a sample involves
    init = torch.where(cols == 2, w.sum(), 0.0).expand(c + 1, 4)
    batch = add_at(init.reshape(-1), idx, vals).reshape(c + 1, 4)[:c]
    prev = optional(ins, "StatesInfo")
    accum = batch if prev is None else batch + prev
    return {"BatchMetrics": _pr_metrics(batch),
            "AccumMetrics": _pr_metrics(accum), "AccumStatesInfo": accum}


register_op("precision_recall", ["MaxProbs", "Indices", "Labels", "Weights",
                                 "StatesInfo"],
            ["BatchMetrics", "AccumMetrics", "AccumStatesInfo"],
            infer=_precision_recall_infer,
            compute=_precision_recall_compute, grad=None)


# -- positive_negative_pair -------------------------------------------------

def _pnp_infer(op, block):
    s = in_var(op, block, "Score")
    for slot in ("PositivePair", "NegativePair", "NeutralPair"):
        set_output(op, block, slot, (1,), s.dtype)


def _pnp_compute(ins, attrs, ctx, op_index):
    """Weighted counts of the ordered pairs i < j of one query whose labels
    differ: positive where the scores order them as the labels do, else
    negative; a tied pair counts as neutral and as negative (the
    reference kernel's fall-through)."""
    score = ins["Score"][0]
    col = attrs.get("column", 0)
    if col < 0:
        col += score.shape[1]
    s = score[:, col]
    lbl = ins["Label"][0].reshape(-1)
    q = ins["QueryID"][0].reshape(-1)
    w_in = optional(ins, "Weight")
    w = w_in.reshape(-1) if w_in is not None else torch.ones_like(s)
    n = s.shape[0]
    ar = torch.arange(n, device=s.device)
    valid = (q[:, None] == q[None, :]) & (ar[:, None] < ar[None, :]) & \
        (lbl[:, None] != lbl[None, :])
    pair_w = 0.5 * (w[:, None] + w[None, :])
    agree = (s[:, None] - s[None, :]) * (lbl[:, None] - lbl[None, :]) > 0
    tie = s[:, None] == s[None, :]
    zero = torch.zeros_like(pair_w)
    pos = torch.where(valid & agree, pair_w, zero).sum()
    neg = torch.where(valid & ~agree, pair_w, zero).sum()
    neu = torch.where(valid & tie, pair_w, zero).sum()

    def acc(slot, v):
        a = optional(ins, slot)
        return (v + a.reshape(()) if a is not None else v).reshape(1)

    return {"PositivePair": acc("AccumulatePositivePair", pos),
            "NegativePair": acc("AccumulateNegativePair", neg),
            "NeutralPair": acc("AccumulateNeutralPair", neu)}


register_op("positive_negative_pair",
            ["Score", "Label", "QueryID", "AccumulatePositivePair",
             "AccumulateNegativePair", "AccumulateNeutralPair", "Weight"],
            ["PositivePair", "NegativePair", "NeutralPair"],
            infer=_pnp_infer, compute=_pnp_compute, grad=None)


# -- detection_map ----------------------------------------------------------

def _dmap_infer(op, block):
    c = int(op.attrs["class_num"])
    set_output(op, block, "MAP", (1,), "float32")
    set_output(op, block, "AccumPosCount", (c, 1), "int32")


def _dmap_match(dets, dlen, gts, glen, thresh, eval_difficult):
    """Greedy matching of every image at once: dets [B, D, 6] (label,
    score, box), gts [B, G, 6] (label, box, difficult).  Each image's
    detections in descending score order (stable) claim the best
    same-class ground truth over ``thresh`` not yet claimed.  Returns
    (tp, fp, counted) [B, D] in the detections' own order."""
    from .detection import iou_matrix

    b, d = dets.shape[:2]
    g = gts.shape[1]
    dev = dets.device
    det_valid = (torch.arange(d, device=dev)[None] < dlen.long()[:, None]) \
        & (dets[:, :, 0] >= 0)
    gt_valid = torch.arange(g, device=dev)[None] < glen.long()[:, None]
    order = torch.sort(-dets[:, :, 1], dim=1, stable=True).indices
    sdets = torch.gather(dets, 1, order[:, :, None].expand(b, d, 6))
    svalid = torch.gather(det_valid, 1, order)
    iou = iou_matrix(torch.clamp(sdets[:, :, 2:6], 0.0, 1.0),
                     gts[:, :, 1:5])
    same = sdets[:, :, 0, None] == gts[:, None, :, 0]
    iou = torch.where(same & gt_valid[:, None, :], iou, -1.0)
    difficult = gts[:, :, 5] > 0
    visited = torch.zeros((b, g), dtype=torch.bool, device=dev)
    gs = torch.arange(g, device=dev)[None]
    tps, fps, cnts = [], [], []
    for i in range(d):
        max_ov, max_idx = torch.max(iou[:, i], dim=1)
        at = max_idx[:, None]
        matched = max_ov > thresh
        diff_skip = torch.gather(difficult, 1, at)[:, 0] & matched
        if eval_difficult:
            diff_skip = torch.zeros_like(diff_skip)
        fresh = matched & ~torch.gather(visited, 1, at)[:, 0] & ~diff_skip
        ok = svalid[:, i]
        visited = visited | ((gs == at) & (fresh & ok)[:, None])
        tps.append(fresh & ok)
        fps.append(~diff_skip & ~fresh & ok)
        cnts.append(ok & ~diff_skip)
    out = []
    for x in (tps, fps, cnts):
        x = torch.stack(x, 1)
        out.append(torch.zeros_like(x).scatter(1, order, x))
    return out


def _dmap_compute(ins, attrs, ctx, op_index):
    dets = ins["DetectRes"][0]
    labels = ins["Label"][0]
    c = int(attrs["class_num"])
    bg = int(attrs.get("background_label", 0))
    thresh = float(attrs.get("overlap_threshold", 0.5))
    eval_diff = bool(attrs.get("evaluate_difficult", True))
    ap_type = attrs.get("ap_type", "integral")
    if ap_type not in ("integral", "11point"):
        raise ValueError("detection_map: ap_type must be integral or "
                         "11point, got %r" % ap_type)
    b, d = dets.shape[:2]
    g = labels.shape[1]
    dev = dets.device
    if labels.shape[-1] == 5:                 # no difficult column
        labels = torch.cat([labels, labels.new_zeros(labels.shape[:-1]
                                                     + (1,))], -1)
    dlen = optional(ins, "DetectResLength")
    if dlen is None:
        dlen = torch.full((b,), d, dtype=torch.int32, device=dev)
    glen = optional(ins, "GtLength")
    if glen is None:
        glen = torch.full((b,), g, dtype=torch.int32, device=dev)

    gt_valid = torch.arange(g, device=dev)[None] < glen.long()[:, None]
    counted_gt = gt_valid if eval_diff else gt_valid & (labels[..., 5] <= 0)
    cls = torch.arange(c, device=dev).to(labels.dtype)
    pos_count = ((labels[None, :, :, 0] == cls[:, None, None])
                 & counted_gt[None]).sum((1, 2))              # [C]
    tp, fp, counted = _dmap_match(dets, dlen, labels, glen, thresh,
                                  eval_diff)
    order = torch.sort(-dets[..., 1].reshape(-1), stable=True).indices
    s_cls = dets[..., 0].reshape(-1)[order]
    s_tp = tp.reshape(-1)[order].to(torch.float32)
    s_fp = fp.reshape(-1)[order].to(torch.float32)
    s_cnt = counted.reshape(-1)[order]
    mask = s_cnt[None] & (s_cls[None] == cls.to(s_cls.dtype)[:, None])
    tpk = torch.where(mask, s_tp[None], 0.0)                  # [C, N]
    fpk = torch.where(mask, s_fp[None], 0.0)
    tp_cum, fp_cum = torch.cumsum(tpk, 1), torch.cumsum(fpk, 1)
    precision = tp_cum / torch.clamp_min(tp_cum + fp_cum, 1.0)
    npos = torch.clamp_min(pos_count.to(torch.float32), 1.0)[:, None]
    if ap_type == "integral":
        # recall moves at the true positives only, by 1 / npos each
        aps = torch.where(mask & (tpk > 0), precision / npos, 0.0) \
            .double().sum(1)
    else:
        recall = tp_cum / npos
        pts = torch.arange(11, device=dev, dtype=torch.float32) * recip(10)
        interp = torch.where(mask[:, None] & (recall[:, None] >= pts[None,
                                                                    :, None]),
                             precision[:, None], 0.0).amax(2)   # [C, 11]
        aps = (interp.double().sum(1).to(torch.float32) * recip(11)) \
            .double()
    has_det = mask.any(1)
    contributing = (pos_count > 0) & (pos_count != bg) & has_det
    n = contributing.sum().clamp_min(1)
    mean_ap = torch.where(contributing, aps.to(torch.float32).double(),
                          0.0).sum() / n
    return {"MAP": mean_ap.to(torch.float32).reshape(1),
            "AccumPosCount": pos_count[:, None].to(torch.int32)}


register_op("detection_map",
            ["DetectRes", "DetectResLength", "Label", "GtLength"],
            ["MAP", "AccumPosCount"], infer=_dmap_infer,
            compute=_dmap_compute, grad=None)
