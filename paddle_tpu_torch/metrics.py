"""Host-side metric accumulators (a copy of ``paddle_tpu/metrics.py``,
which the port cannot import: that package imports JAX): MetricBase,
CompositeMetric, Precision, Recall, Accuracy, EditDistance, Auc,
DetectionMAP and ChunkEvaluator accumulate fetched per-batch values in
numpy across minibatches.
"""

import numpy as np

__all__ = [
    "MetricBase", "CompositeMetric", "Precision", "Recall", "Accuracy",
    "EditDistance", "Auc", "DetectionMAP", "ChunkEvaluator",
]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        for k, v in self.__dict__.items():
            if k.startswith("_"):
                continue
            if isinstance(v, (int, float)):
                setattr(self, k, 0)
            elif isinstance(v, np.ndarray):
                setattr(self, k, np.zeros_like(v))

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0


class Accuracy(MetricBase):
    """Weighted streaming accuracy (feed per-batch acc + batch size)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        return self.value / self.weight if self.weight else 0.0


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances).reshape(-1)
        self.total_distance += float(np.sum(distances))
        self.seq_num += int(seq_num)
        self.instance_error += int(np.sum(distances > 0))

    def eval(self):
        avg = self.total_distance / self.seq_num if self.seq_num else 0.0
        err = self.instance_error / self.seq_num if self.seq_num else 0.0
        return avg, err


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        bins = num_thresholds + 1
        self._stat_pos = np.zeros(bins, dtype=np.int64)
        self._stat_neg = np.zeros(bins, dtype=np.int64)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        p = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        nb = len(self._stat_pos)
        idx = np.clip((p * (nb - 1)).astype(np.int64), 0, nb - 1)
        for i, lab in zip(idx, labels):
            if lab > 0:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def eval(self):
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tot_pos = max(tp[-1], 1)
        tot_neg = max(fp[-1], 1)
        tpr = tp / tot_pos
        fpr = fp / tot_neg
        return float(np.trapezoid(tpr, fpr))


class DetectionMAP(MetricBase):
    """Streaming mean-average-precision for detection (reference
    fluid/metrics.py DetectionMAP / detection_map_op.cc) — host-side
    accumulation (mAP evaluation has no MXU work; keeping it off-graph
    is the TPU-appropriate split).

    update(detections, gt_boxes, gt_labels): detections [N, 6]
    (label, score, x1, y1, x2, y2) from multiclass_nms; gt per image.
    eval() returns mAP over accumulated images (11-point or integral).
    """

    def __init__(self, name=None, overlap_threshold=0.5,
                 ap_version="integral", class_num=None):
        super().__init__(name)
        self.overlap_threshold = overlap_threshold
        self.ap_version = ap_version
        self._scores = {}   # class -> list of (score, is_tp)
        self._n_gt = {}     # class -> gt count

    @staticmethod
    def _iou(a, b):
        ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
        ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
        inter = max(ix2 - ix1, 0.0) * max(iy2 - iy1, 0.0)
        ua = ((a[2] - a[0]) * (a[3] - a[1]) +
              (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / ua if ua > 0 else 0.0

    def reset(self):
        """Clear accumulated detections/counts; thresholds are config,
        not state (MetricBase.reset would zero them)."""
        self._scores = {}
        self._n_gt = {}

    def update(self, detections, gt_boxes, gt_labels):
        detections = np.asarray(detections, dtype=np.float64)
        gt_boxes = np.asarray(gt_boxes, dtype=np.float64)
        gt_labels = np.asarray(gt_labels).reshape(-1)
        for c in np.unique(gt_labels):
            self._n_gt[int(c)] = self._n_gt.get(int(c), 0) + \
                int(np.sum(gt_labels == c))
        used = np.zeros(len(gt_boxes), bool)
        order = np.argsort(-detections[:, 1]) if len(detections) else []
        for i in order:
            lbl, score = int(detections[i, 0]), detections[i, 1]
            if lbl < 0:
                continue
            # dets clip to [0, 1] before overlap; the best gt is found
            # over ALL gts of the class (used or not) and a used best is
            # an FP — exactly detection_map_op.h CalcTrueAndFalsePositive
            box = np.clip(detections[i, 2:6], 0.0, 1.0)
            best, best_j = -1.0, -1
            for j, (gb, gl) in enumerate(zip(gt_boxes, gt_labels)):
                if int(gl) != lbl:
                    continue
                ov = self._iou(box, gb)
                if ov > best:
                    best, best_j = ov, j
            tp = best > self.overlap_threshold and not used[best_j]
            if tp:
                used[best_j] = True
            self._scores.setdefault(lbl, []).append((score, tp))

    def eval(self):
        aps = []
        for c, n_gt in self._n_gt.items():
            recs = sorted(self._scores.get(c, []), reverse=True)
            if not recs or n_gt == 0:
                # classes with no detections are skipped, not zeroed
                # (detection_map_op.h CalcMAP true_pos.find == end)
                continue
            tps = np.cumsum([1.0 if t else 0.0 for _, t in recs])
            fps = np.cumsum([0.0 if t else 1.0 for _, t in recs])
            recall = tps / n_gt
            precision = tps / np.maximum(tps + fps, 1e-12)
            if self.ap_version == "11point":
                ap = np.mean([
                    np.max(precision[recall >= t], initial=0.0)
                    for t in np.linspace(0, 1, 11)])
            else:  # integral
                ap = 0.0
                prev_r = 0.0
                for r, p in zip(recall, precision):
                    ap += (r - prev_r) * p
                    prev_r = r
            aps.append(float(ap))
        return float(np.mean(aps)) if aps else 0.0


class ChunkEvaluator(MetricBase):
    """Accumulate chunk_eval counters across mini-batches; eval returns
    (precision, recall, f1) (reference metrics.py:355)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        for label, v in (("num_infer_chunks", num_infer_chunks),
                         ("num_label_chunks", num_label_chunks),
                         ("num_correct_chunks", num_correct_chunks)):
            if not isinstance(v, (int, float, np.ndarray, np.generic)):
                raise ValueError(
                    "%s must be a number or numpy ndarray" % label)
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).sum())
        self.num_label_chunks += int(np.asarray(num_label_chunks).sum())
        self.num_correct_chunks += int(
            np.asarray(num_correct_chunks).sum())

    def eval(self):
        precision = float(self.num_correct_chunks) / \
            self.num_infer_chunks if self.num_infer_chunks else 0.0
        recall = float(self.num_correct_chunks) / \
            self.num_label_chunks if self.num_label_chunks else 0.0
        f1 = 2 * precision * recall / (precision + recall) \
            if self.num_correct_chunks else 0.0
        return precision, recall, f1
