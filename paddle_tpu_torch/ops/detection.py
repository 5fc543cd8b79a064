"""The detection op family (counterpart of ``paddle_tpu/ops/detection.py``):
``iou_similarity``, ``prior_box``, ``anchor_generator``, ``box_coder``,
``bipartite_match``, ``target_assign``, ``multiclass_nms``,
``mine_hard_examples``, ``polygon_box_transform``, ``roi_pool``,
``generate_proposals``, ``rpn_target_assign``,
``generate_proposal_labels`` and ``roi_perspective_transform``.

Padded batches with count companions replace the LoD, as in the JAX ops.
Where these choose by rank they do as the JAX ops do, on either device:
sorts are stable (``jnp.argsort``), a top-k takes the lowest index among
equal values (``lax.top_k``; ``control_flow.top_k_first_index``) and an
argmax the first maximum (``torch.max``'s index).

The greedy selections loop over fixed trip counts with masks, one trip
for the whole batch:

* NMS (``nms_keep``) runs over each (image, class)'s ``top_k`` best boxes
  in descending score order, with one [..., k, k] IoU: box i is kept if
  it passes the score threshold and no kept earlier box overlaps it past
  the (adaptive) threshold.  The JAX op loops over all M boxes, but keeps
  none past the first k in score order, so the k trips give its keep mask
  bit for bit; SSD300's 8732 priors take 400 trips, not 8732.
* ``bipartite_match`` runs min(G, P) trips of a global argmax.
* ``detection_map``'s matching (``ops/metric.py``) loops over detections.

Nothing is read on the host: the counts (``OutLength``, ``NegCount``,
``RpnRoisLength``, ``RoisNum``) stay device tensors, and an index that a
JAX scatter drops (``mode="drop"``: ``target_assign``'s -1 matches, the
compacted ``NegIndices``, the sampled slots) writes a spare row or column
that is cut off, so none reaches a CUDA kernel out of range.

Under ``jax.jit`` XLA turns a division by a trace-time constant into a
product with its float32 reciprocal; the ops here multiply by the same
reciprocal where the JAX op divides by a constant (``_recip``), so the
boxes and the bins they decide come out alike.

``roi_pool`` takes each bin's maximum from a 2-D disjoint sparse table
of the feature map (four disjoint rectangles a bin, each with its
maximum and the count of its ties) instead of masking the whole map for
every bin, and splits a bin's gradient among its tied maxima as the JAX
op's ``jnp.max`` does (``_RegionMax``).
"""

import numpy as np
import torch

from ..registry import in_var, optional, register_op, set_output
from .control_flow import top_k_first_index
from .creation import device_constant
from .manipulation import add_at
from .metric import recip as _recip

_BIG_NEG = -1e9


def _stable_desc(x, dim=-1):
    """Indices sorting ``x`` descending, equal values in index order (the
    JAX ops' ``jnp.argsort(-x)``)."""
    return torch.sort(-x, dim=dim, stable=True).indices


def _rank(order):
    """The inverse permutation of ``order`` along the last dim."""
    ar = torch.arange(order.shape[-1], device=order.device)
    return torch.empty_like(order).scatter_(
        -1, order, ar.expand(order.shape).contiguous())


def _take_rows(x, idx):
    """``x[b, idx[b, ...]]`` for x [B, N, ...] and idx [B, ...]."""
    b = x.shape[0]
    bi = torch.arange(b, device=x.device).reshape((b,) + (1,) * (
        idx.dim() - 1))
    return x[bi, idx]


# -- iou_similarity ---------------------------------------------------------

def iou_matrix(a, b, normalized=True):
    """[..., N, 4] x [..., M, 4] -> [..., N, M] IoU of (x1, y1, x2, y2)
    boxes (the leading dims broadcast)."""
    off = 0.0 if normalized else 1.0
    area_a = (a[..., 2] - a[..., 0] + off) * (a[..., 3] - a[..., 1] + off)
    area_b = (b[..., 2] - b[..., 0] + off) * (b[..., 3] - b[..., 1] + off)
    ix1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp_min(ix2 - ix1 + off, 0.0) * \
        torch.clamp_min(iy2 - iy1 + off, 0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp_min(union, 1e-10),
                       0.0)


def _iou_infer(op, block):
    x, y = in_var(op, block, "X"), in_var(op, block, "Y")
    if len(x.shape) == 3:
        set_output(op, block, "Out", (x.shape[0], x.shape[1], y.shape[-2]),
                   x.dtype)
    else:
        set_output(op, block, "Out", (x.shape[0], y.shape[0]), x.dtype)


register_op("iou_similarity", ["X", "Y"], ["Out"], infer=_iou_infer,
            compute=lambda ins, attrs, ctx, op_index: {
                "Out": iou_matrix(ins["X"][0], ins["Y"][0])}, grad=None)


# -- prior_box --------------------------------------------------------------

def _prior_box_shapes(attrs):
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes", []) or []]
    ars = [1.0]
    for ar in attrs.get("aspect_ratios", []) or []:
        ar = float(ar)
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(ar)
            if attrs.get("flip", False) and \
                    not any(abs(1.0 / ar - e) < 1e-6 for e in ars):
                ars.append(1.0 / ar)
    return min_sizes, max_sizes, ars, \
        len(ars) * len(min_sizes) + len(max_sizes)


def _prior_box_wh(attrs):
    """Each prior's (half width, half height) in pixels, in the
    reference's order: each min size's aspect ratios, then the
    sqrt(min * max) square (``min_max_aspect_ratios_order``: the min
    square, the max square, then the other ratios)."""
    min_sizes, max_sizes, ars, _ = _prior_box_shapes(attrs)
    first = attrs.get("min_max_aspect_ratios_order", False)
    ws, hs = [], []
    for i, ms in enumerate(min_sizes):
        big = [np.sqrt(ms * max_sizes[i]) / 2.0] if max_sizes else []
        rest = [(ms * np.sqrt(ar) / 2.0, ms / np.sqrt(ar) / 2.0)
                for ar in ars if not (first and abs(ar - 1.0) < 1e-6)]
        pairs = ([(ms / 2.0, ms / 2.0)] + [(m, m) for m in big] + rest
                 if first else rest + [(m, m) for m in big])
        ws += [p[0] for p in pairs]
        hs += [p[1] for p in pairs]
    return np.asarray(ws, np.float32), np.asarray(hs, np.float32)


def _prior_box_infer(op, block):
    x = in_var(op, block, "Input")
    n = _prior_box_shapes(op.attrs)[3]
    set_output(op, block, "Boxes", (x.shape[2], x.shape[3], n, 4),
               "float32")
    set_output(op, block, "Variances", (x.shape[2], x.shape[3], n, 4),
               "float32")


def _grid(n, device):
    return torch.arange(n, device=device, dtype=torch.float32)


def _prior_box_compute(ins, attrs, ctx, op_index):
    fmap, image = ins["Input"][0], ins["Image"][0]
    dev = fmap.device
    h, w = fmap.shape[2], fmap.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    step_w = float(attrs.get("step_w", 0) or 0) or img_w / w
    step_h = float(attrs.get("step_h", 0) or 0) or img_h / h
    offset = float(attrs.get("offset", 0.5))
    half_w, half_h = (device_constant(a, dev) for a in _prior_box_wh(attrs))
    n = half_w.shape[0]
    cx = ((_grid(w, dev) + offset) * step_w)[None, :, None]
    cy = ((_grid(h, dev) + offset) * step_h)[:, None, None]
    rw, rh = _recip(img_w), _recip(img_h)
    boxes = torch.stack([
        ((cx - half_w) * rw).expand(h, w, n),
        ((cy - half_h) * rh).expand(h, w, n),
        ((cx + half_w) * rw).expand(h, w, n),
        ((cy + half_h) * rh).expand(h, w, n)], dim=-1)
    if attrs.get("clip", False):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = device_constant(np.asarray(attrs.get(
        "variances", [0.1, 0.1, 0.2, 0.2]), np.float32), dev)
    return {"Boxes": boxes, "Variances": var.expand(boxes.shape)}


register_op("prior_box", ["Input", "Image"], ["Boxes", "Variances"],
            infer=_prior_box_infer, compute=_prior_box_compute, grad=None)


# -- anchor_generator -------------------------------------------------------

def _anchor_gen_infer(op, block):
    x = in_var(op, block, "Input")
    n = len(op.attrs["anchor_sizes"]) * len(op.attrs["aspect_ratios"])
    for slot in ("Anchors", "Variances"):
        set_output(op, block, slot, (x.shape[2], x.shape[3], n, 4),
                   "float32")


def _anchor_gen_compute(ins, attrs, ctx, op_index):
    fmap = ins["Input"][0]
    dev = fmap.device
    h, w = fmap.shape[2], fmap.shape[3]
    sw, sh = (float(s) for s in attrs.get("stride", [16.0, 16.0]))
    offset = float(attrs.get("offset", 0.5))
    aws, ahs = [], []
    for ar in (float(a) for a in attrs["aspect_ratios"]):
        for s in (float(s) for s in attrs["anchor_sizes"]):
            base_w = np.round(np.sqrt(sw * sh / ar))
            aws.append(s / sw * base_w)
            ahs.append(s / sh * np.round(base_w * ar))
    aw = device_constant(np.asarray(aws, np.float32), dev)
    ah = device_constant(np.asarray(ahs, np.float32), dev)
    n = aw.shape[0]
    x_ctr = (_grid(w, dev) * sw + offset * (sw - 1))[None, :, None]
    y_ctr = (_grid(h, dev) * sh + offset * (sh - 1))[:, None, None]
    anchors = torch.stack([
        (x_ctr - 0.5 * (aw - 1)).expand(h, w, n),
        (y_ctr - 0.5 * (ah - 1)).expand(h, w, n),
        (x_ctr + 0.5 * (aw - 1)).expand(h, w, n),
        (y_ctr + 0.5 * (ah - 1)).expand(h, w, n)], dim=-1)
    var = device_constant(np.asarray(attrs.get(
        "variances", [0.1, 0.1, 0.2, 0.2]), np.float32), dev)
    return {"Anchors": anchors, "Variances": var.expand(anchors.shape)}


register_op("anchor_generator", ["Input"], ["Anchors", "Variances"],
            infer=_anchor_gen_infer, compute=_anchor_gen_compute, grad=None)


# -- box_coder --------------------------------------------------------------

def _center_form(b, off):
    return ((b[..., 2] + b[..., 0]) / 2, (b[..., 3] + b[..., 1]) / 2,
            b[..., 2] - b[..., 0] + off, b[..., 3] - b[..., 1] + off)


def _box_coder_infer(op, block):
    t, p = in_var(op, block, "TargetBox"), in_var(op, block, "PriorBox")
    if op.attrs.get("code_type", "encode_center_size") \
            .endswith("encode_center_size"):
        set_output(op, block, "OutputBox", (t.shape[0], p.shape[0], 4),
                   "float32")
    else:
        set_output(op, block, "OutputBox", t.shape, "float32")


def _box_coder_compute(ins, attrs, ctx, op_index):
    tb, pb = ins["TargetBox"][0], ins["PriorBox"][0]
    pv = optional(ins, "PriorBoxVar")
    off = 0.0 if attrs.get("box_normalized", True) else 1.0
    pcx, pcy, pw, ph = _center_form(pb, off)
    if attrs.get("code_type", "encode_center_size") \
            .endswith("encode_center_size"):
        tcx, tcy, tw, th = _center_form(tb, off)
        out = torch.stack([
            (tcx[:, None] - pcx[None]) / pw[None],
            (tcy[:, None] - pcy[None]) / ph[None],
            torch.log(torch.abs(tw[:, None] / pw[None])),
            torch.log(torch.abs(th[:, None] / ph[None]))], dim=-1)
        if pv is not None:
            out = out / pv[None]
    else:  # decode_center_size: tb [N, M, 4] against prior j a column
        t = tb * pv[None] if pv is not None else tb
        cx = t[..., 0] * pw[None] + pcx[None]
        cy = t[..., 1] * ph[None] + pcy[None]
        w = torch.exp(t[..., 2]) * pw[None]
        h = torch.exp(t[..., 3]) * ph[None]
        out = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2 - off,
                           cy + h / 2 - off], dim=-1)
    return {"OutputBox": out.to(torch.float32)}


register_op("box_coder", ["TargetBox", "PriorBox", "PriorBoxVar"],
            ["OutputBox"], infer=_box_coder_infer,
            compute=_box_coder_compute, grad=None)


# -- bipartite_match --------------------------------------------------------

def bipartite_match(dist, per_prediction=False, dist_threshold=0.5):
    """dist [B, G, P] -> (the matched row of each column or -1 [B, P]
    int32, its distance [B, P]).  Each trip matches the largest entry
    left (the first in row-major order among equals) while it is above
    0; with ``per_prediction`` an unmatched column whose best row reaches
    ``dist_threshold`` takes that row."""
    b, g, p = dist.shape
    dev = dist.device
    match = torch.full((b, p), -1, dtype=torch.int32, device=dev)
    mdist = torch.zeros((b, p), dtype=dist.dtype, device=dev)
    row_used = torch.zeros((b, g), dtype=torch.bool, device=dev)
    col_used = torch.zeros((b, p), dtype=torch.bool, device=dev)
    rows = torch.arange(g, device=dev)[None]
    cols = torch.arange(p, device=dev)[None]
    for _ in range(min(g, p)):
        masked = torch.where(row_used[:, :, None] | col_used[:, None, :],
                             _BIG_NEG, dist)
        best, flat = torch.max(masked.reshape(b, g * p), dim=1)
        i, j = flat // p, flat % p
        ok = (best > 0)[:, None]
        at_j = (cols == j[:, None]) & ok
        match = torch.where(at_j, i.to(torch.int32)[:, None], match)
        mdist = torch.where(at_j, best[:, None], mdist)
        row_used = row_used | ((rows == i[:, None]) & ok)
        col_used = col_used | at_j
    if per_prediction:
        best_val, best_row = torch.max(dist, dim=1)
        fill = (match == -1) & (best_val >= dist_threshold)
        match = torch.where(fill, best_row.to(torch.int32), match)
        mdist = torch.where(fill, best_val, mdist)
    return match, mdist


def _bipartite_infer(op, block):
    d = in_var(op, block, "DistMat")
    b = d.shape[0] if len(d.shape) == 3 else 1
    set_output(op, block, "ColToRowMatchIndices", (b, d.shape[-1]), "int32")
    set_output(op, block, "ColToRowMatchDist", (b, d.shape[-1]), "float32")


def _bipartite_compute(ins, attrs, ctx, op_index):
    dist = ins["DistMat"][0]
    if dist.dim() == 2:
        dist = dist[None]
    match, mdist = bipartite_match(
        dist, attrs.get("match_type", "bipartite") == "per_prediction",
        float(attrs.get("dist_threshold", 0.5)))
    return {"ColToRowMatchIndices": match,
            "ColToRowMatchDist": mdist.to(torch.float32)}


register_op("bipartite_match", ["DistMat"],
            ["ColToRowMatchIndices", "ColToRowMatchDist"],
            infer=_bipartite_infer, compute=_bipartite_compute, grad=None)


# -- target_assign ----------------------------------------------------------

def _target_assign_infer(op, block):
    x, m = in_var(op, block, "X"), in_var(op, block, "MatchIndices")
    set_output(op, block, "Out", (m.shape[0], m.shape[1], x.shape[-1]),
               x.dtype)
    set_output(op, block, "OutWeight", (m.shape[0], m.shape[1], 1),
               "float32")


def _target_assign_compute(ins, attrs, ctx, op_index):
    """out[b, p] = x[b, match[b, p]] (x [B, G, K]) or x[b, match[b, p], p]
    (x [B, G, P, K]); the mismatch value where match is -1.  Weight 1 at
    the matched priors and at ``NegIndices`` (-1 padded)."""
    x, match = ins["X"][0], ins["MatchIndices"][0]
    b, p = match.shape
    dev = x.device
    safe = torch.clamp(match.long(), 0, x.shape[1] - 1)
    if x.dim() == 4:
        out = x[torch.arange(b, device=dev)[:, None], safe,
                torch.arange(p, device=dev)[None]]
    else:
        out = _take_rows(x, safe)
    matched = (match >= 0)[:, :, None]
    out = torch.where(matched, out, torch.full_like(
        out, float(attrs.get("mismatch_value", 0))))
    weight = matched.to(torch.float32)
    neg = optional(ins, "NegIndices")
    if neg is not None:
        neg = neg.long()
        tgt = torch.where((neg >= 0) & (neg < p), neg, p)
        rows = torch.arange(b, device=dev)[:, None].expand(tgt.shape)
        buf = torch.cat([weight[:, :, 0], weight.new_zeros((b, 1))], 1)
        weight = buf.index_put((rows, tgt), torch.ones_like(
            tgt, dtype=torch.float32))[:, :p, None]
    return {"Out": out, "OutWeight": weight}


register_op("target_assign", ["X", "MatchIndices", "NegIndices"],
            ["Out", "OutWeight"], infer=_target_assign_infer,
            compute=_target_assign_compute, grad=None)


# -- NMS --------------------------------------------------------------------

def nms_keep(sboxes, valid, nms_thresh, normalized, eta=1.0):
    """Greedy NMS over boxes already in descending score order: sboxes
    [..., k, 4], valid [..., k] -> keep [..., k].  Box i is kept when it
    is valid and no kept box before it overlaps it by more than the
    threshold at its turn; with ``eta`` < 1 the threshold decays by eta
    after each kept box while it is above 0.5 (adaptive NMS).  One trip a
    box, over every leading index at once; the IoU matrix is symmetric,
    so row i is box i's column."""
    k = sboxes.shape[-2]
    iou = iou_matrix(sboxes, sboxes, normalized)
    keep = torch.zeros_like(valid)
    thresh = torch.full(valid.shape[:-1], float(np.float32(nms_thresh)),
                        device=valid.device) if eta < 1.0 else nms_thresh
    for i in range(k):
        over = iou[..., i, :] > (thresh[..., None] if eta < 1.0 else thresh)
        ok = valid[..., i] & ~(keep & over).any(-1)
        keep[..., i] = ok
        if eta < 1.0:
            thresh = torch.where(ok & (thresh > 0.5), thresh * eta, thresh)
    return keep


def _multiclass_nms_infer(op, block):
    s = in_var(op, block, "Scores")
    keep = int(op.attrs.get("keep_top_k", -1))
    m = s.shape[-1]
    n = keep if keep > 0 else (None if m in (None, -1) else s.shape[1] * m)
    set_output(op, block, "Out", (s.shape[0], n, 6), "float32", lod_level=1)
    set_output(op, block, "OutLength", (s.shape[0],), "int32")


def multiclass_nms(bboxes, scores, attrs):
    """bboxes [B, M, 4], scores [B, C, M] -> (out [B, N, 6] rows (class,
    score, box) with -1-class padding, count [B] int32)."""
    b, c, m = scores.shape
    dev = scores.device
    bg = int(attrs.get("background_label", 0))
    top_k = int(attrs.get("nms_top_k", -1))
    keep_top_k = int(attrs.get("keep_top_k", -1))
    k = min(top_k, m) if top_k > 0 else m
    order = _stable_desc(scores)[..., :k]                   # [B, C, k]
    sscores = torch.gather(scores, 2, order)
    sboxes = _take_rows(bboxes, order)                      # [B, C, k, 4]
    keep = nms_keep(sboxes, sscores > float(attrs.get("score_threshold",
                                                       0.0)),
                    float(attrs.get("nms_threshold", 0.3)),
                    bool(attrs.get("normalized", True)),
                    float(attrs.get("nms_eta", 1.0)))
    if 0 <= bg < c:
        keep = keep & (torch.arange(c, device=dev) != bg)[None, :, None]
    # the kept boxes of every class, best first, equal scores in order of
    # their (class, box) index: lax.top_k over the [C * M] scores
    cand = torch.where(keep, sscores, _BIG_NEG).reshape(b, c * k)
    flat = (torch.arange(c, device=dev)[None, :, None] * m
            + order).reshape(b, c * k)
    by_index = torch.sort(flat, dim=1).indices
    cand, flat = torch.gather(cand, 1, by_index), torch.gather(flat, 1,
                                                               by_index)
    total = min(keep_top_k if keep_top_k > 0 else c * m, c * m)
    sel = _stable_desc(cand)[:, :total]
    top, flat = torch.gather(cand, 1, sel), torch.gather(flat, 1, sel)
    if total > c * k:
        pad = total - c * k
        top = torch.cat([top, top.new_full((b, pad), _BIG_NEG)], 1)
        flat = torch.cat([flat, flat.new_zeros((b, pad))], 1)
    valid = top > _BIG_NEG / 2
    boxes = _take_rows(bboxes, flat % m)
    out = torch.cat([
        torch.where(valid, (flat // m).to(torch.float32), -1.0)[:, :, None],
        torch.where(valid, top, 0.0)[:, :, None],
        torch.where(valid[:, :, None], boxes, 0.0)], dim=2)
    return out, valid.sum(1).to(torch.int32)


def _multiclass_nms_compute(ins, attrs, ctx, op_index):
    out, count = multiclass_nms(ins["BBoxes"][0], ins["Scores"][0], attrs)
    return {"Out": out, "OutLength": count}


register_op("multiclass_nms", ["BBoxes", "Scores"], ["Out", "OutLength"],
            infer=_multiclass_nms_infer, compute=_multiclass_nms_compute,
            grad=None)


# -- roi_pool ---------------------------------------------------------------

def _floor_log2(n, levels):
    """floor(log2 n) of positive integers below 2^levels, in integer
    arithmetic."""
    pw = 2 ** torch.arange(1, levels, device=n.device)
    return (n[..., None] >= pw).sum(-1)


def _halves(t, k):
    """The last dim (a power of two) as [..., blocks, 2, 2^k]: each block of
    2^(k + 1) split at its middle."""
    h = 1 << k
    return t.reshape(t.shape[:-1] + (t.shape[-1] // (2 * h), 2, h))


def _running_max(v):
    """The running maximum along the last dim, by log-step maxima (the
    host's ``cummax`` is a serial loop)."""
    n, d = v.shape[-1], 1
    v = v.clone()
    while d < n:
        v[..., d:] = torch.maximum(v[..., d:], v[..., :-d])
        d *= 2
    return v


def _run_max_count(v, c):
    """Along the last dim: the running maximum m[i] = max(v[:i + 1]) and
    the weight of its ties, sum of c[j] over j <= i with v[j] = m[i]."""
    n = v.shape[-1]
    m = _running_max(v)
    idx = torch.arange(n, device=v.device)
    new = torch.ones_like(m, dtype=torch.bool)
    new[..., 1:] = m[..., 1:] != m[..., :-1]
    start = _running_max(torch.where(new, idx, 0))
    e = torch.cumsum(torch.where(v == m, c, 0), -1, dtype=torch.int32)
    before = torch.gather(e, -1, torch.clamp_min(start - 1, 0))
    return m, e - torch.where(start > 0, before, 0)


def _run_sums(a, m):
    """Along the last dim, where the running maximum ``m`` is constant on
    runs: each position's sum of ``a`` from it to the end of its run, by
    log-step segmented sums (no cancellation)."""
    n, d = a.shape[-1], 1
    a = a.clone()
    while d < n:
        a[..., :-d] += torch.where(m[..., d:] == m[..., :-d], a[..., d:],
                                   0.0)
        d *= 2
    return a


def _toward_middle(fn, *ts, k):
    """``fn`` over each half of every 2^(k + 1) block of the last dim, run
    toward the middle: the left half reversed (its suffixes), the right
    half as is (its prefixes)."""
    hs = [_halves(t, k) for t in ts]
    left = fn(*(t[..., 0, :].flip(-1) for t in hs))
    right = fn(*(t[..., 1, :] for t in hs))
    if not isinstance(left, tuple):
        left, right = (left,), (right,)
    return tuple(torch.stack([a.flip(-1), b], -2).reshape(ts[0].shape)
                 for a, b in zip(left, right))


def _disjoint_table(v, c):
    """A disjoint sparse table of (maximum, tie count) along the last dim
    (a power of two): level 0 the elements, level k + 1 each position's
    aggregate toward the middle of its 2^(k + 1) block.  A range [l, r]
    with l != r is the two disjoint entries of level floor(log2(l ^ r))
    + 1 at l and at r."""
    ms, cs = [v], [c]
    for k in range(v.shape[-1].bit_length() - 1):
        m, cnt = _toward_middle(_run_max_count, v, c, k=k)
        ms.append(m)
        cs.append(cnt)
    return torch.stack(ms), torch.stack(cs)


def _push(a, m, below, levels):
    """The backward of ``_disjoint_table``: ``a`` [levels, ..., n] holds
    each entry's gradient for every element of it equal to its maximum
    (``m`` the table's maxima); returns it pushed onto the elements
    (``below`` their values): each element gets the sum over the entries
    that cover it and whose maximum it equals."""
    out = a[0]
    for k in range(1, levels):
        got = _toward_middle(_run_sums, a[k], m[k], k=k - 1)[0]
        out = out + torch.where(below == m[k], got, 0.0)
    return out


def _pad_pow2(x, dim):
    n = x.shape[dim]
    p = 1 << max(n - 1, 1).bit_length()
    if p == n:
        return x
    shape = list(x.shape)
    shape[dim] = p - n
    return torch.cat([x, x.new_full(shape, float("-inf"))], dim)


class _RegionMax(torch.autograd.Function):
    """The maximum of x [N, C, H, W] over each bin's rectangle [y0, y1) x
    [x0, x1) of image ``bidx``: [R, ph, pw] bins -> [R, C, ph, pw]; 0 for
    an empty bin (or a maximum at or below -5e8, as the JAX op's mask
    fill).  A 2-D disjoint sparse table of (maximum, tie count) pairs
    gives each bin as four disjoint rectangles, so the gradient can split
    a bin's cotangent equally among its tied maxima as ``jnp.max``'s
    does: pushed back through the table, each element gets the sum over
    the entries covering it whose maximum it equals."""

    @staticmethod
    def forward(ctx, x, bidx, y0, y1, x0, x1):
        n, c, h, w = x.shape
        xp = _pad_pow2(_pad_pow2(x, 3), 2)
        ones = torch.ones(xp.shape, dtype=torch.int32, device=x.device)
        tx_m, tx_c = _disjoint_table(xp, ones)           # [Kx, N, C, Hp, Wp]
        txy_m, txy_c = (t.transpose(-1, -2) for t in _disjoint_table(
            tx_m.transpose(-1, -2), tx_c.transpose(-1, -2)))
        ky, kx = txy_m.shape[0], txy_m.shape[1]
        empty = (y1 <= y0) | (x1 <= x0)
        looks = []
        for lo, hi, levels in ((y0, y1, ky), (x0, x1, kx)):
            lo = torch.minimum(lo, hi - 1).clamp_min(0)
            hi = torch.clamp_min(hi - 1, 0)
            one = lo == hi
            level = torch.where(one, 0, _floor_log2(
                torch.clamp_min(lo ^ hi, 1), levels - 1) + 1)
            looks.append((level, lo, hi, one))
        (ly, ya, yb, y_one), (lx, xa, xb, x_one) = looks
        ly, ya, yb, y_one, lx, xa, xb, x_one = torch.broadcast_tensors(
            ly, ya, yb, y_one, lx, xa, xb, x_one)
        bi = bidx[:, None, None].expand(ly.shape)
        corners = [(ya, xa, None), (ya, xb, x_one), (yb, xa, y_one),
                   (yb, xb, y_one | x_one)]
        vals, cnts = [], []
        for yy, xx, dup in corners:
            v = txy_m[ly, lx, bi, :, yy, xx]               # [R, ph, pw, C]
            cnt = txy_c[ly, lx, bi, :, yy, xx]
            if dup is not None:          # a one-element range: one entry
                v = torch.where(dup[..., None], float("-inf"), v)
                cnt = torch.where(dup[..., None], 0, cnt)
            vals.append(v)
            cnts.append(cnt)
        out = torch.stack(vals).amax(0)
        count = sum(torch.where(v == out, cnt, 0)
                    for v, cnt in zip(vals, cnts))
        out, count = out.permute(0, 3, 1, 2), count.permute(0, 3, 1, 2)
        zero = empty[:, None] | (out <= _BIG_NEG / 2)
        ctx.save_for_backward(xp, tx_m, txy_m, bi, ly, lx, ya, yb, xa, xb,
                              out, count, zero,
                              *[v.permute(0, 3, 1, 2) for v in vals])
        ctx.dims = (n, c, h, w)
        return torch.where(zero, 0.0, out)

    @staticmethod
    def backward(ctx, g):
        (xp, tx_m, txy_m, bi, ly, lx, ya, yb, xa, xb, out, count, zero,
         *vals) = ctx.saved_tensors
        n, c, h, w = ctx.dims
        ky, kx, _, _, hp, wp = txy_m.shape
        share = torch.where(zero, 0.0, g / torch.clamp_min(count, 1))
        chan = torch.arange(c, device=g.device)[None, :, None, None]
        acc = g.new_zeros(txy_m.numel())
        for (yy, xx), v in zip(((ya, xa), (ya, xb), (yb, xa), (yb, xb)),
                               vals):
            at = (((ly * kx + lx)[:, None] * n + bi[:, None]) * c + chan) \
                * (hp * wp) + yy[:, None] * wp + xx[:, None]
            acc = add_at(acc, at.reshape(-1),
                         torch.where(v == out, share, 0.0).reshape(-1))
        acc = acc.reshape(txy_m.shape)
        rows = _push(acc.transpose(-1, -2), txy_m.transpose(-1, -2),
                     tx_m.transpose(-1, -2), ky).transpose(-1, -2)
        grad = _push(rows, tx_m, xp, kx)
        return grad[:, :, :h, :w], None, None, None, None, None


def _roi_pool_infer(op, block):
    x, rois = in_var(op, block, "X"), in_var(op, block, "ROIs")
    set_output(op, block, "Out", (rois.shape[0], x.shape[1],
                                  int(op.attrs["pooled_height"]),
                                  int(op.attrs["pooled_width"])), x.dtype)


def _bins(lo, extent, n_bins, size):
    """[R, n_bins] first and past-the-end pixels of each bin along one
    axis, clipped to [0, size): bin j spans lo + floor(j * e / n) to lo +
    ceil((j + 1) * e / n), at least one pixel before the clip."""
    step = extent * _recip(n_bins)                     # [R]
    j = torch.arange(n_bins, device=lo.device, dtype=torch.float32)[None]
    start = lo[:, None] + torch.floor(j * step[:, None])
    end = lo[:, None] + torch.ceil((j + 1) * step[:, None])
    end = torch.maximum(end, start + 1)
    return (torch.clamp(start, 0, size).long(),
            torch.clamp(end, 0, size).long())


def _roi_pool_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    rois = ins["ROIs"][0].to(torch.float32)
    rb = optional(ins, "RoisBatch")
    bidx = rb.long() if rb is not None else torch.zeros(
        rois.shape[0], dtype=torch.long, device=x.device)
    ph, pw = int(attrs["pooled_height"]), int(attrs["pooled_width"])
    scale = float(attrs.get("spatial_scale", 1.0))
    h, w = x.shape[2], x.shape[3]
    x1, y1, x2, y2 = (torch.round(rois[:, i] * scale) for i in range(4))
    y0, y_end = _bins(y1, torch.clamp_min(y2 - y1 + 1, 1.0), ph, h)
    x0, x_end = _bins(x1, torch.clamp_min(x2 - x1 + 1, 1.0), pw, w)
    out = _RegionMax.apply(x, bidx, y0[:, :, None], y_end[:, :, None],
                           x0[:, None, :], x_end[:, None, :])
    return {"Out": out.to(x.dtype)}


register_op("roi_pool", ["X", "ROIs", "RoisBatch"], ["Out"],
            infer=_roi_pool_infer, compute=_roi_pool_compute,
            no_grad_inputs=("ROIs", "RoisBatch"), keep_graph=True)


# -- polygon_box_transform --------------------------------------------------

def _pbt_compute(ins, attrs, ctx, op_index):
    """Even channels: column - x; odd channels: row - x."""
    x = ins["X"][0]
    c, h, w = x.shape[1:]
    cols = torch.arange(w, device=x.device, dtype=x.dtype)
    rows = torch.arange(h, device=x.device, dtype=x.dtype)
    even = (torch.arange(c, device=x.device) % 2 == 0)[:, None, None]
    base = torch.where(even, cols[None, None, :].expand(c, h, w),
                       rows[None, :, None].expand(c, h, w))
    return {"Out": base[None] - x}


register_op("polygon_box_transform", ["X"], ["Out"],
            infer=lambda op, block: set_output(
                op, block, "Out", in_var(op, block, "X").shape,
                in_var(op, block, "X").dtype),
            compute=_pbt_compute, grad=None)


# -- mine_hard_examples -----------------------------------------------------

def _mine_hard_infer(op, block):
    m = in_var(op, block, "MatchIndices")
    set_output(op, block, "NegIndices", m.shape, "int32")
    set_output(op, block, "NegCount", (m.shape[0],), "int32")
    set_output(op, block, "UpdatedMatchIndices", m.shape, "int32")


def _mine_hard_compute(ins, attrs, ctx, op_index):
    """``max_negative``: the unmatched priors under the distance threshold
    with the largest classification losses, num_pos * ratio of them;
    ``hard_example``: the ``sample_size`` largest cls + loc losses, the
    unmined matched priors losing their match.  ``NegIndices`` holds each
    image's mined prior ids ascending, -1 padded, ``NegCount`` their
    number."""
    cls_loss = ins["ClsLoss"][0]
    match, mdist = ins["MatchIndices"][0], ins["MatchDist"][0]
    mining = attrs.get("mining_type", "max_negative")
    if mining not in ("max_negative", "hard_example"):
        raise ValueError("mine_hard_examples: unknown mining_type %r"
                         % mining)
    n, p = match.shape
    dev = match.device
    unmatched = match == -1
    if mining == "hard_example":
        sample_size = int(attrs.get("sample_size") or 0)
        if sample_size <= 0:
            raise ValueError(
                "mine_hard_examples: mining_type='hard_example' needs "
                "sample_size > 0 (mine_hard_examples_op.cc enforces it)")
        eligible = torch.ones_like(unmatched)
        loc = optional(ins, "LocLoss")
        loss = cls_loss + loc if loc is not None else cls_loss
        num_neg = torch.full((n,), min(sample_size, p), dtype=torch.int32,
                             device=dev)
    else:
        eligible = unmatched & (mdist < float(attrs.get(
            "neg_dist_threshold", 0.5)))
        loss = cls_loss
        num_pos = (~unmatched).sum(1, dtype=torch.int32)
        num_neg = torch.minimum(
            (num_pos.to(torch.float32) * float(attrs.get(
                "neg_pos_ratio", 3.0))).to(torch.int32),
            eligible.sum(1, dtype=torch.int32))
    rank = _rank(_stable_desc(torch.where(eligible, loss, _BIG_NEG)))
    hard = eligible & (rank < num_neg[:, None])
    if mining == "hard_example":
        updated = torch.where(~unmatched & ~hard, -1, match)
        sel = hard & unmatched
        num_out = sel.sum(1, dtype=torch.int32)
    else:
        updated, sel, num_out = match, hard, num_neg
    pos = torch.where(sel, torch.cumsum(sel.long(), 1) - 1, p)
    rows = torch.arange(n, device=dev)[:, None].expand(n, p)
    ids = torch.arange(p, device=dev, dtype=torch.int32)[None].expand(n, p)
    neg = torch.full((n, p + 1), -1, dtype=torch.int32, device=dev) \
        .index_put((rows, pos), ids)[:, :p]
    return {"NegIndices": neg, "NegCount": num_out.to(torch.int32),
            "UpdatedMatchIndices": updated.to(torch.int32)}


register_op("mine_hard_examples",
            ["ClsLoss", "LocLoss", "MatchIndices", "MatchDist"],
            ["NegIndices", "NegCount", "UpdatedMatchIndices"],
            infer=_mine_hard_infer, compute=_mine_hard_compute, grad=None)


# -- generate_proposals -----------------------------------------------------

def _gen_proposals_infer(op, block):
    s = in_var(op, block, "Scores")
    post = int(op.attrs.get("post_nms_topN", 1000))
    set_output(op, block, "RpnRois", (s.shape[0], post, 4), "float32",
               lod_level=1)
    set_output(op, block, "RpnRoiProbs", (s.shape[0], post, 1), "float32")
    set_output(op, block, "RpnRoisLength", (s.shape[0],), "int32")


def generate_proposals(scores, deltas, im_info, anchors, variances, attrs):
    """scores [B, A], deltas [B, A, 4] in the anchors' order: the top
    ``pre_nms_topN`` scores' boxes decoded on their anchors, clipped to
    the image, tiny ones dropped, NMS, the best ``post_nms_topN``."""
    pre_n = int(attrs.get("pre_nms_topN", 6000))
    post_n = int(attrs.get("post_nms_topN", 1000))
    min_size = float(attrs.get("min_size", 0.1))
    b, a = scores.shape
    k = min(pre_n, a)
    top, idx = top_k_first_index(scores, k)                 # [B, k]
    anc, var = anchors[idx], variances[idx]                 # [B, k, 4]
    d = _take_rows(deltas, idx) * var
    aw = anc[..., 2] - anc[..., 0] + 1.0
    ah = anc[..., 3] - anc[..., 1] + 1.0
    cx = d[..., 0] * aw + (anc[..., 0] + aw / 2)
    cy = d[..., 1] * ah + (anc[..., 1] + ah / 2)
    w = torch.exp(torch.clamp_max(d[..., 2], 10.0)) * aw
    h = torch.exp(torch.clamp_max(d[..., 3], 10.0)) * ah
    img_h, img_w = im_info[:, 0, None], im_info[:, 1, None]
    zero = torch.zeros_like(cx)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi - 1.0)

    boxes = torch.stack([clip(cx - w / 2, img_w), clip(cy - h / 2, img_h),
                         clip(cx + w / 2 - 1.0, img_w),
                         clip(cy + h / 2 - 1.0, img_h)], dim=-1)
    scale = im_info[:, 2, None]
    big = ((boxes[..., 2] - boxes[..., 0] + 1.0 >= min_size * scale)
           & (boxes[..., 3] - boxes[..., 1] + 1.0 >= min_size * scale))
    eff = torch.where(big, top, _BIG_NEG)
    order = _stable_desc(eff)
    keep_sorted = nms_keep(_take_rows(boxes, order),
                           torch.gather(eff, 1, order) > _BIG_NEG / 2,
                           float(attrs.get("nms_thresh", 0.5)), False,
                           float(attrs.get("eta", 1.0)))
    keep = torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)
    n_out = min(post_n, k)
    sel_scores, sel = top_k_first_index(torch.where(keep, eff, _BIG_NEG),
                                        n_out)
    valid = sel_scores > _BIG_NEG / 2
    rois = torch.where(valid[..., None], _take_rows(boxes, sel), 0.0)
    probs = torch.where(valid, sel_scores, 0.0)[..., None]
    if n_out < post_n:
        pad = post_n - n_out
        rois = torch.cat([rois, rois.new_zeros((b, pad, 4))], 1)
        probs = torch.cat([probs, probs.new_zeros((b, pad, 1))], 1)
    return rois, probs, valid.sum(1).to(torch.int32)


def _gen_proposals_compute(ins, attrs, ctx, op_index):
    """Scores [B, A_total] / deltas [B, A_total, 4] in the anchors' order
    ((H, W, A)-major), or the conv head's NCHW [B, A, H, W] / [B, 4A, H,
    W], transposed to that order here."""
    scores, deltas = ins["Scores"][0], ins["BboxDeltas"][0]
    if scores.dim() == 4:
        scores = scores.permute(0, 2, 3, 1).reshape(scores.shape[0], -1)
    elif scores.dim() != 2:
        raise ValueError(
            "generate_proposals: scores must be [B, A_total] "
            "(anchor-flattening order) or NCHW [B, A, H, W]; got ndim=%d"
            % scores.dim())
    if deltas.dim() == 4:
        b_, c4, hh, ww = deltas.shape
        deltas = deltas.reshape(b_, c4 // 4, 4, hh, ww) \
            .permute(0, 3, 4, 1, 2).reshape(b_, -1, 4)
    elif deltas.dim() != 3:
        raise ValueError(
            "generate_proposals: bbox_deltas must be [B, A_total, 4] or "
            "NCHW [B, 4A, H, W]; got ndim=%d" % deltas.dim())
    rois, probs, count = generate_proposals(
        scores, deltas, ins["ImInfo"][0], ins["Anchors"][0].reshape(-1, 4),
        ins["Variances"][0].reshape(-1, 4), attrs)
    return {"RpnRois": rois, "RpnRoiProbs": probs, "RpnRoisLength": count}


register_op("generate_proposals",
            ["Scores", "BboxDeltas", "ImInfo", "Anchors", "Variances"],
            ["RpnRois", "RpnRoiProbs", "RpnRoisLength"],
            infer=_gen_proposals_infer, compute=_gen_proposals_compute,
            grad=None)


# -- rpn_target_assign ------------------------------------------------------

def _rpn_assign_infer(op, block):
    a, g = in_var(op, block, "Anchor"), in_var(op, block, "GtBoxes")
    b = g.shape[0] if len(g.shape) == 3 else 1
    dims = list(a.shape[:-1])
    n = None if any(d in (None, -1) for d in dims) else int(np.prod(dims))
    set_output(op, block, "ScoreLabels", (b, n), "int32")
    set_output(op, block, "TargetBBox", (b, n, 4), "float32")
    set_output(op, block, "BBoxWeight", (b, n, 1), "float32")


def _encode_unnormalized(anchors, boxes, weights=None):
    """(dx, dy, log dw, log dh) of ``boxes`` against ``anchors`` (pixel
    boxes, corners inclusive)."""
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    gw = boxes[..., 2] - boxes[..., 0] + 1.0
    gh = boxes[..., 3] - boxes[..., 1] + 1.0
    dx = (boxes[..., 0] + 0.5 * gw - (anchors[..., 0] + 0.5 * aw)) / aw
    dy = (boxes[..., 1] + 0.5 * gh - (anchors[..., 1] + 0.5 * ah)) / ah
    if weights is None:
        return torch.stack([dx, dy, torch.log(gw / aw),
                            torch.log(gh / ah)], -1)
    t = torch.stack([dx, dy, torch.log(torch.clamp_min(gw / aw, 1e-10)),
                     torch.log(torch.clamp_min(gh / ah, 1e-10))], -1)
    return t * device_constant(np.asarray([_recip(v) for v in weights],
                                          np.float32), t.device)


def _rpn_assign_compute(ins, attrs, ctx, op_index):
    """Per anchor: fg if it is some ground truth's best anchor or overlaps
    one by ``rpn_positive_overlap``; bg under ``rpn_negative_overlap``;
    the first fg_fraction * batch_size_per_im fg and the first of the
    rest bg in anchor order; -1 elsewhere.  The targets encode each fg
    anchor's best ground truth."""
    anchors = ins["Anchor"][0].reshape(-1, 4)
    gt = ins["GtBoxes"][0]
    if gt.dim() == 2:
        gt = gt[None]
    b, g = gt.shape[:2]
    gt_len = optional(ins, "GtLength")
    if gt_len is None:
        gt_len = torch.full((b,), g, dtype=torch.int32, device=gt.device)
    per_im = int(attrs.get("rpn_batch_size_per_im", 256))
    gt_valid = (torch.arange(g, device=gt.device)[None]
                < gt_len.long()[:, None])[:, None, :]
    iou = torch.where(gt_valid, iou_matrix(anchors, gt, False), 0.0)
    best_val, best_gt = torch.max(iou, dim=2)                # [B, A]
    per_gt = iou.amax(1, keepdim=True)                       # [B, 1, G]
    is_best = ((iou == per_gt) & (iou > 0) & gt_valid).any(2)
    fg = is_best | (best_val >= float(attrs.get("rpn_positive_overlap",
                                                0.7)))
    bg = ~fg & (best_val < float(attrs.get("rpn_negative_overlap", 0.3)))
    fg = fg & (torch.cumsum(fg.int(), 1) - 1 < int(
        float(attrs.get("rpn_fg_fraction", 0.5)) * per_im))
    n_fg = fg.sum(1, keepdim=True)
    bg = bg & (torch.cumsum(bg.int(), 1) - 1 < per_im - n_fg)
    labels = torch.where(fg, 1, torch.where(bg, 0, -1)).to(torch.int32)
    tgt = _encode_unnormalized(anchors[None], _take_rows(gt, best_gt))
    return {"ScoreLabels": labels,
            "TargetBBox": torch.where(fg[..., None], tgt, 0.0),
            "BBoxWeight": fg.to(torch.float32)[..., None]}


register_op("rpn_target_assign", ["Anchor", "GtBoxes", "GtLength"],
            ["ScoreLabels", "TargetBBox", "BBoxWeight"],
            infer=_rpn_assign_infer, compute=_rpn_assign_compute, grad=None)


# -- generate_proposal_labels -----------------------------------------------

def _gpl_infer(op, block):
    rois = in_var(op, block, "RpnRois")
    b, s = rois.shape[0], int(op.attrs["batch_size_per_im"])
    if op.attrs.get("class_nums") is None:
        raise ValueError(
            "generate_proposal_labels: class_nums is required (the number "
            "of detection classes incl. background)")
    c = int(op.attrs["class_nums"])
    set_output(op, block, "Rois", (b, s, 4), "float32", lod_level=1)
    set_output(op, block, "LabelsInt32", (b, s, 1), "int32")
    for slot in ("BboxTargets", "BboxInsideWeights", "BboxOutsideWeights"):
        set_output(op, block, slot, (b, s, 4 * c), "float32")
    set_output(op, block, "RoisNum", (b,), "int32")


def _gpl_compute(ins, attrs, ctx, op_index):
    """Each image's ground truths, then its proposals (in the image's
    scale): fg over ``fg_thresh`` (crowd ground truths never), bg in
    [bg_thresh_lo, bg_thresh_hi); up to fg_fraction * batch_size_per_im
    fg and the rest bg, ranked by a uniform draw (``use_random``) or
    taken in order; fg rows first, then bg, then zero padding, with the
    regression targets of each fg row in its class's four columns."""
    rois, gt_cls = ins["RpnRois"][0], ins["GtClasses"][0]
    crowd, gt = ins["IsCrowd"][0], ins["GtBoxes"][0]
    im_info = ins["ImInfo"][0]
    b, r = rois.shape[:2]
    g = gt.shape[1]
    dev = rois.device
    s = int(attrs["batch_size_per_im"])
    c = int(attrs["class_nums"])
    fg_frac = float(attrs.get("fg_fraction", 0.25))
    roi_len, gt_len = optional(ins, "RpnRoisLength"), optional(ins, "GtLength")
    if roi_len is None:
        roi_len = torch.full((b,), r, dtype=torch.int32, device=dev)
    if gt_len is None:
        gt_len = torch.full((b,), g, dtype=torch.int32, device=dev)
    p = g + r
    gt_valid = torch.arange(g, device=dev)[None] < gt_len.long()[:, None]
    roi_valid = torch.arange(r, device=dev)[None] < roi_len.long()[:, None]
    im_scale = im_info[:, 2]
    boxes = torch.cat([gt, rois / im_scale[:, None, None]], 1)  # [B, P, 4]
    box_valid = torch.cat([gt_valid, roi_valid], 1)
    iou = torch.where(gt_valid[:, None, :] & box_valid[:, :, None],
                      iou_matrix(boxes, gt, False), 0.0)
    max_ov, gt_ind = torch.max(iou, dim=2)
    crowd_row = torch.cat([(crowd > 0) & gt_valid,
                           torch.zeros_like(roi_valid)], 1)
    max_ov = torch.where(crowd_row, -1.0, max_ov)
    fg = box_valid & (max_ov > float(attrs.get("fg_thresh", 0.25)))
    bg = box_valid & ~fg & (max_ov >= float(attrs.get("bg_thresh_lo", 0.0))) \
        & (max_ov < float(attrs.get("bg_thresh_hi", 0.5)))
    if bool(attrs.get("use_random", True)):
        order = torch.rand((b, p), generator=ctx.generator, device=dev)
    else:
        order = (torch.arange(p, device=dev, dtype=torch.float32)
                 * _recip(p))[None].expand(b, p)
    fg_sel = fg & (_rank(torch.sort(torch.where(fg, order, 2.0), dim=1,
                                    stable=True).indices)
                   < int(np.floor(s * fg_frac)))
    n_fg = fg_sel.sum(1, keepdim=True)
    bg_sel = bg & (_rank(torch.sort(torch.where(bg, order, 2.0), dim=1,
                                    stable=True).indices) < s - n_fg)
    n_bg = bg_sel.sum(1, keepdim=True)
    slot = torch.where(fg_sel, torch.cumsum(fg_sel.long(), 1) - 1,
                       torch.where(bg_sel, n_fg + torch.cumsum(
                           bg_sel.long(), 1) - 1, s))
    rows = torch.arange(b, device=dev)[:, None].expand(b, p)

    def place(vals, fill_shape):
        buf = vals.new_zeros((b, s + 1) + fill_shape)
        return buf.index_put((rows, slot), vals)[:, :s]

    smp_boxes = place(boxes, (4,))
    labels = place(torch.where(fg_sel, torch.gather(gt_cls.to(
        torch.int32), 1, gt_ind), 0), ())
    smp_gts = place(_take_rows(gt, gt_ind), (4,))
    deltas = _encode_unnormalized(smp_boxes, smp_gts, list(attrs.get(
        "bbox_reg_weights", [1.0, 1.0, 1.0, 1.0])))
    is_fg = (labels > 0)[..., None]
    col = torch.where(is_fg, 4 * labels.long()[..., None] + torch.arange(
        4, device=dev), 4 * c)                              # [B, S, 4]
    bi = torch.arange(b, device=dev)[:, None, None].expand(col.shape)
    si = torch.arange(s, device=dev)[None, :, None].expand(col.shape)

    def spread(vals):
        buf = vals.new_zeros((b, s, 4 * c + 1))
        return buf.index_put((bi, si, col), vals)[..., :4 * c]

    targets = spread(torch.where(is_fg, deltas, 0.0))
    inside = spread(is_fg.to(torch.float32).expand(b, s, 4))
    return {"Rois": smp_boxes * im_scale[:, None, None],
            "LabelsInt32": labels[..., None], "BboxTargets": targets,
            "BboxInsideWeights": inside, "BboxOutsideWeights": inside.clone(),
            "RoisNum": (n_fg + n_bg)[:, 0].to(torch.int32)}


register_op("generate_proposal_labels",
            ["RpnRois", "RpnRoisLength", "GtClasses", "IsCrowd", "GtBoxes",
             "GtLength", "ImInfo"],
            ["Rois", "LabelsInt32", "BboxTargets", "BboxInsideWeights",
             "BboxOutsideWeights", "RoisNum"],
            infer=_gpl_infer, compute=_gpl_compute, grad=None,
            stateful_random=True)


# -- roi_perspective_transform ----------------------------------------------

def _roi_persp_infer(op, block):
    x, rois = in_var(op, block, "X"), in_var(op, block, "ROIs")
    set_output(op, block, "Out", (
        rois.shape[0], x.shape[1], int(op.attrs.get("transformed_height", 1)),
        int(op.attrs.get("transformed_width", 1))), x.dtype)


def _persp_matrix(rx, ry, th, tw):
    """The projective map of output (w, h) to source coordinates of each
    quadrilateral (rx, ry [R, 4]), as ``get_transform_matrix``."""
    x0, x1, x2, x3 = rx.unbind(1)
    y0, y1, y2, y3 = ry.unbind(1)
    len1 = torch.sqrt((x0 - x1) ** 2 + (y0 - y1) ** 2)
    len2 = torch.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2)
    len3 = torch.sqrt((x2 - x3) ** 2 + (y2 - y3) ** 2)
    len4 = torch.sqrt((x3 - x0) ** 2 + (y3 - y0) ** 2)
    est_h, est_w = (len2 + len4) / 2.0, (len1 + len3) / 2.0
    norm_w = torch.clamp_max(torch.round(
        est_w * (th - 1) / torch.clamp_min(est_h, 1e-6)) + 1.0, float(tw))
    rh = _recip(th - 1)
    dx1, dx2, dx3 = x1 - x2, x3 - x2, x0 - x1 + x2 - x3
    dy1, dy2, dy3 = y1 - y2, y3 - y2, y0 - y1 + y2 - y3
    den = dx1 * dy2 - dx2 * dy1
    den = torch.where(torch.abs(den) < 1e-10, 1e-10, den)
    m6 = (dx3 * dy2 - dx2 * dy3) / den / (norm_w - 1)
    m7 = (dx1 * dy3 - dx3 * dy1) / den * rh
    m3 = (y1 - y0 + m6 * (norm_w - 1) * y1) / (norm_w - 1)
    m4 = (y3 - y0 + m7 * (th - 1) * y3) * rh
    m0 = (x1 - x0 + m6 * (norm_w - 1) * x1) / (norm_w - 1)
    m1 = (x3 - x0 + m7 * (th - 1) * x3) * rh
    return m0, m1, x0, m3, m4, y0, m6, m7


def _in_quad(px, py, rx, ry):
    """On an edge of the quadrilateral, or an odd number of ray crossings
    (``in_quad``); px, py [R, th, tw]."""
    eps = 1e-4
    on_edge = torch.zeros_like(px, dtype=torch.bool)
    n_cross = torch.zeros_like(px, dtype=torch.int32)
    for i in range(4):
        xs, ys = rx[:, i, None, None], ry[:, i, None, None]
        xe, ye = rx[:, (i + 1) % 4, None, None], ry[:, (i + 1) % 4, None,
                                                    None]
        horiz = torch.abs(ys - ye) < eps
        on_h = (torch.abs(py - ys) < eps) & (torch.abs(py - ye) < eps) & \
            (px >= torch.minimum(xs, xe) - eps) & \
            (px <= torch.maximum(xs, xe) + eps)
        ix = (py - ys) * (xe - xs) / torch.where(horiz, 1.0, ye - ys) + xs
        on_v = (torch.abs(ix - px) < eps) & \
            (py >= torch.minimum(ys, ye) - eps) & \
            (py <= torch.maximum(ys, ye) + eps)
        on_edge = on_edge | torch.where(horiz, on_h, on_v)
        in_span = ~(py <= torch.minimum(ys, ye) + eps) & \
            ~(py - torch.maximum(ys, ye) > eps)
        n_cross = n_cross + (~horiz & in_span & (ix - px > eps)).int()
    return on_edge | (n_cross % 2 == 1)


def _bilinear(x, im, in_w, in_h):
    """Bilinear samples of x [N, C, H, W] at (in_w, in_h) [R, th, tw] of
    image ``im`` [R] -> [R, C, th, tw]; 0 outside the map (the reference's
    boundary rules)."""
    h, w = x.shape[2], x.shape[3]
    oob = (in_w < -0.5) | (in_w > w - 0.5) | (in_h < -0.5) | \
        (in_h > h - 0.5)
    iw, ih = torch.clamp_min(in_w, 0.0), torch.clamp_min(in_h, 0.0)
    wf, hf = torch.floor(iw), torch.floor(ih)
    right, bottom = wf >= w - 1, hf >= h - 1
    wf = torch.where(right, float(w - 1), wf)
    hf = torch.where(bottom, float(h - 1), hf)
    iw = torch.where(right, wf, iw)
    ih = torch.where(bottom, hf, ih)
    wc = torch.where(right, wf, wf + 1)
    hc = torch.where(bottom, hf, hf + 1)
    fw, fh = (iw - wf)[:, None], (ih - hf)[:, None]
    b = im[:, None, None]

    def at(hh, ww):
        hh = torch.clamp(hh, 0, h - 1).long()
        ww = torch.clamp(ww, 0, w - 1).long()
        return x[b, :, hh, ww].permute(0, 3, 1, 2)          # [R, C, th, tw]

    val = (1 - fw) * (1 - fh) * at(hf, wf) + (1 - fw) * fh * at(hc, wf) + \
        fw * fh * at(hc, wc) + (1 - fh) * fw * at(hf, wc)
    return torch.where(oob[:, None], 0.0, val)


def _roi_persp_compute(ins, attrs, ctx, op_index):
    x, rois = ins["X"][0], ins["ROIs"][0]
    scale = float(attrs.get("spatial_scale", 1.0))
    th = int(attrs.get("transformed_height", 1))
    tw = int(attrs.get("transformed_width", 1))
    im = optional(ins, "RoisImageId")
    im = im.reshape(-1).long() if im is not None else torch.zeros(
        rois.shape[0], dtype=torch.long, device=x.device)
    out_w = torch.arange(tw, device=x.device, dtype=x.dtype)[None, None, :]
    out_h = torch.arange(th, device=x.device, dtype=x.dtype)[None, :, None]
    rx, ry = rois[:, 0::2] * scale, rois[:, 1::2] * scale
    m0, m1, m2, m3, m4, m5, m6, m7 = (
        v[:, None, None] for v in _persp_matrix(rx, ry, th, tw))
    wq = m6 * out_w + m7 * out_h + 1.0
    in_w = (m0 * out_w + m1 * out_h + m2) / wq
    in_h = (m3 * out_w + m4 * out_h + m5) / wq
    inside = _in_quad(in_w, in_h, rx, ry)
    vals = _bilinear(x, im, in_w, in_h)
    return {"Out": torch.where(inside[:, None], vals, 0.0)}


register_op("roi_perspective_transform", ["X", "ROIs", "RoisImageId"],
            ["Out"], infer=_roi_persp_infer, compute=_roi_persp_compute,
            no_grad_inputs=("ROIs", "RoisImageId"))
