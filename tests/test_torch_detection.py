"""The detection op family held against the JAX package on the CPU: each
of its 14 op types as one-op programs (``test_torch_plain_ops.one_op``)
and the layers of ``layers/detection.py`` as programs built in both
packages.

The programs serialize alike; integer, bool and index outputs agree by
value, floats within rtol 1e-5, gradients (``roi_pool``,
``roi_perspective_transform``) within relative L2 1e-5.  The cases plant
the ties that SSD's priors make common: equal scores in NMS (broken by
the lower (class, box) index, as ``lax.top_k``), in ``mine_hard_examples``
(by the lower prior id, as the stable ``argsort``), equal entries in
``bipartite_match`` (the first in row-major order), tied maxima in
``roi_pool`` (the gradient split among them, as ``jnp.max``'s); NMS with
``nms_top_k`` < M against the JAX op's loop over all M boxes; adaptive
NMS; out-of-range and -1 indices in ``target_assign``; RoIs past the map
and bins whose edges fall on the float32 reciprocal.
``generate_proposal_labels`` with ``use_random`` is held by its counts
and by every pick lying in its eligible set.  No op reads a value on the
host but the constants the box generators make once (a device constant on
the card)."""

import numpy as np
import pytest

import paddle_tpu as fluid

import paddle_tpu_torch as pt

import chip_smoke as cs
from test_torch_capture import host_read_guard  # noqa: F401
from test_torch_plain_ops import _same_values, one_op, rel_l2
from test_torch_rnn import rand
from test_torch_serving import fresh_torch_programs  # noqa: F401


def _case(op_type, inputs, attrs=None, outputs=None, diff=(), id=None):
    return pytest.param(op_type, inputs, attrs or {}, outputs or {"Out": 1},
                        diff, id=id or op_type)


def boxes(rng, *lead, scale=1.0, min_wh=0.05, max_wh=0.4):
    """Random (x1, y1, x2, y2) boxes, float32, in [0, scale]."""
    xy = rng.rand(*lead, 2) * (1 - max_wh)
    wh = min_wh + rng.rand(*lead, 2) * (max_wh - min_wh)
    return (np.concatenate([xy, xy + wh], -1) * scale).astype("float32")


NMS_OUTS = {"Out": 1, "OutLength": 1}
GP_OUTS = {"RpnRois": 1, "RpnRoiProbs": 1, "RpnRoisLength": 1}
GPL_OUTS = {s: 1 for s in ("Rois", "LabelsInt32", "BboxTargets",
                           "BboxInsideWeights", "BboxOutsideWeights",
                           "RoisNum")}


def _nms_inputs(rng, b=2, m=30, c=4):
    bb = boxes(rng, b, m)
    bb[:, 10:20] = bb[:, :10] + 0.01          # heavy overlaps
    sc = np.round(rng.rand(b, c, m), 1).astype("float32")   # ties
    return bb, sc


def _rpn_inputs(rng, h=4, w=5, a=3):
    anchors = np.zeros((h, w, a, 4), "float32")
    cx = (np.arange(w) * 16 + 7.5)[None, :, None]
    cy = (np.arange(h) * 16 + 7.5)[:, None, None]
    half = np.asarray([8.0, 16.0, 24.0], "float32")[None, None, :a]
    anchors[..., 0] = cx - half
    anchors[..., 1] = cy - half
    anchors[..., 2] = cx + half
    anchors[..., 3] = cy + half
    return anchors


def _cases():
    rng = np.random.RandomState(0)
    b3 = boxes(rng, 2, 5)
    prior = boxes(rng, 7)
    var = np.tile(np.asarray([[0.1, 0.1, 0.2, 0.2]], "float32"), (7, 1))
    dist = np.round(rng.rand(2, 3, 6), 1).astype("float32")
    dist[0, :, 2] = dist[0, 0, 2]            # a column of equal entries
    dist[1, 1] = 0.0                          # an empty row
    gt_rows = rand(rng, 2, 3, 4)
    match = np.asarray([[0, -1, 2, 1, -1, 0], [-1, -1, 1, 1, 0, -1]],
                       "int32")
    neg = np.asarray([[1, 4, -1, -1], [0, 5, 9, -1]], "int32")
    bb, sc = _nms_inputs(rng)
    feat = rand(rng, 2, 3, 10, 12)
    rois = np.asarray([[0, 0, 9, 9], [2, 3, 15, 11], [-4, -2, 3, 30],
                       [1, 1, 1, 1], [5.6, 2.4, 27.2, 18.5],
                       [30, 30, 40, 40]], "float32")
    roi_batch = np.asarray([0, 1, 1, 0, 1, 0], "int64")
    cls_loss = (np.round(rng.rand(2, 12) * 3) / 3).astype("float32")
    m_idx = np.where(rng.rand(2, 12) < 0.25, rng.randint(0, 3, (2, 12)),
                     -1).astype("int32")
    m_dist = rng.rand(2, 12).astype("float32")
    anchors = _rpn_inputs(rng)
    a_total = anchors.shape[0] * anchors.shape[1] * anchors.shape[2]
    im_info = np.asarray([[64, 80, 1.0], [60, 70, 2.0]], "float32")
    gt_px = boxes(rng, 2, 4, scale=60.0, min_wh=0.1, max_wh=0.5)
    quads = np.asarray([[1, 1, 8, 2, 9, 7, 2, 8], [0, 0, 11, 0, 11, 9, 0, 9],
                        [3, 2, 6, 1, 7, 5, 2, 6]], "float32")
    return [
        _case("iou_similarity", {"X": b3[0], "Y": prior}),
        _case("iou_similarity", {"X": b3, "Y": prior}, id="iou_batched"),
        _case("iou_similarity", {"X": b3, "Y": b3[::-1].copy()},
              id="iou_batched_pairs"),
        _case("prior_box", {"Input": rand(rng, 1, 2, 3, 4),
                            "Image": rand(rng, 1, 3, 30, 40)},
              {"min_sizes": [4.0, 9.0], "max_sizes": [8.0, 15.0],
               "aspect_ratios": [2.0, 3.0], "flip": True, "clip": True,
               "variances": [0.1, 0.1, 0.2, 0.2], "step_w": 0.0,
               "step_h": 0.0, "offset": 0.5},
              outputs={"Boxes": 1, "Variances": 1}),
        _case("prior_box", {"Input": rand(rng, 1, 2, 3, 4),
                            "Image": rand(rng, 1, 3, 30, 40)},
              {"min_sizes": [6.0], "max_sizes": [12.0],
               "aspect_ratios": [2.0], "flip": False,
               "step_w": 9.0, "step_h": 11.0, "offset": 0.3,
               "min_max_aspect_ratios_order": True},
              outputs={"Boxes": 1, "Variances": 1},
              id="prior_box_minmax_order_steps"),
        _case("anchor_generator", {"Input": rand(rng, 1, 2, 3, 4)},
              {"anchor_sizes": [32.0, 64.0], "aspect_ratios": [0.5, 1.0,
                                                              2.0],
               "stride": [16.0, 16.0], "offset": 0.5},
              outputs={"Anchors": 1, "Variances": 1}),
        _case("box_coder", {"TargetBox": b3[0], "PriorBox": prior,
                            "PriorBoxVar": var},
              {"code_type": "encode_center_size"},
              outputs={"OutputBox": 1}),
        _case("box_coder", {"TargetBox": rand(rng, 5, 7, 4, scale=0.3),
                            "PriorBox": prior, "PriorBoxVar": var},
              {"code_type": "decode_center_size"},
              outputs={"OutputBox": 1}, id="box_coder_decode"),
        _case("box_coder", {"TargetBox": b3[0] * 50, "PriorBox": prior * 50},
              {"code_type": "encode_center_size", "box_normalized": False},
              outputs={"OutputBox": 1}, id="box_coder_pixels_no_var"),
        _case("bipartite_match", {"DistMat": dist},
              outputs={"ColToRowMatchIndices": 1, "ColToRowMatchDist": 1}),
        _case("bipartite_match", {"DistMat": dist},
              {"match_type": "per_prediction", "dist_threshold": 0.3},
              outputs={"ColToRowMatchIndices": 1, "ColToRowMatchDist": 1},
              id="bipartite_match_per_prediction"),
        _case("bipartite_match", {"DistMat": dist[0]},
              outputs={"ColToRowMatchIndices": 1, "ColToRowMatchDist": 1},
              id="bipartite_match_2d"),
        _case("target_assign", {"X": gt_rows, "MatchIndices": match},
              {"mismatch_value": -7}, outputs={"Out": 1, "OutWeight": 1}),
        _case("target_assign", {"X": rand(rng, 2, 3, 6, 4),
                                "MatchIndices": match, "NegIndices": neg},
              outputs={"Out": 1, "OutWeight": 1}, id="target_assign_4d_neg"),
        _case("target_assign", {"X": rng.randint(0, 9, (2, 3, 1)).astype(
            "int64"), "MatchIndices": match, "NegIndices": neg},
            {"mismatch_value": 0}, outputs={"Out": 1, "OutWeight": 1},
            id="target_assign_labels"),
        _case("multiclass_nms", {"BBoxes": bb, "Scores": sc},
              {"score_threshold": 0.15, "nms_top_k": -1,
               "nms_threshold": 0.3, "keep_top_k": 25,
               "background_label": 0}, outputs=NMS_OUTS),
        _case("multiclass_nms", {"BBoxes": bb, "Scores": sc},
              {"score_threshold": 0.05, "nms_top_k": 8,
               "nms_threshold": 0.45, "keep_top_k": 20,
               "background_label": 1}, outputs=NMS_OUTS,
              id="multiclass_nms_top_k_lt_m"),
        _case("multiclass_nms", {"BBoxes": bb, "Scores": sc},
              {"score_threshold": 0.05, "nms_top_k": 6,
               "nms_threshold": 0.5, "keep_top_k": -1, "nms_eta": 0.7,
               "background_label": -1}, outputs=NMS_OUTS,
              id="multiclass_nms_adaptive_all_kept_rows"),
        _case("multiclass_nms", {"BBoxes": bb * 40, "Scores": sc},
              {"score_threshold": 0.0, "nms_top_k": 12, "keep_top_k": 200,
               "nms_threshold": 0.3, "normalized": False},
              outputs=NMS_OUTS, id="multiclass_nms_pixels_padded"),
        _case("roi_pool", {"X": feat, "ROIs": rois, "RoisBatch": roi_batch},
              {"pooled_height": 3, "pooled_width": 2,
               "spatial_scale": 0.5}, diff=("X",)),
        _case("roi_pool", {"X": feat, "ROIs": rois * 2},
              {"pooled_height": 7, "pooled_width": 7,
               "spatial_scale": 0.5}, diff=("X",), id="roi_pool_7x7"),
        # post-ReLU-like maps of a few levels: most bins hold tied maxima,
        # whose gradient jnp.max splits equally
        _case("roi_pool", {"X": np.maximum(np.round(feat * 1.5), 0).astype(
            "float32"), "ROIs": rois, "RoisBatch": roi_batch},
            {"pooled_height": 3, "pooled_width": 4, "spatial_scale": 0.5},
            diff=("X",), id="roi_pool_tied_maxima"),
        _case("polygon_box_transform", {"X": rand(rng, 2, 4, 3, 5)}),
        _case("mine_hard_examples", {"ClsLoss": cls_loss,
                                     "MatchIndices": m_idx,
                                     "MatchDist": m_dist},
              {"neg_pos_ratio": 2.0, "neg_dist_threshold": 0.5,
               "mining_type": "max_negative"},
              outputs={"NegIndices": 1, "NegCount": 1,
                       "UpdatedMatchIndices": 1}),
        _case("mine_hard_examples", {"ClsLoss": cls_loss,
                                     "LocLoss": np.round(rng.rand(2, 12),
                                                         1).astype(
                                         "float32"),
                                     "MatchIndices": m_idx,
                                     "MatchDist": m_dist},
              {"mining_type": "hard_example", "sample_size": 5},
              outputs={"NegIndices": 1, "NegCount": 1,
                       "UpdatedMatchIndices": 1},
              id="mine_hard_examples_hard_example"),
        _case("generate_proposals", {
            "Scores": np.round(rng.rand(2, a_total), 2).astype("float32"),
            "BboxDeltas": rand(rng, 2, a_total, 4, scale=0.3),
            "ImInfo": im_info, "Anchors": anchors,
            "Variances": np.full_like(anchors, 1.0)},
            {"pre_nms_topN": 30, "post_nms_topN": 12, "nms_thresh": 0.5,
             "min_size": 4.0}, outputs=GP_OUTS),
        _case("generate_proposals", {
            "Scores": rand(rng, 2, 3, 4, 5),
            "BboxDeltas": rand(rng, 2, 12, 4, 5, scale=0.3),
            "ImInfo": im_info, "Anchors": anchors,
            "Variances": np.full_like(anchors, 0.5)},
            {"pre_nms_topN": 50, "post_nms_topN": 80, "nms_thresh": 0.7,
             "min_size": 0.1, "eta": 0.8}, outputs=GP_OUTS,
            id="generate_proposals_nchw_padded_eta"),
        _case("rpn_target_assign", {
            "Anchor": anchors, "GtBoxes": gt_px,
            "GtLength": np.asarray([4, 2], "int32")},
            {"rpn_batch_size_per_im": 16, "rpn_fg_fraction": 0.25,
             "rpn_positive_overlap": 0.5, "rpn_negative_overlap": 0.3},
            outputs={"ScoreLabels": 1, "TargetBBox": 1, "BBoxWeight": 1}),
        _case("rpn_target_assign", {"Anchor": anchors.reshape(-1, 4),
                                    "GtBoxes": gt_px[0]},
              outputs={"ScoreLabels": 1, "TargetBBox": 1, "BBoxWeight": 1},
              id="rpn_target_assign_unbatched"),
        _case("generate_proposal_labels", {
            "RpnRois": boxes(rng, 2, 20, scale=60.0, min_wh=0.1,
                             max_wh=0.5),
            "RpnRoisLength": np.asarray([20, 14], "int32"),
            "GtClasses": np.asarray([[1, 3, 2, 1], [2, 2, 0, 0]], "int32"),
            "IsCrowd": np.asarray([[0, 0, 1, 0], [0, 0, 0, 0]], "int32"),
            "GtBoxes": gt_px, "GtLength": np.asarray([4, 2], "int32"),
            "ImInfo": im_info},
            {"batch_size_per_im": 10, "fg_fraction": 0.3, "fg_thresh": 0.4,
             "bg_thresh_hi": 0.4, "bg_thresh_lo": 0.0, "class_nums": 4,
             "bbox_reg_weights": [0.1, 0.1, 0.2, 0.2],
             "use_random": False}, outputs=GPL_OUTS),
        _case("roi_perspective_transform", {
            "X": rand(rng, 2, 3, 10, 12), "ROIs": quads,
            "RoisImageId": np.asarray([0, 1, 1], "int64")},
            {"transformed_height": 4, "transformed_width": 5,
             "spatial_scale": 1.0}, diff=("X",)),
        _case("roi_perspective_transform", {
            "X": rand(rng, 1, 2, 12, 14), "ROIs": quads * 2},
            {"transformed_height": 3, "transformed_width": 6,
             "spatial_scale": 0.5}, diff=("X",),
            id="roi_perspective_transform_scaled"),
    ]


CASES = _cases()
TYPES = {c.values[0] for c in CASES}

# the box generators' per-prior sizes and variances and the regression
# weights are host constants made once (``ops/creation.device_constant``)
HOST_CONSTANTS = {(t, "torch.from_numpy") for t in (
    "prior_box", "anchor_generator", "generate_proposal_labels")}


def test_the_family_is_whole():
    assert len(TYPES) == 14


@pytest.mark.parametrize("op_type,inputs,attrs,outputs,diff", CASES)
def test_op_follows_jax(op_type, inputs, attrs, outputs, diff):
    want_prog, want, want_g = one_op(fluid, op_type, inputs, attrs,
                                     outputs, diff)
    got_prog, got, got_g = one_op(pt, op_type, inputs, attrs, outputs,
                                  diff)
    assert got_prog == want_prog
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if g.dtype.kind in "biu" or w.dtype.kind in "biu":
            assert _same_values(g, w), (i, g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg="output %d" % i)
    assert len(got_g) == len(want_g)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        assert rel_l2(g, w) <= 1e-5, (i, rel_l2(g, w))


@pytest.mark.parametrize("op_type,inputs,attrs,outputs,diff", CASES)
def test_op_reads_nothing_on_the_host(host_read_guard, op_type, inputs,
                                      attrs, outputs, diff):
    one_op(pt, op_type, inputs, attrs, outputs, diff)
    assert set(host_read_guard) <= HOST_CONSTANTS, host_read_guard


def _by_id(name):
    (case,) = [c for c in CASES if c.id == name]
    return case.values


def test_planted_ties_are_real():
    """The tie cases hold what they claim: NMS scores equal across kept
    boxes, the mined losses equal at the cut, a bipartite column of equal
    entries."""
    _, (out, n), _ = one_op(pt, *_by_id("multiclass_nms"))
    kept = out[0, :n[0], 1]
    assert len(np.unique(kept)) < len(kept)
    args = _by_id("mine_hard_examples")
    loss = args[1]["ClsLoss"]
    assert len(np.unique(loss[0])) < loss.shape[1] // 2
    assert len(np.unique(_by_id("bipartite_match")[1]["DistMat"][0, :, 2])) \
        == 1


def test_nms_top_k_trips_equal_the_full_loop():
    """The port's NMS loops over the ``nms_top_k`` best boxes only; the
    JAX op over all M.  Raising ``nms_top_k`` to M in the port changes
    nothing past what the k best allow, and at k = M the two agree with
    the JAX op (held above); here the port's k-trip result equals the
    JAX op's all-M loop at every k."""
    bb, sc = _nms_inputs(np.random.RandomState(9), m=40)
    for k in (1, 5, 17, 40):
        attrs = {"score_threshold": 0.05, "nms_top_k": k,
                 "nms_threshold": 0.4, "keep_top_k": 60}
        _, want, _ = one_op(fluid, "multiclass_nms", {"BBoxes": bb,
                                                      "Scores": sc},
                            attrs, NMS_OUTS, ())
        _, got, _ = one_op(pt, "multiclass_nms", {"BBoxes": bb,
                                                  "Scores": sc},
                           attrs, NMS_OUTS, ())
        np.testing.assert_array_equal(got[0], want[0])
        assert _same_values(got[1], want[1])


def test_generate_proposal_labels_random_keeps_its_invariants():
    """With ``use_random``: programs equal, the fg and bg counts of each
    image those of the JAX op (they do not depend on the draw), every fg
    row a fg-eligible box with its class's targets, every bg row a
    bg-eligible box, zero padding after RoisNum; two seeds pick
    differently."""
    inputs, attrs = _by_id("generate_proposal_labels")[1:3]
    attrs = dict(attrs, use_random=True)
    want_prog, want, _ = one_op(fluid, "generate_proposal_labels", inputs,
                                attrs, GPL_OUTS, (), seed=1)
    got_prog, got, _ = one_op(pt, "generate_proposal_labels", inputs,
                              attrs, GPL_OUTS, (), seed=1)
    _, other, _ = one_op(pt, "generate_proposal_labels", inputs, attrs,
                         GPL_OUTS, (), seed=2)
    assert got_prog == want_prog
    assert _same_values(got[5], want[5])
    counts = [[int((lab[:n] > 0).sum()), int((lab[:n] == 0).sum())]
              for lab, n in zip(want[1][..., 0], want[5])]
    assert cs.gpl_faults(inputs, attrs, got, counts) == []
    assert not np.array_equal(got[0], other[0])


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def detection_layers(pkg):
    """Every layer of ``layers/detection.py`` but ``ssd_loss``
    (``test_torch_srl_ssd.py``) in one program: a small SSD head
    (``multi_box_head``) decoded and NMS'd into ``detection_map``, and the
    Faster R-CNN layers over one feature map."""
    L = pkg.layers
    img = L.data("img", shape=[3, 32, 32])
    f1 = L.data("f1", shape=[4, 8, 8])
    f2 = L.data("f2", shape=[4, 4, 4])
    f3 = L.data("f3", shape=[4, 2, 2])
    loc, conf, box, var = L.multi_box_head(
        [f1, f2, f3], img, base_size=32, num_classes=3,
        aspect_ratios=[[2.0], [2.0, 3.0], [2.0]], min_ratio=20,
        max_ratio=90, flip=True, kernel_size=3, pad=1)
    decoded = L.box_coder(box, var, loc, code_type="decode_center_size")
    scores = L.transpose(L.softmax(conf), perm=[0, 2, 1])
    nms = L.detection_output(decoded, scores, score_threshold=0.01,
                             nms_top_k=20, nms_threshold=0.45, keep_top_k=10)
    gt = L.data("gt", shape=[3, 6])
    m = L.detection_map(nms, gt, class_num=3, ap_version="11point")
    gtb = L.data("gtb", shape=[3, 4])
    iou = L.iou_similarity(gtb, box)
    match, mdist = L.bipartite_match(iou, "per_prediction", 0.3)
    tgt, tw = L.target_assign(gtb, match, mismatch_value=0)
    neg, upd = L.mine_hard_examples(L.reduce_sum(L.square(loc), dim=2),
                                    match, mdist, neg_pos_ratio=1.0)
    poly = L.polygon_box_transform(f2)

    feat = L.data("feat", shape=[4, 4, 5])
    anchors, avar = L.anchor_generator(feat, anchor_sizes=[16.0, 32.0],
                                       aspect_ratios=[1.0, 2.0],
                                       stride=[8.0, 8.0])
    rpn_s = L.data("rpn_s", shape=[4, 4, 5])
    rpn_d = L.data("rpn_d", shape=[16, 4, 5])
    info = L.data("info", shape=[3])
    rois, probs = L.generate_proposals(rpn_s, rpn_d, info, anchors, avar,
                                       pre_nms_top_n=40, post_nms_top_n=10,
                                       nms_thresh=0.6, min_size=1.0)
    gt_px = L.data("gt_px", shape=[2, 4])
    labels, tbox, bw = L.rpn_target_assign(anchors, gt_px,
                                           rpn_batch_size_per_im=12)
    gt_cls = L.data("gt_cls", shape=[2], dtype="int32")
    crowd = L.data("crowd", shape=[2], dtype="int32")
    s_rois, s_lab, s_tgt, s_in, _ = L.generate_proposal_labels(
        rois, gt_cls, crowd, gt_px, info, batch_size_per_im=8,
        class_nums=3, use_random=False, fg_thresh=0.3)
    pooled = L.roi_pool(feat, L.reshape(s_rois, shape=[-1, 4]),
                        pooled_height=2, pooled_width=2,
                        spatial_scale=0.125)
    quads = L.data("quads", shape=[8], append_batch_size=True)
    warped = L.roi_perspective_transform(feat, quads, 2, 3,
                                         spatial_scale=0.25)
    return [loc, conf, box, var, decoded, nms, L.sequence_length(nms), m,
            match, mdist, tgt, tw, neg, upd, poly, anchors, rois, probs,
            labels, tbox, bw, s_rois, s_lab, s_tgt, s_in, pooled, warped]


def test_detection_layers_build_and_follow_jax():
    """The programs (main and startup) equal the JAX builder's, and from
    the JAX startup state every output agrees (integers by value)."""
    from test_torch_rnn import build_both, started_scopes

    rng = np.random.RandomState(4)
    gt = np.zeros((2, 3, 6), "float32")
    gt[..., 0] = [[1, 2, 1], [2, 2, 1]]
    gt[..., 1:5] = boxes(rng, 2, 3, min_wh=0.2, max_wh=0.5)
    feed = {"img": rand(rng, 2, 3, 32, 32), "f1": rand(rng, 2, 4, 8, 8),
            "f2": rand(rng, 2, 4, 4, 4), "f3": rand(rng, 2, 4, 2, 2),
            "gt": gt, "gtb": gt[..., 1:5].copy(),
            "feat": rand(rng, 2, 4, 4, 5), "rpn_s": rand(rng, 2, 4, 4, 5),
            "rpn_d": rand(rng, 2, 16, 4, 5, scale=0.2),
            "info": np.asarray([[32, 40, 1.0], [30, 38, 1.0]], "float32"),
            "gt_px": boxes(rng, 2, 2, scale=30.0, min_wh=0.2, max_wh=0.6),
            "gt_cls": np.asarray([[1, 2], [2, 1]], "int32"),
            "crowd": np.zeros((2, 2), "int32"),
            "quads": np.asarray([[1, 1, 14, 2, 15, 12, 2, 13],
                                 [0, 0, 19, 0, 19, 15, 0, 15]], "float32")}
    progs = build_both(detection_layers)
    for i in (0, 1):
        assert progs[pt][i].to_dict() == progs[fluid][i].to_dict()
    scopes = started_scopes(progs)
    outs = {}
    for pkg in (fluid, pt):
        main, _, fetch = progs[pkg]
        outs[pkg] = pkg.Executor(pkg.CPUPlace()).run(
            main, feed=feed, fetch_list=fetch, scope=scopes[pkg])
    for i, (g, w) in enumerate(zip(outs[pt], outs[fluid])):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype.kind in "biu" or w.dtype.kind in "biu":
            assert _same_values(g, w), i
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg="fetch %d" % i)
    assert int(np.asarray(outs[pt][6]).sum()) > 0


def test_multi_box_head_validation_follows_jax():
    """``multi_box_head``'s refusals are the JAX builder's."""
    for pkg in (fluid, pt):
        with pkg.program_guard(pkg.Program(), pkg.Program()):
            img = pkg.layers.data("img", shape=[3, 32, 32])
            f = pkg.layers.data("f", shape=[4, 8, 8])
            with pytest.raises(AssertionError):
                pkg.layers.multi_box_head([f, f], img, base_size=32,
                                          num_classes=3,
                                          aspect_ratios=[[2.0], [2.0]])
            with pytest.raises(ValueError):
                pkg.layers.multi_box_head([f, f, f], img, base_size=32,
                                          num_classes=3,
                                          aspect_ratios=[[2.0]],
                                          min_ratio=20, max_ratio=90)
