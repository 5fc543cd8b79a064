"""The detection layers (counterpart of ``paddle_tpu/layers/detection.py``):
``prior_box``, ``anchor_generator``, ``box_coder``, ``iou_similarity``,
``bipartite_match``, ``target_assign``, ``multiclass_nms`` (and its alias
``detection_output``), ``roi_pool``, ``polygon_box_transform``,
``mine_hard_examples``, the composite ``ssd_loss`` and ``multi_box_head``,
the Faster R-CNN layers and ``detection_map``.  They append the same ops
with the same attrs as the JAX package, so the programs serialize alike."""

from ..layer_helper import LayerHelper

__all__ = [
    "multi_box_head",
    "prior_box",
    "anchor_generator",
    "box_coder",
    "iou_similarity",
    "bipartite_match",
    "target_assign",
    "multiclass_nms",
    "detection_output",
    "roi_pool",
    "polygon_box_transform",
    "mine_hard_examples",
    "ssd_loss",
    "generate_proposals",
    "rpn_target_assign",
    "generate_proposal_labels",
    "roi_perspective_transform",
    "detection_map",
]


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=None,
              variance=None, flip=False, clip=False, steps=None,
              offset=0.5, min_max_aspect_ratios_order=False, name=None):
    """SSD prior boxes over a feature map (reference detection.py
    prior_box / prior_box_op.h).  Returns (boxes, variances), each
    [H, W, num_priors, 4]."""
    helper = LayerHelper("prior_box", input=input, name=name)
    boxes = helper.create_variable_for_type_inference("float32")
    variances = helper.create_variable_for_type_inference("float32")
    steps = steps or [0.0, 0.0]
    helper.append_op(
        type="prior_box", inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [boxes], "Variances": [variances]},
        attrs={"min_sizes": list(min_sizes),
               "max_sizes": list(max_sizes or []),
               "aspect_ratios": list(aspect_ratios or [1.0]),
               "variances": list(variance or [0.1, 0.1, 0.2, 0.2]),
               "flip": bool(flip), "clip": bool(clip),
               "step_w": float(steps[0]), "step_h": float(steps[1]),
               "offset": float(offset),
               "min_max_aspect_ratios_order":
                   bool(min_max_aspect_ratios_order)})
    for v in (boxes, variances):
        v.stop_gradient = True
    return boxes, variances


def anchor_generator(input, anchor_sizes, aspect_ratios, variance=None,
                     stride=None, offset=0.5, name=None):
    """RPN anchors (reference anchor_generator_op.h).  Returns
    (anchors, variances) [H, W, num_anchors, 4]."""
    helper = LayerHelper("anchor_generator", input=input, name=name)
    anchors = helper.create_variable_for_type_inference("float32")
    variances = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="anchor_generator", inputs={"Input": [input]},
        outputs={"Anchors": [anchors], "Variances": [variances]},
        attrs={"anchor_sizes": [float(s) for s in anchor_sizes],
               "aspect_ratios": [float(a) for a in aspect_ratios],
               "variances": list(variance or [0.1, 0.1, 0.2, 0.2]),
               "stride": [float(s) for s in (stride or [16.0, 16.0])],
               "offset": float(offset)})
    for v in (anchors, variances):
        v.stop_gradient = True
    return anchors, variances


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None):
    helper = LayerHelper("box_coder", input=target_box, name=name)
    out = helper.create_variable_for_type_inference("float32")
    inputs = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var]
    helper.append_op(
        type="box_coder", inputs=inputs, outputs={"OutputBox": [out]},
        attrs={"code_type": code_type,
               "box_normalized": bool(box_normalized)})
    return out


def iou_similarity(x, y, name=None):
    helper = LayerHelper("iou_similarity", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="iou_similarity", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    """Returns (match_indices [B, P] int32, match_dist [B, P]).
    ``match_type='per_prediction'`` additionally matches unmatched
    columns whose best dist >= ``dist_threshold`` (default 0.5)."""
    helper = LayerHelper("bipartite_match", input=dist_matrix, name=name)
    match = helper.create_variable_for_type_inference("int32")
    mdist = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="bipartite_match", inputs={"DistMat": [dist_matrix]},
        outputs={"ColToRowMatchIndices": [match],
                 "ColToRowMatchDist": [mdist]},
        attrs={"match_type": match_type or "bipartite",
               "dist_threshold": float(dist_threshold or 0.5)})
    match.stop_gradient = True
    mdist.stop_gradient = True
    return match, mdist


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=0, name=None):
    """Returns (out [B, P, K], out_weight [B, P, 1])."""
    helper = LayerHelper("target_assign", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out_weight = helper.create_variable_for_type_inference("float32")
    inputs = {"X": [input], "MatchIndices": [matched_indices]}
    if negative_indices is not None:
        inputs["NegIndices"] = [negative_indices]
    helper.append_op(
        type="target_assign", inputs=inputs,
        outputs={"Out": [out], "OutWeight": [out_weight]},
        attrs={"mismatch_value": int(mismatch_value)})
    out.stop_gradient = True
    out_weight.stop_gradient = True
    return out, out_weight


def multiclass_nms(bboxes, scores, score_threshold=0.0,
                   nms_top_k=-1, nms_threshold=0.3, keep_top_k=-1,
                   normalized=True, background_label=0, name=None):
    """Per-class NMS; returns detections [B, keep_top_k, 6]
    ((label, score, x1, y1, x2, y2), -1-labeled rows are padding) with
    a per-image count companion (sequence-length convention)."""
    helper = LayerHelper("multiclass_nms", input=bboxes, name=name)
    out = helper.create_variable_for_type_inference("float32")
    out_len = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="multiclass_nms",
        inputs={"BBoxes": [bboxes], "Scores": [scores]},
        outputs={"Out": [out], "OutLength": [out_len]},
        attrs={"score_threshold": float(score_threshold),
               "nms_top_k": int(nms_top_k),
               "nms_threshold": float(nms_threshold),
               "keep_top_k": int(keep_top_k),
               "normalized": bool(normalized),
               "background_label": int(background_label)})
    out.stop_gradient = True
    out._seq_len_name = out_len.name
    return out


detection_output = multiclass_nms  # reference alias: decode+nms tail


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, rois_batch=None, name=None):
    helper = LayerHelper("roi_pool", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_batch is not None:
        inputs["RoisBatch"] = [rois_batch]
    helper.append_op(
        type="roi_pool", inputs=inputs, outputs={"Out": [out]},
        attrs={"pooled_height": int(pooled_height),
               "pooled_width": int(pooled_width),
               "spatial_scale": float(spatial_scale)})
    return out


def polygon_box_transform(input, name=None):
    helper = LayerHelper("polygon_box_transform", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="polygon_box_transform",
                     inputs={"X": [input]}, outputs={"Out": [out]})
    return out


def mine_hard_examples(cls_loss, match_indices, match_dist, loc_loss=None,
                       neg_pos_ratio=3.0, neg_dist_threshold=0.5,
                       mining_type="max_negative", sample_size=None,
                       name=None):
    """Hard-negative mining (mine_hard_examples_op.cc, max_negative
    mode).  Returns (neg_indices [B, P] -1-padded, updated_match)."""
    helper = LayerHelper("mine_hard_examples", input=cls_loss, name=name)
    neg = helper.create_variable_for_type_inference("int32")
    neg_count = helper.create_variable_for_type_inference("int32")
    updated = helper.create_variable_for_type_inference("int32")
    inputs = {"ClsLoss": [cls_loss], "MatchIndices": [match_indices],
              "MatchDist": [match_dist]}
    if loc_loss is not None:
        inputs["LocLoss"] = [loc_loss]
    helper.append_op(
        type="mine_hard_examples", inputs=inputs,
        outputs={"NegIndices": [neg], "NegCount": [neg_count],
                 "UpdatedMatchIndices": [updated]},
        attrs={"neg_pos_ratio": float(neg_pos_ratio),
               "neg_dist_threshold": float(neg_dist_threshold),
               "mining_type": mining_type,
               "sample_size": int(sample_size or -1)})
    for v in (neg, neg_count, updated):
        v.stop_gradient = True
    # the count rides as neg's length companion (padded-array convention)
    neg._seq_len_name = neg_count.name
    return neg, updated


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0,
             overlap_threshold=0.5, neg_pos_ratio=3.0, neg_overlap=0.5,
             loc_loss_weight=1.0, conf_loss_weight=1.0,
             match_type="per_prediction", mining_type="max_negative",
             normalize=True, sample_size=None):
    """SSD multibox loss (reference detection.py:662 ssd_loss): match
    priors to ground truth, mine hard negatives, and combine smooth-L1
    localization loss with softmax confidence loss.

    Shapes (padded-batch convention): location [B, P, 4], confidence
    [B, P, C], gt_box [B, G, 4], gt_label [B, G, 1] (pad gt rows with
    boxes of zero area), prior_box [P, 4].  Returns the per-prior
    weighted loss [B, P, 1].
    """
    from .. import layers as L  # composite of existing layers/ops

    # 1. match: iou [B, G, P] -> per-prior matched gt row
    iou = iou_similarity(gt_box, prior_box)
    matched, match_dist = bipartite_match(iou, match_type,
                                          overlap_threshold)

    # 2. confidence targets for mining: background where unmatched
    tgt_label, _ = target_assign(gt_label, matched,
                                 mismatch_value=background_label)
    tgt_label = L.cast(tgt_label, "int64")
    mining_conf_loss = L.softmax_with_cross_entropy(confidence, tgt_label)

    # 3. hard-negative mining
    neg_indices, updated = mine_hard_examples(
        L.reshape(mining_conf_loss, shape=[0, -1]), matched, match_dist,
        neg_pos_ratio=neg_pos_ratio, neg_dist_threshold=neg_overlap,
        mining_type=mining_type, sample_size=sample_size)

    # 4. confidence loss weighted over positives + mined negatives
    # (reuses the mining pass's cross-entropy — same op, same inputs)
    _, conf_wt = target_assign(gt_label, matched,
                               negative_indices=neg_indices,
                               mismatch_value=background_label)
    conf_loss = L.elementwise_mul(mining_conf_loss, conf_wt)

    # 5. localization targets: encode gt against priors, gather matched
    gt_flat = L.reshape(gt_box, shape=[-1, 4])
    enc = box_coder(prior_box, prior_box_var, gt_flat,
                    "encode_center_size")           # [B*G, P, 4]
    enc = L.reshape(
        enc, shape=[-1, gt_box.shape[1], prior_box.shape[0], 4])
    loc_target, loc_wt = target_assign(enc, matched, mismatch_value=0)
    # per-prior smooth-L1 via clip identity: with m = clip(|d|, 0, 1),
    # 0.5*m^2 + (|d| - m) equals 0.5 d^2 for |d|<1 and |d|-0.5 beyond
    ad = L.abs(L.elementwise_sub(location, loc_target))
    m = L.clip(ad, min=0.0, max=1.0)
    sl1 = L.elementwise_add(
        L.scale(L.elementwise_mul(m, m), scale=0.5),
        L.elementwise_sub(ad, m))
    loc_loss = L.reduce_sum(sl1, dim=-1, keep_dim=True)
    loc_loss = L.elementwise_mul(loc_loss, loc_wt)

    loss = L.elementwise_add(L.scale(loc_loss, scale=loc_loss_weight),
                             L.scale(conf_loss, scale=conf_loss_weight))
    if normalize:
        num_matched = L.reduce_sum(loc_wt) + 1e-6
        loss = L.elementwise_div(loss, num_matched)
    return loss


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0, name=None):
    """RPN proposal generation (reference generate_proposals_op.cc):
    decode top-scoring anchor deltas, clip to the image, drop tiny
    boxes, NMS.  Returns (rois [B, post_n, 4], probs [B, post_n, 1])
    with the per-image count as rois' length companion.  ``eta`` < 1
    decays the NMS threshold after each kept box (adaptive NMS)."""
    helper = LayerHelper("generate_proposals", input=scores, name=name)
    rois = helper.create_variable_for_type_inference("float32")
    probs = helper.create_variable_for_type_inference("float32")
    count = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="generate_proposals",
        inputs={"Scores": [scores], "BboxDeltas": [bbox_deltas],
                "ImInfo": [im_info], "Anchors": [anchors],
                "Variances": [variances]},
        outputs={"RpnRois": [rois], "RpnRoiProbs": [probs],
                 "RpnRoisLength": [count]},
        attrs={"pre_nms_topN": int(pre_nms_top_n),
               "post_nms_topN": int(post_nms_top_n),
               "nms_thresh": float(nms_thresh),
               "min_size": float(min_size), "eta": float(eta)})
    for v in (rois, probs, count):
        v.stop_gradient = True
    rois._seq_len_name = count.name
    return rois, probs


def rpn_target_assign(anchor, gt_boxes, rpn_batch_size_per_im=256,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, gt_length=None,
                      name=None):
    """RPN training targets (reference rpn_target_assign_op.cc),
    static-shape form: per-anchor labels [B, A] (1 fg / 0 bg / -1
    ignore), encoded regression targets [B, A, 4], and fg weights
    [B, A, 1] — mask-based instead of the reference's index lists
    (deterministic first-k subsampling replaces reservoir sampling)."""
    helper = LayerHelper("rpn_target_assign", input=anchor, name=name)
    labels = helper.create_variable_for_type_inference("int32")
    tgt = helper.create_variable_for_type_inference("float32")
    weight = helper.create_variable_for_type_inference("float32")
    inputs = {"Anchor": [anchor], "GtBoxes": [gt_boxes]}
    if gt_length is not None:
        inputs["GtLength"] = [gt_length]
    helper.append_op(
        type="rpn_target_assign", inputs=inputs,
        outputs={"ScoreLabels": [labels], "TargetBBox": [tgt],
                 "BBoxWeight": [weight]},
        attrs={"rpn_batch_size_per_im": int(rpn_batch_size_per_im),
               "rpn_fg_fraction": float(rpn_fg_fraction),
               "rpn_positive_overlap": float(rpn_positive_overlap),
               "rpn_negative_overlap": float(rpn_negative_overlap)})
    for v in (labels, tgt, weight):
        v.stop_gradient = True
    return labels, tgt, weight


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.25,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None, use_random=True,
                             rpn_rois_length=None, gt_length=None):
    """Sample RoIs + classification/regression targets for Faster-RCNN
    training (reference detection.py:1401 /
    generate_proposal_labels_op.cc).  Padded-batch convention: inputs are
    [B, ...]; outputs carry a fixed ``batch_size_per_im`` rows per image
    with RoisNum as the valid-count companion.

    Returns (rois, labels_int32, bbox_targets, bbox_inside_weights,
    bbox_outside_weights)."""
    helper = LayerHelper("generate_proposal_labels", input=rpn_rois)
    rois = helper.create_variable_for_type_inference(rpn_rois.dtype)
    labels = helper.create_variable_for_type_inference("int32")
    targets = helper.create_variable_for_type_inference(rpn_rois.dtype)
    inside = helper.create_variable_for_type_inference(rpn_rois.dtype)
    outside = helper.create_variable_for_type_inference(rpn_rois.dtype)
    num = helper.create_variable_for_type_inference("int32")
    inputs = {"RpnRois": [rpn_rois], "GtClasses": [gt_classes],
              "IsCrowd": [is_crowd], "GtBoxes": [gt_boxes],
              "ImInfo": [im_info]}
    if rpn_rois_length is not None:
        inputs["RpnRoisLength"] = [rpn_rois_length]
    elif getattr(rpn_rois, "_seq_len_name", None):
        inputs["RpnRoisLength"] = [rpn_rois._seq_len_name]
    if gt_length is not None:
        inputs["GtLength"] = [gt_length]
    helper.append_op(
        type="generate_proposal_labels", inputs=inputs,
        outputs={"Rois": [rois], "LabelsInt32": [labels],
                 "BboxTargets": [targets], "BboxInsideWeights": [inside],
                 "BboxOutsideWeights": [outside], "RoisNum": [num]},
        attrs={"batch_size_per_im": batch_size_per_im,
               "fg_fraction": fg_fraction, "fg_thresh": fg_thresh,
               "bg_thresh_hi": bg_thresh_hi, "bg_thresh_lo": bg_thresh_lo,
               "bbox_reg_weights": list(bbox_reg_weights),
               "class_nums": class_nums, "use_random": use_random})
    for v in (rois, labels, targets, inside, outside, num):
        v.stop_gradient = True
    rois._seq_len_name = num.name
    return rois, labels, targets, inside, outside


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0,
                              rois_image_id=None):
    """Warp quadrilateral ROIs to rectangles (reference detection.py:1353
    / roi_perspective_transform_op.cc).  ``rois`` is [R, 8] corner
    coords; ``rois_image_id`` maps each ROI to its batch image (the LoD
    replacement; defaults to image 0)."""
    helper = LayerHelper("roi_perspective_transform", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_image_id is not None:
        inputs["RoisImageId"] = [rois_image_id]
    helper.append_op(
        type="roi_perspective_transform", inputs=inputs,
        outputs={"Out": [out]},
        attrs={"transformed_height": transformed_height,
               "transformed_width": transformed_width,
               "spatial_scale": spatial_scale})
    return out


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.3, evaluate_difficult=True,
                  has_state=None, input_states=None, out_states=None,
                  ap_version="integral", detect_res_length=None,
                  gt_length=None):
    """In-graph mean-average-precision (reference detection.py:399 /
    detection_map_op.h) over one mini-batch.  ``detect_res`` [B, D, 6]
    (label, score, x1..y2) with its count companion, ``label`` [B, G, 5|6]
    gt rows.  ``input_states``/``out_states`` (the reference's streaming
    accumulation, dynamic-length LoD state) are not supported in-graph —
    use ``metrics.DetectionMAP`` host-side for multi-batch accumulation.

    Returns the [1] mAP tensor."""
    if input_states is not None or out_states is not None or \
            has_state is not None:
        raise ValueError(
            "detection_map: in-graph streaming state is unsupported "
            "(variable-length state; see metrics.DetectionMAP)")
    helper = LayerHelper("detection_map", input=detect_res)
    m = helper.create_variable_for_type_inference("float32")
    pos = helper.create_variable_for_type_inference("int32")
    inputs = {"DetectRes": [detect_res], "Label": [label]}
    if detect_res_length is not None:
        inputs["DetectResLength"] = [detect_res_length]
    elif getattr(detect_res, "_seq_len_name", None):
        inputs["DetectResLength"] = [detect_res._seq_len_name]
    if gt_length is not None:
        inputs["GtLength"] = [gt_length]
    helper.append_op(
        type="detection_map", inputs=inputs,
        outputs={"MAP": [m], "AccumPosCount": [pos]},
        attrs={"class_num": class_num,
               "background_label": background_label,
               "overlap_threshold": overlap_threshold,
               "evaluate_difficult": evaluate_difficult,
               "ap_type": ap_version})
    m.stop_gradient = True
    return m


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=None, flip=True, clip=False,
                   kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD prediction head (reference detection.py:1015 multi_box_head):
    per feature map, prior boxes plus location/confidence convolutions;
    returns (mbox_loc [N, P, 4], mbox_conf [N, P, C],
    boxes [P, 4], variances [P, 4]) concatenated over all maps."""
    import math

    from .cnn import conv2d
    from .tensor import concat, reshape, transpose

    num_layer = len(inputs)
    if num_layer <= 2:
        assert min_sizes is not None and max_sizes is not None, (
            "min_sizes/max_sizes must be given for <=2 feature maps")
        assert len(min_sizes) == num_layer and len(max_sizes) == num_layer
    elif min_sizes is None and max_sizes is None:
        # the SSD paper's scale schedule from min_ratio..max_ratio
        min_sizes, max_sizes = [], []
        step = int(math.floor((max_ratio - min_ratio) / (num_layer - 2)))
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.10] + min_sizes
        max_sizes = [base_size * 0.20] + max_sizes

    def _per_layer(seq, what):
        if seq and len(seq) != num_layer:
            raise ValueError(
                "%s must have one entry per input (%d vs %d)"
                % (what, len(seq), num_layer))
    _per_layer(aspect_ratios, "aspect_ratios")
    _per_layer(step_h, "step_h")
    _per_layer(step_w, "step_w")
    _per_layer(steps, "steps")
    if steps:
        step_w = step_h = steps

    mbox_locs, mbox_confs, box_results, var_results = [], [], [], []
    for i, feat in enumerate(inputs):
        min_size = min_sizes[i]
        max_size = max_sizes[i]
        if not isinstance(min_size, (list, tuple)):
            min_size = [min_size]
        if not isinstance(max_size, (list, tuple)):
            max_size = [max_size]
        aspect_ratio = []
        if aspect_ratios is not None:
            aspect_ratio = aspect_ratios[i]
            if not isinstance(aspect_ratio, (list, tuple)):
                aspect_ratio = [aspect_ratio]
        step = [step_w[i] if step_w else 0.0,
                step_h[i] if step_h else 0.0]

        box, var = prior_box(
            feat, image, min_size, max_size, aspect_ratio, variance,
            flip, clip, step, offset,
            min_max_aspect_ratios_order=min_max_aspect_ratios_order)
        box_results.append(box)
        var_results.append(var)
        num_boxes = box.shape[2]

        loc = conv2d(feat, num_filters=num_boxes * 4,
                     filter_size=kernel_size, padding=pad, stride=stride)
        loc = transpose(loc, perm=[0, 2, 3, 1])
        mbox_locs.append(reshape(loc, shape=[0, -1, 4]))

        conf = conv2d(feat, num_filters=num_boxes * num_classes,
                      filter_size=kernel_size, padding=pad, stride=stride)
        conf = transpose(conf, perm=[0, 2, 3, 1])
        mbox_confs.append(reshape(conf, shape=[0, -1, num_classes]))

    if num_layer == 1:
        box, var = box_results[0], var_results[0]
        mbox_locs_concat, mbox_confs_concat = mbox_locs[0], mbox_confs[0]
    else:
        box = concat([reshape(b, shape=[-1, 4]) for b in box_results])
        var = concat([reshape(v, shape=[-1, 4]) for v in var_results])
        mbox_locs_concat = concat(mbox_locs, axis=1)
        mbox_confs_concat = concat(mbox_confs, axis=1)
    box.stop_gradient = True
    var.stop_gradient = True
    return mbox_locs_concat, mbox_confs_concat, box, var
