"""Detection layer APIs: the SSD family and the Faster R-CNN / RPN
family (port of ``paddle_tpu/layers/detection.py``; parity with
python/paddle/fluid/layers/detection.py): prior_box, multi_box_head,
bipartite_match, target_assign, detection_output, ssd_loss,
iou_similarity, box_coder, polygon_box_transform, multiclass_nms,
anchor_generator, rpn_target_assign, generate_proposals,
generate_proposal_labels and detection_map.

As in the reference, the SSD training path (ssd_loss) is one fused op,
and the Faster R-CNN path is fixed-shape: where Paddle emits
variable-length LoD outputs, these pad to static budgets with
zero-gradient filler. The cross-batch mAP accumulates on the host in
``evaluator.DetectionMAP`` / ``metrics.DetectionMAP`` from the
per-batch MatchInfo and GTCount of ``detection_map``.
"""
from ..layer_helper import LayerHelper
from . import nn
from . import tensor as tensor_layers

__all__ = ["prior_box", "multi_box_head", "bipartite_match",
           "target_assign", "detection_output", "ssd_loss",
           "iou_similarity", "box_coder", "polygon_box_transform",
           "multiclass_nms", "anchor_generator", "rpn_target_assign",
           "generate_proposals", "generate_proposal_labels",
           "detection_map"]


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.3, evaluate_difficult=True,
                  has_state=None, input_states=None, out_states=None,
                  ap_version="integral"):
    """Minibatch VOC mAP (reference detection.py detection_map).
    detect_res: dense [B, keep_top_k, 6] multiclass_nms output; label:
    lod_level-1 gt rows [label, x1, y1, x2, y2] or — 6-wide, matching
    the reference detection_map_op.h GetBoxes layout — [label,
    is_difficult, x1, y1, x2, y2]. The reference's cross-batch
    accumulator states are host-side here — stream the per-batch value
    through evaluator.DetectionMAP / metrics.DetectionMAP."""
    if has_state is not None or input_states or out_states:
        import warnings
        warnings.warn(
            "detection_map: in-graph accumulator states are not "
            "supported — cross-batch accumulation is host-side; "
            "use evaluator.DetectionMAP / metrics.DetectionMAP (the "
            "MatchInfo/GTCount outputs carry the per-batch TP/FP data)")
    helper = LayerHelper("detection_map")
    m_ap = helper.create_variable_for_type_inference(
        "float32", shape=[], stop_gradient=True)
    b = detect_res.shape[0] if detect_res.shape else -1
    k = detect_res.shape[1] if len(detect_res.shape) > 1 else -1
    match_info = helper.create_variable_for_type_inference(
        "float32", shape=[b * k if b > 0 and k > 0 else -1, 4],
        stop_gradient=True)
    gt_count = helper.create_variable_for_type_inference(
        "int32", shape=[class_num], stop_gradient=True)
    helper.append_op(
        type="detection_map",
        inputs={"DetectRes": [detect_res.name], "Label": [label.name]},
        outputs={"MAP": [m_ap.name], "MatchInfo": [match_info.name],
                 "GTCount": [gt_count.name]},
        attrs={"class_num": class_num,
               "background_label": background_label,
               "overlap_threshold": overlap_threshold,
               "evaluate_difficult": evaluate_difficult,
               "ap_version": ap_version})
    # evaluator.DetectionMAP fetches these to accumulate the dataset mAP
    m_ap.match_info = match_info
    m_ap.gt_count = gt_count
    return m_ap


def iou_similarity(x, y, name=None):
    """Pairwise IoU between two box sets ([M,4] x [N,4] -> [M,N], or
    batched [B,M,4])."""
    helper = LayerHelper("iou_similarity", name=name)
    m = x.shape[-2]
    n = y.shape[-2]
    shape = list(x.shape[:-2]) + [m, n]
    out = helper.create_variable_for_type_inference(x.dtype, shape=shape)
    helper.append_op(type="iou_similarity",
                     inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]})
    return out


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None):
    helper = LayerHelper("box_coder", name=name)
    out = helper.create_variable_for_type_inference(
        target_box.dtype, shape=target_box.shape)
    inputs = {"PriorBox": [prior_box.name], "TargetBox": [target_box.name]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var.name]
    helper.append_op(type="box_coder", inputs=inputs,
                     outputs={"OutputBox": [out.name]},
                     attrs={"code_type": code_type,
                            "box_normalized": box_normalized})
    return out


def polygon_box_transform(input, name=None):
    helper = LayerHelper("polygon_box_transform", name=name)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=input.shape)
    helper.append_op(type="polygon_box_transform",
                     inputs={"Input": [input.name]},
                     outputs={"Output": [out.name]})
    return out


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None,
              min_max_aspect_ratios_order=False):
    """SSD prior boxes over a conv feature map (reference detection.py
    prior_box). Returns (boxes [H*W*P, 4], variances [H*W*P, 4])."""
    helper = LayerHelper("prior_box", name=name)
    min_sizes = list(min_sizes)
    max_sizes = list(max_sizes or [])
    ars = list(aspect_ratios)
    num_ar = 1 + sum(2 if flip and abs(a - 1.0) > 1e-6 else
                     (0 if abs(a - 1.0) < 1e-6 else 1) for a in ars)
    num_priors = len(min_sizes) * num_ar + len(max_sizes)
    h = input.shape[2] if input.shape[2] > 0 else -1
    w = input.shape[3] if input.shape[3] > 0 else -1
    n = h * w * num_priors if h > 0 and w > 0 else -1
    boxes = helper.create_variable_for_type_inference("float32",
                                                      shape=[n, 4])
    var = helper.create_variable_for_type_inference("float32",
                                                    shape=[n, 4])
    helper.append_op(type="prior_box",
                     inputs={"Input": [input.name], "Image": [image.name]},
                     outputs={"Boxes": [boxes.name],
                              "Variances": [var.name]},
                     attrs={"min_sizes": min_sizes, "max_sizes": max_sizes,
                            "aspect_ratios": ars, "flip": flip,
                            "clip": clip, "variances": list(variance),
                            "step_w": steps[0], "step_h": steps[1],
                            "offset": offset,
                            "min_max_aspect_ratios_order":
                                min_max_aspect_ratios_order})
    boxes.stop_gradient = True
    var.stop_gradient = True
    return boxes, var


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    helper = LayerHelper("bipartite_match", name=name)
    b = dist_matrix.shape[0] if dist_matrix.ndim == 3 else 1
    n = dist_matrix.shape[-1]
    match_indices = helper.create_variable_for_type_inference(
        "int32", shape=[b, n])
    match_dist = helper.create_variable_for_type_inference(
        dist_matrix.dtype, shape=[b, n])
    helper.append_op(type="bipartite_match",
                     inputs={"DistMat": [dist_matrix.name]},
                     outputs={"ColToRowMatchIndices": [match_indices.name],
                              "ColToRowMatchDist": [match_dist.name]},
                     attrs={"match_type": match_type or "bipartite",
                            "dist_threshold": dist_threshold or 0.5})
    return match_indices, match_dist


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=0, name=None):
    helper = LayerHelper("target_assign", name=name)
    b, n = matched_indices.shape[0], matched_indices.shape[1]
    k = input.shape[-1]
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=[b, n, k])
    out_weight = helper.create_variable_for_type_inference(
        "float32", shape=[b, n, 1])
    inputs = {"X": [input.name], "MatchIndices": [matched_indices.name]}
    if negative_indices is not None:
        inputs["NegIndices"] = [negative_indices.name]
    helper.append_op(type="target_assign",
                     inputs=inputs,
                     outputs={"Out": [out.name],
                              "OutWeight": [out_weight.name]},
                     attrs={"mismatch_value": mismatch_value})
    return out, out_weight


def multiclass_nms(bboxes, scores, background_label=0, score_threshold=0.0,
                   nms_top_k=400, nms_threshold=0.3, keep_top_k=200,
                   normalized=True, nms_eta=1.0, name=None):
    """Fixed-shape multiclass NMS: output [B, keep_top_k, 6] rows of
    [label, score, xmin, ymin, xmax, ymax], label -1 marking empty
    slots (the fixed-shape form of Paddle's variable-length LoD out)."""
    helper = LayerHelper("multiclass_nms", name=name)
    b = bboxes.shape[0]
    out = helper.create_variable_for_type_inference(
        bboxes.dtype, shape=[b, keep_top_k, 6])
    helper.append_op(type="multiclass_nms",
                     inputs={"BBoxes": [bboxes.name],
                             "Scores": [scores.name]},
                     outputs={"Out": [out.name]},
                     attrs={"background_label": background_label,
                            "score_threshold": score_threshold,
                            "nms_top_k": nms_top_k,
                            "nms_threshold": nms_threshold,
                            "keep_top_k": keep_top_k,
                            "normalized": normalized, "nms_eta": nms_eta})
    return out


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0):
    """Decode predicted offsets against priors, then multiclass NMS
    (reference detection.py detection_output). loc [B, Np, 4];
    scores [B, Np, C] raw class scores."""
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    sm = nn.softmax(scores)
    sm_t = nn.transpose(sm, perm=[0, 2, 1])          # [B, C, Np]
    return multiclass_nms(decoded, sm_t, background_label=background_label,
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k, nms_threshold=nms_threshold,
                          keep_top_k=keep_top_k)


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True, sample_size=None):
    """SSD multibox loss (reference detection.py ssd_loss). One fused op:
    IoU match (bipartite + per-prediction), max-negative mining,
    smooth-L1 localization + softmax confidence loss. Returns the
    per-prior weighted loss [B, Np, 1]; reduce_sum it for the objective
    (already normalized by positive count when ``normalize``)."""
    if mining_type != "max_negative":
        raise ValueError("Only mining_type == 'max_negative' is supported")
    helper = LayerHelper("ssd_loss")
    b, np_, _ = location.shape
    out = helper.create_variable_for_type_inference(
        location.dtype, shape=[b, np_, 1])
    inputs = {"Location": [location.name], "Confidence": [confidence.name],
              "GTBox": [gt_box.name], "GTLabel": [gt_label.name],
              "PriorBox": [prior_box.name]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var.name]
    helper.append_op(type="ssd_loss", inputs=inputs,
                     outputs={"Loss": [out.name]},
                     attrs={"background_label": background_label,
                            "overlap_threshold": overlap_threshold,
                            "neg_pos_ratio": neg_pos_ratio,
                            "neg_overlap": neg_overlap,
                            "loc_loss_weight": loc_loss_weight,
                            "conf_loss_weight": conf_loss_weight,
                            "match_type": match_type,
                            "normalize": normalize})
    return out


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD prediction head over multiple feature maps (reference
    detection.py multi_box_head): per-map conv predictions for location
    and confidence + prior boxes, concatenated. Returns
    (mbox_locs [B, Np, 4], mbox_confs [B, Np, C], boxes [Np, 4],
    variances [Np, 4])."""
    if min_sizes is None:
        # derive per-map sizes from the ratio range like the reference
        num_layer = len(inputs)
        min_sizes, max_sizes = [], []
        if num_layer > 2:
            step = int((max_ratio - min_ratio) / (num_layer - 2))
            for ratio in range(min_ratio, max_ratio + 1, step):
                min_sizes.append(base_size * ratio / 100.0)
                max_sizes.append(base_size * (ratio + step) / 100.0)
            min_sizes = [base_size * 0.1] + min_sizes
            max_sizes = [base_size * 0.2] + max_sizes
        else:
            min_sizes = [base_size * 0.1, base_size * 0.2]
            max_sizes = [base_size * 0.2, base_size * 0.3]

    locs, confs, all_boxes, all_vars = [], [], [], []
    for i, feat in enumerate(inputs):
        mins = min_sizes[i]
        maxs = max_sizes[i] if max_sizes else None
        ar = aspect_ratios[i] if isinstance(aspect_ratios[i], (list, tuple)) \
            else [aspect_ratios[i]]
        step = [steps[i], steps[i]] if steps else \
            [step_w[i] if step_w else 0.0, step_h[i] if step_h else 0.0]
        boxes, var = prior_box(feat, image, [mins],
                               [maxs] if maxs else None, ar, variance,
                               flip, clip, step, offset,
                               min_max_aspect_ratios_order=
                               min_max_aspect_ratios_order)
        num_priors_per_cell = boxes.shape[0] // (feat.shape[2] *
                                                 feat.shape[3])
        n_map = boxes.shape[0]          # H*W*P, static (SSD maps are)
        num_loc = num_priors_per_cell * 4
        loc = nn.conv2d(feat, num_filters=num_loc,
                        filter_size=kernel_size, padding=pad, stride=stride)
        loc = nn.transpose(loc, perm=[0, 2, 3, 1])
        loc = nn.reshape(loc, shape=[-1, n_map, 4])
        num_conf = num_priors_per_cell * num_classes
        conf = nn.conv2d(feat, num_filters=num_conf,
                         filter_size=kernel_size, padding=pad, stride=stride)
        conf = nn.transpose(conf, perm=[0, 2, 3, 1])
        conf = nn.reshape(conf, shape=[-1, n_map, num_classes])
        locs.append(loc)
        confs.append(conf)
        all_boxes.append(boxes)
        all_vars.append(var)

    mbox_locs = tensor_layers.concat(locs, axis=1)
    mbox_confs = tensor_layers.concat(confs, axis=1)
    boxes = tensor_layers.concat(all_boxes, axis=0)
    variances = tensor_layers.concat(all_vars, axis=0)
    boxes.stop_gradient = True
    variances.stop_gradient = True
    return mbox_locs, mbox_confs, boxes, variances


# ---------------------------------------------------------------------------
# Faster-RCNN / RPN family (reference detection.py:58,1167,1259,1317)

def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=(0.1, 0.1, 0.2, 0.2), stride=None, offset=0.5,
                     name=None):
    """Anchors for Faster-RCNN over an NCHW feature map (reference
    detection.py anchor_generator). Returns (Anchors [H,W,A,4],
    Variances [H,W,A,4]), A = len(sizes) * len(ratios), ratios loop
    outermost like the reference."""
    helper = LayerHelper("anchor_generator", name=name)
    sizes = list(anchor_sizes) if isinstance(anchor_sizes, (list, tuple)) \
        else [anchor_sizes]
    ars = list(aspect_ratios) if isinstance(aspect_ratios, (list, tuple)) \
        else [aspect_ratios]
    if not isinstance(stride, (list, tuple)) or len(stride) != 2:
        raise ValueError("stride must be [stride_w, stride_h]")
    a = len(sizes) * len(ars)
    h = input.shape[2] if input.shape[2] > 0 else -1
    w = input.shape[3] if input.shape[3] > 0 else -1
    anchors = helper.create_variable_for_type_inference(
        "float32", shape=[h, w, a, 4])
    var = helper.create_variable_for_type_inference(
        "float32", shape=[h, w, a, 4])
    helper.append_op(type="anchor_generator",
                     inputs={"Input": [input.name]},
                     outputs={"Anchors": [anchors.name],
                              "Variances": [var.name]},
                     attrs={"anchor_sizes": [float(s) for s in sizes],
                            "aspect_ratios": [float(r) for r in ars],
                            "variances": list(variance),
                            "stride": [float(s) for s in stride],
                            "offset": offset})
    anchors.stop_gradient = True
    var.stop_gradient = True
    return anchors, var


def rpn_target_assign(loc, scores, anchor_box, anchor_var, gt_box,
                      rpn_batch_size_per_im=256, fg_fraction=0.25,
                      rpn_positive_overlap=0.7, rpn_negative_overlap=0.3):
    """RPN training targets (reference detection.py rpn_target_assign).

    loc [B,M,4], scores [B,M,1], anchor_box [M,4], gt_box a lod_level-1
    variable of per-image gt boxes. Returns (predicted_scores,
    predicted_location, target_label, target_bbox) like the reference,
    but fixed-shape: F = B * rpn_batch*fg_fraction loc rows, S = B *
    rpn_batch score rows; padding rows carry zero loss and gradient.
    """
    helper = LayerHelper("rpn_target_assign")
    b = loc.shape[0] if loc.shape[0] > 0 else 1
    n_fg = int(rpn_batch_size_per_im * fg_fraction)
    score_pred = helper.create_variable_for_type_inference(
        scores.dtype, shape=[b * rpn_batch_size_per_im, 1])
    loc_pred = helper.create_variable_for_type_inference(
        loc.dtype, shape=[b * n_fg, 4])
    score_tgt = helper.create_variable_for_type_inference(
        "int64", shape=[b * rpn_batch_size_per_im, 1])
    loc_tgt = helper.create_variable_for_type_inference(
        loc.dtype, shape=[b * n_fg, 4])
    helper.append_op(
        type="rpn_target_assign",
        inputs={"Loc": [loc.name], "Scores": [scores.name],
                "Anchor": [anchor_box.name], "GtBox": [gt_box.name]},
        outputs={"ScorePred": [score_pred.name],
                 "LocPred": [loc_pred.name],
                 "ScoreTarget": [score_tgt.name],
                 "LocTarget": [loc_tgt.name]},
        attrs={"rpn_batch_size_per_im": rpn_batch_size_per_im,
               "fg_fraction": fg_fraction,
               "rpn_positive_overlap": rpn_positive_overlap,
               "rpn_negative_overlap": rpn_negative_overlap})
    score_tgt.stop_gradient = True
    loc_tgt.stop_gradient = True
    return score_pred, loc_pred, score_tgt, loc_tgt


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0, name=None):
    """RPN proposals (reference detection.py generate_proposals): decode,
    clip, filter, NMS. Fixed-shape [B, post_nms_top_n, 4] RoIs with
    zero-padding (probs 0 mark empty slots)."""
    helper = LayerHelper("generate_proposals", name=name)
    b = scores.shape[0] if scores.shape[0] > 0 else -1
    rois = helper.create_variable_for_type_inference(
        bbox_deltas.dtype, shape=[b, post_nms_top_n, 4])
    probs = helper.create_variable_for_type_inference(
        scores.dtype, shape=[b, post_nms_top_n, 1])
    helper.append_op(
        type="generate_proposals",
        inputs={"Scores": [scores.name], "BboxDeltas": [bbox_deltas.name],
                "ImInfo": [im_info.name], "Anchors": [anchors.name],
                "Variances": [variances.name]},
        outputs={"RpnRois": [rois.name], "RpnRoiProbs": [probs.name]},
        attrs={"pre_nms_topN": pre_nms_top_n,
               "post_nms_topN": post_nms_top_n,
               "nms_thresh": nms_thresh, "min_size": min_size, "eta": eta})
    rois.stop_gradient = True
    probs.stop_gradient = True
    return rois, probs


def generate_proposal_labels(rpn_rois, gt_classes, gt_boxes, im_scales,
                             batch_size_per_im=256, fg_fraction=0.25,
                             fg_thresh=0.25, bg_thresh_hi=0.5,
                             bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None):
    """RoI sampling + per-class bbox targets for the RCNN head (reference
    detection.py generate_proposal_labels). rpn_rois [B, R, 4];
    gt_classes / gt_boxes lod_level-1 per-image variables; im_scales
    [B, 1]. Fixed-shape [B, batch_size_per_im, ...] outputs; padded RoIs
    have label -1 (mask them out of the classification loss) and zero
    bbox weights."""
    helper = LayerHelper("generate_proposal_labels")
    b = rpn_rois.shape[0] if rpn_rois.shape[0] > 0 else -1
    s = batch_size_per_im
    rois = helper.create_variable_for_type_inference(
        rpn_rois.dtype, shape=[b, s, 4])
    labels = helper.create_variable_for_type_inference(
        "int32", shape=[b, s])
    tgt = helper.create_variable_for_type_inference(
        rpn_rois.dtype, shape=[b, s, 4 * class_nums])
    w_in = helper.create_variable_for_type_inference(
        rpn_rois.dtype, shape=[b, s, 4 * class_nums])
    w_out = helper.create_variable_for_type_inference(
        rpn_rois.dtype, shape=[b, s, 4 * class_nums])
    helper.append_op(
        type="generate_proposal_labels",
        inputs={"RpnRois": [rpn_rois.name], "GtClasses": [gt_classes.name],
                "GtBoxes": [gt_boxes.name], "ImScales": [im_scales.name]},
        outputs={"Rois": [rois.name], "LabelsInt32": [labels.name],
                 "BboxTargets": [tgt.name],
                 "BboxInsideWeights": [w_in.name],
                 "BboxOutsideWeights": [w_out.name]},
        attrs={"batch_size_per_im": batch_size_per_im,
               "fg_fraction": fg_fraction, "fg_thresh": fg_thresh,
               "bg_thresh_hi": bg_thresh_hi, "bg_thresh_lo": bg_thresh_lo,
               "bbox_reg_weights": list(bbox_reg_weights),
               "class_nums": class_nums})
    for v in (rois, labels, tgt, w_in, w_out):
        v.stop_gradient = True
    return rois, labels, tgt, w_in, w_out
