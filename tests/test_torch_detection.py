"""The detection ops of the torch port (``ops/detection.py``, ``ops/eval_ops.py``
``detection_map``), their layers (``layers/detection.py``) and Faster
R-CNN (``models/faster_rcnn.py``) against the JAX package, whose rules
are fixed-shape XLA programs (``lax.scan`` matching and suppression,
``lax.top_k`` orders, ``jax.random`` samplers).

- Each rule on the same numpy inputs in both packages, every output
  compared whole and the float inputs' gradients through one random
  cotangent per output (torch_seq_common.py ``rule_pair``: forwards
  rtol 2e-4 / atol 2e-5, gradients rtol 2e-3 / atol 2e-4); integer
  outputs — match indices, NMS labels, sampled labels, mAP counts —
  exactly, and NMS rows and kept-box order exactly.
- The samplers draw from different generators in the two packages
  (``jax.random`` there, a seeded CPU ``torch.Generator`` here), so they
  are compared where the quotas do not bind (every candidate is
  picked, in index order), and held to their distribution where they
  do: the counts are min(quota, candidates), the picks a subset of the
  candidates, each candidate picked at the uniform rate.
- The reference's cases: the 13 of tests/test_detection.py (its
  ``warpctc`` case is in test_torch_crf_ctc.py), the 5 of
  tests/test_rpn.py, the two ``detection_map`` layer cases of
  tests/test_eval_ops.py (its dataset accumulation is in
  test_torch_metrics.py); then an SSD head through ``multi_box_head``,
  ``ssd_loss`` and ``detection_output``, Faster R-CNN's two SGD steps
  and its inference program against the reference, and both programs
  saved, loaded and served across the packages.
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import weights
from torch_seq_common import (FWD, GRAD, S, assert_same, build_both,
                              make_feed, port_rule, port_scope, program_pair,
                              reference_state, rule_pair, seqs)

torch.set_num_threads(1)


def _f(seed, *shape, lo=0.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _boxes(seed, *lead, lo=0.0, hi=1.0, wh=(0.1, 0.4)):
    """Random corner boxes [*lead, 4] inside [lo, hi]."""
    rng = np.random.RandomState(seed)
    span = hi - lo
    size = rng.uniform(wh[0], wh[1], lead + (2,)) * span
    xy = lo + rng.uniform(0, 1, lead + (2,)) * (span - size)
    return np.concatenate([xy, xy + size], -1).astype(np.float32)


def _anchors(h, w, sizes, ratios, stride=16.0):
    out = port_rule("anchor_generator",
                     {"Input": [np.zeros((1, 1, h, w), np.float32)]},
                     {"anchor_sizes": sizes, "aspect_ratios": ratios,
                      "stride": [stride, stride]})
    return out["Anchors"][0].numpy(), out["Variances"][0].numpy()


# ---------------------------------------------------------------------------
# each rule against the reference's
# ---------------------------------------------------------------------------
PRIOR = _boxes(10, 24)
PRIOR_VAR = np.tile(np.asarray([[0.1, 0.1, 0.2, 0.2]], np.float32), (24, 1))
GT = S(_boxes(11, 2, 3), np.asarray([2, 3], np.int64))
GT_LABEL = S(np.random.RandomState(12).randint(1, 3, (2, 3, 1)),
             np.asarray([2, 3], np.int64))
ANCH_GRID = np.stack(np.meshgrid(np.arange(8) * 20.0, np.arange(8) * 20.0),
                     -1).reshape(-1, 2).astype(np.float32)
GRID_ANCHORS = np.concatenate([ANCH_GRID, ANCH_GRID + 20], -1)   # [64, 4]
RPN_GT = S(np.asarray([[[22, 18, 61, 63], [0, 0, 0, 0]],
                       [[5, 5, 38, 44], [90, 100, 150, 130]]], np.float32),
           np.asarray([1, 2], np.int64))
ANCH_4x4, VAR_4x4 = _anchors(4, 4, [32.0, 64.0, 128.0], [1.0])
ANCH_16, VAR_16 = _anchors(16, 16, [32.0, 64.0, 128.0], [0.5, 1.0, 2.0])
SCORES_TIED = np.round(_f(21, 2, 4, 30) * 10) / 10
DETS = np.asarray(
    [[[1, 0.9, 0.1, 0.1, 0.4, 0.4], [2, 0.8, 0.5, 0.5, 0.9, 0.9],
      [1, 0.7, 0.12, 0.1, 0.42, 0.4], [3, 0.6, 0.0, 0.6, 0.3, 0.9],
      [1, 0.3, 0.6, 0.1, 0.9, 0.3], [-1, 0, 0, 0, 0, 0]],
     [[2, 0.95, 0.2, 0.2, 0.6, 0.6], [2, 0.5, 0.21, 0.2, 0.6, 0.62],
      [1, 0.4, 0.7, 0.7, 0.95, 0.95], [3, 0.35, 0.1, 0.5, 0.4, 0.8],
      [-1, 0, 0, 0, 0, 0], [-1, 0, 0, 0, 0, 0]]], np.float32)
GT5 = S(np.asarray([[[1, 0.1, 0.1, 0.4, 0.4], [2, 0.5, 0.5, 0.9, 0.9],
                     [3, 0.0, 0.6, 0.3, 0.9]],
                    [[2, 0.2, 0.2, 0.6, 0.6], [1, 0.7, 0.7, 0.95, 0.95],
                     [0, 0, 0, 0, 0]]], np.float32),
        np.asarray([3, 2], np.int64))
GT6 = S(np.asarray([[[1, 0, 0.1, 0.1, 0.4, 0.4], [2, 1, 0.5, 0.5, 0.9, 0.9],
                     [3, 0, 0.0, 0.6, 0.3, 0.9]],
                    [[2, 0, 0.2, 0.2, 0.6, 0.6], [1, 1, 0.7, 0.7, 0.95, 0.95],
                     [0, 0, 0, 0, 0, 0]]], np.float32),
        np.asarray([3, 2], np.int64))

RULES = {
    "iou_2d": ("iou_similarity", {"X": [_boxes(1, 5)], "Y": [_boxes(2, 7)]},
               {}, ("X", "Y")),
    "iou_batched_x": ("iou_similarity", {"X": [_boxes(1, 2, 5)],
                                         "Y": [_boxes(2, 7)]}, {}, ()),
    "iou_batched_y": ("iou_similarity", {"X": [_boxes(1, 5)],
                                         "Y": [_boxes(2, 2, 7)]}, {}, ()),
    "iou_batched_both": ("iou_similarity", {"X": [_boxes(1, 2, 5)],
                                            "Y": [_boxes(2, 2, 7)]}, {}, ()),
    "box_encode": ("box_coder", {"PriorBox": [PRIOR],
                                 "PriorBoxVar": [PRIOR_VAR],
                                 "TargetBox": [_boxes(3, 24)]},
                   {"code_type": "encode_center_size"}, ("TargetBox",)),
    "box_encode_novar": ("box_coder", {"PriorBox": [PRIOR],
                                       "TargetBox": [_boxes(3, 24)]},
                         {"code_type": "encode_center_size"}, ()),
    "box_decode_batched": ("box_coder", {
        "PriorBox": [PRIOR], "PriorBoxVar": [PRIOR_VAR],
        "TargetBox": [_f(4, 2, 24, 4, lo=-1, hi=1)]},
        {"code_type": "decode_center_size"}, ("TargetBox",)),
    "prior_box": ("prior_box", {"Input": [np.zeros((1, 8, 4, 4), np.float32)],
                                "Image": [np.zeros((1, 3, 32, 32),
                                                   np.float32)]},
                  {"min_sizes": [4.0], "max_sizes": [8.0],
                   "aspect_ratios": [2.0, 3.0], "flip": True, "clip": True},
                  ()),
    "prior_box_min_max_order": ("prior_box", {
        "Input": [np.zeros((1, 8, 3, 5), np.float32)],
        "Image": [np.zeros((1, 3, 30, 50), np.float32)]},
        {"min_sizes": [4.0, 9.0], "max_sizes": [8.0, 15.0],
         "aspect_ratios": [2.0], "flip": False,
         "min_max_aspect_ratios_order": True, "step_w": 9.0, "step_h": 11.0,
         "offset": 0.3}, ()),
    "bipartite": ("bipartite_match", {"DistMat": [_f(5, 2, 4, 7)]}, {}, ()),
    "bipartite_2d": ("bipartite_match", {"DistMat": [_f(6, 3, 5)]}, {}, ()),
    "per_prediction": ("bipartite_match", {"DistMat": [_f(7, 2, 4, 7)]},
                       {"match_type": "per_prediction",
                        "dist_threshold": 0.3}, ()),
    "target_assign": ("target_assign", {
        "X": [_f(8, 2, 3, 4)],
        "MatchIndices": [np.asarray([[2, -1, 0, 1, -1, 0],
                                     [-1, 1, 1, -1, 2, 0]], np.int32)]},
        {"mismatch_value": 7}, ("X",)),
    "target_assign_neg": ("target_assign", {
        "X": [_f(8, 2, 3, 4)],
        "MatchIndices": [np.asarray([[2, -1, 0, 1, -1, 0],
                                     [-1, 1, 1, -1, 2, 0]], np.int32)],
        "NegIndices": [np.asarray([[1, 4, -1], [0, 3, 5]], np.int32)]},
        {}, ("X",)),
    "nms": ("multiclass_nms", {"BBoxes": [_boxes(20, 2, 30)],
                               "Scores": [_f(21, 2, 4, 30)]},
            {"score_threshold": 0.05, "nms_threshold": 0.4,
             "nms_top_k": -1, "keep_top_k": 12}, ()),
    "nms_eta_pixels": ("multiclass_nms", {
        "BBoxes": [_boxes(22, 2, 30, hi=100.0)],
        "Scores": [_f(23, 2, 4, 30)]},
        {"score_threshold": 0.1, "nms_threshold": 0.7, "nms_top_k": 10,
         "keep_top_k": 16, "normalized": False, "nms_eta": 0.8,
         "background_label": 1}, ()),
    "nms_tied_scores": ("multiclass_nms", {"BBoxes": [_boxes(20, 2, 30)],
                                           "Scores": [SCORES_TIED]},
                        {"score_threshold": 0.05, "nms_threshold": 0.5,
                         "nms_top_k": 20, "keep_top_k": 25}, ()),
    "polygon_box_transform": ("polygon_box_transform",
                              {"Input": [_f(9, 2, 4, 3, 5)]}, {},
                              ("Input",)),
    "ssd_loss": ("ssd_loss", {
        "Location": [_f(13, 2, 24, 4, lo=-0.5, hi=0.5)],
        "Confidence": [_f(14, 2, 24, 3, lo=-2, hi=2)],
        "GTBox": [GT], "GTLabel": [GT_LABEL], "PriorBox": [PRIOR],
        "PriorBoxVar": [PRIOR_VAR]}, {}, ("Location", "Confidence")),
    "ssd_loss_bipartite_unnormalized": ("ssd_loss", {
        "Location": [_f(13, 2, 24, 4, lo=-0.5, hi=0.5)],
        "Confidence": [_f(14, 2, 24, 3, lo=-2, hi=2)],
        "GTBox": [GT], "GTLabel": [GT_LABEL], "PriorBox": [PRIOR]},
        {"match_type": "bipartite", "normalize": False,
         "neg_pos_ratio": 2.0, "loc_loss_weight": 0.5},
        ("Location", "Confidence")),
    "anchor_generator": ("anchor_generator",
                         {"Input": [np.zeros((1, 8, 4, 6), np.float32)]},
                         {"anchor_sizes": [64.0, 128.0],
                          "aspect_ratios": [0.5, 1.0, 2.0],
                          "stride": [16.0, 16.0], "offset": 0.5}, ()),
    "proposals_dense": ("generate_proposals", {
        "Scores": [_f(30, 2, 3, 4, 4)],
        "BboxDeltas": [_f(31, 2, 12, 4, 4, lo=-0.2, hi=0.2)],
        "ImInfo": [np.asarray([[64, 64, 1.0], [60, 50, 1.0]], np.float32)],
        "Anchors": [ANCH_4x4], "Variances": [VAR_4x4]},
        {"pre_nms_topN": 24, "post_nms_topN": 8, "nms_thresh": 0.7,
         "min_size": 0.1}, ()),
    "proposals_eta": ("generate_proposals", {
        "Scores": [_f(32, 2, 3, 4, 4)],
        "BboxDeltas": [_f(33, 2, 12, 4, 4, lo=-0.2, hi=0.2)],
        "ImInfo": [np.asarray([[64, 64, 1.0], [64, 64, 2.0]], np.float32)],
        "Anchors": [ANCH_4x4], "Variances": [VAR_4x4]},
        {"pre_nms_topN": 40, "post_nms_topN": 12, "nms_thresh": 0.8,
         "min_size": 8.0, "eta": 0.9}, ()),
    # a 16 x 16 x 9 map: a pool of 2304 > 2048, the iterative pick
    "proposals_iterative": ("generate_proposals", {
        "Scores": [_f(34, 1, 9, 16, 16)],
        "BboxDeltas": [_f(35, 1, 36, 16, 16, lo=-0.2, hi=0.2)],
        "ImInfo": [np.asarray([[256, 256, 1.0]], np.float32)],
        "Anchors": [ANCH_16], "Variances": [VAR_16]},
        {"pre_nms_topN": 6000, "post_nms_topN": 16, "nms_thresh": 0.7},
        ()),
    # quotas past the candidate counts: every candidate is picked
    "rpn_target_assign_unbound": ("rpn_target_assign", {
        "Loc": [_f(40, 2, 64, 4, lo=-1, hi=1)],
        "Scores": [_f(41, 2, 64, 1, lo=-1, hi=1)],
        "Anchor": [GRID_ANCHORS], "GtBox": [RPN_GT]},
        {"rpn_batch_size_per_im": 64, "fg_fraction": 1.0},
        ("Loc", "Scores")),
    "proposal_labels_unbound": ("generate_proposal_labels", {
        "RpnRois": [_boxes(42, 2, 16, hi=64.0, wh=(0.2, 0.6))],
        "GtClasses": [S(np.asarray([[[1], [0]], [[2], [4]]]),
                        np.asarray([1, 2], np.int64))],
        "GtBoxes": [S(np.asarray([[[5, 5, 20, 20], [0, 0, 0, 0]],
                                  [[10, 10, 30, 30], [40, 40, 60, 60]]],
                                 np.float32), np.asarray([1, 2], np.int64))],
        "ImScales": [np.asarray([[1.0], [1.5]], np.float32)]},
        {"batch_size_per_im": 18, "fg_fraction": 1.0, "fg_thresh": 0.3,
         "bg_thresh_hi": 0.3, "class_nums": 5}, ()),
    "detection_map": ("detection_map", {"DetectRes": [DETS],
                                        "Label": [GT5]},
                      {"class_num": 4, "overlap_threshold": 0.5}, ()),
    "detection_map_11point": ("detection_map", {"DetectRes": [DETS],
                                                "Label": [GT5]},
                              {"class_num": 4, "overlap_threshold": 0.5,
                               "ap_version": "11point"}, ()),
    "detection_map_difficult": ("detection_map", {"DetectRes": [DETS],
                                                  "Label": [GT6]},
                                {"class_num": 4, "overlap_threshold": 0.5,
                                 "evaluate_difficult": False}, ()),
    "detection_map_difficult_counted": ("detection_map", {
        "DetectRes": [DETS], "Label": [GT6]},
        {"class_num": 4, "overlap_threshold": 0.3, "background_label": -1,
         "ap_version": "11point"}, ()),
}


@pytest.mark.parametrize("case", sorted(RULES))
def test_rule_matches_reference(case):
    op, ins, attrs, grad = RULES[case]
    jout, tout = rule_pair(op, ins, attrs, grad=grad, jit=True)
    if op == "multiclass_nms":
        # the kept rows, their labels and their order exactly; with tied
        # scores the lower box index leads, as lax.top_k orders them
        np.testing.assert_array_equal(tout["Out"][0].numpy(),
                                      np.asarray(jout["Out"][0]))


def test_nms_ties_break_toward_the_lower_box_index():
    """Two boxes far apart with one score in one class: both are kept,
    the lower box index first, as the reference's stable top-k orders
    them; a third tied box overlapping the first is suppressed by it."""
    boxes = np.asarray([[[0, 0, 1, 1], [5, 5, 6, 6], [0, 0, 1, 1.1]]],
                       np.float32)
    scores = np.zeros((1, 2, 3), np.float32)
    scores[0, 1] = 0.5
    jout, tout = rule_pair("multiclass_nms", {"BBoxes": [boxes],
                                              "Scores": [scores]},
                           {"score_threshold": 0.1, "nms_threshold": 0.5,
                            "keep_top_k": 3})
    out = tout["Out"][0].numpy()
    np.testing.assert_array_equal(out, np.asarray(jout["Out"][0]))
    np.testing.assert_array_equal(out[0, :, 0], [1, 1, -1])
    np.testing.assert_array_equal(out[0, :2, 2:], boxes[0, :2])


def test_proposals_unbound_quota_selection_is_exact():
    """Where no quota binds (RULES' two cases, equal to the reference's
    slot for slot), the RPN sampler keeps every candidate with the fg
    slots leading, and the RoI sampler every real box, with labels of
    the candidates."""
    op, ins, attrs, _ = RULES["proposal_labels_unbound"]
    lab = port_rule(op, ins, attrs)["LabelsInt32"][0].numpy()
    assert set(np.unique(lab)) <= {-1, 0, 1, 2, 4} and (lab > 0).any()
    assert (lab >= 0).sum() == 2 * 16 + 3       # every RoI and real gt
    op, ins, attrs, _ = RULES["rpn_target_assign_unbound"]
    out = port_rule(op, ins, attrs)
    st = out["ScoreTarget"][0].numpy().reshape(2, 64)
    assert st[:, 0].tolist() == [1, 1]          # fg slots lead
    n_fg = (np.abs(out["LocPred"][0].numpy().reshape(2, 64, 4)).sum(-1)
            > 0).sum(1)
    assert ((st == 1).sum(1) == n_fg).all()


# ---------------------------------------------------------------------------
# the samplers where the quotas bind: held to their distribution
# ---------------------------------------------------------------------------
def _rows_of(loc, rows):
    """Indices into ``loc`` [M, 4] of each of ``rows`` [K, 4]."""
    return [int(np.where((loc == r).all(-1))[0][0]) for r in rows]


def test_rpn_sampler_draws_uniformly_where_quotas_bind():
    """fg quota 4 and 12 score slots over more fg and bg candidates: each
    draw takes min(quota, candidates) of each kind, only candidates, and
    over 300 draws every fg candidate anchor is picked at the uniform
    rate quota / candidates."""
    loc = np.random.RandomState(50).randn(2, 64, 4).astype(np.float32)
    gt = S(np.asarray([[[10, 10, 90, 90], [0, 0, 0, 0]],
                       [[5, 5, 38, 44], [90, 100, 150, 130]]], np.float32),
           np.asarray([1, 2], np.int64))
    ins = {"Loc": [loc], "Scores": [np.zeros((2, 64, 1), np.float32)],
           "Anchor": [GRID_ANCHORS], "GtBox": [gt]}
    attrs = {"rpn_batch_size_per_im": 12, "fg_fraction": 1 / 3,
             "rpn_positive_overlap": 0.05, "rpn_negative_overlap": 0.02}
    # the candidates: the rule's own picks where no quota binds
    full = port_rule("rpn_target_assign", ins, dict(
        attrs, rpn_batch_size_per_im=64, fg_fraction=1.0))
    fg_rows = full["LocPred"][0].numpy().reshape(2, 64, 4)
    fg_cand = [set(_rows_of(loc[b], fg_rows[b][np.abs(fg_rows[b]).sum(-1)
                                                > 0])) for b in range(2)]
    n_bg = (full["ScoreTarget"][0].numpy().reshape(2, 64) == 0).sum(1)
    assert all(len(c) > 4 for c in fg_cand) and (n_bg > 8).all()
    counts = np.zeros((2, 64))
    draws = 300
    for seed in range(draws):
        out = port_rule("rpn_target_assign", ins, attrs, seed=seed)
        lp = out["LocPred"][0].numpy().reshape(2, 4, 4)
        st = out["ScoreTarget"][0].numpy().reshape(2, 12)
        assert ((st == 1).sum(1) == 4).all() and ((st == 0).sum(1) == 8).all()
        for b in range(2):
            picked = _rows_of(loc[b], lp[b])
            assert len(set(picked)) == 4 and set(picked) <= fg_cand[b]
            counts[b, picked] += 1
    for b in range(2):
        rate = 4 / len(fg_cand[b])
        seen = counts[b, sorted(fg_cand[b])] / draws
        sd = np.sqrt(rate * (1 - rate) / draws)
        assert np.abs(seen - rate).max() < 5 * sd, (seen, rate)


def test_roi_sampler_draws_uniformly_where_quotas_bind():
    """fg quota 2 of a 6-RoI minibatch: each draw keeps min(quota,
    candidates) foregrounds and back-fills backgrounds, all of them
    candidates, and every fg candidate is picked at the uniform rate."""
    rois = np.zeros((1, 10, 4), np.float32)
    # six RoIs around the gt (IoU >= 0.5), four far from it
    base = np.asarray([10, 10, 40, 40], np.float32)
    for i in range(6):
        rois[0, i] = base + np.asarray([1 + i % 3, i // 3, i % 2, 1 + i])
    for i in range(4):
        rois[0, 6 + i] = np.asarray([60 + i, 60, 80 + i, 90], np.float32)
    ins = {"RpnRois": [rois],
           "GtClasses": [S(np.asarray([[[3]]]), np.asarray([1], np.int64))],
           "GtBoxes": [S(base[None, None], np.asarray([1], np.int64))],
           "ImScales": [np.ones((1, 1), np.float32)]}
    attrs = {"batch_size_per_im": 6, "fg_fraction": 1 / 3, "fg_thresh": 0.5,
             "bg_thresh_hi": 0.5, "class_nums": 4}
    counts = np.zeros(7)
    draws = 300
    for seed in range(draws):
        out = port_rule("generate_proposal_labels", ins, attrs, seed=seed)
        lab = out["LabelsInt32"][0].numpy()[0]
        r = out["Rois"][0].numpy()[0]
        assert (lab == 3).sum() == 2 and (lab == 0).sum() == 4
        for roi in r[lab == 3]:
            # a candidate: one of the six near RoIs or the appended gt
            hit = np.where((rois[0, :6] == roi).all(-1))[0]
            counts[hit[0] if len(hit) else 6] += 1
            assert len(hit) or (roi == base).all()
        for roi in r[lab == 0]:
            assert (rois[0, 6:] == roi).all(-1).any()
    rate = 2 / 7
    sd = np.sqrt(rate * (1 - rate) / draws)
    assert np.abs(counts / draws - rate).max() < 5 * sd, counts


def test_samplers_draw_on_the_host_the_same_noise_on_any_device():
    """The two samplers draw their noise from a CPU generator seeded by
    the op's draw, so one step samples the same slots wherever it runs;
    another step draws anew."""
    op, ins, attrs, _ = RULES["rpn_target_assign_unbound"]
    attrs = dict(attrs, rpn_batch_size_per_im=8, fg_fraction=0.25)
    a = port_rule(op, ins, attrs, seed=3)
    b = port_rule(op, ins, attrs, seed=3)
    c = port_rule(op, ins, attrs, seed=4)
    for slot in a:
        np.testing.assert_array_equal(a[slot][0].numpy(), b[slot][0].numpy())
    assert any(not np.array_equal(a[s][0].numpy(), c[s][0].numpy())
               for s in a)


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_detection.py), each held to the
# reference's program and to its own assertions
# ---------------------------------------------------------------------------
def _data(fluid, name, shape, dtype="float32", **kw):
    return fluid.layers.data(name=name, shape=shape, dtype=dtype,
                             append_batch_size=False, **kw)


def _iou_np(a, b):
    xa, ya = max(a[0], b[0]), max(a[1], b[1])
    xb, yb = min(a[2], b[2]), min(a[3], b[3])
    inter = max(xb - xa, 0) * max(yb - ya, 0)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


def test_iou_similarity():
    x = np.array([[0, 0, 2, 2], [1, 1, 3, 3]], np.float32)
    y = np.array([[0, 0, 2, 2], [2, 2, 4, 4], [10, 10, 11, 11]], np.float32)
    _, (out,) = program_pair(lambda fl: [fl.layers.iou_similarity(
        _data(fl, "x", [-1, 4]), _data(fl, "y", [-1, 4]))],
        {"x": x, "y": y})
    want = np.array([[_iou_np(a, b) for b in y] for a in x], np.float32)
    np.testing.assert_allclose(out, want, rtol=1e-5)


def test_box_coder_roundtrip():
    rng = np.random.RandomState(0)
    prior = np.abs(rng.rand(6, 4).astype(np.float32))
    prior[:, 2:] = prior[:, :2] + 0.5 + prior[:, 2:]
    var = np.full((6, 4), 0.1, np.float32)

    def build(fl):
        pb, pv, tb = (_data(fl, n, [-1, 4]) for n in ("pb", "pv", "tb"))
        enc = fl.layers.box_coder(pb, pv, tb, code_type="encode_center_size")
        return [enc, fl.layers.box_coder(pb, pv, enc,
                                         code_type="decode_center_size")]

    _, (_, dec) = program_pair(build, {"pb": prior, "pv": var,
                                       "tb": prior + 0.05})
    np.testing.assert_allclose(dec, prior + 0.05, rtol=1e-4, atol=1e-5)


def test_prior_box_shapes_and_range():
    def build(fl):
        feat = fl.layers.data(name="feat", shape=[8, 4, 4], dtype="float32")
        img = fl.layers.data(name="img", shape=[3, 32, 32], dtype="float32")
        return list(fl.layers.prior_box(feat, img, min_sizes=[4.0],
                                        max_sizes=[8.0], aspect_ratios=[2.0],
                                        flip=True, clip=True))

    _, (boxes, var) = program_pair(build, {
        "feat": np.zeros((1, 8, 4, 4), np.float32),
        "img": np.zeros((1, 3, 32, 32), np.float32)})
    assert boxes.shape == (64, 4) and var.shape == (64, 4)
    assert boxes.min() >= 0.0 and boxes.max() <= 1.0
    np.testing.assert_allclose((boxes[0, 0] + boxes[0, 2]) / 2, 0.125,
                               atol=1e-5)


def _bipartite(dist):
    def build(fl):
        return list(fl.layers.bipartite_match(
            _data(fl, "d", [-1] + list(dist.shape[1:]))))
    return program_pair(build, {"d": dist})[1]


def test_bipartite_match_greedy():
    idx, md = _bipartite(np.array([[[0.7, 0.9, 0.1],
                                    [0.6, 0.8, 0.2]]], np.float32))
    np.testing.assert_array_equal(idx[0], [1, 0, -1])
    np.testing.assert_allclose(md[0], [0.6, 0.9, 0.0])


def test_bipartite_match_prefers_global_best():
    m, md = _bipartite(np.array([[[0.6, 0.55], [0.9, 0.1]]], np.float32))
    assert m[0, 0] == 1 and m[0, 1] == 0
    np.testing.assert_allclose(md[0], [0.9, 0.55], rtol=1e-6)


def _target_assign(x, match, neg=None, mismatch_value=0):
    def build(fl):
        nv = None if neg is None else _data(fl, "n", [-1, neg.shape[1]],
                                            "int32")
        return list(fl.layers.target_assign(
            _data(fl, "x", [-1] + list(x.shape[1:])),
            _data(fl, "m", [-1, match.shape[1]], "int32"),
            negative_indices=nv, mismatch_value=mismatch_value))
    feed = {"x": x, "m": match}
    if neg is not None:
        feed["n"] = neg
    return program_pair(build, feed)[1]


def test_target_assign():
    x = np.arange(12, dtype=np.float32).reshape(1, 3, 4)
    out, w = _target_assign(x, np.array([[2, -1, 0, 1]], np.int32))
    np.testing.assert_allclose(out[0, 0], x[0, 2])
    np.testing.assert_allclose(out[0, 1], np.zeros(4))
    np.testing.assert_allclose(out[0, 2], x[0, 0])
    np.testing.assert_allclose(w[0].reshape(-1), [1, 0, 1, 1])


def test_target_assign_negative_indices():
    out, w = _target_assign(np.ones((1, 2, 1), np.float32),
                            np.array([[0, -1, -1, -1]], np.int32),
                            neg=np.array([[2, -1]], np.int32))
    np.testing.assert_allclose(w[0].reshape(-1), [1, 0, 1, 0])
    np.testing.assert_allclose(out[0, 2], [0.0])


def _nms(boxes, scores, **kw):
    def build(fl):
        return [fl.layers.multiclass_nms(
            _data(fl, "b", [-1] + list(boxes.shape[1:])),
            _data(fl, "s", [-1] + list(scores.shape[1:])), **kw)]
    jout, (out,) = program_pair(build, {"b": boxes, "s": scores})
    np.testing.assert_array_equal(out, np.asarray(jout[0]))
    return out


def test_multiclass_nms_suppression():
    scores = np.zeros((1, 2, 3), np.float32)
    scores[0, 1] = [0.9, 0.8, 0.7]
    out = _nms(np.array([[[0, 0, 1, 1], [0, 0, 1.05, 1.05], [3, 3, 4, 4]]],
                        np.float32), scores, background_label=0,
               score_threshold=0.01, nms_threshold=0.5, keep_top_k=3)
    kept = out[0, :, 0] >= 0
    assert kept.sum() == 2
    np.testing.assert_allclose(sorted(out[0, kept, 1]), [0.7, 0.9])


def test_multiclass_nms_score_threshold_and_topk():
    scores = np.zeros((1, 3, 4), np.float32)
    scores[0, 1] = [0.9, 0.05, 0.6, 0.4]
    scores[0, 2] = [0.02, 0.8, 0.03, 0.7]
    out = _nms(np.array([[[0, 0, 1, 1], [2, 2, 3, 3], [5, 5, 6, 6],
                          [8, 8, 9, 9]]], np.float32), scores,
               background_label=0, score_threshold=0.1, nms_threshold=0.5,
               keep_top_k=3)
    kept = out[0, out[0, :, 0] >= 0]
    order = np.argsort(-kept[:, 1])
    np.testing.assert_allclose(kept[order, 1], [0.9, 0.8, 0.7], rtol=1e-6)
    np.testing.assert_allclose(kept[order, 2:6],
                               [[0, 0, 1, 1], [2, 2, 3, 3], [8, 8, 9, 9]],
                               rtol=1e-6)


def test_multiclass_nms_multiclass_same_box():
    scores = np.zeros((1, 3, 2), np.float32)
    scores[0, 1] = [0.9, 0.0]
    scores[0, 2] = [0.8, 0.0]
    out = _nms(np.array([[[0, 0, 1, 1], [10, 10, 11, 11]]], np.float32),
               scores, background_label=0, score_threshold=0.1,
               nms_threshold=0.5, keep_top_k=4)
    kept = out[0, :, 0] >= 0
    assert kept.sum() == 2 and sorted(out[0, kept, 0]) == [1, 2]
    np.testing.assert_allclose(out[0, kept, 2:6],
                               [[0, 0, 1, 1], [0, 0, 1, 1]], rtol=1e-6)


def _ssd_loss_build(np_, c):
    def build(fl):
        feat = fl.layers.data(name="feat", shape=[16], dtype="float32")
        loc = fl.layers.reshape(fl.layers.fc(feat, size=np_ * 4),
                                shape=[-1, np_, 4])
        conf = fl.layers.reshape(fl.layers.fc(feat, size=np_ * c),
                                 shape=[-1, np_, c])
        gb = fl.layers.data(name="gb", shape=[4], dtype="float32",
                            lod_level=1)
        gl = fl.layers.data(name="gl", shape=[1], dtype="int64", lod_level=1)
        loss = fl.layers.ssd_loss(loc, conf, gb, gl,
                                  _data(fl, "pb", [np_, 4]),
                                  _data(fl, "pv", [np_, 4]))
        return [fl.layers.reduce_sum(loss)]
    return build


def test_ssd_loss_trains():
    """A tiny SSD head: the first step's loss and every gradient equal
    the reference's; 25 SGD steps in the port drop the loss by 30%."""
    rng = np.random.RandomState(0)
    b, np_, c = 2, 8, 3
    prior = np.linspace(0, 1, np_ * 4).reshape(np_, 4).astype(np.float32)
    prior[:, 2:] = prior[:, :2] + 0.3
    feed = {"feat": rng.rand(b, 16).astype(np.float32),
            "gb": seqs([np.array([[0.1, 0.1, 0.4, 0.4]], np.float32),
                        np.array([[0.2, 0.2, 0.5, 0.5],
                                  [0.6, 0.6, 0.9, 0.9]], np.float32)]),
            "gl": seqs([np.array([[1]], np.int64),
                        np.array([[2], [1]], np.int64)]),
            "pb": prior, "pv": np.full((np_, 4), 0.1, np.float32)}
    build = _ssd_loss_build(np_, c)
    program_pair(build, feed, grads=True)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        total = build(tfluid)[0]
        tfluid.optimizer.SGD(learning_rate=0.05).minimize(total)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    tfeed = make_feed("port", feed)
    losses = [float(exe.run(main, feed=tfeed, fetch_list=[total],
                            scope=scope)[0].reshape(())) for _ in range(25)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])


def test_iou_similarity_batched_vs_shared():
    x = np.array([[[0, 0, 2, 2]], [[1, 1, 3, 3]]], np.float32)
    y = np.array([[0, 0, 2, 2], [2, 2, 4, 4]], np.float32)
    _, (out,) = program_pair(lambda fl: [fl.layers.iou_similarity(
        _data(fl, "x", [-1, 1, 4]), _data(fl, "y", [-1, 4]))],
        {"x": x, "y": y})
    assert out.shape == (2, 1, 2)
    np.testing.assert_allclose(out[0, 0, 0], 1.0)


def test_prior_box_min_max_order():
    def build(fl):
        feat = fl.layers.data(name="feat", shape=[8, 1, 1], dtype="float32")
        img = fl.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
        return [fl.layers.prior_box(feat, img, min_sizes=[2.0],
                                    max_sizes=[4.0], aspect_ratios=[2.0],
                                    min_max_aspect_ratios_order=True)[0]]

    _, (boxes,) = program_pair(build, {
        "feat": np.zeros((1, 8, 1, 1), np.float32),
        "img": np.zeros((1, 3, 8, 8), np.float32)})
    w, h = boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]
    np.testing.assert_allclose(w[:2], h[:2], rtol=1e-5)
    assert w[1] > w[0] and abs(w[2] - h[2]) > 1e-4


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_rpn.py)
# ---------------------------------------------------------------------------
def test_anchor_generator_grid():
    def build(fl):
        from_det = fl.layers.detection
        return list(from_det.anchor_generator(
            _data(fl, "feat", [-1, 8, 4, 6]), anchor_sizes=[64.0, 128.0],
            aspect_ratios=[0.5, 1.0], stride=[16.0, 16.0], offset=0.5))

    _, (a, v) = program_pair(build, {"feat": np.zeros((1, 8, 4, 6),
                                                      np.float32)})
    assert a.shape == (4, 6, 4, 4) and v.shape == (4, 6, 4, 4)
    w0, h0 = a[0, 0, 2, 2] - a[0, 0, 2, 0], a[0, 0, 2, 3] - a[0, 0, 2, 1]
    assert abs(w0 - 63.0) < 1e-4 and abs(h0 - 63.0) < 1e-4
    assert abs((a[0, 0, 2, 0] + a[0, 0, 2, 2]) / 2 - 7.5) < 1e-4
    assert abs((a[0, 1, 2, 0] - a[0, 0, 2, 0]) - 16.0) < 1e-4
    np.testing.assert_allclose(v[0, 0, 0], [0.1, 0.1, 0.2, 0.2], rtol=1e-6)


def test_rpn_target_assign_labels():
    """The reference's case at its own quotas (fg quota 8 of one
    candidate, 32 score slots): the shapes, the exact zero delta target
    of the perfectly overlapping fg anchor and the fg-first slots hold
    in the port; its fg slots and the fg anchor's slot equal the
    reference's (the one fg candidate is drawn in both)."""
    b, m = 2, 64
    rng = np.random.RandomState(0)
    gt = [np.asarray([GRID_ANCHORS[10]], np.float32),
          np.asarray([GRID_ANCHORS[30]], np.float32)]

    def build(fl):
        det = fl.layers.detection
        return list(det.rpn_target_assign(
            _data(fl, "loc", [-1, m, 4]), _data(fl, "scores", [-1, m, 1]),
            _data(fl, "anchors", [m, 4]), None,
            fl.layers.data("gt", shape=[4], dtype="float32", lod_level=1),
            rpn_batch_size_per_im=32, fg_fraction=0.25))

    progs = build_both(build)
    feed = {"loc": rng.randn(b, m, 4).astype(np.float32),
            "scores": rng.randn(b, m, 1).astype(np.float32),
            "anchors": GRID_ANCHORS, "gt": seqs(gt, np.float32)}
    outs = {}
    for which, pkg in (("jax", jfluid), ("port", tfluid)):
        main, startup, names, _ = progs[which]
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        outs[which] = [np.asarray(o) for o in exe.run(
            main, feed=make_feed(which, feed), fetch_list=names,
            scope=scope)]
    sp, lp, st, lt = outs["port"]
    assert sp.shape == (64, 1) and st.shape == (64, 1)
    assert lp.shape == (16, 4) and lt.shape == (16, 4)
    assert np.isfinite(lt).all() and np.abs(lt).max() < 1e-4
    assert set(np.unique(st)) <= {0, 1}
    assert st[0, 0] == 1 and st[32, 0] == 1
    for got, want in zip(outs["port"][1::2], outs["jax"][1::2]):
        np.testing.assert_allclose(got, want, **FWD)
    np.testing.assert_array_equal(st[[0, 32]], outs["jax"][2][[0, 32]])
    np.testing.assert_allclose(sp[[0, 32]], outs["jax"][0][[0, 32]], **FWD)


def test_generate_proposals_shapes_and_order():
    b, a, h, w = 1, 3, 4, 4
    rng = np.random.RandomState(1)

    def build(fl):
        det = fl.layers.detection
        anchors, var = det.anchor_generator(
            _data(fl, "feat", [-1, 8, h, w]),
            anchor_sizes=[32.0, 64.0, 128.0], aspect_ratios=[1.0],
            stride=[16.0, 16.0])
        return list(det.generate_proposals(
            _data(fl, "scores", [-1, a, h, w]),
            _data(fl, "deltas", [-1, 4 * a, h, w]),
            _data(fl, "im_info", [-1, 3]), anchors, var,
            pre_nms_top_n=24, post_nms_top_n=8, nms_thresh=0.7))

    _, (r, p) = program_pair(build, {
        "feat": np.zeros((b, 8, h, w), np.float32),
        "scores": rng.rand(b, a, h, w).astype(np.float32),
        "deltas": (rng.randn(b, 4 * a, h, w) * 0.1).astype(np.float32),
        "im_info": np.asarray([[64.0, 64.0, 1.0]], np.float32)})
    assert r.shape == (b, 8, 4) and p.shape == (b, 8, 1)
    pv = p[0, :, 0]
    assert (np.diff(pv[pv > 0]) <= 1e-6).all()
    assert (r >= 0).all() and (r[..., 2] <= 63.0 + 1e-4).all()
    assert ((r[0, pv > 0, 2] - r[0, pv > 0, 0]) > 0).all()


def test_generate_proposal_labels_sampling():
    """The reference's case at its own quotas (fg quota 3 of a
    12-RoI minibatch): the port keeps its shapes, labels and per-class
    weight layout (the draw binds, so no slot is compared)."""
    b, r, ncls = 2, 16, 5
    rng = np.random.RandomState(2)
    rois = np.zeros((b, r, 4), np.float32)
    rois[..., :2] = rng.rand(b, r, 2) * 40
    rois[..., 2:] = rois[..., :2] + 10 + rng.rand(b, r, 2) * 30

    def build(fl):
        return list(fl.layers.detection.generate_proposal_labels(
            _data(fl, "rois", [-1, r, 4]),
            fl.layers.data("gcls", shape=[1], dtype="int64", lod_level=1),
            fl.layers.data("gbox", shape=[4], dtype="float32", lod_level=1),
            _data(fl, "scales", [-1, 1]), batch_size_per_im=12,
            fg_fraction=0.25, fg_thresh=0.3, bg_thresh_hi=0.3,
            class_nums=ncls))

    main, startup, names, _ = build_both(build)["port"]
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    ro, lab, tgt, wi, _ = exe.run(main, feed=make_feed("port", {
        "rois": rois,
        "gcls": seqs([np.asarray([[1]]), np.asarray([[2], [4]])], np.int64),
        "gbox": seqs([np.asarray([[5.0, 5.0, 20.0, 20.0]], np.float32),
                      np.asarray([[10.0, 10.0, 30.0, 30.0],
                                  [40.0, 40.0, 60.0, 60.0]], np.float32)],
                     np.float32),
        "scales": np.ones((b, 1), np.float32)}), fetch_list=names,
        scope=scope)
    assert ro.shape == (b, 12, 4) and lab.shape == (b, 12)
    assert tgt.shape == (b, 12, 4 * ncls)
    assert (lab > 0).sum() >= b
    assert set(np.unique(lab)) <= {-1, 0, 1, 2, 4}
    for bi in range(b):
        for si in range(12):
            row = wi[bi, si].reshape(ncls, 4)
            if lab[bi, si] > 0:
                assert row[lab[bi, si]].sum() == 4.0 and row.sum() == 4.0
            else:
                assert row.sum() == 0.0


# ---------------------------------------------------------------------------
# Faster R-CNN (tests/test_rpn.py test_faster_rcnn_trains, the zoo entry)
# ---------------------------------------------------------------------------
ZOO_CFG = dict(class_num=4, anchor_sizes=[16.0, 32.0], aspect_ratios=[1.0],
               backbone_channels=[8, 8], rpn_channels=16, rpn_batch_size=16,
               pre_nms_top_n=32, post_nms_top_n=8, roi_batch_size=8,
               pooled_size=3, head_dim=16)
# the zoo entry's shapes with quotas past every candidate count: 32
# anchors, 8 proposals + 2 gt slots, every candidate kept in both samplers
UNBOUND_CFG = dict(ZOO_CFG, rpn_batch_size=32, rpn_fg_fraction=1.0,
                   roi_batch_size=10, roi_fg_fraction=1.0)


def _rcnn_feed(b=2, hw=64, seed=4):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(b, 3, hw, hw).astype(np.float32),
            "gtb": seqs([np.array([[8, 8, 40, 40]], np.float32),
                         np.array([[4, 4, 30, 30], [20, 20, 60, 60]],
                                  np.float32)], np.float32),
            "gtl": seqs([np.array([[1]], np.int64),
                         np.array([[2], [3]], np.int64)], np.int64),
            "info": np.asarray([[hw, hw, 1.0]] * b, np.float32)}


def _rcnn_build(cfg_kw, is_train=True, lr=1e-3, hw=64):
    def build(fl):
        import importlib
        frc = importlib.import_module(fl.__name__ + ".models.faster_rcnn")
        img = _data(fl, "img", [-1, 3, hw, hw])
        info = _data(fl, "info", [-1, 3])
        if not is_train:
            return list(frc.build_faster_rcnn(
                img, None, None, info, frc.FasterRCNNConfig(**cfg_kw),
                is_train=False))
        gtb = fl.layers.data("gtb", shape=[4], dtype="float32", lod_level=1)
        gtl = fl.layers.data("gtl", shape=[1], dtype="int64", lod_level=1)
        loss, rois, cls = frc.build_faster_rcnn(
            img, gtb, gtl, info, frc.FasterRCNNConfig(**cfg_kw))
        fl.optimizer.SGD(learning_rate=lr).minimize(loss)
        return [loss, rois, cls]
    return build


def test_faster_rcnn_two_sgd_steps_match_the_reference():
    """Two SGD steps at the zoo entry's shapes, quotas past the candidate
    counts: each step's loss, RoIs and class scores and every parameter's
    gradient, then every parameter after the steps, equal the
    reference's."""
    progs = build_both(_rcnn_build(UNBOUND_CFG, lr=0.05))
    jm, js, names, params = progs["jax"]
    tm = progs["port"][0]
    jscope, state = reference_state(js)
    tscope = port_scope(state)
    fetch = names + [p + "@GRAD" for p in params]
    feed = _rcnn_feed()
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), \
        tfluid.Executor(tfluid.CPUPlace())
    for step in range(2):
        jout = jexe.run(jm, feed=make_feed("jax", feed), fetch_list=fetch,
                        scope=jscope)
        tout = texe.run(tm, feed=make_feed("port", feed), fetch_list=fetch,
                        scope=tscope)
        for name, a, b in zip(fetch, tout, jout):
            assert_same(a, b, GRAD if name.endswith("@GRAD") else FWD,
                        f"step {step}: {name}")
    for p in params:
        np.testing.assert_allclose(
            weights.tensor_to_array(tscope.find_var(p)),
            np.asarray(jscope.find_var(p)), err_msg=p, **GRAD)


def test_faster_rcnn_trains():
    """The zoo entry at its own quotas (the samplers' draws bind): three
    SGD steps, finite losses, fixed shapes."""
    from paddle_tpu_torch.models import zoo
    zp = zoo.build_zoo_program("faster_rcnn")
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(zp.startup, scope=scope)
    vals = [float(exe.run(zp.main, feed=zoo.example_feed("faster_rcnn", 2,
                                                         step),
                          fetch_list=zp.fetch_list, scope=scope)[0]
                  .reshape(())) for step in range(3)]
    assert np.isfinite(vals).all()
    main, startup, names, _ = build_both(_rcnn_build(ZOO_CFG))["port"]
    exe.run(startup, scope=scope)
    loss, rois, cls = exe.run(main, feed=make_feed("port", _rcnn_feed()),
                              fetch_list=names, scope=scope)
    assert loss.shape == (1,) and np.isfinite(loss).all()
    assert rois.shape == (2, 8, 4) and cls.shape == (16, 4)


def test_faster_rcnn_inference_program_matches_the_reference():
    """is_train=False: the proposals, class probabilities and box
    regressions equal the reference's."""
    feed = {k: v for k, v in _rcnn_feed().items() if k in ("img", "info")}
    program_pair(_rcnn_build(ZOO_CFG, is_train=False), feed)


# ---------------------------------------------------------------------------
# an SSD head: multi_box_head, ssd_loss, detection_output, detection_map
# ---------------------------------------------------------------------------
SSD_MAPS = ((8, 4), (6, 2), (4, 1))          # (channels, side)


def _ssd_build(train):
    def build(fl):
        img = _data(fl, "img", [-1, 3, 32, 32])
        maps = [_data(fl, f"map{i}", [-1, c, s, s])
                for i, (c, s) in enumerate(SSD_MAPS)]
        locs, confs, boxes, var = fl.layers.multi_box_head(
            maps, img, base_size=32, num_classes=3,
            aspect_ratios=[[2.0], [2.0, 3.0], [2.0]], min_ratio=20,
            max_ratio=90, kernel_size=3, pad=1, flip=True)
        if train:
            gb = fl.layers.data("gb", shape=[4], dtype="float32",
                                lod_level=1)
            gl = fl.layers.data("gl", shape=[1], dtype="int64", lod_level=1)
            return [fl.layers.reduce_sum(fl.layers.ssd_loss(
                locs, confs, gb, gl, boxes, var)), boxes]
        return [fl.layers.detection_output(
            locs, confs, boxes, var, nms_threshold=0.45, nms_top_k=20,
            keep_top_k=10, score_threshold=0.01), boxes]
    return build


def _ssd_feed(b=2, seed=7):
    rng = np.random.RandomState(seed)
    feed = {"img": rng.rand(b, 3, 32, 32).astype(np.float32)}
    for i, (c, s) in enumerate(SSD_MAPS):
        feed[f"map{i}"] = rng.randn(b, c, s, s).astype(np.float32)
    feed["gb"] = seqs([_boxes(60 + i, 1 + i) for i in range(b)], np.float32)
    feed["gl"] = seqs([rng.randint(1, 3, (1 + i, 1)) for i in range(b)],
                      np.int64)
    return feed


def test_ssd_head_trains_like_the_reference():
    """multi_box_head over three maps (priors by min/max ratio, 3 x 3
    heads, flipped ratios) into ssd_loss: the loss and every gradient
    equal the reference's."""
    _, (loss, boxes, *_) = program_pair(_ssd_build(True), _ssd_feed(),
                                        grads=True)
    assert boxes.shape == (4 * 4 * 4 + 2 * 2 * 6 + 1 * 4, 4)
    assert np.isfinite(loss).all()


def test_detection_output_and_map_match_the_reference():
    """detection_output (decode, softmax, NMS) of the head's raw
    predictions: the NMS rows equal the reference's exactly, and the
    ``detection_map`` of those rows against the ground truth too."""
    feed = {k: v for k, v in _ssd_feed().items() if k not in ("gb", "gl")}
    jout, (out, _) = program_pair(_ssd_build(False), feed)
    want = np.asarray(jout[0])
    np.testing.assert_array_equal(out[..., 0], want[..., 0])
    np.testing.assert_allclose(out, want, **FWD)
    assert out.shape == (2, 10, 6) and (out[..., 0] >= 0).any()
    gt = S(np.concatenate([np.full((2, 3, 1), 1, np.float32),
                           _boxes(70, 2, 3)], -1),
           np.asarray([2, 3], np.int64))
    for version in ("integral", "11point"):
        jm, tm = rule_pair("detection_map", {"DetectRes": [out],
                                             "Label": [gt]},
                           {"class_num": 3, "overlap_threshold": 0.1,
                            "ap_version": version})
        np.testing.assert_allclose(tm["MAP"][0].numpy(),
                                   np.asarray(jm["MAP"][0]), atol=1e-6)


# ---------------------------------------------------------------------------
# detection_map layer cases (tests/test_eval_ops.py)
# ---------------------------------------------------------------------------
def _dmap(det, gts, **kw):
    def build(fl):
        dv = _data(fl, "det", [-1, det.shape[1], 6])
        gv = fl.layers.data("gt", shape=[6], dtype="float32", lod_level=1)
        return [fl.layers.detection_map(dv, gv, class_num=3,
                                        overlap_threshold=0.5, **k)
                for k in ({}, kw) if k is not None]
    jout, tout = program_pair(build, {"det": det,
                                      "gt": seqs(gts, np.float32)})
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a, b, atol=1e-6)
    return [float(np.asarray(v).reshape(())) for v in tout]


def test_detection_map_perfect():
    det = np.zeros((1, 4, 6), np.float32)
    det[0, 0] = [1, 0.9, 10, 10, 20, 20]
    det[0, 1] = [2, 0.8, 30, 30, 50, 50]
    det[0, 2:] = [-1, 0, 0, 0, 0, 0]
    gts = [np.array([[1, 0, 10, 10, 20, 20], [2, 0, 30, 30, 50, 50]],
                    np.float32)]
    v = _dmap(det, gts)
    assert abs(v[0] - 1.0) < 1e-5


def test_detection_map_half():
    det = np.zeros((1, 4, 6), np.float32)
    det[0, 0] = [1, 0.9, 10, 10, 20, 20]
    det[0, 1] = [2, 0.8, 100, 100, 120, 120]
    det[0, 2:] = [-1, 0, 0, 0, 0, 0]
    gts = [np.array([[1, 0, 10, 10, 20, 20], [2, 0, 30, 30, 50, 50]],
                    np.float32)]
    v, v11 = _dmap(det, gts, ap_version="11point")
    assert abs(v - 0.5) < 1e-5 and abs(v11 - 0.5) < 0.05


# ---------------------------------------------------------------------------
# the inference programs cross both ways and serve
# ---------------------------------------------------------------------------
def _save(fluid, build, feed_names, d):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        fetches = build(fluid)[:3]
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        with warnings.catch_warnings():
            warnings.simplefilter("error", UserWarning)
            fluid.io.save_inference_model(d, feed_names, fetches, exe,
                                          main_program=main)


def _serve(fluid, d, feed):
    inf = fluid.Inferencer.from_inference_model(d, place=fluid.CPUPlace())
    return [np.asarray(o) for o in inf.infer(
        {n: feed[n] for n in inf.feed_names})]


MODELS_IO = {
    "faster_rcnn": (_rcnn_build(ZOO_CFG, is_train=False), ["img", "info"],
                    lambda: {k: v for k, v in _rcnn_feed().items()
                             if k in ("img", "info")}),
    "ssd_detection_output": (
        _ssd_build(False), ["img", "map0", "map1", "map2"],
        lambda: {k: v for k, v in _ssd_feed().items()
                 if k not in ("gb", "gl")}),
}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("model", sorted(MODELS_IO))
def test_detection_inference_models_cross_both_ways(tmp_path, model,
                                                    direction):
    """A saved Faster R-CNN inference program and an SSD
    ``detection_output`` program load and serve through the other
    package's Inferencer with the saver's answers; the port's save also
    exports the AOT graph (the suppression loop unrolled), whose
    CompiledPredictor answers the same."""
    build, feed_names, feed_fn = MODELS_IO[model]
    feed = feed_fn()
    d = str(tmp_path / model)
    saver, loader = (jfluid, tfluid) if direction == "jax_to_port" \
        else (tfluid, jfluid)
    _save(saver, build, feed_names, d)
    want = _serve(saver, d, feed)
    got = _serve(loader, d, feed)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **FWD)
    if saver is tfluid:
        from paddle_tpu_torch.io import load_compiled_predictor
        pred = load_compiled_predictor(d, device="cpu")
        for a, b in zip(pred.run({n: feed[n] for n in feed_names}), want):
            np.testing.assert_allclose(a, b, **FWD)


def test_roi_pool_bin_edges_are_the_references():
    """F17: roi_pool's bin edges are jnp.linspace's i · float32(1 / bins),
    not i / bins. At 7 bins over a 7-pixel RoI the two differ in the last
    place at every edge, and i / bins put the pixel on edge 3 into the
    wrong bin; here every RoI width from 1 to 21 pixels, 7 bins a side,
    pools the reference's values."""
    rng = np.random.RandomState(80)
    x = rng.randn(1, 3, 24, 24).astype(np.float32)
    rois = np.asarray([[0, 0, w - 1, w + 1] for w in range(1, 22)]
                      + [[2, 3, 2 + w, 4 + w] for w in range(3, 20, 2)],
                      np.float32)
    rule_pair("roi_pool", {"X": [x], "ROIs": [rois]},
              {"pooled_height": 7, "pooled_width": 7, "spatial_scale": 1.0},
              grad=("X",))
