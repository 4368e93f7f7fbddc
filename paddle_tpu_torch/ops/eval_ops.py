"""In-graph evaluation ops: ``chunk_eval`` (sequence labelling P/R/F1)
and ``detection_map`` (VOC mAP).

Port of ``paddle_tpu/ops/eval_ops.py`` (capability parity with
paddle/fluid/operators/chunk_eval_op.h and detection_map_op.h). The
reference walks LoD sequences on the host; here, as in the JAX
package, chunk segmentation is elementwise begin/end flags over the
padded tags, and matching is a masked scan over the time axis, batched
over the rows: ``rnn._recur``'s recurrence, a torch loop eagerly and
torch's ``scan`` in an export. ``detection_map`` matches each image's
detections in score order in one loop over the detection slots,
batched over the images, then computes every class's AP at once.
"""
import torch

from ..core.registry import canonical_int, register_op
from ..core.sequence import SequenceBatch
# the reference module's sentinel (its detection_map's), the one
# ops/crf_ctc.py keeps
from .crf_ctc import NEG_INF
from .rnn import _recur

_SCHEMES = {
    # num_tag_types, tag_begin, tag_inside, tag_end, tag_single
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, -1),
}


def _chunk_flags(labels, num_chunk_types, scheme):
    """Begin/end flags per position (reference chunk_eval_op.h
    ChunkBegin/ChunkEnd). labels [B, T] with out-of-sequence positions
    already set to the 'other' type. Returns (begin, end, type), each
    [B, T]."""
    ntag, t_begin, t_inside, t_end, t_single = _SCHEMES[scheme]
    other = num_chunk_types
    tag = labels % ntag
    typ = labels // ntag
    b = labels.shape[0]

    def edge(v, fill):
        return torch.full((b, 1), fill, dtype=v.dtype, device=v.device)

    prev_tag = torch.cat([edge(tag, -1), tag[:, :-1]], dim=1)
    prev_typ = torch.cat([edge(typ, other), typ[:, :-1]], dim=1)
    next_tag = torch.cat([tag[:, 1:], edge(tag, -1)], dim=1)
    next_typ = torch.cat([typ[:, 1:], edge(typ, other)], dim=1)
    false = torch.zeros_like(labels, dtype=torch.bool)
    true = ~false

    def w(c, a, b_):
        return torch.where(c, a, b_)

    end_or_single = (prev_tag == t_end) | (prev_tag == t_single)
    begin = w(prev_typ == other, typ != other,
            w(typ == other, false,
            w(typ != prev_typ, true,
            w(tag == t_begin, true,
            w(tag == t_inside, end_or_single,
            w(tag == t_end, end_or_single,
            w(tag == t_single, true, false)))))))
    next_begins = (next_tag == t_begin) | (next_tag == t_single)
    end = w(typ == other, false,
          w(next_typ == other, true,
          w(next_typ != typ, true,
          w(tag == t_begin, next_begins,
          w(tag == t_inside, next_begins,
          w((tag == t_end) | (tag == t_single), true, false))))))
    return begin, end, typ


@register_op("chunk_eval", seq_aware=True)
def _chunk_eval(ctx, ins, attrs):
    """Inference/Label: lod_level-1 int sequences of chunk tags.
    Outputs the reference's six: Precision, Recall, F1-Score,
    NumInferChunks, NumLabelChunks, NumCorrectChunks."""
    inf = ins["Inference"][0]
    lab = ins["Label"][0]
    scheme = attrs.get("chunk_scheme", "IOB")
    nct = int(attrs["num_chunk_types"])
    excluded = [int(e) for e in attrs.get("excluded_chunk_types") or []]
    other_tag = nct * _SCHEMES[scheme][0]   # maps to type == other

    inf_data, lengths = inf.data, inf.lengths
    lab_data = lab.data
    if inf_data.dim() == 3:
        inf_data = inf_data[..., 0]
    if lab_data.dim() == 3:
        lab_data = lab_data[..., 0]
    b, t = inf_data.shape
    mask = torch.arange(t, device=inf_data.device)[None, :] \
        < lengths[:, None]
    iseq = torch.where(mask, inf_data, other_tag).to(torch.int64)
    lseq = torch.where(mask, lab_data, other_tag).to(torch.int64)
    ib, ie, ityp = _chunk_flags(iseq, nct, scheme)
    lb, le, ltyp = _chunk_flags(lseq, nct, scheme)
    inc_i, inc_l = ib, lb
    for e in excluded:
        inc_i = inc_i & (ityp != e)
        inc_l = inc_l & (ltyp != e)

    def step(carry, flags, _):
        in_match, correct = carry
        starts, same_begin, both_end, any_end = flags
        # a mismatched boundary or type kills any active match
        in_match = (in_match & same_begin) | starts
        correct = correct + (in_match & both_end)
        return [in_match & ~any_end, correct], []

    # the exclusion applies to match starts too; the matching runs over
    # the padded axis as ``rnn._recur``'s recurrence, so an exported
    # chunk_eval keeps that length a symbol
    starts = ib & lb & (ityp == ltyp) & inc_i
    (_, correct), _ = _recur(
        ctx, step, [torch.zeros(b, dtype=torch.bool, device=iseq.device),
                    torch.zeros(b, dtype=torch.int64, device=iseq.device)],
        [starts, ib == lb, ie & le, ie | le], mask, False)
    num_i = inc_i.sum().to(canonical_int())
    num_l = inc_l.sum().to(canonical_int())
    num_c = correct.sum().to(canonical_int())
    p = torch.where(num_i > 0, num_c / torch.clamp(num_i, min=1), 0.0)
    r = torch.where(num_l > 0, num_c / torch.clamp(num_l, min=1), 0.0)
    f1 = torch.where(num_c > 0, 2 * p * r / torch.clamp(p + r, min=1e-12),
                     0.0)
    return {"Precision": [p.to(torch.float32)],
            "Recall": [r.to(torch.float32)],
            "F1-Score": [f1.to(torch.float32)],
            "NumInferChunks": [num_i],
            "NumLabelChunks": [num_l],
            "NumCorrectChunks": [num_c]}


@register_op("detection_map", seq_aware=True)
def _detection_map(ctx, ins, attrs):
    """VOC mAP over the minibatch (reference detection_map_op.h).
    DetectRes: dense [B, K, 6] rows [label, score, x1, y1, x2, y2]
    (label -1 pads — the multiclass_nms output). Label: lod_level-1 gt
    per image, rows [label, x1, y1, x2, y2] or — matching the reference
    detection_map_op.h GetBoxes 6-wide layout — [label, is_difficult,
    x1, y1, x2, y2]. Greedy per-(image, class) matching in score order,
    then per-class AP (integral or 11point) averaged over classes with
    gt. MatchInfo rows [label, score, tp, valid] and the per-class
    GTCount let ``evaluator.DetectionMAP`` accumulate the dataset mAP.
    """
    from .detection import _iou_matrix, _take_rows
    det = ins["DetectRes"][0]
    gt = ins["Label"][0]
    class_num = int(attrs["class_num"])
    overlap = float(attrs.get("overlap_threshold", 0.3))
    evaluate_difficult = bool(attrs.get("evaluate_difficult", True))
    background = int(attrs.get("background_label", 0))

    if isinstance(det, SequenceBatch):
        det = det.data
    gt_data, gt_lens = gt.data, gt.lengths
    b, k, _ = det.shape
    g = gt_data.shape[1]
    dev = det.device
    gt_label = gt_data[..., 0].to(torch.int64)
    if gt_data.shape[-1] >= 6:
        difficult = gt_data[..., 1] > 0
        gt_boxes = gt_data[..., 2:6]
    else:
        difficult = torch.zeros(gt_data.shape[:2], dtype=torch.bool,
                                device=dev)
        gt_boxes = gt_data[..., 1:5]
    gt_valid = torch.arange(g, device=dev)[None, :] < gt_lens[:, None]
    # difficult gts stay matchable but are IGNORED (neither TP nor FP,
    # and excluded from the gt count) when evaluate_difficult is off —
    # the reference/VOC protocol
    gt_counted = gt_valid if evaluate_difficult else gt_valid & ~difficult

    det_label = det[..., 0].to(torch.int64)
    det_score = det[..., 1]
    det_boxes = det[..., 2:6]
    det_valid = det_label >= 0

    # VOC matching in score order: each detection pairs with its single
    # max-IoU same-class gt; TP if above threshold and unclaimed, FP if
    # claimed or below threshold, ignored if the gt is difficult and
    # difficult evaluation is off
    order = torch.argsort(-det_score, dim=1, stable=True)       # [B, K]
    used = torch.zeros((b, g), dtype=torch.bool, device=dev)
    gpos = torch.arange(g, device=dev)[None, :]
    hits, igns = [], []
    for i in range(k):
        di = order[:, i:i + 1]                                  # [B, 1]
        iou = _iou_matrix(_take_rows(det_boxes, di), gt_boxes)[:, 0]
        same = gt_valid & (gt_label == torch.gather(det_label, 1, di))
        best = torch.argmax(torch.where(same, iou, -1.0), dim=1,
                            keepdim=True)                       # [B, 1]
        best_iou = torch.where(torch.gather(same, 1, best),
                               torch.gather(iou, 1, best), -1.0)
        over = (best_iou >= overlap) & torch.gather(det_valid, 1, di)
        hit = over & ~torch.gather(used, 1, best)
        ign = over & torch.gather(difficult, 1, best) \
            if not evaluate_difficult else torch.zeros_like(over)
        used = used | ((gpos == best) & over)
        hits.append(hit & ~ign)
        igns.append(ign)
    # back from score order to slot order
    tps = torch.zeros((b, k), dtype=torch.bool, device=dev).scatter(
        1, order, torch.cat(hits, dim=1))
    ignored = torch.zeros((b, k), dtype=torch.bool, device=dev).scatter(
        1, order, torch.cat(igns, dim=1))

    flat_label = det_label.reshape(-1)
    flat_score = det_score.reshape(-1)
    flat_tp = tps.reshape(-1)
    flat_valid = det_valid.reshape(-1) & ~ignored.reshape(-1)

    # every class's AP at once: [C, B*K] masks, each row sorted by score
    classes = torch.arange(class_num, device=dev)
    mask = flat_valid[None] & (flat_label[None] == classes[:, None])
    gt_count = (gt_counted[None] & (gt_label[None] == classes[:, None, None])
                ).sum(dim=(1, 2))                               # [C]
    s = torch.where(mask, flat_score[None], NEG_INF)
    cls_order = torch.argsort(-s, dim=1, stable=True)
    tp = torch.gather(flat_tp[None] & mask, 1, cls_order).to(torch.float32)
    valid = torch.gather(mask, 1, cls_order).to(torch.float32)
    tp_cum = torch.cumsum(tp, dim=1)
    fp_cum = torch.cumsum(valid - tp, dim=1)
    recall = tp_cum / torch.clamp(gt_count, min=1)[:, None]
    precision = tp_cum / torch.clamp(tp_cum + fp_cum, min=1e-12)
    if attrs.get("ap_version", "integral") == "11point":
        # jnp.linspace(0, 1, 11)'s float32 points, bit for bit (0.9 is
        # 9 * 0.1f there, one ulp above float32(0.9))
        pts = torch.arange(11, dtype=torch.float32, device=dev) * \
            torch.tensor(0.1, dtype=torch.float32, device=dev)
        pmax = torch.amax(torch.where(recall[:, None, :] >= pts[None, :, None],
                                      precision[:, None, :], 0.0), dim=2)
        ap = pmax.mean(dim=1)
    else:
        prev = torch.cat([torch.zeros_like(recall[:, :1]), recall[:, :-1]],
                         dim=1)
        ap = torch.sum((recall - prev) * precision * valid, dim=1)
    present = gt_count > 0
    aps = torch.where(present, ap, 0.0)
    if background >= 0:
        bg = classes == background
        present = present & ~bg
        aps = torch.where(bg, 0.0, aps)
    n_present = torch.clamp(present.sum(), min=1)
    m_ap = (aps.sum() / n_present).to(torch.float32)
    match_info = torch.stack(
        [flat_label.to(torch.float32), flat_score,
         flat_tp.to(torch.float32), flat_valid.to(torch.float32)], dim=-1)
    return {"MAP": [m_ap], "MatchInfo": [match_info],
            "GTCount": [gt_count.to(torch.int32)]}
