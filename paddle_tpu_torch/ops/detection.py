"""Detection op lowerings: the SSD family and the Faster R-CNN / RPN family.

Port of ``paddle_tpu/ops/detection.py`` (capability parity with
paddle/fluid/operators/detection/: iou_similarity, box_coder,
prior_box, bipartite_match, target_assign, multiclass_nms,
polygon_box_transform, ssd_loss, anchor_generator, rpn_target_assign,
generate_proposals, generate_proposal_labels).

Every op keeps the reference's fixed shapes: NMS fills ``keep_top_k``
slots and marks empty ones with label -1, the samplers fill fixed
fg/bg slots with zero-gradient padding. The reference's ``lax.scan``
loops (greedy matching, the NMS suppression, the iterative proposal
pick) become one torch loop each, batched over the images (and the
classes): no Python loop over the batch, and no host read inside a
loop. Orders follow the reference's stable ``lax.top_k`` / ``argsort``
(ties to the lower index), through ``moe._top_k`` and stable sorts.

The two samplers (``rpn_target_assign``, ``generate_proposal_labels``)
draw their uniform noise from a CPU ``torch.Generator`` seeded with
``ctx.next_seed()`` and move it to the device, so a step on the card
samples the anchors and RoIs the same step on the host samples. The
reference draws with ``jax.random``, so the two packages are held to
the distribution, or compared where the quotas do not bind.
"""
import torch

from ..core.registry import canonical_int, register_op
from ..core.sequence import SequenceBatch
from .moe import _top_k

NEG_INF = -1e30


def _iou_matrix(a, b, normalized=True):
    """a [..., M, 4], b [..., N, 4] in (xmin, ymin, xmax, ymax) ->
    [..., M, N] IoU, the leading axes broadcast. ``normalized=False``
    applies the reference's +1 pixel-coordinate width/height
    correction."""
    off = 0.0 if normalized else 1.0
    area_a = torch.clamp(a[..., 2] - a[..., 0] + off, min=0) * \
        torch.clamp(a[..., 3] - a[..., 1] + off, min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0] + off, min=0) * \
        torch.clamp(b[..., 3] - b[..., 1] + off, min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt + off, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def _take_rows(x, idx):
    """x [B, N, K], idx [B, ...] -> x[b, idx[b]] of shape [B, ..., K]."""
    flat = idx.reshape(idx.shape[0], -1)
    out = torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1]))
    return out.reshape(*idx.shape, x.shape[-1])


def _stable_rank(score):
    """Rank of each entry of ``score`` [..., N] in descending order, ties
    to the lower index (the reference's ``argsort(argsort(-score))``)."""
    order = torch.argsort(-score, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


@register_op("iou_similarity")
def _iou_similarity(ctx, ins, attrs):
    return {"Out": [_iou_matrix(ins["X"][0], ins["Y"][0])]}


def _encode_center_size(target, prior, var):
    """target/prior [*, 4] corner boxes -> offsets (reference box_coder
    encode_center_size)."""
    pw = prior[..., 2] - prior[..., 0]
    ph = prior[..., 3] - prior[..., 1]
    pcx = (prior[..., 0] + prior[..., 2]) / 2
    pcy = (prior[..., 1] + prior[..., 3]) / 2
    tw = target[..., 2] - target[..., 0]
    th = target[..., 3] - target[..., 1]
    tcx = (target[..., 0] + target[..., 2]) / 2
    tcy = (target[..., 1] + target[..., 3]) / 2
    out = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph,
                       torch.log(torch.clamp(tw / pw, min=1e-10)),
                       torch.log(torch.clamp(th / ph, min=1e-10))], dim=-1)
    return out / var


def _decode_center_size(code, prior, var):
    pw = prior[..., 2] - prior[..., 0]
    ph = prior[..., 3] - prior[..., 1]
    pcx = (prior[..., 0] + prior[..., 2]) / 2
    pcy = (prior[..., 1] + prior[..., 3]) / 2
    c = code * var
    cx = c[..., 0] * pw + pcx
    cy = c[..., 1] * ph + pcy
    w = torch.exp(c[..., 2]) * pw
    h = torch.exp(c[..., 3]) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


@register_op("box_coder")
def _box_coder(ctx, ins, attrs):
    prior = ins["PriorBox"][0]                       # [M, 4]
    var = ins["PriorBoxVar"][0] if ins.get("PriorBoxVar") else \
        torch.ones_like(prior)
    target = ins["TargetBox"][0]
    code_type = attrs.get("code_type", "encode_center_size")
    if code_type.lower().endswith("encode_center_size"):
        out = _encode_center_size(target, prior, var)
    else:
        # decode: target codes may be [B, M, 4] against [M, 4] priors
        out = _decode_center_size(target, prior, var)
    return {"OutputBox": [out]}


@register_op("prior_box")
def _prior_box(ctx, ins, attrs):
    """SSD priors for one feature map (reference prior_box_op.h): for
    every cell, boxes at each (min_size, aspect_ratio) plus the
    sqrt(min*max) box."""
    feat = ins["Input"][0]                           # [B, C, H, W]
    image = ins["Image"][0]                          # [B, C, IH, IW]
    dev = feat.device
    h, w = feat.shape[2], feat.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes", [])]
    ars = [1.0]
    for ar in attrs.get("aspect_ratios", [1.0]):
        ar = float(ar)
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(ar)
            if attrs.get("flip", False):
                ars.append(1.0 / ar)
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    step_w = attrs.get("step_w", 0.0) or img_w / w
    step_h = attrs.get("step_h", 0.0) or img_h / h
    offset = attrs.get("offset", 0.5)

    # box widths/heights per prior kind (static python); ordering
    # follows the reference's min_max_aspect_ratios_order switch so conv
    # head channels pair with the same priors
    min_max_order = attrs.get("min_max_aspect_ratios_order", False)
    whs = []
    for k, ms in enumerate(min_sizes):
        whs.append((ms, ms))
        ar_boxes = [(ms * (ar ** 0.5), ms / (ar ** 0.5))
                    for ar in ars if abs(ar - 1.0) > 1e-6]
        max_boxes = []
        if max_sizes:
            big = (ms * max_sizes[k]) ** 0.5
            max_boxes.append((big, big))
        if min_max_order:
            whs.extend(max_boxes + ar_boxes)
        else:
            whs.extend(ar_boxes + max_boxes)
    f32 = dict(dtype=torch.float32, device=dev)
    whs = torch.tensor(whs, **f32)                   # [P, 2]

    cx = (torch.arange(w, **f32) + offset) * step_w
    cy = (torch.arange(h, **f32) + offset) * step_h
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")  # [H, W]
    centers = torch.stack([cxg, cyg], dim=-1)        # [H, W, 2]
    half = whs / 2                                   # [P, 2]
    size = torch.tensor([img_w, img_h], **f32)
    mins = (centers[:, :, None, :] - half[None, None]) / size
    maxs = (centers[:, :, None, :] + half[None, None]) / size
    boxes = torch.cat([mins, maxs], dim=-1)          # [H, W, P, 4]
    if attrs.get("clip", False):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    boxes = boxes.reshape(-1, 4)
    var = torch.tensor(variances, **f32)[None].expand(boxes.shape[0], 4)
    return {"Boxes": [boxes], "Variances": [var.contiguous()]}


def _bipartite_match(dist):
    """Greedy argmax matching (reference bipartite_match_op.cc), batched:
    pick each image's globally best (row, col) pair, retire both, repeat.
    dist [B, M, N] (M ground-truths, N priors). Returns (col->row match
    [B, N], col match dist [B, N]); unmatched cols get -1."""
    b, m, n = dist.shape
    row_free = torch.ones((b, m), dtype=torch.bool, device=dist.device)
    col_match = torch.full((b, n), -1, dtype=canonical_int(),
                           device=dist.device)
    col_dist = torch.zeros((b, n), dtype=dist.dtype, device=dist.device)
    cols = torch.arange(n, device=dist.device)
    rows = torch.arange(m, device=dist.device)
    d = dist
    for _ in range(min(m, n)):
        masked = torch.where(row_free[:, :, None], d, NEG_INF)
        flat = masked.reshape(b, -1)
        pick = torch.argmax(flat, dim=1)
        best = torch.gather(flat, 1, pick[:, None])[:, 0]
        r, c = pick // n, pick % n
        ok = best > NEG_INF / 2
        at_col = (cols[None] == c[:, None]) & ok[:, None]      # [B, N]
        col_match = torch.where(at_col, r[:, None], col_match)
        col_dist = torch.where(at_col, best[:, None], col_dist)
        row_free = row_free & ~((rows[None] == r[:, None]) & ok[:, None])
        d = torch.where(at_col[:, None, :], NEG_INF, d)
    return col_match, col_dist


def _per_prediction(dist, col_match, col_dist, threshold):
    """Also match every unmatched column to its best row when that
    distance clears ``threshold`` (dist [B, M, N])."""
    best_val = torch.amax(dist, dim=1)
    best_row = torch.argmax(dist, dim=1)    # first of ties, as jnp.argmax
    extra = (col_match < 0) & (best_val >= threshold)
    return (torch.where(extra, best_row, col_match),
            torch.where(extra, best_val, col_dist))


@register_op("bipartite_match")
def _bipartite_match_op(ctx, ins, attrs):
    dist = ins["DistMat"][0]
    if dist.dim() == 2:
        dist = dist[None]
    col_match, col_dist = _bipartite_match(dist)
    if attrs.get("match_type", "bipartite") == "per_prediction":
        col_match, col_dist = _per_prediction(
            dist, col_match, col_dist, attrs.get("dist_threshold", 0.5))
    return {"ColToRowMatchIndices": [col_match],
            "ColToRowMatchDist": [col_dist]}


@register_op("target_assign")
def _target_assign(ctx, ins, attrs):
    """Gather per-prior targets by match index (reference
    target_assign_op.h). X [B, M, K] per-gt targets, MatchIndices
    [B, N] (col->gt row or -1). Out [B, N, K]; OutWeight [B, N, 1]
    zero for unmatched (mismatch_value fills the target)."""
    x = ins["X"][0]
    match = ins["MatchIndices"][0].to(torch.int64)
    gathered = _take_rows(x, torch.clamp(match, min=0))
    matched = (match >= 0)[..., None]
    out = torch.where(matched, gathered,
                      torch.full_like(gathered,
                                      attrs.get("mismatch_value", 0)))
    weight = matched.to(x.dtype)
    if ins.get("NegIndices"):
        # mined negatives get weight 1 with the mismatch (background)
        # target, so they contribute to the confidence loss (reference
        # target_assign_op.h NegIndices path). Dense [B, Nn], -1 pads.
        neg = ins["NegIndices"][0]
        if isinstance(neg, SequenceBatch):
            neg_idx = neg.data
            pos_valid = torch.arange(neg_idx.shape[1],
                                     device=neg_idx.device)[None, :] < \
                neg.lengths[:, None]
        else:
            neg_idx = neg
            pos_valid = neg_idx >= 0
        if neg_idx.dim() == 3:
            neg_idx = neg_idx[..., 0]
            pos_valid = pos_valid if pos_valid.dim() == 2 \
                else pos_valid[..., 0]
        neg_idx = neg_idx.to(torch.int64)
        n = weight.shape[1]
        # the reference's .at[].max(mode="drop"): pads scatter into one
        # spare slot past the end, which is then cut off
        safe = torch.where(pos_valid & (neg_idx >= 0) & (neg_idx < n),
                           neg_idx, n)
        w = torch.cat([weight[..., 0], weight.new_zeros(weight.shape[0],
                                                        1)], dim=1)
        w = w.scatter_reduce(1, safe, torch.ones_like(safe, dtype=w.dtype),
                             reduce="amax")
        weight = w[:, :n, None]
    return {"Out": [out], "OutWeight": [weight]}


def _suppress(iou, live, thr, eta):
    """The reference's NMSFast suppression scan, batched over the leading
    axes: for i in order, a live box i suppresses every later live box
    whose IoU with it exceeds the threshold, and the adaptive threshold
    decays by ``eta`` (while above 0.5) after every live box. iou
    [..., T, T], live [..., T] bool, thr a float -> the live mask after
    the scan. One loop of T steps, no host read."""
    t = live.shape[-1]
    later = torch.ones((t, t), dtype=torch.bool,
                       device=live.device).triu(1)   # j > i
    if eta >= 1.0:
        # a fixed threshold: the suppression masks are known up front,
        # two launches a step
        keeps = ~((iou > thr) & later)
        for i in range(t):
            live = torch.where(live[..., i:i + 1], live & keeps[..., i, :],
                               live)
        return live
    thr = torch.full(live.shape[:-1] + (1,), thr, dtype=iou.dtype,
                     device=live.device)
    for i in range(t):
        alive_i = live[..., i:i + 1]
        sup = (iou[..., i, :] > thr) & later[i] & alive_i
        live = live & ~sup
        thr = torch.where(alive_i & (thr > 0.5), thr * eta, thr)
    return live


def _nms(boxes, scores, score_threshold, nms_threshold, nms_top_k,
         keep_top_k, normalized=True, eta=1.0):
    """Per-class NMS over each image, fixed shapes. boxes [B, N, 4],
    scores [B, C, N]. Returns (labels [B, keep_top_k], kept_scores,
    kept_boxes) with label -1 in empty slots."""
    b, c, n = scores.shape
    top = min(nms_top_k if nms_top_k > 0 else n, n)
    s, order = _top_k(scores, top)                   # [B, C, top]
    cand = _take_rows(boxes, order.reshape(b, c * top)).reshape(
        b, c, top, 4)
    iou = _iou_matrix(cand, cand, normalized=normalized)
    keep = _suppress(iou, s > score_threshold, nms_threshold, eta)
    flat = torch.where(keep, s, NEG_INF).reshape(b, c * top)
    k = min(keep_top_k if keep_top_k > 0 else flat.shape[1], flat.shape[1])
    best, best_idx = _top_k(flat, k)
    labels = best_idx // top
    box_idx = torch.gather(order.reshape(b, c * top), 1, best_idx)
    kept_boxes = _take_rows(boxes, box_idx)
    valid = best > NEG_INF / 2
    labels = torch.where(valid, labels, -1)
    best = torch.where(valid, best, 0.0)
    kept_boxes = torch.where(valid[..., None], kept_boxes, 0.0)
    return labels, best, kept_boxes


@register_op("multiclass_nms")
def _multiclass_nms(ctx, ins, attrs):
    boxes = ins["BBoxes"][0]                         # [B, N, 4]
    scores = ins["Scores"][0]                        # [B, C, N]
    background_label = attrs.get("background_label", 0)
    if background_label >= 0:
        is_bg = torch.arange(scores.shape[1], device=scores.device) == \
            background_label
        scores = torch.where(is_bg[None, :, None], NEG_INF, scores)
    labels, kept_scores, kept_boxes = _nms(
        boxes, scores, attrs.get("score_threshold", 0.0),
        attrs.get("nms_threshold", 0.3), attrs.get("nms_top_k", -1),
        attrs.get("keep_top_k", -1), normalized=attrs.get("normalized",
                                                          True),
        eta=attrs.get("nms_eta", 1.0))
    # reference emits LoD [label, score, x1, y1, x2, y2]; dense form:
    out = torch.cat([labels[..., None].to(kept_scores.dtype),
                     kept_scores[..., None], kept_boxes], dim=-1)
    return {"Out": [out]}


@register_op("polygon_box_transform")
def _polygon_box_transform(ctx, ins, attrs):
    """(reference polygon_box_transform_op.cc): input [B, 2K, H, W] of
    offsets; even channels get x-coords added, odd channels y."""
    x = ins["Input"][0]
    _, c, h, w = x.shape
    xs = torch.arange(w, dtype=x.dtype, device=x.device)[None, :].expand(h, w)
    ys = torch.arange(h, dtype=x.dtype, device=x.device)[:, None].expand(h, w)
    grid = torch.stack([xs, ys]).repeat(c // 2, 1, 1)   # [C, H, W]
    return {"Output": [grid[None] * 4 - x]}


def _smooth_l1(x):
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def _seq_labels(v):
    lab = v.data
    if lab.dim() == 3:
        lab = lab[..., 0]
    return lab.to(torch.int64)


@register_op("ssd_loss", seq_aware=True)
def _ssd_loss(ctx, ins, attrs):
    """Fused SSD multibox loss — the reference composes iou_similarity →
    bipartite_match → mine_hard_examples → target_assign → smooth_l1 +
    softmax_with_cross_entropy (detection.py ssd_loss); here, as in the
    JAX package, one masked dense computation, batched over images."""
    loc = ins["Location"][0]                         # [B, Np, 4]
    conf = ins["Confidence"][0]                      # [B, Np, C]
    gt_box = ins["GTBox"][0]                         # SequenceBatch
    prior = ins["PriorBox"][0]                       # [Np, 4]
    var = ins["PriorBoxVar"][0] if ins.get("PriorBoxVar") else \
        torch.ones_like(prior)
    background = attrs.get("background_label", 0)
    neg_pos_ratio = attrs.get("neg_pos_ratio", 3.0)
    loc_w = attrs.get("loc_loss_weight", 1.0)
    conf_w = attrs.get("conf_loss_weight", 1.0)

    gt_boxes, gt_lens = gt_box.data, gt_box.lengths
    labels = _seq_labels(ins["GTLabel"][0])
    g = gt_boxes.shape[1]
    valid_gt = torch.arange(g, device=loc.device)[None, :] < \
        gt_lens[:, None]                             # [B, G]
    dist = torch.where(valid_gt[:, :, None], _iou_matrix(gt_boxes, prior),
                       NEG_INF)                      # [B, G, Np]
    col_match, col_dist = _bipartite_match(dist)
    if attrs.get("match_type", "per_prediction") == "per_prediction":
        col_match, col_dist = _per_prediction(
            dist, col_match, col_dist,
            attrs.get("overlap_threshold", 0.5))
    matched = col_match >= 0
    safe_idx = torch.clamp(col_match, min=0)

    # confidence loss on every prior (target = matched gt label or bg)
    tgt_label = torch.where(matched, torch.gather(labels, 1, safe_idx),
                            background)
    logp = torch.log_softmax(conf, dim=-1)
    conf_loss_all = -torch.gather(logp, 2, tgt_label[..., None])[..., 0]

    # max-negative mining: hardest unmatched priors, ratio-capped
    num_pos = matched.sum(dim=1)
    neg_cand = (~matched) & (col_dist < attrs.get("neg_overlap", 0.5))
    neg_score = torch.where(neg_cand, conf_loss_all.detach(), NEG_INF)
    rank = _stable_rank(neg_score)
    num_neg = torch.minimum((neg_pos_ratio * num_pos).to(torch.int64),
                            neg_cand.sum(dim=1))
    selected_neg = neg_cand & (rank < num_neg[:, None])
    conf_loss = conf_loss_all * (matched | selected_neg).to(conf.dtype)

    # localization loss on positives only
    enc = _encode_center_size(_take_rows(gt_boxes, safe_idx), prior, var)
    loc_loss = _smooth_l1(loc - enc).sum(-1) * matched.to(loc.dtype)

    total = conf_w * conf_loss + loc_w * loc_loss
    if attrs.get("normalize", True):
        total = total / torch.clamp(num_pos, min=1).to(total.dtype)[:, None]
    return {"Loss": [total[..., None]]}


# ---------------------------------------------------------------------------
# Faster-RCNN / RPN family. The reference runs these on host CPU with
# dynamic-size outputs (rpn_target_assign_op.cc, generate_proposals_op.cc,
# generate_proposal_labels_op.cc); here every output is fixed-shape with
# zero-gradient padding.

def _box_to_delta(ex, gt, weights=None, normalized=True):
    """Regression deltas from ex(anchor/roi) to gt (reference
    bbox_util.h BoxToDelta). Pixel boxes use the +1 width convention."""
    off = 0.0 if normalized else 1.0
    ex_w = ex[..., 2] - ex[..., 0] + off
    ex_h = ex[..., 3] - ex[..., 1] + off
    ex_cx = ex[..., 0] + 0.5 * ex_w
    ex_cy = ex[..., 1] + 0.5 * ex_h
    gt_w = gt[..., 2] - gt[..., 0] + off
    gt_h = gt[..., 3] - gt[..., 1] + off
    gt_cx = gt[..., 0] + 0.5 * gt_w
    gt_cy = gt[..., 1] + 0.5 * gt_h
    d = torch.stack([(gt_cx - ex_cx) / ex_w, (gt_cy - ex_cy) / ex_h,
                     torch.log(torch.clamp(gt_w / ex_w, min=1e-10)),
                     torch.log(torch.clamp(gt_h / ex_h, min=1e-10))],
                    dim=-1)
    if weights is not None:
        d = d / torch.tensor(weights, dtype=d.dtype, device=d.device)
    return d


@register_op("anchor_generator")
def _anchor_generator(ctx, ins, attrs):
    """(reference anchor_generator_op.h): per feature-map cell, one
    anchor per (aspect_ratio, anchor_size) — ratio loop outer — with
    base w/h snapped to integers like the reference."""
    feat = ins["Input"][0]                           # [B, C, H, W]
    h, w = feat.shape[2], feat.shape[3]
    sizes = [float(s) for s in attrs["anchor_sizes"]]
    ars = [float(a) for a in attrs["aspect_ratios"]]
    stride_w, stride_h = [float(s) for s in attrs["stride"]]
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    offset = float(attrs.get("offset", 0.5))

    whs = []
    area = stride_w * stride_h
    for ar in ars:
        base_w = round((area / ar) ** 0.5)
        base_h = round(base_w * ar)
        for size in sizes:
            whs.append((size / stride_w * base_w, size / stride_h * base_h))
    f32 = dict(dtype=torch.float32, device=feat.device)
    whs = torch.tensor(whs, **f32)                   # [A, 2]

    cx = torch.arange(w, **f32) * stride_w + offset * (stride_w - 1)
    cy = torch.arange(h, **f32) * stride_h + offset * (stride_h - 1)
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")  # [H, W]
    centers = torch.stack([cxg, cyg], dim=-1)        # [H, W, 2]
    half = 0.5 * (whs - 1.0)                         # [A, 2]
    mins = centers[:, :, None, :] - half[None, None]
    maxs = centers[:, :, None, :] + half[None, None]
    anchors = torch.cat([mins, maxs], dim=-1)        # [H, W, A, 4]
    var = torch.tensor(variances, **f32).expand(anchors.shape)
    return {"Anchors": [anchors], "Variances": [var.contiguous()]}


def _host_noise(ctx, shape, device):
    """Uniform [0, 1) noise of ``shape`` drawn from a CPU generator
    seeded with the op's draw (``ctx.next_seed()``), then moved to
    ``device``: the same step samples the same boxes on the card and on
    the host."""
    g = torch.Generator()
    g.manual_seed(ctx.next_seed())
    return torch.rand(shape, generator=g).to(device)


def _sample_mask(candidates, quota, noise):
    """Pick up to ``quota`` (an int or a [B] tensor) True entries of each
    row of ``candidates`` [B, N] uniformly at random (the reference's
    ReservoirSampling), as a bool mask — fixed shapes via randomized
    rank + threshold."""
    rank = _stable_rank(torch.where(candidates, noise, -1.0))
    if torch.is_tensor(quota):
        quota = quota[:, None]
    return candidates & (rank < quota)


@register_op("rpn_target_assign", stateful=True, seq_aware=True)
def _rpn_target_assign(ctx, ins, attrs):
    """Fused RPN target assignment (reference rpn_target_assign_op.cc):
    label anchors fg (best per gt, or IoU >= pos_thresh), bg
    (max IoU < neg_thresh), randomly subsample a fixed fg/bg budget,
    gather predictions and encode matched gt deltas.

    Fixed-shape outputs per image: F = rpn_batch_size*fg_fraction fg
    slots, S = rpn_batch_size score slots. Padded slots are constants
    with zero loss/gradient (loc: pred == target == 0; score: logit +20
    with label 1 → ~0 loss, no gradient into the model).
    """
    loc = ins["Loc"][0]                              # [B, M, 4]
    scores = ins["Scores"][0]                        # [B, M, 1]
    anchors = ins["Anchor"][0]                       # [M, 4]
    gt = ins["GtBox"][0]                             # SequenceBatch
    rpn_batch = int(attrs.get("rpn_batch_size_per_im", 256))
    n_fg = int(rpn_batch * float(attrs.get("fg_fraction", 0.25)))
    n_s = rpn_batch
    gt_boxes, gt_lens = gt.data, gt.lengths
    b, m_anch = loc.shape[0], anchors.shape[0]
    dev = loc.device
    noise = _host_noise(ctx, (b, 2, m_anch), dev)

    g = gt_boxes.shape[1]
    valid_gt = torch.arange(g, device=dev)[None, :] < gt_lens[:, None]
    iou = torch.where(valid_gt[:, :, None],
                      _iou_matrix(gt_boxes, anchors, normalized=False),
                      0.0)                           # [B, G, M]
    a2g_max = torch.amax(iou, dim=1)                 # [B, M]
    a2g_arg = torch.argmax(iou, dim=1)
    # (i) best anchor per valid gt is fg; padded gt rows scatter into a
    # spare slot past the end so they can't clobber anchor 0
    g2a_arg = torch.where(valid_gt, torch.argmax(iou, dim=2), m_anch)
    best_of_gt = torch.zeros((b, m_anch + 1), dtype=torch.bool, device=dev)
    best_of_gt = best_of_gt.scatter(1, g2a_arg, True)[:, :m_anch]
    fg_cand = best_of_gt | (a2g_max >= float(attrs.get(
        "rpn_positive_overlap", 0.7)))
    bg_cand = (~fg_cand) & (a2g_max < float(attrs.get(
        "rpn_negative_overlap", 0.3)))

    fg_sel = _sample_mask(fg_cand, n_fg, noise[:, 0])
    num_fg = fg_sel.sum(dim=1)
    bg_sel = _sample_mask(bg_cand, n_s - num_fg, noise[:, 1])

    # fg slots: indices of up to n_fg selected anchors in index order
    # (a stable top-k over the 0/1 mask), -1 padded
    _, fg_idx = _top_k(fg_sel.to(loc.dtype), n_fg)
    fg_ok = torch.gather(fg_sel, 1, fg_idx)
    safe_fg = torch.where(fg_ok, fg_idx, 0)
    pred_loc = torch.where(fg_ok[..., None], _take_rows(loc, safe_fg), 0.0)
    tgt_bbox = _box_to_delta(anchors[safe_fg],
                             _take_rows(gt_boxes,
                                        torch.gather(a2g_arg, 1, safe_fg)),
                             normalized=False)
    tgt_bbox = torch.where(fg_ok[..., None], tgt_bbox, 0.0)

    # score slots: the full n_s minibatch — fg and bg packed together so
    # back-fill negatives (sampled when fg falls short of quota,
    # reference SampleFgBgGt) are kept, not truncated
    sel_rank = fg_sel.to(loc.dtype) * 2.0 + bg_sel.to(loc.dtype)
    s_rank, s_idx = _top_k(sel_rank, n_s)
    s_ok = s_rank > 0
    pred_sc = torch.where(s_ok[..., None], _take_rows(scores, s_idx), 20.0)
    tgt_lbl = torch.where(s_ok, torch.gather(fg_sel, 1, s_idx),
                          True).to(canonical_int())
    return {"ScorePred": [pred_sc.reshape(b * n_s, 1)],
            "LocPred": [pred_loc.reshape(b * n_fg, 4)],
            "ScoreTarget": [tgt_lbl.reshape(b * n_s, 1)],
            "LocTarget": [tgt_bbox.reshape(b * n_fg, 4)]}


def _pick_iteratively(s_top, b_top, alive, thr, eta, k):
    """The reference's selection for large pre-NMS pools: ``k`` picks of
    the best live box, each retiring the boxes whose IoU with it
    exceeds the (adaptive) threshold — one [top]-sized IoU row a pick
    instead of a [top, top] matrix. Returns (picked index [B, k],
    picked score [B, k], NEG_INF where nothing was live)."""
    n, top = s_top.shape
    pos = torch.arange(top, device=s_top.device)
    thr = torch.full((n, 1), thr, dtype=s_top.dtype, device=s_top.device)
    idx_sel, sc_sel = [], []
    for _ in range(k):
        i = torch.argmax(torch.where(alive, s_top, NEG_INF), dim=1)
        good = torch.gather(alive, 1, i[:, None])            # [B, 1]
        iou_row = _iou_matrix(_take_rows(b_top, i[:, None]), b_top,
                              normalized=False)[:, 0]         # [B, top]
        alive = alive & (iou_row <= thr) & (pos[None] != i[:, None])
        if eta < 1.0:
            thr = torch.where(good & (thr > 0.5), thr * eta, thr)
        idx_sel.append(i)
        sc_sel.append(torch.where(good[:, 0],
                                  torch.gather(s_top, 1, i[:, None])[:, 0],
                                  NEG_INF))
    return torch.stack(idx_sel, dim=1), torch.stack(sc_sel, dim=1)


@register_op("generate_proposals")
def _generate_proposals(ctx, ins, attrs):
    """(reference generate_proposals_op.cc): decode RPN deltas against
    anchors, clip to image, drop boxes under min_size, top pre_nms_top_n
    by score, NMS, keep post_nms_top_n — all fixed-shape, zero-padded."""
    scores = ins["Scores"][0]                        # [N, A, H, W]
    deltas = ins["BboxDeltas"][0]                    # [N, 4A, H, W]
    info = ins["ImInfo"][0]                          # [N, 3] (h, w, scale)
    anchors = ins["Anchors"][0].reshape(-1, 4)       # [H*W*A, 4]
    variances = ins["Variances"][0].reshape(-1, 4)
    pre_n = int(attrs.get("pre_nms_topN", 6000))
    post_n = int(attrs.get("post_nms_topN", 1000))
    nms_thresh = float(attrs.get("nms_thresh", 0.5))
    min_size = float(attrs.get("min_size", 0.1))
    eta = float(attrs.get("eta", 1.0))

    n, a, h, w = scores.shape
    m = h * w * a
    # NCHW -> [H, W, A(,4)] flat, matching the anchor layout
    sc = scores.permute(0, 2, 3, 1).reshape(n, m)
    dl = deltas.reshape(n, a, 4, h, w).permute(0, 3, 4, 1, 2).reshape(
        n, m, 4)

    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    acx = anchors[:, 0] + 0.5 * aw
    acy = anchors[:, 1] + 0.5 * ah
    cx = acx + dl[..., 0] * variances[:, 0] * aw
    cy = acy + dl[..., 1] * variances[:, 1] * ah
    bw = torch.exp(torch.clamp(dl[..., 2] * variances[:, 2], max=10.0)) * aw
    bh = torch.exp(torch.clamp(dl[..., 3] * variances[:, 3], max=10.0)) * ah
    boxes = torch.stack([cx - 0.5 * bw, cy - 0.5 * bh,
                         cx + 0.5 * bw - 1.0, cy + 0.5 * bh - 1.0], dim=-1)
    # clip to image (reference ClipTiledBoxes)
    imh, imw = info[:, 0:1], info[:, 1:2]            # [N, 1]
    lim = torch.stack([imw - 1.0, imh - 1.0, imw - 1.0, imh - 1.0], dim=-1)
    boxes = torch.minimum(torch.clamp(boxes, min=0.0), lim)
    # filter small boxes (reference FilterBoxes: min_size scaled)
    ms = torch.clamp(min_size * info[:, 2:3], min=1.0)
    ws = boxes[..., 2] - boxes[..., 0] + 1.0
    hs = boxes[..., 3] - boxes[..., 1] + 1.0
    keep = (ws >= ms) & (hs >= ms) & \
        (boxes[..., 0] + 0.5 * ws <= imw) & (boxes[..., 1] + 0.5 * hs <= imh)
    s = torch.where(keep, sc, NEG_INF)
    top = min(pre_n, m)
    k = min(post_n, top)
    s_top, order = _top_k(s, top)
    b_top = _take_rows(boxes, order)
    live = s_top > NEG_INF / 2

    if top <= 2048:
        # dense path: one [top, top] IoU matrix + suppression scan
        iou = _iou_matrix(b_top, b_top, normalized=False)
        alive = _suppress(iou, live, nms_thresh, eta)
        fs, fi = _top_k(torch.where(alive, s_top, NEG_INF), k)
    else:
        # large pre_nms pools (reference default 6000): a [top, top]
        # matrix is O(top^2) memory — select the post_nms_top_n
        # survivors iteratively instead
        fi, fs = _pick_iteratively(s_top, b_top, live, nms_thresh, eta, k)
    ok = fs > NEG_INF / 2
    rois = torch.where(ok[..., None], _take_rows(b_top, fi), 0.0)
    probs = torch.where(ok, fs, 0.0)
    return {"RpnRois": [rois], "RpnRoiProbs": [probs[..., None]]}


@register_op("generate_proposal_labels", stateful=True, seq_aware=True)
def _generate_proposal_labels(ctx, ins, attrs):
    """(reference generate_proposal_labels_op.cc): append gt boxes to the
    proposals, match by IoU, sample a fixed fg/bg RoI minibatch, emit
    per-class bbox regression targets. Fixed [B, S, ...] outputs; padded
    rows have label -1 (mask them from the cls loss) and zero weights."""
    rois = ins["RpnRois"][0]                         # [B, R, 4]
    gt_box = ins["GtBoxes"][0]                       # SequenceBatch [G,4]
    batch_size = int(attrs.get("batch_size_per_im", 256))
    fg_fraction = float(attrs.get("fg_fraction", 0.25))
    reg_w = [float(v) for v in attrs.get("bbox_reg_weights",
                                         [0.1, 0.1, 0.2, 0.2])]
    n_cls = int(attrs["class_nums"])
    n_fg = int(round(fg_fraction * batch_size))
    gtb, glens = gt_box.data, gt_box.lengths
    gtc = _seq_labels(ins["GtClasses"][0])
    scales = ins["ImScales"][0].reshape(-1)
    b, g, dev = rois.shape[0], gtb.shape[1], rois.device
    noise = _host_noise(ctx, (b, 2, rois.shape[1] + g), dev)

    valid_gt = torch.arange(g, device=dev)[None, :] < glens[:, None]
    gt_scaled = gtb * scales[:, None, None]
    cand = torch.cat([rois, torch.where(valid_gt[..., None], gt_scaled,
                                        0.0)], dim=1)    # [B, R+G, 4]
    # match in the scaled coordinate frame the candidates live in, with
    # the reference's +1 pixel-width convention
    iou = torch.where(valid_gt[:, :, None],
                      _iou_matrix(gt_scaled, cand, normalized=False), 0.0)
    max_iou = torch.amax(iou, dim=1)                 # [B, R+G]
    argmax = torch.argmax(iou, dim=1)
    # non-box padding (all-zero candidate rows) never matches
    real = torch.any(cand != 0.0, dim=-1)
    fg_cand = real & (max_iou >= float(attrs.get("fg_thresh", 0.25)))
    bg_cand = real & (max_iou < float(attrs.get("bg_thresh_hi", 0.5))) & \
        (max_iou >= float(attrs.get("bg_thresh_lo", 0.0)))
    fg_sel = _sample_mask(fg_cand, n_fg, noise[:, 0])
    bg_sel = _sample_mask(bg_cand, batch_size - fg_sel.sum(dim=1),
                          noise[:, 1])
    # pack fg + back-fill bg into the full fixed minibatch (fg slots
    # lead; when fg is short, extra sampled bg fill the rest)
    sel_rank = fg_sel.to(rois.dtype) * 2.0 + bg_sel.to(rois.dtype)
    rank, idx = _top_k(sel_rank, batch_size)
    ok = rank > 0
    is_fg = torch.gather(fg_sel, 1, idx) & ok

    picked = _take_rows(cand, idx)
    out_rois = torch.where(ok[..., None], picked, 0.0)
    match = torch.gather(argmax, 1, idx)
    # -1 marks padded slots so losses can mask them out
    labels = torch.where(ok, torch.where(is_fg, torch.gather(gtc, 1, match),
                                         0), -1)
    deltas = _box_to_delta(picked, _take_rows(gt_scaled, match),
                           weights=reg_w, normalized=False)
    # per-class layout [S, 4*n_cls], only the matched class filled
    classes = torch.arange(n_cls, device=dev)
    onehot = (labels[..., None] == classes).to(deltas.dtype)  # [B, S, C]
    fg = is_fg.to(deltas.dtype)[..., None, None]
    tgt = (onehot[..., None] * deltas[..., None, :] * fg).reshape(
        b, batch_size, 4 * n_cls)
    w_in = (onehot[..., None] * torch.ones_like(deltas)[..., None, :]
            * fg).reshape(b, batch_size, 4 * n_cls)
    return {"Rois": [out_rois], "LabelsInt32": [labels.to(torch.int32)],
            "BboxTargets": [tgt], "BboxInsideWeights": [w_in],
            "BboxOutsideWeights": [w_in]}
