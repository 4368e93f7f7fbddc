"""Neural-network op lowering rules (port of ``paddle_tpu/ops/nn.py``):
the embedding lookup, ``layer_norm`` and ``group_norm``, ``dropout``,
the losses, ``label_smooth``, the norms and distances, the metrics
(``mean_iou``, ``accuracy``, ``auc``) and the composed
``scaled_dot_product_attention``; then each op's static infer and
numerics rules (the reference's, for the analysis package).

Every rule is plain torch, as XLA fused them in the reference. The
convolutions, pools, ``batch_norm``, ``lrn``, the interps, ``roi_pool``
and ``random_crop`` wait for ROADMAP.md item 'Conv nets and the
transpilers'; ``im2sequence``, ``hierarchical_sigmoid``, ``nce`` and
``row_conv`` for item 'Remaining op families and the zoo'
(``core/registry.py`` names each).
"""
import math

import torch

from ..core.registry import register_op


@register_op("lookup_table")
def _lookup_table(ctx, ins, attrs):
    """reference paddle/fluid/operators/lookup_table_op.cc. Ids [..., 1]
    or [...] int; a trailing dim of size 1 is squeezed; padding_idx rows
    return zeros."""
    w, ids = ins["W"][0], ins["Ids"][0]
    if ids.dim() and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    if ids.is_floating_point() or ids.dtype == torch.bool:
        ids = ids.to(torch.int64)
    pad = attrs.get("padding_idx", -1)
    out = w[ids]
    if pad is not None and pad != -1:
        out = out * (ids != pad).unsqueeze(-1).to(out.dtype)
    return {"Out": [out]}


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _hard_label(label):
    """Label [..., 1] or [...] int → [...] int64."""
    lbl = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 else label
    return lbl.to(torch.int64)


def _pick(x, lbl, ignore):
    """x[..., lbl] with ignored rows reading class 0, as [..., 1]."""
    safe = torch.where(lbl == ignore, torch.zeros_like(lbl), lbl)
    return torch.gather(x, -1, safe[..., None])


@register_op("cross_entropy")
def _cross_entropy(ctx, ins, attrs):
    """reference paddle/fluid/operators/cross_entropy_op.cc: X is a
    probability distribution [N, D]; Label is int64 [N, 1] (or soft
    [N, D])."""
    x, label = ins["X"][0], ins["Label"][0]
    eps = 1e-9
    if attrs.get("soft_label", False):
        out = -torch.sum(label * torch.log(x + eps), dim=-1, keepdim=True)
    else:
        lbl = _hard_label(label)
        ignore = attrs.get("ignore_index", -100)
        picked = _pick(x, lbl, ignore)
        out = torch.where((lbl == ignore)[..., None],
                          torch.zeros_like(picked), -torch.log(picked + eps))
    return {"Y": [out]}


@register_op("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ctx, ins, attrs):
    logits, label = ins["Logits"][0], ins["Label"][0]
    lsm = torch.log_softmax(logits, dim=-1)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * lsm, dim=-1, keepdim=True)
    else:
        lbl = _hard_label(label)
        ignore = attrs.get("ignore_index", -100)
        picked = _pick(lsm, lbl, ignore)
        loss = torch.where((lbl == ignore)[..., None],
                           torch.zeros_like(picked), -picked)
    out = {"Loss": [loss]}
    if ctx.wants("Softmax"):   # a train step's loss alone does not
        out["Softmax"] = [torch.exp(lsm)]
    return out


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs):
    return {"Out": [torch.sum(torch.square(ins["X"][0])).reshape((1,))]}


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------


@register_op("layer_norm")
def _layer_norm(ctx, ins, attrs):
    """Normalises over the dims from ``begin_norm_axis`` on (population
    variance), then the flattened ``Scale`` / ``Bias``; ``Mean`` and
    ``Variance`` are [prod(leading dims)]-shaped as the leading dims."""
    x = ins["X"][0]
    begin = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(begin, x.dim()))
    var, mean = torch.var_mean(x, dim=axes, keepdim=True, correction=0)
    y = (x - mean) * torch.rsqrt(var + attrs.get("epsilon", 1e-5))
    norm_shape = (1,) * begin + tuple(x.shape[begin:])
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(norm_shape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(norm_shape)
    lead = tuple(x.shape[:begin])
    return {"Y": [y], "Mean": [mean.reshape(lead)],
            "Variance": [var.reshape(lead)]}


@register_op("group_norm")
def _group_norm(ctx, ins, attrs):
    x = ins["X"][0]  # NCHW
    g = attrs.get("groups", 32)
    n, c = x.shape[:2]
    xr = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    axes = tuple(range(2, xr.dim()))
    var, mean = torch.var_mean(xr, dim=axes, keepdim=True, correction=0)
    y = ((xr - mean) * torch.rsqrt(var + attrs.get("epsilon", 1e-5))) \
        .reshape(x.shape)
    bshape = (1, c) + (1,) * (x.dim() - 2)
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(bshape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(bshape)
    return {"Y": [y], "Mean": [mean.reshape(n, g)],
            "Variance": [var.reshape(n, g)]}


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


@register_op("dropout", stateful=True)
def _dropout(ctx, ins, attrs):
    """reference dropout_op.cc. Train: keep each element with
    probability 1 - p (one draw from ``ctx.next_key()``);
    ``downgrade_in_infer`` (the default) keeps kept values as they are
    and scales by 1 - p at test time, ``upscale_in_train`` scales kept
    values by 1 / (1 - p) and leaves test time alone. Test mode comes
    from the ``is_test`` attribute (``clone(for_test=True)`` sets it) or
    from the run's mode."""
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    is_test = attrs.get("is_test", False) or ctx.is_test
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if is_test:
        out = x * (1.0 - p) if impl == "downgrade_in_infer" else x
        return {"Out": [out], "Mask": [torch.ones_like(x)]}
    keep = torch.rand(x.shape, generator=ctx.next_key(), device=x.device,
                      dtype=torch.float32) < (1.0 - p)
    mask = keep.to(x.dtype)
    if impl == "upscale_in_train":
        out = torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
    else:
        out = x * mask
    return {"Out": [out], "Mask": [mask]}


# ---------------------------------------------------------------------------
# more losses
# ---------------------------------------------------------------------------


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


@register_op("sigmoid_cross_entropy_with_logits")
def _sigmoid_ce(ctx, ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    loss = torch.clamp_min(x, 0) - x * label + _softplus(-torch.abs(x))
    loss = torch.where(label == attrs.get("ignore_index", -100),
                       torch.zeros_like(loss), loss)
    return {"Out": [loss]}


@register_op("square_error_cost")
def _square_error_cost(ctx, ins, attrs):
    return {"Out": [torch.square(ins["X"][0] - ins["Y"][0])]}


@register_op("smooth_l1_loss")
def _smooth_l1(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    sigma2 = attrs.get("sigma", 1.0) ** 2
    diff = x - y
    if ins.get("InsideWeight"):
        diff = diff * ins["InsideWeight"][0]
    ad = torch.abs(diff)
    loss = torch.where(ad < 1.0 / sigma2, 0.5 * sigma2 * diff * diff,
                       ad - 0.5 / sigma2)
    if ins.get("OutsideWeight"):
        loss = loss * ins["OutsideWeight"][0]
    out = torch.sum(loss.reshape(loss.shape[0], -1), dim=1, keepdim=True)
    return {"Out": [out], "Diff": [diff]}


@register_op("huber_loss")
def _huber_loss(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    d = attrs.get("delta", 1.0)
    r = y - x
    ar = torch.abs(r)
    loss = torch.where(ar <= d, 0.5 * r * r, d * (ar - 0.5 * d))
    return {"Out": [loss], "Residual": [r]}


@register_op("rank_loss")
def _rank_loss(ctx, ins, attrs):
    label, left, right = ins["Label"][0], ins["Left"][0], ins["Right"][0]
    d = left - right
    return {"Out": [_softplus(d) - label * d]}


@register_op("margin_rank_loss")
def _margin_rank_loss(ctx, ins, attrs):
    label, x1, x2 = ins["Label"][0], ins["X1"][0], ins["X2"][0]
    act = torch.clamp_min(-label * (x1 - x2) + attrs.get("margin", 0.0), 0)
    return {"Out": [act], "Activated": [(act > 0).to(x1.dtype)]}


@register_op("hinge_loss")
def _hinge_loss(ctx, ins, attrs):
    logits, label = ins["Logits"][0], ins["Labels"][0]
    return {"Loss": [torch.clamp_min(1.0 - (2 * label - 1) * logits, 0)]}


@register_op("log_loss")
def _log_loss(ctx, ins, attrs):
    pred, label = ins["Predicted"][0], ins["Labels"][0]
    eps = attrs.get("epsilon", 1e-4)
    out = -label * torch.log(pred + eps) \
        - (1 - label) * torch.log(1 - pred + eps)
    return {"Loss": [out]}


@register_op("kldiv_loss")
def _kldiv_loss(ctx, ins, attrs):
    x, target = ins["X"][0], ins["Target"][0]
    loss = target * (torch.log(torch.clamp_min(target, 1e-10)) - x)
    red = attrs.get("reduction", "mean")
    if red == "mean":
        loss = torch.mean(loss).reshape(())
    elif red == "sum":
        loss = torch.sum(loss).reshape(())
    elif red == "batchmean":
        loss = (torch.sum(loss) / x.shape[0]).reshape(())
    return {"Loss": [loss]}


@register_op("dice_loss")
def _dice_loss(ctx, ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    eps = attrs.get("epsilon", 1e-5)
    classes = torch.arange(x.shape[-1], device=x.device)
    lbl = (label.reshape(label.shape[:-1])[..., None] == classes) \
        .to(x.dtype)
    dims = tuple(range(1, x.dim()))
    inter = torch.sum(x * lbl, dim=dims)
    union = torch.sum(x, dim=dims) + torch.sum(lbl, dim=dims)
    return {"Out": [1 - (2 * inter + eps) / (union + eps)]}


@register_op("label_smooth")
def _label_smooth(ctx, ins, attrs):
    x = ins["X"][0]
    eps = attrs.get("epsilon", 0.1)
    if ins.get("PriorDist"):
        return {"Out": [(1 - eps) * x + eps * ins["PriorDist"][0]]}
    return {"Out": [(1 - eps) * x + eps / x.shape[-1]]}


@register_op("l1_norm")
def _l1_norm(ctx, ins, attrs):
    return {"Out": [torch.sum(torch.abs(ins["X"][0])).reshape((1,))]}


@register_op("squared_l2_distance")
def _squared_l2_distance(ctx, ins, attrs):
    d = ins["X"][0] - ins["Y"][0]
    return {"Out": [torch.sum(torch.square(d), dim=-1, keepdim=True)],
            "sub_result": [d]}


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


@register_op("mean_iou")
def _mean_iou(ctx, ins, attrs):
    pred, label = ins["Predictions"][0], ins["Labels"][0]
    n = attrs["num_classes"]
    p = pred.reshape(-1).to(torch.int64)
    lab = label.reshape(-1).to(torch.int64)
    cm = torch.zeros((n, n), dtype=torch.float32, device=pred.device)
    cm = cm.index_put((lab, p), torch.ones_like(p, dtype=torch.float32),
                      accumulate=True)
    inter = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    iou = torch.where(union > 0, inter / torch.clamp_min(union, 1),
                      torch.zeros_like(inter))
    valid = (union > 0).sum()
    return {"OutMeanIou": [iou.sum() / torch.clamp_min(valid, 1)],
            "OutWrong": [(union - inter).to(torch.int32)],
            "OutCorrect": [inter.to(torch.int32)]}


@register_op("accuracy")
def _accuracy(ctx, ins, attrs):
    """reference accuracy_op.cc: a row is right when any of its top-k
    ``Indices`` equals its label [N, 1]."""
    idx, label = ins["Indices"][0], ins["Label"][0]
    lbl = label.reshape(-1)
    correct = torch.any(idx == lbl[:, None].to(idx.dtype), dim=1)
    c = torch.sum(correct.to(torch.float32))
    n = lbl.shape[0]
    return {"Accuracy": [(c / n).reshape((1,))],
            "Correct": [c.to(torch.int32).reshape((1,))],
            "Total": [torch.full((1,), n, dtype=torch.int32,
                                 device=idx.device)]}


@register_op("auc")
def _auc(ctx, ins, attrs):
    """Streaming AUC (reference auc_op.cc): adds the batch to the
    persistable positive/negative score histograms and integrates the
    ROC curve over all of them by trapezoids."""
    preds, label = ins["Predict"][0], ins["Label"][0]
    stat_pos, stat_neg = ins["StatPos"][0], ins["StatNeg"][0]
    bins = stat_pos.shape[0]
    pos_score = preds[:, 1] if preds.dim() == 2 and preds.shape[1] == 2 \
        else preds.reshape(-1)
    idx = torch.clamp((pos_score * (bins - 1)).to(torch.int64), 0,
                      bins - 1)
    lbl = label.reshape(-1).to(torch.float32)
    stat_pos = stat_pos.index_add(0, idx, lbl)
    stat_neg = stat_neg.index_add(0, idx, 1.0 - lbl)
    tp = torch.cumsum(torch.flip(stat_pos, (0,)), 0)
    fp = torch.cumsum(torch.flip(stat_neg, (0,)), 0)
    tpr = tp / torch.clamp_min(tp[-1], 1.0)
    fpr = fp / torch.clamp_min(fp[-1], 1.0)
    zero = torch.zeros(1, device=tpr.device)
    tpr0 = torch.cat([zero, tpr[:-1]])
    fpr0 = torch.cat([zero, fpr[:-1]])
    auc = torch.sum((fpr - fpr0) * (tpr + tpr0) / 2.0)
    return {"AUC": [auc.reshape((1,))],
            "StatPosOut": [stat_pos], "StatNegOut": [stat_neg]}


# ---------------------------------------------------------------------------
# attention, composed (the flash kernels serve multihead_attention)
# ---------------------------------------------------------------------------


@register_op("scaled_dot_product_attention")
def _sdpa(ctx, ins, attrs):
    """softmax(Q·Kᵀ·scale + Mask)·V from plain matmuls, as the
    reference composes it (no kernel: the flash kernels serve
    ``multihead_attention``)."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    scale = attrs.get("scale", None) or (1.0 / math.sqrt(q.shape[-1]))
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if ins.get("Mask"):
        logits = logits + ins["Mask"][0]
    w = torch.softmax(logits, dim=-1)
    return {"Out": [torch.matmul(w, v)]}


# ---------------------------------------------------------------------------
# Static shape/dtype inference rules (analysis/infer.py engine) — the
# reference's (paddle_tpu/ops/nn.py) for the ops the port registers, pure
# shape arithmetic colocated with the lowerings above.
# ---------------------------------------------------------------------------
from ..analysis.infer import VarInfo, first_in, same_as  # noqa: E402
from ..core.registry import register_infer  # noqa: E402


@register_infer("layer_norm")
def _infer_layer_norm(op, ins, attrs):
    return {"Y": [same_as(first_in(ins, "X"))]}


@register_infer("group_norm")
def _infer_group_norm(op, ins, attrs):
    return {"Y": [same_as(first_in(ins, "X"))]}


@register_infer("label_smooth")
def _infer_label_smooth(op, ins, attrs):
    return {"Out": [same_as(first_in(ins, "X"))]}


@register_infer("lookup_table")
def _infer_lookup_table(op, ins, attrs):
    w, ids = first_in(ins, "W"), first_in(ins, "Ids")
    emb = w.shape[-1] if w.shape is not None and len(w.shape) else -1
    if ids.shape is None:
        return {"Out": [VarInfo(None, w.dtype, ids.lod_level)]}
    base = ids.shape[:-1] if ids.shape and ids.shape[-1] == 1 \
        else ids.shape
    return {"Out": [VarInfo(base + (emb,), w.dtype, ids.lod_level,
                            confident=w.confident and ids.confident)]}


@register_infer("dropout")
def _infer_dropout(op, ins, attrs):
    x = first_in(ins, "X")
    return {"Out": [same_as(x)], "Mask": [same_as(x)]}


def _loss_shape(x):
    """[N, ..., D] → [N, ..., 1] per-row loss."""
    if x.shape is None:
        return None
    return x.shape[:-1] + (1,)


@register_infer("cross_entropy")
def _infer_cross_entropy(op, ins, attrs):
    x = first_in(ins, "X")
    return {"Y": [VarInfo(_loss_shape(x), x.dtype,
                          confident=x.confident)]}


@register_infer("softmax_with_cross_entropy")
def _infer_softmax_ce(op, ins, attrs):
    logits = first_in(ins, "Logits")
    return {"Loss": [VarInfo(_loss_shape(logits), logits.dtype,
                             confident=logits.confident)],
            "Softmax": [same_as(logits)]}


@register_infer("sigmoid_cross_entropy_with_logits")
def _infer_sigmoid_ce(op, ins, attrs):
    return {"Out": [same_as(first_in(ins, "X"))]}


@register_infer("square_error_cost")
def _infer_square_error(op, ins, attrs):
    return {"Out": [same_as(first_in(ins, "X"))]}


@register_infer("accuracy")
def _infer_accuracy(op, ins, attrs):
    conf = first_in(ins, "Indices").confident
    return {"Accuracy": [VarInfo((1,), "float32", confident=conf)],
            "Correct": [VarInfo((1,), "int32", confident=conf)],
            "Total": [VarInfo((1,), "int32", confident=conf)]}


# ---------------------------------------------------------------------------
# Numerics transfer functions (analysis/numcheck.py) — value-range and
# finiteness behavior, colocated like the infer rules above. Pure
# interval arithmetic, no tensors.
# ---------------------------------------------------------------------------
from ..analysis.numcheck import (interval, num_first)  # noqa: E402
from ..core.registry import register_numerics  # noqa: E402


@register_numerics("layer_norm")
def _num_layer_norm(op, ins, attrs):
    return {"Y": [interval(-math.inf, math.inf)]}


@register_numerics("group_norm")
def _num_group_norm(op, ins, attrs):
    return {"Y": [interval(-math.inf, math.inf)]}


@register_numerics("label_smooth")
def _num_label_smooth(op, ins, attrs):
    x = num_first(ins, "X")
    return {"Out": [interval(min(x.lo, 0.0), max(x.hi, 1.0))]}


@register_numerics("lookup_table")
def _num_lookup_table(op, ins, attrs):
    w = num_first(ins, "W")
    return {"Out": [interval(w.lo, w.hi)]}


@register_numerics("dropout")
def _num_dropout(op, ins, attrs):
    """Train: mask then 1/(1-p) upscale; eval: identity or (1-p)
    downscale. Either way the range is the (0-joined) input range
    scaled by at most 1/(1-p)."""
    x = num_first(ins, "X")
    p = float(attrs.get("dropout_prob", 0.5))
    s = 1.0 / max(1.0 - p, 1e-6)
    return {"Out": [interval(min(x.lo * s, 0.0), max(x.hi * s, 0.0))],
            "Mask": [interval(0.0, s)]}


@register_numerics("cross_entropy")
def _num_cross_entropy(op, ins, attrs):
    """-log(p + 1e-9) (the lowering's epsilon): bounded and finite for
    probability inputs p ∈ [0, 1]; unproven otherwise (a negative p
    would put the log over a non-positive argument)."""
    x = num_first(ins, "X")
    if x.lo >= 0.0:
        hi = -math.log(max(x.lo, 0.0) + 1e-9)
        lo = 0.0 if x.hi == math.inf else min(-math.log(x.hi + 1e-9),
                                              0.0)
        return {"Y": [interval(lo, hi)]}
    return {"Y": [interval(-math.inf, math.inf, finite=False)]}


@register_numerics("softmax_with_cross_entropy")
def _num_softmax_ce(op, ins, attrs):
    # stable log-softmax formulation: finite for finite logits; loss
    # magnitude bounded by the logit spread, which seeds leave open
    return {"Loss": [interval(0.0, math.inf)],
            "Softmax": [interval(0.0, 1.0)]}


@register_numerics("sigmoid_cross_entropy_with_logits")
def _num_sigmoid_ce(op, ins, attrs):
    return {"Out": [interval(0.0, math.inf)]}


@register_numerics("square_error_cost")
def _num_square_error(op, ins, attrs):
    x, y = num_first(ins, "X"), num_first(ins, "Label")
    d = max(abs(x.hi - y.lo), abs(y.hi - x.lo))
    return {"Out": [interval(0.0, d * d if d < math.inf else math.inf)]}


@register_numerics("accuracy")
def _num_accuracy(op, ins, attrs):
    return {"Accuracy": [interval(0.0, 1.0)],
            "Correct": [interval(0.0, math.inf)],
            "Total": [interval(0.0, math.inf)]}
