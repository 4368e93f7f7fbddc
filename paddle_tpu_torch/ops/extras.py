"""Long-tail op lowerings completing registry parity with the
reference's operator directory (port of ``paddle_tpu/ops/extras.py``):
losses (modified_huber, minus), signal ops (conv_shift,
pad_constant_like), pooling variants (max_pool2d_with_index, unpool,
spp), ranking/classification metrics (positive_negative_pair,
precision_recall), quantization-aware training ops
(fake_quantize_abs_max, fake_dequantize_max_abs), the weight-norm
reparameterization, and the weight-only int8 ops
(``quantized_mul``, ``quantized_conv2d``) that
``transpiler/quantize_transpiler.py`` emits; then the infer and
numerics rules the reference registers beside them.

References: paddle/fluid/operators/{modified_huber_loss_op.h, minus_op.cc,
conv_shift_op.cc, pad_constant_like_op.cc, pool_with_index_op.cc,
unpool_op.cc, spp_op.cc, positive_negative_pair_op.h,
precision_recall_op.h, fake_quantize_op.cc}.
"""
import math

import torch
import torch.nn.functional as F

from ..core.registry import canonical_int, get_op, register_op


@register_op("minus")
def _minus(ctx, ins, attrs):
    return {"Out": [ins["X"][0] - ins["Y"][0]]}


@register_op("modified_huber_loss")
def _modified_huber_loss(ctx, ins, attrs):
    """X: [N, 1] predictions; Y: {0,1} labels. val = (2y-1) * x;
    loss = -4*val (val < -1), (1-val)^2 (-1 <= val < 1), 0 (val >= 1)."""
    x, y = ins["X"][0], ins["Y"][0]
    val = (2.0 * y.to(x.dtype) - 1.0) * x
    loss = torch.where(val < -1.0, -4.0 * val,
                       torch.where(val < 1.0, torch.square(1.0 - val), 0.0))
    return {"IntermediateVal": [val], "Out": [loss]}


@register_op("pad_constant_like")
def _pad_constant_like(ctx, ins, attrs):
    """Pad Y at the tail of every axis up to X's shape with pad_value."""
    x, y = ins["X"][0], ins["Y"][0]
    pads = []
    for xs, ys in reversed(list(zip(x.shape, y.shape))):
        pads += [0, xs - ys]
    return {"Out": [F.pad(y, pads, value=float(attrs.get("pad_value",
                                                         0.0)))]}


@register_op("conv_shift")
def _conv_shift(ctx, ins, attrs):
    """Circular correlation (reference conv_shift_op.cc): X [B, M],
    Y [B, N] (N odd, N <= M); out[b, i] = sum_j x[b, (i + j - N/2) % M]
    * y[b, j]."""
    x, y = ins["X"][0], ins["Y"][0]
    m, n = x.shape[1], y.shape[1]
    # gather the N diagonals of the circulant structure
    idx = (torch.arange(m, device=x.device)[:, None]
           + torch.arange(n, device=x.device)[None, :] - n // 2) % m
    windows = x[:, idx]                              # [B, M, N]
    return {"Out": [torch.einsum("bmn,bn->bm", windows, y)]}


def _two(v, default=None):
    if v is None:
        v = default
    return (v, v) if isinstance(v, int) else (v[0], v[1])


@register_op("max_pool2d_with_index")
def _max_pool2d_with_index(ctx, ins, attrs):
    """Max pooling that also returns the flat h*w index of each maximum
    (reference pool_with_index_op.cc) for later unpooling."""
    x = ins["X"][0]                                  # [B, C, H, W]
    kh, kw = _two(attrs["ksize"])
    sh, sw = _two(attrs.get("strides"), [kh, kw])
    ph, pw = _two(attrs.get("paddings"), [0, 0])
    b, c, h, w = x.shape
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w + 2 * pw - kw) // sw + 1
    dev = x.device
    xp = F.pad(x, (pw, pw, ph, ph), value=torch.finfo(x.dtype).min)
    flat_idx = torch.arange(h * w, device=dev).reshape(h, w).to(
        canonical_int())
    idxp = F.pad(flat_idx, (pw, pw, ph, ph), value=-1)
    # window gather: [OH, OW, KH, KW] index maps
    hs = torch.arange(oh, device=dev)[:, None] * sh + \
        torch.arange(kh, device=dev)[None, :]
    ws = torch.arange(ow, device=dev)[:, None] * sw + \
        torch.arange(kw, device=dev)[None, :]
    rows, cols = hs[:, None, :, None], ws[None, :, None, :]
    flat = xp[:, :, rows, cols].reshape(b, c, oh, ow, kh * kw)
    arg = torch.argmax(flat, dim=-1, keepdim=True)   # first of ties
    out = torch.gather(flat, -1, arg)[..., 0]
    mask = idxp[rows, cols].reshape(oh, ow, kh * kw)
    idx_out = torch.gather(mask.expand(b, c, oh, ow, kh * kw), -1,
                           arg)[..., 0]
    return {"Out": [out], "Mask": [idx_out]}


@register_op("unpool")
def _unpool(ctx, ins, attrs):
    """Scatter pooled values back to their recorded positions
    (reference unpool_op.cc; unpooling_type 'max'). An index past the
    map is dropped, a negative one counts from its end (the reference's
    ``.at[i].set(v, mode="drop")``)."""
    x, mask = ins["X"][0], ins["Indices"][0]
    b, c, oh, ow = x.shape
    uh, uw = attrs["unpooled_height"], attrs["unpooled_width"]
    hw = uh * uw
    flat_i = mask.reshape(b, c, oh * ow).to(torch.int64)
    flat_i = torch.where(flat_i < 0, flat_i + hw, flat_i)
    flat_i = torch.where((flat_i >= 0) & (flat_i < hw), flat_i, hw)
    out = x.new_zeros(b, c, hw + 1).scatter(2, flat_i,
                                            x.reshape(b, c, oh * ow))
    return {"Out": [out[..., :hw].reshape(b, c, uh, uw)]}


@register_op("spp")
def _spp(ctx, ins, attrs):
    """Spatial pyramid pooling (reference spp_op.cc): levels 0..P-1 pool
    to 2^l x 2^l bins (max or avg), flattened and concatenated."""
    x = ins["X"][0]
    ptype = attrs.get("pooling_type", "max")
    b, c, h, w = x.shape
    dev = x.device
    rows = torch.arange(h, device=dev)[None, :]
    cols = torch.arange(w, device=dev)[None, :]
    outs = []
    for level in range(attrs["pyramid_height"]):
        bins = 2 ** level
        # adaptive pooling via a masked reduce per bin:
        # start=floor(i*h/bins), end=ceil((i+1)*h/bins), so every bin is
        # non-empty even when bins > h
        i = torch.arange(bins, device=dev)
        y0, y1 = (i * h) // bins, -((-((i + 1) * h)) // bins)
        x0, x1 = (i * w) // bins, -((-((i + 1) * w)) // bins)
        rmask = (rows >= y0[:, None]) & (rows < y1[:, None])
        cmask = (cols >= x0[:, None]) & (cols < x1[:, None])
        m = rmask[:, None, :, None] & cmask[None, :, None, :]
        if ptype == "max":
            v = torch.where(m[None, None], x[:, :, None, None],
                            torch.finfo(x.dtype).min)
            pooled = torch.amax(v, dim=(4, 5))
        else:
            cnt = m.sum(dim=(2, 3)).to(x.dtype)
            v = torch.where(m[None, None], x[:, :, None, None], 0.0)
            pooled = v.sum(dim=(4, 5)) / torch.clamp(cnt, min=1.0)
        outs.append(pooled.reshape(b, c * bins * bins))
    return {"Out": [torch.cat(outs, dim=1)]}


@register_op("positive_negative_pair")
def _positive_negative_pair(ctx, ins, attrs):
    """Query-grouped ranking pair counts (reference
    positive_negative_pair_op.h): for items sharing a QueryID, a pair
    (i, j) with label_i > label_j is positive if score_i > score_j,
    negative if <, neutral if equal."""
    score = ins["Score"][0].reshape(-1)
    label = ins["Label"][0].reshape(-1)
    qid = ins["QueryID"][0].reshape(-1)
    pair = (qid[:, None] == qid[None, :]) & (label[:, None] > label[None, :])
    s_i, s_j = score[:, None], score[None, :]
    f = torch.float32
    pos = (pair & (s_i > s_j)).sum().to(f)
    neg = (pair & (s_i < s_j)).sum().to(f)
    neu = (pair & (s_i == s_j)).sum().to(f)
    if ins.get("AccumulatePositivePair"):
        pos = pos + ins["AccumulatePositivePair"][0].reshape(())
        neg = neg + ins["AccumulateNegativePair"][0].reshape(())
        neu = neu + ins["AccumulateNeutralPair"][0].reshape(())
    return {"PositivePair": [pos], "NegativePair": [neg],
            "NeutralPair": [neu]}


def _ratio(num, den):
    """num / den, 1.0 where den is 0 (reference precision_recall_op.h)."""
    return torch.where(den > 0, num / torch.clamp(den, min=1e-12), 1.0)


def _f1_of(p, r):
    return torch.where(p + r > 0, 2 * p * r / torch.clamp(p + r, min=1e-12),
                       0.0)


def _pr_metrics(s):
    """[macro P, R, F1, micro P, R, F1] of states [C, 4] (TP, FP, TN,
    FN): macro-F1 is the F1 of the macro-averaged precision/recall."""
    tp, fp, fn = s[:, 0], s[:, 1], s[:, 3]
    prec, rec = _ratio(tp, tp + fp), _ratio(tp, tp + fn)
    map_, mar = prec.mean(), rec.mean()
    tps, fps, fns = tp.sum(), fp.sum(), fn.sum()
    mp, mr = _ratio(tps, tps + fps), _ratio(tps, tps + fns)
    return torch.stack([map_, mar, _f1_of(map_, mar), mp, mr, _f1_of(mp, mr)])


@register_op("precision_recall")
def _precision_recall(ctx, ins, attrs):
    """Multi-class macro/micro precision/recall/F1 (reference
    precision_recall_op.h). Indices [N, 1] predicted class, Labels
    [N, 1]; optional per-instance Weights and accumulated StatesInfo
    [C, 4] of (TP, FP, TN, FN)."""
    idx = ins["Indices"][0].reshape(-1).to(torch.int64)
    lbl = ins["Labels"][0].reshape(-1).to(torch.int64)
    c = int(attrs["class_number"])
    f = torch.float32
    w = ins["Weights"][0].reshape(-1).to(f) if ins.get("Weights") \
        else torch.ones(idx.shape, dtype=f, device=idx.device)
    classes = torch.arange(c, device=idx.device)
    pred_1h = (idx[:, None] == classes).to(f) * w[:, None]
    true_1h = (lbl[:, None] == classes).to(f) * w[:, None]
    tp = (pred_1h * true_1h).sum(0)
    fp = pred_1h.sum(0) - tp
    fn = true_1h.sum(0) - tp
    tn = w.sum() - tp - fp - fn
    states = torch.stack([tp, fp, tn, fn], dim=1)    # [C, 4]
    acc_states = states + ins["StatesInfo"][0].to(f) \
        if ins.get("StatesInfo") else states
    return {"BatchMetrics": [_pr_metrics(states)],
            "AccumMetrics": [_pr_metrics(acc_states)],
            "AccumStatesInfo": [acc_states]}


def _quant_range(bits):
    return float((1 << (bits - 1)) - 1)


@register_op("fake_quantize_abs_max")
def _fake_quantize_abs_max(ctx, ins, attrs):
    """QAT fake quantization (reference fake_quantize_op.cc): scale =
    max|x|, Out = round(x / scale * range) in the QUANTIZED domain —
    pair with fake_dequantize_max_abs to return to real values. The
    gradient is straight-through identity (the reference grad op passes
    dOut through unscaled)."""
    x = ins["X"][0]
    r = _quant_range(int(attrs.get("bit_length", 8)))
    scale = torch.amax(torch.abs(x)).to(torch.float32)
    q = torch.round(x / torch.clamp(scale, min=1e-8) * r)
    out = x + (q - x).detach()                       # STE, identity grad
    return {"Out": [out], "OutScale": [scale]}


@register_op("fake_dequantize_max_abs")
def _fake_dequantize_max_abs(ctx, ins, attrs):
    x = ins["X"][0]
    scale = ins["Scale"][0].reshape(())
    r = float(attrs.get("max_range", _quant_range(8)))
    return {"Out": [x * scale / r]}


def _norm_except_dim(v, dim):
    """||v|| over all axes except ``dim`` (keepdims); dim<0 → over all
    axes (scalar-keepdims). Reference layer_helper.py __norm_except_dim."""
    if dim is None or dim < 0:
        return torch.sqrt(torch.sum(v * v))
    axes = tuple(i for i in range(v.dim()) if i != dim)
    return torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))


@register_op("weight_norm")
def _weight_norm(ctx, ins, attrs):
    """Effective weight of a weight-normalized parameter (reference
    layer_helper.py _create_weight_normalize:112): W = G * V / ||V||
    with the norm over every axis except ``dim``. V and G are the
    trainable parameters; W is a per-step intermediate."""
    v, g = ins["V"][0], ins["G"][0]
    dim = int(attrs.get("dim", -1))
    norm = _norm_except_dim(v, dim)
    if dim < 0:
        w = g.reshape(()) * v / norm
    else:
        gshape = [1] * v.dim()
        gshape[dim] = -1
        w = g.reshape(gshape) * v / norm
    return {"W": [w]}


@register_op("weight_norm_g_init")
def _weight_norm_g_init(ctx, ins, attrs):
    """Startup-program op: G = ||V|| so the initial effective weight
    equals the initialized V (reference startup __norm_except_dim on the
    freshly-initialized v)."""
    v = ins["V"][0]
    return {"G": [_norm_except_dim(v, int(attrs.get("dim", -1))).reshape(-1)]}


def _dequant_weight(ins, axis, like_dtype):
    """int8 weight * per-channel scale → the activation's dtype (bf16
    under amp), shaped for broadcast."""
    wq, scale = ins["Y" if "Y" in ins else "Filter"][0], ins["Scale"][0]
    shape = [1] * wq.dim()
    shape[axis] = -1
    return wq.to(like_dtype) * scale.to(like_dtype).reshape(shape)


@register_op("quantized_mul", seq_aware=True)
def _quantized_mul(ctx, ins, attrs):
    """Weight-only int8 mul (QuantizeTranspiler): the weight is stored
    int8 with one scale a column and dequantized ahead of ``mul``'s own
    rule (which takes a SequenceBatch X as it is)."""
    x = ins["X"][0]
    x_dtype = getattr(x, "data", x).dtype
    new_ins = {k: v for k, v in ins.items() if k != "Scale"}
    new_ins["Y"] = [_dequant_weight(ins, axis=1, like_dtype=x_dtype)]
    return get_op("mul").lower(ctx, new_ins, attrs)


@register_op("quantized_conv2d")
def _quantized_conv2d(ctx, ins, attrs):
    """Weight-only int8 conv2d: per-out-channel scales (axis 0 of
    OIHW), dequantized ahead of conv2d's own rule."""
    new_ins = {k: v for k, v in ins.items() if k != "Scale"}
    new_ins["Filter"] = [_dequant_weight(ins, axis=0,
                                         like_dtype=ins["Input"][0].dtype)]
    return get_op("conv2d").lower(ctx, new_ins, attrs)


# ---------------------------------------------------------------------------
# Static infer + numerics rules for the quantization surface (colocated
# with the lowerings above; no tensors). The numerics rules are what give
# numcheck its int8-scale-clip teeth: fake_quantize pins the quantized
# domain to ±(2^(bits-1)-1), and the engine cross-checks every
# dequantize step's declared max_range against the propagated range.
# ---------------------------------------------------------------------------
from ..analysis.infer import VarInfo, first_in, same_as  # noqa: E402
from ..analysis.numcheck import interval, num_first  # noqa: E402
from ..core.registry import register_infer, register_numerics  # noqa: E402


@register_infer("fake_quantize_abs_max")
def _infer_fake_quantize(op, ins, attrs):
    x = first_in(ins, "X")
    return {"Out": [same_as(x)],
            "OutScale": [VarInfo((1,), "float32",
                                 confident=x.confident)]}


@register_infer("fake_dequantize_max_abs")
def _infer_fake_dequantize(op, ins, attrs):
    return {"Out": [same_as(first_in(ins, "X"))]}


@register_infer("quantized_mul")
def _infer_quantized_mul(op, ins, attrs):
    from .basic import _infer_mul
    return {"Out": _infer_mul(op, ins, attrs)["Out"]}


@register_infer("quantized_conv2d")
def _infer_quantized_conv2d(op, ins, attrs):
    from .nn import _infer_conv2d
    return _infer_conv2d(op, ins, attrs)


@register_numerics("fake_quantize_abs_max")
def _num_fake_quantize(op, ins, attrs):
    x = num_first(ins, "X")
    r = _quant_range(int(attrs.get("bit_length", 8)))
    return {"Out": [interval(-r, r)],
            "OutScale": [interval(0.0, x.mag)]}


@register_numerics("fake_dequantize_max_abs")
def _num_fake_dequantize(op, ins, attrs):
    # Out = x·scale/max_range: |out| ≤ mag(x)·mag(scale)/r. The
    # engine's int8-scale-clip check separately compares x's range
    # against max_range (the quantized domain must fit).
    x, s = num_first(ins, "X"), num_first(ins, "Scale")
    r = float(attrs.get("max_range", _quant_range(8)))
    if x.mag < math.inf and s.mag < math.inf and r > 0:
        m = x.mag * s.mag / r
        return {"Out": [interval(-m, m)]}
    return {"Out": [interval(-math.inf, math.inf)]}


def _num_quantized_matmul(op, ins, attrs):
    # int8 weight dequantized then contracted with finite activations:
    # finite, magnitude open (scale tensor unbounded by seeds)
    return {"Out" if op.type == "quantized_mul" else "Output":
            [interval(-math.inf, math.inf)]}


register_numerics("quantized_mul")(_num_quantized_matmul)
register_numerics("quantized_conv2d")(_num_quantized_matmul)
