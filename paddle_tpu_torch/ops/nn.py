"""Neural-network op lowering rules (port of ``paddle_tpu/ops/nn.py``):
the convolutions (``conv2d``, ``depthwise_conv2d``, ``conv3d`` and the
transposed ``conv2d_transpose`` / ``conv3d_transpose``), ``pool2d`` and
``pool3d``, ``batch_norm`` with its hand-derived backward, the embedding
lookup, ``layer_norm``, ``group_norm`` and ``lrn``, ``dropout``, the
losses, ``label_smooth``, the norms and distances, the metrics
(``mean_iou``, ``accuracy``, ``auc``), the composed
``scaled_dot_product_attention``, the image ops (``bilinear_interp``,
``nearest_interp``, ``roi_pool``, ``random_crop``), the sequence ops
``im2sequence`` and ``row_conv``, the sampled softmax losses
``hierarchical_sigmoid`` and ``nce``; then each op's static infer and
numerics rules (the reference's, for the analysis package).

Every rule is plain torch, as XLA computed them in the reference; the
convolutions run ``torch.nn.functional``'s (cuDNN on the card). An
``NHWC`` tensor stays ``[N, H, W, C]`` at the op boundary, as in the
reference's IR; the rule hands cuDNN its ``permute(0, 3, 1, 2)`` view,
an NCHW tensor in ``torch.channels_last`` memory, so no activation is
copied, and permutes the result back the same way.
"""
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..core.lowering import remat_tag
from ..core.registry import canonical_int, register_op


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,) * n


def _fmt(attrs):
    return attrs.get("data_format", attrs.get("data_layout", "NCHW"))


def _to_nchw(x):
    """An ``[N, H, W, C]`` tensor as the NCHW view of the same memory
    (``torch.channels_last``): no copy."""
    return x.permute(0, 3, 1, 2)


def _to_nhwc(y):
    """The inverse of :func:`_to_nchw`: a channels-last NCHW result as
    ``[N, H, W, C]`` (a view when cuDNN wrote it channels-last)."""
    return y.permute(0, 2, 3, 1)


def _filter_for(w, fmt):
    """The filter in the memory format cuDNN pairs with the activation's:
    channels-last for an NHWC conv (the fluid ``[cout, cin/g, kh, kw]``
    shape either way)."""
    return w.contiguous(memory_format=torch.channels_last) \
        if fmt == "NHWC" else w


@register_op("conv2d")
def _conv2d(ctx, ins, attrs):
    """reference paddle/fluid/operators/conv_op.cc. Filter
    [cout, cin/groups, kh, kw] (fluid layout). Input NCHW by default;
    ``data_format="NHWC"`` keeps [N, H, W, C] at the op boundary and runs
    cuDNN on the channels-last view. Under the ``save_conv_only`` remat
    policy the output is tagged ``conv_out`` (``core/lowering.py``
    :func:`remat_tag`), the only values that policy saves."""
    x, w = ins["Input"][0], ins["Filter"][0]
    fmt = _fmt(attrs)
    if fmt == "NHWC":
        x = _to_nchw(x)
    w = _filter_for(w, fmt)
    with remat_tag(ctx, "conv_out"):
        out = F.conv2d(x, w, None, _pair(attrs.get("strides", [1, 1])),
                       _pair(attrs.get("paddings", [0, 0])),
                       _pair(attrs.get("dilations", [1, 1])),
                       attrs.get("groups", 1) or 1)
    return {"Output": [_to_nhwc(out) if fmt == "NHWC" else out]}


@register_op("depthwise_conv2d")
def _depthwise_conv2d(ctx, ins, attrs):
    return _conv2d(ctx, ins, attrs)


_CONV_TRANSPOSE = {2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _conv_transpose_nd(ins, attrs, nd, fmt="NCHW"):
    """Shared N-D deconv lowering (reference conv_transpose_op.cc): the
    gradient of a forward conv whose [cin, cout/g, *k] fluid filter is
    torch's transposed-conv weight as it is. The output extent is
    (in − 1)·s − 2p + d(k − 1) + 1, the fluid padding p is torch's, and
    groups split the input channels and the filter's first axis, as the
    reference's per-group ``lax.conv_transpose`` does."""
    x, w = ins["Input"][0], ins["Filter"][0]
    ones = [1] * nd
    if fmt == "NHWC":
        x = _to_nchw(x)
    out = _CONV_TRANSPOSE[nd](
        x, _filter_for(w, fmt), None, list(attrs.get("strides", ones)),
        list(attrs.get("paddings", [0] * nd)), 0,
        attrs.get("groups", 1) or 1, list(attrs.get("dilations", ones)))
    return {"Output": [_to_nhwc(out) if fmt == "NHWC" else out]}


@register_op("conv2d_transpose")
def _conv2d_transpose(ctx, ins, attrs):
    return _conv_transpose_nd(ins, attrs, 2, _fmt(attrs))


@register_op("conv3d_transpose")
def _conv3d_transpose(ctx, ins, attrs):
    return _conv_transpose_nd(ins, attrs, 3)


@register_op("conv3d")
def _conv3d(ctx, ins, attrs):
    x, w = ins["Input"][0], ins["Filter"][0]
    return {"Output": [F.conv3d(
        x, w, None, _pair(attrs.get("strides", [1, 1, 1]), 3),
        _pair(attrs.get("paddings", [0, 0, 0]), 3),
        _pair(attrs.get("dilations", [1, 1, 1]), 3),
        attrs.get("groups", 1) or 1)]}


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool(x, ksize, strides, pads, ptype, ceil_mode, global_pool, nd=2,
          fmt="NCHW"):
    """The reference's ``lax.reduce_window`` pooling. ``ceil_mode`` pads
    the right edge by what the last partial window needs and keeps every
    window the padded extent holds (torch's own ``ceil_mode`` drops a last
    window that starts in the right padding), so that case pads
    explicitly and pools unpadded. ``avg`` is exclusive: it divides each
    window's sum by its in-bounds count, the extra right padding
    included; torch's pools accumulate 16-bit inputs in float32, as the
    reference's upcast does."""
    if fmt != "NCHW":
        return _to_nhwc(_pool(_to_nchw(x), ksize, strides, pads, ptype,
                              ceil_mode, global_pool, nd))
    spatial = tuple(x.shape[2:])
    if global_pool:
        ksize, pads, strides = spatial, (0,) * nd, spatial
    extra = [0] * nd
    if ceil_mode:
        for i in range(nd):
            rem = (spatial[i] + 2 * pads[i] - ksize[i]) % strides[i]
            extra[i] = (strides[i] - rem) % strides[i] if rem else 0
    if not x.is_floating_point():
        x = x.to(torch.float32)
    native = not any(extra) and all(2 * p <= k for p, k in zip(pads, ksize))
    if ptype == "max":
        if native:
            return _MAX_POOL[nd](x, ksize, strides, pads)
        return _MAX_POOL[nd](_pad_right(x, pads, extra, -math.inf),
                             ksize, strides)
    if native:
        return _AVG_POOL[nd](x, ksize, strides, pads,
                             count_include_pad=False)
    s = _AVG_POOL[nd](_pad_right(x, pads, extra, 0.0), ksize, strides,
                      divisor_override=1)
    ones = torch.ones((1, 1) + spatial, dtype=torch.float32,
                      device=x.device)
    cnt = _AVG_POOL[nd](_pad_right(ones, pads, extra, 0.0), ksize, strides,
                        divisor_override=1)
    return (s.to(torch.float32) / cnt).to(x.dtype)


def _pad_right(x, pads, extra, value):
    """``x`` padded by ``pads`` on both sides of each spatial axis and
    ``extra`` more on the right (F.pad lists the last axis first)."""
    spec = []
    for p, e in reversed(list(zip(pads, extra))):
        spec += [p, p + e]
    return F.pad(x, spec, value=value)


@register_op("pool2d")
def _pool2d(ctx, ins, attrs):
    return {"Out": [_pool(ins["X"][0], _pair(attrs.get("ksize", [2, 2])),
                          _pair(attrs.get("strides", [1, 1])),
                          _pair(attrs.get("paddings", [0, 0])),
                          attrs.get("pooling_type", "max"),
                          attrs.get("ceil_mode", False),
                          attrs.get("global_pooling", False), nd=2,
                          fmt=attrs.get("data_format", "NCHW"))]}


@register_op("pool3d")
def _pool3d(ctx, ins, attrs):
    return {"Out": [_pool(ins["X"][0],
                          _pair(attrs.get("ksize", [2, 2, 2]), 3),
                          _pair(attrs.get("strides", [1, 1, 1]), 3),
                          _pair(attrs.get("paddings", [0, 0, 0]), 3),
                          attrs.get("pooling_type", "max"),
                          attrs.get("ceil_mode", False),
                          attrs.get("global_pooling", False), nd=3)]}


# ---------------------------------------------------------------------------
# batch normalisation
# ---------------------------------------------------------------------------


def _bn_autodiff():
    """A/B seam: ``PADDLE_TPU_BN_AUTODIFF=1`` routes batch_norm training
    through autograd of the forward instead of the hand-derived backward.
    Read when the op runs, not at import, so setting it after
    ``import paddle_tpu_torch`` takes effect."""
    return os.environ.get("PADDLE_TPU_BN_AUTODIFF", "0") == "1"


def _widen(x):
    """A bf16 activation as float32 (the reference's upcast for the
    statistics and the normalize); any other dtype as it is."""
    return x.to(torch.float32) if x.dtype == torch.bfloat16 else x


def _bn_core(x, scale, bias, axes, bshape, eps):
    """One-pass-stats batch norm (E[x²] − E[x]², clamped at 0):
    returns (y, batch mean, biased batch variance, 1/√(var + ε))."""
    bm = torch.mean(x, dim=axes)
    bv = torch.clamp_min(torch.mean(x * x, dim=axes) - bm * bm, 0.0)
    inv = torch.rsqrt(bv.reshape(bshape) + eps)
    y = (x - bm.reshape(bshape)) * inv * scale.reshape(bshape) \
        + bias.reshape(bshape)
    return y, bm, bv, inv


class _BNTrain(torch.autograd.Function):
    """The reference's ``_bn_train`` custom vjp: the forward of
    :func:`_bn_core` in float32, and the textbook backward

      x̂ = (x − μ)·inv;  dβ = Σ dy;  dγ = Σ dy·x̂
      dx = γ·inv·(dy − dβ/n − x̂·dγ/n)

    (one reduce sweep over (x, dy) and one elementwise pass). ``x`` is
    kept in its own dtype and widened again in the backward, so a bf16
    activation is saved at 2 bytes an element. The statistics outputs
    carry no gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, axes, bshape, eps):
        y, bm, bv, inv = _bn_core(_widen(x), scale, bias, axes, bshape,
                                  eps)
        ctx.save_for_backward(x, scale, bm, inv)
        ctx.axes, ctx.bshape = axes, bshape
        ctx.mark_non_differentiable(bm, bv)
        return y, bm, bv

    @staticmethod
    def backward(ctx, dy, _dbm, _dbv):
        x, scale, bm, inv = ctx.saved_tensors
        axes, bshape = ctx.axes, ctx.bshape
        n = x.numel() // scale.numel()       # reduced elements a channel
        xhat = (_widen(x) - bm.reshape(bshape)) * inv
        dbias = torch.sum(dy, dim=axes)
        dscale = torch.sum(dy * xhat, dim=axes)
        dx = (inv * scale.reshape(bshape)) * (
            dy - (dbias / n).reshape(bshape)
            - xhat * (dscale / n).reshape(bshape))
        return dx.to(x.dtype), dscale, dbias, None, None, None


@register_op("batch_norm")
def _batch_norm(ctx, ins, attrs):
    """reference paddle/fluid/operators/batch_norm_op.cc, from the
    reference's formulas, not ``F.batch_norm``: one-pass statistics;
    moving statistics ``mean·momentum + batch·(1 − momentum)`` with the
    biased batch variance; a bf16 input normalised in float32 with only
    Y cast back; ``is_test`` or ``use_global_stats`` normalises with the
    moving statistics. The four statistics outputs carry no gradient.
    Under the ``recompute_norms`` remat policy the normalize is tagged
    ``batch_norm_out`` and recomputed in the backward."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    is_test = attrs.get("is_test", False) or ctx.is_test
    c_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != c_axis)
    bshape = tuple(x.shape[c_axis] if i == c_axis else 1
                   for i in range(x.dim()))
    in_dtype = x.dtype
    with remat_tag(ctx, "batch_norm_out"):
        if is_test or attrs.get("use_global_stats", False):
            xf = _widen(x)
            inv = torch.rsqrt(var.reshape(bshape) + eps)
            y = (xf - mean.reshape(bshape)) * inv * scale.reshape(bshape) \
                + bias.reshape(bshape)
            mean_out, var_out = mean, var
            saved_mean, saved_var = mean, var
        else:
            if _bn_autodiff():
                y, bm, bv, _ = _bn_core(_widen(x), scale, bias, axes, bshape, eps)
            else:
                y, bm, bv = _BNTrain.apply(x, scale, bias, axes, bshape,
                                           eps)
            bm, bv = bm.detach(), bv.detach()
            mean_out = mean * momentum + bm * (1 - momentum)
            var_out = var * momentum + bv * (1 - momentum)
            saved_mean, saved_var = bm, bv
        y = y.to(in_dtype)
    return {"Y": [y], "MeanOut": [mean_out.detach()],
            "VarianceOut": [var_out.detach()],
            "SavedMean": [saved_mean.detach()],
            "SavedVariance": [saved_var.detach()]}


@register_op("lookup_table", seq_aware=True)
def _lookup_table(ctx, ins, attrs):
    """reference paddle/fluid/operators/lookup_table_op.cc. Ids [..., 1]
    or [...] int; a trailing dim of size 1 is squeezed; padding_idx rows
    return zeros. SequenceBatch ids give a SequenceBatch of
    embeddings."""
    from ..core.sequence import SequenceBatch
    w, ids = ins["W"][0], ins["Ids"][0]
    if isinstance(ids, SequenceBatch):
        out = _lookup_table(ctx, {"W": [w], "Ids": [ids.data]},
                            attrs)["Out"][0]
        return {"Out": [ids.with_data(out)]}
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


@register_op("lrn")
def _lrn(ctx, ins, attrs):
    """Local response norm across channels: ``x / (k + α·Σx²)^β`` over a
    window of ``n`` channels (α is not divided by n, unlike
    ``F.local_response_norm``); ``MidOut`` is the windowed Σx². NCHW by
    default; ``data_format="NHWC"`` windows the last axis."""
    x = ins["X"][0]
    n = attrs.get("n", 5)
    k, alpha, beta = attrs.get("k", 2.0), attrs.get("alpha", 1e-4), \
        attrs.get("beta", 0.75)
    c_axis = 1 if attrs.get("data_format", "NCHW") == "NCHW" \
        else x.dim() - 1
    half = n // 2
    spec = [0, 0] * (x.dim() - 1 - c_axis) + [half, half]
    pad = F.pad(torch.square(x), spec)
    c = x.shape[c_axis]
    acc = sum(torch.narrow(pad, c_axis, i, c) for i in range(n))
    return {"Out": [x / torch.pow(k + alpha * acc, beta)],
            "MidOut": [acc]}


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
# image ops
# ---------------------------------------------------------------------------


def _triangle_weights(n_in, n_out, device, dtype):
    """``jax.image.resize``'s [n_in, n_out] linear weights (its
    ``compute_weight_mat``, antialiased): half-pixel sample centres, the
    triangle kernel widened by in/out when downsampling, each output's
    weights normalised to sum 1 and zeroed outside the input. Float32
    arithmetic step for step, on the host (the shapes are static)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.0) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0), f32(1) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w,
                 f32(0)).astype(f32)
    return torch.from_numpy(w).to(device=device, dtype=dtype)


@register_op("bilinear_interp")
def _bilinear_interp(ctx, ins, attrs):
    """``jax.image.resize(x, (n, c, out_h, out_w), "bilinear")``: each
    resized axis is a product with :func:`_triangle_weights` (which
    antialias when downsampling, as jax's default does); an axis whose
    size stays is left alone. NCHW."""
    x = ins["X"][0]
    oh, ow = attrs.get("out_h"), attrs.get("out_w")
    if not x.is_floating_point():
        x = x.to(torch.float32)
    if x.shape[3] != ow:
        x = torch.matmul(x, _triangle_weights(x.shape[3], ow, x.device,
                                              x.dtype))
    if x.shape[2] != oh:
        x = torch.matmul(_triangle_weights(x.shape[2], oh, x.device,
                                           x.dtype).t(), x)
    return {"Out": [x]}


def _nearest_index(n_in, n_out, device):
    """``jax.image.resize``'s nearest source rows: ⌊(i + ½)·in / out⌋ in
    float32 (torch's ``"nearest-exact"``)."""
    pos = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
    return torch.floor(pos).to(torch.int64).to(device)


@register_op("nearest_interp")
def _nearest_interp(ctx, ins, attrs):
    x = ins["X"][0]
    oh, ow = attrs.get("out_h"), attrs.get("out_w")
    if x.shape[2] != oh:
        x = torch.index_select(x, 2, _nearest_index(x.shape[2], oh,
                                                    x.device))
    if x.shape[3] != ow:
        x = torch.index_select(x, 3, _nearest_index(x.shape[3], ow,
                                                    x.device))
    return {"Out": [x]}


def _bin_edges(lo, extent, bins):
    """jnp.linspace(0, 1, bins + 1)·extent + lo for each roi (the
    reference's bin edges). jax's linspace is i · float32(1 / bins), the
    last exactly 1 — not i / bins, which differs in the last place at 7
    bins and moves a pixel on an edge into the next bin. The fractions
    are made on the host, where no device arithmetic rounds them."""
    step = torch.tensor(1.0 / bins, dtype=torch.float32)
    frac = torch.cat([torch.arange(bins, dtype=torch.float32) * step,
                      torch.ones(1)]).to(lo.device)
    return frac[None, :] * extent[:, None] + lo[:, None]


def _bin_mask(edges, size):
    """[R, bins, size]: index ``j`` lies in bin b (at least one index a
    bin, from its start)."""
    j = torch.arange(size, device=edges.device, dtype=torch.float32)
    start, end = edges[:, :-1, None], edges[:, 1:, None]
    return (j >= start) & (j < torch.maximum(end, start + 1))


@register_op("roi_pool")
def _roi_pool(ctx, ins, attrs):
    """reference paddle/fluid/operators/roi_pool_op.cc, static-shape: rois
    [R, 4] (x1, y1, x2, y2) with batch ids, or batched [B, S, 4]. Each
    bin is the max over its rows and columns; an empty bin (a roi past
    the feature map) pools to 0, never -inf. NCHW."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    if rois.dim() == 3:
        b, s_, _ = rois.shape
        batch_ids = torch.arange(b, device=x.device).repeat_interleave(s_)
        rois = rois.reshape(b * s_, 4)
    elif ins.get("RoisBatchId"):
        batch_ids = ins["RoisBatchId"][0].reshape(-1).to(torch.int64)
    else:
        batch_ids = torch.zeros((rois.shape[0],), dtype=torch.int64,
                                device=x.device)
    ph, pw = attrs["pooled_height"], attrs["pooled_width"]
    scale = attrs.get("spatial_scale", 1.0)
    x1, y1, x2, y2 = torch.round(rois.to(torch.float32) * scale).unbind(1)
    h = torch.clamp_min(y2 - y1 + 1, 1.0)
    w = torch.clamp_min(x2 - x1 + 1, 1.0)
    rmask = _bin_mask(_bin_edges(y1, h, ph), x.shape[2])  # [R, ph, H]
    cmask = _bin_mask(_bin_edges(x1, w, pw), x.shape[3])  # [R, pw, W]
    m = rmask[:, :, None, :, None] & cmask[:, None, :, None, :]
    img = x[batch_ids]                                    # [R, C, H, W]
    vals = torch.where(m[:, None], img[:, :, None, None],
                       torch.full((), -math.inf, dtype=x.dtype,
                                  device=x.device))
    maxed = torch.amax(vals, dim=(4, 5))                  # [R, C, ph, pw]
    empty = ~torch.any(m, dim=(3, 4))                     # [R, ph, pw]
    out = torch.where(empty[:, None], torch.zeros((), dtype=x.dtype,
                                                  device=x.device), maxed)
    return {"Out": [out],
            "Argmax": [torch.zeros(out.shape, dtype=canonical_int(),
                                   device=x.device)]}


@register_op("random_crop", stateful=True)
def _random_crop(ctx, ins, attrs):
    """A window of ``attrs['shape']`` over the trailing dims, each start
    drawn uniformly from [0, size − crop] (one generator from
    ``ctx.next_key()``; the reference draws from ``jax.random``, so the
    two are held to the distribution, not the draw)."""
    x = ins["X"][0]
    shape = attrs["shape"]
    lead = x.dim() - len(shape)
    g = ctx.next_key()
    out = x
    for i, s in enumerate(shape):
        limit = max(x.shape[lead + i] - s, 0)
        start = int(torch.randint(0, limit + 1, (), generator=g,
                                  device=g.device))
        out = torch.narrow(out, lead + i, start, s)
    return {"Out": [out]}


@register_op("im2sequence", seq_aware=True)
def _im2sequence(ctx, ins, attrs):
    """Each image becomes one sequence of its oh*ow patches (the
    reference emits LoD [0, oh*ow, 2*oh*ow, ...]; here a SequenceBatch
    of equal lengths), each patch flattened channel-major (C, kh, kw),
    so the output feeds sequence ops like dynamic_gru directly — the
    CRNN/OCR pipeline."""
    from ..core.sequence import SequenceBatch
    x = ins["X"][0]  # NCHW
    kh, kw = _pair(attrs["kernels"])
    sh, sw = _pair(attrs.get("strides", [1, 1]))
    pt, pl, pb, pr = (list(attrs.get("paddings", [0, 0, 0, 0]))
                      + [0] * 4)[:4]
    x = F.pad(x, (pl, pr, pt, pb))
    n = x.shape[0]
    patches = F.unfold(x, (kh, kw), stride=(sh, sw))   # [N, C*kh*kw, L]
    out = patches.transpose(1, 2)                      # [N, oh*ow, C*kh*kw]
    lengths = torch.full((n,), out.shape[1], dtype=torch.int64,
                         device=x.device)
    return {"Out": [SequenceBatch(out, lengths)]}


@register_op("row_conv")
def _row_conv(ctx, ins, attrs):
    """Lookahead row convolution (reference row_conv_op.cc): x [B, T, D]
    padded, Filter [context + 1, D]; out[t] = sum_i x[t + i] * f[i],
    zeros past the padded end."""
    x, f = ins["X"][0], ins["Filter"][0]
    k = f.shape[0]
    padded = F.pad(x, (0, 0, 0, k - 1))
    out = sum(padded[:, i:i + x.shape[1], :] * f[i] for i in range(k))
    return {"Out": [out]}


def _hsig_tables(num_classes):
    """The complete binary tree's static code tables (heap layout, leaves
    from ``num_classes``): for each class and depth, the inner node on
    its path from the root, the branch bit (1 left) and whether the
    depth is on the path."""
    depth = int(np.ceil(np.log2(num_classes)))
    codes = np.zeros((num_classes, depth), np.int64)
    signs = np.zeros((num_classes, depth), np.float32)
    valid = np.zeros((num_classes, depth), np.float32)
    for c in range(num_classes):
        node = c + num_classes
        path = []
        while node > 1:
            parent = node // 2
            path.append((parent - 1, 1.0 if node % 2 == 0 else 0.0))
            node = parent
        for d, (nid, bit) in enumerate(reversed(path)):
            if nid < num_classes - 1:
                codes[c, d] = nid
                signs[c, d] = bit
                valid[c, d] = 1.0
    return codes, signs, valid


@register_op("hierarchical_sigmoid")
def _hsigmoid(ctx, ins, attrs):
    """Complete-binary-tree hsigmoid: the code/path tables are built on
    the host with numpy and go to the device as constants; the loss is
    dense gathers and one [batch, depth, dim] contraction."""
    x, label, w = ins["X"][0], ins["Label"][0], ins["W"][0]
    codes, signs, valid = (torch.from_numpy(t).to(x.device)
                           for t in _hsig_tables(attrs["num_classes"]))
    lbl = label.reshape(-1).to(torch.int64)
    node_ids = codes[lbl]            # [B, depth]
    bit = signs[lbl]                 # [B, depth]
    msk = valid[lbl]
    logits = torch.einsum("bd,bkd->bk", x, w[node_ids])
    if ins.get("Bias"):
        logits = logits + ins["Bias"][0][node_ids]
    # bit==1 -> sigmoid(logit), else sigmoid(-logit); NLL over path
    ll = bit * F.logsigmoid(logits) + (1 - bit) * F.logsigmoid(-logits)
    return {"Out": [-torch.sum(ll * msk, dim=1, keepdim=True)]}


@register_op("nce", stateful=True)
def _nce(ctx, ins, attrs):
    """Noise-contrastive estimation with ``num_neg_samples`` negatives a
    row drawn uniformly from [0, num_total_classes) with the op's device
    generator (``ctx.next_key()``)."""
    x, label, w = ins["Input"][0], ins["Label"][0], ins["Weight"][0]
    k = attrs.get("num_neg_samples", 10)
    n = attrs["num_total_classes"]
    lbl = label.reshape(-1).to(torch.int64)
    neg = torch.randint(0, n, (x.shape[0], k), generator=ctx.next_key(),
                        device=x.device)
    ids = torch.cat([lbl[:, None], neg], dim=1)     # [B, 1+k]
    logits = torch.einsum("bd,bkd->bk", x, w[ids])
    if ins.get("Bias"):
        logits = logits + ins["Bias"][0][ids]
    # NCE with uniform noise: P_n = 1/n
    adjusted = logits - torch.log(torch.tensor(k / n, dtype=x.dtype,
                                               device=x.device))
    lbls = F.pad(torch.ones_like(adjusted[:, :1]), (0, k))
    loss = torch.clamp(adjusted, min=0) - adjusted * lbls + \
        F.softplus(-torch.abs(adjusted))
    out = torch.sum(loss, dim=1, keepdim=True)
    if ins.get("SampleWeight"):
        out = out * ins["SampleWeight"][0].reshape(-1, 1)
    return {"Cost": [out]}


# ---------------------------------------------------------------------------
# Static shape/dtype inference rules (analysis/infer.py engine) — the
# reference's (paddle_tpu/ops/nn.py) for the ops the port registers, pure
# shape arithmetic colocated with the lowerings above.
# ---------------------------------------------------------------------------
from ..analysis.infer import (InferError, VarInfo, first_in,  # noqa: E402
                              same_as)
from ..core.registry import register_infer  # noqa: E402


def _conv_dim(i, k, p, s, d=1):
    if i < 0:
        return -1
    eff = (k - 1) * d + 1
    return (i + 2 * p - eff) // s + 1


def _infer_conv2d(op, ins, attrs):
    x, w = first_in(ins, "Input"), first_in(ins, "Filter")
    if x.shape is None or w.shape is None or len(x.shape) != 4 \
            or len(w.shape) != 4:
        return {"Output": [VarInfo(None, x.dtype)]}
    strides = attrs.get("strides", [1, 1])
    pads = attrs.get("paddings", [0, 0])
    dil = attrs.get("dilations", [1, 1])
    groups = attrs.get("groups", 1) or 1
    fmt = attrs.get("data_format", attrs.get("data_layout", "NCHW"))
    n, c, h, wd = (x.shape if fmt == "NCHW"
                   else (x.shape[0], x.shape[3], x.shape[1], x.shape[2]))
    cout, cin_g, kh, kw = w.shape
    if x.confident and w.confident and c >= 0 \
            and c != cin_g * groups:
        raise InferError(
            f"conv2d channel mismatch: input has {c} channels "
            f"({fmt}) but filter {w.shape} expects "
            f"{cin_g * groups} (groups={groups})")
    oh = _conv_dim(h, kh, pads[0], strides[0], dil[0])
    ow = _conv_dim(wd, kw, pads[1], strides[1], dil[1])
    shape = (n, cout, oh, ow) if fmt == "NCHW" else (n, oh, ow, cout)
    return {"Output": [VarInfo(shape, x.dtype,
                               confident=x.confident and w.confident)]}


register_infer("conv2d")(_infer_conv2d)
register_infer("depthwise_conv2d")(_infer_conv2d)


def _deconv_dim(i, k, p, s, d=1):
    if i < 0:
        return -1
    eff = (k - 1) * d + 1
    return (i - 1) * s + eff - 2 * p


@register_infer("conv2d_transpose")
def _infer_conv2d_transpose(op, ins, attrs):
    x, w = first_in(ins, "Input"), first_in(ins, "Filter")
    if x.shape is None or w.shape is None or len(x.shape) != 4 \
            or len(w.shape) != 4:
        return {"Output": [VarInfo(None, x.dtype)]}
    strides = attrs.get("strides", [1, 1])
    pads = attrs.get("paddings", [0, 0])
    dil = attrs.get("dilations", [1, 1])
    groups = attrs.get("groups", 1) or 1
    fmt = attrs.get("data_format", attrs.get("data_layout", "NCHW"))
    n, c, h, wd = (x.shape if fmt == "NCHW"
                   else (x.shape[0], x.shape[3], x.shape[1], x.shape[2]))
    cin, cout_g, kh, kw = w.shape   # fluid deconv filter [cin, cout/g,*]
    cout = cout_g * groups
    oh = _deconv_dim(h, kh, pads[0], strides[0], dil[0])
    ow = _deconv_dim(wd, kw, pads[1], strides[1], dil[1])
    shape = (n, cout, oh, ow) if fmt == "NCHW" else (n, oh, ow, cout)
    return {"Output": [VarInfo(shape, x.dtype,
                               confident=x.confident and w.confident)]}


def _pool_dim(i, k, p, s, ceil_mode):
    if i < 0:
        return -1
    num = i + 2 * p - k
    return (num + s - 1) // s + 1 if ceil_mode else num // s + 1


@register_infer("pool2d")
def _infer_pool2d(op, ins, attrs):
    x = first_in(ins, "X")
    if x.shape is None or len(x.shape) != 4:
        return {"Out": [VarInfo(None, x.dtype)]}
    fmt = attrs.get("data_format", "NCHW")
    n, c, h, w = (x.shape if fmt == "NCHW"
                  else (x.shape[0], x.shape[3], x.shape[1], x.shape[2]))
    if attrs.get("global_pooling", False):
        oh = ow = 1
    else:
        ksize = attrs.get("ksize", [2, 2])
        strides = attrs.get("strides", [1, 1])
        pads = attrs.get("paddings", [0, 0])
        ksize = ksize if isinstance(ksize, (list, tuple)) else [ksize] * 2
        strides = strides if isinstance(strides, (list, tuple)) \
            else [strides] * 2
        pads = pads if isinstance(pads, (list, tuple)) else [pads] * 2
        cm = attrs.get("ceil_mode", False)
        oh = _pool_dim(h, ksize[0], pads[0], strides[0], cm)
        ow = _pool_dim(w, ksize[1], pads[1], strides[1], cm)
    shape = (n, c, oh, ow) if fmt == "NCHW" else (n, oh, ow, c)
    return {"Out": [VarInfo(shape, x.dtype, confident=x.confident)]}


@register_infer("batch_norm")
def _infer_batch_norm(op, ins, attrs):
    x, mean = first_in(ins, "X"), first_in(ins, "Mean")
    stat = VarInfo(mean.shape, "float32", confident=mean.confident)
    return {"Y": [same_as(x)], "MeanOut": [stat], "VarianceOut": [stat],
            "SavedMean": [stat], "SavedVariance": [stat]}


@register_infer("layer_norm")
def _infer_layer_norm(op, ins, attrs):
    return {"Y": [same_as(first_in(ins, "X"))]}


@register_infer("group_norm")
def _infer_group_norm(op, ins, attrs):
    return {"Y": [same_as(first_in(ins, "X"))]}


@register_infer("lrn")
def _infer_lrn(op, ins, attrs):
    return {"Out": [same_as(first_in(ins, "X"))]}


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
from ..analysis.infer import dim_prod as _nc_dim_prod  # noqa: E402
from ..analysis.numcheck import (interval, num_first)  # noqa: E402
from ..core.registry import register_numerics  # noqa: E402


def _num_conv(op, ins, attrs):
    """Accumulate-width aware: |out| ≤ k·max|x|·max|w| with
    k = (C_in/groups)·kh·kw contraction taps (+ bias join)."""
    x, w = num_first(ins, "Input"), num_first(ins, "Filter")
    if w.shape is None or len(w.shape) != 4 or x.mag == math.inf \
            or w.mag == math.inf:
        out = interval(-math.inf, math.inf)
    else:
        k = _nc_dim_prod(w.shape[1:])
        if k < 0:
            out = interval(-math.inf, math.inf)
        else:
            m = k * x.mag * w.mag
            b = num_first(ins, "Bias")
            if ins.get("Bias"):
                m += b.mag
                if b.mag == math.inf:
                    m = math.inf
            out = interval(-m, m)
    return {"Output": [out]}


register_numerics("conv2d")(_num_conv)
register_numerics("depthwise_conv2d")(_num_conv)
register_numerics("conv2d_transpose")(_num_conv)


@register_numerics("pool2d")
def _num_pool2d(op, ins, attrs):
    # max pool selects, avg pool averages: both stay inside X's range
    x = num_first(ins, "X")
    return {"Out": [interval(x.lo, x.hi)]}


register_numerics("pool3d")(_num_pool2d)


@register_numerics("batch_norm")
def _num_batch_norm(op, ins, attrs):
    """(x-μ)/√(σ²+ε)·γ+β: ε>0 keeps the denominator away from 0, so Y
    is finite whenever the inputs are; the magnitude depends on the
    learned γ/β, which the seeds leave unbounded."""
    y = interval(-math.inf, math.inf)
    stat = interval(-math.inf, math.inf)
    var = interval(0.0, math.inf)
    return {"Y": [y], "MeanOut": [stat], "VarianceOut": [var],
            "SavedMean": [stat], "SavedVariance": [var]}


@register_numerics("layer_norm")
def _num_layer_norm(op, ins, attrs):
    return {"Y": [interval(-math.inf, math.inf)]}


@register_numerics("group_norm")
def _num_group_norm(op, ins, attrs):
    return {"Y": [interval(-math.inf, math.inf)]}


@register_numerics("lrn")
def _num_lrn(op, ins, attrs):
    # out = x / (k + α·Σx²)^β with k ≥ 1 by default: |out| ≤ |x|/k^β
    x = num_first(ins, "X")
    k = float(attrs.get("k", 1.0))
    if k <= 0:
        return None
    return {"Out": [interval(min(x.lo, 0.0), max(x.hi, 0.0))]}


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
