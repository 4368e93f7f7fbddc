"""Basic tensor / math / logic op lowering rules (port of
``paddle_tpu/ops/basic.py``): creation and assignment, the random
``*_batch_size_like`` ops, matmul, the elementwise family with fluid
axis broadcast, the unary activation table, reductions, shape movement,
gather/scatter, arg/sort/top-k, norms, and the compare and logical ops.

Every rule is plain torch: XLA fused these in the reference and no
Pallas kernel exists for any of them. Integer index outputs are
``canonical_int()`` (int64 here, int32 in the reference; tests compare
them by value).
"""
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.framework import torch_dtype
from ..core.registry import canonical_int, register_op


def _prod(dims):
    r = 1
    for d in dims:
        r *= d
    return r


def _dt(attrs, key="dtype", default="float32"):
    return torch_dtype(attrs.get(key, default))


def _batch_like_shape(ins, attrs):
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        ins["Input"][0].shape[attrs.get("input_dim_idx", 0)]
    return tuple(shape)


# ---------------------------------------------------------------------------
# creation / assignment
# ---------------------------------------------------------------------------


@register_op("fill_constant")
def _fill_constant(ctx, ins, attrs):
    shape = attrs.get("shape", [1])
    return {"Out": [torch.full(tuple(shape), attrs.get("value", 0.0),
                               dtype=_dt(attrs), device=ctx.device)]}


@register_op("fill_constant_batch_size_like")
def _fill_constant_bsl(ctx, ins, attrs):
    return {"Out": [torch.full(_batch_like_shape(ins, attrs),
                               attrs.get("value", 0.0), dtype=_dt(attrs),
                               device=ctx.device)]}


@register_op("fill_zeros_like")
def _fill_zeros_like(ctx, ins, attrs):
    return {"Out": [torch.zeros_like(ins["X"][0])]}


@register_op("assign")
def _assign(ctx, ins, attrs):
    return {"Out": [ins["X"][0]]}


@register_op("assign_value")
def _assign_value(ctx, ins, attrs):
    vals = np.asarray(attrs["values"])
    return {"Out": [torch.as_tensor(vals, device=ctx.device)
                    .to(_dt(attrs))]}


def _uniform(ctx, shape, attrs):
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    out = torch.rand(shape, generator=ctx.next_key(), device=ctx.device,
                     dtype=torch.float32) * (hi - lo) + lo
    return {"Out": [out.to(_dt(attrs))]}


def _normal(ctx, shape, attrs):
    out = (torch.randn(shape, generator=ctx.next_key(), device=ctx.device,
                       dtype=torch.float32) * attrs.get("std", 1.0)
           + attrs.get("mean", 0.0))
    return {"Out": [out.to(_dt(attrs))]}


register_op("uniform_random", stateful=True)(
    lambda ctx, ins, attrs: _uniform(ctx, tuple(attrs["shape"]), attrs))
register_op("uniform_random_batch_size_like", stateful=True)(
    lambda ctx, ins, attrs: _uniform(ctx, _batch_like_shape(ins, attrs),
                                     attrs))
register_op("gaussian_random", stateful=True)(
    lambda ctx, ins, attrs: _normal(ctx, tuple(attrs["shape"]), attrs))
register_op("gaussian_random_batch_size_like", stateful=True)(
    lambda ctx, ins, attrs: _normal(ctx, _batch_like_shape(ins, attrs),
                                    attrs))


@register_op("truncated_gaussian_random", stateful=True)
def _truncated_gaussian_random(ctx, ins, attrs):
    """Normal truncated to [-2, 2] standard deviations (the reference's
    ``jax.random.truncated_normal(key, -2, 2)``), by the inverse CDF of
    a uniform draw over the kept mass."""
    shape = tuple(attrs["shape"])
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=ctx.next_key(), device=ctx.device,
                   dtype=torch.float32) * (1.0 - 2.0 * lo) + lo
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    z = torch.clamp(z, -2.0, 2.0)
    out = z * attrs.get("std", 1.0) + attrs.get("mean", 0.0)
    return {"Out": [out.to(_dt(attrs))]}


@register_op("sampling_id", stateful=True)
def _sampling_id(ctx, ins, attrs):
    """One class id a row, drawn in proportion to the row's
    probabilities (the reference's categorical over log(x + 1e-20))."""
    x = ins["X"][0].float() + 1e-20
    ids = torch.multinomial(x, 1, generator=ctx.next_key()).reshape(-1)
    return {"Out": [ids.to(canonical_int())]}


@register_op("cast")
def _cast(ctx, ins, attrs):
    return {"Out": [ins["X"][0].to(torch_dtype(attrs["out_dtype"]))]}


@register_op("shape")
def _shape(ctx, ins, attrs):
    return {"Out": [torch.tensor(tuple(ins["Input"][0].shape),
                                 dtype=torch.int32, device=ctx.device)]}


# ---------------------------------------------------------------------------
# matmul family
# ---------------------------------------------------------------------------


@register_op("mul")
def _mul(ctx, ins, attrs):
    """fluid mul op (reference paddle/fluid/operators/mul_op.cc): flattens X
    to 2D at x_num_col_dims, Y at y_num_col_dims, then matmul — the
    product behind fc."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(_prod(xs[:xn]), _prod(xs[xn:]))
    y2 = y.reshape(_prod(ys[:yn]), _prod(ys[yn:]))
    return {"Out": [(x2 @ y2).reshape(xs[:xn] + ys[yn:])]}


@register_op("matmul")
def _matmul(ctx, ins, attrs):
    """Batched matmul with numpy broadcasting of the batch dims,
    ``transpose_X``/``transpose_Y`` on the last two dims and an
    ``alpha`` scale (reference matmul_op.cc)."""
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


# ---------------------------------------------------------------------------
# elementwise binary with fluid axis-broadcast semantics
# ---------------------------------------------------------------------------


def _bcast(x, y, axis):
    """fluid broadcast: Y's shape must match a contiguous span of X's dims
    starting at ``axis`` (default: trailing). Reference
    paddle/fluid/operators/elementwise_op_function.h."""
    if x.shape == y.shape or y.dim() == 0:
        return x, y
    if y.dim() > x.dim():
        # symmetric case (rare); fall back to numpy-style broadcasting
        return x, y
    if axis is None or axis == -1:
        axis = x.dim() - y.dim()
    new_shape = (1,) * axis + tuple(y.shape) \
        + (1,) * (x.dim() - axis - y.dim())
    return x, y.reshape(new_shape)


def _register_binary(name, fn):
    @register_op(name)
    def rule(ctx, ins, attrs, _fn=fn):
        x, y = _bcast(ins["X"][0], ins["Y"][0], attrs.get("axis", -1))
        return {"Out": [_fn(x, y)]}


for _n, _f in [
    ("elementwise_add", torch.add), ("elementwise_sub", torch.sub),
    ("elementwise_mul", torch.mul), ("elementwise_div", torch.div),
    ("elementwise_max", torch.maximum), ("elementwise_min", torch.minimum),
    ("elementwise_pow", torch.pow),
    # numpy's mod and floor_divide: the sign of the divisor, rounding down
    ("elementwise_mod", torch.remainder),
    ("elementwise_floordiv", torch.floor_divide),
]:
    _register_binary(_n, _f)


@register_op("scale")
def _scale(ctx, ins, attrs):
    x = ins["X"][0]
    scale = attrs.get("scale", 1.0)
    bias = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * scale + bias]}
    return {"Out": [(x + bias) * scale]}


@register_op("sum")
def _sum(ctx, ins, attrs):
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register_op("mean")
def _mean(ctx, ins, attrs):
    return {"Out": [ins["X"][0].mean().reshape((1,))]}


# ---------------------------------------------------------------------------
# activations (reference paddle/fluid/operators/activation_op.cc)
# ---------------------------------------------------------------------------


def _where0(cond, x):
    return torch.where(cond, x, torch.zeros_like(x))


UNARY_TABLE = {
    "relu": lambda x, a: torch.clamp_min(x, 0),
    "sigmoid": lambda x, a: torch.sigmoid(x),
    "logsigmoid": lambda x, a: F.logsigmoid(x),
    "tanh": lambda x, a: torch.tanh(x),
    "tanh_shrink": lambda x, a: x - torch.tanh(x),
    "exp": lambda x, a: torch.exp(x),
    "log": lambda x, a: torch.log(x),
    "sqrt": lambda x, a: torch.sqrt(x),
    "rsqrt": lambda x, a: torch.rsqrt(x),
    "abs": lambda x, a: torch.abs(x),
    "square": lambda x, a: torch.square(x),
    "reciprocal": lambda x, a: 1.0 / x,
    "floor": lambda x, a: torch.floor(x),
    "ceil": lambda x, a: torch.ceil(x),
    "round": lambda x, a: torch.round(x),      # half to even, as numpy
    "sin": lambda x, a: torch.sin(x),
    "cos": lambda x, a: torch.cos(x),
    # jax.nn.softplus is logaddexp(x, 0), with no linear cut-over
    "softplus": lambda x, a: torch.logaddexp(x, torch.zeros_like(x)),
    "softsign": lambda x, a: x / (1 + torch.abs(x)),
    "softshrink": lambda x, a: torch.sign(x) * torch.clamp_min(
        torch.abs(x) - a.get("lambda", 0.5), 0),
    "hard_shrink": lambda x, a: _where0(
        torch.abs(x) > a.get("threshold", 0.5), x),
    "thresholded_relu": lambda x, a: _where0(
        x > a.get("threshold", 1.0), x),
    "relu6": lambda x, a: torch.clamp(x, 0, a.get("threshold", 6.0)),
    "elu": lambda x, a: F.elu(x, a.get("alpha", 1.0)),
    "leaky_relu": lambda x, a: F.leaky_relu(x, a.get("alpha", 0.02)),
    "gelu": lambda x, a: F.gelu(
        x, approximate="tanh" if a.get("approximate", True) else "none"),
    "swish": lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x),
    "stanh": lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
        a.get("scale_a", 0.67) * x),
    "brelu": lambda x, a: torch.clamp(x, a.get("t_min", 0.0),
                                      a.get("t_max", 24.0)),
    "soft_relu": lambda x, a: torch.log(
        1 + torch.exp(torch.clamp(x, -a.get("threshold", 40.0),
                                  a.get("threshold", 40.0)))),
    "hard_sigmoid": lambda x, a: torch.clamp(
        a.get("slope", 0.2) * x + a.get("offset", 0.5), 0.0, 1.0),
    "pow": lambda x, a: torch.pow(x, a.get("factor", 1.0)),
    "mish": lambda x, a: x * torch.tanh(
        torch.logaddexp(x, torch.zeros_like(x))),
    "sign": lambda x, a: torch.sign(x),
    "logical_not": lambda x, a: torch.logical_not(x),
}


def _register_unary(name, fn):
    @register_op(name)
    def rule(ctx, ins, attrs, _fn=fn):
        return {"Out": [_fn(ins["X"][0], attrs)]}


for _n, _f in UNARY_TABLE.items():
    _register_unary(_n, _f)


@register_op("prelu")
def _prelu(ctx, ins, attrs):
    x, alpha = ins["X"][0], ins["Alpha"][0]
    if attrs.get("mode", "all") == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    return {"Out": [torch.where(x > 0, x, alpha * x)]}


@register_op("maxout")
def _maxout(ctx, ins, attrs):
    x = ins["X"][0]  # NCHW
    g = attrs["groups"]
    n, c, h, w = x.shape
    return {"Out": [torch.amax(x.reshape(n, c // g, g, h, w), dim=2)]}


@register_op("softmax")
def _softmax(ctx, ins, attrs):
    return {"Out": [torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))]}


@register_op("log_softmax")
def _log_softmax(ctx, ins, attrs):
    return {"Out": [torch.log_softmax(ins["X"][0],
                                      dim=attrs.get("axis", -1))]}


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def _prod_over(x, dim, keepdim=False):
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


_REDUCERS = {
    "reduce_sum": lambda x, dim: torch.sum(x, dim=dim),
    "reduce_mean": lambda x, dim: torch.mean(x, dim=dim),
    # amax/amin: a tie splits the gradient evenly, as jnp.max's does
    "reduce_max": lambda x, dim: torch.amax(x, dim=dim),
    "reduce_min": lambda x, dim: torch.amin(x, dim=dim),
    "reduce_prod": _prod_over,
}


def _register_reduce(name, fn):
    @register_op(name)
    def rule(ctx, ins, attrs, _fn=fn):
        x = ins["X"][0]
        if attrs.get("reduce_all", False):
            out = _fn(x, tuple(range(x.dim())))
            if attrs.get("keep_dim", False):
                out = out.reshape((1,) * x.dim())
        else:
            dim = attrs.get("dim", [0])
            axes = tuple(sorted(d % x.dim() for d in
                                (dim if isinstance(dim, (list, tuple))
                                 else [dim])))
            out = _fn(x, axes)
            if attrs.get("keep_dim", False):
                for a in axes:
                    out = out.unsqueeze(a)
        return {"Out": [out]}


for _n, _f in _REDUCERS.items():
    _register_reduce(_n, _f)


@register_op("cumsum")
def _cumsum(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    if attrs.get("reverse", False):
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis)
    if attrs.get("exclusive", False):
        out = out - x
    if attrs.get("reverse", False):
        out = torch.flip(out, (axis,))
    return {"Out": [out]}


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------


def _xshape(ctx, x):
    return torch.zeros((0,) + tuple(x.shape), device=ctx.device)


@register_op("reshape")
def _reshape(ctx, ins, attrs):
    x = ins["X"][0]
    shape = list(attrs["shape"])
    # fluid semantics: 0 copies the input dim, -1 infers
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return {"Out": [x.reshape(tuple(shape))]}


register_op("reshape2")(lambda ctx, ins, attrs: {
    "Out": [_reshape(ctx, ins, attrs)["Out"][0]],
    "XShape": [_xshape(ctx, ins["X"][0])]})


@register_op("squeeze")
def _squeeze(ctx, ins, attrs):
    x = ins["X"][0]
    axes = attrs.get("axes", [])
    if not axes:
        return {"Out": [torch.squeeze(x)]}
    return {"Out": [torch.squeeze(x, tuple(a % x.dim() for a in axes))]}


@register_op("unsqueeze")
def _unsqueeze(ctx, ins, attrs):
    x = ins["X"][0]
    for a in sorted(attrs["axes"]):
        x = x.unsqueeze(a)
    return {"Out": [x]}


@register_op("transpose")
def _transpose(ctx, ins, attrs):
    return {"Out": [ins["X"][0].permute(tuple(attrs["axis"]))]}


@register_op("transpose2")
def _transpose2(ctx, ins, attrs):
    """transpose with the fluid v2 op signature (reference
    transpose_op.cc Transpose2Op): same math, plus an XShape output."""
    x = ins["X"][0]
    return {"Out": [x.permute(tuple(attrs["axis"]))],
            "XShape": [_xshape(ctx, x)]}


@register_op("flatten")
def _flatten(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", 1)
    lead = _prod(x.shape[:axis]) if axis > 0 else 1
    return {"Out": [x.reshape((lead, -1))]}


@register_op("concat")
def _concat(ctx, ins, attrs):
    return {"Out": [torch.cat(ins["X"], dim=attrs.get("axis", 0))]}


@register_op("split")
def _split(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if not sections:
        num = attrs.get("num", 0)
        if x.shape[axis] % num:
            raise ValueError(f"split: dim {axis} of size {x.shape[axis]} "
                             f"does not divide into {num} equal parts")
        sections = [x.shape[axis] // num] * num
    return {"Out": list(torch.split(x, list(sections), dim=axis))}


@register_op("stack")
def _stack(ctx, ins, attrs):
    return {"Y": [torch.stack(ins["X"], dim=attrs.get("axis", 0))]}


@register_op("unstack")
def _unstack(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", 0)
    n = attrs.get("num", x.shape[axis])
    if n != x.shape[axis]:
        raise ValueError(f"unstack: num {n} != dim {axis} of size "
                         f"{x.shape[axis]}")
    return {"Y": list(torch.unbind(x, dim=axis))}


@register_op("slice")
def _slice(ctx, ins, attrs):
    x = ins["Input"][0]
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    return {"Out": [x[tuple(idx)]]}


@register_op("strided_slice")
def _strided_slice(ctx, ins, attrs):
    """Python slice semantics a listed axis, negative strides included
    (torch slicing takes no negative step, so each axis gathers the
    indices python's ``slice.indices`` gives)."""
    x = ins["Input"][0]
    for a, s, e, st in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                           attrs.get("strides", [1] * len(attrs["axes"]))):
        keep = range(*slice(s, e, st).indices(x.shape[a]))
        x = x.index_select(a, torch.tensor(list(keep), dtype=torch.int64,
                                           device=x.device))
    return {"Out": [x]}


@register_op("expand")
def _expand(ctx, ins, attrs):
    return {"Out": [torch.tile(ins["X"][0], tuple(attrs["expand_times"]))]}


@register_op("reverse")
def _reverse(ctx, ins, attrs):
    axes = attrs.get("axis", [0])
    if not isinstance(axes, (list, tuple)):
        axes = [axes]
    return {"Out": [torch.flip(ins["X"][0], tuple(axes))]}


def _index(t):
    return t.to(torch.int64)


@register_op("gather")
def _gather(ctx, ins, attrs):
    x, idx = ins["X"][0], ins["Index"][0]
    return {"Out": [x.index_select(0, _index(idx.reshape(-1)))]}


@register_op("scatter")
def _scatter(ctx, ins, attrs):
    x, ids, upd = ins["X"][0], ins["Ids"][0], ins["Updates"][0]
    ids = _index(ids.reshape(-1))
    return {"Out": [x.index_put((ids,), upd,
                                accumulate=not attrs.get("overwrite",
                                                         True))]}


@register_op("gather_nd")
def _gather_nd(ctx, ins, attrs):
    x, idx = ins["X"][0], _index(ins["Index"][0])
    return {"Out": [x[tuple(torch.movedim(idx, -1, 0))]]}


@register_op("pad")
def _pad(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs["paddings"]
    pads = []
    for i in reversed(range(x.dim())):   # F.pad lists the last dim first
        pads += [p[2 * i], p[2 * i + 1]]
    return {"Out": [F.pad(x, pads, value=attrs.get("pad_value", 0.0))]}


@register_op("pad2d")
def _pad2d(ctx, ins, attrs):
    x = ins["X"][0]
    t, b, l, r = attrs["paddings"]
    mode = attrs.get("mode", "constant")
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    if mode == "constant":
        out = F.pad(x, [l, r, t, b], value=attrs.get("pad_value", 0.0))
    else:
        out = F.pad(x, [l, r, t, b],
                    mode={"reflect": "reflect", "edge": "replicate"}[mode])
    return {"Out": [out.permute(0, 2, 3, 1) if nhwc else out]}


@register_op("crop")
def _crop(ctx, ins, attrs):
    x = ins["X"][0]
    idx = tuple(slice(o, o + s) for o, s in zip(attrs.get("offsets"),
                                                attrs.get("shape")))
    return {"Out": [x[idx]]}


@register_op("one_hot")
def _one_hot(ctx, ins, attrs):
    """float32 one-hot over ``depth``; a trailing dim of 1 is squeezed
    ([N, 1] → [N, depth]); an id outside [0, depth) gives a zero row,
    as ``jax.nn.one_hot``."""
    x = ins["X"][0]
    sq = x.reshape(x.shape[:-1]) if x.dim() and x.shape[-1] == 1 else x
    classes = torch.arange(attrs["depth"], device=x.device)
    return {"Out": [(sq[..., None] == classes).to(torch.float32)]}


@register_op("multiplex")
def _multiplex(ctx, ins, attrs):
    ids = _index(ins["Ids"][0].reshape(-1))
    stacked = torch.stack(ins["X"], dim=0)  # [n, batch, ...]
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return {"Out": [stacked[ids, rows]]}


# ---------------------------------------------------------------------------
# argmin/argmax/sort/topk
# ---------------------------------------------------------------------------


@register_op("arg_max")
def _arg_max(ctx, ins, attrs):
    return {"Out": [torch.argmax(ins["X"][0], dim=attrs.get("axis", -1))
                    .to(canonical_int())]}


@register_op("arg_min")
def _arg_min(ctx, ins, attrs):
    return {"Out": [torch.argmin(ins["X"][0], dim=attrs.get("axis", -1))
                    .to(canonical_int())]}


@register_op("argsort")
def _argsort(ctx, ins, attrs):
    vals, idx = torch.sort(ins["X"][0], dim=attrs.get("axis", -1),
                           stable=True)
    return {"Out": [vals], "Indices": [idx.to(canonical_int())]}


@register_op("top_k")
def _top_k(ctx, ins, attrs):
    vals, idx = torch.topk(ins["X"][0], attrs["k"], dim=-1, largest=True,
                           sorted=True)
    return {"Out": [vals], "Indices": [idx.to(canonical_int())]}


# ---------------------------------------------------------------------------
# clip and norms
# ---------------------------------------------------------------------------


@register_op("clip")
def _clip(ctx, ins, attrs):
    return {"Out": [torch.clamp(ins["X"][0], attrs["min"], attrs["max"])]}


@register_op("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    x = ins["X"][0]
    mn = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return {"Out": [x * (mn / torch.clamp(norm, min=mn))]}


@register_op("norm")
def _norm(ctx, ins, attrs):
    x = ins["X"][0]
    norm = torch.sqrt(torch.sum(torch.square(x), dim=attrs.get("axis", -1),
                                keepdim=True)
                      + attrs.get("epsilon", 1e-10))
    return {"Out": [x / norm], "Norm": [norm]}


# ---------------------------------------------------------------------------
# compare / logical
# ---------------------------------------------------------------------------


for _n, _f in [("less_than", torch.lt), ("less_equal", torch.le),
               ("greater_than", torch.gt), ("greater_equal", torch.ge),
               ("equal", torch.eq), ("not_equal", torch.ne),
               ("logical_and", torch.logical_and),
               ("logical_or", torch.logical_or),
               ("logical_xor", torch.logical_xor)]:
    _register_binary(_n, _f)


@register_op("isfinite")
def _isfinite(ctx, ins, attrs):
    return {"Out": [torch.isfinite(ins["X"][0]).all().reshape((1,))]}


@register_op("increment")
def _increment(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x + torch.tensor(attrs.get("step", 1.0), dtype=x.dtype,
                                     device=x.device)]}


# ---------------------------------------------------------------------------
# misc math
# ---------------------------------------------------------------------------


@register_op("cos_sim")
def _cos_sim(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt(torch.sum(torch.square(x), -1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), -1, keepdim=True))
    out = torch.sum(x * y, -1, keepdim=True) / (xn * yn + 1e-12)
    return {"Out": [out], "XNorm": [xn], "YNorm": [yn]}


@register_op("dot")
def _dot(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": [torch.sum(x * y, dim=-1, keepdim=True)]}


@register_op("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, ins, attrs):
    x, y, w = ins["X"][0], ins["Y"][0], ins["Weight"][0]
    out = torch.einsum("bi,oij,bj->bo", x, w, y)
    if ins.get("Bias"):
        out = out + ins["Bias"][0]
    return {"Out": [out]}
