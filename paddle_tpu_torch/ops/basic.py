"""Basic tensor / math / logic op lowering rules (port of
``paddle_tpu/ops/basic.py``): creation and assignment, the random
``*_batch_size_like`` ops, matmul, the elementwise family with fluid
axis broadcast, the unary activation table, reductions, shape movement,
gather/scatter, arg/sort/top-k, norms, the compare and logical ops,
``fused_elementwise``, the chain the optimize pass's fusion builds, and
``flatten_concat`` / ``fused_param_split``, the plumbing of
``transpiler/fuse_optimizer.py``;
then each op's static infer and numerics rules (the reference's, for
the analysis package).

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
from ..core.registry import canonical_int, get_op, register_op


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


def _check_contraction(op, kx, ky, x, y):
    """TypeError naming both sizes when the contracted dims of X and Y
    differ, before any product runs: jax raises TypeError there while
    tracing, torch's eager product a RuntimeError."""
    if kx != ky:
        raise TypeError(f"{op}: X's contracted size {kx} (shape "
                        f"{tuple(x.shape)}) does not match Y's {ky} (shape "
                        f"{tuple(y.shape)})")


@register_op("mul", seq_aware=True)
def _mul(ctx, ins, attrs):
    """fluid mul op (reference paddle/fluid/operators/mul_op.cc): flattens X
    to 2D at x_num_col_dims, Y at y_num_col_dims, then matmul — the
    product behind fc. A SequenceBatch X contracts its last dim row-wise
    (the lod-tensor [N, D] @ [D, K] semantics)."""
    from ..core.sequence import SequenceBatch
    x, y = ins["X"][0], ins["Y"][0]
    if isinstance(x, SequenceBatch):
        _check_contraction("mul", x.data.shape[-1], y.shape[0], x.data, y)
        return {"Out": [SequenceBatch(torch.einsum("btd,dk->btk", x.data, y),
                                      x.lengths)]}
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    _check_contraction("mul", _prod(xs[xn:]), _prod(ys[:yn]), x, y)
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
    _check_contraction("matmul", x.shape[-1], y.shape[-2 if y.dim() > 1
                                                       else 0], x, y)
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
    paddle/fluid/operators/elementwise_op_function.h. Ranks are compared
    first, so an exported graph (torch.export) gets no guard comparing a
    symbolic batch with a width."""
    if y.dim() == 0 or (x.dim() == y.dim() and x.shape == y.shape):
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


@register_op("load")
def _load(ctx, ins, attrs):
    """Load a variable from a numpy file (reference load_op.cc; files
    here are .npy, or the .npz written by io.save_vars with the target
    variable name as the key). A bfloat16 file array, which ``np.load``
    gives back as 2-byte void, takes the variable's declared dtype."""
    from .. import weights
    path = attrs["file_path"]
    data = np.load(path)
    name = ctx.op.outputs["Out"][0]
    if hasattr(data, "files"):          # npz archive
        data = data[name] if name in data.files else data[data.files[0]]
    var = ctx.op.block._find_var_recursive(name)
    out = weights.array_to_tensor(np.asarray(data), ctx.device,
                                  dtype=getattr(var, "dtype", None))
    if attrs.get("load_as_fp16"):
        out = out.half()
    return {"Out": [out]}


# ---------------------------------------------------------------------------
# the fused elementwise chain (analysis/optimize.py fusion pass)
# ---------------------------------------------------------------------------

@register_op("flatten_concat")
def _flatten_concat(ctx, ins, attrs):
    """Optimizer-fusion plumbing (transpiler/fuse_optimizer.py): ravel
    every input into one flat vector."""
    return {"Out": [torch.cat([x.reshape(-1) for x in ins["X"]])]}


@register_op("fused_elementwise")
def _fused_elementwise(ctx, ins, attrs):
    """One elementwise chain the fusion pass collapsed (reference
    ``paddle_tpu/ops/basic.py`` ``_fused_elementwise``).
    ``attrs['steps']`` replays the original ops in order; each step's
    ``arg`` picks its second operand: -1 none (unary), -2 the chain
    value itself, >=0 an index into the ``Args`` input slot. Every step
    but dropout calls the registered rule of the op it replaces (the
    binaries with their axis broadcast, ``cast``, ``scale``, the unary
    table), so the chain's torch ops — and therefore its values, on the
    CPU and the card alike, and its autograd gradients — are the
    unfused chain's by construction. Test-time dropout, the one step
    kept inline, is the rule's ``x * (1 - p)`` or identity without the
    ``Mask`` fill nothing reads."""
    cur = ins["X"][0]
    args = ins.get("Args", [])
    for step in attrs["steps"]:
        t, a, arg = step["op"], step.get("attrs", {}), step.get("arg", -1)
        if t == "dropout":
            # test time only (the fusion pass admits is_test=True alone):
            # the rule's deterministic downscale or identity, never a draw
            if a.get("dropout_implementation",
                     "downgrade_in_infer") == "downgrade_in_infer":
                cur = cur * (1.0 - a.get("dropout_prob", 0.5))
            continue
        step_ins = {"X": [cur]}
        if arg != -1:
            step_ins["Y"] = [cur if arg == -2 else args[arg]]
        cur = get_op(t).lower(ctx, step_ins, a)["Out"][0]
    return {"Out": [cur]}


@register_op("fused_param_split")
def _fused_param_split(ctx, ins, attrs):
    """Inverse of flatten_concat: slice the fused update result back
    into the individual parameter buffers (attrs['shapes'] carries the
    per-output shapes, in order)."""
    x = ins["X"][0]
    outs, off = [], 0
    for shp in attrs["shapes"]:
        n = int(np.prod([int(s) for s in shp])) if shp else 1
        outs.append(x[off:off + n].reshape([int(s) for s in shp]))
        off += n
    return {"Out": outs}


# ---------------------------------------------------------------------------
# Static shape/dtype inference rules (analysis/infer.py engine).
# Colocated with the lowering rules above — the same pairing as Fluid,
# where InferShape lives on each OperatorWithKernel
# (paddle/fluid/framework/shape_inference.h). These are the reference's
# rules (paddle_tpu/ops/basic.py) for the ops the port registers, pure
# shape arithmetic: they touch no tensor. Integer outputs are declared
# int32 as the reference declares them (the port's kernels emit
# canonical_int()), so the two packages' inferences agree exactly.
# ---------------------------------------------------------------------------
from ..analysis.infer import (InferError, VarInfo, broadcast_shapes,  # noqa: E402
                              dim_prod, dims_compatible, first_in, same_as)
from ..core.framework import convert_dtype  # noqa: E402
from ..core.registry import register_infer  # noqa: E402


def _register_same_shape(*types, in_slot="X", out_slot="Out"):
    for t in types:
        def rule(op, ins, attrs, _slot_in=in_slot, _slot_out=out_slot):
            return {_slot_out: [same_as(first_in(ins, _slot_in))]}
        register_infer(t)(rule)


_register_same_shape(*UNARY_TABLE.keys())
_register_same_shape("softmax", "log_softmax", "prelu", "assign",
                     "fill_zeros_like", "clip", "clip_by_norm", "cumsum",
                     "increment", "scale")


def _attr_dtype(attrs, key="dtype", default="float32"):
    try:
        return convert_dtype(attrs.get(key, default))
    except Exception:
        return None


@register_infer("fill_constant")
def _infer_fill_constant(op, ins, attrs):
    return {"Out": [VarInfo(tuple(attrs.get("shape", [1])),
                            _attr_dtype(attrs), confident=True)]}


@register_infer("assign_value")
def _infer_assign_value(op, ins, attrs):
    shape = np.shape(np.asarray(attrs.get("values", [0.0])))
    return {"Out": [VarInfo(tuple(shape), _attr_dtype(attrs),
                            confident=True)]}


@register_infer("fused_elementwise")
def _infer_fused_elementwise(op, ins, attrs):
    """Shape follows the chain head (broadcast never widens X under
    fluid axis semantics); dtype threads through cast steps."""
    x = first_in(ins, "X")
    dtype = x.dtype
    for step in attrs.get("steps", []):
        if step.get("op") == "cast":
            try:
                dtype = convert_dtype(step["attrs"]["out_dtype"])
            except Exception:
                dtype = None
    return {"Out": [VarInfo(x.shape, dtype, x.lod_level,
                            x.confident)]}


def _infer_batch_size_like(op, ins, attrs):
    ref = first_in(ins, "Input")
    shape = list(attrs["shape"])
    in_idx = attrs.get("input_dim_idx", 0)
    out_idx = attrs.get("output_dim_idx", 0)
    shape[out_idx] = ref.shape[in_idx] if ref.shape is not None \
        and in_idx < len(ref.shape) else -1
    return {"Out": [VarInfo(shape, _attr_dtype(attrs),
                            confident=ref.confident)]}


for _t in ("fill_constant_batch_size_like",
           "uniform_random_batch_size_like",
           "gaussian_random_batch_size_like"):
    register_infer(_t)(_infer_batch_size_like)


def _infer_random(op, ins, attrs):
    return {"Out": [VarInfo(tuple(attrs["shape"]), _attr_dtype(attrs),
                            confident=True)]}


for _t in ("uniform_random", "gaussian_random",
           "truncated_gaussian_random"):
    register_infer(_t)(_infer_random)


@register_infer("cast")
def _infer_cast(op, ins, attrs):
    x = first_in(ins, "X")
    return {"Out": [VarInfo(x.shape, _attr_dtype(attrs, "out_dtype",
                                                 x.dtype),
                            x.lod_level, x.confident)]}


@register_infer("shape")
def _infer_shape_op(op, ins, attrs):
    x = first_in(ins, "Input")
    n = x.ndim if x.ndim is not None else -1
    return {"Out": [VarInfo((n,), "int32", confident=x.confident)]}


@register_infer("mul")
def _infer_mul(op, ins, attrs):
    x, y = first_in(ins, "X"), first_in(ins, "Y")
    if x.lod_level > 0:
        # SequenceBatch path: [b, t, d] @ [d, k] — padded rank differs
        # from the declared lod-var rank, stay conservative
        return {"Out": [VarInfo(None, x.dtype, x.lod_level)]}
    if x.shape is None or y.shape is None:
        return {"Out": [VarInfo(None, x.dtype or y.dtype)]}
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    kx = dim_prod(x.shape[xn:])
    ky = dim_prod(y.shape[:yn])
    if x.confident and y.confident and kx >= 0 and ky >= 0 and kx != ky:
        raise InferError(
            f"mul contraction mismatch: X{x.shape} flattened at "
            f"x_num_col_dims={xn} gives inner dim {kx}, but Y{y.shape} "
            f"flattened at y_num_col_dims={yn} gives {ky}",
            hint="the fc/mul weight's first dim must equal the "
                 "flattened feature size of its input")
    return {"Out": [VarInfo(x.shape[:xn] + y.shape[yn:], x.dtype,
                            confident=x.confident and y.confident)]}


@register_infer("matmul")
def _infer_matmul(op, ins, attrs):
    x, y = first_in(ins, "X"), first_in(ins, "Y")
    if x.shape is None or y.shape is None or x.ndim < 2 or y.ndim < 2:
        return {"Out": [VarInfo(None, x.dtype or y.dtype)]}
    xs = list(x.shape)
    ys = list(y.shape)
    if attrs.get("transpose_X", False):
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if attrs.get("transpose_Y", False):
        ys[-1], ys[-2] = ys[-2], ys[-1]
    if x.confident and y.confident \
            and not dims_compatible(xs[-1], ys[-2]):
        raise InferError(
            f"matmul contraction mismatch: {tuple(xs)} @ {tuple(ys)} "
            f"(inner dims {xs[-1]} vs {ys[-2]})")
    batch = broadcast_shapes(tuple(xs[:-2]), tuple(ys[:-2]))
    return {"Out": [VarInfo(batch + (xs[-2], ys[-1]), x.dtype,
                            confident=x.confident and y.confident)]}


def _infer_elementwise(op, ins, attrs):
    x, y = first_in(ins, "X"), first_in(ins, "Y")
    if x.shape is None:
        return {"Out": [VarInfo(None, x.dtype, x.lod_level)]}
    if y.shape is None or x.shape == y.shape or y.ndim == 0:
        return {"Out": [same_as(x)]}
    if y.ndim > x.ndim:
        return {"Out": [VarInfo(broadcast_shapes(x.shape, y.shape),
                                x.dtype, x.lod_level,
                                x.confident and y.confident)]}
    axis = attrs.get("axis", -1)
    if axis is None or axis == -1:
        axis = x.ndim - y.ndim
    out = list(x.shape)
    for i, yd in enumerate(y.shape):
        xi = axis + i
        if xi >= len(out):
            break
        xd = out[xi]
        if yd == 1 or yd < 0:
            continue
        if xd < 0:
            out[xi] = yd if x.confident and y.confident else -1
        elif xd != yd and xd != 1 and x.confident and y.confident:
            raise InferError(
                f"{op.type}: Y{y.shape} does not match X{x.shape} at "
                f"axis {axis} (dim {xd} vs {yd})",
                hint="fluid broadcast requires Y's shape to match a "
                     "contiguous span of X's dims starting at `axis`")
    return {"Out": [VarInfo(out, x.dtype, x.lod_level,
                            x.confident and y.confident)]}


for _t in ("elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_max", "elementwise_min",
           "elementwise_pow", "elementwise_mod", "elementwise_floordiv"):
    register_infer(_t)(_infer_elementwise)


@register_infer("sum")
def _infer_sum(op, ins, attrs):
    xs = ins.get("X", [])
    known = [x for x in xs if x.shape is not None]
    if not known:
        return {"Out": [VarInfo(None, xs[0].dtype if xs else None)]}
    return {"Out": [same_as(known[0])]}


@register_infer("mean")
def _infer_mean(op, ins, attrs):
    x = first_in(ins, "X")
    return {"Out": [VarInfo((1,), x.dtype, confident=x.confident)]}


def _infer_reduce(op, ins, attrs):
    x = first_in(ins, "X")
    if x.shape is None:
        return {"Out": [VarInfo(None, x.dtype)]}
    if attrs.get("reduce_all", False):
        shape = (1,) * x.ndim if attrs.get("keep_dim", False) else ()
        return {"Out": [VarInfo(shape, x.dtype, confident=x.confident)]}
    dim = attrs.get("dim", [0])
    axes = {d % x.ndim for d in
            (dim if isinstance(dim, (list, tuple)) else [dim])}
    if attrs.get("keep_dim", False):
        shape = tuple(1 if i in axes else d
                      for i, d in enumerate(x.shape))
    else:
        shape = tuple(d for i, d in enumerate(x.shape) if i not in axes)
    return {"Out": [VarInfo(shape, x.dtype, confident=x.confident)]}


for _t in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
           "reduce_prod"):
    register_infer(_t)(_infer_reduce)


@register_infer("reshape")
def _infer_reshape(op, ins, attrs):
    x = first_in(ins, "X")
    shape = [int(s) for s in attrs["shape"]]
    if x.shape is not None:
        shape = [x.shape[i] if s == 0 and i < len(x.shape) else s
                 for i, s in enumerate(shape)]
        total = dim_prod(x.shape)
        rest = dim_prod([s for s in shape if s != -1])
        if -1 in shape:
            if total >= 0 and rest > 0 and total % rest == 0:
                shape[shape.index(-1)] = total // rest
        elif x.confident and total >= 0 and rest >= 0 and total != rest:
            raise InferError(
                f"reshape cannot map {x.shape} ({total} elements) to "
                f"{tuple(shape)} ({rest} elements)")
    else:
        shape = [-1 if s in (0, -1) else s for s in shape]
    return {"Out": [VarInfo(shape, x.dtype, x.lod_level, x.confident)]}


@register_infer("reshape2")
def _infer_reshape2(op, ins, attrs):
    out = _infer_reshape(op, ins, attrs)
    x = first_in(ins, "X")
    xshape = VarInfo((0,) + x.shape if x.shape is not None else None,
                     x.dtype, confident=x.confident)
    out["XShape"] = [xshape]
    return out


@register_infer("squeeze")
def _infer_squeeze(op, ins, attrs):
    x = first_in(ins, "X")
    if x.shape is None:
        return {"Out": [VarInfo(None, x.dtype)]}
    axes = attrs.get("axes", [])
    if not axes:
        shape = tuple(d for d in x.shape if d != 1)
    else:
        drop = {a % x.ndim for a in axes}
        shape = tuple(d for i, d in enumerate(x.shape) if i not in drop)
    return {"Out": [VarInfo(shape, x.dtype, confident=x.confident)]}


@register_infer("unsqueeze")
def _infer_unsqueeze(op, ins, attrs):
    x = first_in(ins, "X")
    if x.shape is None:
        return {"Out": [VarInfo(None, x.dtype)]}
    shape = list(x.shape)
    for a in sorted(attrs["axes"]):
        shape.insert(a if a >= 0 else a + len(shape) + 1, 1)
    return {"Out": [VarInfo(shape, x.dtype, confident=x.confident)]}


@register_infer("transpose")
def _infer_transpose(op, ins, attrs):
    x = first_in(ins, "X")
    perm = attrs.get("axis")
    if x.shape is None or perm is None or len(perm) != x.ndim:
        return {"Out": [VarInfo(None, x.dtype)]}
    return {"Out": [VarInfo(tuple(x.shape[p] for p in perm), x.dtype,
                            confident=x.confident)]}


@register_infer("transpose2")
def _infer_transpose2(op, ins, attrs):
    out = _infer_transpose(op, ins, attrs)
    x = first_in(ins, "X")
    out["XShape"] = [VarInfo((0,) + x.shape if x.shape is not None
                             else None, x.dtype, confident=x.confident)]
    return out


@register_infer("pad2d")
def _infer_pad2d(op, ins, attrs):
    x = first_in(ins, "X")
    if x.shape is None or len(x.shape) != 4:
        return {"Out": [VarInfo(None, x.dtype)]}
    t, b, l, r = attrs.get("paddings", [0, 0, 0, 0])
    hi, wi = (2, 3) if attrs.get("data_format", "NCHW") == "NCHW" \
        else (1, 2)
    shape = list(x.shape)
    if shape[hi] >= 0:
        shape[hi] += t + b
    if shape[wi] >= 0:
        shape[wi] += l + r
    return {"Out": [VarInfo(shape, x.dtype, confident=x.confident)]}


@register_infer("flatten")
def _infer_flatten(op, ins, attrs):
    x = first_in(ins, "X")
    if x.shape is None:
        return {"Out": [VarInfo(None, x.dtype)]}
    axis = attrs.get("axis", 1)
    lead = dim_prod(x.shape[:axis]) if axis > 0 else 1
    rest = dim_prod(x.shape[axis:])
    return {"Out": [VarInfo((lead, rest), x.dtype,
                            confident=x.confident)]}


@register_infer("concat")
def _infer_concat(op, ins, attrs):
    xs = ins.get("X", [])
    axis = attrs.get("axis", 0)
    known = [x for x in xs if x.shape is not None]
    if not known:
        return {"Out": [VarInfo(None, xs[0].dtype if xs else None)]}
    nd = known[0].ndim
    ax = axis % nd
    out = list(known[0].shape)
    csum = 0
    confident = all(x.confident for x in xs)
    for x in xs:
        if x.shape is None or x.ndim != nd:
            csum = -1
            continue
        for i in range(nd):
            if i == ax:
                continue
            if confident and not dims_compatible(out[i], x.shape[i]):
                raise InferError(
                    f"concat inputs disagree on non-axis dim {i}: "
                    f"{tuple(out)} vs {x.shape} (axis={ax})")
            if out[i] < 0:
                out[i] = x.shape[i]
        if csum >= 0:
            csum = -1 if x.shape[ax] < 0 else csum + x.shape[ax]
    out[ax] = csum
    return {"Out": [VarInfo(out, known[0].dtype, known[0].lod_level,
                            confident)]}


@register_infer("split")
def _infer_split(op, ins, attrs):
    x = first_in(ins, "X")
    n_out = len(op.outputs.get("Out", []))
    if x.shape is None:
        return {"Out": [VarInfo(None, x.dtype)] * n_out}
    axis = attrs.get("axis", 0) % x.ndim
    sections = attrs.get("sections", [])
    outs = []
    for i in range(n_out):
        shape = list(x.shape)
        if sections:
            shape[axis] = sections[i] if i < len(sections) else -1
        elif shape[axis] >= 0 and n_out:
            shape[axis] = shape[axis] // n_out
        outs.append(VarInfo(shape, x.dtype, confident=x.confident))
    return {"Out": outs}


@register_infer("stack")
def _infer_stack(op, ins, attrs):
    xs = ins.get("X", [])
    known = [x for x in xs if x.shape is not None]
    if not known:
        return {"Y": [VarInfo(None, xs[0].dtype if xs else None)]}
    axis = attrs.get("axis", 0)
    shape = list(known[0].shape)
    shape.insert(axis if axis >= 0 else axis + len(shape) + 1, len(xs))
    return {"Y": [VarInfo(shape, known[0].dtype,
                          confident=all(x.confident for x in xs))]}


@register_infer("expand")
def _infer_expand(op, ins, attrs):
    x = first_in(ins, "X")
    times = attrs["expand_times"]
    if x.shape is None or len(times) != x.ndim:
        return {"Out": [VarInfo(None, x.dtype)]}
    shape = tuple(-1 if d < 0 else d * t
                  for d, t in zip(x.shape, times))
    return {"Out": [VarInfo(shape, x.dtype, confident=x.confident)]}


@register_infer("slice")
def _infer_slice(op, ins, attrs):
    x = first_in(ins, "Input")
    if x.shape is None:
        return {"Out": [VarInfo(None, x.dtype)]}
    shape = list(x.shape)
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = shape[a]
        if dim < 0:
            continue
        s2 = max(s + dim, 0) if s < 0 else min(s, dim)
        e2 = max(e + dim, 0) if e < 0 else min(e, dim)
        shape[a] = max(e2 - s2, 0)
    return {"Out": [VarInfo(shape, x.dtype, confident=x.confident)]}


@register_infer("gather")
def _infer_gather(op, ins, attrs):
    x, idx = first_in(ins, "X"), first_in(ins, "Index")
    if x.shape is None or idx.shape is None:
        return {"Out": [VarInfo(None, x.dtype)]}
    return {"Out": [VarInfo((dim_prod(idx.shape),) + x.shape[1:],
                            x.dtype,
                            confident=x.confident and idx.confident)]}


@register_infer("one_hot")
def _infer_one_hot(op, ins, attrs):
    x = first_in(ins, "X")
    depth = attrs["depth"]
    if x.shape is None:
        return {"Out": [VarInfo(None, "float32")]}
    base = x.shape[:-1] if x.shape and x.shape[-1] == 1 else x.shape
    return {"Out": [VarInfo(base + (depth,), "float32",
                            confident=x.confident)]}


@register_infer("arg_max")
def _infer_arg_max(op, ins, attrs):
    x = first_in(ins, "X")
    if x.shape is None:
        return {"Out": [VarInfo(None, "int32")]}
    axis = attrs.get("axis", -1) % x.ndim
    shape = tuple(d for i, d in enumerate(x.shape) if i != axis)
    return {"Out": [VarInfo(shape, "int32", confident=x.confident)]}


register_infer("arg_min")(_infer_arg_max)


@register_infer("argsort")
def _infer_argsort(op, ins, attrs):
    x = first_in(ins, "X")
    return {"Out": [same_as(x)],
            "Indices": [VarInfo(x.shape, "int32", confident=x.confident)]}


@register_infer("top_k")
def _infer_top_k(op, ins, attrs):
    x = first_in(ins, "X")
    k = attrs["k"]
    if x.shape is None:
        return {"Out": [VarInfo(None, x.dtype)],
                "Indices": [VarInfo(None, "int32")]}
    shape = x.shape[:-1] + (k,)
    return {"Out": [VarInfo(shape, x.dtype, confident=x.confident)],
            "Indices": [VarInfo(shape, "int32", confident=x.confident)]}


@register_infer("pad")
def _infer_pad(op, ins, attrs):
    x = first_in(ins, "X")
    if x.shape is None:
        return {"Out": [VarInfo(None, x.dtype)]}
    p = attrs["paddings"]
    shape = tuple(-1 if d < 0 else d + p[2 * i] + p[2 * i + 1]
                  for i, d in enumerate(x.shape))
    return {"Out": [VarInfo(shape, x.dtype, confident=x.confident)]}


# ---------------------------------------------------------------------------
# Numerics transfer functions (analysis/numcheck.py engine) — the third
# registered half of each op: how its value RANGES move. The reference's
# rules for the ops the port registers, colocated with the lowering +
# infer rules above, same purity contract (no tensors). The
# engine stamps dtype/shape/confidence; rules only do interval
# arithmetic and finiteness. Intervals are conservative over REAL
# arithmetic — the engine separately checks narrow-dtype overflow.
# ---------------------------------------------------------------------------
from ..analysis.infer import dim_prod as _num_dim_prod  # noqa: E402
from ..analysis.numcheck import (NumInfo, interval, num_first,  # noqa: E402
                                 add_iv, sub_iv, mul_iv, div_iv, join_iv)
from ..core.registry import get_numerics, register_numerics  # noqa: E402


def _register_num_passthrough(*types, in_slot="X", out_slot="Out"):
    """Value-preserving ops (data movement, assign): output range is
    the input range."""
    for t in types:
        def rule(op, ins, attrs, _si=in_slot, _so=out_slot):
            x = num_first(ins, _si)
            return {_so: [x.with_range(x.lo, x.hi)]}
        register_numerics(t)(rule)


_register_num_passthrough(
    "assign", "reshape", "reshape2", "squeeze", "unsqueeze", "transpose",
    "transpose2", "flatten", "slice", "gather", "expand", "cast")


def _register_num_unary(**table):
    """Monotone-interval unaries: fn(lo, hi, attrs) → (lo, hi, finite)."""
    for t, fn in table.items():
        def rule(op, ins, attrs, _fn=fn):
            x = num_first(ins, "X")
            lo, hi, finite = _fn(x.lo, x.hi, attrs)
            return {"Out": [interval(lo, hi, finite)]}
        register_numerics(t)(rule)


def _softplus(x):
    # overflow-safe log(1 + e^x): ~x for large x, ~0 for very negative
    if x > 30.0:
        return x
    if x < -30.0:
        return 0.0
    return math.log1p(math.exp(x))


def _safe_exp(x):
    try:
        return math.exp(x)
    except OverflowError:
        return math.inf


def _leaky(lo, hi, alpha):
    return (lo if lo >= 0 else alpha * lo,
            hi if hi >= 0 else alpha * hi)


def _square_iv(lo, hi):
    a, b = lo * lo, hi * hi
    a, b = (0.0 if math.isnan(v) else v for v in (a, b))
    return (0.0 if lo <= 0 <= hi else min(a, b)), max(a, b)


_register_num_unary(
    relu=lambda lo, hi, a: (max(lo, 0.0), max(hi, 0.0), True),
    relu6=lambda lo, hi, a: (0.0, a.get("threshold", 6.0), True),
    brelu=lambda lo, hi, a: (a.get("t_min", 0.0), a.get("t_max", 24.0),
                             True),
    sigmoid=lambda lo, hi, a: (0.0, 1.0, True),
    hard_sigmoid=lambda lo, hi, a: (0.0, 1.0, True),
    tanh=lambda lo, hi, a: (-1.0, 1.0, True),
    stanh=lambda lo, hi, a: (-abs(a.get("scale_b", 1.7159)),
                             abs(a.get("scale_b", 1.7159)), True),
    sin=lambda lo, hi, a: (-1.0, 1.0, True),
    cos=lambda lo, hi, a: (-1.0, 1.0, True),
    sign=lambda lo, hi, a: (-1.0, 1.0, True),
    logical_not=lambda lo, hi, a: (0.0, 1.0, True),
    softsign=lambda lo, hi, a: (-1.0, 1.0, True),
    abs=lambda lo, hi, a: ((0.0 if lo <= 0 <= hi else min(abs(lo),
                                                          abs(hi))),
                           max(abs(lo), abs(hi)), True),
    square=lambda lo, hi, a: _square_iv(lo, hi) + (True,),
    exp=lambda lo, hi, a: (_safe_exp(lo), _safe_exp(hi), True),
    softplus=lambda lo, hi, a: (_softplus(lo), _softplus(hi), True),
    soft_relu=lambda lo, hi, a: (0.0, a.get("threshold", 40.0) + 0.7,
                                 True),
    logsigmoid=lambda lo, hi, a: (-_softplus(-lo), -_softplus(-hi),
                                  True),
    leaky_relu=lambda lo, hi, a: _leaky(lo, hi, a.get("alpha", 0.02))
    + (True,),
    elu=lambda lo, hi, a: (max(lo, -abs(a.get("alpha", 1.0)))
                           if lo < 0 else lo, max(hi, 0.0), True),
    # gelu/swish/mish dip slightly below 0 (min ≈ -0.17 / -0.28/β /
    # -0.31) and sit under max(x, 0) above
    gelu=lambda lo, hi, a: (max(min(lo, 0.0), -0.17), max(hi, 0.0),
                            True),
    swish=lambda lo, hi, a: (max(min(lo, 0.0),
                                 -0.2785 / max(a.get("beta", 1.0),
                                               1e-6)),
                             max(hi, 0.0), True),
    mish=lambda lo, hi, a: (max(min(lo, 0.0), -0.31), max(hi, 0.0),
                            True),
    tanh_shrink=lambda lo, hi, a: (min(lo, 0.0), max(hi, 0.0), True),
    softshrink=lambda lo, hi, a: (min(lo, 0.0), max(hi, 0.0), True),
    hard_shrink=lambda lo, hi, a: (min(lo, 0.0), max(hi, 0.0), True),
    thresholded_relu=lambda lo, hi, a: (0.0, max(hi, 0.0), True),
    floor=lambda lo, hi, a: (lo - 1.0, hi, True),
    ceil=lambda lo, hi, a: (lo, hi + 1.0, True),
    round=lambda lo, hi, a: (lo - 0.5, hi + 0.5, True),
    clip=lambda lo, hi, a: (a.get("min", -math.inf),
                            a.get("max", math.inf), True),
    clip_by_norm=lambda lo, hi, a: (
        max(lo, -abs(a.get("max_norm", math.inf))),
        min(hi, abs(a.get("max_norm", math.inf))), True),
    softmax=lambda lo, hi, a: (0.0, 1.0, True),
    log_softmax=lambda lo, hi, a: (-math.inf, 0.0, True),
)


@register_numerics("log")
def _num_log(op, ins, attrs):
    x = num_first(ins, "X")
    if x.lo > 0:
        return {"Out": [interval(math.log(x.lo),
                                 math.log(x.hi) if x.hi < math.inf
                                 else math.inf)]}
    return {"Out": [interval(-math.inf,
                             math.log(x.hi) if 0 < x.hi < math.inf
                             else math.inf, finite=False)]}


@register_numerics("sqrt")
def _num_sqrt(op, ins, attrs):
    x = num_first(ins, "X")
    ok = x.lo >= 0
    lo = math.sqrt(max(x.lo, 0.0))
    hi = math.sqrt(x.hi) if 0 <= x.hi < math.inf else math.inf
    return {"Out": [interval(lo, hi, finite=ok)]}


@register_numerics("rsqrt")
def _num_rsqrt(op, ins, attrs):
    x = num_first(ins, "X")
    if x.lo > 0:
        return {"Out": [interval(
            1.0 / math.sqrt(x.hi) if x.hi < math.inf else 0.0,
            1.0 / math.sqrt(x.lo))]}
    return {"Out": [NumInfo(confident=True)]}


@register_numerics("reciprocal")
def _num_reciprocal(op, ins, attrs):
    x = num_first(ins, "X")
    qlo, qhi = div_iv(interval(1.0, 1.0), x)
    return {"Out": [interval(qlo, qhi,
                             finite=(x.lo > 0 or x.hi < 0))]}


@register_numerics("pow")
def _num_pow(op, ins, attrs):
    x = num_first(ins, "X")
    f = attrs.get("factor", 1.0)
    if f == 1.0:
        return {"Out": [x.with_range(x.lo, x.hi)]}
    if f == 2.0:
        lo, hi = _square_iv(x.lo, x.hi)
        return {"Out": [interval(lo, hi)]}
    if f == 0.5:
        return _num_sqrt(op, ins, attrs)
    return None


@register_numerics("scale")
def _num_scale(op, ins, attrs):
    x = num_first(ins, "X")
    s = float(attrs.get("scale", 1.0))
    b = float(attrs.get("bias", 0.0))
    if attrs.get("bias_after_scale", True):
        lo, hi = x.lo * s + b, x.hi * s + b
    else:
        lo, hi = (x.lo + b) * s, (x.hi + b) * s
    if s < 0:
        lo, hi = hi, lo
    lo, hi = (0.0 if math.isnan(v) else v for v in (lo, hi))
    return {"Out": [interval(lo, hi)]}


@register_numerics("increment")
def _num_increment(op, ins, attrs):
    x = num_first(ins, "X")
    step = float(attrs.get("step", 1.0))
    return {"Out": [interval(x.lo + step, x.hi + step)]}


@register_numerics("fill_constant")
def _num_fill_constant(op, ins, attrs):
    v = float(attrs.get("value", 0.0))
    return {"Out": [interval(v, v)]}


@register_numerics("assign_value")
def _num_assign_value(op, ins, attrs):
    vals = [float(v) for v in np.asarray(
        attrs.get("values", [0.0])).ravel()]
    return {"Out": [interval(min(vals), max(vals))]} if vals else None


@register_numerics("fill_zeros_like")
def _num_fill_zeros_like(op, ins, attrs):
    return {"Out": [interval(0.0, 0.0)]}


@register_numerics("fill_constant_batch_size_like")
def _num_fill_batch_like(op, ins, attrs):
    v = float(attrs.get("value", 0.0))
    return {"Out": [interval(v, v)]}


@register_numerics("uniform_random")
def _num_uniform_random(op, ins, attrs):
    return {"Out": [interval(float(attrs.get("min", -1.0)),
                             float(attrs.get("max", 1.0)))]}


@register_numerics("gaussian_random")
def _num_gaussian_random(op, ins, attrs):
    # unbounded support, but every draw is finite
    return {"Out": [interval(-math.inf, math.inf)]}


def _num_binary(op, ins, attrs, fn, finite_fn=None):
    x, y = num_first(ins, "X"), num_first(ins, "Y")
    lo, hi = fn(x, y)
    fin = finite_fn(x, y) if finite_fn else True
    return {"Out": [interval(lo, hi, finite=fin)]}


register_numerics("elementwise_add")(
    lambda op, ins, attrs: _num_binary(op, ins, attrs, add_iv))
register_numerics("elementwise_sub")(
    lambda op, ins, attrs: _num_binary(op, ins, attrs, sub_iv))
register_numerics("elementwise_mul")(
    lambda op, ins, attrs: _num_binary(op, ins, attrs, mul_iv))
register_numerics("elementwise_div")(
    lambda op, ins, attrs: _num_binary(
        op, ins, attrs, div_iv,
        finite_fn=lambda x, y: y.lo > 0 or y.hi < 0))
register_numerics("elementwise_max")(
    lambda op, ins, attrs: _num_binary(
        op, ins, attrs, lambda x, y: (max(x.lo, y.lo), max(x.hi, y.hi))))
register_numerics("elementwise_min")(
    lambda op, ins, attrs: _num_binary(
        op, ins, attrs, lambda x, y: (min(x.lo, y.lo), min(x.hi, y.hi))))


@register_numerics("elementwise_mod")
def _num_mod(op, ins, attrs):
    y = num_first(ins, "Y")
    if y.lo > 0 or y.hi < 0:
        m = y.mag
        return {"Out": [interval(-m, m)]}
    return {"Out": [NumInfo(confident=True)]}


def _contraction_bound(x, y, k):
    """|out| ≤ k · max|x| · max|y| — the accumulate-width-aware bound
    for matmul-shaped ops (k = contraction size). Returns a finite
    NumInfo, unbounded when k or an operand magnitude is unknown."""
    if k is None or k < 0 or x.mag == math.inf or y.mag == math.inf:
        return interval(-math.inf, math.inf)
    m = k * x.mag * y.mag
    lo = 0.0 if (x.lo >= 0 and y.lo >= 0) else -m
    return interval(lo, m)


@register_numerics("mul")
def _num_mul_op(op, ins, attrs):
    x, y = num_first(ins, "X"), num_first(ins, "Y")
    xn = attrs.get("x_num_col_dims", 1)
    k = _num_dim_prod(x.shape[xn:]) if x.shape is not None else None
    return {"Out": [_contraction_bound(x, y, k)]}


@register_numerics("matmul")
def _num_matmul(op, ins, attrs):
    x, y = num_first(ins, "X"), num_first(ins, "Y")
    k = None
    if x.shape is not None and len(x.shape) >= 2:
        k = x.shape[-2] if attrs.get("transpose_X", False) \
            else x.shape[-1]
    return {"Out": [_contraction_bound(x, y, k)]}


@register_numerics("sum")
def _num_sum(op, ins, attrs):
    xs = ins.get("X", [])
    if not xs:
        return None
    lo = sum(x.lo for x in xs)
    hi = sum(x.hi for x in xs)
    lo, hi = (0.0 if math.isnan(v) else v for v in (lo, hi))
    return {"Out": [interval(lo, hi)]}


@register_numerics("mean")
def _num_mean(op, ins, attrs):
    x = num_first(ins, "X")
    return {"Out": [interval(x.lo, x.hi)]}


def _reduced_count(x, attrs):
    if x.shape is None:
        return None
    if attrs.get("reduce_all", False):
        return _num_dim_prod(x.shape)
    dim = attrs.get("dim", [0])
    axes = [d % len(x.shape) for d in
            (dim if isinstance(dim, (list, tuple)) else [dim])]
    return _num_dim_prod([x.shape[a] for a in axes])


@register_numerics("reduce_sum")
def _num_reduce_sum(op, ins, attrs):
    x = num_first(ins, "X")
    k = _reduced_count(x, attrs)
    if k is None or k < 0:
        # unknown reduced count: still a finite sum of finite terms,
        # but the range degrades to the sign information alone
        return {"Out": [interval(-math.inf if x.lo < 0 else 0.0,
                                 math.inf if x.hi > 0 else 0.0)]}
    lo = min(k * x.lo, 0.0) if x.lo < 0 else k * x.lo
    hi = max(k * x.hi, 0.0) if x.hi > 0 else k * x.hi
    return {"Out": [interval(lo, hi)]}


@register_numerics("reduce_mean")
def _num_reduce_mean(op, ins, attrs):
    x = num_first(ins, "X")
    return {"Out": [interval(x.lo, x.hi)]}


register_numerics("reduce_max")(
    lambda op, ins, attrs: {"Out": [interval(num_first(ins, "X").lo,
                                             num_first(ins, "X").hi)]})
register_numerics("reduce_min")(
    lambda op, ins, attrs: {"Out": [interval(num_first(ins, "X").lo,
                                             num_first(ins, "X").hi)]})


@register_numerics("cumsum")
def _num_cumsum(op, ins, attrs):
    x = num_first(ins, "X")
    if x.shape is None:
        return {"Out": [interval(-math.inf if x.lo < 0 else 0.0,
                                 math.inf if x.hi > 0 else 0.0)]}
    axis = attrs.get("axis", -1)
    k = x.shape[axis] if -len(x.shape) <= axis < len(x.shape) else -1
    if k < 0:
        return {"Out": [interval(-math.inf if x.lo < 0 else 0.0,
                                 math.inf if x.hi > 0 else 0.0)]}
    return {"Out": [interval(min(k * x.lo, x.lo), max(k * x.hi, x.hi))]}


@register_numerics("concat")
def _num_concat(op, ins, attrs):
    xs = ins.get("X", [])
    j = join_iv(xs)
    return {"Out": [interval(j.lo, j.hi, j.finite)]}


@register_numerics("stack")
def _num_stack(op, ins, attrs):
    xs = ins.get("X", [])
    j = join_iv(xs)
    return {"Out": [interval(j.lo, j.hi, j.finite)]}


@register_numerics("split")
def _num_split(op, ins, attrs):
    x = num_first(ins, "X")
    n = len(op.output("Out"))
    return {"Out": [x.with_range(x.lo, x.hi) for _ in range(n)]}


def _num_pad_like(op, ins, attrs):
    x = num_first(ins, "X")
    v = float(attrs.get("pad_value", 0.0))
    return {"Out": [interval(min(x.lo, v), max(x.hi, v))]}


register_numerics("pad")(_num_pad_like)
register_numerics("pad2d")(_num_pad_like)


@register_numerics("one_hot")
def _num_one_hot(op, ins, attrs):
    return {"Out": [interval(0.0, 1.0)]}


@register_numerics("top_k")
def _num_top_k(op, ins, attrs):
    x = num_first(ins, "X")
    hi_idx = float(x.shape[-1] - 1) \
        if x.shape and x.shape[-1] > 0 else math.inf
    return {"Out": [interval(x.lo, x.hi)],
            "Indices": [interval(0.0, hi_idx)]}


class _ChainOp:
    """Stand-in op handed to per-step numerics rules when the fused
    chain replays them (rules only touch .type/.input/.output)."""

    def __init__(self, type):
        self.type = type

    def input(self, slot):
        return ["<chain>"]

    def output(self, slot):
        return ["<chain>"]


@register_numerics("fused_elementwise")
def _num_fused_elementwise(op, ins, attrs):
    """Replays the fused chain's steps over intervals — the same
    per-step transfer functions the unfused ops would get, so
    admitting a fusion never loses range precision."""
    x = num_first(ins, "X")
    cur = interval(x.lo, x.hi, x.finite)
    args = ins.get("Args", [])
    for step in attrs.get("steps", []):
        t = step.get("op")
        sattrs = step.get("attrs", {})
        arg = step.get("arg", -1)
        other = args[arg] if 0 <= arg < len(args) else cur
        if t == "dropout":
            # fused chains carry eval-mode dropout only: identity or a
            # deterministic |scale| <= 1 downscale — range shrinks
            cur = interval(min(cur.lo, 0.0), max(cur.hi, 0.0),
                           cur.finite)
            continue
        rule = get_numerics(t)
        out = rule(_ChainOp(t), {"X": [cur], "Y": [other]}, sattrs) \
            if rule is not None else None
        vals = (out or {}).get("Out")
        nxt = vals[0] if vals else None
        if nxt is None:
            cur = NumInfo(confident=True)
        else:
            nxt.finite = nxt.finite and cur.finite and other.finite
            cur = nxt
    return {"Out": [cur]}
