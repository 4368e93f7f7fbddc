"""Basic tensor / math op lowering rules (port of
``paddle_tpu/ops/basic.py``): the creation, cast, matmul, elementwise,
reduction, softmax and reshape rules that the Llama and MNIST train
programs, their startups and the optimizers' helper ops (beta-power
``scale``, L1/L2 decay, gradient clipping) use."""
import torch

from ..core.framework import torch_dtype
from ..core.registry import register_op


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------


@register_op("fill_constant")
def _fill_constant(ctx, ins, attrs):
    shape = attrs.get("shape", [1])
    return {"Out": [torch.full(tuple(shape), attrs.get("value", 0.0),
                               dtype=torch_dtype(attrs.get("dtype",
                                                           "float32")),
                               device=ctx.device)]}


@register_op("uniform_random", stateful=True)
def _uniform_random(ctx, ins, attrs):
    shape = tuple(attrs["shape"])
    dt = torch_dtype(attrs.get("dtype", "float32"))
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    out = torch.rand(shape, generator=ctx.next_key(), device=ctx.device,
                     dtype=torch.float32) * (hi - lo) + lo
    return {"Out": [out.to(dt)]}


@register_op("gaussian_random", stateful=True)
def _gaussian_random(ctx, ins, attrs):
    shape = tuple(attrs["shape"])
    dt = torch_dtype(attrs.get("dtype", "float32"))
    out = (torch.randn(shape, generator=ctx.next_key(), device=ctx.device,
                       dtype=torch.float32) * attrs.get("std", 1.0)
           + attrs.get("mean", 0.0))
    return {"Out": [out.to(dt)]}


@register_op("cast")
def _cast(ctx, ins, attrs):
    return {"Out": [ins["X"][0].to(torch_dtype(attrs["out_dtype"]))]}


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


def _prod(dims):
    r = 1
    for d in dims:
        r *= d
    return r


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


def _register_elementwise(name, fn):
    @register_op(name)
    def rule(ctx, ins, attrs, _fn=fn):
        x, y = _bcast(ins["X"][0], ins["Y"][0], attrs.get("axis", -1))
        return {"Out": [_fn(x, y)]}


# div and max: global-norm gradient clipping (clip.py)
for _n, _f in [("elementwise_add", torch.add),
               ("elementwise_mul", torch.mul),
               ("elementwise_div", torch.div),
               ("elementwise_max", torch.maximum)]:
    _register_elementwise(_n, _f)


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
# activations and math the optimizers' helper ops use
# ---------------------------------------------------------------------------


register_op("sqrt")(lambda ctx, ins, attrs: {
    "Out": [torch.sqrt(ins["X"][0])]})
register_op("sign")(lambda ctx, ins, attrs: {
    "Out": [torch.sign(ins["X"][0])]})


@register_op("softmax")
def _softmax(ctx, ins, attrs):
    return {"Out": [torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))]}


@register_op("clip")
def _clip(ctx, ins, attrs):
    return {"Out": [torch.clamp(ins["X"][0], attrs["min"], attrs["max"])]}


@register_op("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    x = ins["X"][0]
    mn = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return {"Out": [x * (mn / torch.clamp(norm, min=mn))]}


@register_op("increment")
def _increment(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x + torch.tensor(attrs.get("step", 1.0), dtype=x.dtype,
                                     device=x.device)]}


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------


@register_op("reshape")
def _reshape(ctx, ins, attrs):
    x = ins["X"][0]
    shape = list(attrs["shape"])
    # fluid semantics: 0 copies the input dim, -1 infers
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return {"Out": [x.reshape(tuple(shape))]}


register_op("reshape2")(lambda ctx, ins, attrs: {
    "Out": [_reshape(ctx, ins, attrs)["Out"][0]],
    "XShape": [torch.zeros((0,) + tuple(ins["X"][0].shape),
                           device=ctx.device)]})
