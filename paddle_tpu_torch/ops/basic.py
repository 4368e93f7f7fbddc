"""Basic tensor / math op lowering rules (port of
``paddle_tpu/ops/basic.py``): the creation, matmul, elementwise and
reshape rules the Llama forward program and its startup use."""
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


@register_op("gaussian_random", stateful=True)
def _gaussian_random(ctx, ins, attrs):
    shape = tuple(attrs["shape"])
    dt = torch_dtype(attrs.get("dtype", "float32"))
    out = (torch.randn(shape, generator=ctx.next_key(), device=ctx.device,
                       dtype=torch.float32) * attrs.get("std", 1.0)
           + attrs.get("mean", 0.0))
    return {"Out": [out.to(dt)]}


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


for _n, _f in [("elementwise_add", torch.add),
               ("elementwise_mul", torch.mul)]:
    _register_elementwise(_n, _f)


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
