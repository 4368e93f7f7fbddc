"""The weight-only int8 ops (port of the part of
``paddle_tpu/ops/extras.py`` that ``transpiler/quantize_transpiler.py``
emits): ``quantized_mul`` and ``quantized_conv2d``, each dequantizing its
int8 weight with the per-channel ``Scale`` into the activation's dtype
and running the float op's own rule, and their infer and numerics rules.
The module's other ops (fake quantize and dequantize, the rest of the
extras family) wait for ROADMAP.md item 'Remaining op families and the
zoo' (``core/registry.py`` names each).
"""
import math

from ..core.registry import get_op, register_op


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
# Static infer + numerics rules (colocated with the lowerings above; no
# tensors).
# ---------------------------------------------------------------------------
from ..analysis.numcheck import interval  # noqa: E402
from ..core.registry import register_infer, register_numerics  # noqa: E402


@register_infer("quantized_mul")
def _infer_quantized_mul(op, ins, attrs):
    from .basic import _infer_mul
    return {"Out": _infer_mul(op, ins, attrs)["Out"]}


@register_infer("quantized_conv2d")
def _infer_quantized_conv2d(op, ins, attrs):
    from .nn import _infer_conv2d
    return _infer_conv2d(op, ins, attrs)


def _num_quantized_matmul(op, ins, attrs):
    # int8 weight dequantized then contracted with finite activations:
    # finite, magnitude open (scale tensor unbounded by seeds)
    return {"Out" if op.type == "quantized_mul" else "Output":
            [interval(-math.inf, math.inf)]}


register_numerics("quantized_mul")(_num_quantized_matmul)
register_numerics("quantized_conv2d")(_num_quantized_matmul)
