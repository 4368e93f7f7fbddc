"""Transformer building-block layers (port of
``paddle_tpu/layers/transformer.py``): rms_norm, rope, multihead
attention (the flash kernel), silu. The layer-stacked decoder, MoE,
generation and paged-decode layers arrive with their slices."""
from ..layer_helper import LayerHelper
from .. import initializer as init_mod

__all__ = ["rms_norm", "rope", "multihead_attention", "silu"]


def rms_norm(input, epsilon=1e-6, param_attr=None, name=None):
    helper = LayerHelper("rms_norm", param_attr=param_attr, name=name)
    d = int(input.shape[-1])
    scale = helper.create_parameter(helper.param_attr, [d], input.dtype,
                                    default_initializer=init_mod.Constant(1.0))
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=input.shape)
    helper.append_op(type="rms_norm",
                     inputs={"X": [input.name], "Scale": [scale.name]},
                     outputs={"Y": [out.name]},
                     attrs={"epsilon": epsilon})
    return out


def rope(x, base=10000.0, name=None):
    """x: [batch, seq, heads, head_dim]."""
    helper = LayerHelper("rope", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(type="rope", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"base": base})
    return out


def multihead_attention(q, k, v, causal=True, scale=None, name=None):
    """q,k,v: [batch, seq, heads, head_dim] (k/v may have fewer heads for
    GQA). Lowers to the flash-attention forward kernel."""
    helper = LayerHelper("multihead_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype, shape=q.shape)
    attrs = {"causal": causal}
    if scale is not None:
        attrs["scale"] = scale
    helper.append_op(type="multihead_attention",
                     inputs={"Q": [q.name], "K": [k.name], "V": [v.name]},
                     outputs={"Out": [out.name]}, attrs=attrs)
    return out


def silu(x, name=None):
    helper = LayerHelper("silu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(type="silu", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out
