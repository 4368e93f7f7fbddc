"""Transformer building-block layers (port of
``paddle_tpu/layers/transformer.py``): rms_norm, rope, multihead
attention (the flash kernel), silu, the layer-stacked decoder and the
vocab-chunked fused head loss. MoE, generation and paged-decode layers
arrive with their slices."""
import copy

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from ..sharding import PartitionSpec as P
from .. import initializer as init_mod

__all__ = ["rms_norm", "rope", "multihead_attention", "silu",
           "llama_decoder_stack", "fused_head_cross_entropy"]


def fused_head_cross_entropy(h, label, vocab_size, chunk_size=8192,
                             ignore_index=-100, head_name="lm_head",
                             name=None):
    """Per-token ``softmax_with_cross_entropy(h @ lm_head, label)``
    without the [tokens, vocab] logits — vocab-chunked online
    log-sum-exp with a chunk-recomputing backward (ops/fused_loss.py).
    h: [..., D]; label: [...] or [..., 1] int. Creates (or reuses) the
    ``head_name`` parameter [D, vocab], so checkpoints see the ordinary
    lm_head weight."""
    helper = LayerHelper("fused_head_cross_entropy", name=name)
    d = int(h.shape[-1])
    head = helper.create_parameter(
        ParamAttr(name=head_name,
                  initializer=init_mod.Normal(0.0, 0.02)),
        [d, vocab_size], h.dtype)
    lead = list(h.shape[:-1])
    loss = helper.create_variable_for_type_inference(
        "float32", shape=lead + [1])
    helper.append_op(
        type="fused_head_cross_entropy",
        inputs={"X": [h.name], "W": [head.name], "Label": [label.name]},
        outputs={"Loss": [loss.name]},
        attrs={"chunk_size": chunk_size, "ignore_index": ignore_index})
    return loss


def _stack_params(helper, x_dtype, n_layers, n_heads, n_kv_heads, d, hd,
                  ffn_hidden, param_attr):
    """The layer-stacked decoder weights (leading [L] axis), named
    ``{helper.name}.{suffix}`` as the reference's, annotated
    ``P('pp', ...)`` (read once a mesh exists: ROADMAP.md item
    'Multi-device parallelism')."""
    base_attr = ParamAttr._to_attr(param_attr)

    def _p(suffix, shape, default_init):
        attr = copy.copy(base_attr) if base_attr else ParamAttr()
        attr.name = f"{helper.name}.{suffix}"
        if attr.initializer is None:
            attr.initializer = default_init
        w = helper.create_parameter(attr, shape, x_dtype)
        w.sharding = P(*(("pp",) + (None,) * (len(shape) - 1)))
        return w

    ninit = init_mod.Normal(0.0, 0.02)
    L = n_layers
    return {
        "AttnNorm": _p("attn_norm", [L, d], init_mod.Constant(1.0)),
        "Wq": _p("wq", [L, d, n_heads * hd], ninit),
        "Wk": _p("wk", [L, d, n_kv_heads * hd], ninit),
        "Wv": _p("wv", [L, d, n_kv_heads * hd], ninit),
        "Wo": _p("wo", [L, n_heads * hd, d], ninit),
        "MlpNorm": _p("mlp_norm", [L, d], init_mod.Constant(1.0)),
        "WGate": _p("w_gate", [L, d, ffn_hidden], ninit),
        "WUp": _p("w_up", [L, d, ffn_hidden], ninit),
        "WDown": _p("w_down", [L, ffn_hidden, d], ninit),
    }


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


def llama_decoder_stack(x, n_layers, n_heads, n_kv_heads, ffn_hidden,
                        rope_base=10000.0, epsilon=1e-6, n_micro=0,
                        remat=True, scan_unroll=1, param_attr=None,
                        name=None):
    """The full decoder-layer stack as one op with layer-stacked weights
    (leading [L] axis) — see ops/transformer_ops.py for the lowering.
    x: [batch, seq, dim]; returns [batch, seq, dim]. ``remat``
    recomputes each layer in the backward pass; ``n_micro`` and
    ``scan_unroll`` are kept on the op as the reference keeps them and
    change nothing on one device."""
    helper = LayerHelper("llama_decoder_stack", param_attr=param_attr,
                         name=name)
    d = int(x.shape[-1])
    hd = d // n_heads
    weights = _stack_params(helper, x.dtype, n_layers, n_heads,
                            n_kv_heads, d, hd, ffn_hidden, param_attr)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(
        type="llama_decoder_stack",
        inputs={"X": [x.name],
                **{slot: [w.name] for slot, w in weights.items()}},
        outputs={"Out": [out.name]},
        attrs={"n_heads": n_heads, "n_kv_heads": n_kv_heads,
               "rope_base": rope_base, "epsilon": epsilon,
               "n_micro": n_micro, "remat": remat,
               "scan_unroll": int(scan_unroll)})
    return out
