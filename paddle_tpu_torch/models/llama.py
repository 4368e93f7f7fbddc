"""Llama-3-style decoder-only LLM (port of ``paddle_tpu/models/llama.py``).

The port builds the unrolled decoder — embedding → [rms_norm → GQA
attention with rope on the flash kernels → rms_norm → SwiGLU MLP] × L →
rms_norm → lm_head, and with ``targets`` the unfused loss
softmax_with_cross_entropy → mean — with the same layer calls, so the
port's program has the reference's op types and parameter names one for
one. MoE, the layer-stacked pipeline (``shard_pp``), the vocab-chunked
fused head (``fused_head_chunk``), sharded variants and generation
arrive with later slices (ROADMAP.md) and are refused by name.
"""
from dataclasses import dataclass

from .. import layers
from ..layers import transformer as tfl
from ..param_attr import ParamAttr
from .. import initializer as init_mod
from ..sharding import PartitionSpec as P

__all__ = ["LlamaConfig", "LLAMA3_8B", "LLAMA_TINY", "build_llama"]


@dataclass
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_hidden: int = 14336
    rope_base: float = 500000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # MoE: >0 turns every FFN into a mixture of this many SwiGLU experts
    # in the reference; the port refuses it until MoE is ported
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01


LLAMA3_8B = LlamaConfig()
LLAMA_TINY = LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, ffn_hidden=128, dtype="float32")


def _linear(x, out_dim, name):
    return layers.fc(x, size=out_dim, num_flatten_dims=2, bias_attr=False,
                     param_attr=ParamAttr(
                         name=name,
                         initializer=init_mod.Normal(0.0, 0.02)))


def build_llama(cfg, tokens, targets=None, shard_tp=False, shard_sp=False,
                shard_dp=False, shard_pp=False, pp_n_micro=0,
                pp_schedule="gpipe", fused_head_chunk=0, scan_unroll=1,
                remat=True):
    """Builds the forward (and loss if ``targets``) graph, as the
    reference does. tokens (and targets): int data vars [batch, seq].
    Returns (logits, avg_loss|None). ``scan_unroll`` and ``remat`` only
    shape the reference's ``shard_pp`` layer scan; the other knobs are
    refused until their slice is ported."""
    if pp_schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pp_schedule {pp_schedule!r}")
    if shard_pp or pp_schedule != "gpipe":
        raise NotImplementedError(
            "shard_pp / pp_schedule (the layer-stacked decoder, "
            "llama_decoder_stack) is a later slice of the torch port "
            "(ROADMAP.md items 'Training' and 'Multi-device parallelism')")
    if fused_head_chunk:
        raise NotImplementedError(
            "fused_head_chunk (the vocab-chunked fused_head_cross_entropy) "
            "is a later slice of the torch port (ROADMAP.md item "
            "'Training')")
    if shard_tp or shard_sp or shard_dp:
        raise NotImplementedError(
            "shard_tp / shard_sp / shard_dp need a device mesh, a later "
            "slice of the torch port (ROADMAP.md item 'Multi-device "
            "parallelism')")
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "MoE FFNs are a later slice of the torch port (ROADMAP.md "
            "item 'Multi-device parallelism')")
    dt = cfg.dtype
    hd = cfg.dim // cfg.n_heads
    h = layers.embedding(tokens, size=[cfg.vocab_size, cfg.dim],
                         param_attr=ParamAttr(
                             name="tok_emb",
                             initializer=init_mod.Normal(0.0, 0.02)),
                         dtype=dt)
    for i in range(cfg.n_layers):
        pre = tfl.rms_norm(h, epsilon=cfg.norm_eps,
                           param_attr=ParamAttr(name=f"l{i}.attn_norm"))
        q = _linear(pre, cfg.n_heads * hd, f"l{i}.wq")
        k = _linear(pre, cfg.n_kv_heads * hd, f"l{i}.wk")
        v = _linear(pre, cfg.n_kv_heads * hd, f"l{i}.wv")
        q = layers.reshape(q, [0, 0, cfg.n_heads, hd])
        k = layers.reshape(k, [0, 0, cfg.n_kv_heads, hd])
        v = layers.reshape(v, [0, 0, cfg.n_kv_heads, hd])
        q = tfl.rope(q, base=cfg.rope_base)
        k = tfl.rope(k, base=cfg.rope_base)
        attn = tfl.multihead_attention(q, k, v, causal=True)
        attn = layers.reshape(attn, [0, 0, cfg.n_heads * hd])
        o = _linear(attn, cfg.dim, f"l{i}.wo")
        h = layers.elementwise_add(h, o)

        pre2 = tfl.rms_norm(h, epsilon=cfg.norm_eps,
                            param_attr=ParamAttr(name=f"l{i}.mlp_norm"))
        gate = tfl.silu(_linear(pre2, cfg.ffn_hidden, f"l{i}.w_gate"))
        up = _linear(pre2, cfg.ffn_hidden, f"l{i}.w_up")
        mlp = _linear(layers.elementwise_mul(gate, up), cfg.dim,
                      f"l{i}.w_down")
        h = layers.elementwise_add(h, mlp)

    h = tfl.rms_norm(h, epsilon=cfg.norm_eps,
                     param_attr=ParamAttr(name="final_norm"))
    logits = _linear(h, cfg.vocab_size, "lm_head")
    tokens.sharding = P(None, None)
    avg_loss = None
    if targets is not None:
        targets.sharding = P(None, None)
        loss = layers.softmax_with_cross_entropy(logits, targets)
        avg_loss = layers.mean(loss)
    return logits, avg_loss
