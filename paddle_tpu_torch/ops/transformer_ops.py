"""Transformer-family op lowering rules (port of
``paddle_tpu/ops/transformer_ops.py``): RMSNorm, rotary embeddings,
multi-head attention on the flash kernel, SiLU, and the layer-stacked
decoder ``llama_decoder_stack``.

rms_norm, rope and silu are plain torch: XLA fused them in the
reference and no Pallas kernel exists for them. Attention goes through
K1 forward and K2/K3 backward (ops/flash_attention.py).
"""
import torch
from torch.utils import checkpoint as _ckpt

from ..core.registry import register_op
from .flash_attention import flash_attention


def rms_normalize(x, scale=None, eps=1e-6):
    """float32-accumulated RMS norm, output in x.dtype."""
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if scale is not None:
        y = y * scale.float()
    return y.to(dt)


@register_op("rms_norm")
def _rms_norm(ctx, ins, attrs):
    scale = ins["Scale"][0] if ins.get("Scale") else None
    return {"Y": [rms_normalize(ins["X"][0], scale,
                                attrs.get("epsilon", 1e-6))]}


def apply_rope_at(x, positions, base=10000.0):
    """x: [B, T, H, D]; positions: [T] absolute positions shared by the
    batch, or [B, T] per-row positions. Rotates feature pairs
    (d, d + D/2) (neox style) in float32."""
    d = x.shape[-1]
    inv = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d))
    freqs = positions.float()[..., None] * inv            # [(B,)T, D/2]
    if freqs.dim() == 2:
        cos = torch.cos(freqs)[None, :, None, :]
        sin = torch.sin(freqs)[None, :, None, :]
    else:
        cos = torch.cos(freqs)[:, :, None, :]
        sin = torch.sin(freqs)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, base=10000.0, position_offset=0):
    """x: [B, T, H, D] at positions offset..offset+T."""
    t = x.shape[1]
    return apply_rope_at(
        x, position_offset + torch.arange(t, device=x.device), base)


@register_op("rope")
def _rope(ctx, ins, attrs):
    return {"Out": [apply_rope(ins["X"][0], attrs.get("base", 10000.0))]}


def attention_core(q, k, v, causal=True, scale=None):
    """GQA-aware attention on [B, T, H, D] tensors: repeats each kv head
    for its group of q heads (``repeat_interleave``, as the reference's
    ``jnp.repeat`` on the head axis), moves heads next to batch and runs
    the flash kernel. The reference's ring-attention branch needs a
    device mesh, which the port does not have yet (ROADMAP.md item
    'Multi-device parallelism')."""
    if k.shape[2] != q.shape[2]:  # GQA repeat kv heads
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    ot = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal, scale)
    return ot.transpose(1, 2)


@register_op("multihead_attention")
def _mha(ctx, ins, attrs):
    """Q,K,V: [B, T, H, D] (K/V may have fewer heads — GQA)."""
    return {"Out": [attention_core(ins["Q"][0], ins["K"][0], ins["V"][0],
                                   attrs.get("causal", True),
                                   attrs.get("scale"))]}


@register_op("silu")
def _silu(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x * torch.sigmoid(x)]}


_STACK_SLOTS = ("AttnNorm", "Wq", "Wk", "Wv", "Wo",
                "MlpNorm", "WGate", "WUp", "WDown")


def _reject_quant_scales(ins, op_name):
    """The training-side stack ops never take int8 ``<Slot>Scale``
    companions: a rounded activation has zero gradient, so training
    through it would silently give zero gradients (as the reference's
    ``_reject_quant_scales``)."""
    scales = sorted(k for k in ins if k.endswith("Scale"))
    if scales:
        raise ValueError(
            f"{op_name} got int8 quantization scale inputs {scales}; "
            "the W8A8 path is serving-only (rounding has zero gradient "
            "— training through it would silently produce zero "
            "gradients). Train in bf16/f32 and quantize the trained "
            "scope.")


def decoder_block(p, h, *, n_heads, n_kv, base, eps, pos, attend_fn):
    """One Llama decoder block over one layer's weights ``p`` (the
    ``_STACK_SLOTS``) — the single copy of the block math: rms_norm →
    roped QKV at ``pos`` → ``attend_fn`` → residual → rms_norm → SwiGLU
    → residual. ``attend_fn(q, k, v) -> [b, t, n_heads*hd]`` gets the
    roped q/k and raw v ([b, t, heads, hd]). The products are plain
    ``x @ w``: the reference's int8 ``qmat`` is serving-only and its MoE
    branch a later slice (ROADMAP.md items 'Generation and the paged
    decode engine' and 'Multi-device parallelism')."""
    b, t, _ = h.shape
    hd = p["Wq"].shape[-1] // n_heads
    pre = rms_normalize(h, p["AttnNorm"], eps)
    q = apply_rope_at((pre @ p["Wq"]).reshape(b, t, n_heads, hd), pos,
                      base)
    k = apply_rope_at((pre @ p["Wk"]).reshape(b, t, n_kv, hd), pos, base)
    v = (pre @ p["Wv"]).reshape(b, t, n_kv, hd)
    h = h + attend_fn(q, k, v) @ p["Wo"]
    pre2 = rms_normalize(h, p["MlpNorm"], eps)
    g = pre2 @ p["WGate"]
    u = pre2 @ p["WUp"]
    return h + ((g * torch.sigmoid(g)) * u) @ p["WDown"]


def make_flash_block(n_heads, n_kv, base, eps, remat=True):
    """The training-side decoder block (flash attention, causal). With
    ``remat`` the block runs under non-reentrant
    ``torch.utils.checkpoint`` where autograd records it: only its
    input is kept, and the backward recomputes the block — K1 included —
    before K2 and K3 run (the reference's ``jax.checkpoint``)."""
    def block(p, h):
        b, t, _ = h.shape

        def attend(q, k, v):
            return attention_core(q, k, v, causal=True).reshape(b, t, -1)

        return decoder_block(p, h, n_heads=n_heads, n_kv=n_kv, base=base,
                             eps=eps, pos=torch.arange(t, device=h.device),
                             attend_fn=attend)

    if not remat:
        return block

    def remat_block(p, h):
        if not torch.is_grad_enabled():
            return block(p, h)     # nothing to save: no checkpoint
        return _ckpt.checkpoint(block, p, h, use_reentrant=False)

    return remat_block


@register_op("llama_decoder_stack")
def _llama_decoder_stack(ctx, ins, attrs):
    """The whole decoder-layer stack as one op with layer-stacked
    weights (leading [L] axis): [rms_norm → GQA attention (rope, flash
    kernels) → rms_norm → SwiGLU] × L, as a Python loop over the layer
    axis — the reference's single-device branch (its ``lax.scan``).

    On one device ``scan_unroll`` and ``n_micro`` change nothing, as in
    the reference's ``pp <= 1`` branch: there is no scan to unroll, and
    microbatches only shape the pipeline schedule of a mesh with a 'pp'
    axis, which the port does not have yet (ROADMAP.md item
    'Multi-device parallelism'). Each layer's weights are ``unbind``
    views of the stacks, so the backward writes each stack's gradient
    once."""
    x = ins["X"][0]                                     # [B, T, D]
    _reject_quant_scales(ins, "llama_decoder_stack")
    n_heads = attrs["n_heads"]
    blk = make_flash_block(n_heads, attrs.get("n_kv_heads", n_heads),
                           attrs.get("rope_base", 10000.0),
                           attrs.get("epsilon", 1e-6),
                           attrs.get("remat", True))
    layers = {s: ins[s][0].unbind(0) for s in _STACK_SLOTS}
    h = x
    for i in range(len(layers["Wq"])):
        h = blk({s: w[i] for s, w in layers.items()}, h)
    return {"Out": [h]}
