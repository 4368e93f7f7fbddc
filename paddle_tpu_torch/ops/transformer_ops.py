"""Transformer-family op lowering rules (port of
``paddle_tpu/ops/transformer_ops.py``): RMSNorm, rotary embeddings,
multi-head attention on the flash kernel, SiLU.

rms_norm, rope and silu are plain torch: XLA fused them in the
reference and no Pallas kernel exists for them. Attention goes through
K1 (ops/flash_attention.py).
"""
import torch

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
