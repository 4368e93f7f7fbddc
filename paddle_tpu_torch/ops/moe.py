"""Mixture-of-Experts helpers (port of ``paddle_tpu/ops/moe.py``): only
the activation quantization ``_act_quant``, the A half of W8A8 that the
generator's ``qmat`` and its int8 KV cache use. The MoE FFNs (top-k
gating, expert dispatch over a mesh 'ep' axis, the drop-free serving
forms and the ``moe_ffn`` op) come with ROADMAP.md item 'Multi-device
parallelism' and are refused by name.
"""
import torch

from ..waiting import MESH, module_getattr

__all__ = []

WAITING = dict.fromkeys(("top_k_gating", "moe_apply", "moe_apply_no_drop",
                         "moe_apply_no_drop_q"), MESH)
__getattr__ = module_getattr(__name__, WAITING)


def _act_quant(x):
    """Per-row dynamic activation quantization (absmax over the last,
    contracted axis): int8 values and a float32 scale [..., 1]. Both
    divisions are float32 divisions by a tensor (CUDA turns a division by
    a Python scalar into a product with its reciprocal, a bit apart) and
    the rounding is half to even, as the reference's ``jnp.round``, so
    equal inputs quantize bit for bit alike on either device."""
    xf = x.float()
    m = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8)
    s = m / torch.full_like(m, 127.0)
    return torch.round(xf / s).to(torch.int8), s
