"""Flash attention forward (port of ``paddle_tpu/ops/pallas_attention.py``).

K1, the reference's Pallas forward kernel ``_fa_kernel``, is the CUDA
kernel ``csrc/flash_fwd.cu`` here. :func:`flash_fwd` is its wrapper: on a
CUDA tensor it launches the kernel (or raises — there is no fallback),
on a CPU tensor it runs :func:`ref_attention_lse`, the plain torch copy
of the reference's ``_ref_attention_lse`` that the kernel is held to.

The kernel follows ``_ref_attention_lse``'s semantics, not the Pallas
kernel's quirks: causal masking is bottom-right aligned
(``row + tk - tq >= col``; the Pallas kernel masks top-left, which agrees
only when tq == tk) and keys past tk never enter the softmax (the Pallas
kernel has no key-bounds mask for a ragged tail).

Forward only: the differentiable entry with the backward kernels K2/K3
(``torch.autograd.Function``) comes with training.
"""
import ctypes
import math

import torch

from . import cuda_build

__all__ = ["flash_attention", "attention_with_lse", "flash_fwd",
           "ref_attention_lse", "NEG_INF"]

NEG_INF = -1e30

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128)


def ref_attention_lse(q, k, v, scale, causal, bias=None):
    """[..., T, D] attention returning (out, lse) — the plain version of
    K1, a torch copy of the reference's ``_ref_attention_lse``."""
    s = torch.einsum("...qd,...kd->...qk", q, k).float() * scale
    if bias is not None:
        s = s + bias
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        rows = torch.arange(tq, device=s.device)[:, None]
        cols = torch.arange(tk, device=s.device)[None, :]
        s = s.masked_fill(rows + (tk - tq) < cols, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("...qk,...kd->...qd", (p / l).to(v.dtype), v)
    lse = (m + torch.log(l))[..., 0]
    return o, lse


def _kernel():
    fn = cuda_build.load("flash_fwd").flash_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        # q, k, v, o, lse; bh, tq, tk, d, dtype; scale, causal, stream
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def flash_fwd(q, k, v, scale, causal):
    """K1's wrapper. q: [BH, tq, D]; k, v: [BH, tk, D], contiguous, one
    dtype, one device. Returns (o [BH, tq, D] in q's dtype,
    lse [BH, tq] float32). ``flash_fwd.launches`` counts kernel
    launches."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"flash_fwd takes [BH, T, D] tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, tq, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v devices differ: {q.device}, {k.device}, "
                         f"{v.device}")
    if q.device.type == "cpu":
        return ref_attention_lse(q, k, v, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_fwd kernel takes float32, bfloat16 or "
                         f"float16, got {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel takes head dims {_HEAD_DIMS}, "
                         f"got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd needs contiguous q, k, v")
    kernel = _kernel()
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    o.data_ptr(), lse.data_ptr(), bh, tq, k.shape[1], d,
                    _DTYPE_CODE[q.dtype], float(scale), int(bool(causal)),
                    stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{rc} (bh={bh}, tq={tq}, tk={k.shape[1]}, "
                           f"d={d}, dtype={q.dtype})")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def _flash_fwd(q, k, v, causal, scale):
    """[B, H, T, D] → (o [B, H, tq, D], lse [B, H, tq]) through K1.
    ``scale`` 0 or None means 1/sqrt(D), as in the reference."""
    sc = scale or (1.0 / math.sqrt(q.shape[-1]))
    b, h, t, d = q.shape
    o, lse = flash_fwd(q.reshape(b * h, t, d).contiguous(),
                       k.reshape(b * h, k.shape[2], d).contiguous(),
                       v.reshape(b * h, v.shape[2], d).contiguous(),
                       sc, causal)
    return o.reshape(q.shape), lse.reshape(b, h, t)


def attention_with_lse(q, k, v, scale=None, causal=False):
    """Attention that also returns log-sum-exp — the building block
    ring attention merges partial results with. q,k,v: [B, H, T, D]."""
    return _flash_fwd(q, k, v, causal, scale)


def flash_attention(q, k, v, causal=True, scale=None):
    """q,k,v: [B, H, T, D] → [B, H, T, D] (forward only)."""
    o, _ = _flash_fwd(q, k, v, causal, scale)
    return o
