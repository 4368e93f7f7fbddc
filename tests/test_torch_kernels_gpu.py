"""The port's CUDA kernels against their plain torch versions, on the
card. Imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit::

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu

(``--noconftest``: the suite's conftest imports jax). Without CUDA every
test skips. Tolerance: f32 rtol 2e-4 / atol 2e-5 (TF32 off); bf16 2e-2.
Gradients through the autograd.Function (K1, K2, K3 on the card)
against the plain versions on the CPU: rtol 2e-3 / atol 2e-4.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

F32_TOL = dict(rtol=2e-4, atol=2e-5)


def _qkv(seed, shape_q, shape_kv, scale=0.5):
    rng = np.random.RandomState(seed)
    return tuple((rng.randn(*s) * scale).astype(np.float32)
                 for s in (shape_q, shape_kv, shape_kv))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    tol = F32_TOL if dt == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    q, k, v = (torch.from_numpy(a).cuda().to(dt) for a in
               _qkv(11, (8, 200, 128), (8, 200, 128)))
    before = fa.flash_fwd.launches
    o, lse = fa.flash_fwd(q, k, v, 1 / np.sqrt(128), True)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == before + 1
    want_o, want_lse = fa.ref_attention_lse(q, k, v, 1 / np.sqrt(128), True)
    torch.testing.assert_close(o.float(), want_o.float(), **tol)
    torch.testing.assert_close(lse, want_lse, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_kernels_match_plain_versions(dtype):
    """K2 (dQ) and K3 (dK, dV), each on its own, at T = 200 causal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    tol = F32_TOL if dt == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    sc = 1 / np.sqrt(128)
    q, k, v = (torch.from_numpy(a).cuda().to(dt) for a in
               _qkv(12, (8, 200, 128), (8, 200, 128)))
    do = torch.from_numpy(np.random.RandomState(13).randn(8, 200, 128)
                          .astype(np.float32)).cuda().to(dt)
    o, lse = fa.flash_fwd(q, k, v, sc, True)
    delta = (do.float() * o.float()).sum(-1)
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, sc, True)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, sc, True)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == \
        (before[0] + 1, before[1] + 1)
    want_q = fa.ref_flash_bwd_dq(q, k, v, do, lse, delta, sc, True)
    want_k, want_v = fa.ref_flash_bwd_dkv(q, k, v, do, lse, delta, sc, True)
    for got, want in ((dq, want_q), (dk, want_k), (dv, want_v)):
        assert got.dtype == dt
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
def test_attention_gradients_on_the_card_match_the_cpu():
    """flash_attention and attention_with_lse (o and lse) keep their
    gradient on CUDA tensors: autograd through K1/K2/K3 against the same
    autograd on the CPU (the plain versions), float32, GQA-free."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    r = np.random.RandomState(14)
    arrs = [(r.randn(2, 4, 256, 128) * 0.5).astype(np.float32)
            for _ in range(3)]
    do = r.randn(2, 4, 256, 128).astype(np.float32)
    dl = r.randn(2, 4, 256).astype(np.float32)
    grads = {}
    for dev in ("cuda", "cpu"):
        ts = [torch.from_numpy(a).to(dev).requires_grad_() for a in arrs]
        o, lse = fa.attention_with_lse(*ts, causal=True)
        loss = (o * torch.from_numpy(do).to(dev)).sum() \
            + (lse * torch.from_numpy(dl).to(dev)).sum()
        grads[dev] = [g.cpu() for g in torch.autograd.grad(loss, ts)]
    for g, w in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(g, w, rtol=2e-3, atol=2e-4)
