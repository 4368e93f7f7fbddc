"""The port's CUDA kernels against their plain torch versions, on the
card. Imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit::

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu

(``--noconftest``: the suite's conftest imports jax). Without CUDA every
test skips. Tolerance: f32 rtol 2e-4 / atol 2e-5 (TF32 off); bf16 2e-2.
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
