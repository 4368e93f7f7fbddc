"""The torch port's flash-attention module against the JAX package.

The port's plain version of K1 (``ref_attention_lse``) is held to the
reference's ``_ref_attention_lse`` and to the real Pallas forward kernel
run by the Pallas interpreter; the wrapper's CPU contract and the
kernel-build plumbing are checked here (the CUDA kernel itself is
held to the plain version on the card by test_torch_kernels_gpu.py and
chip_smoke.py).

Tolerance: f32 outputs and lse at rtol 2e-4 / atol 2e-5, the tier of
tests/test_attention.py for the Pallas kernel (summation order differs
between the packages).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.ops.pallas_attention as pa
from paddle_tpu_torch.ops import cuda_build
from paddle_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

F32_TOL = dict(rtol=2e-4, atol=2e-5)


def _qkv(seed, shape_q, shape_kv, scale=0.5):
    rng = np.random.RandomState(seed)
    q = (rng.randn(*shape_q) * scale).astype(np.float32)
    k = (rng.randn(*shape_kv) * scale).astype(np.float32)
    v = (rng.randn(*shape_kv) * scale).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("tq,tk", [(64, 64), (128, 256), (256, 128),
                                   (200, 200)])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_matches_reference(tq, tk, causal):
    """Equal and unequal lengths (bottom-right causal alignment, fully
    masked rows when tq > tk) and a ragged T."""
    q, k, v = _qkv(0, (2, 3, tq, 64), (2, 3, tk, 64))
    sc = 1.0 / np.sqrt(64)
    o_ref, lse_ref = pa._ref_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sc, causal)
    o, lse = fa.ref_attention_lse(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), sc, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_matches_pallas_kernel_interpreted(monkeypatch, causal):
    """The real Pallas K1 (``_fa_kernel``), run by the Pallas interpreter
    at a shape its gate admits, against the port's entry on CPU."""
    monkeypatch.setattr(pa, "_FORCE_INTERPRET", True)
    q, k, v = _qkv(3, (1, 2, 256, 128), (1, 2, 256, 128))
    o_ref, lse_ref = pa._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal, None)
    o, lse = fa.attention_with_lse(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **F32_TOL)
    o2 = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal)
    assert torch.equal(o2, o)


def test_bfloat16_plain_version_matches_reference():
    """bf16 inputs: both round scores and probabilities to bf16 at the
    same points; bf16 tier rtol/atol 2e-2."""
    q, k, v = _qkv(5, (1, 2, 128, 64), (1, 2, 128, 64))
    sc = 1.0 / np.sqrt(64)
    o_ref, lse_ref = pa._ref_attention_lse(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), sc, True)
    o, lse = fa.ref_attention_lse(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), sc,
        True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(o_ref.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref),
                               rtol=2e-2, atol=2e-2)


def test_zero_scale_means_unset():
    """``scale or 1/sqrt(d)``: 0.0 is treated as unset, as the
    reference does."""
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(7, (1, 2, 32, 16), (1, 2, 32, 16)))
    a, _ = fa.attention_with_lse(q, k, v, scale=0.0, causal=True)
    b, _ = fa.attention_with_lse(q, k, v, scale=None, causal=True)
    assert torch.equal(a, b)


def test_wrapper_uses_plain_version_only_for_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(8, (4, 96, 64), (4, 96, 64)))
    before = fa.flash_fwd.launches
    o, lse = fa.flash_fwd(q, k, v, 0.125, True)
    want_o, want_lse = fa.ref_attention_lse(q, k, v, 0.125, True)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    assert fa.flash_fwd.launches == before   # no kernel ran
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fa.flash_fwd(q.to("meta"), k.to("meta"), v.to("meta"), 0.125,
                     True)


@pytest.mark.parametrize("bad", ["rank", "kv_shape", "dtype", "head_dim"])
def test_wrapper_rejects_bad_inputs(bad):
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(9, (2, 16, 64), (2, 16, 64)))
    if bad == "rank":
        q = q[None]
    elif bad == "kv_shape":
        v = v[:, :8]
    elif bad == "dtype":
        k = k.double()
    else:
        q = q[..., :32]
    with pytest.raises(ValueError):
        fa.flash_fwd(q, k, v, 0.125, False)


def test_library_path_keys_on_sources():
    p = cuda_build.library_path("flash_fwd")
    assert p == cuda_build.library_path("flash_fwd")
    assert p.parent == cuda_build.BUILD_DIR
    assert p.name.startswith("libflash_fwd-") and p.suffix == ".so"
    for name in cuda_build.SOURCES:
        assert (cuda_build.CSRC / f"{name}.cu").exists()


def test_build_without_nvcc_raises(monkeypatch):
    """No silent skip: a machine without the CUDA toolkit cannot build
    the kernels and says so."""
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build()
