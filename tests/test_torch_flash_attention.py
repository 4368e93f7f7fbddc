"""The torch port's flash-attention module against the JAX package.

The port's plain version of K1 (``ref_attention_lse``) is held to the
reference's ``_ref_attention_lse`` and to the real Pallas forward kernel
run by the Pallas interpreter; the plain versions of K2 and K3
(``ref_flash_bwd_dq`` / ``ref_flash_bwd_dkv``) and the gradients of
``flash_attention`` / ``attention_with_lse`` (the autograd.Function
around the kernels) are held to ``jax.vjp`` of ``_ref_attention_lse``
and to the real Pallas backward kernels run by the interpreter. The
wrappers' CPU contract and the kernel-build plumbing are checked here
(the CUDA kernels themselves are held to their plain versions on the
card by test_torch_kernels_gpu.py and chip_smoke.py).

Tolerance: f32 outputs and lse at rtol 2e-4 / atol 2e-5, gradients at
rtol 2e-3 / atol 2e-4 — the tiers of tests/test_attention.py for the
Pallas kernels (summation order differs between the packages).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.ops.pallas_attention as pa
from paddle_tpu_torch.ops import cuda_build
from paddle_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

F32_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


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
    p = cuda_build.library_path("flash_fwd_f32mma")
    assert p == cuda_build.library_path("flash_fwd_f32mma")
    assert p.parent == cuda_build.BUILD_DIR
    assert p.name.startswith("libflash_fwd_f32mma-") and p.suffix == ".so"
    assert set(cuda_build.SOURCES) == {
        "flash_fwd_f32mma", "flash_bwd_dq_f32mma", "flash_bwd_dkv_f32mma",
        "flash_fwd_mma", "flash_bwd_dq_mma", "flash_bwd_dkv_mma",
        "flash_fwd_d256_wgmma", "flash_bwd_dq_d256_wgmma",
        "flash_bwd_dkv_d256_wgmma", "flash_fwd_f32_d256_wgmma",
        "flash_bwd_dq_f32_d256_wgmma", "flash_bwd_dkv_f32_d256_wgmma",
        "flash_fwd_d128_wgmma", "flash_bwd_dkv_d128_wgmma",
        "flash_bwd_dq_d128_wgmma", "flash_bwd_dkv_f32_d64_wgmma",
        "flash_bwd_dq_f32_d64_wgmma", "flash_fwd_f32_d64_wgmma",
        "flash_fwd_f32_d128_wgmma", "flash_bwd_dq_f32_d128_wgmma",
        "flash_bwd_dkv_f32_d128_wgmma"}
    assert len(cuda_build.SOURCES) == 21
    for name in cuda_build.SOURCES:
        assert (cuda_build.CSRC / f"{name}.cu").exists()
    assert cuda_build.library_path("flash_bwd_dq_f32mma").name.startswith(
        "libflash_bwd_dq_f32mma-")


def test_build_without_nvcc_raises(monkeypatch):
    """No silent skip: a machine without the CUDA toolkit cannot build
    the kernels and says so."""
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build()


# ---------------------------------------------------------------------------
# backward: K2 (dQ) and K3 (dK, dV)
# ---------------------------------------------------------------------------


def _jax_vjp(q, k, v, do, dlse, scale, causal, dtype=jnp.float32):
    """jax.vjp of the reference's _ref_attention_lse at (do, dlse)."""
    f = lambda q, k, v: pa._ref_attention_lse(  # noqa: E731
        q, k, v, scale, causal)
    (o, lse), vjp = jax.vjp(f, *(jnp.asarray(a, dtype) for a in (q, k, v)))
    dlse = jnp.zeros_like(lse) if dlse is None else jnp.asarray(dlse)
    return vjp((jnp.asarray(do, dtype), dlse))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) \
        if isinstance(x, jax.Array) else x.detach().float().numpy()


BWD_CASES = [(64, 64), (128, 256), (256, 128), (200, 200)]


@pytest.mark.parametrize("tq,tk", BWD_CASES)
@pytest.mark.parametrize("causal", [False, True])
def test_backward_plain_versions_match_jax_vjp(tq, tk, causal):
    """K2's and K3's plain versions, fed the forward's lse and
    delta = rowsum(dO * O), against jax.vjp of _ref_attention_lse: equal
    and unequal lengths, a ragged T, and fully masked rows (causal with
    tq > tk: P = 1/tk, dS = 0)."""
    q, k, v = _qkv(20, (2, 3, tq, 64), (2, 3, tk, 64))
    do = np.random.RandomState(21).randn(2, 3, tq, 64).astype(np.float32)
    sc = 1.0 / np.sqrt(64)
    want = _jax_vjp(q, k, v, do, None, sc, causal)
    tq_, tk_, tv_, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = fa.ref_attention_lse(tq_, tk_, tv_, sc, causal)
    delta = (tdo * o).sum(-1)
    dq = fa.ref_flash_bwd_dq(tq_, tk_, tv_, tdo, lse, delta, sc, causal)
    dk, dv = fa.ref_flash_bwd_dkv(tq_, tk_, tv_, tdo, lse, delta, sc,
                                  causal)
    for got, w, name in zip((dq, dk, dv), want, "qkv"):
        np.testing.assert_allclose(_np(got), _np(w), **GRAD_TOL,
                                   err_msg=f"d{name}")
    if causal and tq > tk:
        # the fully masked rows: no dQ, and dV holds their dO averaged
        n = tq - tk
        assert float(dq[..., :n, :].abs().max()) == 0.0
        assert abs(float(lse[..., :n].max()) - fa.NEG_INF) < 1e24


@pytest.mark.parametrize("tq,tk", BWD_CASES)
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_gradients_match_jax_vjp(tq, tk, causal):
    """flash_attention's gradients on the CPU (the autograd.Function,
    running K2's and K3's plain versions) against jax.vjp."""
    q, k, v = _qkv(22, (1, 2, tq, 64), (1, 2, tk, 64))
    do = np.random.RandomState(23).randn(1, 2, tq, 64).astype(np.float32)
    sc = 1.0 / np.sqrt(64)
    want = _jax_vjp(q, k, v, do, None, sc, causal)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = fa.flash_attention(*ts, causal)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, ts, grad_outputs=torch.from_numpy(do))
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(_np(g), _np(w), **GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("tq,tk,causal", [(128, 128, True),
                                          (256, 128, True),
                                          (200, 200, False)])
def test_attention_with_lse_differentiable_in_both_outputs(tq, tk, causal):
    """Cotangents on o AND lse (ring attention trains through the lse):
    the lse term enters the kernels as delta = rowsum(dO * O) - dlse."""
    q, k, v = _qkv(24, (1, 2, tq, 64), (1, 2, tk, 64))
    r = np.random.RandomState(25)
    do = r.randn(1, 2, tq, 64).astype(np.float32)
    dlse = r.randn(1, 2, tq).astype(np.float32)
    sc = 1.0 / np.sqrt(64)
    want = _jax_vjp(q, k, v, do, dlse, sc, causal)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o, lse = fa.attention_with_lse(*ts, causal=causal)
    assert lse.grad_fn is not None
    loss = (o * torch.from_numpy(do)).sum() \
        + (lse * torch.from_numpy(dlse)).sum()
    got = torch.autograd.grad(loss, ts)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(_np(g), _np(w), **GRAD_TOL,
                                   err_msg=f"d{name}")
    # the lse alone: no cotangent reaches o
    want_l = _jax_vjp(q, k, v, np.zeros_like(do), dlse, sc, causal)
    o, lse = fa.attention_with_lse(*ts, causal=causal)
    got_l = torch.autograd.grad((lse * torch.from_numpy(dlse)).sum(), ts)
    for g, w, name in zip(got_l, want_l, "qkv"):
        np.testing.assert_allclose(_np(g), _np(w), **GRAD_TOL,
                                   err_msg=f"lse-only d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_backward_matches_pallas_kernels_interpreted(monkeypatch, causal):
    """The real Pallas K2 and K3 (``_fa_bwd_dq_kernel``,
    ``_fa_bwd_dkv_kernel``), run by the Pallas interpreter at a shape
    their gate admits (as tests/test_attention.py does), against the
    port's K2/K3 wrappers on the CPU fed the same o and lse, and against
    the port's autograd gradients."""
    monkeypatch.setattr(pa, "_FORCE_INTERPRET", True)
    q, k, v = _qkv(26, (1, 2, 256, 128), (1, 2, 256, 128))
    do = np.random.RandomState(27).randn(1, 2, 256, 128).astype(np.float32)
    sc = 1.0 / np.sqrt(128)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o, lse = pa._flash_fwd(jq, jk, jv, causal, None)
    fold = lambda a: a.reshape(2, 256, 128)  # noqa: E731
    lse128 = jnp.broadcast_to(lse.reshape(2, 256)[..., None],
                              (2, 256, 128)).astype(jnp.float32)
    want = pa._flash_bwd_pallas(fold(jq), fold(jk), fold(jv), fold(o),
                                lse128, fold(jdo), sc, causal)
    tq_, tk_, tv_, tdo = (torch.from_numpy(a).reshape(2, 256, 128)
                          for a in (q, k, v, do))
    to = torch.from_numpy(np.array(o)).reshape(2, 256, 128)
    tl = torch.from_numpy(np.array(lse)).reshape(2, 256)
    delta = (tdo * to).sum(-1)
    dq = fa.flash_bwd_dq(tq_, tk_, tv_, tdo, tl, delta, sc, causal)
    dk, dv = fa.flash_bwd_dkv(tq_, tk_, tv_, tdo, tl, delta, sc, causal)
    for g, w, name in zip((dq, dk, dv), want, "qkv"):
        np.testing.assert_allclose(_np(g), _np(w), **GRAD_TOL,
                                   err_msg=f"d{name} vs Pallas")
    # the whole differentiable entry: jax.grad through the custom_vjp
    # (Pallas K1, K2, K3) against torch.autograd through the port's
    jgrads = jax.vjp(lambda a, b, c: pa.flash_attention(a, b, c, causal,
                                                        None),
                     jq, jk, jv)[1](jdo)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(fa.flash_attention(*ts, causal), ts,
                              grad_outputs=torch.from_numpy(do))
    for g, w, name in zip(got, jgrads, "qkv"):
        np.testing.assert_allclose(_np(g), _np(w), **GRAD_TOL,
                                   err_msg=f"autograd d{name} vs Pallas")


@pytest.mark.parametrize("causal", [False, True])
def test_bfloat16_gradients_match_reference(causal):
    """bf16 inputs: the reference's vjp rounds scores, probabilities and
    products to bf16, the plain versions (like the kernels) keep them in
    float32 and round only the outputs; bf16 tier rtol 2e-2 / atol
    1e-2."""
    q, k, v = _qkv(28, (1, 2, 128, 64), (1, 2, 128, 64))
    do = np.random.RandomState(29).randn(1, 2, 128, 64).astype(np.float32)
    sc = 1.0 / np.sqrt(64)
    want = _jax_vjp(q, k, v, do, None, sc, causal, dtype=jnp.bfloat16)
    ts = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v)]
    o = fa.flash_attention(*ts, causal, sc)
    got = torch.autograd.grad(o, ts,
                              grad_outputs=torch.from_numpy(do).bfloat16())
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(g), _np(w), rtol=2e-2, atol=1e-2,
                                   err_msg=f"d{name}")


def test_backward_wrappers_use_plain_versions_only_for_cpu_tensors(
        monkeypatch):
    """On CPU tensors K2's and K3's wrappers run their plain versions
    and count no launch; a tensor on another device is refused. A
    backward through flash_attention calls each wrapper once."""
    q, k, v, do = (torch.from_numpy(a) for a in
                   _qkv(30, (4, 96, 64), (4, 96, 64)) + (
                       np.random.RandomState(31).randn(4, 96, 64)
                       .astype(np.float32),))
    o, lse = fa.ref_attention_lse(q, k, v, 0.125, True)
    delta = (do * o).sum(-1)
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, 0.125, True)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, 0.125, True)
    assert torch.equal(dq, fa.ref_flash_bwd_dq(q, k, v, do, lse, delta,
                                               0.125, True))
    want_k, want_v = fa.ref_flash_bwd_dkv(q, k, v, do, lse, delta, 0.125,
                                          True)
    assert torch.equal(dk, want_k) and torch.equal(dv, want_v)
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == before
    meta = [x.to("meta") for x in (q, k, v, do, lse, delta)]
    for wrapper in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            wrapper(*meta, 0.125, True)
    with pytest.raises(ValueError, match="does not match q"):
        fa.flash_bwd_dq(q, k, v, do[:, :8], lse, delta, 0.125, True)

    calls = []
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        real = getattr(fa, name)
        monkeypatch.setattr(
            fa, name, lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    ts = [x.reshape(1, 4, 96, 64).clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*ts, True)
    out.sum().backward()
    assert calls == ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"]
    assert all(t.grad is not None for t in ts)
