"""Head dims past 128 (256, 384: the reference's Pallas gate takes every
D % 128 == 0), the torch port against the JAX package on the CPU.

On a CUDA tensor such a head dim runs the port's tensor-core kernels in
128-column slices (csrc/mma_sm90.cuh ``HEAD_SLICE``), but at D = 256,
where K1, K2 and K3 on every dtype run warpgroup kernels of their own
(held to their plain versions on the card by
chip_smoke.py's ``head_dim_256`` cases and
tests/test_torch_kernels_gpu.py). Here the plain versions those kernels
are held to (``ref_attention_lse``, ``ref_flash_bwd_dq``,
``ref_flash_bwd_dkv``) are held to the reference's real Pallas kernels
K1, K2 and K3 run by the Pallas interpreter (``_FORCE_INTERPRET``, as
tests/test_attention.py runs them), at tq == tk where the Pallas
kernels' top-left causal mask agrees with ``_ref_attention_lse``'s
bottom-right one, and to ``_ref_attention_lse`` and its ``jax.vjp`` at
tq != tk. Tolerances: the reference's Pallas tiers (outputs and lse
rtol 2e-4 / atol 2e-5, gradients rtol 2e-3 / atol 2e-4).
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
T = 128            # the Pallas gate's least T


def _arrays(seed, bh, tq, tk, d):
    rng = np.random.RandomState(seed)
    q = (rng.randn(bh, tq, d) * 0.5).astype(np.float32)
    k = (rng.randn(bh, tk, d) * 0.5).astype(np.float32)
    v = (rng.randn(bh, tk, d) * 0.5).astype(np.float32)
    do = rng.randn(bh, tq, d).astype(np.float32)
    return q, k, v, do


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("d", [256, 384])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_pallas_kernel_interpreted(monkeypatch, d, causal):
    """K1's plain version, and the port's differentiable entry on the
    CPU, against the real Pallas ``_fa_kernel`` interpreted."""
    monkeypatch.setattr(pa, "_FORCE_INTERPRET", True)
    q, k, v, _ = _arrays(d + causal, 2, T, T, d)
    o_ref, lse_ref = pa._flash_fwd(*(jnp.asarray(a)[None] for a in (q, k, v)),
                                   causal, None)
    sc = 1.0 / np.sqrt(d)
    o, lse = fa.ref_attention_lse(*_t(q, k, v), sc, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref)[0], **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[0],
                               **F32_TOL)
    o2, lse2 = fa.attention_with_lse(*(x[None] for x in _t(q, k, v)),
                                     causal=causal)
    assert torch.equal(o2[0], o) and torch.equal(lse2[0], lse)


@pytest.mark.parametrize("d", [256, 384])
@pytest.mark.parametrize("causal", [False, True])
def test_backward_matches_pallas_kernels_interpreted(monkeypatch, d,
                                                     causal):
    """K2's and K3's plain versions (the CPU path of the wrappers), fed
    the Pallas forward's o and lse, against the real Pallas
    ``_fa_bwd_dq_kernel`` and ``_fa_bwd_dkv_kernel`` interpreted; and
    the port's autograd gradients against ``jax.vjp`` through the
    reference's custom_vjp (Pallas K1, K2, K3)."""
    monkeypatch.setattr(pa, "_FORCE_INTERPRET", True)
    q, k, v, do = _arrays(10 + d + causal, 2, T, T, d)
    sc = 1.0 / np.sqrt(d)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o, lse = pa._flash_fwd(jq[None], jk[None], jv[None], causal, None)
    o, lse = o[0], lse[0]
    lse_d = jnp.broadcast_to(lse[..., None], (2, T, d)).astype(jnp.float32)
    want = pa._flash_bwd_pallas(jq, jk, jv, o, lse_d, jdo, sc, causal)
    tq_, tk_, tv_, tdo = _t(q, k, v, do)
    to, tl = _t(np.array(o), np.array(lse))
    delta = (tdo * to).sum(-1)
    dq = fa.flash_bwd_dq(tq_, tk_, tv_, tdo, tl, delta, sc, causal)
    dk, dv = fa.flash_bwd_dkv(tq_, tk_, tv_, tdo, tl, delta, sc, causal)
    for g, w, name in zip((dq, dk, dv), want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=f"d{name} vs Pallas, D {d}")
    jgrads = jax.vjp(lambda a, b, c: pa.flash_attention(a, b, c, causal,
                                                        None),
                     jq[None], jk[None], jv[None])[1](jdo[None])
    ts = [torch.from_numpy(a)[None].requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(fa.flash_attention(*ts, causal), ts,
                              grad_outputs=torch.from_numpy(do)[None])
    for g, w, name in zip(got, jgrads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=f"autograd d{name}, D {d}")


@pytest.mark.parametrize("tq,tk", [(128, 256), (256, 128), (200, 200)])
@pytest.mark.parametrize("causal", [False, True])
def test_ragged_and_unequal_lengths_match_the_reference(tq, tk, causal):
    """At D 256, tq != tk (bottom-right causal, fully masked rows when
    tq > tk) and a ragged T: the plain versions against
    ``_ref_attention_lse`` and ``jax.vjp`` of it."""
    d = 256
    q, k, v, do = _arrays(tq + tk + causal, 2, tq, tk, d)
    sc = 1.0 / np.sqrt(d)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    (o_ref, lse_ref), vjp = jax.vjp(
        lambda a, b, c: pa._ref_attention_lse(a, b, c, sc, causal),
        jq, jk, jv)
    o, lse = fa.ref_attention_lse(*_t(q, k, v), sc, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **F32_TOL)
    want = vjp((jnp.asarray(do), jnp.zeros_like(lse_ref)))
    tdo = torch.from_numpy(do)
    delta = (tdo * o).sum(-1)
    dq = fa.flash_bwd_dq(*_t(q, k, v), tdo, lse, delta, sc, causal)
    dk, dv = fa.flash_bwd_dkv(*_t(q, k, v), tdo, lse, delta, sc, causal)
    for g, w, name in zip((dq, dk, dv), want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=f"d{name}")


def test_slices_are_the_d128_tiles():
    """The sliced head dims run the D = 128 instantiation of every
    mma.sync kernel (128-column slices on gridDim.z): the slice width is
    the kernels' widest tile, and every such launcher dispatches the
    multiples of it to its wide instantiation. K1, K2 and K3 at D = 256
    have warpgroup kernels of their own on every dtype, which take
    D = 256 whole and nothing else (K1, K2 and K3 on both routes at
    D = 128 too, which take D = 128 alone, and float32 K1, K2 and K3 at
    D = 64, which take D = 64 alone); D = 384 runs the mma.sync kernels
    that D = 64 runs on 16-bit inputs, and on float32 the ones that no
    other head dim runs."""
    assert fa.HEAD_SLICE == 128
    assert cuda_build.parse_constexprs(
        (cuda_build.CSRC / "mma_sm90.cuh").read_text())["HEAD_SLICE"] == 128
    whole = {lib for lib, _ in fa._WGMMA_ROUTES.values()}
    assert whole == {"flash_fwd_d256_wgmma", "flash_bwd_dq_d256_wgmma",
                     "flash_bwd_dkv_d256_wgmma", "flash_fwd_f32_d256_wgmma",
                     "flash_bwd_dq_f32_d256_wgmma",
                     "flash_bwd_dkv_f32_d256_wgmma", "flash_fwd_d128_wgmma",
                     "flash_bwd_dkv_d128_wgmma", "flash_bwd_dq_d128_wgmma",
                     "flash_bwd_dkv_f32_d64_wgmma",
                     "flash_bwd_dq_f32_d64_wgmma", "flash_fwd_f32_d64_wgmma",
                     "flash_fwd_f32_d128_wgmma",
                     "flash_bwd_dq_f32_d128_wgmma",
                     "flash_bwd_dkv_f32_d128_wgmma"}
    assert sorted(k for k in fa._WGMMA_ROUTES if k[2] == 256) == sorted(
        (w, route, 256)
        for w in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        for route in (fa.F32_ROUTE, fa.HALF_ROUTE))
    assert sorted(k for k in fa._WGMMA_ROUTES if k[2] != 256) == [
        ("flash_bwd_dkv", fa.F32_ROUTE, 64),
        ("flash_bwd_dkv", fa.F32_ROUTE, 128),
        ("flash_bwd_dkv", fa.HALF_ROUTE, 128),
        ("flash_bwd_dq", fa.F32_ROUTE, 64),
        ("flash_bwd_dq", fa.F32_ROUTE, 128),
        ("flash_bwd_dq", fa.HALF_ROUTE, 128),
        ("flash_fwd", fa.F32_ROUTE, 64),
        ("flash_fwd", fa.F32_ROUTE, 128),
        ("flash_fwd", fa.HALF_ROUTE, 128)]
    for w in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        for dt in (torch.float32, torch.bfloat16):
            assert fa.kernel_for(w, dt, 256) != fa.kernel_for(w, dt, 128)
            if dt == torch.float32:
                mma = fa._ROUTES[w][fa.F32_ROUTE]
                assert fa.kernel_for(w, dt, 384) == mma \
                    != fa.kernel_for(w, dt, 64)
                assert fa.kernel_for(w, dt, 128) != mma
            else:
                assert fa.kernel_for(w, dt, 384) == fa.kernel_for(w, dt, 64)
    for lib in whole:
        src = (cuda_build.CSRC / f"{lib}.cu").read_text()
        assert "d != D" in src and "gridDim.z" not in src, lib
    for lib in sorted(set(cuda_build.SOURCES) - whole):
        src = (cuda_build.CSRC / f"{lib}.cu").read_text()
        assert "d % HEAD_SLICE == 0" in src, lib
        assert "HEAD_SLICE, true>" in src, lib
        assert "gridDim.z" in src, lib
