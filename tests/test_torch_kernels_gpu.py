"""The port's CUDA kernels against their plain torch versions, on the
card. Imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit::

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu

(``--noconftest``: the suite's conftest imports jax). Without CUDA every
test skips. Tolerance: f32 rtol 2e-4 / atol 2e-5 (TF32 off); bf16 2e-2.
Gradients through the autograd.Function (K1, K2, K3 on the card)
against the plain versions on the CPU: rtol 2e-3 / atol 2e-4.

The tensor-core kernels (bf16 and fp16: ``flash_fwd_mma``,
``flash_bwd_dq_mma``, ``flash_bwd_dkv_mma``, at head dim 256 the
warpgroup kernels ``flash_fwd_d256_wgmma``, ``flash_bwd_dq_d256_wgmma``
and ``flash_bwd_dkv_d256_wgmma``, and at head dim 128 the warpgroup
kernels ``flash_fwd_d128_wgmma``, ``flash_bwd_dq_d128_wgmma`` and
``flash_bwd_dkv_d128_wgmma``) are held to chip_smoke.py's 16-bit
tier: rtol 1e-2 (one rounding of the output) plus atol 1e-2 x the plain
output's RMS, against the plain version evaluated in float32 on the same
inputs and rounded once to the output's type. The float32 kernels
(``flash_fwd_f32mma``, ``flash_bwd_dq_f32mma``, ``flash_bwd_dkv_f32mma``,
at head dim 256 the warpgroup kernels ``flash_fwd_f32_d256_wgmma``,
``flash_bwd_dq_f32_d256_wgmma`` and ``flash_bwd_dkv_f32_d256_wgmma``,
at head dim 128 ``flash_fwd_f32_d128_wgmma``,
``flash_bwd_dq_f32_d128_wgmma`` and ``flash_bwd_dkv_f32_d128_wgmma``,
and at head dim 64
``flash_fwd_f32_d64_wgmma``, ``flash_bwd_dq_f32_d64_wgmma`` and
``flash_bwd_dkv_f32_d64_wgmma``: tensor cores with
every operand split into bf16 or TF32 pieces) are held to the f32 tier.
"""
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu_torch as fluid
from paddle_tpu_torch.ops import cuda_build
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


HALF_RTOL, HALF_RMS = 1e-2, 1e-2

# (tq, tk, d, causal): ragged T, tq < tk, tq > tk (fully masked rows),
# head dims 64 and 128, 256 (the warpgroup K1, K2 and K3 on every
# dtype) and the sliced 384, causal and not
MMA_CASES = [(200, 200, 128, True), (200, 200, 128, False),
             (128, 256, 128, True), (256, 128, 128, True),
             (256, 256, 64, True), (256, 256, 64, False),
             (256, 256, 128, False), (256, 256, 256, True),
             (200, 200, 256, False), (128, 256, 256, True),
             (256, 128, 384, True)]


def _half_tier_ratio(got, want):
    """Worst |got - want| / (rtol |want| + atol) in the 16-bit tier;
    ``want`` is the plain version evaluated in float32."""
    wf = want.float()
    atol = HALF_RMS * float(wf.square().mean().sqrt())
    return float(((got.float() - wf).abs()
                  / (atol + HALF_RTOL * wf.abs())).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("tq,tk,d,causal", MMA_CASES)
def test_mma_kernels_match_plain_versions(dtype, tq, tk, d, causal):
    """K1, K2 and K3 on the tensor cores (float32: the split-operand
    kernels), each output against its plain version in the tier of its
    type, with the variant that launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    sc = 1 / np.sqrt(d)
    q, k, v = (torch.from_numpy(a).cuda().to(dt) for a in
               _qkv(21, (8, tq, d), (8, tk, d)))
    do = torch.from_numpy(np.random.RandomState(22).randn(8, tq, d)
                          .astype(np.float32)).cuda().to(dt)
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, sc, causal)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, sc, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, sc, causal)
    torch.cuda.synchronize()
    f32 = dt == torch.float32
    for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        sym = fa.kernel_for(w.__name__, dt, d)[1]
        if d == 256:
            assert sym == f"{w.__name__}_{'f32_' if f32 else ''}d256_wgmma"
        elif d == 128 and not f32:
            assert sym == f"{w.__name__}_d128_wgmma"
        elif d == 64 and f32:
            assert sym == f"{w.__name__}_f32_d64_wgmma"
        elif d == 128 and f32:
            assert sym == f"{w.__name__}_f32_d128_wgmma"
        else:
            assert sym == f"{w.__name__}_{'f32mma' if f32 else 'mma'}"
        assert w.launches_by_kernel == {
            s: int(s == sym) for s in w.launches_by_kernel}
    want_o, want_lse = fa.ref_attention_lse(q.float(), k.float(), v.float(),
                                            sc, causal)
    want_q = fa.ref_flash_bwd_dq(q, k, v, do, lse, delta, sc, causal)
    want_k, want_v = fa.ref_flash_bwd_dkv(q, k, v, do, lse, delta, sc,
                                          causal)
    torch.testing.assert_close(lse, want_lse, **F32_TOL)
    for name, got, want in (("O", o, want_o.to(dt)), ("dQ", dq, want_q),
                            ("dK", dk, want_k), ("dV", dv, want_v)):
        assert got.dtype == dt and torch.isfinite(got).all(), name
        if f32:
            torch.testing.assert_close(got, want, **F32_TOL)
            continue
        ratio = _half_tier_ratio(got, want)
        assert ratio <= 1.0, f"{name}: worst err / limit {ratio:.3f}"


# (bh, tq, tk, causal) at head dim 256: T 128 and 2048, causal and not,
# tq != tk (fully masked rows), ragged, and B*H past gridDim.y's 65535
WGMMA_CASES = [(8, 128, 128, True), (8, 128, 128, False),
               (2, 2048, 2048, True), (2, 2048, 2048, False),
               (8, 128, 256, True), (8, 256, 128, True),
               (8, 200, 200, True), (8, 200, 200, False),
               (65536, 16, 16, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("bh,tq,tk,causal", WGMMA_CASES)
def test_wgmma_kernels_match_plain_versions(dtype, bh, tq, tk, causal):
    """bf16 and fp16 K1, K2 and K3 at head dim 256 on their warpgroup
    kernels (wgmma, TMA), each output against its plain version in the
    16-bit tier, one launch on each symbol (two for B*H past 65535)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    q, k, v, do = chip_smoke.attention_inputs(torch, gen, "cuda", bh, tq, tk,
                                              256, dt)
    sc = 1 / 16
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, sc, causal)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, sc, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, sc, causal)
    torch.cuda.synchronize()
    chunks = -(-bh // fa.MAX_GRID_Y)
    for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        assert w.launches_by_kernel[f"{w.__name__}_d256_wgmma"] \
            == w.launches == chunks
    want_o, want_lse = fa.ref_attention_lse(q.float(), k.float(), v.float(),
                                            sc, causal)
    want_q = fa.ref_flash_bwd_dq(q, k, v, do, lse, delta, sc, causal)
    want_k, want_v = fa.ref_flash_bwd_dkv(q, k, v, do, lse, delta, sc,
                                          causal)
    torch.testing.assert_close(lse, want_lse, **F32_TOL)
    for name, got, want in (("O", o, want_o.to(dt)), ("dQ", dq, want_q),
                            ("dK", dk, want_k), ("dV", dv, want_v)):
        assert got.dtype == dt and torch.isfinite(got).all(), name
        ratio = _half_tier_ratio(got, want)
        assert ratio <= 1.0, f"{name}: worst err / limit {ratio:.3f}"


# (bh, tq, tk, causal) at head dim 128: the Llama training shape, the
# serving buckets and generate's recompute, T 2048 non-causal, tq != tk
# (fully masked rows), ragged, and B*H past gridDim.y's 65535
WGMMA_D128_CASES = [(64, 2048, 2048, True), (2, 2048, 2048, False),
                    (128, 128, 128, True), (128, 256, 256, True),
                    (128, 192, 192, True), (8, 128, 128, False),
                    (8, 128, 256, True), (8, 256, 128, True),
                    (8, 200, 200, True), (8, 200, 200, False),
                    (65536, 16, 16, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("bh,tq,tk,causal", WGMMA_D128_CASES)
def test_d128_wgmma_kernels_match_plain_versions(dtype, bh, tq, tk, causal):
    """bf16 and fp16 K1, K2 and K3 at head dim 128 on their warpgroup
    kernels (wgmma, TMA; K1's consumers in ping-pong), each output
    against its plain version in the 16-bit tier, one launch on each
    symbol (two for B*H past 65535)."""
    _check_d128_kernels(dtype, bh, tq, tk, causal, 1 / np.sqrt(128))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("bh,tq,tk,causal", [(8, 256, 256, True),
                                             (8, 512, 512, False)])
def test_d128_wgmma_kernels_take_a_negative_scale(dtype, bh, tq, tk, causal):
    """The reference takes any scale, a negative one too: there K1's
    unmasked tiles may not take the raw scores' row maxima for the
    maxima of the scaled ones (at -8 those scores span 2^249, and
    2^(x - m) from the raw maxima would overflow to inf), so K1-K3 at
    head dim 128 still match their plain versions."""
    _check_d128_kernels(dtype, bh, tq, tk, causal, -8.0)


def _check_d128_kernels(dtype, bh, tq, tk, causal, sc):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    q, k, v, do = chip_smoke.attention_inputs(torch, gen, "cuda", bh, tq, tk,
                                              128, dt)
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, sc, causal)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, sc, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, sc, causal)
    torch.cuda.synchronize()
    chunks = -(-bh // fa.MAX_GRID_Y)
    for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        sym = fa.kernel_for(w.__name__, dt, 128)[1]
        assert sym == f"{w.__name__}_d128_wgmma"
        assert w.launches_by_kernel[sym] == w.launches == chunks
    want_o, want_lse = fa.ref_attention_lse(q.float(), k.float(), v.float(),
                                            sc, causal)
    want_q = fa.ref_flash_bwd_dq(q, k, v, do, lse, delta, sc, causal)
    want_k, want_v = fa.ref_flash_bwd_dkv(q, k, v, do, lse, delta, sc,
                                          causal)
    torch.testing.assert_close(lse, want_lse, **F32_TOL)
    for name, got, want in (("O", o, want_o.to(dt)), ("dQ", dq, want_q),
                            ("dK", dk, want_k), ("dV", dv, want_v)):
        assert got.dtype == dt and torch.isfinite(got).all(), name
        ratio = _half_tier_ratio(got, want)
        assert ratio <= 1.0, f"{name}: worst err / limit {ratio:.3f}"


@pytest.mark.gpu
@pytest.mark.parametrize("bh,tq,tk,causal", WGMMA_CASES)
def test_f32_wgmma_kernel_matches_plain_version(bh, tq, tk, causal):
    """float32 K1, K2 and K3 at head dim 256 on their warpgroup kernels
    (wgmma on bf16 pieces, TMA, a producer warpgroup that splits), O,
    lse, dQ, dK and dV against the plain versions in the f32 tier with
    TF32 off, one launch on each symbol (two for B*H past 65535)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    q, k, v, do = chip_smoke.attention_inputs(torch, gen, "cuda", bh, tq, tk,
                                              256, torch.float32)
    sc = 1 / 16
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, sc, causal)
    delta = (do * o).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, sc, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, sc, causal)
    torch.cuda.synchronize()
    chunks = -(-bh // fa.MAX_GRID_Y)
    for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        assert w.launches_by_kernel[f"{w.__name__}_f32_d256_wgmma"] \
            == w.launches == chunks
    want_o, want_lse = fa.ref_attention_lse(q, k, v, sc, causal)
    want_k, want_v = fa.ref_flash_bwd_dkv(q, k, v, do, lse, delta, sc,
                                          causal)
    for name, got, want in (
            ("O", o, want_o), ("lse", lse, want_lse),
            ("dQ", dq, fa.ref_flash_bwd_dq(q, k, v, do, lse, delta, sc,
                                           causal)),
            ("dK", dk, want_k), ("dV", dv, want_v)):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        ok, err, ratio = chip_smoke.kernel_err(got, want)
        assert ok, f"{name}: max abs err {err:.3e}, err/limit {ratio:.3f}"


# (bh, tq, tk, causal) at head dim 64 in float32: Transformer-base's
# causal self-attention and unpadded cross-attention (B*H 32 x 8), tq > tk
# with fully masked rows, ragged, and B*H past gridDim.y's 65535 at T 32
F32_D64_CASES = [(256, 256, 256, True), (256, 128, 256, False),
                 (8, 256, 128, True), (8, 200, 200, True),
                 (8, 200, 200, False), (65536, 32, 32, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("bh,tq,tk,causal", F32_D64_CASES)
def test_f32_d64_wgmma_kernel_matches_plain_version(bh, tq, tk, causal):
    """float32 K3 at head dim 64 on its warpgroup kernel (wgmma on bf16
    pieces of 64-row q tiles, TMA, a producer warpgroup that splits), dK
    and dV against the plain version in the f32 tier with TF32 off, one
    launch (two for B*H past 65535); K1 and K2 beside it on their own
    warpgroup kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    q, k, v, do = chip_smoke.attention_inputs(torch, gen, "cuda", bh, tq, tk,
                                              64, torch.float32)
    sc = 1 / 8
    o, lse = fa.flash_fwd(q, k, v, sc, causal)
    delta = (do * o).sum(-1)
    fa.reset_launch_counts()
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, sc, causal)
    torch.cuda.synchronize()
    sym = fa.kernel_for("flash_bwd_dkv", torch.float32, 64)[1]
    assert sym == "flash_bwd_dkv_f32_d64_wgmma"
    assert fa.flash_bwd_dkv.launches_by_kernel[sym] \
        == fa.flash_bwd_dkv.launches == -(-bh // fa.MAX_GRID_Y)
    want_k, want_v = fa.ref_flash_bwd_dkv(q, k, v, do, lse, delta, sc,
                                          causal)
    for name, got, want in (("dK", dk, want_k), ("dV", dv, want_v)):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        ok, err, ratio = chip_smoke.kernel_err(got, want)
        assert ok, f"{name}: max abs err {err:.3e}, err/limit {ratio:.3f}"


# F32_D64_CASES and the two float32 D = 64 cases chip_smoke.py's kernels
# phase adds for K1 and K2: causal tq < tk and ragged causal (already
# above)
F32_D64_FWD_DQ_CASES = F32_D64_CASES + [(8, 128, 256, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("bh,tq,tk,causal", F32_D64_FWD_DQ_CASES)
def test_f32_d64_wgmma_fwd_and_dq_match_plain_versions(bh, tq, tk, causal):
    """float32 K1 and K2 at head dim 64 on their warpgroup kernels
    (wgmma on bf16 pieces, TMA, a producer warpgroup that splits in
    place, two blocks an SM): O, lse and dQ against the plain versions
    in the f32 tier with TF32 off, one launch each (two for B*H past
    65535) on the symbol kernel_for names, and the card's occupancy
    count equal to each source's BLOCKS_PER_SM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(28)
    q, k, v, do = chip_smoke.attention_inputs(torch, gen, "cuda", bh, tq, tk,
                                              64, torch.float32)
    sc = 1 / 8
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, sc, causal)
    delta = (do * o).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, sc, causal)
    torch.cuda.synchronize()
    chunks = -(-bh // fa.MAX_GRID_Y)
    for w, want in ((fa.flash_fwd, "flash_fwd_f32_d64_wgmma"),
                    (fa.flash_bwd_dq, "flash_bwd_dq_f32_d64_wgmma")):
        route = fa.kernel_for(w.__name__, torch.float32, 64)
        assert route == (want, want)
        assert w.launches_by_kernel[want] == w.launches == chunks
        assert fa.blocks_per_sm(route) \
            == cuda_build.constexprs(want)["BLOCKS_PER_SM"]
    want_o, want_lse = fa.ref_attention_lse(q, k, v, sc, causal)
    for name, got, want in (
            ("O", o, want_o), ("lse", lse, want_lse),
            ("dQ", dq, fa.ref_flash_bwd_dq(q, k, v, do, lse, delta, sc,
                                           causal))):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        ok, err, ratio = chip_smoke.kernel_err(got, want)
        assert ok, f"{name}: max abs err {err:.3e}, err/limit {ratio:.3f}"


# (bh, tq, tk, causal) at head dim 128 in float32: the Llama width's
# serving buckets (B*H 4 x 32, T 128 and 256), the parity shape causal and
# not, tq < tk, tq > tk with fully masked rows, ragged causal and not,
# T 2048 (B*H 2 x 32) and B*H past gridDim.y's 65535 at T 32
F32_D128_CASES = [(128, 128, 128, True), (128, 256, 256, True),
                  (8, 256, 256, True), (8, 256, 256, False),
                  (8, 128, 256, True), (8, 256, 128, True),
                  (8, 200, 200, True), (8, 200, 200, False),
                  (64, 2048, 2048, True), (65536, 32, 32, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("scale_sign", [1, -1])
@pytest.mark.parametrize("bh,tq,tk,causal", F32_D128_CASES)
def test_f32_d128_wgmma_fwd_and_dq_match_plain_versions(bh, tq, tk, causal,
                                                        scale_sign):
    """float32 K1 and K2 at head dim 128 on their warpgroup kernels
    (wgmma on bf16 pieces, TMA, a producer warpgroup that splits in
    place; K1 two blocks an SM): O, lse and dQ against the plain versions
    in the f32 tier with TF32 off, under a scale and its negative (the
    masked path), one launch each (two for B*H past 65535) on the symbol
    kernel_for names, and K1's occupancy count equal to its source's
    BLOCKS_PER_SM; K3 beside them on its own warpgroup kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    q, k, v, do = chip_smoke.attention_inputs(torch, gen, "cuda", bh, tq, tk,
                                              128, torch.float32)
    sc = scale_sign / np.sqrt(128)
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, sc, causal)
    delta = (do * o).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, sc, causal)
    torch.cuda.synchronize()
    chunks = -(-bh // fa.MAX_GRID_Y)
    for w, want in ((fa.flash_fwd, "flash_fwd_f32_d128_wgmma"),
                    (fa.flash_bwd_dq, "flash_bwd_dq_f32_d128_wgmma")):
        route = fa.kernel_for(w.__name__, torch.float32, 128)
        assert route == (want, want)
        assert w.launches_by_kernel[want] == w.launches == chunks
    assert fa.blocks_per_sm(fa.kernel_for("flash_fwd", torch.float32, 128)) \
        == cuda_build.constexprs("flash_fwd_f32_d128_wgmma")["BLOCKS_PER_SM"]
    assert fa.kernel_for("flash_bwd_dkv", torch.float32, 128)[1] \
        == "flash_bwd_dkv_f32_d128_wgmma"
    want_o, want_lse = fa.ref_attention_lse(q, k, v, sc, causal)
    for name, got, want in (
            ("O", o, want_o), ("lse", lse, want_lse),
            ("dQ", dq, fa.ref_flash_bwd_dq(q, k, v, do, lse, delta, sc,
                                           causal))):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        ok, err, ratio = chip_smoke.kernel_err(got, want)
        assert ok, f"{name}: max abs err {err:.3e}, err/limit {ratio:.3f}"


@pytest.mark.gpu
@pytest.mark.parametrize("scale_sign", [1, -1])
@pytest.mark.parametrize("bh,tq,tk,causal",
                         F32_D128_CASES + [(32, 512, 512, True)])
def test_f32_d128_wgmma_dkv_matches_plain_version(bh, tq, tk, causal,
                                                  scale_sign):
    """float32 K3 at head dim 128 on its warpgroup kernel alone (wgmma on
    bf16 pieces of 32-row q tiles, TMA, a producer warpgroup that
    splits): dK and dV against the plain version in the f32 tier with
    TF32 off, on chip_smoke.py's float32 D 128 cases and the pipeline
    stage's T 512, under a scale and its negative (the masked path), one
    launch (two for B*H past 65535) on the symbol kernel_for names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(30)
    q, k, v, do = chip_smoke.attention_inputs(torch, gen, "cuda", bh, tq, tk,
                                              128, torch.float32)
    sc = scale_sign / np.sqrt(128)
    o, lse = fa.ref_attention_lse(q, k, v, sc, causal)
    delta = (do * o).sum(-1)
    lse = lse.contiguous()
    fa.reset_launch_counts()
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, sc, causal)
    torch.cuda.synchronize()
    sym = fa.kernel_for("flash_bwd_dkv", torch.float32, 128)[1]
    assert sym == "flash_bwd_dkv_f32_d128_wgmma"
    assert fa.flash_bwd_dkv.launches_by_kernel[sym] \
        == fa.flash_bwd_dkv.launches == -(-bh // fa.MAX_GRID_Y)
    want_k, want_v = fa.ref_flash_bwd_dkv(q, k, v, do, lse, delta, sc,
                                          causal)
    for name, got, want in (("dK", dk, want_k), ("dV", dv, want_v)):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        ok, err, ratio = chip_smoke.kernel_err(got, want)
        assert ok, f"{name}: max abs err {err:.3e}, err/limit {ratio:.3f}"


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_f32_d128_gradients_through_the_function_match_the_cpu(causal):
    """attention_with_lse in float32 at head dim 128 on the card (K1, K2
    and K3 on their warpgroup kernels, one launch each) against the same autograd on the CPU (the plain versions),
    tq > tk so that causal rows are fully masked, rtol 2e-3 / atol
    2e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    r = np.random.RandomState(29)
    q = (r.randn(2, 4, 256, 128) * 0.5).astype(np.float32)
    k, v = ((r.randn(2, 4, 200, 128) * 0.5).astype(np.float32)
            for _ in range(2))
    do = r.randn(2, 4, 256, 128).astype(np.float32)
    dl = r.randn(2, 4, 256).astype(np.float32)
    grads = {}
    for dev in ("cuda", "cpu"):
        fa.reset_launch_counts()
        ts = [torch.from_numpy(a).to(dev).requires_grad_() for a in (q, k, v)]
        o, lse = fa.attention_with_lse(*ts, causal=causal)
        loss = (o * torch.from_numpy(do).to(dev)).sum() \
            + (lse * torch.from_numpy(dl).to(dev)).sum()
        grads[dev] = [g.cpu() for g in torch.autograd.grad(loss, ts)]
        if dev == "cuda":
            torch.cuda.synchronize()
            for w, sym in ((fa.flash_fwd, "flash_fwd_f32_d128_wgmma"),
                           (fa.flash_bwd_dq, "flash_bwd_dq_f32_d128_wgmma"),
                           (fa.flash_bwd_dkv,
                            "flash_bwd_dkv_f32_d128_wgmma")):
                assert w.launches_by_kernel[sym] == w.launches == 1
    for g, w in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(g, w, rtol=2e-3, atol=2e-4)


@pytest.mark.gpu
def test_mma_route_refuses_what_it_does_not_take():
    """A 16-bit CUDA input the tensor-core kernels do not take raises at
    the wrapper; it never falls back to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q = torch.zeros(2, 64, 96, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_fwd(q, q, q, 0.1, True)
    buf = torch.zeros(2 * 64 * 128 + 1, dtype=torch.bfloat16, device="cuda")
    q = buf[1:].view(2, 64, 128)          # contiguous, 2 bytes off
    fa.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_fwd(q, q, q, 0.1, True)
    assert fa.flash_fwd.launches == 0
    rows = torch.zeros(2, 64, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_bwd_dq(q, q, q, q, rows, rows, 0.1, True)
    assert fa.flash_bwd_dq.launches == 0


@pytest.mark.gpu
def test_float32_route_refuses_views_off_the_16_byte_boundary():
    """float32 views 4 bytes off a 16-byte boundary: K1, K2 and K3 copy
    their tiles by cp.async and raise on them (never falling back to the
    plain version); the same values, copied to aligned tensors, run and
    match the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    sc = 1 / np.sqrt(128)
    n = 8 * 200 * 128
    arrs = _qkv(16, (8, 200, 128), (8, 200, 128)) + (
        np.random.RandomState(17).randn(8, 200, 128).astype(np.float32),)
    q, k, v, do = (torch.cat([torch.zeros(1), torch.from_numpy(a).reshape(-1)])
                   .cuda()[1:1 + n].view(8, 200, 128) for a in arrs)
    assert all(fa._misaligned((x,)) for x in (q, k, v, do))
    fa.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_fwd(q, k, v, sc, True)
    o, lse = fa.flash_fwd(q.clone(), k.clone(), v.clone(), sc, True)
    delta = (do * o).sum(-1)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_bwd_dq(q, k, v, do, lse, delta, sc, True)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_bwd_dkv(q, k, v, do, lse, delta, sc, True)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == (1, 0, 0)
    q, k, v, do = (x.clone() for x in (q, k, v, do))
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, sc, True)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, sc, True)
    torch.cuda.synchronize()
    for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        sym = fa.kernel_for(w.__name__, torch.float32, 128)[1]
        assert w.launches_by_kernel[sym] == 1
    want_o, want_lse = fa.ref_attention_lse(q, k, v, sc, True)
    want_k, want_v = fa.ref_flash_bwd_dkv(q, k, v, do, lse, delta, sc, True)
    for got, want in ((o, want_o), (lse, want_lse), (dk, want_k),
                      (dv, want_v),
                      (dq, fa.ref_flash_bwd_dq(q, k, v, do, lse, delta, sc,
                                               True))):
        torch.testing.assert_close(got, want, **F32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernels_take_bh_past_the_grid_y_limit(dtype):
    """B*H = 65536, one past gridDim.y's 65535: each launcher takes B*H in
    chunks, and K1, K2 and K3 match their plain versions on every slice
    (bf16 in the 16-bit tier, float32 in the f32 tier), T = 16, causal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    bh, t, d = 65536, 16, 128
    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    q, k, v, do = chip_smoke.attention_inputs(torch, gen, "cuda", bh, t, t,
                                              d, dt)
    sc = 1 / np.sqrt(d)
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, sc, True)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, sc, True)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, sc, True)
    torch.cuda.synchronize()
    # one call a wrapper, each launched as two chunks of B*H
    assert fa.MAX_GRID_Y == 65535
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == (2, 2, 2)
    want_o, want_lse = fa.ref_attention_lse(q.float(), k.float(), v.float(),
                                            sc, True)
    want_k, want_v = fa.ref_flash_bwd_dkv(q, k, v, do, lse, delta, sc, True)
    torch.testing.assert_close(lse, want_lse, **F32_TOL)
    for name, got, want in (
            ("O", o, want_o.to(dt)), ("dK", dk, want_k), ("dV", dv, want_v),
            ("dQ", dq, fa.ref_flash_bwd_dq(q, k, v, do, lse, delta, sc,
                                           True))):
        ok, err, ratio = chip_smoke.kernel_err(got, want)
        assert ok, f"{name}: max abs err {err:.3e}, err/limit {ratio:.3f}"


@pytest.mark.gpu
def test_llama_tiny_trains_and_serves_on_the_card_through_the_plain_route():
    """LLAMA_TINY (head dim 16, which no kernel takes) on CUDAPlace(0):
    one train step and 3 Adam steps match CPUPlace() at the f32 gradient
    and loss tiers, ServingEngine's answers match CPU Executor.run at
    the f32 logits tier, and every attention call takes the counted
    plain route, no kernel (chip_smoke.phase_plain_route)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = chip_smoke.phase_plain_route(torch, fluid, fa, "test")
    assert out["train"]["calls"]["flash_fwd plain"] == 8
    assert out["serve"]["calls"]["flash_fwd plain"] > 0


@pytest.mark.gpu
def test_bf16_attention_gradients_on_the_card_match_f32_cpu():
    """FlashAttention in bf16 on the card (K1, K2 and K3 on the
    tensor cores), through o and lse, causal, T = 256, held two ways.

    Against the plain backward on the card's own bf16 O and lse (the
    same delta = rowsum(dO * O) - dlse the backward forms, the rest in
    float32, rounded once to bf16): the 16-bit tier, rtol 1e-2 plus
    1e-2 x the plain gradient's RMS. A K3 that skips its last q tile,
    and a K2 that skips each q tile's last k tile, must fail that
    tier.

    Against float32 autograd on the CPU on the same bf16-valued inputs:
    rtol 2e-2 plus 0.1 x the float32 gradient's RMS. That path keeps O
    in float32, and dP - delta cancels, so O's bf16 rounding alone moves
    dQ by ~0.05 x RMS."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    r = np.random.RandomState(15)
    arrs = [(r.randn(2, 4, 256, 128) * 0.5).astype(np.float32)
            for _ in range(3)]
    do = torch.from_numpy(r.randn(2, 4, 256, 128).astype(np.float32)) \
        .to(torch.bfloat16)
    dl = torch.from_numpy(r.randn(2, 4, 256).astype(np.float32))
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    sc = 1 / np.sqrt(128)
    grads = {}
    for dev, dt in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        ts = [x.to(dev).to(dt).requires_grad_() for x in bf]
        fa.reset_launch_counts()
        o, lse = fa.attention_with_lse(*ts, causal=True)
        loss = (o.float() * do.to(dev).to(dt).float()).sum() \
            + (lse * dl.to(dev)).sum()
        grads[dev] = [g.float().cpu() for g in torch.autograd.grad(loss, ts)]
        if dev == "cuda":
            for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
                sym = fa.kernel_for(w.__name__, torch.bfloat16, 128)[1]
                assert w.launches_by_kernel[sym] == 1 == w.launches
            card_o, card_lse = o.detach().cpu(), lse.detach().cpu()
    q, k, v = bf
    delta = (do.float() * card_o.float()).sum(-1) - dl
    want_q = fa.ref_flash_bwd_dq(q, k, v, do, card_lse, delta, sc, True)
    want_k, want_v = fa.ref_flash_bwd_dkv(q, k, v, do, card_lse, delta, sc,
                                          True)
    got_q, got_k, got_v = grads["cuda"]
    for name, got, want in (("dQ", got_q, want_q), ("dK", got_k, want_k),
                            ("dV", got_v, want_v)):
        ratio = _half_tier_ratio(got, want)
        assert ratio <= 1.0, f"{name}: worst err / limit {ratio:.3f}"
    # K3 skipping its last q tile loses those rows' share of dK and dV
    m = cuda_build.constexprs(fa.kernel_for("flash_bwd_dkv", torch.bfloat16,
                                            128)[0])["BLOCK_M"]
    lost_k, lost_v = fa.ref_flash_bwd_dkv(
        q[:, :, -m:], k, v, do[:, :, -m:], card_lse[..., -m:],
        delta[..., -m:], sc, True)
    for name, got, lost, want in (("dK", got_k, lost_k, want_k),
                                  ("dV", got_v, lost_v, want_v)):
        ratio = _half_tier_ratio(got - lost.float(), want)
        assert ratio > 1.0, f"{name}: a skipped q tile reads {ratio:.3f}"
    # K2 skipping each q tile's last k tile loses, under causal with
    # tq = tk, the share of the keys on the diagonal tile: the plain dQ
    # of each q tile's rows against those keys (the masks align
    # bottom-right)
    tiles = cuda_build.constexprs(fa.kernel_for("flash_bwd_dq", torch.bfloat16,
                                                128)[0])
    bm, bn = tiles["BLOCK_M"], tiles["BLOCK_N"]
    nt = 256 // bm
    q_t, do_t = (x.reshape(2, 4, nt, bm, 128) for x in (q, do))
    k_t, v_t = (x.reshape(2, 4, nt, bm // bn, bn, 128)[:, :, :, -1]
                for x in (k, v))
    lost_q = fa.ref_flash_bwd_dq(q_t, k_t, v_t, do_t,
                                 card_lse.reshape(2, 4, nt, bm),
                                 delta.reshape(2, 4, nt, bm), sc, True)
    ratio = _half_tier_ratio(got_q - lost_q.float().reshape(got_q.shape),
                             want_q)
    assert ratio > 1.0, f"dQ: a skipped k tile reads {ratio:.3f}"
    for g, w in zip(grads["cuda"], grads["cpu"]):
        atol = 0.1 * float(w.square().mean().sqrt())
        torch.testing.assert_close(g, w, rtol=2e-2, atol=atol)


# ---------------------------------------------------------------------------
# the training switches on the card: stacked decoder with remat, the fused
# loss, memory_optimize, AMP and the NaN guard
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_stacked_remat_fused_llama_on_the_card_matches_the_cpu():
    """``build_llama(shard_pp=True, fused_head_chunk=384, remat=True)``
    in float32 on the card (K1, K2 and K3 on their warpgroup kernels of
    head dim 128; K1 twice a layer a step)
    against the CPU at the f32 tiers; remat off and ``memory_optimize``
    (``nothing_saveable``, ``dots_saveable``) give the gradients of remat
    on (chip_smoke.phase_train_stack_parity)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    by_kernel, out = chip_smoke.phase_train_stack_parity(torch, fluid, fa,
                                                         "test")
    assert by_kernel["flash_fwd_f32_d128_wgmma"] == 16
    assert by_kernel["flash_bwd_dq_f32_d128_wgmma"] == 8
    assert by_kernel["flash_bwd_dkv_f32_d128_wgmma"] == 8
    assert by_kernel["flash_bwd_dkv_f32mma"] == 0
    assert out["remat_variants"]["nothing_saveable"]["k1_launches"] == 6


@pytest.mark.gpu
def test_nan_guard_on_the_card_names_what_the_cpu_names():
    """chip_smoke.phase_nan_guard: the guarded step equals the unguarded
    one; an inf in blocks.wq trips the guard on the card with the CPU's
    message; repeats=2 raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = chip_smoke.phase_nan_guard(torch, fluid, fa, "test")
    assert "llama_decoder_stack -> " in out["tripped"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_loss_on_the_card_matches_float64(dtype):
    """The fused loss at a sliding last chunk (V = 1000, chunk 192), its
    loss, dH and dW on the card against float64 autograd of the full
    logits on the same (dtype-valued) inputs: float32 (TF32 off) at
    rtol 1e-4 / atol 1e-5, bf16 — logits in float32 from bf16 products,
    the softmax gradient rounded once to bf16 before its products — at
    rtol 2e-2 plus 1e-2 x the float64 gradient's RMS."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.ops import fused_loss as fl
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    r = np.random.RandomState(21)
    h = torch.from_numpy(r.randn(300, 128).astype(np.float32)).to(dt)
    w = torch.from_numpy((r.randn(128, 1000) * 0.1).astype(np.float32)) \
        .to(dt)
    t = torch.from_numpy(r.randint(0, 1000, (300,)))
    t[::7] = -100
    gw = torch.from_numpy(r.rand(300).astype(np.float32))
    hc, wc = (x.cuda().requires_grad_() for x in (h, w))
    loss = fl.fused_head_cross_entropy(hc, wc, t.cuda(), 192)
    (loss * gw.cuda()).sum().backward()
    h64, w64 = (x.double().requires_grad_() for x in (h, w))
    logits = h64 @ w64
    keep = t != -100
    want = torch.zeros(300, dtype=torch.float64)
    want[keep] = torch.logsumexp(logits[keep], -1) \
        - logits[keep].gather(1, t[keep][:, None])[:, 0]
    (want * gw.double()).sum().backward()
    if dt == torch.float32:
        tol = dict(rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(loss.detach().cpu().double(), want.detach(),
                                   **tol)
        torch.testing.assert_close(hc.grad.cpu().double(), h64.grad, **tol)
        torch.testing.assert_close(wc.grad.cpu().double(), w64.grad, **tol)
    else:
        torch.testing.assert_close(loss.detach().cpu().double(),
                                   want.detach(), rtol=1e-5, atol=1e-4)
        for got, ref in ((hc.grad, h64.grad), (wc.grad, w64.grad)):
            atol = 1e-2 * float(ref.square().mean().sqrt())
            torch.testing.assert_close(got.cpu().double(), ref, rtol=2e-2,
                                       atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_on_the_card_runs_the_bf16_kernels(level):
    """A float32 Llama (head dim 128) under amp_transpile on the card:
    every K1/K2/K3 launch is a bf16 kernel (the head-dim-128 warpgroup
    kernels), the state stays
    float32, and 3 Adam losses track the CPU's AMP run at rtol 5e-2
    (tests/test_torch_amp.py's tier)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models.llama import LlamaConfig
    cfg = LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=2,
                      n_kv_heads=1, ffn_hidden=512, dtype="float32")
    main, startup, loss = chip_smoke.build_train(
        fluid, cfg, 1e-3, shard_pp=True, fused_head_chunk=200, remat=True)
    fluid.transpiler.amp_transpile(main, level=level)
    gpu = fluid.Executor()
    scope = fluid.Scope()
    gpu.run(startup, scope=scope)
    cpu_scope = weights.load_state(fluid.Scope(), weights.dump_state(scope),
                                   torch.device("cpu"))
    cpu = fluid.Executor(fluid.CPUPlace())
    feed = chip_smoke.train_feed(cfg.vocab_size, 2, 128)
    fa.reset_launch_counts()
    got = [float(gpu.run(main, feed=feed, fetch_list=[loss],
                         scope=scope)[0].reshape(())) for _ in range(3)]
    for w, n in ((fa.flash_fwd, 12), (fa.flash_bwd_dq, 6),
                 (fa.flash_bwd_dkv, 6)):
        sym = fa.kernel_for(w.__name__, torch.bfloat16, 128)[1]
        assert w.launches_by_kernel[sym] == n == w.launches
    want = [float(cpu.run(main, feed=feed, fetch_list=[loss],
                          scope=cpu_scope)[0].reshape(())) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=5e-2)
    assert got[-1] < got[0]
    for p in main.all_parameters():
        assert scope.find_var(p.name).dtype == torch.float32, p.name


# ---------------------------------------------------------------------------
# Transformer-base (head dim 64, float32): the kernels at its attention
# shapes, its card-vs-CPU step and dropout on the card
# ---------------------------------------------------------------------------

# (tq, tk, causal): the decoder self-attention (causal, T 256 padded, 128
# unpadded), the encoder self-attention and the cross-attention of 128
# target rows over 256 source keys (non-causal)
TF_CASES = [(256, 256, True), (128, 128, True), (256, 256, False),
            (128, 256, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("tq,tk,causal", TF_CASES)
def test_f32_kernels_at_the_transformer_shapes(tq, tk, causal):
    """K1, K2 and K3 in float32 at head dim 64 and B·H 32 x 8, called as
    the model calls them: [B, T, H, D] projections, the heads moved next
    to the batch by a transpose view (``attention_core``), so strided
    inputs reach ``FlashAttention``, which hands the kernels contiguous,
    aligned copies. Output and gradients against the plain versions on
    the same inputs at the f32 tiers; one launch each, on the kernels
    ``kernel_for`` names at head dim 64 (their warpgroup kernels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from paddle_tpu_torch.ops.transformer_ops import attention_core
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, d = 32, 8, 64
    q, k, v = (torch.from_numpy(a).cuda() for a in
               _qkv(31, (b, tq, h, d), (b, tk, h, d)))
    do = torch.from_numpy(np.random.RandomState(32).randn(b, tq, h, d)
                          .astype(np.float32)).cuda()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.reset_launch_counts()
    out = attention_core(*leaves, causal=causal)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        sym = fa.kernel_for(w.__name__, torch.float32, d)[1]
        assert w.launches == 1 and w.launches_by_kernel[sym] == 1
    ref = [x.cpu().clone().requires_grad_() for x in (q, k, v)]
    want = attention_core(*ref, causal=causal)
    want_grads = torch.autograd.grad(want, ref, do.cpu())
    torch.testing.assert_close(out.cpu(), want.detach(), **F32_TOL)
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(g.cpu(), w, rtol=2e-3, atol=2e-4)


@pytest.mark.gpu
def test_transformer_on_the_card_matches_the_cpu():
    """The base width at 2 + 2 layers in float32 (chip_smoke's
    ``transformer_parity``): loss and every gradient at the f32 tiers,
    3 noam + Adam losses, the rates and the LR counter; K1/K2/K3 on the
    float32 kernels, 2 decoder layers x 4 steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    by_kernel, out = chip_smoke.phase_transformer_parity(torch, fluid, fa,
                                                         "test")
    assert by_kernel[fa.kernel_for("flash_fwd", torch.float32, 64)[1]] == 8
    assert out["lr_counter"] == 3


@pytest.mark.gpu
def test_dropout_on_the_card():
    """chip_smoke's dropout phase: kept share, replay and scaling."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = chip_smoke.phase_dropout(torch, "test")
    assert abs(out["upscale_in_train"]["kept_share"] - 0.9) < 0.01


def _engine(optimize, build, feeds, scope):
    from paddle_tpu_torch import serving
    main, fetch = build
    return serving.ServingEngine(
        main, feeds, [fetch], scope=scope,
        buckets=serving.BucketSpec(batch_sizes=(1, 2)),
        config=serving.ServingConfig(max_wait_ms=5.0), optimize=optimize)


def _fold_chain():
    """A test program whose constant feeds an exp/log/pow chain (all
    foldable), times tanh of the feed. Returns (program, fetch, feed)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        c = fluid.layers.fill_constant([16], "float32", 0.7310585)
        k = fluid.layers.pow(fluid.layers.log(fluid.layers.exp(
            fluid.layers.scale(c, scale=3.3, bias=0.1))), factor=1.7)
        out = fluid.layers.elementwise_mul(fluid.layers.tanh(x), k)
    feed = {"x": np.random.RandomState(5).randn(2, 16).astype(np.float32)}
    return main.clone(for_test=True), out, feed


@pytest.mark.gpu
def test_engine_folds_on_the_card_bit_exact():
    """A foldable exp/log/pow chain: the engine's default optimize folds
    it on the card (its own device), so the served answer equals the
    unoptimized program run on the card bit for bit — a CPU fold could
    differ from the card's exp/log in the last bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    infer, out, feed = _fold_chain()
    scope = fluid.Scope()
    want = fluid.Executor().run(infer, feed=feed, fetch_list=[out],
                                scope=scope)[0]
    with _engine(True, (infer, out), ["x"], scope) as eng:
        assert eng.optimize_report.n_folded >= 3
        assert [op.type for op in eng.program.global_block().ops
                ].count("exp") == 0
        got = eng.infer(feed, timeout=60.0)[0]
    assert np.array_equal(got, want)


@pytest.mark.gpu
def test_direct_optimize_folds_on_the_card_bit_exact():
    """``Program.optimize`` names no device and, with a card present,
    folds the same chain on the card (as the reference folds on jax's
    default backend), so the optimized program run on the card equals
    the unoptimized one bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    infer, out, feed = _fold_chain()
    opt = infer.clone(for_test=True)
    assert opt.optimize(fetch_list=[out.name]).n_folded >= 3
    exe, scope = fluid.Executor(), fluid.Scope()
    got = exe.run(opt, feed=feed, fetch_list=[out], scope=scope)[0]
    want = exe.run(infer, feed=feed, fetch_list=[out], scope=scope)[0]
    assert np.array_equal(got, want)


@pytest.mark.gpu
def test_engine_serves_optimized_clone_identically_on_the_card():
    """An MLP whose bias-add + relu chains fuse: the optimized engine's
    answers equal the unoptimized engine's bit for bit on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[32], dtype="float32")
        h = fluid.layers.fc(x, size=64, act="relu")
        pred = fluid.layers.fc(h, size=10, act="softmax")
    infer = main.clone(for_test=True)
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    feed = {"x": np.random.RandomState(6).randn(2, 32).astype(np.float32)}
    with _engine(False, (infer, pred), ["x"], scope) as off:
        off.warmup()
        want = off.infer(feed, timeout=60.0)[0]
    with _engine(True, (infer, pred), ["x"], scope) as on:
        assert on.optimize_report.n_fused >= 1
        on.warmup()
        got = on.infer(feed, timeout=60.0)[0]
        on.assert_no_recompiles()
    assert np.array_equal(got, want)



@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [("float32", 64), ("bfloat16", 128),
                                     ("bfloat16", 256)])
def test_custom_op_launches_flash_attentions_kernel(dtype, d):
    """K1's operator (``torch.ops.paddle_tpu_torch.flash_fwd``, what an
    exported graph calls) launches the kernel FlashAttention launches:
    one launch of the same variant, outputs bit for bit equal; an
    exported step on the card counts its K1 launches through it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).cuda().to(dt).reshape(2, 4, 128, d)
               for a in _qkv(21, (8, 128, d), (8, 128, d)))
    sym = fa.kernel_for("flash_fwd", dt, d)[1]
    fa.reset_launch_counts()
    o_op, lse_op = fa.flash_fwd_op(fa._fold(q), fa._fold(k), fa._fold(v),
                                   1 / np.sqrt(d), True)
    assert fa.flash_fwd.launches_by_kernel[sym] == 1
    fa.reset_launch_counts()
    o, lse = fa.FlashAttention.apply(q.requires_grad_(), k, v, True,
                                     float(1 / np.sqrt(d)))
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches_by_kernel[sym] == 1
    assert torch.equal(o.detach().reshape(o_op.shape), o_op)
    assert torch.equal(lse.detach().reshape(lse_op.shape), lse_op)

    from paddle_tpu_torch.io import aot
    step = lambda st, feed, dev, seed, n: (  # noqa: E731
        {}, [fa.flash_attention(feed["q"], feed["k"], feed["v"])])
    ep = aot.export_step(step, [], [], ["q", "k", "v"],
                         [q.detach(), k, v], q.device)
    fa.reset_launch_counts()
    got = ep.module()([], [q.detach(), k, v])[0]
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches_by_kernel[sym] == 1
    assert fa.flash_fwd.input_copies == 0
    assert torch.equal(got, o.detach())
    # a view the kernels cannot take is copied by the operator, counted
    fa.reset_launch_counts()
    qt = fa._fold(q.detach()).transpose(1, 2).contiguous().transpose(1, 2)
    o_view, _ = fa.flash_fwd_op(qt, fa._fold(k), fa._fold(v),
                                1 / np.sqrt(d), True)
    assert fa.flash_fwd.input_copies == 1
    assert torch.equal(o_view, o_op)


@pytest.mark.gpu
def test_device_loader_copies_on_a_side_stream():
    """DeviceLoader on the card: every batch arrives as a CUDA tensor
    equal to the host array, copied from pinned memory on the loader's
    own stream, the consumer's stream waiting on its event; a train
    step consuming the batches right away equals host-fed steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.io import DeviceLoader

    def reader():
        rng = np.random.RandomState(0)
        for _ in range(12):
            yield rng.randn(64, 256).astype(np.float32), \
                rng.randint(0, 2, (64, 1)).astype(np.int64)

    dl = DeviceLoader(reader, feed_names=["x", "y"], buffer_size=3)
    got = list(dl)
    assert dl._copy_stream is not None
    assert dl._copy_stream != torch.cuda.current_stream()
    assert len(got) == 12
    for f, (x, y) in zip(got, reader()):
        assert f["x"].is_cuda and torch.equal(f["x"].cpu(),
                                              torch.from_numpy(x))
        assert torch.equal(f["y"].cpu(), torch.from_numpy(y))
    losses = {}
    for mode in ("loader", "host"):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[256])
            y = fluid.layers.data("y", shape=[1], dtype="int64")
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(
                    fluid.layers.fc(x, size=2), y))
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        src = DeviceLoader(reader, feed_names=["x", "y"]) \
            if mode == "loader" else ({"x": a, "y": b} for a, b in reader())
        losses[mode] = [exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope)[0].item() for f in src]
    assert losses["loader"] == losses["host"]


def _exact_product(eq, a, b):
    """The exact int64 product of two int8 tensors, on the CPU (float64
    sums of integers far below 2**53 are exact)."""
    return torch.einsum(eq, a.cpu().double(), b.cpu().double()).long()


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 4, 17])
@pytest.mark.parametrize("k,n", [(4096, 1024), (14336, 4096)])
def test_qmat_int8_product_exact_on_the_card(m, k, n):
    """qmat's int8 x int8 -> int32 product (``int8_mm``: torch._int_mm,
    fewer than 17 rows padded with zero rows) at the decode step's row
    counts and the 8B width's inner sizes equals the exact product, with
    the extreme values the quantization gives (+-127)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the int8 GEMM runs there")
    from paddle_tpu_torch.ops import transformer_ops as tops
    g = torch.Generator(device="cuda").manual_seed(m * k)
    a = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                      dtype=torch.int8)
    a[0] = 127
    b[:, 0] = 127                      # one sum of k products of 127**2
    got = tops.int8_mm(a, b)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu().long(), _exact_product("mk,kn->mn", a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("eq,a_shape,b_shape", [
    ("bqgrd,bkgd->bgrqk", (2, 3, 8, 4, 1500), (2, 64, 8, 1500)),
    ("bgrqk,bkgd->bqgrd", (2, 8, 4, 3, 3000), (2, 3000, 8, 128))])
def test_int8_kv_contraction_exact_on_the_card(eq, a_shape, b_shape):
    """The int8 KV cache's contractions (``int8_einsum``: float32 products
    in chunks of at most 1040 terms) past 1040 terms, where one float32
    sum of 127**2-sized products would round, equal the exact product."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.ops import transformer_ops as tops
    g = torch.Generator(device="cuda").manual_seed(7)
    sign = lambda s: (torch.randint(0, 2, s, generator=g,  # noqa: E731
                                    device="cuda") * 254 - 127).to(
                                        torch.int8)
    a, b = sign(a_shape), sign(b_shape)
    got = tops.int8_einsum(eq, a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu().long(), _exact_product(eq, a, b))


@pytest.mark.gpu
def test_generator_on_the_card_matches_the_cpu():
    """A float32 generator (head dim 128, TF32 off) on the card: greedy
    tokens equal the CPU's (a seeded model whose margins are far above
    float32's rounding) and FirstProbs within rtol 1e-4 / atol 1e-6; its
    int8 forms (quantize, kv_int8) run on the card and echo the
    prompt."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               build_llama_generator,
                                               quantize_generator_weights)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=2,
                      n_kv_heads=1, ffn_hidden=512, dtype="float32")
    progs = {}
    for name, kw in (("f32", {}), ("int8", dict(quantize=True)),
                     ("kv8", dict(kv_int8=True))):
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
            ptok = fluid.layers.data(name="ptok", shape=[-1, 16],
                                     dtype="int64", append_batch_size=False)
            progs[name] = (prog, startup, build_llama_generator(
                cfg, ptok, max_new_tokens=8, return_probs=True, **kw))
    cpu = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    cpu.run(progs["f32"][1], scope=scope)
    prompt = np.random.RandomState(0).randint(0, 512, (3, 16)) \
        .astype(np.int64)
    prog, _, (out, probs) = progs["f32"]
    want, wprobs = cpu.run(prog, feed={"ptok": prompt},
                           fetch_list=[out, probs], scope=scope,
                           mode="test")
    card_scope = fluid.Scope()
    for n in scope.keys():
        card_scope.set(n, scope.find_var(n).cuda())
    card = fluid.Executor()
    got, gprobs = card.run(prog, feed={"ptok": prompt},
                           fetch_list=[out, probs], scope=card_scope,
                           mode="test")
    np.testing.assert_allclose(gprobs, wprobs, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got, want)
    for name in ("kv8", "int8"):
        if name == "int8":
            quantize_generator_weights(card_scope)
        prog, _, (out, _) = progs[name]
        toks = card.run(prog, feed={"ptok": prompt}, fetch_list=[out],
                        scope=card_scope, mode="test")[0]
        np.testing.assert_array_equal(toks[:, :16], prompt)
        assert ((toks >= 0) & (toks < 512)).all()


@pytest.mark.gpu
def test_decode_engine_on_the_card_matches_the_cpu():
    """A float32 DecodeEngine built with no place runs on the card (its
    pools on the card) and serves the tokens the same engine serves on
    the CPU (TF32 off; a seeded model whose margins are far above
    float32's rounding), with no step build after warmup and every page
    returned."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               build_llama_generator)
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=2,
                      n_kv_heads=1, ffn_hidden=512, dtype="float32")
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        ptok = fluid.layers.data(name="ptok", shape=[-1, 16],
                                 dtype="int64", append_batch_size=False)
        build_llama_generator(cfg, ptok, max_new_tokens=8)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    card_scope = fluid.Scope()
    for n in scope.keys():
        card_scope.set(n, scope.find_var(n).cuda())
    conf = dict(max_batch=4, prompt_buckets=(16, 32), max_new_tokens=8,
                page_size=8, decode_block=4, prefill_batch=2,
                default_timeout_s=120.0)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 512, (int(n),)).astype(np.int64)
               for n in rng.randint(3, 33, 8)]
    outs = {}
    for where, sc, place in (("cpu", scope, fluid.CPUPlace()),
                             ("card", card_scope, None)):
        eng = DecodeEngine(cfg, scope=sc, place=place,
                           config=DecodeConfig(**conf))
        try:
            eng.warmup()
            assert eng._kp.device.type == ("cpu" if place else "cuda")
            reqs = [eng.submit(p, timeout=120) for p in prompts]
            outs[where] = [r.result(120) for r in reqs]
            eng.assert_no_recompiles()
            assert eng.stats()["pages_in_use"] == 0
        finally:
            eng.close()
    for a, b in zip(outs["card"], outs["cpu"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_step_on_the_card_matches_the_cpu(reverse):
    """One ``lstm`` rule (peepholes, lengths 1-9 over a padded 12) on the
    card against the same rule on the CPU: the whole padded hidden and
    cell sequences (forward rtol 2e-4 / atol 2e-5) and the gradients of
    the input, the recurrent weight and the bias through one cotangent
    (rtol 2e-3 / atol 2e-4), TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from paddle_tpu_torch.core import lowering, registry
    from paddle_tpu_torch.core.sequence import SequenceBatch
    rng = np.random.RandomState(3)
    h = 16
    x = (rng.randn(5, 12, 4 * h) * 0.5).astype(np.float32)
    w = (rng.randn(h, 4 * h) * 0.3).astype(np.float32)
    b = (rng.randn(7 * h) * 0.3).astype(np.float32)
    lengths = np.asarray([9, 1, 12, 4, 7])
    cot = [rng.randn(5, 12, h).astype(np.float32) for _ in range(2)]
    res = []
    for dev in (torch.device("cuda"), torch.device("cpu")):
        leaves = [torch.from_numpy(a).to(dev).requires_grad_()
                  for a in (x, w, b)]
        ins = {"Input": [SequenceBatch(leaves[0], torch.from_numpy(
            lengths).to(dev))], "Weight": [leaves[1]], "Bias": [leaves[2]]}
        ctx = lowering.LoweringContext(None, "train", dev, 0, 1)
        with torch.enable_grad():
            out = registry.get_op("lstm").lower(
                ctx, ins, {"use_peepholes": True, "is_reverse": reverse})
            hc = [out["Hidden"][0].data, out["Cell"][0].data]
            total = sum((t * torch.from_numpy(c).to(dev)).sum()
                        for t, c in zip(hc, cot))
            grads = torch.autograd.grad(total, leaves)
        res.append(([t.detach().cpu() for t in hc], [g.cpu() for g in grads]))
    (card_out, card_g), (cpu_out, cpu_g) = res
    for a, b_ in zip(card_out, cpu_out):
        torch.testing.assert_close(a, b_, **F32_TOL)
    for a, b_ in zip(card_g, cpu_g):
        torch.testing.assert_close(a, b_, rtol=2e-3, atol=2e-4)
