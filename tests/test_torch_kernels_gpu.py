"""The port's CUDA kernels against their plain torch versions, on the
card. Imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit::

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu

(``--noconftest``: the suite's conftest imports jax). Without CUDA every
test skips. Tolerance: f32 rtol 2e-4 / atol 2e-5 (TF32 off); bf16 2e-2.
Gradients through the autograd.Function (K1, K2, K3 on the card)
against the plain versions on the CPU: rtol 2e-3 / atol 2e-4.

The tensor-core kernels (bf16 and fp16: ``flash_fwd_mma``,
``flash_bwd_dq_mma``, ``flash_bwd_dkv_mma``) are held to chip_smoke.py's
16-bit tier: rtol
1e-2 (one rounding of the output) plus atol 1e-2 x the plain output's
RMS, against the plain version evaluated in float32 on the same inputs
and rounded once to the output's type. The float32 kernels
(``flash_fwd_f32mma``, ``flash_bwd_dq_f32mma``, ``flash_bwd_dkv_f32mma``:
tensor cores with every operand split into bf16 or TF32 halves) are held
to the f32 tier.
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
# both head dims, causal and not
MMA_CASES = [(200, 200, 128, True), (200, 200, 128, False),
             (128, 256, 128, True), (256, 128, 128, True),
             (256, 256, 64, True), (256, 256, 64, False),
             (256, 256, 128, False)]


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
    assert fa.flash_fwd.launches_by_kernel == {
        "flash_fwd_f32mma": int(f32), "flash_fwd_mma": int(not f32),
        "plain": 0}
    assert fa.flash_bwd_dkv.launches_by_kernel == {
        "flash_bwd_dkv_f32mma": int(f32), "flash_bwd_dkv_mma": int(not f32),
        "plain": 0}
    assert fa.flash_bwd_dq.launches_by_kernel == {
        "flash_bwd_dq_f32mma": int(f32), "flash_bwd_dq_mma": int(not f32),
        "plain": 0}
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
    assert fa.flash_fwd.launches_by_kernel["flash_fwd_f32mma"] == 1
    assert fa.flash_bwd_dq.launches_by_kernel["flash_bwd_dq_f32mma"] == 1
    assert fa.flash_bwd_dkv.launches_by_kernel["flash_bwd_dkv_f32mma"] == 1
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
            assert fa.flash_fwd.launches_by_kernel["flash_fwd_mma"] == 1
            assert fa.flash_bwd_dq.launches_by_kernel[
                "flash_bwd_dq_mma"] == 1
            assert fa.flash_bwd_dkv.launches_by_kernel[
                "flash_bwd_dkv_mma"] == 1
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
    m = cuda_build.constexprs("flash_bwd_dkv_mma")["BLOCK_M"]
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
    tiles = cuda_build.constexprs("flash_bwd_dq_mma")
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
    in float32 on the card (the three ``_f32mma`` kernels, K1 twice a
    layer a step) against the CPU at the f32 tiers; remat off and
    ``memory_optimize`` (``nothing_saveable``, ``dots_saveable``) give
    the gradients of remat on (chip_smoke.phase_train_stack_parity)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    by_kernel, out = chip_smoke.phase_train_stack_parity(torch, fluid, fa,
                                                         "test")
    assert by_kernel["flash_fwd_f32mma"] == 16
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
    every K1/K2/K3 launch is a bf16 ``_mma`` kernel, the state stays
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
    assert fa.flash_fwd.launches_by_kernel["flash_fwd_mma"] == 12
    assert fa.flash_bwd_dq.launches_by_kernel["flash_bwd_dq_mma"] == 6
    assert fa.flash_bwd_dkv.launches_by_kernel["flash_bwd_dkv_mma"] == 6
    assert fa.flash_fwd.launches == 12
    want = [float(cpu.run(main, feed=feed, fetch_list=[loss],
                          scope=cpu_scope)[0].reshape(())) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=5e-2)
    assert got[-1] < got[0]
    for p in main.all_parameters():
        assert scope.find_var(p.name).dtype == torch.float32, p.name
