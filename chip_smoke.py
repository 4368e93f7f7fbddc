#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

Run from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit::

    python3 chip_smoke.py

Phases — any failure exits non-zero:

1. device: the card's name, ``nvidia-smi`` name and power limit, torch
   and CUDA versions;
2. build: every kernel of ``paddle_tpu_torch/csrc`` with nvcc (one
   process per source, all at once), with the build seconds, the
   compiler's register/shared-memory/spill report, and each kernel's
   count of tensor-core instructions (``HMMA``) in its SASS
   (``cuobjdump``) — none in a kernel (every one is ``_mma`` or
   ``_f32mma``) fails the run;
3. kernels: K1 (the flash-attention forward) and K2/K3 (its backward,
   dQ and dK/dV) against their plain torch versions on the same inputs,
   on both routes — bf16/fp16 through the 16-bit tensor-core kernels
   (``csrc/flash_fwd_mma.cu``, ``csrc/flash_bwd_dq_mma.cu``,
   ``csrc/flash_bwd_dkv_mma.cu``), float32 through the split-operand
   tensor-core kernels (``csrc/flash_fwd_f32mma.cu``,
   ``csrc/flash_bwd_dq_f32mma.cu``, ``csrc/flash_bwd_dkv_f32mma.cu``) —
   at the serving and training shapes and the edge cases (causal and
   not, tq != tk with fully masked rows, ragged T, D = 64, in f32, bf16
   and fp16), each case asserting which variant launched, with dQ, dK
   and dV each checked on its own, in a tier set by the output's type
   and scale; at the training shape, grid and tile-loop faults planted
   in copies of the outputs, at the tiles of the kernels that ran, must
   fail that tier, as must two faults of each float32 kernel at its own
   tile at the f32 serving shape and ``f32 causal``, in the float32
   tier; every kernel in bf16 and float32 at B*H = 65536 (past
   gridDim.y's 65535, launched in chunks); ``attention_with_lse``'s
   gradient through both outputs against plain autograd of
   ``ref_attention_lse``; each kernel timed beside its plain version,
   its bound and ``scaled_dot_product_attention`` forward or backward (a
   yardstick only — the port never calls it), the float32 ones also at
   B*H = 2 x 32, T = 2048;
4. serve: the Llama-3-8B-width forward program, all 32 layers (random
   weights from SEED) behind the port's ``ServingEngine``: warmup over the
   buckets, concurrent requests, each answer held against the same
   request run alone through ``Executor.run``, no step build after
   warmup, and K1 launched once per layer per dispatch — in bfloat16
   (every launch ``flash_fwd_mma``), then in float32 (every launch
   ``flash_fwd_f32mma``), where answers match the lone runs logit for
   logit; one (4 x 256) dispatch's device time by kind in each dtype;
5. train: the Llama-3-8B-width model cut to 8 layers, bf16, through
   ``build_llama(targets)`` → ``Adam.minimize`` → ``Executor.run`` on one
   fixed batch of 2 x 2048 tokens: 2 warmup and 8 timed steps with
   finite, falling loss, K1/K2/K3 each launched once per layer per step
   (every time on the tensor cores),
   step time, tokens/s, peak memory and one step's device time by kind
   (the main path of slices 2 to 4);
6. train_stack (the main path of this slice, whose launches the kernel
   line reports): the reference's own train benchmark (``bench.py``
   ``transformer_main``) at ``phase_train``'s width, depth, batch and
   steps — ``build_llama(shard_pp=True, fused_head_chunk=2048,
   remat=True)``: the layer-stacked decoder, each layer recomputed in
   the backward pass (K1 twice a layer a step, K2/K3 once), and the
   vocab-chunked fused loss, which never builds the logits; the checks
   of 5, and peak memory below 5's, with both steps' times, tokens/s,
   peak memory and device time by kind side by side;
7. train parity: a narrow float32 model (head dim 128, TF32 off) whose
   step on the card (the kernels: ``flash_fwd_f32mma``,
   ``flash_bwd_dq_f32mma``, ``flash_bwd_dkv_f32mma``) matches the same
   step on the CPU (the plain versions): loss and every parameter's
   gradient, then 3 Adam steps' losses; then the same model built as 6
   builds its own (stacked, remat, a fused loss whose last chunk slides
   back), held to the CPU the same way, and its step with remat off and
   under ``memory_optimize`` (``nothing_saveable``, ``dots_saveable``)
   equal to the step with remat on;
8. amp: the 8B width cut to 4 layers with float32 master state,
   unrolled and stacked, under ``amp_transpile`` O1 and O2: 3 Adam steps
   with finite, falling losses, every attention launch on the bf16
   kernels, the state still float32, and the first loss near the same
   program's without AMP;
9. nan guard: on 7's stacked model, the guarded step equals the
   unguarded one, an inf planted in ``blocks.wq`` raises
   FloatingPointError naming the op outputs the CPU names, and
   ``repeats=2`` raises ValueError;
10. plain route: ``LLAMA_TINY`` (head dim 16, off the reference's
   D % 128 == 0 gate) trains one step and 3 Adam steps and serves
   requests through ``ServingEngine`` on the card, matching the same
   runs on the CPU; its attention runs the plain versions, as the
   reference's gate sends that shape to its own, counted as
   ``launches_by_kernel["plain"]``, with no kernel launched.

It prints one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and
as its last line ``{"ok": true, "device": {...}}``. Without CUDA, or
without the package beside it, it exits non-zero and prints no result.
"""
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 0   # random weights, inputs and requests all derive from it

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_SPLIT_RATE = "float32 3xbf16"
F32_SPLIT_TF32_RATE = "float32 3xtf32"
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12,
              # float32 products as three bf16 / three TF32 tensor-core
              # products
              F32_SPLIT_RATE: 989e12 / 3, F32_SPLIT_TF32_RATE: 494.7e12 / 3}
# each kind's products, 2 d FLOP per visible (row, key) pair each
PRODUCTS = {"fwd": ("QK^T", "PV"), "dq": ("QK^T", "dOV^T", "dSK"),
            "dkv": ("QK^T", "dOV^T", "P^TdO", "dS^TQ")}
# the float32 kernels take each product as a split on the tensor cores:
# their bounds count each product at its split's rate (a kernel not
# listed runs every product at its dtype's rate)
RATE_OF_KERNEL = {
    "flash_fwd_f32mma": (F32_SPLIT_RATE, F32_SPLIT_RATE),
    "flash_bwd_dq_f32mma": (F32_SPLIT_RATE, F32_SPLIT_TF32_RATE,
                            F32_SPLIT_RATE),
    "flash_bwd_dkv_f32mma": (F32_SPLIT_RATE, F32_SPLIT_TF32_RATE,
                             F32_SPLIT_TF32_RATE, F32_SPLIT_RATE)}

# tolerances (|got - want| <= atol + rtol * |want|). A kernel's plain
# version is evaluated in float32 on the kernel's own inputs and rounded
# once to the output's type, as the kernel does; the tier follows the
# output's type.
TOL_F32 = (2e-4, 2e-5)     # tests/test_attention.py's f32 kernel tier
TOL_HALF_RTOL = 1e-2       # bf16/fp16 outputs: one rounding apart at
                           # most (a bf16 ulp is <= 2**-7 of the value)
TOL_HALF_RMS = 1e-2        # ... plus an atol of this x the plain
                           # output's RMS, for sums that cancel near 0
TOL_LOGITS_F32 = (5e-4, 5e-4)   # 32 float32 layers, summed in other orders
TOL_LOGITS_BF16_RMS = 0.1       # see phase_serve
TOL_GRAD_F32 = (2e-3, 2e-4)     # tests/test_attention.py's f32 gradient tier
TOL_LOSS_F32 = 2e-3             # tests/test_llama.py's loss tier

TRAIN_LAYERS = 8                # 32 → 8: Adam state of 32 layers
                                # (8.03 B params x 8 bytes in bf16) does
                                # not fit in 80 GB
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_WARMUP, TRAIN_STEPS = 2, 8
TRAIN_LABEL = "training shape"
STACK_CHUNK = 2048              # bench.py's fused_head_chunk
# the f32 parity model (dim 512, head dim 128, vocab 2048): stacked, its
# fused loss in chunks of 384, so the last of 6 slides back by 256
PARITY_CHUNK = 384
AMP_LAYERS = 4                  # 32 → 4: float32 master state (params,
                                # gradients, two Adam moments) of 4 layers
                                # with the embedding and head is 31 GB
AMP_STEPS = 3
# each wrapper's float32 kernel
F32_KERNELS = {"flash_fwd": "flash_fwd_f32mma",
               "flash_bwd_dq": "flash_bwd_dq_f32mma",
               "flash_bwd_dkv": "flash_bwd_dkv_f32mma"}
# the float32 cases where faults planted at the float32 kernels' tiles
# must fail
F32_FAULT_CASES = ("f32 serving T=256", "f32 causal")
F32_LONG_LABEL = "f32 T=2048"   # the float32 kernels where the grid fills
BIG_BH = 65536                  # past gridDim.y's 65535
INIT_STD = 0.02                 # models/llama.py _linear's Normal(0, 0.02)

# the profiler's kinds and the kernel functions each covers (both routes)
KERNEL_NAMES = (("k1_flash_fwd", ("flash_fwd_f32mma_kernel",
                                   "flash_fwd_mma_kernel")),
                ("k2_flash_bwd_dq", ("flash_bwd_dq_f32mma_kernel",
                                     "flash_bwd_dq_mma_kernel")),
                ("k3_flash_bwd_dkv", ("flash_bwd_dkv_f32mma_kernel",
                                      "flash_bwd_dkv_mma_kernel")))
# the tensor-core kernels, whose SASS must hold HMMA instructions: all
MMA_KERNELS = tuple(kern for _, kerns in KERNEL_NAMES for kern in kerns)
# kernel symbol -> the constexprs of its source that give its tile's q
# rows and keys, where the planted faults are placed
TILE_CONSTEXPRS = {sym: ("BLOCK_M", "BLOCK_N")
                   for sym in ("flash_fwd_f32mma", "flash_fwd_mma",
                               "flash_bwd_dq_f32mma", "flash_bwd_dq_mma",
                               "flash_bwd_dkv_f32mma", "flash_bwd_dkv_mma")}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, torch, iters=20, flush=None):
    """Mean device time of ``fn`` in ms, by CUDA events around each
    call; ``flush`` (a large buffer) is rewritten before every call so
    each call finds a cold L2, as a layer of the model does."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def allclose_err(got, want, tol):
    rtol, atol = tol
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    return ok, float(err.max())


def kernel_err(got, want):
    """A kernel output against its plain version, in the tier of the
    output's type: (ok, max abs err, worst err / limit)."""
    wf = want.float()
    if want.element_size() >= 4:
        rtol, atol = TOL_F32
    else:
        rtol = TOL_HALF_RTOL
        atol = TOL_HALF_RMS * float(wf.square().mean().sqrt())
    err = (got.float() - wf).abs()
    ratio = float((err / (atol + rtol * wf.abs())).max())
    return ratio <= 1.0, float(err.max()), ratio


TOL_TEXT = (f"f32 rtol={TOL_F32[0]} atol={TOL_F32[1]}; bf16/fp16 "
            f"rtol={TOL_HALF_RTOL} atol={TOL_HALF_RMS} x rms")


def attention_bound_ms(bh, tq, tk, d, rates, causal, itemsize,
                       kind="fwd"):
    """Least time for one call of K1 (``kind`` "fwd"), K2 ("dq") or K3
    ("dkv"): each input read once and each output written once, against
    the FLOPs this call's mask leaves per visible (row, key) pair, 2*d a
    product (:data:`PRODUCTS`) — K1 4*d (QK^T, PV), K2 6*d (QK^T,
    dO V^T, dS K), K3 8*d (QK^T, dO V^T, P^T dO, dS^T Q) — each product
    at its rate: ``rates`` names one rate of PEAK_FLOPS for all, or is a
    tuple of one a product."""
    q_bytes, kv_bytes = bh * tq * d * itemsize, bh * tk * d * itemsize
    row_bytes = bh * tq * 4                          # lse / delta, f32
    nbytes = {
        # q, k, v in; o, lse out
        "fwd": 2 * q_bytes + 2 * kv_bytes + row_bytes,
        # q, k, v, do, lse, delta in; dq out
        "dq": 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,
        # q, k, v, do, lse, delta in; dk, dv out
        "dkv": 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes,
    }[kind]
    if isinstance(rates, str):
        rates = (rates,) * len(PRODUCTS[kind])
    if causal:
        rows = np.arange(tq)
        vis = np.clip(rows + (tk - tq) + 1, 0, tk)
        vis = np.where(rows + (tk - tq) < 0, tk, vis)  # fully masked: all
        pairs = int(vis.sum())
    else:
        pairs = tq * tk
    product_flops = 2.0 * bh * d * pairs
    flops = product_flops * len(rates)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_flops = sum(product_flops / PEAK_FLOPS[r] for r in rates)
    return (max(t_bytes, t_flops) * 1e3,
            "bytes" if t_bytes >= t_flops else "operations",
            nbytes, flops)


def attention_inputs(torch, gen, dev, bh, tq, tk, d, dt):
    q = (torch.randn(bh, tq, d, generator=gen, device=dev) * 0.5).to(dt)
    k = (torch.randn(bh, tk, d, generator=gen, device=dev) * 0.5).to(dt)
    v = (torch.randn(bh, tk, d, generator=gen, device=dev) * 0.5).to(dt)
    do = torch.randn(bh, tq, d, generator=gen, device=dev).to(dt)
    return q, k, v, do


def phase_kernels(torch, fa, seed):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    bh_train = TRAIN_BATCH * 32
    # (label, bh, tq, tk, d, dtype, causal); bf16/fp16 run the 16-bit
    # tensor-core K1, K2 and K3, float32 the split-operand ones
    cases = [
        ("serving T=128", 4 * 32, 128, 128, 128, bf16, True),
        ("serving T=256", 4 * 32, 256, 256, 128, bf16, True),
        ("f32 serving T=128", 4 * 32, 128, 128, 128, f32, True),
        ("f32 serving T=256", 4 * 32, 256, 256, 128, f32, True),
        (TRAIN_LABEL, bh_train, TRAIN_SEQ, TRAIN_SEQ, 128, bf16, True),
        ("f32 causal", 8, 256, 256, 128, f32, True),
        ("f32 non-causal", 8, 256, 256, 128, f32, False),
        ("f32 tq<tk causal", 8, 128, 256, 128, f32, True),
        ("f32 tq>tk causal (fully masked rows)", 8, 256, 128, 128, f32,
         True),
        ("f32 ragged T=200 causal", 8, 200, 200, 128, f32, True),
        ("f32 ragged T=200 non-causal", 8, 200, 200, 128, f32, False),
        ("f32 D=64 causal", 8, 256, 256, 64, f32, True),
        ("bf16 tq<tk causal", 8, 128, 256, 128, bf16, True),
        ("bf16 tq>tk causal (fully masked rows)", 8, 256, 128, 128, bf16,
         True),
        ("bf16 ragged T=200 causal", 8, 200, 200, 128, bf16, True),
        ("bf16 ragged T=200 non-causal", 8, 200, 200, 128, bf16, False),
        ("bf16 D=64 causal", 8, 256, 256, 64, bf16, True),
        ("bf16 D=64 non-causal", 8, 256, 256, 64, bf16, False),
        ("fp16 ragged T=200 causal", 8, 200, 200, 128, f16, True),
        ("fp16 ragged T=200 non-causal", 8, 200, 200, 128, f16, False),
        ("fp16 D=64 causal", 8, 256, 256, 64, f16, True),
        (F32_LONG_LABEL, bh_train, TRAIN_SEQ, TRAIN_SEQ, 128, f32, True),
    ]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    results = {}
    failures = []
    for label, bh, tq, tk, d, dt, causal in cases:
        q, k, v, do = attention_inputs(torch, gen, dev, bh, tq, tk, d, dt)
        scale = 1.0 / np.sqrt(d)
        fa.reset_launch_counts()
        o, lse = fa.flash_fwd(q, k, v, scale, causal)
        torch.cuda.synchronize()
        # K1's plain version rounds scores and probabilities to the
        # input type; evaluated in float32 it rounds only its output
        o_ref, lse_ref = fa.ref_attention_lse(q.float(), k.float(),
                                              v.float(), scale, causal)
        pairs = {"O": (o, o_ref.to(dt)), "lse": (lse, lse_ref)}
        del o_ref, lse_ref
        # K2 and K3 on the forward's own lse and delta, each output
        # checked on its own against the plain versions on those inputs
        delta = (do.float() * o.float()).sum(-1)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, scale, causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
        torch.cuda.synchronize()
        ran = check_variants(torch, fa, dt, d)
        pairs["dQ"] = (dq, fa.ref_flash_bwd_dq(q, k, v, do, lse, delta,
                                               scale, causal))
        want_k, want_v = fa.ref_flash_bwd_dkv(q, k, v, do, lse, delta,
                                              scale, causal)
        pairs["dK"], pairs["dV"] = (dk, want_k), (dv, want_v)
        errs = {n: kernel_err(g, w) for n, (g, w) in pairs.items()}
        finite = all(bool(torch.isfinite(g).all()) for g, _ in pairs.values())
        ok = finite and all(e[0] for e in errs.values())
        log(f"K1-3 {label}: bh={bh} tq={tq} tk={tk} d={d} {dt} "
            f"causal={causal} ({', '.join(ran)}): max abs err (err/limit) "
            + ", ".join(f"{n} {e:.3e} ({r:.3f})"
                        for n, (_, e, r) in errs.items())
            + f" ({TOL_TEXT}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            failures.append(label)
        results[label] = dict(
            inputs=(q, k, v, do, causal),
            err_fwd=max(errs["O"][1], errs["lse"][1]), err_dq=errs["dQ"][1],
            err_dkv=max(errs["dK"][1], errs["dV"][1]))
        if label == TRAIN_LABEL and ok:
            check_planted_faults(torch, fa, (q, k, v, do, lse, delta), scale,
                                 pairs, errs)
        if label in F32_FAULT_CASES and ok:
            check_planted_f32_faults(torch, fa, label,
                                     (q, k, v, do, lse, delta), scale,
                                     pairs, errs)
        del o, lse, delta, dq, dk, dv, pairs, want_k, want_v
    check(not failures,
          f"K1/K2/K3 disagree with their plain versions: {failures}")
    check_lse_gradient(torch, fa, gen, dev)
    check_big_bh(torch, fa, gen, dev)

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB
    timing = {}
    for label, kinds in (("serving T=256", ("fwd",)),
                         ("f32 serving T=256", ("fwd",)),
                         (TRAIN_LABEL, ("fwd", "dq", "dkv")),
                         ("f32 causal", ("fwd", "dq", "dkv")),
                         (F32_LONG_LABEL, ("fwd", "dq", "dkv"))):
        timing.update(time_kernels(torch, fa, results[label], label, kinds,
                                   flush))
    del flush, results
    return timing


def check_variants(torch, fa, dt, d, launches=1):
    """Each wrapper launched ``launches`` kernels (one call, in that many
    B*H chunks) since the counts were reset, all of the variant
    ``kernel_for`` names for ``dt``; returns the variants' symbols."""
    ran = []
    for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        _, sym = fa.kernel_for(w.__name__, dt, d)
        want = F32_KERNELS[w.__name__]
        check(dt != torch.float32 or sym == want,
              f"float32 {w.__name__} routes to {sym}, not {want}")
        by = w.launches_by_kernel
        check(w.launches == launches and by[sym] == launches
              and not by[fa.PLAIN],
              f"{w.__name__} on {dt}: launches {by}, expected {launches} "
              f"of {sym}")
        ran.append(sym)
    return ran


def time_kernels(torch, fa, r, label, kinds, flush):
    """Time the wrappers of ``kinds`` ("fwd" K1, "dq" K2, "dkv" K3) on
    case ``r``'s inputs (cold L2), beside their plain versions, SDPA's
    forward or backward and their bounds. Returns {(kind, label): row}."""
    q, k, v, do, causal = r["inputs"]
    bh, t, d = q.shape
    scale = 1.0 / np.sqrt(d)
    dt_name = str(q.dtype).rsplit(".", 1)[-1]
    heads = 32 if bh % 32 == 0 else bh
    q4, k4, v4, do4 = (x.view(bh // heads, heads, t, d)
                       for x in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    o, lse = fa.flash_fwd(q, k, v, scale, causal)
    delta = (do.float() * o.float()).sum(-1)
    lib_ms = {"fwd": time_ms(lambda: sdpa(q4, k4, v4, is_causal=causal),
                             torch, flush=flush)}
    if set(kinds) - {"fwd"}:
        # SDPA's backward (dQ, dK and dV in one call) on a saved graph
        qg, kg, vg = (x.detach().clone().requires_grad_()
                      for x in (q4, k4, v4))
        out = sdpa(qg, kg, vg, is_causal=causal)
        lib_ms["dq"] = lib_ms["dkv"] = time_ms(
            lambda: torch.autograd.grad(out, (qg, kg, vg), do4,
                                        retain_graph=True),
            torch, flush=flush)
        del out, qg, kg, vg
    bwd = (q, k, v, do, lse, delta, scale, causal)
    calls = {
        "fwd": ("flash_fwd", "err_fwd",
                lambda: fa.flash_fwd(q, k, v, scale, causal),
                lambda: fa.ref_attention_lse(q, k, v, scale, causal), 20),
        "dq": ("flash_bwd_dq", "err_dq", lambda: fa.flash_bwd_dq(*bwd),
               lambda: fa.ref_flash_bwd_dq(*bwd), 5),
        "dkv": ("flash_bwd_dkv", "err_dkv", lambda: fa.flash_bwd_dkv(*bwd),
                lambda: fa.ref_flash_bwd_dkv(*bwd), 5),
    }
    rows = {}
    for kind in kinds:
        wrapper, err, kern, plain, plain_iters = calls[kind]
        ms = time_ms(kern, torch, flush=flush)
        plain_ms = time_ms(plain, torch, iters=plain_iters, flush=flush)
        symbol = fa.kernel_for(wrapper, q.dtype, d)[1]
        rates = RATE_OF_KERNEL.get(symbol, (dt_name,) * len(PRODUCTS[kind]))
        bound, by, nbytes, flops = attention_bound_ms(
            bh, t, t, d, rates, causal, q.element_size(), kind)
        at_rate = ", ".join(f"{prod} at {PEAK_FLOPS[r] / 1e12:.1f} TFLOP/s"
                            f" {r}" for prod, r in zip(PRODUCTS[kind], rates))
        rows[(kind, label)] = dict(
            kernel=symbol, ms=ms, plain_ms=plain_ms,
            library_ms=lib_ms[kind], bound_ms=bound, bound_by=by,
            max_abs_err=r[err])
        also = ""
        if symbol in RATE_OF_KERNEL:
            # the same work with every product at the 3xbf16 rate: one
            # yardstick for any float32 design, whichever splits it takes
            rows[(kind, label)]["bound_3xbf16_ms"] = attention_bound_ms(
                bh, t, t, d, F32_SPLIT_RATE, causal, q.element_size(),
                kind)[0]
            also = (f" (every product at 3xbf16: "
                    f"{rows[(kind, label)]['bound_3xbf16_ms']:.4f} ms)")
        log(f"{symbol} {label} timing (cold L2): kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa "
            f"{'forward' if kind == 'fwd' else 'backward (dQ, dK, dV)'} "
            f"{lib_ms[kind]:.4f} ms, bound {bound:.4f} ms by {by}{also} "
            f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP: {at_rate})")
    del o, lse, delta
    return rows


def kernel_tile(fa, wrapper, dtype, d=128):
    """(q rows, keys) of a tile of the kernel ``wrapper`` launches on
    ``dtype``, read from its source's constexprs."""
    from paddle_tpu_torch.ops import cuda_build
    lib, sym = fa.kernel_for(wrapper, dtype, d)
    values = cuda_build.constexprs(lib)
    return tuple(values[name] for name in TILE_CONSTEXPRS[sym])


def planted_fault_tiles(torch, fa):
    """(q rows, keys) of a tile of each kernel the bf16 training shape
    runs (K1, K2 and K3 on the tensor cores)."""
    return {w: kernel_tile(fa, w, torch.bfloat16)
            for w in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}


def check_planted_faults(torch, fa, inputs, scale, pairs, errs):
    """The bf16 tier must catch what a grid or tile-loop fault leaves at
    the training shape (causal, tq = tk = T), where late rows and keys
    hold the smallest values: each fault is planted in a copy of a
    kernel's output and must fail the check the kernel passed. Tiles are
    those of the kernels that ran (:func:`planted_fault_tiles`)."""
    q, k, v, do, lse, delta = inputs
    bh, t, d = q.shape
    tiles = planted_fault_tiles(torch, fa)
    fwd_rows, _ = tiles["flash_fwd"]
    dq_rows, dq_keys = tiles["flash_bwd_dq"]
    dkv_rows, dkv_keys = tiles["flash_bwd_dkv"]

    def last_tile_lost(x, n):
        x = x.clone()
        x[:, -n:] = 0
        return x

    def minus(x, part):
        return (x.float() - part.float().reshape(x.shape)).to(x.dtype)

    # K2 stops one k tile early: under causal the last k tile of q tile
    # i is keys [(i + 1) dq_rows - dq_keys, (i + 1) dq_rows), whose share
    # of dQ is the plain dQ of those rows against those keys (the masks
    # align bottom-right)
    nt = t // dq_rows
    q_t, do_t = (x.view(bh, nt, dq_rows, d) for x in (q, do))
    k_t, v_t = (x.view(bh, nt, dq_rows // dq_keys, dq_keys, d)[:, :, -1]
                for x in (k, v))
    lse_t, delta_t = (x.view(bh, nt, dq_rows) for x in (lse, delta))
    dq_last_k = fa.ref_flash_bwd_dq(q_t, k_t, v_t, do_t, lse_t, delta_t,
                                    scale, True)
    # K3 stops one q tile early: every k tile's loop ends at rows
    # [T - dkv_rows, T)
    dk_last_q, dv_last_q = fa.ref_flash_bwd_dkv(
        q[:, -dkv_rows:], k, v, do[:, -dkv_rows:], lse[:, -dkv_rows:],
        delta[:, -dkv_rows:], scale, True)
    (o, _), (dq, _), (dk, _), (dv, _) = (pairs[n]
                                         for n in ("O", "dQ", "dK", "dV"))
    faults = (
        ("O", f"K1 leaves its last {fwd_rows}-row q tile unwritten",
         last_tile_lost(o, fwd_rows)),
        ("dQ", f"K2 leaves its last {dq_rows}-row q tile unwritten",
         last_tile_lost(dq, dq_rows)),
        ("dQ", f"K2 skips each q tile's last {dq_keys}-key tile",
         minus(dq, dq_last_k)),
        ("dK", f"K3 leaves its last {dkv_keys}-key tile unwritten",
         last_tile_lost(dk, dkv_keys)),
        ("dV", f"K3 leaves its last {dkv_keys}-key tile unwritten",
         last_tile_lost(dv, dkv_keys)),
        ("dK", f"K3 skips its last {dkv_rows}-row q tile",
         minus(dk, dk_last_q)),
        ("dV", f"K3 skips its last {dkv_rows}-row q tile",
         minus(dv, dv_last_q)),
    )
    for name, what, bad in faults:
        _, err, ratio = kernel_err(bad, pairs[name][1])
        log(f"planted fault, {TRAIN_LABEL}: {what}: {name} max abs err "
            f"{err:.3e}, err/limit {ratio:.3f} (the kernel's own "
            f"{errs[name][2]:.3f}) {'caught' if ratio > 1 else 'MISSED'}")
        check(ratio > 1.0, f"the bf16 tier does not catch a planted fault "
                           f"({what}: {name} err/limit {ratio:.3f})")


def check_planted_f32_faults(torch, fa, label, inputs, scale, pairs,
                             errs):
    """The float32 tier must catch what a grid or tile-loop fault of each
    float32 kernel leaves at a causal case (tq = tk): each fault is
    planted in a copy of the kernel's output and must fail the check the
    kernel passed, at the kernel's own tile (read from its source's
    constexprs) — K1 and K2 leaving their last q tile unwritten or
    skipping each q tile's last visited key tile, K3 leaving its last
    key tile unwritten or skipping its last q tile."""
    q, k, v, do, lse, delta = inputs
    tq, tk, d = q.shape[1], k.shape[1], q.shape[2]
    rows_i = torch.arange(tq, device=q.device)
    cols = torch.arange(tk, device=q.device)[None, :]

    def last_tile_lost(x, n):
        x = x.clone()
        x[:, (x.shape[1] - 1) // n * n:] = 0
        return x

    def last_key_tile(rows, keys, last_row):
        """[tq, tk]: the keys of the last key tile the q tile of each row
        visits, whose loop ends at the causal limit of ``last_row`` (the
        tile's last row) — K1's and K2's loop bound."""
        last = ((last_row(rows_i // rows * rows) + tk - tq) // keys) \
            .clamp(max=(tk - 1) // keys)
        return cols // keys == last[:, None]

    faults = []
    rows, keys = kernel_tile(fa, "flash_fwd", torch.float32, d)
    # K1: the skipped keys leave the softmax of the tile's rows
    skipped = last_key_tile(rows, keys, lambda q0: q0 + rows - 1)
    bias = torch.zeros(tq, tk, device=q.device).masked_fill(skipped,
                                                            -math.inf)
    skip_o, _ = fa.ref_attention_lse(q, k, v, scale, True, bias)
    faults += [("O", f"K1 f32 leaves its last {rows}-row q tile unwritten",
                last_tile_lost(pairs["O"][0], rows)),
               ("O", f"K1 f32 skips each q tile's last {keys}-key tile",
                skip_o)]
    del skip_o, bias
    # K2: the skipped keys' share of dQ, dS K over those keys
    rows, keys = kernel_tile(fa, "flash_bwd_dq", torch.float32, d)
    skipped = last_key_tile(rows, keys,
                            lambda q0: (q0 + rows).clamp(max=tq) - 1)
    _, ds = fa._ref_p_ds(q, k, v, do, lse, delta, scale, True)
    lost_dq = torch.einsum("bqk,bkd->bqd", ds * skipped, k.float())
    del ds
    dq = pairs["dQ"][0]
    faults += [("dQ", f"K2 f32 leaves its last {rows}-row q tile unwritten",
                last_tile_lost(dq, rows)),
               ("dQ", f"K2 f32 skips each q tile's last {keys}-key tile",
                dq - lost_dq)]
    # K3: the last q tile's share of dK and dV
    rows, keys = kernel_tile(fa, "flash_bwd_dkv", torch.float32, d)
    r0 = (tq - 1) // rows * rows
    lost_dk, lost_dv = fa.ref_flash_bwd_dkv(
        q[:, r0:], k, v, do[:, r0:], lse[:, r0:], delta[:, r0:], scale, True)
    for name, lost in (("dK", lost_dk), ("dV", lost_dv)):
        got = pairs[name][0]
        faults += [(name, f"K3 f32 leaves its last {keys}-key tile "
                          f"unwritten", last_tile_lost(got, keys)),
                   (name, f"K3 f32 skips its last {rows}-row q tile",
                    got - lost)]
    for name, what, bad in faults:
        _, err, ratio = kernel_err(bad, pairs[name][1])
        log(f"planted fault, {label}: {what}: {name} max abs err "
            f"{err:.3e}, err/limit {ratio:.3f} (the kernel's own "
            f"{errs[name][2]:.3f}) {'caught' if ratio > 1 else 'MISSED'}")
        check(ratio > 1.0, f"the f32 tier does not catch a planted fault "
                           f"({label}: {what}: {name} err/limit "
                           f"{ratio:.3f})")


def check_big_bh(torch, fa, gen, dev):
    """B*H = BIG_BH, one past gridDim.y's 65535, which the launchers take
    in chunks: K1, K2 and K3 in bf16 and float32 (causal, T = 32,
    D = 64) against their plain versions in the tier of the output's
    type — the slices past the first chunk among them."""
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, do = attention_inputs(torch, gen, dev, BIG_BH, 32, 32, 64,
                                       dt)
        scale = 1.0 / 8
        fa.reset_launch_counts()
        o, lse = fa.flash_fwd(q, k, v, scale, True)
        delta = (do.float() * o.float()).sum(-1)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, scale, True)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True)
        torch.cuda.synchronize()
        # one call a wrapper, launched as two chunks of B*H
        ran = check_variants(torch, fa, dt, 64,
                             launches=-(-BIG_BH // fa.MAX_GRID_Y))
        o_ref, lse_ref = fa.ref_attention_lse(q.float(), k.float(),
                                              v.float(), scale, True)
        want_k, want_v = fa.ref_flash_bwd_dkv(q, k, v, do, lse, delta,
                                              scale, True)
        errs = {"O": kernel_err(o, o_ref.to(dt)),
                "lse": kernel_err(lse, lse_ref),
                "dQ": kernel_err(dq, fa.ref_flash_bwd_dq(
                    q, k, v, do, lse, delta, scale, True)),
                "dK": kernel_err(dk, want_k), "dV": kernel_err(dv, want_v)}
        ok = all(e[0] for e in errs.values())
        log(f"K1-3 bh={BIG_BH} (past gridDim.y) t=32 d=64 {dt} causal "
            f"({', '.join(ran)}): max abs err (err/limit) "
            + ", ".join(f"{n} {e:.3e} ({r:.3f})"
                        for n, (_, e, r) in errs.items())
            + f" {'ok' if ok else 'MISMATCH'}")
        check(ok, f"kernels at bh={BIG_BH} disagree with their plain "
                  f"versions ({dt})")
        del q, k, v, do, o, lse, delta, dq, dk, dv, o_ref, lse_ref
        del want_k, want_v


def check_lse_gradient(torch, fa, gen, dev):
    """attention_with_lse is differentiable in o AND lse: its gradient
    (K1, K2, K3) against plain torch autograd through ref_attention_lse,
    on the card, float32, with fully masked rows (tq > tk) and without."""
    for tq, tk in ((256, 256), (256, 128)):
        q, k, v, do = attention_inputs(torch, gen, dev, 8, tq, tk, 128,
                                       torch.float32)
        dl = torch.randn(8, tq, generator=gen, device=dev)
        q, k, v = (x.view(2, 4, -1, 128) for x in (q, k, v))
        do, dl = do.view(2, 4, tq, 128), dl.view(2, 4, tq)
        grads = []
        for f in (lambda a, b, c: fa.attention_with_lse(a, b, c,
                                                         causal=True),
                  lambda a, b, c: fa.ref_attention_lse(
                      a, b, c, 1.0 / math.sqrt(128), True)):
            ts = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            o, lse = f(*ts)
            loss = (o * do).sum() + (lse * dl).sum()
            grads.append(torch.autograd.grad(loss, ts))
        torch.cuda.synchronize()
        errs = [allclose_err(g, w, TOL_GRAD_F32)
                for g, w in zip(grads[0], grads[1])]
        log(f"attention_with_lse gradient through o and lse, f32 tq={tq} "
            f"tk={tk} causal: max|dq|,|dk|,|dv| = "
            + ", ".join(f"{e:.3e}" for _, e in errs)
            + f" vs plain autograd (rtol={TOL_GRAD_F32[0]}, "
            f"atol={TOL_GRAD_F32[1]})")
        check(all(ok for ok, _ in errs),
              f"attention_with_lse gradient differs from plain autograd "
              f"(tq={tq}, tk={tk})")


def where_the_time_goes(torch, exe, program, fetch, scope, feed):
    """Break one dispatch of ``feed`` down: host wall time with and
    without copying the fetched logits to numpy, and the device's kernel
    time by kind from torch.profiler (K1, matrix products, copies, the
    rest). Diagnostic only — reports "not measured" where the profiler
    sees no device time."""
    def run(return_numpy):
        t0 = time.perf_counter()
        out = exe.run(program, feed=feed, fetch_list=[fetch], scope=scope,
                      return_numpy=return_numpy)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    run(True)
    no_fetch = sorted(run(False)[0] for _ in range(3))[1]
    with_fetch = sorted(run(True)[0] for _ in range(3))[1]
    kinds = device_ms_by_kind(torch, lambda: run(False))
    out = {"feed": {k: list(v.shape) for k, v in feed.items()},
           "wall_ms_device_fetch": no_fetch * 1e3,
           "wall_ms_numpy_fetch": with_fetch * 1e3}
    add_busy(out, kinds, no_fetch * 1e3)
    return out


def device_ms_by_kind(torch, fn):
    """Device time of one call of ``fn`` by kind, from torch.profiler:
    K1/K2/K3, matrix products, copies, the rest — and the rest's eight
    largest kernels by name under ``"other_top"``, and the kernels of a
    train step's optimizer segment (the lowering's profiler range) under
    ``"optimizer_segment"``. None where the profiler sees no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.core.lowering import RANGE_OPTIMIZER

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = dict.fromkeys([k for k, _ in KERNEL_NAMES]
                          + ["matmul", "copy", "other"], 0.0)
    other = {}
    # the optimizer range's mark on the device is a span from its first
    # kernel to its last, not a kernel; the step runs on one stream, so
    # the kernels that start inside it are the optimizer's
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [e.time_range for e in on_device if e.name == RANGE_OPTIMIZER]
    seg = None
    if spans:
        seg = {"span_ms": sum(s.elapsed_us() for s in spans) / 1e3,
               "kernels_ms": sum(
                   e.time_range.elapsed_us() for e in on_device
                   if e.name != RANGE_OPTIMIZER and any(
                       s.start <= e.time_range.start < s.end
                       for s in spans)) / 1e3}
    for e in prof.key_averages():
        if e.key == RANGE_OPTIMIZER:
            continue
        # kernels and copies only: an aten op's device time is its
        # kernels' again
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if not us:
            continue
        name = e.key.lower()
        kind = next((k for k, kerns in KERNEL_NAMES
                     if any(kern in name for kern in kerns)), None)
        if kind is None:
            if any(w in name for w in ("gemm", "nvjet", "cutlass", "xmma",
                                       "matmul")):
                kind = "matmul"
            elif "memcpy" in name or "memset" in name:
                kind = "copy"
            else:
                kind = "other"
                short = e.key.replace("void at::native::", "")[:120]
                other[short] = other.get(short, 0.0) + us / 1e3
        kinds[kind] += us / 1e3
    if not sum(kinds.values()):
        return None
    kinds["other_top"] = sorted(other.items(), key=lambda kv: -kv[1])[:8]
    kinds["optimizer_segment"] = seg
    return kinds


def add_busy(out, kinds, wall_ms):
    """Device busy ms, idle share of ``wall_ms`` and ms by kind into
    ``out`` ("not measured" where the profiler saw no device time)."""
    if kinds is None:
        out["device_busy_ms"] = "not measured"
        return
    seg = kinds.pop("optimizer_segment")
    busy = sum(v for k, v in kinds.items() if k != "other_top")
    if seg is not None:
        out["optimizer_segment"] = seg
    out.update({"device_busy_ms": busy,
                "device_idle_share": 1 - busy / wall_ms,
                "device_ms_by_kind": kinds})


def phase_serve(torch, fluid, dtype, card):
    """Serve the 8B-width forward in ``dtype`` and hold every answer to
    the same request run alone; every K1 launch must go to the variant
    the dtype routes to (bf16: flash_fwd_mma, float32:
    flash_fwd_f32mma). Returns (K1 launches, serve stats).

    The tiers: in float32 each logit within TOL_LOGITS_F32 and the greedy
    token exact. In bfloat16 a 32-layer network amplifies rounding that
    differs between GEMM shapes (a batch of 4 x 128 rows vs 1 x n): the
    logits are held to a relative RMS error of TOL_LOGITS_BF16_RMS, and a
    greedy flip is allowed only where the top-1 margin is within twice
    that row's logit error."""
    from paddle_tpu_torch.models.llama import LLAMA3_8B, build_llama
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.serving import (BucketSpec, ServingConfig,
                                          ServingEngine)

    cfg = dataclasses.replace(LLAMA3_8B, dtype=dtype)   # all 32 layers
    tag = f"serve {dtype}"
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        tokens = fluid.layers.data(name="tokens", shape=[-1, -1],
                                   dtype="int64", append_batch_size=False)
        logits, _ = build_llama(cfg, tokens)
    infer = main.clone(for_test=True)
    scope = fluid.Scope()
    exe = fluid.Executor()                     # the card: CUDAPlace(0)
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in scope.vars.values())
    log(f"{tag}: Llama-3-8B width (dim {cfg.dim}, {cfg.n_layers} layers, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, ffn "
        f"{cfg.ffn_hidden}, vocab {cfg.vocab_size}): "
        f"{n_params / 1e9:.3f} B params, startup on the card "
        f"{time.perf_counter() - t0:.2f} s")

    buckets = BucketSpec(batch_sizes=(1, 2, 4),
                         seq_lens={"tokens": (128, 256)})
    engine = ServingEngine(infer, ["tokens"], [logits], scope=scope,
                           buckets=buckets,
                           config=ServingConfig(max_wait_ms=20.0,
                                                default_timeout_s=600.0))
    rng = np.random.RandomState(SEED)
    lengths = [40, 77, 128, 96, 130, 200, 256, 171]
    reqs = [rng.randint(0, cfg.vocab_size, (1, n)).astype(np.int64)
            for n in lengths]
    torch.cuda.reset_peak_memory_stats()
    try:
        # the main path: counts reset just before, read just after
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        warm = engine.warmup()
        warm_s = time.perf_counter() - t0
        start = threading.Barrier(len(reqs))

        def call(r):
            start.wait()
            return engine.infer({"tokens": r}, timeout=600.0)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(reqs)) as pool:
            answers = list(pool.map(call, reqs))
        wall = time.perf_counter() - t0
        launches = fa.flash_fwd.launches
        by_kernel = dict(fa.flash_fwd.launches_by_kernel)
        stats = engine.stats()
        engine.assert_no_recompiles()
    finally:
        engine.close()
    dispatches = warm["signatures"] + stats["batches_total"]
    log(f"{tag}: warmup {warm['signatures']} bucket signatures in "
        f"{warm_s:.2f} s; {len(reqs)} concurrent requests in "
        f"{stats['batches_total']} batches, no step build after warmup")
    check(stats["responses_total"] == len(reqs),
          f"responses {stats['responses_total']} != {len(reqs)}")
    check(launches == cfg.n_layers * dispatches,
          f"K1 launches {launches} != {cfg.n_layers} layers x "
          f"{dispatches} dispatches")
    _, variant = fa.kernel_for("flash_fwd", getattr(torch, dtype),
                               cfg.dim // cfg.n_heads)
    check(by_kernel[variant] == launches,
          f"K1 launches by kernel {by_kernel}: not all {variant}")
    log(f"{tag}: K1 launched {launches} times = {cfg.n_layers} x "
        f"{dispatches} dispatches, all {variant}")

    worst_abs = worst_rms = 0.0
    for n, r, ans in zip(lengths, reqs, answers):
        got = ans[0]
        bucket = buckets.seq_bucket("tokens", n)
        check(got.shape == (1, bucket, cfg.vocab_size),
              f"answer shape {got.shape}")
        got = got[:, :n]
        check(np.isfinite(got).all(), f"non-finite logits (len {n})")
        alone = exe.run(infer, feed={"tokens": r}, fetch_list=[logits],
                        scope=scope)[0]
        err = np.abs(got - alone)
        rel_rms = float(np.sqrt((err ** 2).mean() / (alone ** 2).mean()))
        worst_abs = max(worst_abs, float(err.max()))
        worst_rms = max(worst_rms, rel_rms)
        g_tok, a_tok = int(got[0, -1].argmax()), int(alone[0, -1].argmax())
        top2 = np.sort(alone[0, -1])[-2:]
        margin = float(top2[1] - top2[0])
        row_err = float(err[0, -1].max())
        log(f"{tag}: request len {n}: vs alone max|d logits| "
            f"{float(err.max()):.3e}, rel rms {rel_rms:.3e}; greedy "
            f"{g_tok} vs {a_tok} (alone top-1 margin {margin:.3e})")
        if dtype == "float32":
            rtol, atol = TOL_LOGITS_F32
            check(bool((err <= atol + rtol * np.abs(alone)).all()),
                  f"len {n}: logits differ from the request run alone "
                  f"beyond rtol={rtol}, atol={atol}")
            check(g_tok == a_tok, f"len {n}: greedy token {g_tok} != "
                                  f"{a_tok} of the request run alone")
        else:
            check(rel_rms <= TOL_LOGITS_BF16_RMS,
                  f"len {n}: logits differ from the request run alone by "
                  f"rel rms {rel_rms:.3e} > {TOL_LOGITS_BF16_RMS}")
            # a flip is explicable only by a logit error of half the margin
            check(g_tok == a_tok or margin <= 2 * row_err,
                  f"len {n}: greedy token {g_tok} != {a_tok} of the "
                  f"request run alone, with top-1 margin {margin:.3e} > 2 "
                  f"x the row's logit error {row_err:.3e}")
    lat = stats["request_latency"]
    long_batch, _, _ = buckets.pad_batch(
        [{"tokens": r} for r, n in zip(reqs, lengths) if n > 128][:4])
    dispatch = where_the_time_goes(torch, exe, infer, logits, scope,
                                   long_batch)
    log(f"{tag}: one dispatch: " + json.dumps(dispatch))
    serve = {"dtype": dtype, "requests": len(reqs), "wall_s": wall,
             "requests_per_s": len(reqs) / wall,
             "p50_ms": lat["p50_ms"], "p99_ms": lat["p99_ms"],
             "batches": stats["batches_total"],
             "batch_p50_ms": stats["batch_latency"]["p50_ms"],
             "k1_launches": launches, "k1_variant": variant,
             "dispatches": dispatches,
             "layers": cfg.n_layers,
             "max_abs_logit_err_vs_alone": worst_abs,
             "max_rel_rms_logit_err_vs_alone": worst_rms,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "card": card}
    log(f"{tag}: " + json.dumps(serve))
    return launches, dict(serve, one_dispatch=dispatch)


def build_train(fluid, cfg, lr, policy=None, **llama_kw):
    """``build_llama(cfg, tokens, targets, **llama_kw)`` →
    ``Adam(lr).minimize``, in fresh programs seeded from SEED, with
    ``memory_optimize(policy)`` where a remat policy is given. Returns
    (main, startup, loss)."""
    from paddle_tpu_torch.models.llama import build_llama
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        tokens = fluid.layers.data(name="tokens", shape=[-1, -1],
                                   dtype="int64", append_batch_size=False)
        targets = fluid.layers.data(name="targets", shape=[-1, -1],
                                    dtype="int64", append_batch_size=False)
        _, loss = build_llama(cfg, tokens, targets, **llama_kw)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    if policy:
        fluid.memory_optimize(main, policy=policy)
    return main, startup, loss


def train_feed(vocab, batch, seq):
    toks = np.random.RandomState(SEED).randint(0, vocab, (batch, seq)) \
        .astype(np.int64)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


def phase_train(torch, fluid, fa, card):
    """Train the 8B-width model, cut to TRAIN_LAYERS layers, in bf16 on
    one fixed batch, unrolled with the full logits (``build_llama``'s
    defaults); every K1, K2 and K3 launch must be the tensor-core
    kernel's, once per layer per step. Returns (launches by kernel
    symbol, train stats)."""
    return train_8b(torch, fluid, fa, card, "train", "l0.wq", 1)


def phase_train_stack(torch, fluid, fa, card, train):
    """The main path of this slice: the reference's own train benchmark
    (``bench.py`` ``transformer_main``: ``build_llama(shard_pp=True,
    fused_head_chunk=2048, remat=True)``, ``Adam(1e-4)``) at the 8B
    width and ``phase_train``'s depth, batch and steps: the layer-stacked
    decoder with each layer recomputed in the backward pass (K1 twice a
    layer a step, K2 and K3 once) and the vocab-chunked fused loss
    (128256 = 62 x 2048 + 1280: 63 chunks, the last slid back by 768
    columns). Its peak memory must be below ``train``'s (phase_train's
    stats, from this run). Returns (launches by kernel symbol, stats)."""
    by_kernel, stats = train_8b(
        torch, fluid, fa, card, "train_stack", "blocks.wq", 2,
        shard_pp=True, fused_head_chunk=STACK_CHUNK, remat=True)
    check(stats["peak_mem_gb"] < train["peak_mem_gb"],
          f"train_stack peak {stats['peak_mem_gb']:.2f} GB is not below "
          f"the unrolled step's {train['peak_mem_gb']:.2f} GB")
    keys = ("step_ms_median", "step_ms_min", "step_ms_max", "tokens_per_s",
            "peak_mem_gb")
    beside = {name: dict({k: st[k] for k in keys},
                         **{k: st["one_step"].get(k, "not measured")
                            for k in ("device_busy_ms", "device_idle_share",
                                      "device_ms_by_kind",
                                      "optimizer_segment")})
              for name, st in (("train", train), ("train_stack", stats))}
    log("train_stack beside train: " + json.dumps(beside))
    return by_kernel, stats


def train_8b(torch, fluid, fa, card, tag, probe_name, k1_per_layer,
             **llama_kw):
    """Train the 8B-width model, cut to TRAIN_LAYERS layers, in bf16 on
    one fixed batch (``build_llama(**llama_kw)``, ``Adam(1e-4)`` as
    bench.py): TRAIN_WARMUP + TRAIN_STEPS steps with finite, falling
    loss, the first near ln V + dim·0.02²/2, K1 launched
    ``k1_per_layer`` times and K2/K3 once per layer per step (each time
    on the tensor cores), ``probe_name`` moved; step time, tokens/s,
    peak memory and one step's device time by kind. Returns (launches by
    kernel symbol, stats)."""
    from paddle_tpu_torch.models.llama import LLAMA3_8B

    cfg = dataclasses.replace(LLAMA3_8B, n_layers=TRAIN_LAYERS)
    main, startup, loss = build_train(fluid, cfg, 1e-4,   # bench.py's lr
                                      **llama_kw)
    scope = fluid.Scope()
    exe = fluid.Executor()                     # the card: CUDAPlace(0)
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in (scope.find_var(v.name)
                                       for v in main.all_parameters()))
    log(f"{tag}: Llama-3-8B width (dim {cfg.dim}, {cfg.n_heads} heads / "
        f"{cfg.n_kv_heads} kv, ffn {cfg.ffn_hidden}, vocab "
        f"{cfg.vocab_size}), {cfg.n_layers} of 32 layers, bf16, Adam, "
        f"build_llama({llama_kw}): {n_params / 1e9:.3f} B params, startup "
        f"on the card {time.perf_counter() - t0:.2f} s")
    feed = train_feed(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)

    def probe():
        w = scope.find_var(probe_name)
        return w.reshape(-1, w.shape[-1])[:8, :8].float().clone()

    before = probe()
    wrappers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    # the main path: counts reset just before, read just after
    fa.reset_launch_counts()
    for step in range(TRAIN_WARMUP + TRAIN_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(np.asarray(out[0]).reshape(())))
        log(f"{tag}: step {step}: loss {losses[-1]:.4f}, "
            f"{step_s[-1] * 1e3:.1f} ms")
    launches = [w.launches for w in wrappers]
    by_kernel = launches_by_kernel(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    check(all(math.isfinite(x) for x in losses),
          f"{tag}: non-finite loss {losses}")
    # random init: logits ~ N(0, dim * INIT_STD^2) (the final rms_norm
    # makes the hidden state's squared norm dim), so the expected first
    # loss is ln V + dim * INIT_STD^2 / 2
    expected = math.log(cfg.vocab_size) + cfg.dim * INIT_STD ** 2 / 2
    check(abs(losses[0] - expected) < 0.5,
          f"{tag}: first loss {losses[0]:.4f} not within 0.5 of "
          f"{expected:.4f} (ln V = {math.log(cfg.vocab_size):.4f})")
    check(losses[-1] < losses[0],
          f"{tag}: loss did not fall: {losses[0]:.4f} -> {losses[-1]:.4f}")
    for name, w, n, per_layer in zip(("K1", "K2", "K3"), wrappers, launches,
                                     (k1_per_layer, 1, 1)):
        check(n == per_layer * cfg.n_layers * n_steps,
              f"{tag}: {name} launched {n} times, not {per_layer} x "
              f"{cfg.n_layers} layers x {n_steps} steps")
        _, variant = fa.kernel_for(w.__name__, torch.bfloat16, 128)
        check(by_kernel[variant] == n,
              f"{tag}: {name} launches by kernel {w.launches_by_kernel}: "
              f"not all {variant}")
    changed = float((probe() - before).abs().max())
    check(changed > 0, f"{tag}: parameter {probe_name} did not change")
    log(f"{tag}: K1/K2/K3 launched {launches} times = ({k1_per_layer}, 1, "
        f"1) x {cfg.n_layers} layers x {n_steps} steps ({by_kernel}); "
        f"{probe_name} moved by up to {changed:.3e}")

    timed = sorted(step_s[TRAIN_WARMUP:])
    step_ms = timed[len(timed) // 2] * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    breakdown = {}
    add_busy(breakdown, device_ms_by_kind(
        torch, lambda: exe.run(main, feed=feed, fetch_list=[loss],
                               scope=scope)), step_ms)
    breakdown.setdefault("optimizer_segment", "not measured")
    stats = {"layers": cfg.n_layers, "params_b": n_params / 1e9,
             "build_llama": llama_kw,
             "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
             "losses": losses, "first_loss_expected": expected,
             "step_ms_median": step_ms,
             "step_ms_min": timed[0] * 1e3, "step_ms_max": timed[-1] * 1e3,
             "tokens_per_s": tokens / (step_ms / 1e3),
             "peak_mem_gb": peak_gb, "launches_k1_k2_k3": launches,
             "launches_by_kernel": by_kernel,
             "one_step": breakdown, "card": card}
    log(f"{tag}: " + json.dumps(stats))
    return by_kernel, stats


def train_card_vs_cpu(torch, fluid, cfg, lr, batch, seq, tag, **llama_kw):
    """One float32 step of ``cfg`` (``build_llama(**llama_kw)``) on the
    card and on the CPU from one startup scope (TF32 off): the loss and
    every parameter's gradient within the f32 gradient tier, then 3 Adam
    steps' losses within the loss tier. Returns the stats."""
    from paddle_tpu_torch import weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    main, startup, loss = build_train(fluid, cfg, lr, **llama_kw)
    gpu_scope = fluid.Scope()
    gpu = fluid.Executor()
    gpu.run(startup, scope=gpu_scope)
    cpu_scope = weights.load_state(fluid.Scope(),
                                   weights.dump_state(gpu_scope),
                                   torch.device("cpu"))
    cpu = fluid.Executor(fluid.CPUPlace())
    feed = train_feed(cfg.vocab_size, batch, seq)
    grads = sorted(v for v in main.global_block().vars
                   if v.endswith("@GRAD"))
    got = gpu.run(main, feed=feed, fetch_list=[loss] + grads,
                  scope=gpu_scope)
    want = cpu.run(main, feed=feed, fetch_list=[loss] + grads,
                   scope=cpu_scope)
    worst = 0.0
    for name, g, w in zip(["loss"] + grads, got, want):
        rtol, atol = TOL_GRAD_F32
        err = np.abs(g - w)
        check(bool((err <= atol + rtol * np.abs(w)).all()),
              f"{tag}: {name} on the card differs from the CPU by "
              f"{float(err.max()):.3e} (rtol={rtol}, atol={atol})")
        worst = max(worst, float((err / (atol + rtol * np.abs(w))).max()))
    lg, lc = [], []
    for _ in range(3):
        lg.append(float(gpu.run(main, feed=feed, fetch_list=[loss],
                                scope=gpu_scope)[0].reshape(())))
        lc.append(float(cpu.run(main, feed=feed, fetch_list=[loss],
                                scope=cpu_scope)[0].reshape(())))
    check(np.allclose(lg, lc, rtol=TOL_LOSS_F32, atol=0),
          f"{tag}: Adam losses differ: card {lg} vs CPU {lc}")
    return {"config": dataclasses.asdict(cfg), "build_llama": llama_kw,
            "batch": [batch, seq],
            "loss_step1": [float(got[0].reshape(())),
                           float(want[0].reshape(()))],
            "grads_checked": len(grads),
            "worst_err_over_tolerance": worst,
            "adam_losses_card": lg, "adam_losses_cpu": lc}


def launches_by_kernel(fa):
    """{kernel symbol: launches} over the three wrappers, and the plain
    route's calls under "<wrapper> plain"."""
    return {(f"{w.__name__} {sym}" if sym == fa.PLAIN else sym): n
            for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
            for sym, n in w.launches_by_kernel.items()}


def phase_train_parity(torch, fluid, fa, card):
    """One float32 step of a narrow model with head dim 128 on the card
    (K1, K2 and K3 on flash_fwd_f32mma, flash_bwd_dq_f32mma and
    flash_bwd_dkv_f32mma: 2 layers x 4 steps, 8 launches each) and on
    the CPU (the plain versions), from one startup scope: the loss and
    every parameter's gradient within the f32 gradient tier, then 3 Adam
    steps' losses within the loss tier. Returns (launches by kernel
    symbol, stats)."""
    from paddle_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(vocab_size=2048, dim=512, n_layers=2, n_heads=4,
                      n_kv_heads=2, ffn_hidden=1024, dtype="float32")
    # this path's counts: reset just before, read after its last step
    fa.reset_launch_counts()
    out = train_card_vs_cpu(torch, fluid, cfg, 1e-3, 2, 256,
                            "train parity f32")
    by_kernel = launches_by_kernel(fa)
    for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        variant = F32_KERNELS[w.__name__]
        check(w.launches == cfg.n_layers * 4
              and by_kernel[variant] == w.launches,
              f"f32 {w.__name__} launches by kernel "
              f"{w.launches_by_kernel}: not {cfg.n_layers} layers x 4 "
              f"steps of {variant}")
    out.update(launches_by_kernel=by_kernel, card=card)
    log("train parity f32: " + json.dumps(out))
    return by_kernel, out


PARITY_CFG = dict(vocab_size=2048, dim=512, n_layers=2, n_heads=4,
                  n_kv_heads=2, ffn_hidden=1024, dtype="float32")


def phase_train_stack_parity(torch, fluid, fa, card):
    """The float32 parity model (``phase_train_parity``'s) built as
    ``phase_train_stack`` builds the 8B one — stacked, remat, its fused
    loss in chunks of PARITY_CHUNK (the last slides back) — on the card
    (K1 twice a layer a step, K2 and K3 once, on the ``_f32mma``
    kernels) against the CPU at the f32 tiers. Then the same step on the
    card with ``remat=False`` and under ``memory_optimize`` with
    ``nothing_saveable`` and ``dots_saveable`` (a checkpoint of the
    whole forward around each layer's own) gives the loss and gradients
    of ``remat=True`` within the f32 gradient tier; whether they are
    bit-identical is reported. Returns (launches by kernel symbol,
    stats)."""
    from paddle_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(**PARITY_CFG)
    stack = dict(shard_pp=True, fused_head_chunk=PARITY_CHUNK, remat=True)
    fa.reset_launch_counts()
    out = train_card_vs_cpu(torch, fluid, cfg, 1e-3, 2, 256,
                            "train_stack parity f32", **stack)
    by_kernel = launches_by_kernel(fa)
    for w, per_layer in zip((fa.flash_fwd, fa.flash_bwd_dq,
                             fa.flash_bwd_dkv), (2, 1, 1)):
        variant = F32_KERNELS[w.__name__]
        check(w.launches == per_layer * cfg.n_layers * 4
              and by_kernel[variant] == w.launches,
              f"train_stack parity f32: {w.__name__} launches by kernel "
              f"{w.launches_by_kernel}: not {per_layer} x {cfg.n_layers} "
              f"layers x 4 steps of {variant}")

    feed = train_feed(cfg.vocab_size, 2, 256)
    variants = {"remat": dict(stack),
                "no_remat": dict(stack, remat=False),
                "nothing_saveable": dict(stack, policy="nothing_saveable"),
                "dots_saveable": dict(stack, policy="dots_saveable")}
    results = {}
    for name, kw in variants.items():
        main, startup, loss = build_train(fluid, cfg, 1e-3, **kw)
        scope = fluid.Scope()
        exe = fluid.Executor()
        exe.run(startup, scope=scope)
        grads = sorted(v for v in main.global_block().vars
                       if v.endswith("@GRAD"))
        fa.reset_launch_counts()
        results[name] = (grads, exe.run(main, feed=feed,
                                        fetch_list=[loss] + grads,
                                        scope=scope),
                         fa.flash_fwd.launches)
    grads, want, _ = results["remat"]
    rtol, atol = TOL_GRAD_F32
    same = {}
    for name, (g_names, got, k1) in results.items():
        check(g_names == grads, f"{name}: other gradients {g_names}")
        for n, g, w in zip(["loss"] + grads, got, want):
            err = np.abs(g - w)
            check(bool((err <= atol + rtol * np.abs(w)).all()),
                  f"train_stack parity f32 {name}: {n} differs from "
                  f"remat=True by {float(err.max()):.3e}")
        same[name] = {"bit_identical": all(np.array_equal(g, w)
                                           for g, w in zip(got, want)),
                      "max_abs_diff": max(float(np.abs(g - w).max())
                                          for g, w in zip(got, want)),
                      "k1_launches": k1}
    # K1 a layer: once without remat, twice with, three times when the
    # whole forward's checkpoint nests around each layer's
    for name, k1 in (("no_remat", 1), ("remat", 2),
                     ("nothing_saveable", 3), ("dots_saveable", 3)):
        check(same[name]["k1_launches"] == k1 * cfg.n_layers,
              f"{name}: K1 launched {same[name]['k1_launches']} times, "
              f"not {k1} x {cfg.n_layers} layers")
    out.update(launches_by_kernel=by_kernel, remat_variants=same,
               card=card)
    log("train_stack parity f32: " + json.dumps(out))
    return by_kernel, out


def phase_amp(torch, fluid, fa, card):
    """AMP on the 8B width, cut to AMP_LAYERS layers, float32 master
    state: the unrolled program and the stacked one (``phase_train_
    stack``'s knobs), each under ``amp_transpile`` O1 and O2 for
    AMP_STEPS Adam steps on one batch of 2 x 2048 from a fresh startup:
    finite, falling losses; K1-K3 on the bf16 tensor-core kernels (the
    f32 program's products run in bf16, attention among them); every
    parameter and Adam moment still float32; and the first loss against
    the same program's forward without AMP (float32, TF32 off) within
    the bf16 tier TOL_HALF_RTOL. Returns (launches by kernel symbol of
    each run, stats)."""
    from paddle_tpu_torch.models.llama import LLAMA3_8B

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(LLAMA3_8B, n_layers=AMP_LAYERS,
                              dtype="float32")
    feed = train_feed(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    wrappers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    out, launches = {}, {}
    for model, kw, k1_per_layer in (
            ("unrolled", {}, 1),
            ("stacked", dict(shard_pp=True, fused_head_chunk=STACK_CHUNK,
                             remat=True), 2)):
        main, startup, loss = build_train(fluid, cfg, 1e-4, **kw)

        def fresh():
            # a fresh Executor draws the startup's numbers anew: the same
            # initial state for every run
            scope = fluid.Scope()
            exe = fluid.Executor()
            exe.run(startup, scope=scope)
            return scope, exe

        scope, exe = fresh()
        ref = float(np.asarray(exe.run(
            main.clone(for_test=True), feed=feed, fetch_list=[loss],
            scope=scope)[0]).reshape(()))
        del scope, exe
        free_card(torch)
        for level in ("O1", "O2"):
            tag = f"amp {model} {level}"
            prog = fluid.transpiler.amp_transpile(main.clone(), level=level)
            scope, exe = fresh()
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            losses = [float(np.asarray(exe.run(
                prog, feed=feed, fetch_list=[loss],
                scope=scope)[0]).reshape(())) for _ in range(AMP_STEPS)]
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            by_kernel = launches_by_kernel(fa)
            check(all(math.isfinite(x) for x in losses),
                  f"{tag}: non-finite loss {losses}")
            check(losses[-1] < losses[0],
                  f"{tag}: loss did not fall: {losses}")
            check(abs(losses[0] - ref) <= TOL_HALF_RTOL * abs(ref),
                  f"{tag}: first loss {losses[0]:.5f} vs {ref:.5f} without "
                  f"AMP (rtol {TOL_HALF_RTOL})")
            for name, w, per_layer in zip(("K1", "K2", "K3"), wrappers,
                                          (k1_per_layer, 1, 1)):
                _, variant = fa.kernel_for(w.__name__, torch.bfloat16, 128)
                n = per_layer * cfg.n_layers * AMP_STEPS
                check(w.launches == n and by_kernel[variant] == n,
                      f"{tag}: {name} launches by kernel "
                      f"{w.launches_by_kernel}: not {n} of {variant}")
            state = {v.name: scope.find_var(v.name).dtype
                     for v in main.global_block().vars.values()
                     if v.persistable and scope.find_var(v.name) is not None
                     and scope.find_var(v.name).is_floating_point()}
            check(all(dt == torch.float32 for dt in state.values()),
                  f"{tag}: state not float32: "
                  f"{ {k: str(v) for k, v in state.items()} }")
            check(any("moment1" in n for n in state),
                  f"{tag}: no Adam moment in the scope")
            out[tag] = {"losses": losses, "first_loss_without_amp": ref,
                        "first_loss_rel_diff": abs(losses[0] - ref) / abs(ref),
                        "steps_s": took, "float32_state": len(state),
                        "launches_by_kernel": by_kernel}
            launches[tag] = by_kernel
            del scope, exe
            free_card(torch)
    out = {"layers": cfg.n_layers, "batch": [TRAIN_BATCH, TRAIN_SEQ],
           "runs": out, "card": card}
    log("amp: " + json.dumps(out))
    return launches, out


def phase_nan_guard(torch, fluid, fa, card):
    """The NaN guard on the card, on ``phase_train_stack_parity``'s
    stacked float32 model: with clean weights the guarded step equals
    the unguarded one (loss and every gradient within the f32 gradient
    tier; which are bit-identical is reported); with one
    planted inf in ``blocks.wq`` ``Executor.run`` raises
    FloatingPointError naming the same op outputs as the CPU run of the
    same step; ``repeats=2`` raises ValueError."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(**PARITY_CFG)
    main, startup, loss = build_train(
        fluid, cfg, 1e-3, shard_pp=True, fused_head_chunk=PARITY_CHUNK,
        remat=True)
    guarded = fluid.debugger.enable_nan_guard(main.clone())
    gpu = fluid.Executor()
    cpu = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    gpu.run(startup, scope=scope)
    state = weights.dump_state(scope)
    feed = train_feed(cfg.vocab_size, 2, 256)
    grads = sorted(v for v in main.global_block().vars
                   if v.endswith("@GRAD"))
    plain_scope = weights.load_state(fluid.Scope(), state, gpu.device)
    got = gpu.run(guarded, feed=feed, fetch_list=[loss] + grads,
                  scope=scope)
    want = gpu.run(main, feed=feed, fetch_list=[loss] + grads,
                   scope=plain_scope)
    rtol, atol = TOL_GRAD_F32
    for n, g, w in zip(["loss"] + grads, got, want):
        err = np.abs(g - w)
        check(bool((err <= atol + rtol * np.abs(w)).all()),
              f"nan_guard: {n} of the guarded step differs from the "
              f"unguarded one's by {float(err.max()):.3e}")
    # the embedding's gradient sums rows in an order the device picks
    identical = [n for n, g, w in zip(["loss"] + grads, got, want)
                 if np.array_equal(g, w)]

    wq = state["blocks.wq"].copy()
    wq[0, 0, 0] = np.inf
    messages = {}
    for name, exe, dev in (("card", gpu, gpu.device),
                           ("cpu", cpu, torch.device("cpu"))):
        sc = weights.load_state(fluid.Scope(), dict(state, **{
            "blocks.wq": wq}), dev)
        try:
            exe.run(guarded, feed=feed, fetch_list=[loss], scope=sc)
        except FloatingPointError as e:
            messages[name] = str(e)
        check(name in messages, f"nan_guard: no FloatingPointError on the "
                                f"{name} with an inf in blocks.wq")
    check(messages["card"] == messages["cpu"],
          f"nan_guard: the card names {messages['card']!r}, the CPU "
          f"{messages['cpu']!r}")
    try:
        gpu.run(guarded, feed=feed, fetch_list=[loss], scope=scope,
                repeats=2)
        raised = False
    except ValueError:
        raised = True
    check(raised, "nan_guard: repeats=2 with the guard did not raise")
    out = {"clean_step_within_f32_tier": True,
           "bit_identical": len(identical) == len(grads) + 1,
           "differ_in_bits": sorted(set(["loss"] + grads) - set(identical)),
           "grads": len(grads),
           "tripped": messages["card"], "card": card}
    log("nan_guard: " + json.dumps(out))
    return out


def phase_plain_route(torch, fluid, fa, card):
    """LLAMA_TINY, whose head dim (16) no kernel takes, on the card: its
    attention takes the plain versions, as the reference's gate sends
    such shapes to its own plain path on every backend. One train step
    and 3 Adam steps match the CPU (train_card_vs_cpu), and
    ServingEngine's answers match CPU Executor.run of each request alone
    at TOL_LOGITS_F32; every attention call, forward and backward, is
    counted as the plain route and no kernel launches."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models.llama import LLAMA_TINY, build_llama
    from paddle_tpu_torch.serving import (BucketSpec, ServingConfig,
                                          ServingEngine)

    cfg = LLAMA_TINY
    d = cfg.dim // cfg.n_heads
    for w in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        try:
            fa.kernel_for(w, torch.float32, d)
        except ValueError:
            continue
        raise SmokeFailure(f"{w}: a kernel takes head dim {d}")
    wrappers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    # the main path of this phase: counts reset just before, read after
    fa.reset_launch_counts()
    train = train_card_vs_cpu(torch, fluid, cfg, 1e-3, 2, 64,
                              "LLAMA_TINY train")
    steps = 4
    for w in wrappers:
        check(w.launches == 0 and
              w.launches_by_kernel[fa.PLAIN] == cfg.n_layers * steps,
              f"LLAMA_TINY train: {w.__name__} {w.launches_by_kernel}, "
              f"launches {w.launches}: not {cfg.n_layers} layers x "
              f"{steps} steps of the plain route")
    train_calls = launches_by_kernel(fa)

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        tokens = fluid.layers.data(name="tokens", shape=[-1, -1],
                                   dtype="int64", append_batch_size=False)
        logits, _ = build_llama(cfg, tokens)
    infer = main.clone(for_test=True)
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    cpu_scope = weights.load_state(fluid.Scope(), weights.dump_state(scope),
                                   torch.device("cpu"))
    cpu = fluid.Executor(fluid.CPUPlace())
    buckets = BucketSpec(batch_sizes=(1, 2, 4), seq_lens={"tokens": (16, 32)})
    engine = ServingEngine(infer, ["tokens"], [logits], scope=scope,
                           buckets=buckets,
                           config=ServingConfig(max_wait_ms=20.0,
                                                default_timeout_s=120.0))
    rng = np.random.RandomState(SEED)
    lengths = [5, 16, 23, 32]
    reqs = [rng.randint(0, cfg.vocab_size, (1, n)).astype(np.int64)
            for n in lengths]
    fa.reset_launch_counts()
    try:
        warm = engine.warmup()
        with ThreadPoolExecutor(len(reqs)) as pool:
            answers = list(pool.map(
                lambda r: engine.infer({"tokens": r}, timeout=120.0), reqs))
        stats = engine.stats()
        engine.assert_no_recompiles()
    finally:
        engine.close()
    dispatches = warm["signatures"] + stats["batches_total"]
    check(fa.flash_fwd.launches == 0 and fa.flash_fwd.launches_by_kernel[
              fa.PLAIN] == cfg.n_layers * dispatches,
          f"LLAMA_TINY serve: K1 {fa.flash_fwd.launches_by_kernel}: not "
          f"{cfg.n_layers} layers x {dispatches} dispatches of the plain "
          f"route")
    worst = 0.0
    for n, r, ans in zip(lengths, reqs, answers):
        got = ans[0][:, :n]
        want = cpu.run(infer, feed={"tokens": r}, fetch_list=[logits],
                       scope=cpu_scope)[0]
        rtol, atol = TOL_LOGITS_F32
        err = np.abs(got - want)
        check(got.shape == want.shape and np.isfinite(got).all()
              and bool((err <= atol + rtol * np.abs(want)).all()),
              f"LLAMA_TINY serve: len {n}: logits differ from the CPU by "
              f"{float(err.max()):.3e} (rtol={rtol}, atol={atol})")
        worst = max(worst, float((err / (atol + rtol * np.abs(want))).max()))
    out = {"head_dim": d, "train": dict(train, calls=train_calls),
           "serve": {"requests": len(reqs), "dispatches": dispatches,
                     "worst_err_over_tolerance": worst,
                     "calls": launches_by_kernel(fa)},
           "card": card}
    log("plain route LLAMA_TINY: " + json.dumps(out))
    return out


def check_sass(cuda_build):
    """Log each kernel's count of tensor-core instructions (HMMA) from
    its SASS; fail if a tensor-core kernel has none."""
    hmma = {}
    for name in cuda_build.SOURCES:
        for fn, n in cuda_build.sass_counts(name, "HMMA").items():
            hmma[fn] = n
            log(f"sass {name}: {fn}: {n} HMMA")
    for kern in MMA_KERNELS:
        fns = {fn: n for fn, n in hmma.items() if kern in fn}
        check(fns and all(fns.values()),
              f"{kern}: no HMMA instruction in its SASS ({fns})")
    return hmma


def free_card(torch):
    gc.collect()
    torch.cuda.empty_cache()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.ops import cuda_build
        from paddle_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    try:
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi()
        log(f"device: {kind}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {torch.cuda.device_count()} card(s)")
        log(f"nvidia-smi: {smi}")

        t0 = time.perf_counter()
        took = cuda_build.build()
        log(f"build: {sorted(cuda_build.SOURCES)} in "
            f"{time.perf_counter() - t0:.2f} s ({took})")
        for name in cuda_build.SOURCES:
            report = f"{cuda_build.library_path(name)}.log"
            if os.path.exists(report):
                for line in open(report).read().splitlines():
                    if any(w in line for w in ("Function properties",
                                               "registers", "spill")):
                        log(f"build {name}: {line.strip()}")
        check_sass(cuda_build)

        timing = phase_kernels(torch, fa, SEED)
        free_card(torch)
        # serving: bf16, then float32, where the answers can be held to
        # the request run alone logit for logit
        serve_launches, serve_bf16 = phase_serve(torch, fluid, "bfloat16",
                                                 smi)
        free_card(torch)
        serve_f32_launches, serve_f32 = phase_serve(torch, fluid, "float32",
                                                    smi)
        free_card(torch)
        log("serve: one (4 x 256) dispatch's device ms by kind, bf16 | "
            "float32: " + json.dumps({
                s["dtype"]: {k: s["one_dispatch"].get(k, "not measured")
                             for k in ("device_busy_ms", "device_ms_by_kind")}
                for s in (serve_bf16, serve_f32)}))
        # training, the main path of slices 2 to 4
        train_launches, train = phase_train(torch, fluid, fa, smi)
        free_card(torch)
        # the reference's own train benchmark (stacked, remat, fused
        # loss): the main path whose launches the kernel line reports
        stack_launches, _ = phase_train_stack(torch, fluid, fa, smi, train)
        free_card(torch)
        # float32 training, the main path of slices 5 and 6
        parity_launches, _ = phase_train_parity(torch, fluid, fa, smi)
        free_card(torch)
        stack_parity_launches, _ = phase_train_stack_parity(torch, fluid,
                                                            fa, smi)
        free_card(torch)
        amp_launches, _ = phase_amp(torch, fluid, fa, smi)
        free_card(torch)
        phase_nan_guard(torch, fluid, fa, smi)
        free_card(torch)
        phase_plain_route(torch, fluid, fa, smi)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")

    power = smi.rsplit(",", 1)[-1].strip()
    train_shape = (f"bh={TRAIN_BATCH}*32 t={TRAIN_SEQ} d=128 causal bf16 "
                   f"(training)")
    f32_shape = "bh=8 t=256 d=128 causal f32 (train parity)"
    replaces = {"fwd": ":59", "dq": ":223", "dkv": ":189"}
    kernels = []
    # bf16 rows at the training shape (launches: this slice's main path,
    # the stacked bf16 train step, K1 with its remat recompute), then the
    # float32 K1, K2 and K3 (split-operand tensor cores; launches: the
    # f32 train step); every path's launches under "launches_by_path"
    paths = {"train": train_launches, "train_stack": stack_launches,
             "train_parity_f32": parity_launches,
             "train_stack_parity_f32": stack_parity_launches,
             **amp_launches}
    for kind_, label, launches, shape in (
            ("fwd", TRAIN_LABEL, stack_launches, train_shape),
            ("dq", TRAIN_LABEL, stack_launches, train_shape),
            ("dkv", TRAIN_LABEL, stack_launches, train_shape),
            ("fwd", "f32 causal", parity_launches, f32_shape),
            ("dq", "f32 causal", parity_launches, f32_shape),
            ("dkv", "f32 causal", parity_launches, f32_shape)):
        t = timing[(kind_, label)]
        fn = t["kernel"]
        lib = fa.kernel_for(
            {"fwd": "flash_fwd", "dq": "flash_bwd_dq",
             "dkv": "flash_bwd_dkv"}[kind_],
            torch.float32 if label == "f32 causal" else torch.bfloat16,
            128)[0]
        row = {"name": fn, "route": "cuda",
               "source": f"paddle_tpu_torch/csrc/{lib}.cu",
               "replaces": "paddle_tpu/ops/pallas_attention.py"
                           + replaces[kind_],
               "launches": launches[fn],
               "launches_by_path": {p: n[fn] for p, n in paths.items()},
               "max_abs_err": t["max_abs_err"], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t["library_ms"],
               "shape": shape, "card": kind, "power_limit": power}
        if label == "f32 causal":
            # the float32 kernel where its grid fills the card, timed and
            # held to its plain version in phase_kernels (not launched on
            # the main path)
            long = dict(timing[(kind_, F32_LONG_LABEL)])
            long.pop("kernel")
            row["t2048"] = dict(long, shape=f"bh={TRAIN_BATCH}*32 "
                                f"t={TRAIN_SEQ} d=128 causal f32")
        if kind_ == "fwd":
            # K1 at this dtype's serving shape, timed and held to its
            # plain version in phase_kernels; launches: that serve phase
            f32 = label == "f32 causal"
            serve = dict(timing[("fwd", "f32 serving T=256" if f32
                                 else "serving T=256")])
            serve.pop("kernel")
            row["serving"] = dict(
                serve, launches=serve_f32_launches if f32 else serve_launches,
                shape=f"bh=4*32 t=256 d=128 causal {'f32' if f32 else 'bf16'}")
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
