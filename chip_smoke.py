#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

Run from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit::

    python3 chip_smoke.py

Phases — any failure exits non-zero:

1. device: the card's name, ``nvidia-smi`` name and power limit, torch
   and CUDA versions;
2. build: every kernel of ``paddle_tpu_torch/csrc`` with nvcc (one
   process per source, all at once), with the build seconds and the
   compiler's register/shared-memory report;
3. kernels: K1 (the flash-attention forward, ``csrc/flash_fwd.cu``)
   against its plain torch version on the same inputs, on the serving
   shapes and on the edge cases (f32 causal and not, tq != tk, ragged T,
   D = 64, fp16), and timed beside the plain version and
   ``scaled_dot_product_attention`` (a yardstick only — the port never
   calls it);
4. serve: the Llama-3-8B-width forward program, all 32 layers (random
   weights from SEED) behind the port's ``ServingEngine``: warmup over the
   buckets, concurrent requests, each answer held against the same
   request run alone through ``Executor.run``, no step build after
   warmup, and K1 launched once per layer per dispatch — in bfloat16
   (the main path, whose K1 launches the kernel line reports), then in
   float32, where answers match the lone runs logit for logit.

It prints one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and
as its last line ``{"ok": true, "device": {...}}``. Without CUDA, or
without the package beside it, it exits non-zero and prints no result.
"""
import dataclasses
import json
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
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12,
              "float32": 67e12}        # float32 outside the tensor cores

# tolerances (|got - want| <= atol + rtol * |want|)
TOL_F32 = (2e-4, 2e-5)     # tests/test_attention.py's f32 kernel tier
TOL_HALF = (2e-2, 2e-2)    # bf16/fp16: the plain version rounds scores
                           # and probabilities to the input type, the
                           # kernel keeps them in float32
TOL_LOGITS_F32 = (5e-4, 5e-4)   # 32 float32 layers, summed in other orders
TOL_LOGITS_BF16_RMS = 0.1       # see phase_serve


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


def attention_bound_ms(bh, tq, tk, d, dtype_name, causal, itemsize):
    """Least time for one K1 call: q, k, v read once, o and lse written
    once, against the FLOPs this call's mask leaves (2 products of
    2*d FLOPs per visible (row, key) pair)."""
    nbytes = (bh * tq * d + 2 * bh * tk * d + bh * tq * d) * itemsize \
        + bh * tq * 4
    if causal:
        rows = np.arange(tq)
        vis = np.clip(rows + (tk - tq) + 1, 0, tk)
        vis = np.where(rows + (tk - tq) < 0, tk, vis)  # fully masked: all
        pairs = int(vis.sum())
    else:
        pairs = tq * tk
    flops = 4.0 * bh * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_flops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_flops) * 1e3,
            "bytes" if t_bytes >= t_flops else "operations",
            nbytes, flops)


def phase_kernels(torch, fa, seed):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    # (label, bh, tq, tk, d, dtype, causal)
    cases = [
        ("serving T=128", 4 * 32, 128, 128, 128, bf16, True),
        ("serving T=256", 4 * 32, 256, 256, 128, bf16, True),
        ("f32 causal", 8, 256, 256, 128, f32, True),
        ("f32 non-causal", 8, 256, 256, 128, f32, False),
        ("f32 tq<tk causal", 8, 128, 256, 128, f32, True),
        ("f32 tq>tk causal (fully masked rows)", 8, 256, 128, 128, f32,
         True),
        ("f32 ragged T=200 causal", 8, 200, 200, 128, f32, True),
        ("f32 ragged T=200 non-causal", 8, 200, 200, 128, f32, False),
        ("f32 D=64 causal", 8, 256, 256, 64, f32, True),
        ("bf16 D=64 causal", 8, 256, 256, 64, bf16, True),
        ("fp16 ragged T=200 non-causal", 8, 200, 200, 128, f16, False),
    ]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    results = {}
    failures = []
    for label, bh, tq, tk, d, dt, causal in cases:
        q = (torch.randn(bh, tq, d, generator=gen, device=dev) * 0.5).to(dt)
        k = (torch.randn(bh, tk, d, generator=gen, device=dev) * 0.5).to(dt)
        v = (torch.randn(bh, tk, d, generator=gen, device=dev) * 0.5).to(dt)
        scale = 1.0 / np.sqrt(d)
        o, lse = fa.flash_fwd(q, k, v, scale, causal)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.ref_attention_lse(q, k, v, scale, causal)
        tol = TOL_F32 if dt == f32 else TOL_HALF
        ok_o, err_o = allclose_err(o, o_ref, tol)
        ok_l, err_l = allclose_err(lse, lse_ref, tol)
        finite = bool(torch.isfinite(o).all())
        log(f"K1 {label}: bh={bh} tq={tq} tk={tk} d={d} {dt} "
            f"causal={causal}: max|dO|={err_o:.3e} max|dlse|={err_l:.3e} "
            f"(rtol={tol[0]}, atol={tol[1]}) "
            f"{'ok' if ok_o and ok_l and finite else 'MISMATCH'}")
        if not (ok_o and ok_l and finite):
            failures.append(label)
        results[label] = (q, k, v, causal, max(err_o, err_l))
    check(not failures, f"K1 disagrees with its plain version: {failures}")

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB
    timing = {}
    for label in ("serving T=128", "serving T=256"):
        q, k, v, causal, err = results[label]
        bh, t, d = q.shape
        scale = 1.0 / np.sqrt(d)
        q4, k4, v4 = (x.view(4, 32, t, d) for x in (q, k, v))
        ms = time_ms(lambda: fa.flash_fwd(q, k, v, scale, causal), torch,
                     flush=flush)
        plain_ms = time_ms(
            lambda: fa.ref_attention_lse(q, k, v, scale, causal), torch,
            flush=flush)
        lib_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal), torch, flush=flush)
        bound, by, nbytes, flops = attention_bound_ms(
            bh, t, t, d, "bfloat16", causal, q.element_size())
        timing[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound, bound_by=by, max_abs_err=err)
        log(f"K1 {label} timing (cold L2, mean of 20): kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
            f"{bound:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.3f} GFLOP)")
    del flush
    return timing


def where_the_time_goes(torch, exe, program, fetch, scope, feed):
    """Break one dispatch of ``feed`` down: host wall time with and
    without copying the fetched logits to numpy, and the device's kernel
    time by kind from torch.profiler (K1, matrix products, copies, the
    rest). Diagnostic only — reports "not measured" where the profiler
    sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    def run(return_numpy):
        t0 = time.perf_counter()
        out = exe.run(program, feed=feed, fetch_list=[fetch], scope=scope,
                      return_numpy=return_numpy)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    run(True)
    no_fetch = sorted(run(False)[0] for _ in range(3))[1]
    with_fetch = sorted(run(True)[0] for _ in range(3))[1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(False)
    kinds = {"k1_flash_fwd": 0.0, "matmul": 0.0, "copy": 0.0, "other": 0.0}
    for e in prof.key_averages():
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
        if "flash_fwd_kernel" in name:
            kinds["k1_flash_fwd"] += us / 1e3
        elif any(w in name for w in ("gemm", "nvjet", "cutlass", "xmma",
                                     "matmul")):
            kinds["matmul"] += us / 1e3
        elif "memcpy" in name or "memset" in name:
            kinds["copy"] += us / 1e3
        else:
            kinds["other"] += us / 1e3
    busy = sum(kinds.values())
    out = {"feed": {k: list(v.shape) for k, v in feed.items()},
           "wall_ms_device_fetch": no_fetch * 1e3,
           "wall_ms_numpy_fetch": with_fetch * 1e3}
    if busy:
        out.update({"device_busy_ms": busy,
                    "device_idle_share": 1 - busy / (no_fetch * 1e3),
                    "device_ms_by_kind": kinds})
    else:
        out["device_busy_ms"] = "not measured"
    return out


def phase_serve(torch, fluid, dtype, card):
    """Serve the 8B-width forward in ``dtype`` and hold every answer to
    the same request run alone. Returns (K1 launches, serve stats).

    The tiers: in float32 each logit within TOL_LOGITS_F32 and the greedy
    token exact. In bfloat16 a 32-layer network amplifies rounding that
    differs between GEMM shapes (a batch of 4 x 128 rows vs 1 x n): the
    logits are held to a relative RMS error of TOL_LOGITS_BF16_RMS, and a
    greedy flip is allowed only where the top-1 margin is within twice
    that row's logit error."""
    from paddle_tpu_torch.models.llama import LLAMA3_8B, build_llama
    from paddle_tpu_torch.ops.flash_attention import flash_fwd
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
        flash_fwd.launches = 0
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
        launches = flash_fwd.launches
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
    log(f"{tag}: K1 launched {launches} times = {cfg.n_layers} x "
        f"{dispatches} dispatches")

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
    log(f"{tag}: one dispatch: " + json.dumps(where_the_time_goes(
        torch, exe, infer, logits, scope, long_batch)))
    serve = {"dtype": dtype, "requests": len(reqs), "wall_s": wall,
             "requests_per_s": len(reqs) / wall,
             "p50_ms": lat["p50_ms"], "p99_ms": lat["p99_ms"],
             "batches": stats["batches_total"],
             "batch_p50_ms": stats["batch_latency"]["p50_ms"],
             "k1_launches": launches, "dispatches": dispatches,
             "layers": cfg.n_layers,
             "max_abs_logit_err_vs_alone": worst_abs,
             "max_rel_rms_logit_err_vs_alone": worst_rms,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "card": card}
    log(f"{tag}: " + json.dumps(serve))
    return launches, serve


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
                    if "registers" in line or "spill" in line:
                        log(f"build {name}: {line.strip()}")

        timing = phase_kernels(torch, fa, SEED)
        # the main path in bf16; then float32, where the answers can be
        # held to the request run alone logit for logit
        launches, _ = phase_serve(torch, fluid, "bfloat16", smi)
        torch.cuda.empty_cache()
        phase_serve(torch, fluid, "float32", smi)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    t = timing["serving T=256"]
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas_attention.py:59",
        "launches": launches, "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "shape": "bh=4*32 t=256 d=128 causal bf16",
        "card": kind, "power_limit": smi.rsplit(",", 1)[-1].strip()}]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
