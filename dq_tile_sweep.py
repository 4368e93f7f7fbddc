#!/usr/bin/env python3
"""Times tile variants of K2's tensor-core kernel (``csrc/flash_bwd_dq_mma.cu``)
on one CUDA card, at chip_smoke.py's bf16 training shape.

Run from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit::

    python3 dq_tile_sweep.py

Each variant is the shipped source with its tile constexprs and its
``__launch_bounds__`` minimum of blocks a SM rewritten, built with the
port's nvcc flags into a temporary directory. Each is checked against
the plain ``ref_flash_bwd_dq`` in chip_smoke's 16-bit tier, then all are
timed (CUDA events, cold L2) in turns: forward through the list, then
back. Prints the compiler's register/spill report and one JSON line of
results with the card's name and power limit.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

# name -> (constexpr overrides, blocks a SM in __launch_bounds__)
VARIANTS = {
    "64 rows x 64 keys, 4 warps, 2 blocks/SM (shipped)": ({}, 2),
    "128 rows x 64 keys, 8 warps, 1 block/SM": ({"BLOCK_M": 128,
                                                 "WARPS": 8}, 1),
    "64 rows x 32 keys, 4 warps, 3 blocks/SM": ({"BLOCK_N": 32}, 3),
}


def variant_source(text, consts, min_blocks):
    for name, value in consts.items():
        text, n = re.subn(rf"^constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text, flags=re.M)
        assert n == 1, name
    text, n = re.subn(r"__launch_bounds__\(THREADS, \d+\)",
                      f"__launch_bounds__(THREADS, {min_blocks})", text)
    assert n == 1
    return text


def build(cuda_build, tmp, name, text):
    src = os.path.join(tmp, f"{name}.cu")
    with open(src, "w") as f:
        f.write(text)
    out = os.path.join(tmp, f"lib{name}.so")
    r = subprocess.run([cuda_build._tool("nvcc"), *cuda_build.NVCC_FLAGS,
                        "-o", out, src], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)
    report = [line.strip() for line in (r.stdout + r.stderr).splitlines()
              if "registers" in line or "spill" in line]
    fn = ctypes.CDLL(out).flash_bwd_dq_mma
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn, report


def main():
    import torch
    if not torch.cuda.is_available():
        print("dq_tile_sweep: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    from paddle_tpu_torch.ops import cuda_build
    from paddle_tpu_torch.ops import flash_attention as fa

    smi = chip_smoke.nvidia_smi()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    bh, t, d = chip_smoke.TRAIN_BATCH * 32, chip_smoke.TRAIN_SEQ, 128
    q, k, v, do = chip_smoke.attention_inputs(torch, gen, dev, bh, t, t, d,
                                              torch.bfloat16)
    scale = 1.0 / np.sqrt(d)
    o, lse = fa.flash_fwd(q, k, v, scale, True)
    delta = (do.float() * o.float()).sum(-1)
    want = fa.ref_flash_bwd_dq(q, k, v, do, lse, delta, scale, True)
    text = (cuda_build.CSRC / "flash_bwd_dq_mma.cu").read_text()
    tmp = tempfile.mkdtemp()
    shutil.copy(cuda_build.CSRC / "mma_sm90.cuh", tmp)
    fns, results = {}, {}
    try:
        for i, (label, (consts, blocks)) in enumerate(VARIANTS.items()):
            fns[label], report = build(cuda_build, tmp, f"v{i}",
                                       variant_source(text, consts, blocks))
            for line in report:
                print(f"{label}: {line}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn):
        dq = torch.empty_like(q)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, t, t,
                d, 1, float(scale), 1, stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return dq

    for label, fn in fns.items():
        ok, err, ratio = chip_smoke.kernel_err(call(fn), want)
        results[label] = {"max_abs_err": err, "err_over_limit": ratio,
                          "ms": []}
        print(f"{label}: dQ max abs err {err:.3e} (err/limit {ratio:.3f})",
              flush=True)
        if not ok:
            return 1
    order = list(fns) + list(fns)[::-1]
    for label in order:
        results[label]["ms"].append(chip_smoke.time_ms(
            lambda: call(fns[label]), torch, flush=flush))
    bound, by, _, _ = chip_smoke.attention_bound_ms(
        bh, t, t, d, "bfloat16", True, 2, "dq")
    print(json.dumps({"shape": f"bh={bh} t={t} d={d} causal bf16",
                      "bound_ms": bound, "bound_by": by, "card": smi,
                      "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
