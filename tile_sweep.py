#!/usr/bin/env python3
"""Times tile variants of the port's tensor-core attention kernels on one
CUDA card: the float32 kernels (``csrc/flash_fwd_f32mma.cu``,
``csrc/flash_bwd_dq_f32mma.cu``, ``csrc/flash_bwd_dkv_f32mma.cu``, and
float32 K3's warpgroup kernel at head dim 128,
``csrc/flash_bwd_dkv_f32_d128_wgmma.cu``: its q tile's rows and ring
stages) at chip_smoke.py's float32 shapes, and K2's bf16 kernel
(``csrc/flash_bwd_dq_mma.cu``) at its bf16 training shape.

Run from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit::

    python3 tile_sweep.py [source ...]     # default: every source below
    python3 tile_sweep.py --before SOURCE=FILE.cu:SYMBOL ... [source ...]

e.g. the warpgroup K3 beside the mma.sync kernel it replaced, SRC being
``paddle_tpu_torch/csrc/flash_bwd_dkv_f32mma.cu``::

    python3 tile_sweep.py --before \\
        flash_bwd_dkv_f32_d128_wgmma=SRC:flash_bwd_dkv_f32mma \\
        flash_bwd_dkv_f32_d128_wgmma

Each variant is the shipped source with its tile constexprs and its
``__launch_bounds__`` minimum of blocks a SM rewritten, built with the
port's nvcc flags into a temporary directory. ``--before`` adds, to
SOURCE's variants, the kernel SYMBOL of another source file with the
same C interface (an older tree's kernel of the same wrapper, say),
checked and timed in the same turns. Each is checked against
the kernel's plain version in chip_smoke's tier for the output's type,
then all are timed (CUDA events, cold L2) in turns: forward through the
list, then back. Prints the compiler's register/spill report and one
JSON line of results a source, with the card's name and power limit.
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

# source -> {variant: (constexpr overrides, blocks a SM in
# __launch_bounds__)}; the first variant of each is the source as it
# ships
SWEEPS = {
    "flash_fwd_f32mma": {
        "128 rows x 64 keys, 8 warps, 1 block/SM (shipped)": ({}, 1),
        "128 rows x 32 keys, 8 warps, 1 block/SM": ({"BLOCK_N": 32}, 1),
        "64 rows x 64 keys, 4 warps, 1 block/SM": ({"BLOCK_M": 64}, 1),
        "64 rows x 32 keys, 4 warps, 2 blocks/SM": ({"BLOCK_M": 64,
                                                     "BLOCK_N": 32}, 2),
    },
    "flash_bwd_dq_mma": {
        "64 rows x 64 keys, 4 warps, 2 blocks/SM (shipped)": ({}, 2),
        "128 rows x 64 keys, 8 warps, 1 block/SM": ({"BLOCK_M": 128,
                                                     "WARPS": 8}, 1),
        "64 rows x 32 keys, 4 warps, 3 blocks/SM": ({"BLOCK_N": 32}, 3),
    },
    "flash_bwd_dq_f32mma": {
        "64 rows x 64 keys, 4 warps, 1 block/SM (shipped)": ({}, 1),
        "64 rows x 32 keys, 4 warps, 1 block/SM": ({"BLOCK_N": 32}, 1),
        "128 rows x 32 keys, 8 warps, 1 block/SM": ({"BLOCK_M": 128,
                                                     "BLOCK_N": 32}, 1),
    },
    # K3: keys per block x q rows per tile; warps split the keys in 16s
    # and the rows among the rest
    "flash_bwd_dkv_f32mma": {
        "32 keys x 64 rows, 4 warps, 1 block/SM (shipped)": ({}, 1),
        "64 keys x 64 rows, 8 warps, 1 block/SM": ({"BLOCK_N": 64,
                                                    "WARPS": 8}, 1),
        "64 keys x 32 rows, 8 warps, 1 block/SM": ({"BLOCK_N": 64,
                                                    "BLOCK_M": 32,
                                                    "WARPS": 8}, 1),
        "32 keys x 32 rows, 4 warps, 2 blocks/SM": ({"BLOCK_M": 32}, 2),
    },
    # 64 keys a block; q rows a tile x ring stages, and the producer's
    # and each consumer's registers (setmaxnreg: 136 + 2 x 184 = 152 +
    # 2 x 176 = 3 x 168). Shared memory 160, 200 and 176 KB
    "flash_bwd_dkv_f32_d128_wgmma": {
        "32 rows x 2 stages, 136/184 regs (shipped)": ({}, 1),
        "32 rows x 3 stages, 136/184 regs": ({"STAGES": 3}, 1),
        "64 rows x 1 stage, 136/184 regs": ({"BLOCK_M": 64, "STAGES": 1},
                                            1),
        "64 rows x 1 stage, 152/176 regs": ({"BLOCK_M": 64, "STAGES": 1,
                                             "PRODUCER_REGS": 152,
                                             "CONSUMER_REGS": 176}, 1),
    },
}
# pointers each source's C entry takes
N_PTRS = {"flash_fwd_f32mma": 5, "flash_bwd_dq_mma": 7,
          "flash_bwd_dq_f32mma": 7, "flash_bwd_dkv_f32mma": 8,
          "flash_bwd_dkv_f32_d128_wgmma": 8}
HEADERS = ("mma_sm90.cuh", "wgmma_sm90.cuh")


def variant_source(text, consts, min_blocks):
    for name, value in consts.items():
        text, n = re.subn(rf"^constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text, flags=re.M)
        assert n == 1, name
    text, n = re.subn(r"__launch_bounds__\(THREADS, \d+\)",
                      f"__launch_bounds__(THREADS, {min_blocks})", text)
    assert n == 1
    return text


def build(cuda_build, tmp, source, name, text, symbol=None):
    src = os.path.join(tmp, f"{name}.cu")
    with open(src, "w") as f:
        f.write(text)
    out = os.path.join(tmp, f"lib{name}.so")
    r = subprocess.run([cuda_build._tool("nvcc"), *cuda_build.NVCC_FLAGS,
                        "-o", out, src], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)
    report = [line.strip() for line in (r.stdout + r.stderr).splitlines()
              if any(w in line for w in ("Function properties",
                                         "registers", "spill"))]
    fn = getattr(ctypes.CDLL(out), symbol or source)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * N_PTRS[source] + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn, report


def cases(source, torch, fa, chip_smoke, gen, dev):
    """[(shape label, call(fn) -> outputs, plain outputs, bound args)] of
    ``source`` at the shapes its main path runs."""
    stream = torch.cuda.current_stream().cuda_stream
    out = []
    if source == "flash_fwd_f32mma":
        shapes = (("bh=4*32 t=256 d=128 causal f32 (serving)", 4 * 32),
                  ("bh=8 t=256 d=128 causal f32 (train parity)", 8))
        for label, bh in shapes:
            t, d = 256, 128
            q, k, v, _ = chip_smoke.attention_inputs(
                torch, gen, dev, bh, t, t, d, torch.float32)
            scale = 1.0 / np.sqrt(d)

            def call(fn, q=q, k=k, v=v, bh=bh, t=t, d=d, scale=scale):
                o = torch.empty_like(q)
                lse = torch.empty(bh, t, device=dev)
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), lse.data_ptr(), bh, t, t, d, 0,
                        float(scale), 1, stream)
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")
                return o, lse
            want = fa.ref_attention_lse(q, k, v, scale, True)
            out.append((label, call, want,
                        (bh, t, t, d, chip_smoke.RATE_OF_KERNEL[source],
                         True, 4, "fwd")))
        return out
    bh_train, t_train = chip_smoke.TRAIN_BATCH * 32, chip_smoke.TRAIN_SEQ
    if source == "flash_bwd_dq_mma":
        shapes = ((f"bh={bh_train} t={t_train} d=128 causal bf16 "
                   f"(training)", bh_train, t_train, torch.bfloat16),)
    else:
        shapes = (("bh=8 t=256 d=128 causal f32 (train parity)", 8, 256,
                   torch.float32),
                  ("bh=32 t=512 d=128 causal f32 (pipeline stage)", 32,
                   chip_smoke.SCHED_F32_SEQ, torch.float32),
                  (f"bh={bh_train} t={t_train} d=128 causal f32", bh_train,
                   t_train, torch.float32))
    kind = "dkv" if source.startswith("flash_bwd_dkv") else "dq"
    for label, bh, t, dt in shapes:
        d = 128
        q, k, v, do = chip_smoke.attention_inputs(torch, gen, dev, bh, t, t,
                                                  d, dt)
        scale = 1.0 / np.sqrt(d)
        o, lse = fa.flash_fwd(q, k, v, scale, True)
        delta = (do.float() * o.float()).sum(-1)
        code = 0 if dt == torch.float32 else 1

        def call(fn, q=q, k=k, v=v, do=do, lse=lse, delta=delta, bh=bh,
                 t=t, scale=scale, code=code):
            outs = (torch.empty_like(q),) if kind == "dq" else \
                (torch.empty_like(k), torch.empty_like(v))
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(),
                    *(x.data_ptr() for x in outs), bh, t, t, d, code,
                    float(scale), 1, stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            return outs
        bwd = (q, k, v, do, lse, delta, scale, True)
        want = (fa.ref_flash_bwd_dq(*bwd),) if kind == "dq" else \
            fa.ref_flash_bwd_dkv(*bwd)
        rates = chip_smoke.RATE_OF_KERNEL.get(source, "bfloat16")
        out.append((label, call, want,
                    (bh, t, t, d, rates, True, q.element_size(), kind)))
    return out


def sweep(source, torch, fa, chip_smoke, cuda_build, smi, flush,
          before=None):
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    text = (cuda_build.CSRC / f"{source}.cu").read_text()
    tmp = tempfile.mkdtemp()
    for header in HEADERS:
        shutil.copy(cuda_build.CSRC / header, tmp)
    fns = {}
    try:
        for i, (label, (consts, blocks)) in enumerate(SWEEPS[source].items()):
            fns[label], report = build(cuda_build, tmp, source, f"v{i}",
                                       variant_source(text, consts, blocks))
            for line in report:
                print(f"{source} {label}: {line}", flush=True)
        if before:
            path, symbol = before.rsplit(":", 1)
            label = f"before: {path}:{symbol}"
            with open(path) as f:
                fns[label], report = build(cuda_build, tmp, source, "before",
                                           f.read(), symbol)
            for line in report:
                print(f"{source} {label}: {line}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    results = []
    for shape, call, want, bound_args in cases(source, torch, fa, chip_smoke,
                                               gen, dev):
        row = {"shape": shape, "variants": {}}
        for label, fn in fns.items():
            errs = [chip_smoke.kernel_err(g, w) for g, w in zip(call(fn), want)]
            ratio = max(e[2] for e in errs)
            row["variants"][label] = {
                "max_abs_err": max(e[1] for e in errs),
                "err_over_limit": ratio, "ms": []}
            print(f"{source} {label}, {shape}: max abs err "
                  f"{max(e[1] for e in errs):.3e} (err/limit {ratio:.3f})",
                  flush=True)
            if not all(e[0] for e in errs):
                return None
        order = list(fns) + list(fns)[::-1]
        for label in order:
            row["variants"][label]["ms"].append(chip_smoke.time_ms(
                lambda: call(fns[label]), torch, flush=flush))
        row["bound_ms"], row["bound_by"], _, _ = \
            chip_smoke.attention_bound_ms(*bound_args)
        results.append(row)
    return {"source": source, "card": smi, "shapes": results}


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("tile_sweep: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    from paddle_tpu_torch.ops import cuda_build
    from paddle_tpu_torch.ops import flash_attention as fa

    before = {}
    while argv[:1] == ["--before"]:
        source, spec = argv[1].split("=", 1)
        before[source] = spec
        argv = argv[2:]
    sources = argv or list(SWEEPS)
    unknown = [s for s in sources + list(before) if s not in SWEEPS]
    if unknown:
        print(f"tile_sweep: no variants for {unknown}; sources: "
              f"{list(SWEEPS)}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke.nvidia_smi()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    for source in sources:
        result = sweep(source, torch, fa, chip_smoke, cuda_build, smi, flush,
                       before.get(source))
        if result is None:
            return 1
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
