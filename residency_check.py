#!/usr/bin/env python3
"""Whether residency, two blocks an SM, is what makes the float32
warpgroup kernels sized for it fast, on one CUDA card.

Float32 K1 and K2 at head dim 64 (``csrc/flash_fwd_f32_d64_wgmma.cu``,
``csrc/flash_bwd_dq_f32_d64_wgmma.cu``) and float32 K1 at head dim 128
(``csrc/flash_fwd_f32_d128_wgmma.cu``) are sized so that two blocks
share an SM (their ``BLOCKS_PER_SM``). This script builds each kernel
three times with the port's nvcc flags into a temporary directory: as it
ships; the same code held to one block an SM by padding its dynamic
shared memory past half the SM's (residency alone changes); and one
block an SM with a ring deep enough to fill that room (the other
arrangement, more tiles in flight a block). It runs the head-dim-64
kernels at Transformer-base's two attention shapes (chip_smoke.py's
``TF_CAUSAL_LABEL`` and ``TF_CROSS_LABEL``: B·H 32 x 8, float32) and
the head-dim-128 K1 at the Llama width's float32 serving bucket (B·H
4 x 32, T 256, causal) and at T 2048 (B·H 2 x 32, causal; chip_smoke.py's
``F32_LONG_LABEL``), holds each output to the kernel's plain version in
chip_smoke.py's float32 tier, reads each variant's resident blocks an SM
from the card's occupancy calculator (the sources' exported
``<symbol>_blocks_per_sm``), and times the variants in turns (CUDA
events, cold L2).

Run from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit::

    python3 residency_check.py

Prints one JSON line a head dim and shape: each variant's blocks an SM,
worst err / limit and ms, with the card's name and power limit. Exits
non-zero if a variant misses the tier or the shipped one's blocks an SM
differ from its ``BLOCKS_PER_SM``.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

# source -> (the ring's slots that fill one block's shared memory, the
# pointers of its C interface)
DEEPER_RING = {"flash_bwd_dq_f32_d64_wgmma": (8, 7),
               "flash_fwd_f32_d64_wgmma": (12, 5),
               "flash_fwd_f32_d128_wgmma": (12, 5)}
PAD_KB = 120     # past half the SM's 228 KB, within a block's 227
HEADERS = ("mma_sm90.cuh", "wgmma_sm90.cuh")
SHIPPED = "2 blocks/SM (shipped)"
_TWO_BLOCK_ASSERT = re.compile(r"static_assert\(BLOCKS_PER_SM \*.*?\);\n",
                               re.S)


def variants(text, slots):
    """{variant: source}: as shipped; held to one block an SM by padding
    SMEM_BYTES by PAD_KB; one block an SM with ``slots`` ring slots. The
    two one-block variants drop the assertion that two blocks fit."""
    one = _TWO_BLOCK_ASSERT.sub("", text)
    assert one != text
    padded, n = re.subn(r"^(constexpr int SMEM_BYTES = .*?);",
                        rf"\1 + {PAD_KB} * 1024;", one, flags=re.M)
    assert n == 1
    deeper, n = re.subn(r"^constexpr int SLOTS = \d+;",
                        f"constexpr int SLOTS = {slots};", one, flags=re.M)
    assert n == 1
    return {SHIPPED: text, "1 block/SM, same ring": padded,
            f"1 block/SM, {slots} slots": deeper}


def build(cuda_build, tmp, name, text, symbol, n_ptrs):
    src = os.path.join(tmp, f"{name}.cu")
    with open(src, "w") as f:
        f.write(text)
    out = os.path.join(tmp, f"lib{name}.so")
    r = subprocess.run([cuda_build._tool("nvcc"), *cuda_build.NVCC_FLAGS,
                        "-o", out, src], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)
    lib = ctypes.CDLL(out)
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    occupancy = getattr(lib, f"{symbol}_blocks_per_sm")
    occupancy.restype, occupancy.argtypes = ctypes.c_int, []
    return fn, occupancy


def main():
    import torch
    if not torch.cuda.is_available():
        print("residency_check: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from paddle_tpu_torch.ops import cuda_build
    from paddle_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)   # the context the occupancy query uses
    tmp = tempfile.mkdtemp()
    fns = {}
    try:
        for h in HEADERS:
            shutil.copy(cuda_build.CSRC / h, tmp)
        for source, (slots, n_ptrs) in DEEPER_RING.items():
            text = (cuda_build.CSRC / f"{source}.cu").read_text()
            for i, (label, src) in enumerate(variants(text, slots).items()):
                fns[source, label] = build(cuda_build, tmp, f"{source}_{i}",
                                           src, source, n_ptrs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    tf_bh = cs.TF_BATCH * 8
    # head dim -> its shapes (label, bh, tq, tk, causal)
    shapes = {cs.TF_HEAD_DIM: (
                  (cs.TF_CAUSAL_LABEL, tf_bh, cs.TF_SEQ, cs.TF_SEQ, True),
                  (cs.TF_CROSS_LABEL, tf_bh, cs.TF_SEQ // 2, cs.TF_SEQ,
                   False)),
              128: (("f32 serving T=256", 4 * 32, 256, 256, True),
                    (cs.F32_LONG_LABEL, cs.TRAIN_BATCH * 32, cs.TRAIN_SEQ,
                     cs.TRAIN_SEQ,
                     True))}
    ok = True
    for d, cases in shapes.items():
        sources = [s for s in DEEPER_RING
                   if cuda_build.constexprs(s)["D"] == d]
        scale = 1 / d ** 0.5
        for shape, bh, tq, tk, causal in cases:
            q, k, v, do = cs.attention_inputs(torch, gen, dev, bh, tq, tk,
                                              d, torch.float32)
            o_ref, lse_ref = fa.ref_attention_lse(q, k, v, scale, causal)
            lse = lse_ref.contiguous()
            delta = (do * o_ref).sum(-1)
            bwd = (q, k, v, do, lse, delta)
            # source -> (inputs, outputs, plain versions of the outputs)
            io = {}
            for source in sources:
                if source.startswith("flash_fwd"):
                    io[source] = ((q, k, v), (torch.empty_like(q),
                                              torch.empty_like(lse)),
                                  (o_ref, lse_ref))
                else:
                    io[source] = (bwd, (torch.empty_like(q),),
                                  (fa.ref_flash_bwd_dq(*bwd, scale,
                                                       causal),))
            row = {"shape": shape, "bh": bh, "tq": tq, "tk": tk, "d": d,
                   "card": smi, "kernels": {}}
            calls = {}
            for (source, label), (fn, occupancy) in fns.items():
                if source not in io:
                    continue
                ins, outs, wants = io[source]
                ptrs = [x.data_ptr() for x in ins + outs]

                def call(fn=fn, ptrs=ptrs):
                    rc = fn(*ptrs, bh, tq, tk, d, 0, scale, int(causal),
                            stream)
                    if rc:
                        raise RuntimeError(f"launch failed: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                ratio = max(cs.kernel_err(g, w)[2]
                            for g, w in zip(outs, wants))
                blocks = occupancy()
                ok &= ratio <= 1.0
                if label == SHIPPED:
                    ok &= blocks == cuda_build.constexprs(source)[
                        "BLOCKS_PER_SM"]
                row["kernels"].setdefault(source, {})[label] = {
                    "blocks_per_sm": blocks, "err_over_limit": ratio,
                    "ms": []}
                calls[source, label] = call
            for _ in range(2):
                for key in list(calls) + list(calls)[::-1]:
                    row["kernels"][key[0]][key[1]]["ms"].append(
                        cs.time_ms(calls[key], torch, flush=flush))
            print(json.dumps(row), flush=True)
            del q, k, v, do, o_ref, lse_ref, lse, delta, bwd, io
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
