#!/usr/bin/env python3
"""Whether the 16-bit head-dim-256 warpgroup kernels still need their
probabilities split into hi + lo 16-bit halves, on one CUDA card.

K1 (``csrc/flash_fwd_d256_wgmma.cu``) takes P V as two products, P's
hi and lo halves; K2 (``csrc/flash_bwd_dq_d256_wgmma.cu``) takes dS K
the same way, and K3 (``csrc/flash_bwd_dkv_d256_wgmma.cu``) Pᵀ dO and
dSᵀ Q. This script builds each kernel twice with the port's nvcc flags
into a temporary directory, as it ships and with the lo product cut
(one 16-bit rounding of P, and of dS), runs both at chip_smoke.py's
D = 256 training and serving shapes, holds each output to the kernel's
plain version in chip_smoke.py's 16-bit tier and times both in turns
(CUDA events, cold L2).

Run from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit::

    python3 split_check.py

Prints one JSON line a shape: worst err / limit and ms of each variant,
with the card's name and power limit. Exits non-zero if the shipped
kernels miss the tier.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

# source -> (the lo product's line, pointers of its C interface)
LO_PRODUCTS = {
    "flash_fwd_d256_wgmma": ("W::rs256(acc, pl[kk], dv);", 5),
    "flash_bwd_dq_d256_wgmma": ("W::rs256(acc, dlo[kk], dk);", 7),
    "flash_bwd_dkv_d256_wgmma": ("W::rs256(acc, xl[kk], db);", 8),
}
HEADERS = ("mma_sm90.cuh", "wgmma_sm90.cuh")


def variants(text, lo_line):
    """{variant: source}: as shipped, and with the lo product cut."""
    assert text.count(lo_line) == 1, lo_line
    return {"hi + lo (shipped)": text, "hi only": text.replace(lo_line, "")}


def build(cuda_build, tmp, name, text, symbol, n_ptrs):
    src = os.path.join(tmp, f"{name}.cu")
    with open(src, "w") as f:
        f.write(text)
    out = os.path.join(tmp, f"lib{name}.so")
    r = subprocess.run([cuda_build._tool("nvcc"), *cuda_build.NVCC_FLAGS,
                        "-o", out, src], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)
    fn = getattr(ctypes.CDLL(out), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def main():
    import torch
    if not torch.cuda.is_available():
        print("split_check: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    from paddle_tpu_torch.ops import cuda_build
    from paddle_tpu_torch.ops import flash_attention as fa

    smi = chip_smoke.nvidia_smi()
    tmp = tempfile.mkdtemp()
    fns = {}
    try:
        for h in HEADERS:
            shutil.copy(cuda_build.CSRC / h, tmp)
        for source, (lo_line, n_ptrs) in LO_PRODUCTS.items():
            text = (cuda_build.CSRC / f"{source}.cu").read_text()
            for i, (label, src) in enumerate(variants(text,
                                                      lo_line).items()):
                fns[source, label] = build(cuda_build, tmp, f"{source}_{i}",
                                           src, source, n_ptrs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    shipped_ok = True
    for shape, bh, t in ((chip_smoke.HD256_LABEL, chip_smoke.TRAIN_BATCH
                          * chip_smoke.HD256_HEADS, chip_smoke.TRAIN_SEQ),
                         (chip_smoke.HD256_OP_LABEL, chip_smoke.HD256_HEADS,
                          256)):
        q, k, v, do = chip_smoke.attention_inputs(torch, gen, dev, bh, t, t,
                                                  256, torch.bfloat16)
        scale = 1.0 / 16
        o_ref, _ = fa.ref_attention_lse(q.float(), k.float(), v.float(),
                                        scale, True)
        o_ref = o_ref.to(torch.bfloat16)
        o, lse = fa.flash_fwd(q, k, v, scale, True)
        delta = (do.float() * o.float()).sum(-1)
        dq_ref = fa.ref_flash_bwd_dq(q, k, v, do, lse, delta, scale, True)
        dk_ref, dv_ref = fa.ref_flash_bwd_dkv(q, k, v, do, lse, delta, scale,
                                              True)
        outs = {"flash_fwd_d256_wgmma": (torch.empty_like(q),
                                         torch.empty_like(lse)),
                "flash_bwd_dq_d256_wgmma": (torch.empty_like(q),),
                "flash_bwd_dkv_d256_wgmma": (torch.empty_like(k),
                                             torch.empty_like(v))}
        ins = {"flash_fwd_d256_wgmma": (q, k, v),
               "flash_bwd_dq_d256_wgmma": (q, k, v, do, lse, delta),
               "flash_bwd_dkv_d256_wgmma": (q, k, v, do, lse, delta)}
        wants = {"flash_fwd_d256_wgmma": (o_ref,),
                 "flash_bwd_dq_d256_wgmma": (dq_ref,),
                 "flash_bwd_dkv_d256_wgmma": (dk_ref, dv_ref)}
        row = {"shape": shape, "bh": bh, "t": t, "card": smi, "kernels": {}}
        calls = {}
        for (source, label), fn in fns.items():
            ptrs = [x.data_ptr() for x in ins[source] + outs[source]]

            def call(fn=fn, ptrs=ptrs):
                rc = fn(*ptrs, bh, t, t, 256, 1, scale, 1, stream)
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            got = outs[source][:len(wants[source])]
            ratio = max(chip_smoke.kernel_err(g, w)[2]
                        for g, w in zip(got, wants[source]))
            if label.endswith("(shipped)") and ratio > 1.0:
                shipped_ok = False
            row["kernels"].setdefault(source, {})[label] = {
                "err_over_limit": ratio, "ms": []}
            calls[source, label] = call
        for key in list(calls) + list(calls)[::-1]:
            row["kernels"][key[0]][key[1]]["ms"].append(
                chip_smoke.time_ms(calls[key], torch, flush=flush))
        print(json.dumps(row), flush=True)
    return 0 if shipped_ok else 1


if __name__ == "__main__":
    sys.exit(main())
