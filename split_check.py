#!/usr/bin/env python3
"""Whether the 16-bit warpgroup kernels still need their probabilities
split into hi + lo 16-bit halves, on one CUDA card.

At head dim 256 K1 (``csrc/flash_fwd_d256_wgmma.cu``) takes P V as two
products, P's hi and lo halves; K2 (``csrc/flash_bwd_dq_d256_wgmma.cu``)
takes dS K the same way, and K3 (``csrc/flash_bwd_dkv_d256_wgmma.cu``)
Pᵀ dO and dSᵀ Q. At head dim 128 K1 (``csrc/flash_fwd_d128_wgmma.cu``),
K2 (``csrc/flash_bwd_dq_d128_wgmma.cu``) and K3
(``csrc/flash_bwd_dkv_d128_wgmma.cu``) do the same. This script
builds each kernel twice with the port's nvcc flags into a temporary
directory, as it ships and with the lo products cut (one 16-bit
rounding of P, and of dS), runs both at chip_smoke.py's training and
serving shapes of the kernel's head dim, holds each output to the
kernel's plain version in chip_smoke.py's 16-bit tier and times both
in turns (CUDA events, cold L2).

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

# source -> (the lines of its lo products, pointers of its C interface)
LO_PRODUCTS = {
    "flash_fwd_d256_wgmma": (("W::rs256(acc, pl[kk], dv);",), 5),
    "flash_bwd_dq_d256_wgmma": (("W::rs256(acc, dlo[kk], dk);",), 7),
    "flash_bwd_dkv_d256_wgmma": (("W::rs256(acc, xl[kk], db);",), 8),
    "flash_fwd_d128_wgmma": (("W::rs128(acc, pl[kk], dv);",), 5),
    "flash_bwd_dq_d128_wgmma": (("W::rs128(acc, dlo[kk], dk);",), 7),
    "flash_bwd_dkv_d128_wgmma": (("W::rs128(acc_v, xl[kk], db);",
                                  "W::rs128(acc_k, yl[kk], db);"), 8),
}
HEADERS = ("mma_sm90.cuh", "wgmma_sm90.cuh")


def variants(text, lo_lines):
    """{variant: source}: as shipped, and with the lo products cut."""
    cut = text
    for line in lo_lines:
        assert text.count(line) == 1, line
        cut = cut.replace(line, "")
    return {"hi + lo (shipped)": text, "hi only": cut}


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
    # source -> (wrapper, head dim), from the routing table
    kernel_of = {lib: (w, d) for (w, _, d), (lib, _) in
                 fa._WGMMA_ROUTES.items() if lib in LO_PRODUCTS}
    tmp = tempfile.mkdtemp()
    fns = {}
    try:
        for h in HEADERS:
            shutil.copy(cuda_build.CSRC / h, tmp)
        for source, (lo_lines, n_ptrs) in LO_PRODUCTS.items():
            text = (cuda_build.CSRC / f"{source}.cu").read_text()
            for i, (label, src) in enumerate(variants(text,
                                                      lo_lines).items()):
                fns[source, label] = build(cuda_build, tmp, f"{source}_{i}",
                                           src, source, n_ptrs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    cs = chip_smoke
    # head dim -> its (label, B*H, T) of chip_smoke.py, causal
    shapes = {256: ((cs.HD256_LABEL, cs.TRAIN_BATCH * cs.HD256_HEADS,
                     cs.TRAIN_SEQ), (cs.HD256_OP_LABEL, cs.HD256_HEADS, 256)),
              128: ((cs.TRAIN_LABEL, cs.TRAIN_BATCH * 32, cs.TRAIN_SEQ),
                    ("serving T=256", 4 * 32, 256))}
    shipped_ok = True
    for d, (shape, bh, t) in ((d, x) for d in shapes for x in shapes[d]):
        q, k, v, do = cs.attention_inputs(torch, gen, dev, bh, t, t, d,
                                          torch.bfloat16)
        scale = 1.0 / d ** 0.5
        o_ref, _ = fa.ref_attention_lse(q.float(), k.float(), v.float(),
                                        scale, True)
        o, lse = fa.flash_fwd(q, k, v, scale, True)
        delta = (do.float() * o.float()).sum(-1)
        bwd = (q, k, v, do, lse, delta)
        # wrapper -> (inputs, outputs, plain versions of the outputs)
        io = {"flash_fwd": ((q, k, v), (torch.empty_like(q),
                                        torch.empty_like(lse)),
                            (o_ref.to(torch.bfloat16),)),
              "flash_bwd_dq": (bwd, (torch.empty_like(q),),
                               (fa.ref_flash_bwd_dq(*bwd, scale, True),)),
              "flash_bwd_dkv": (bwd, (torch.empty_like(k),
                                      torch.empty_like(v)),
                                fa.ref_flash_bwd_dkv(*bwd, scale, True))}
        row = {"shape": shape, "bh": bh, "t": t, "d": d, "card": smi,
               "kernels": {}}
        calls = {}
        for (source, label), fn in fns.items():
            if kernel_of[source][1] != d:
                continue
            ins, outs, wants = io[kernel_of[source][0]]
            ptrs = [x.data_ptr() for x in ins + outs]

            def call(fn=fn, ptrs=ptrs):
                rc = fn(*ptrs, bh, t, t, d, 1, scale, 1, stream)
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            ratio = max(cs.kernel_err(g, w)[2]
                        for g, w in zip(outs[:len(wants)], wants))
            if label.endswith("(shipped)") and ratio > 1.0:
                shipped_ok = False
            row["kernels"].setdefault(source, {})[label] = {
                "err_over_limit": ratio, "ms": []}
            calls[source, label] = call
        for key in list(calls) + list(calls)[::-1]:
            row["kernels"][key[0]][key[1]]["ms"].append(
                cs.time_ms(calls[key], torch, flush=flush))
        print(json.dumps(row), flush=True)
        del q, k, v, do, o, lse, delta, bwd, io, o_ref
    return 0 if shipped_ok else 1


if __name__ == "__main__":
    sys.exit(main())
