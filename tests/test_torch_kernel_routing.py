"""Which CUDA kernel each attention wrapper launches, the tiles the
kernels use, and why the tensor-core kernels split their probabilities —
all on the CPU (the kernels themselves run only on the card:
tests/test_torch_kernels_gpu.py, chip_smoke.py). Why the float32 K1
splits every operand: tests/test_torch_f32_split.py.
"""
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import tile_sweep
from paddle_tpu_torch.ops import cuda_build
from paddle_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "paddle_tpu_torch" / "csrc"


def _library_of(symbol):
    """The csrc library that builds kernel ``symbol``."""
    return next(lib for routes in fa._ROUTES.values()
                for lib, sym in routes if sym == symbol)


@pytest.mark.parametrize("wrapper,dtype,want", [
    ("flash_fwd", torch.bfloat16, "flash_fwd_mma"),
    ("flash_fwd", torch.float16, "flash_fwd_mma"),
    ("flash_fwd", torch.float32, "flash_fwd_f32mma"),
    ("flash_bwd_dkv", torch.bfloat16, "flash_bwd_dkv_mma"),
    ("flash_bwd_dkv", torch.float16, "flash_bwd_dkv_mma"),
    ("flash_bwd_dkv", torch.float32, "flash_bwd_dkv"),
    ("flash_bwd_dq", torch.bfloat16, "flash_bwd_dq_mma"),
    ("flash_bwd_dq", torch.float16, "flash_bwd_dq_mma"),
    ("flash_bwd_dq", torch.float32, "flash_bwd_dq"),
])
@pytest.mark.parametrize("d", [64, 128])
def test_routing_maps_dtypes_to_kernels(wrapper, dtype, want, d):
    """16-bit inputs go to the tensor-core kernels of K1, K2 and K3;
    float32 to K1's split-operand tensor-core kernel and the SIMT K2 and
    K3. The library is the source the symbol is built from."""
    lib, sym = fa.kernel_for(wrapper, dtype, d)
    assert sym == want
    assert lib in cuda_build.SOURCES
    assert f'extern "C" int {sym}(' in (CSRC / f"{lib}.cu").read_text()
    assert set(getattr(fa, wrapper).launches_by_kernel) >= {sym}


@pytest.mark.parametrize("dtype,d,match", [
    (torch.float64, 128, "float32, bfloat16 or float16"),
    (torch.int32, 128, "float32, bfloat16 or float16"),
    (torch.bfloat16, 96, "head dims"),
    (torch.float32, 256, "head dims"),
])
@pytest.mark.parametrize("wrapper", ["flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv"])
def test_routing_raises_for_what_no_kernel_takes(wrapper, dtype, d, match):
    with pytest.raises(ValueError, match=match):
        fa.kernel_for(wrapper, dtype, d)


@pytest.mark.parametrize("symbol", sorted(chip_smoke.TILE_CONSTEXPRS))
def test_tiles_match_the_sources_constexprs(symbol):
    """Each kernel's tile, as chip_smoke.py reads it from the source's
    constexprs: whole mma tiles (multiples of 16) that split the training
    sequence, as the planted faults' views of it assume."""
    rows_name, keys_name = chip_smoke.TILE_CONSTEXPRS[symbol]
    values = cuda_build.constexprs(_library_of(symbol))
    rows, keys = values[rows_name], values[keys_name]
    assert type(rows) is int and type(keys) is int
    assert rows % 16 == 0 and keys % 16 == 0
    assert chip_smoke.TRAIN_SEQ % rows == 0
    assert chip_smoke.TRAIN_SEQ % keys == 0


def test_constexprs_evaluate_in_order_with_integer_division():
    # flash_fwd_f32mma.cu: WARPS = BLOCK_M / 16, THREADS = WARPS * 32
    values = cuda_build.constexprs("flash_fwd_f32mma")
    assert values["WARPS"] == values["BLOCK_M"] // 16
    assert values["THREADS"] == values["WARPS"] * 32
    assert type(values["WARPS"]) is int


def test_planted_faults_follow_the_bf16_kernels_tiles():
    """chip_smoke.py plants its tile faults at the tiles of the kernels
    the bf16 training shape runs, read from the sources' constexprs."""
    tiles = chip_smoke.planted_fault_tiles(torch, fa)
    assert tiles == {"flash_fwd": (128, 64), "flash_bwd_dq": (64, 64),
                     "flash_bwd_dkv": (64, 64)}
    # float32 runs K1's split-operand kernel and the SIMT K2 and K3,
    # whose tiles differ
    assert chip_smoke.kernel_tile(fa, "flash_fwd", torch.float32) == \
        (128, 64)
    assert chip_smoke.kernel_tile(fa, "flash_bwd_dq",
                                  torch.float32) == (64, 32)
    assert chip_smoke.kernel_tile(fa, "flash_bwd_dkv",
                                  torch.float32) == (32, 64)


def test_new_sources_build_with_the_others():
    header = (CSRC / "mma_sm90.cuh").read_text()
    for name in ("flash_fwd_mma", "flash_fwd_f32mma", "flash_bwd_dq_mma",
                 "flash_bwd_dkv_mma"):
        assert name in cuda_build.SOURCES
        text = (CSRC / f"{name}.cu").read_text()
        assert '#include "mma_sm90.cuh"' in text
        assert "mma.sync" in header
    # the float32 K1 splits its operands with the header's helpers
    f32 = (CSRC / "flash_fwd_f32mma.cu").read_text()
    for helper in ("split_tile", "mma_split3", "split_pack"):
        assert helper in f32 and f"{helper}(" in header
    assert "flash_fwd" not in cuda_build.SOURCES   # the SIMT K1 is gone
    assert not (CSRC / "flash_fwd.cu").exists()
    # the header is part of every library's build key
    p = cuda_build.library_path("flash_fwd_mma")
    assert p.name.startswith("libflash_fwd_mma-") and p.suffix == ".so"


def test_tile_sweep_rewrites_only_the_tile_of_the_shipped_source():
    """tile_sweep.py's first variant of each source is the source as it
    ships; each other one changes only its tile constexprs and blocks a
    SM, into whole mma tiles of one m16 row block a warp."""
    assert set(tile_sweep.SWEEPS) == {"flash_fwd_f32mma", "flash_bwd_dq_mma"}
    for source in tile_sweep.SWEEPS:
        _check_tile_variants(source)


def _check_tile_variants(source):
    text = (CSRC / f"{source}.cu").read_text()
    variants = list(tile_sweep.SWEEPS[source].values())
    shipped_blocks = variants[0][1]
    assert variants[0][0] == {}
    assert f"__launch_bounds__(THREADS, {shipped_blocks})" in text
    assert tile_sweep.variant_source(text, {}, shipped_blocks) == text
    for consts, blocks in variants[1:]:
        out = tile_sweep.variant_source(text, consts, blocks)
        tile = cuda_build.parse_constexprs(out)
        assert tile["BLOCK_M"] == 16 * tile["WARPS"]
        assert tile["BLOCK_M"] % tile["BLOCK_N"] == 0
        assert tile["BLOCK_N"] % 16 == 0
        for name, value in consts.items():
            assert f"constexpr int {name} = {value};" in out
        assert f"__launch_bounds__(THREADS, {blocks})" in out
        changed = [(a, b) for a, b in zip(text.splitlines(),
                                           out.splitlines()) if a != b]
        assert len(changed) == len(consts) + (blocks != shipped_blocks)


def test_misaligned_views_are_found():
    buf = torch.zeros(2 * 64 * 128 + 8, dtype=torch.bfloat16)
    good = buf[:2 * 64 * 128].view(2, 64, 128)
    bad = buf[1:1 + 2 * 64 * 128].view(2, 64, 128)
    assert bad.is_contiguous()
    assert fa._misaligned((good,)) == []
    assert fa._misaligned((good, bad)) == [bad]
    assert fa._misaligned((buf[8:8 + 2 * 64 * 128],)) == []   # 16 bytes on


@pytest.mark.parametrize("symbol", sorted(chip_smoke.TILE_CONSTEXPRS))
def test_only_cp_async_kernels_need_16_byte_alignment(symbol):
    """The alignment check applies to the kernels that copy their tiles
    by cp.async (those built on mma_sm90.cuh, the float32 K1 among
    them); the SIMT K2 and K3 load element by element and take any
    contiguous view."""
    text = (CSRC / f"{_library_of(symbol)}.cu").read_text()
    assert (symbol in fa._CP_ASYNC) == ('#include "mma_sm90.cuh"' in text)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    fa.reset_launch_counts()
    q = torch.randn(2, 16, 64, dtype=torch.bfloat16)
    o, lse = fa.flash_fwd(q, q, q, 0.125, True)
    want_o, want_lse = fa.ref_attention_lse(q, q, q, 0.125, True)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        assert w.launches == 0
        assert not any(w.launches_by_kernel.values())
    assert fa.flash_fwd.launches_by_kernel == {"flash_fwd_f32mma": 0,
                                               "flash_fwd_mma": 0}
    assert fa.flash_bwd_dq.launches_by_kernel == {"flash_bwd_dq": 0,
                                                  "flash_bwd_dq_mma": 0}
    assert fa.flash_bwd_dkv.launches_by_kernel == {"flash_bwd_dkv": 0,
                                                   "flash_bwd_dkv_mma": 0}


def test_sass_counts_parse_cuobjdump_text():
    sass = """
        Function : _ZN12_GLOBAL__N_120flash_fwd_mma_kernelI6__halfLi64EEEvPKT_
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x000a00ff017b82 */
        /*0c50*/                   HMMA.16816.F32.BF16 R32, R40, R24, R32 ;
        /*0c60*/              @!P0 HMMA.16816.F32.BF16 R36, R40, R26, R36 ;
        /*0c70*/                   FFMA R3, R4, R5, R3 ;
        Function : _ZN12_GLOBAL__N_116flash_fwd_kernelIfLi64EEEvPKT_
        /*0000*/                   FFMA R3, R4, R5, R3 ;
    """
    counts = cuda_build.parse_sass_counts(sass, "HMMA")
    assert list(counts.values()) == [2, 0]
    assert "flash_fwd_mma_kernel" in next(iter(counts))


# --- why the tensor-core kernels split P and dS into hi + lo halves ---

def _tier_ratio(got, want, dt):
    """chip_smoke.py's 16-bit tier: worst |got - want| over rtol 1e-2 x
    |want| + 1e-2 x RMS(want), both rounded once to ``dt``."""
    w = want.to(dt).float()
    atol = 1e-2 * float(w.square().mean().sqrt())
    return float(((got.to(dt).float() - w).abs()
                  / (atol + 1e-2 * w.abs())).max())


def _rounding_ratios(dt, seed=0, bh=2, t=2048, d=128):
    """The err / limit of O, dQ, dK and dV at the training shape when the
    product's 16-bit operand (P, or dS) is rounded once to ``dt``, and
    when it is split into hi + lo halves of ``dt``; the rest in float32
    as in the kernels."""
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy((rng.randn(bh, t, d) * 0.5)
                                .astype(np.float32)).to(dt).float()
               for _ in range(3))
    do = torch.from_numpy(rng.randn(bh, t, d).astype(np.float32)) \
        .to(dt).float()
    sc = 1 / math.sqrt(d)
    mask = torch.ones(t, t, dtype=torch.bool).triu(1)
    s = (q @ k.transpose(1, 2) * sc).masked_fill(mask, fa.NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    lse = (m + torch.log(l))[..., 0]
    o = p @ v / l
    delta = (do * o.to(dt).float()).sum(-1)
    pn = torch.exp(s - lse[..., None]).masked_fill(mask, 0.0)
    ds = pn * (do @ v.transpose(1, 2) - delta[..., None]) * sc

    def once(x):
        return x.to(dt).float()

    def split(x):
        hi = once(x)
        return hi + once(x - hi)

    out = {}
    for how, r in (("once", once), ("split", split)):
        out[how] = {
            "O": _tier_ratio(r(p) @ v / l, o, dt),
            "dQ": _tier_ratio(r(ds) @ k, ds @ k, dt),
            "dK": _tier_ratio(r(ds).transpose(1, 2) @ q,
                              ds.transpose(1, 2) @ q, dt),
            "dV": _tier_ratio(r(pn).transpose(1, 2) @ do,
                              pn.transpose(1, 2) @ do, dt)}
    return out


def test_one_bf16_rounding_of_p_misses_the_tier_and_the_split_meets_it():
    """At the training shape (T = 2048, D = 128, causal; two heads), a
    P or dS rounded once to bf16 before its product puts O, dQ, dK and
    dV over the 16-bit tier's limit (late rows average ~2000 values of
    ~1e-2, so 2^-9 per term exceeds 1e-2 x RMS); hi + lo halves keep
    every output within it, one output rounding apart. So every
    tensor-core kernel splits its P or dS operand."""
    r = _rounding_ratios(torch.bfloat16)
    assert all(x > 1.0 for x in r["once"].values()), r
    assert all(x < 0.8 for x in r["split"].values()), r
