"""Which CUDA kernel each attention wrapper launches, which shapes go to
the plain versions instead, the tiles the kernels use, and why the
tensor-core kernels split their probabilities — all on the CPU (the
kernels themselves run only on the card: tests/test_torch_kernels_gpu.py,
chip_smoke.py). Why the float32 kernels split every operand:
tests/test_torch_f32_split.py.
"""
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import residency_check
import split_check
import tile_sweep
from paddle_tpu_torch.ops import cuda_build
from paddle_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "paddle_tpu_torch" / "csrc"


def _library_of(symbol):
    """The csrc library that builds kernel ``symbol``."""
    return next(lib for routes in (*fa._ROUTES.values(),
                                   fa._WGMMA_ROUTES.values())
                for lib, sym in routes if sym == symbol)


# the warpgroup kernels: at head dims 256 and 128 K1, K2 and K3 on bf16
# and fp16 and on float32; at head dim 64 K1, K2 and K3 on float32
WGMMA_SOURCES = ("flash_fwd_d256_wgmma", "flash_bwd_dq_d256_wgmma",
                 "flash_bwd_dkv_d256_wgmma", "flash_fwd_f32_d256_wgmma",
                 "flash_bwd_dq_f32_d256_wgmma",
                 "flash_bwd_dkv_f32_d256_wgmma", "flash_fwd_d128_wgmma",
                 "flash_bwd_dkv_d128_wgmma", "flash_bwd_dq_d128_wgmma",
                 "flash_bwd_dkv_f32_d64_wgmma", "flash_bwd_dq_f32_d64_wgmma",
                 "flash_fwd_f32_d64_wgmma", "flash_fwd_f32_d128_wgmma",
                 "flash_bwd_dq_f32_d128_wgmma",
                 "flash_bwd_dkv_f32_d128_wgmma")
# the warpgroup kernels sized for two resident blocks an SM, which
# export <symbol>_blocks_per_sm
TWO_BLOCK_SOURCES = ("flash_bwd_dq_f32_d64_wgmma", "flash_fwd_f32_d64_wgmma",
                     "flash_fwd_f32_d128_wgmma")
# the TPU kernel (pallas_attention.py line and function) each replaces
REPLACES = {"flash_fwd_d256_wgmma": ":59 _fa_kernel",
            "flash_bwd_dq_d256_wgmma": ":223 _fa_bwd_dq_kernel",
            "flash_bwd_dkv_d256_wgmma": ":189 _fa_bwd_dkv_kernel",
            "flash_fwd_f32_d256_wgmma": ":59 _fa_kernel",
            "flash_bwd_dq_f32_d256_wgmma": ":223 _fa_bwd_dq_kernel",
            "flash_bwd_dkv_f32_d256_wgmma": ":189 _fa_bwd_dkv_kernel",
            "flash_fwd_d128_wgmma": ":59 _fa_kernel",
            "flash_bwd_dkv_d128_wgmma": ":189 _fa_bwd_dkv_kernel",
            "flash_bwd_dq_d128_wgmma": ":223 _fa_bwd_dq_kernel",
            "flash_bwd_dkv_f32_d64_wgmma": ":189 _fa_bwd_dkv_kernel",
            "flash_bwd_dq_f32_d64_wgmma": ":223 _fa_bwd_dq_kernel",
            "flash_fwd_f32_d64_wgmma": ":59 _fa_kernel",
            "flash_fwd_f32_d128_wgmma": ":59 _fa_kernel",
            "flash_bwd_dq_f32_d128_wgmma": ":223 _fa_bwd_dq_kernel",
            "flash_bwd_dkv_f32_d128_wgmma": ":189 _fa_bwd_dkv_kernel"}
# each warpgroup kernel's warpgroups, and the (producer, consumer)
# registers setmaxnreg gives them (None: no reallocation)
WARPGROUPS = {"flash_fwd_d256_wgmma": (3, (24, 240)),
              "flash_bwd_dq_d256_wgmma": (3, (24, 240)),
              "flash_bwd_dkv_d256_wgmma": (3, (24, 240)),
              "flash_fwd_f32_d256_wgmma": (2, None),
              "flash_bwd_dq_f32_d256_wgmma": (2, None),
              "flash_bwd_dkv_f32_d256_wgmma": (3, (104, 200)),
              "flash_fwd_d128_wgmma": (3, (24, 240)),
              "flash_bwd_dkv_d128_wgmma": (3, (24, 240)),
              "flash_bwd_dq_d128_wgmma": (3, (24, 240)),
              "flash_bwd_dkv_f32_d64_wgmma": (3, (136, 184)),
              "flash_bwd_dq_f32_d64_wgmma": (2, (88, 168)),
              "flash_fwd_f32_d64_wgmma": (2, (88, 168)),
              "flash_fwd_f32_d128_wgmma": (2, (88, 168)),
              "flash_bwd_dq_f32_d128_wgmma": (2, None),
              "flash_bwd_dkv_f32_d128_wgmma": (3, (136, 184))}
# what kernel_for returned at head dims 64, 128 and 384 before the D = 128
# and D = 64 warpgroup kernels: the mma.sync kernel of each (wrapper,
# route)
MMA_SYMBOLS = {("flash_fwd", False): "flash_fwd_mma",
               ("flash_fwd", True): "flash_fwd_f32mma",
               ("flash_bwd_dq", False): "flash_bwd_dq_mma",
               ("flash_bwd_dq", True): "flash_bwd_dq_f32mma",
               ("flash_bwd_dkv", False): "flash_bwd_dkv_mma",
               ("flash_bwd_dkv", True): "flash_bwd_dkv_f32mma"}


@pytest.mark.parametrize("wrapper,dtype,want", [
    ("flash_fwd", torch.bfloat16, "flash_fwd_mma"),
    ("flash_fwd", torch.float16, "flash_fwd_mma"),
    ("flash_fwd", torch.float32, "flash_fwd_f32mma"),
    ("flash_bwd_dkv", torch.bfloat16, "flash_bwd_dkv_mma"),
    ("flash_bwd_dkv", torch.float16, "flash_bwd_dkv_mma"),
    ("flash_bwd_dkv", torch.float32, "flash_bwd_dkv_f32mma"),
    ("flash_bwd_dq", torch.bfloat16, "flash_bwd_dq_mma"),
    ("flash_bwd_dq", torch.float16, "flash_bwd_dq_mma"),
    ("flash_bwd_dq", torch.float32, "flash_bwd_dq_f32mma"),
])
@pytest.mark.parametrize("d", [64, 128])
def test_routing_maps_dtypes_to_kernels(wrapper, dtype, want, d):
    """16-bit inputs go to the 16-bit tensor-core kernels of K1, K2 and
    K3, float32 to the split-operand ones; at D 128 K1, K2 and K3 on
    both routes to their warpgroup kernels, at D 64 float32 K1, K2 and
    K3 to theirs. The library is the source the symbol is built from."""
    lib, sym = fa.kernel_for(wrapper, dtype, d)
    if d == 128 and dtype != torch.float32:
        want = f"{wrapper}_d128_wgmma"
    if d == 128 and dtype == torch.float32:
        want = f"{wrapper}_f32_d128_wgmma"
    if d == 64 and dtype == torch.float32:
        want = f"{wrapper}_f32_d64_wgmma"
    assert sym == want
    assert lib in cuda_build.SOURCES
    assert f'extern "C" int {sym}(' in (CSRC / f"{lib}.cu").read_text()
    assert set(getattr(fa, wrapper).launches_by_kernel) >= {sym}


@pytest.mark.parametrize("wrapper,dtype,want", [
    ("flash_fwd", torch.bfloat16, "flash_fwd_d256_wgmma"),
    ("flash_fwd", torch.float16, "flash_fwd_d256_wgmma"),
    ("flash_fwd", torch.float32, "flash_fwd_f32_d256_wgmma"),
    ("flash_bwd_dq", torch.bfloat16, "flash_bwd_dq_d256_wgmma"),
    ("flash_bwd_dq", torch.float16, "flash_bwd_dq_d256_wgmma"),
    ("flash_bwd_dq", torch.float32, "flash_bwd_dq_f32_d256_wgmma"),
    ("flash_bwd_dkv", torch.bfloat16, "flash_bwd_dkv_d256_wgmma"),
    ("flash_bwd_dkv", torch.float16, "flash_bwd_dkv_d256_wgmma"),
    ("flash_bwd_dkv", torch.float32, "flash_bwd_dkv_f32_d256_wgmma"),
])
def test_routing_at_head_dim_256(wrapper, dtype, want):
    """At D 256 K1, K2 and K3 go to their warpgroup kernels on both
    routes, bf16 and fp16 and float32; at D 384 every route is the
    sliced mma.sync kernel that D 64 runs (but float32, whose D 64
    kernels are their own). Each
    symbol is built from the source of its name, takes as many pointers
    as its wrapper hands it, and is counted by reset_launch_counts."""
    lib, sym = fa.kernel_for(wrapper, dtype, 256)
    assert lib == sym == want and lib in cuda_build.SOURCES
    text = (CSRC / f"{lib}.cu").read_text()
    sig = text[text.index(f'extern "C" int {sym}('):]
    n_ptrs = {"flash_fwd": 5, "flash_bwd_dq": 7, "flash_bwd_dkv": 8}[wrapper]
    assert sig[:sig.index(")")].count("*") == n_ptrs + 1   # + the stream
    assert sym in getattr(fa, wrapper).launches_by_kernel
    mma = (MMA_SYMBOLS[wrapper, dtype == torch.float32],) * 2
    assert fa.kernel_for(wrapper, dtype, 384) == mma
    if dtype != torch.float32:
        assert fa.kernel_for(wrapper, dtype, 64) == mma


@pytest.mark.parametrize("wrapper", ["flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_routing_at_head_dim_128(wrapper, dtype):
    """At D 128 16-bit K1, K2 and K3 go to their warpgroup kernels
    (flash_fwd_d128_wgmma, flash_bwd_dq_d128_wgmma,
    flash_bwd_dkv_d128_wgmma), and so do float32 K1, K2 and K3
    (flash_fwd_f32_d128_wgmma, flash_bwd_dq_f32_d128_wgmma,
    flash_bwd_dkv_f32_d128_wgmma); at D 64 float32 K1, K2 and K3 go to
    theirs (flash_fwd_f32_d64_wgmma, flash_bwd_dq_f32_d64_wgmma,
    flash_bwd_dkv_f32_d64_wgmma); every 16-bit route at D 64 and every
    route at D 384 keep the mma.sync kernels they ran before, which
    float32 K3 at D 128 ran until it had its own. Each new symbol is built
    from the source of its name, takes as many pointers as its wrapper
    hands it, is one lookup of the (wrapper, route, head dim) table and
    is counted by reset_launch_counts."""
    f32 = dtype == torch.float32
    mma = MMA_SYMBOLS[wrapper, f32]
    assert fa.kernel_for(wrapper, dtype, 384) == (mma, mma)
    if f32:
        own = {64: f"{wrapper}_f32_d64_wgmma",
               128: f"{wrapper}_f32_d128_wgmma"}
        assert fa.kernel_for(wrapper, dtype, 128) != (mma, mma)
    else:
        own = {128: f"{wrapper}_d128_wgmma"}
        assert fa.kernel_for(wrapper, dtype, 64) == (mma, mma)
    route = fa.F32_ROUTE if f32 else fa.HALF_ROUTE
    for d, want in own.items():
        lib, sym = fa.kernel_for(wrapper, dtype, d)
        assert lib == sym == want
        assert fa._WGMMA_ROUTES[wrapper, route, d] == (lib, sym)
        assert lib in cuda_build.SOURCES
        text = (CSRC / f"{lib}.cu").read_text()
        sig = text[text.index(f'extern "C" int {sym}('):]
        n_ptrs = {"flash_fwd": 5, "flash_bwd_dq": 7,
                  "flash_bwd_dkv": 8}[wrapper]
        assert sig[:sig.index(")")].count("*") == n_ptrs + 1   # + stream
        fa.reset_launch_counts()
        assert getattr(fa, wrapper).launches_by_kernel[sym] == 0

@pytest.mark.parametrize("dtype,d,match", [
    (torch.float64, 128, "float32, bfloat16 or float16"),
    (torch.int32, 128, "float32, bfloat16 or float16"),
    (torch.bfloat16, 96, "head dims"),
    # head dims past 128 that are multiples of it (the reference's
    # D % 128 == 0 gate) are not refused: this case holds that K1, K2
    # and K3 at 256 route to their warpgroup kernels on every dtype, and
    # every dtype at 384 to the sliced mma.sync kernels
    pytest.param(torch.float32, 256, None, id="dtype3-256-head dims"),
])
@pytest.mark.parametrize("wrapper", ["flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv"])
def test_routing_raises_for_what_no_kernel_takes(wrapper, dtype, d, match):
    if match is None:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            sliced = (MMA_SYMBOLS[wrapper, dt == torch.float32],) * 2
            assert fa.kernel_for(wrapper, dt, 384) == sliced
            own = (f"{wrapper}_f32_d256_wgmma" if dt == torch.float32
                   else f"{wrapper}_d256_wgmma")
            assert fa.kernel_for(wrapper, dt, 256) == (own, own) != sliced
        return
    with pytest.raises(ValueError, match=match):
        fa.kernel_for(wrapper, dtype, d)


@pytest.mark.parametrize("d,kernels", [(8, False), (16, False), (32, False),
                                       (96, False), (64, True), (128, True),
                                       (256, True), (192, False),
                                       (384, True)])
def test_head_dim_gate_sends_what_no_kernel_takes_to_the_plain_route(
        d, kernels):
    """On a CUDA tensor, head dim 64 and every multiple of 128 (256 and
    384 in 128-column slices) go to the kernels at any T; a head dim
    that is neither 64 nor a multiple of 128 (LLAMA_TINY's 16,
    TRANSFORMER_TINY's 8, 192) to the plain versions, as the reference's
    gate (D % 128 == 0) sends it to its plain path, and kernel_for
    refuses only those non-multiples. A CPU tensor always takes the
    wrappers' plain versions."""
    for t in (16, 128, 2048):
        cuda = types.SimpleNamespace(device=torch.device("cuda", 0),
                                     shape=(2, 4, t, d))
        assert fa.takes_kernels(cuda) is kernels
        assert fa.takes_kernels(torch.zeros(1, 1, t, d))
    if kernels:
        for dt in (torch.float32, torch.bfloat16):
            assert fa.kernel_for("flash_fwd", dt, d)[1] in \
                set(fa.flash_fwd.launches_by_kernel) - {fa.PLAIN}
    else:
        with pytest.raises(ValueError, match="head dims"):
            fa.kernel_for("flash_fwd", torch.float32, d)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_route_computes_what_the_wrappers_do_and_counts_it(
        monkeypatch, causal):
    """The plain route of FlashAttention (taken on CUDA by a head dim no
    kernel takes; here forced on CPU tensors) gives the outputs and
    gradients of the wrappers' CPU path, and counts one "plain" call on
    each wrapper per forward and backward, no kernel launch."""
    r = np.random.RandomState(3)
    arrs = [(r.randn(2, 4, 24, 16) * 0.5).astype(np.float32)
            for _ in range(3)]
    do = torch.from_numpy(r.randn(2, 4, 24, 16).astype(np.float32))
    dl = torch.from_numpy(r.randn(2, 4, 24).astype(np.float32))
    outs = {}
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(fa, "takes_kernels", lambda x: False)
        fa.reset_launch_counts()
        ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
        o, lse = fa.attention_with_lse(*ts, causal=causal)
        grads = torch.autograd.grad((o * do).sum() + (lse * dl).sum(), ts)
        outs[plain] = (o, lse) + grads
        for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
            assert w.launches == 0
            assert w.launches_by_kernel[fa.PLAIN] == int(plain)
    for got, want in zip(outs[True], outs[False]):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


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


@pytest.mark.parametrize("d,want", [
    # the warpgroup K1, K2 and K3: 128-row q tiles over 128-key stages,
    # 128-row q tiles over 64-key stages, and 128-key blocks over 64-row
    # q tiles
    (128, {"flash_fwd": (128, 128), "flash_bwd_dq": (128, 64),
           "flash_bwd_dkv": (64, 128)}),
    # the warpgroup kernels: K2's 128 q rows over 32-key stages
    (256, {"flash_fwd": (128, 64), "flash_bwd_dq": (128, 32),
           "flash_bwd_dkv": (64, 64)})])
def test_planted_faults_follow_the_bf16_kernels_tiles(d, want):
    """chip_smoke.py plants its tile faults at the tiles of the kernels
    the bf16 training shape of head dim ``d`` runs, read from the
    sources' constexprs."""
    assert chip_smoke.planted_fault_tiles(torch, fa, d) == want


def _plain_pairs(q, k, v, do, sc, dt):
    """chip_smoke's (kernel output, plain version) pairs with the plain
    outputs standing in for kernels that agree exactly, and the forward's
    lse and delta."""
    o, lse = fa.ref_attention_lse(q.float(), k.float(), v.float(), sc, True)
    o = o.to(dt)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.ref_flash_bwd_dq(q, k, v, do, lse, delta, sc, True)
    dk, dv = fa.ref_flash_bwd_dkv(q, k, v, do, lse, delta, sc, True)
    pairs = {"O": (o, o), "dQ": (dq, dq), "dK": (dk, dk), "dV": (dv, dv)}
    errs = {n: chip_smoke.kernel_err(g, w) for n, (g, w) in pairs.items()}
    return pairs, errs, lse, delta


def test_planted_faults_are_caught_at_the_d128_training_shape():
    """At the Llama training shape (one head here: T 2048, D 128,
    causal), every fault chip_smoke.py plants at the tiles of the
    kernels that shape runs (K1's 128-row q tiles, K2's 128-row q tiles
    over 64-key stages, K3's 128-key blocks over 64-row q tiles) fails
    the 16-bit tier where the kernels agree exactly."""
    r = np.random.RandomState(7)
    t, d = chip_smoke.TRAIN_SEQ, 128
    q, k, v = (torch.from_numpy((r.randn(1, t, d) * 0.5).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    do = torch.from_numpy(r.randn(1, t, d).astype(np.float32)) \
        .to(torch.bfloat16)
    sc = 1 / math.sqrt(d)
    pairs, errs, lse, delta = _plain_pairs(q, k, v, do, sc, torch.bfloat16)
    logged = []
    chip_smoke.log, log = logged.append, chip_smoke.log
    try:
        chip_smoke.check_planted_faults(
            torch, fa, (q, k, v, do, lse, delta), sc, pairs, errs,
            chip_smoke.TRAIN_LABEL)
    finally:
        chip_smoke.log = log
    assert len(logged) == 7 and all(" caught" in x for x in logged), logged
    for fault in ("K1 leaves its last 128-row q tile unwritten",
                  "K2 leaves its last 128-row q tile unwritten",
                  "K2 skips each q tile's last 64-key tile",
                  "K3 leaves its last 128-key tile unwritten",
                  "K3 skips its last 64-row q tile"):
        assert any(fault in x for x in logged), (fault, logged)


def test_planted_faults_are_caught_at_the_d256_training_shape():
    """At the head_dim_256 phase's bf16 training shape (one head here:
    T 2048, D 256, causal), every fault chip_smoke.py plants at the
    warpgroup kernels' tiles (K2's 128-row q tiles over 32-key stages
    among them) fails the 16-bit tier where the kernels agree exactly."""
    r = np.random.RandomState(5)
    t, d = chip_smoke.TRAIN_SEQ, 256
    q, k, v = (torch.from_numpy((r.randn(1, t, d) * 0.5).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    do = torch.from_numpy(r.randn(1, t, d).astype(np.float32)) \
        .to(torch.bfloat16)
    sc = 1 / 16
    pairs, errs, lse, delta = _plain_pairs(q, k, v, do, sc, torch.bfloat16)
    logged = []
    chip_smoke.log, log = logged.append, chip_smoke.log
    try:
        chip_smoke.check_planted_faults(
            torch, fa, (q, k, v, do, lse, delta), sc, pairs, errs,
            chip_smoke.HD256_LABEL)
    finally:
        chip_smoke.log = log
    assert len(logged) == 7 and all(" caught" in x for x in logged), logged
    assert any("K2 skips each q tile's last 32-key tile" in x
               for x in logged), logged


def test_planted_f32_faults_follow_float32_k1s_warpgroup_tile():
    """At head dim 256 the float32 faults are planted at the warpgroup
    kernels' tiles: K1's 64 q rows over 32-key tiles, K2's 64 rows over
    16-key tiles, K3's 64 keys over 16-row q tiles (q rows, keys), none
    the sliced mma.sync kernels' tiles (D 384)."""
    assert chip_smoke.HD256_F32_LABEL in chip_smoke.F32_FAULT_CASES
    for w, tile in (("flash_fwd", (64, 32)), ("flash_bwd_dq", (64, 16)),
                    ("flash_bwd_dkv", (16, 64))):
        assert chip_smoke.kernel_tile(fa, w, torch.float32, 256) == tile
        assert chip_smoke.kernel_tile(fa, w, torch.float32, 384) != tile


def test_planted_f32_faults_are_caught_at_the_d256_train_step():
    """At the head_dim_256 phase's float32 step shape (B*H 1*16, T 256,
    D 256, causal) every float32 fault, K1's at its warpgroup tile,
    fails the float32 tier where the kernels agree exactly."""
    r = np.random.RandomState(6)
    bh, t, d = chip_smoke.HD256_F32_BATCH * chip_smoke.HD256_HEADS, \
        chip_smoke.HD256_F32_SEQ, 256
    q, k, v = (torch.from_numpy((r.randn(bh, t, d) * 0.5)
                                .astype(np.float32)) for _ in range(3))
    do = torch.from_numpy(r.randn(bh, t, d).astype(np.float32))
    sc = 1 / 16
    pairs, errs, lse, delta = _plain_pairs(q, k, v, do, sc, torch.float32)
    logged = []
    chip_smoke.log, log = logged.append, chip_smoke.log
    try:
        chip_smoke.check_planted_f32_faults(
            torch, fa, chip_smoke.HD256_F32_LABEL,
            (q, k, v, do, lse, delta), sc, pairs, errs)
    finally:
        chip_smoke.log = log
    assert len(logged) == 8 and all(" caught" in x for x in logged), logged
    for fault in ("K1 f32 skips each q tile's last 32-key tile",
                  "K2 f32 skips each q tile's last 16-key tile",
                  "K3 f32 skips its last 16-row q tile",
                  "K3 f32 leaves its last 64-key tile unwritten"):
        assert any(fault in x for x in logged), (fault, logged)


def test_planted_f32_faults_are_caught_at_the_transformer_d64_shape():
    """At Transformer-base's causal self-attention (two heads here: T
    256, D 64) the float32 faults are planted at the tiles of the
    kernels that shape runs, K3's the warpgroup kernel's 64 keys over
    64-row q tiles, and each fails the float32 tier where the kernels
    agree exactly."""
    assert chip_smoke.TF_CAUSAL_LABEL in chip_smoke.F32_FAULT_CASES
    assert chip_smoke.kernel_tile(fa, "flash_bwd_dkv", torch.float32,
                                  64) == (64, 64)
    r = np.random.RandomState(8)
    bh, t, d = 2, chip_smoke.TF_SEQ, 64
    q, k, v = (torch.from_numpy((r.randn(bh, t, d) * 0.5)
                                .astype(np.float32)) for _ in range(3))
    do = torch.from_numpy(r.randn(bh, t, d).astype(np.float32))
    sc = 1 / 8
    pairs, errs, lse, delta = _plain_pairs(q, k, v, do, sc, torch.float32)
    logged = []
    chip_smoke.log, log = logged.append, chip_smoke.log
    try:
        chip_smoke.check_planted_f32_faults(
            torch, fa, chip_smoke.TF_CAUSAL_LABEL,
            (q, k, v, do, lse, delta), sc, pairs, errs)
    finally:
        chip_smoke.log = log
    assert len(logged) == 8 and all(" caught" in x for x in logged), logged
    for fault in ("K3 f32 leaves its last 64-key tile unwritten",
                  "K3 f32 skips its last 64-row q tile"):
        assert any(fault in x for x in logged), (fault, logged)


@pytest.mark.parametrize("wrapper,tile", [("flash_fwd", (64, 32)),
                                          ("flash_bwd_dq", (64, 64)),
                                          ("flash_bwd_dkv", (32, 64))])
def test_planted_f32_faults_follow_the_f32_kernels_tiles(wrapper, tile):
    """The float32 faults at D 128 are planted at the tiles of the
    kernels that head dim runs (K1, K2 and K3 their warpgroup kernels'),
    (q rows, keys) read from their sources' constexprs."""
    lib, sym = fa.kernel_for(wrapper, torch.float32, 128)
    assert sym == chip_smoke.f32_kernel(torch, fa, wrapper, 128)
    values = cuda_build.constexprs(lib)
    assert (values["BLOCK_M"], values["BLOCK_N"]) == tile
    assert chip_smoke.kernel_tile(fa, wrapper, torch.float32) == tile


def test_planted_f32_faults_are_caught_where_the_kernels_agree():
    """chip_smoke's float32 faults, planted in the plain outputs (which
    stand for kernels that agree exactly) at f32 causal's shape, each
    fail the float32 tier: K1's and K2's last q tile unwritten or each
    q tile's last key tile skipped, K3's last key tile unwritten or its
    last q tile skipped."""
    r = np.random.RandomState(4)
    q, k, v = (torch.from_numpy((r.randn(2, 256, 64) * 0.5)
                                .astype(np.float32)) for _ in range(3))
    do = torch.from_numpy(r.randn(2, 256, 64).astype(np.float32))
    sc = 1 / 8
    o, lse = fa.ref_attention_lse(q, k, v, sc, True)
    delta = (do * o).sum(-1)
    dq = fa.ref_flash_bwd_dq(q, k, v, do, lse, delta, sc, True)
    dk, dv = fa.ref_flash_bwd_dkv(q, k, v, do, lse, delta, sc, True)
    pairs = {"O": (o, o), "dQ": (dq, dq), "dK": (dk, dk), "dV": (dv, dv)}
    errs = {n: chip_smoke.kernel_err(g, w) for n, (g, w) in pairs.items()}
    logged = []
    chip_smoke.log, log = logged.append, chip_smoke.log
    try:
        chip_smoke.check_planted_f32_faults(
            torch, fa, "f32 causal", (q, k, v, do, lse, delta), sc, pairs,
            errs)
    finally:
        chip_smoke.log = log
    assert len(logged) == 8 and all(" caught" in x for x in logged), logged


@pytest.mark.parametrize("name", cuda_build.SOURCES)
def test_new_sources_build_with_the_others(name):
    """Every source is a tensor-core kernel on the shared header, whose
    library is keyed by it; the float32 ones split their operands with
    the header's helpers (the backward also into TF32 halves). The SIMT
    sources are gone."""
    header = (CSRC / "mma_sm90.cuh").read_text()
    text = (CSRC / f"{name}.cu").read_text()
    assert '#include "mma_sm90.cuh"' in text
    assert "mma.sync" in header
    assert f'extern "C" int {name}(' in text
    helpers = {"flash_fwd_f32mma": ("split_tile", "mma_split3",
                                    "split_pack"),
               "flash_bwd_dq_f32mma": ("split_tile", "mma_split3",
                                       "split_pack", "mma_split3_tf32",
                                       "split_tf32"),
               "flash_bwd_dkv_f32mma": ("split_tile", "mma_split3",
                                        "split_pack", "mma_split3_tf32",
                                        "split_tf32")}.get(name, ())
    for helper in helpers:
        assert helper in text and f"{helper}(" in header
    # B*H past gridDim.y's limit is launched in chunks, by one helper
    assert "for_bh_chunks(" in text and "65535" not in text
    assert "b0 += MAX_GRID_Y" in header and "b0 += MAX_GRID_Y" not in text
    assert fa.MAX_GRID_Y == 65535
    for gone in ("flash_fwd", "flash_bwd"):   # the SIMT kernels
        assert gone not in cuda_build.SOURCES
        assert not (CSRC / f"{gone}.cu").exists()
    # the header is part of every library's build key
    p = cuda_build.library_path(name)
    assert p.name.startswith(f"lib{name}-") and p.suffix == ".so"


@pytest.mark.parametrize("source", sorted(tile_sweep.SWEEPS))
def test_tile_sweep_rewrites_only_the_tile_of_the_shipped_source(source):
    """tile_sweep.py's first variant of each source is the source as it
    ships; each other one changes only its tile constexprs and blocks a
    SM, into whole mma tiles: one m16 row block a warp (K1, K2), or 16
    keys a warp and whole 16-row k-steps of its q rows (K3); float32
    K3's warpgroup kernel at D 128 its q tile's rows (an m64n32 or
    m64n64 product) and ring stages within a block's shared memory, and
    its registers as setmaxnreg must redistribute them."""
    assert set(tile_sweep.SWEEPS) == {
        "flash_fwd_f32mma", "flash_bwd_dq_mma", "flash_bwd_dq_f32mma",
        "flash_bwd_dkv_f32mma", "flash_bwd_dkv_f32_d128_wgmma"}
    assert set(tile_sweep.N_PTRS) == set(tile_sweep.SWEEPS)
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
        assert tile["BLOCK_N"] % 16 == 0
        if source == "flash_bwd_dkv_f32_d128_wgmma":
            assert tile["BLOCK_M"] in (32, 64) and tile["STAGES"] >= 1
            assert tile["SMEM_BYTES"] <= 232448
            assert tile["PRODUCER_REGS"] + 2 * tile["CONSUMER_REGS"] \
                == 3 * 168
        elif source == "flash_bwd_dkv_f32mma":
            assert tile["KGROUPS"] * tile["RGROUPS"] == tile["WARPS"]
            assert tile["WROWS"] % 16 == 0
        else:
            assert tile["BLOCK_M"] == 16 * tile["WARPS"]
            assert tile["BLOCK_M"] % tile["BLOCK_N"] == 0
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
    """Every kernel copies its tiles by cp.async (mma_sm90.cuh's
    load_tile_async) or, the warpgroup kernels, by TMA (wgmma_sm90.cuh's
    tma_load_3d, whose tensor maps want a 16-byte aligned base), so the
    wrappers refuse any input off a 16-byte boundary: no SIMT kernel
    that took any contiguous view is left."""
    lib = _library_of(symbol)
    text = (CSRC / f"{lib}.cu").read_text()
    assert '#include "mma_sm90.cuh"' in text
    if lib in WGMMA_SOURCES:
        assert "tma_load_3d(" in text and "load_tile_async<" not in text
        assert "cp.async.bulk.tensor" in \
            (CSRC / "wgmma_sm90.cuh").read_text()
    else:
        assert "load_tile_async<" in text
    assert "cp.async" in (CSRC / "mma_sm90.cuh").read_text()


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    fa.reset_launch_counts()
    q = torch.randn(2, 16, 64, dtype=torch.bfloat16)
    o, lse = fa.flash_fwd(q, q, q, 0.125, True)
    want_o, want_lse = fa.ref_attention_lse(q, q, q, 0.125, True)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        assert w.launches == 0
        assert not any(w.launches_by_kernel.values())
    assert fa.flash_fwd.launches_by_kernel == {
        "flash_fwd_f32mma": 0, "flash_fwd_mma": 0, "flash_fwd_d256_wgmma": 0,
        "flash_fwd_f32_d256_wgmma": 0, "flash_fwd_d128_wgmma": 0,
        "flash_fwd_f32_d64_wgmma": 0, "flash_fwd_f32_d128_wgmma": 0,
        "plain": 0}
    assert fa.flash_bwd_dq.launches_by_kernel == {
        "flash_bwd_dq_f32mma": 0, "flash_bwd_dq_mma": 0,
        "flash_bwd_dq_d256_wgmma": 0, "flash_bwd_dq_f32_d256_wgmma": 0,
        "flash_bwd_dq_d128_wgmma": 0, "flash_bwd_dq_f32_d64_wgmma": 0,
        "flash_bwd_dq_f32_d128_wgmma": 0, "plain": 0}
    assert fa.flash_bwd_dkv.launches_by_kernel == {
        "flash_bwd_dkv_f32mma": 0, "flash_bwd_dkv_mma": 0,
        "flash_bwd_dkv_d256_wgmma": 0, "flash_bwd_dkv_f32_d256_wgmma": 0,
        "flash_bwd_dkv_d128_wgmma": 0, "flash_bwd_dkv_f32_d64_wgmma": 0,
        "flash_bwd_dkv_f32_d128_wgmma": 0, "plain": 0}


@pytest.mark.parametrize("name", WGMMA_SOURCES)
def test_wgmma_sources_name_their_design(name):
    """The warpgroup kernels (every route at head dims 256 and 128,
    float32 K1, K2 and K3 at 64):
    warpgroup products (wgmma) fed by TMA from a producer warpgroup
    (which setmaxnreg brings down beside the consumers, to exactly the
    launch's registers a thread: 168 for one block of three warpgroups an
    SM, 128 for two blocks of two; float32 K1's and K2's one consumer at
    D 256, and float32 K2's at D 128, needs no reallocation, and their
    sources say so), built for sm_90a, where alone those instructions
    exist; each source names the TPU kernel it replaces, its
    shared-memory budget and ptxas's registers and spills, and its
    kernel's SASS is held to HGMMA by chip_smoke.py. Each is the route
    kernel_for names at its source's D for its dtypes, and the only
    head dim of the routing table that names it."""
    text = (CSRC / f"{name}.cu").read_text()
    header = (CSRC / "wgmma_sm90.cuh").read_text()
    assert f"paddle_tpu/ops/pallas_attention.py{REPLACES[name]}" in text
    assert '#include "wgmma_sm90.cuh"' in text
    for word in ("wgmma", "TMA", "setmaxnreg", "of the 227 KB", "ptxas",
                 "spill", "What bounds it on the H100"):
        assert word in text, word
    assert "wgmma.mma_async" in header and "setmaxnreg" in header
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    values = cuda_build.constexprs(name)
    dims = {d for (_, _, d), (lib, _) in fa._WGMMA_ROUTES.items()
            if lib == name}
    assert dims == {values["D"]} and values["D"] in (64, 128, 256)
    assert values["SMEM_BYTES"] <= 232448          # 227 KB a block
    f32 = "f32" in name
    groups, regs = WARPGROUPS[name]
    assert values["THREADS"] == groups * 128       # producer + consumers
    if regs is None:
        assert "setmaxnreg_" not in text
    else:
        producer, consumer = regs
        # the launch's registers a thread: the register file over the
        # resident threads, in the allocation's steps of 8
        launch = 65536 // (values["THREADS"]
                           * values.get("BLOCKS_PER_SM", 1)) // 8 * 8
        assert launch == {3: 168, 2: 128}[groups]
        assert producer * 128 + consumer * 128 * (groups - 1) \
            == launch * 128 * groups
        assert (f"setmaxnreg_dec<{producer}>" in text
                and f"setmaxnreg_inc<{consumer}>" in text) or (
            values.get("PRODUCER_REGS") == producer
            and values.get("CONSUMER_REGS") == consumer
            and "setmaxnreg_dec<PRODUCER_REGS>" in text
            and "setmaxnreg_inc<CONSUMER_REGS>" in text)
    assert f"{name}_kernel" in chip_smoke.WGMMA_KERNELS
    assert f"{name}_kernel" not in chip_smoke.MMA_KERNELS
    wrapper = name.replace("_f32", "").replace(f"_d{values['D']}_wgmma",
                                                 "")
    dtypes = (torch.float32,) if f32 else (torch.bfloat16, torch.float16)
    for dt in dtypes:
        assert fa.kernel_for(wrapper, dt, values["D"]) == (name, name)


@pytest.mark.parametrize("name", WGMMA_SOURCES)
def test_two_block_kernels_export_their_occupancy(name):
    """Float32 K1 and K2 at head dim 64 and float32 K1 at head dim 128
    are sized for two resident blocks an SM: BLOCKS_PER_SM 2 in the
    source, launch bounds that ask for it, and an exported
    ``<symbol>_blocks_per_sm``, the card's
    occupancy count at the kernel's shared memory, which chip_smoke.py
    holds to BLOCKS_PER_SM (``check_occupancy``). The other warpgroup
    kernels run one block an SM and export none."""
    text = (CSRC / f"{name}.cu").read_text()
    values = cuda_build.constexprs(name)
    if name in TWO_BLOCK_SOURCES:
        assert values["BLOCKS_PER_SM"] == 2
        assert "__launch_bounds__(THREADS, BLOCKS_PER_SM)" in text
        assert f'extern "C" int {name}_blocks_per_sm(void)' in text
        assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor(" in text
    else:
        assert "BLOCKS_PER_SM" not in values
        assert "_blocks_per_sm" not in text
        assert "__launch_bounds__(THREADS, 1)" in text


@pytest.mark.parametrize("name", TWO_BLOCK_SOURCES)
def test_occupancy_gate_fails_a_kernel_off_its_design(name):
    """chip_smoke.py's occupancy gate: every kernel whose source gives
    BLOCKS_PER_SM must report that many resident blocks on the card;
    one that fits fewer (registers or shared memory past the design's)
    fails the run."""
    logged = []
    log, chip_smoke.log = chip_smoke.log, logged.append
    try:
        fake = types.SimpleNamespace(
            _WGMMA_ROUTES=fa._WGMMA_ROUTES,
            blocks_per_sm=lambda route: 2)
        got = chip_smoke.check_occupancy(fake, cuda_build)
        assert got == {s: 2 for s in TWO_BLOCK_SOURCES}
        fake.blocks_per_sm = lambda route: 1 if route[1] == name else 2
        with pytest.raises(chip_smoke.SmokeFailure,
                           match=f"{name}: 1 resident blocks an SM"):
            chip_smoke.check_occupancy(fake, cuda_build)
    finally:
        chip_smoke.log = log
    assert any("blocks an SM" in x for x in logged)


@pytest.mark.parametrize("name", TWO_BLOCK_SOURCES)
def test_residency_check_changes_only_the_residency(name):
    """residency_check.py's variants of each two-block kernel: the
    source as it ships; the same code with its shared memory padded
    past half the SM's 228 KB (one block an SM, nothing else changed);
    and one block an SM with a ring deep enough to fill a block's room.
    Both one-block variants fit a block's 227 KB and drop only the
    assertion that two blocks fit."""
    assert set(residency_check.DEEPER_RING) == set(TWO_BLOCK_SOURCES)
    slots, n_ptrs = residency_check.DEEPER_RING[name]
    text = (CSRC / f"{name}.cu").read_text()
    got = residency_check.variants(text, slots)
    assert got[residency_check.SHIPPED] == text
    shipped = cuda_build.constexprs(name)
    for label, src in got.items():
        if label == residency_check.SHIPPED:
            continue
        values = cuda_build.parse_constexprs(src)
        changed = {k for k in shipped if values[k] != shipped[k]}
        if "same ring" in label:
            assert changed == {"SMEM_BYTES"}
        else:
            assert {"SLOTS", "SMEM_BYTES", "OFF_BAR"} >= changed >= {"SLOTS"}
            assert values["SLOTS"] == slots
        assert 233472 // 2 < values["SMEM_BYTES"] + 1024
        assert values["SMEM_BYTES"] <= 232448
        gone = [a for a in text.splitlines() if a not in src.splitlines()]
        assert sum(g.startswith("static_assert(BLOCKS_PER_SM *")
                   for g in gone) == 1
        assert len(gone) == 3     # the assertion's two lines, one constant
    sig = text[text.index(f'extern "C" int {name}('):]
    assert sig[:sig.index(")")].count("*") == n_ptrs + 1   # + the stream


@pytest.mark.parametrize("name", sorted(split_check.LO_PRODUCTS))
def test_split_check_cuts_only_the_lo_product(name):
    """split_check.py's "hi only" variant of each 16-bit warpgroup
    kernel (K1, K2, K3) is the shipped source less the wgmma that take
    the lo halves of P (or dS); its "hi + lo" variant is the source as
    it ships."""
    assert set(split_check.LO_PRODUCTS) == {
        s for s in WGMMA_SOURCES if "f32" not in s}
    lo_lines, n_ptrs = split_check.LO_PRODUCTS[name]
    text = (CSRC / f"{name}.cu").read_text()
    got = split_check.variants(text, lo_lines)
    assert got["hi + lo (shipped)"] == text
    cut = [a.strip() for a, b in zip(text.splitlines(),
                                     got["hi only"].splitlines()) if a != b]
    assert len(got["hi only"].splitlines()) == len(text.splitlines())
    assert cut == list(lo_lines)
    sig = text[text.index(f'extern "C" int {name}('):]
    assert sig[:sig.index(")")].count("*") == n_ptrs + 1   # + the stream


@pytest.mark.parametrize("fallen", WGMMA_SOURCES)
def test_sass_gate_holds_wgmma_kernels_to_hgmma(fallen):
    """chip_smoke.py's SASS gate: every mma.sync kernel shows HMMA and
    every warpgroup kernel HGMMA; any one warpgroup kernel that fell
    back to mma.sync (HMMA and no HGMMA) fails it."""
    assert set(chip_smoke.WGMMA_KERNELS) == {
        f"{s}_kernel" for s in WGMMA_SOURCES}

    def sass(hgmma_of_fallen):
        def counts(name, opcode):
            fn = f"_ZN_{name}_kernelI13__nv_bfloat16EEv"
            if name in WGMMA_SOURCES:
                n = (hgmma_of_fallen if name == fallen else 24) \
                    if opcode == "HGMMA" else 16
            else:
                n = 8 if opcode == "HMMA" else 0
            return {fn: n}
        return types.SimpleNamespace(SOURCES=cuda_build.SOURCES,
                                     sass_counts=counts)

    logged = []
    chip_smoke.log, log = logged.append, chip_smoke.log
    try:
        chip_smoke.check_sass(sass(24))
        with pytest.raises(chip_smoke.SmokeFailure,
                           match=f"{fallen}_kernel: no HGMMA"):
            chip_smoke.check_sass(sass(0))
    finally:
        chip_smoke.log = log
    assert any("HGMMA" in x for x in logged)


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
