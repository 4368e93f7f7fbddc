"""Why the float32 flash-attention forward (K1 on float32,
``csrc/flash_fwd_f32mma.cu``) splits every operand of both its products
into bf16 hi + lo halves and takes each product as three tensor-core
products — an emulation on the CPU of the kernel's arithmetic, held to
the float32 tier chip_smoke.py holds the kernel to on the card.

The tier is rtol 2e-4 / atol 2e-5 (``chip_smoke.TOL_F32``, from
tests/test_attention.py). A tensor-core operand carries 8 significant
bits in bf16 and 11 in TF32, so one rounding of Q, K, P and V moves O by
~2^-9 or ~2^-12 of its size: more than the tier allows. Splitting x into
hi = round(x) and lo = round(x - hi) keeps ~2^-17 of x, and
hi·hi + hi·lo + lo·hi drops only lo·lo (~2^-18 of the product), so the
split meets the tier with room for what no emulation models (the tensor
cores' own accumulation order). Both products need it: S = Q Kᵀ feeds
exp, whose relative error is S's absolute one, and P V averages V,
whose rounding passes straight into O.

The backward's kernels (K2, K3) split theirs too, and the head-dim-256
warpgroup ones (``csrc/flash_bwd_dq_f32_d256_wgmma.cu``,
``csrc/flash_bwd_dkv_f32_d256_wgmma.cu``) take a third bf16 piece of dO
where the D = 128 kernels take TF32 halves: the emulation below chooses
that scheme, and shared memory's 227 KB rules out the TF32 one. Float32
K3 at head dim 64 (``csrc/flash_bwd_dkv_f32_d64_wgmma.cu``) takes the
same pieces: both schemes meet the tier there, and the pieces cost fewer
tensor-core products. So does float32 K2 at head dim 64
(``csrc/flash_bwd_dq_f32_d64_wgmma.cu``), whose dO takes its third piece
for the short sequences; it and float32 K1 there
(``csrc/flash_fwd_f32_d64_wgmma.cu``) are sized for two blocks an SM.
At head dim 128 float32 K2 (``csrc/flash_bwd_dq_f32_d128_wgmma.cu``)
takes the same pieces where the mma.sync kernel took 3xTF32 (both meet
the tier; the pieces cost fewer products and leave room for two stages
of k and v), and float32 K1 (``csrc/flash_fwd_f32_d128_wgmma.cu``) is
sized for two blocks an SM; float32 K3 there
(``csrc/flash_bwd_dkv_f32_d128_wgmma.cu``) takes D = 64's and 256's
pieces, with 32-row q tiles so that a ring of them fits beside k and v.
"""
import math

import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.ops import cuda_build
from paddle_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
MASKED = np.float32(fa.NEG_INF)


def _bf16(x):
    """x rounded to the nearest bf16, back in float32."""
    return x.to(torch.bfloat16).float()


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds; back in float32."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def _once(rnd):
    return lambda a, b: rnd(a) @ rnd(b)


def _split3(rnd):
    """a @ b as the kernel takes it: hi·hi + hi·lo + lo·hi of ``rnd``
    halves, float32 sums."""
    def mm(a, b):
        ah, bh = rnd(a), rnd(b)
        al, bl = rnd(a - ah), rnd(b - bh)
        return ah @ bh + (ah @ bl + al @ bh)
    return mm


def _emulate(q, k, v, scale, causal, mm):
    """K1's arithmetic with the products taken by ``mm``: scores in base
    2 (scale and log2(e) in one multiply), masked scores at -1e30 in
    base 2, keys past tk absent, P = 2^(x - m) in float32, l summed from
    the float32 P, O = (P V) / l, lse = m ln 2 + ln l."""
    tq, tk = q.shape[-2], k.shape[-2]
    x = mm(q, k.transpose(-1, -2)) * np.float32(scale * LOG2E)
    if causal:
        rows = torch.arange(tq)[:, None]
        cols = torch.arange(tk)[None, :]
        x = x.masked_fill(rows + (tk - tq) < cols, MASKED * np.float32(LOG2E))
    m = x.amax(-1, keepdim=True)
    p = torch.exp2(x - m)
    l = p.sum(-1, keepdim=True)
    o = mm(p, v) / l
    lse = (m * np.float32(math.log(2)) + torch.log(l))[..., 0]
    return o, lse


def _ratio(got, want):
    """Worst |got - want| / (atol + rtol |want|) in the float32 tier."""
    rtol, atol = chip_smoke.TOL_F32
    return float(((got.double() - want).abs()
                  / (atol + rtol * want.abs())).max())


# (bh, tq, tk, d, causal): chip_smoke.py's float32 cases, and the
# training sequence with two heads
CASES = {
    "serving T=128": (128, 128, 128, 128, True),
    "serving T=256": (128, 256, 256, 128, True),
    "causal": (8, 256, 256, 128, True),
    "non-causal": (8, 256, 256, 128, False),
    "tq<tk causal": (8, 128, 256, 128, True),
    "tq>tk causal (fully masked rows)": (8, 256, 128, 128, True),
    "ragged T=200 causal": (8, 200, 200, 128, True),
    "ragged T=200 non-causal": (8, 200, 200, 128, False),
    "D=64 causal": (8, 256, 256, 64, True),
    "T=2048, two heads": (2, 2048, 2048, 128, True),
}


def _ratios(bh, tq, tk, d, causal, seed=0):
    """{how: (O err/limit, lse err/limit)} for one rounding of every
    operand to bf16 and to TF32, and for the three-product split of
    each, against the float64 plain version rounded to float32."""
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy((rng.randn(bh, t, d) * 0.5)
                                .astype(np.float32))
               for t in (tq, tk, tk))
    scale = 1.0 / math.sqrt(d)
    o_ref, lse_ref = fa.ref_attention_lse(q.double(), k.double(),
                                          v.double(), scale, causal)
    want_o, want_lse = o_ref.float().double(), lse_ref.float().double()
    out = {}
    for how, mm in (("bf16 once", _once(_bf16)), ("tf32 once", _once(_tf32)),
                    ("3xbf16", _split3(_bf16)), ("3xtf32", _split3(_tf32))):
        o, lse = _emulate(q, k, v, scale, causal, mm)
        out[how] = (_ratio(o, want_o), _ratio(lse, want_lse))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_one_rounding_misses_the_f32_tier_and_the_3xbf16_split_meets_it(
        case):
    """One bf16 or TF32 rounding of the operands puts O over the f32
    tier's limit; the kernel's 3×bf16 split keeps O and lse under half
    of it (the margin left for the tensor cores' accumulation order)."""
    r = _ratios(*CASES[case])
    assert r["bf16 once"][0] > 1.0, r
    assert r["tf32 once"][0] > 1.0, r
    assert max(r["3xbf16"]) < 0.5, r
    assert max(r["3xtf32"]) <= max(r["3xbf16"]), r


def test_the_split_halves_hold_float32s_range():
    """bf16 keeps float32's exponent range, so lo = round(x - hi) is a
    normal number where fp16's would flush: the split keeps ~16
    significant bits from 1e-30 to 1e30."""
    x = torch.tensor([1e-30, 3.14159265, 1.1e30, -2.5e-20], dtype=torch.float32)
    hi = _bf16(x)
    lo = _bf16(x - hi)
    rel = ((hi + lo).double() - x.double()).abs() / x.double().abs()
    assert bool((rel < 2.0 ** -16).all()), rel
    rel_once = (hi.double() - x.double()).abs() / x.double().abs()
    assert float(rel_once.max()) > 2.0 ** -12


# --- the backward: why K2 and K3 on float32 split their products, and
# why dP = dO Vᵀ and dV = Pᵀ dO are taken in 3xTF32 ---

def _mm(a, b):
    return a @ b


def _emulate_bwd(q, k, v, do, lse, delta, scale, causal, mms):
    """K2's and K3's arithmetic with the products S = Q Kᵀ, dP = dO Vᵀ,
    dQ = dS K, dK = dSᵀ Q and dV = Pᵀ dO taken by the five functions
    ``mms``, in that order: P = 2^(S scale log2(e) - lse log2(e)),
    dS = P (dP - delta) scale, masked entries 0, fully masked rows at
    P = 1/tk and dS = 0. Returns (dQ, dK, dV)."""
    mm_s, mm_dp, mm_dq, mm_dk, mm_dv = mms
    tq, tk = q.shape[-2], k.shape[-2]
    s = mm_s(q, k.transpose(-1, -2))
    if q.dtype == torch.float64:   # the plain version: exact exp
        p = torch.exp(s * scale - lse[..., None])
    else:
        p = torch.exp2(s * np.float32(scale * LOG2E)
                       - lse[..., None] * np.float32(LOG2E))
    ds = p * (mm_dp(do, v.transpose(-1, -2)) - delta[..., None]) \
        * np.float32(scale)
    if causal:
        rows = torch.arange(tq)[:, None]
        cols = torch.arange(tk)[None, :]
        masked = rows + (tk - tq) < cols
        p = torch.where(rows + (tk - tq) < 0, 1.0 / tk,
                        p.masked_fill(masked, 0.0)).to(q.dtype)
        ds = ds.masked_fill(masked, 0.0)
    return (mm_dq(ds, k), mm_dk(ds.transpose(-1, -2), q),
            mm_dv(p.transpose(-1, -2), do))


_B3, _T3 = _split3(_bf16), _split3(_tf32)
# the backward's schemes, each the functions of (S, dP, dQ, dK, dV);
# "shipped" is what flash_bwd_dq_f32mma.cu (S, dP, dQ) and
# flash_bwd_dkv_f32mma.cu (S, dP, dK, dV) take
BWD_SCHEMES = {"bf16 once": (_once(_bf16),) * 5,
               "tf32 once": (_once(_tf32),) * 5,
               "3xbf16": (_B3,) * 5,
               "3xtf32": (_T3,) * 5,
               "shipped": (_B3, _T3, _B3, _B3, _T3)}


def _bwd_ratios(bh, tq, tk, d, causal, seed, schemes=BWD_SCHEMES):
    """{scheme: (dQ, dK, dV err/limit)} for each of ``schemes`` against
    the float64 plain backward rounded to float32, on the inputs the
    kernels get: float32 q, k, v, dO, the forward's lse rounded to
    float32 and delta = rowsum(dO O) in float32."""
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy((rng.randn(bh, t, d) * 0.5)
                                .astype(np.float32))
               for t in (tq, tk, tk))
    do = torch.from_numpy(rng.randn(bh, tq, d).astype(np.float32))
    scale = 1.0 / math.sqrt(d)
    o, lse = _emulate(q.double(), k.double(), v.double(), scale, causal, _mm)
    lse = lse.float()
    delta = (do * o.float()).sum(-1)
    want = [x.float().double() for x in _emulate_bwd(
        q.double(), k.double(), v.double(), do.double(), lse.double(),
        delta.double(), scale, causal, (_mm,) * 5)]
    return {how: tuple(_ratio(g, w) for g, w in zip(
                _emulate_bwd(q, k, v, do, lse, delta, scale, causal, mms),
                want))
            for how, mms in schemes.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_backward_one_rounding_misses_the_f32_tier_and_the_shipped_split_meets_it(
        case, seed):
    """dQ, dK and dV: one bf16 or TF32 rounding of the operands misses
    the f32 tier on every causal case (and at least one output misses it
    without the mask). The kernels' scheme — S = Q Kᵀ, dQ = dS K and
    dK = dSᵀ Q as 3×bf16 splits, dP = dO Vᵀ and dV = Pᵀ dO as 3×TF32
    splits — keeps all three under half of the limit on every case and
    seed, and under a 3×bf16 split of every product. The 3×bf16 dP
    is what costs dQ and dK (the cancellation in dP - delta), the 3×bf16
    Pᵀ dO what costs dV: at the f32 serving shape they pass 0.5."""
    bh, tq, tk, d, causal = CASES[case]
    r = _bwd_ratios(bh, tq, tk, d, causal, seed)
    for once in ("bf16 once", "tf32 once"):
        if causal:
            assert min(r[once]) > 1.0, r
        else:
            assert max(r[once]) > 1.0, r
    assert max(r["shipped"]) < 0.5, r
    assert max(r["shipped"]) < max(r["3xbf16"]), r


# --- head dim 256: the warpgroup kernels' scheme
# (csrc/flash_bwd_dq_f32_d256_wgmma.cu, flash_bwd_dkv_f32_d256_wgmma.cu).
# wgmma reads a TF32 operand from shared memory only K-major, and TF32
# pieces take 8 bytes an element, so the D = 128 kernels' 3xTF32 dP and
# dV do not carry over; what does is a third bf16 piece ---

def _pieces3(x):
    """x as hi = round(x), mid = round(x - hi), lo = round(x - hi - mid)
    in bf16 (split3_pack): ~24 significant bits."""
    hi = _bf16(x)
    r = x - hi
    mid = _bf16(r)
    return hi, mid, _bf16(r - mid)


def _split5(a, b):
    """a @ b with a in three bf16 pieces and b in two: the five products
    down to ~2^-24 of the product (ah bh, ah bl, am bh, am bl, al bh)."""
    ah, am, al = _pieces3(a)
    bh = _bf16(b)
    bl = _bf16(b - bh)
    return ah @ bh + (ah @ bl + am @ bh) + (am @ bl + al @ bh)


def _split5_b(a, b):
    """a @ b with a in two bf16 pieces and b in three (:func:`_split5`
    transposed)."""
    return _split5(b.transpose(-1, -2), a.transpose(-1, -2)).transpose(-1, -2)


def _split6(a, b):
    """a @ b with both in three bf16 pieces: six products (ah bh, ah bm,
    am bh, am bm, ah bl, al bh)."""
    ah, am, al = _pieces3(a)
    bh, bm, bl = _pieces3(b)
    return ah @ bh + (ah @ bm + am @ bh) + (am @ bm + ah @ bl + al @ bh)


def _tf32_trunc(x):
    """x as a TF32 operand read from a float32 tile: its low 13 bits
    ignored (truncation), as CUTLASS's fast 3xTF32 path assumes."""
    u = x.contiguous().view(torch.int32)
    return (u & ~0x1FFF).view(torch.float32)


_T3T = _split3(_tf32_trunc)
# (S, dP, dQ, dK, dV) at D = 256. "shipped" is what both warpgroup
# kernels take: S, dQ and dK as 3xbf16, dP = dO Vᵀ with dO's three
# pieces against V's two (five products), dV = Pᵀ dO with both in three
# (six); "runner-up" takes dV with Pᵀ in two halves (five products);
# "3xtf32, hi in place" is the D = 128 kernels' TF32 dP and dV with the
# float32 tile itself as the TF32 hi
BWD_SCHEMES_D256 = {"bf16 once": (_once(_bf16),) * 5,
                    "tf32 once": (_once(_tf32),) * 5,
                    "3xbf16": (_B3,) * 5,
                    "3xtf32, hi in place": (_B3, _T3T, _B3, _B3, _T3T),
                    "runner-up": (_B3, _split5, _B3, _B3, _split5_b),
                    "shipped": (_B3, _split5, _B3, _B3, _split6)}

# (bh, tq, tk, d, causal): head_dim_256's float32 train step (B*H 1*16,
# T 256, causal), and chip_smoke.py's other float32 D = 256 shapes at
# T <= 256
D256_CASES = {
    "f32 D=256 train step": (16, 256, 256, 256, True),
    "non-causal": (8, 256, 256, 256, False),
    "tq<tk causal": (8, 128, 256, 256, True),
    "tq>tk causal (fully masked rows)": (8, 256, 128, 256, True),
    "ragged T=200 causal": (8, 200, 200, 256, True),
}


def _bwd_ratios_d256(case, seed):
    return _bwd_ratios(*D256_CASES[case], seed, schemes=BWD_SCHEMES_D256)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", list(D256_CASES))
def test_d256_backward_one_rounding_misses_the_f32_tier_and_the_shipped_pieces_meet_it(
        case, seed):
    """At head dim 256: one bf16 or TF32 rounding of the operands misses
    the f32 tier (every output on the causal cases, one at least without
    the mask). The warpgroup kernels' scheme — dO in three bf16 pieces
    in dP = dO Vᵀ, dO and Pᵀ in three in dV = Pᵀ dO, everything else in
    two — keeps dQ, dK and dV under half of the limit on every case and
    seed, and under the 3×bf16 split's worst; so does the runner-up (Pᵀ
    in two halves, five products for dV) on these shapes, with less room
    on dV."""
    causal = D256_CASES[case][4]
    r = _bwd_ratios_d256(case, seed)
    for once in ("bf16 once", "tf32 once"):
        if causal:
            assert min(r[once]) > 1.0, r
        else:
            assert max(r[once]) > 1.0, r
    assert max(r["shipped"]) < 0.5, r
    assert max(r["runner-up"]) < 0.5, r
    assert max(r["shipped"]) < max(r["3xbf16"]), r
    assert r["runner-up"][:2] == r["shipped"][:2]   # only dV differs


def test_d256_two_bf16_pieces_miss_the_margin_and_tf32_would_not():
    """Why dO takes a third piece: with two (3×bf16 everywhere) dQ
    passes half the limit at the train step's shape (the cancellation
    in dP - delta) and dV on the ragged causal case. The D = 128
    kernels' 3×TF32 dP and dV, with the float32 tile itself as the TF32
    hi (its low 13 bits ignored), would meet the tier too; it does not
    fit (below)."""
    step = _bwd_ratios_d256("f32 D=256 train step", 0)
    ragged = _bwd_ratios_d256("ragged T=200 causal", 0)
    assert step["3xbf16"][0] > 0.5 and ragged["3xbf16"][2] > 0.5
    for r in (step, ragged):
        assert max(r["3xtf32, hi in place"]) < 0.5, r


# bytes an element of each operand a scheme keeps in shared memory:
# 2 a bf16 piece; 4 + 4 a TF32 operand (its float32 tile as the hi, its
# remainder), another 4 + 4 if wgmma must read it transposed (TF32 only
# K-major)
_PIECE, _TF32 = 2, 8


def _d256_smem(scheme):
    """Shared memory of K2 (64 q rows resident, four 16-key slots that
    each land a float32 tile first) and K3 (64 keys resident, two stages
    of a 16-row q tile, the Pᵀ exchange) under ``scheme``: "shipped"
    (q, k, v in two bf16 pieces, dO in three) or "3xtf32" (dO and v as
    TF32 for dP, and dO transposed as TF32 for K3's dV, beside a single
    k / v tile for K2)."""
    d = 256
    if scheme == "shipped":
        k2 = 64 * d * (2 + 3) * _PIECE + 4 * 16 * d * 4
        k3 = (64 * d * (2 + 2) * _PIECE
              + 2 * 16 * d * (2 + 3) * _PIECE + 2 * 64 * 16 * 4)
    else:
        k2 = 64 * d * (2 * _PIECE + _TF32) + 16 * d * (2 * _PIECE + _TF32)
        k3 = (64 * d * (2 * _PIECE + _TF32)
              + 2 * 16 * d * (2 * _PIECE + _TF32 + _TF32) + 2 * 64 * 16 * 4)
    return k2, k3


def test_d256_the_shipped_pieces_fit_and_tf32_does_not():
    """The shipped scheme is what the kernels lay out (their sources'
    OFF_BAR, where the barriers follow the tiles), within a block's
    227 KB; the TF32 scheme needs more than that in both kernels."""
    limit = 232448 - 256 - 1024          # 227 KB less barriers, alignment
    k2, k3 = _d256_smem("shipped")
    assert k2 == cuda_build.constexprs("flash_bwd_dq_f32_d256_wgmma")[
        "OFF_BAR"]
    assert k3 == cuda_build.constexprs("flash_bwd_dkv_f32_d256_wgmma")[
        "OFF_BAR"]
    assert max(k2, k3) <= limit
    assert min(_d256_smem("3xtf32")) > limit


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_d256_the_sixth_dv_product_holds_the_margin_at_t32(seed):
    """Why Pᵀ takes a third piece in dV: at T 32 (chip_smoke's B·H past
    65535 shape, here B·H 512) Pᵀ in two halves (the runner-up, five
    products) puts dV past half the limit, as the card showed at B·H
    65536 (0.84); the sixth product keeps it under."""
    r = _bwd_ratios(512, 32, 32, 256, True, seed, schemes={
        k: BWD_SCHEMES_D256[k] for k in ("runner-up", "shipped")})
    assert r["runner-up"][2] > 0.5, r
    assert r["shipped"][2] < 0.5, r


# --- head dim 64: float32 K3's warpgroup kernel
# (csrc/flash_bwd_dkv_f32_d64_wgmma.cu). Two schemes could serve it: the
# D = 256 kernels' bf16 pieces, or the mma.sync kernels' 3xTF32 dPᵀ and
# dV, which at D 64 would fit (TF32 wgmma reads shared memory only
# K-major, so dV needs dO transposed: 16 KB a 64-row tile) ---

BWD_SCHEMES_D64 = {"bf16 once": (_once(_bf16),) * 5,
                   "tf32 once": (_once(_tf32),) * 5,
                   "pieces (shipped)": BWD_SCHEMES_D256["shipped"],
                   "3xtf32": BWD_SCHEMES["shipped"]}
# bf16 tensor-core products a visible pair costs each scheme in dPᵀ = V
# dOᵀ and dV = Pᵀ dO, a TF32 product at half the bf16 rate (S and dK
# are 3xbf16 in both)
D64_PRODUCT_COST = {"pieces (shipped)": 5 + 6, "3xtf32": 2 * (3 + 3)}

# (bh, tq, tk, d, causal): chip_smoke.py's float32 D = 64 case and
# Transformer-base's unpadded cross-attention (tq 128 over tk 256), cut
# to 16 heads
D64_CASES = {"D=64 causal": CASES["D=64 causal"],
             "D=64 cross tq<tk": (16, 128, 256, 64, False)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", list(D64_CASES))
def test_d64_backward_one_rounding_misses_the_f32_tier_and_both_schemes_meet_it(
        case, seed):
    """At head dim 64: one bf16 or TF32 rounding of the operands puts
    dQ, dK and dV over the f32 tier's limit, causal or not. Both
    candidate schemes for K3 keep dK and dV under half of the limit on
    every case and seed; the shipped one, the D = 256 kernels' bf16
    pieces, costs fewer tensor-core products than 3xTF32 dPᵀ and dV."""
    r = _bwd_ratios(*D64_CASES[case], seed, schemes=BWD_SCHEMES_D64)
    for once in ("bf16 once", "tf32 once"):
        assert min(r[once]) > 1.0, r
    for scheme in D64_PRODUCT_COST:
        assert max(r[scheme][1:]) <= 0.5, (scheme, r)
    assert D64_PRODUCT_COST["pieces (shipped)"] < D64_PRODUCT_COST["3xtf32"]


def _dkv_smem(d, rows, stages=2):
    """Shared memory of float32 K3 in the warpgroup design at head dim
    ``d`` with ``rows``-row q tiles: 64 keys of k and v in two bf16
    pieces, ``stages`` ring stages of a q tile in two and a dO tile in
    three, and the Pᵀ exchange (64 keys x ``rows`` float32, two
    buffers)."""
    return (64 * d * (2 + 2) * _PIECE + stages * rows * d * (2 + 3) * _PIECE
            + 2 * 64 * rows * 4)


def test_d64_takes_64_row_q_tiles_where_d256_could_not():
    """What changes at head dim 64 is room: the D = 64 kernel lays out
    64-row q tiles (m64n64k16 products; its source's OFF_BAR, where the
    barriers follow the tiles) well within a block's 227 KB, where at
    D = 256 a 64-row tile needs more than twice that and 16 rows is what
    fits."""
    limit = 232448 - 256 - 1024          # 227 KB less barriers, alignment
    values = cuda_build.constexprs("flash_bwd_dkv_f32_d64_wgmma")
    assert (values["BLOCK_M"], values["BLOCK_N"], values["D"]) == (64, 64, 64)
    assert _dkv_smem(64, 64) == values["OFF_BAR"] <= limit
    assert _dkv_smem(256, 64) > 2 * limit
    assert _dkv_smem(256, 16) == cuda_build.constexprs(
        "flash_bwd_dkv_f32_d256_wgmma")["OFF_BAR"] <= limit


# --- head dim 64: float32 K2 (csrc/flash_bwd_dq_f32_d64_wgmma.cu) and K1
# (csrc/flash_fwd_f32_d64_wgmma.cu), sized for two blocks an SM. K2's
# dP = dO Vᵀ could take dO in three bf16 pieces (D = 256's five
# products) or in two (three products) ---

DQ_SCHEMES_D64 = {"dO in three pieces (shipped)": BWD_SCHEMES_D256["shipped"],
                  "dO in two pieces": (_B3, _B3, _B3, _B3, _split6)}
# (bh, tq, tk, d, causal): the shapes past the Transformer's where K2
# runs at D 64 on the card: chip_smoke.py's B·H past 65535 at T 32 (here
# B·H 512) and the f32 serving bucket T 128 (B·H 4 x 32)
DQ_D64_SHORT_CASES = {"T=32": (512, 32, 32, 64, True),
                      "T=128": (128, 128, 128, 64, True)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", list(D64_CASES))
def test_d64_dq_meets_the_margin_with_both_do_schemes(case, seed):
    """Float32 K2 at head dim 64: its shipped scheme (dO in three bf16
    pieces in dP = dO Vᵀ) keeps dQ under half of the f32 tier's limit at
    the Transformer's shapes on every seed; so would dO in two pieces
    there, the cheaper scheme (three products for dP, not five)."""
    r = _bwd_ratios(*D64_CASES[case], seed, schemes=DQ_SCHEMES_D64)
    for scheme in DQ_SCHEMES_D64:
        assert r[scheme][0] <= 0.5, (scheme, r)


@pytest.mark.parametrize("case", list(DQ_D64_SHORT_CASES))
def test_d64_dq_takes_do_in_three_pieces_for_the_short_sequences(case):
    """Why K2 at head dim 64 ships the dearer scheme: at T 32 and T 128
    dO in two pieces puts dQ past half the limit on at least one of
    seeds 0-2 (the cancellation in dP - delta, as at D 256), where three
    pieces keep it under on all of them."""
    r = [_bwd_ratios(*DQ_D64_SHORT_CASES[case], seed,
                     schemes=DQ_SCHEMES_D64) for seed in (0, 1, 2)]
    assert max(x["dO in two pieces"][0] for x in r) > 0.5, r
    assert max(x["dO in three pieces (shipped)"][0] for x in r) < 0.5, r


def _d64_smem(kernel):
    """Shared memory of float32 K2 and K1 at head dim 64 (64-row q tile
    and 64-key tiles, every piece bf16): K2 q in two pieces, dO in
    three, and a ring of four k / v slots that each land a float32 tile;
    K1 q in two pieces and a ring of five."""
    d, tile_f32 = 64, 64 * 64 * 4
    if kernel == "flash_bwd_dq_f32_d64_wgmma":
        return 64 * d * (2 + 3) * _PIECE + 4 * tile_f32
    return 64 * d * 2 * _PIECE + 5 * tile_f32


@pytest.mark.parametrize("name", ["flash_bwd_dq_f32_d64_wgmma",
                                  "flash_fwd_f32_d64_wgmma"])
def test_d64_k1_and_k2_fit_two_blocks_an_sm(name):
    """Both kernels take 64-row q tiles and 64-key tiles at D 64, and
    are sized so that BLOCKS_PER_SM (2) of them are resident on an SM:
    their shared memory (the tiles up to OFF_BAR, the barriers and the
    alignment, and the 1 KB the SM keeps a block) times BLOCKS_PER_SM
    within the SM's 228 KB, and their threads at the launch's registers
    (setmaxnreg's producer and consumer counts, averaged) times
    BLOCKS_PER_SM within the 65,536 registers."""
    values = cuda_build.constexprs(name)
    assert (values["BLOCK_M"], values["BLOCK_N"], values["D"]) == (64, 64, 64)
    assert _d64_smem(name) == values["OFF_BAR"]
    assert values["SMEM_BYTES"] == values["OFF_BAR"] + 256 + 1024
    blocks = values["BLOCKS_PER_SM"]
    assert blocks == 2
    assert (values["SMEM_BYTES"] + 1024) * blocks <= 233472   # 228 KB
    launch = (values["PRODUCER_REGS"] + values["CONSUMER_REGS"]) // 2
    assert values["THREADS"] == 256 and launch == 128
    assert values["THREADS"] * launch * blocks <= 65536
    # one more ring slot would leave room for one block only
    assert (values["SMEM_BYTES"] + 64 * 64 * 4 + 1024) * blocks > 233472


# --- head dim 128: float32 K1 (csrc/flash_fwd_f32_d128_wgmma.cu, two
# blocks an SM) and K2 (csrc/flash_bwd_dq_f32_d128_wgmma.cu, one). K2's
# dP = dO Vᵀ could take dO in three bf16 pieces against V's two (the
# D = 64 and 256 warpgroup K2s' five products) or 3xTF32 (the mma.sync
# kernel's); dQ = dS K is 3xbf16 in both ---

DQ_SCHEMES_D128 = {"bf16 once": (_once(_bf16),) * 5,
                   "dO in three pieces (shipped)": BWD_SCHEMES_D256["shipped"],
                   "3xtf32": BWD_SCHEMES["shipped"],
                   "dO in two pieces": DQ_SCHEMES_D64["dO in two pieces"]}
# (bh, tq, tk, d, causal): the float32 D = 128 shapes K2 runs on the card
# (chip_smoke.py's serving buckets, the parity shape, tq > tk, ragged,
# T 2048) and T 32, chip_smoke.py's B·H past 65535 (here B·H 512)
D128_DQ_CASES = {**{k: CASES[k] for k in (
    "serving T=128", "serving T=256", "causal",
    "tq>tk causal (fully masked rows)", "ragged T=200 causal",
    "T=2048, two heads")}, "T=32": (512, 32, 32, 128, True)}


def _d128_dq(case, seed):
    """{scheme: dQ err/limit} of DQ_SCHEMES_D128 at D128_DQ_CASES[case]."""
    r = _bwd_ratios(*D128_DQ_CASES[case], seed, schemes=DQ_SCHEMES_D128)
    return {scheme: ratios[0] for scheme, ratios in r.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", list(D128_DQ_CASES))
def test_d128_dq_one_rounding_misses_and_both_dp_schemes_meet_the_margin(
        case, seed):
    """Float32 K2 at head dim 128: one bf16 rounding of the operands puts
    dQ past the f32 tier's limit on every case; both candidate schemes
    for dP = dO Vᵀ, dO in three bf16 pieces (shipped) and 3×TF32, keep
    dQ under half of it on every case and seed, B·H 65536's T 32
    among them."""
    r = _d128_dq(case, seed)
    assert r["bf16 once"] > 1.0, r
    assert r["dO in three pieces (shipped)"] < 0.5, r
    assert r["3xtf32"] < 0.5, r


@pytest.mark.parametrize("case", ["serving T=256", "ragged T=200 causal",
                                  "T=32"])
def test_d128_dq_takes_do_in_three_pieces(case):
    """Why dO takes a third piece at head dim 128, as at 64 and 256: with
    two (three products for dP) dQ passes half the limit on at least one
    of seeds 0-2 at the serving bucket T 256, the ragged causal case and
    T 32 (the cancellation in dP - delta), where three pieces keep it
    under on all of them."""
    r = [_d128_dq(case, seed) for seed in (0, 1, 2)]
    assert max(x["dO in two pieces"] for x in r) > 0.5, r
    assert max(x["dO in three pieces (shipped)"] for x in r) < 0.5, r


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_d128_forward_split_meets_the_margin_at_t32(seed):
    """Float32 K1 at head dim 128 keeps every K1's 3×bf16 split (the
    cases above at D 128); at T 32, B·H 65536's sequence on the card,
    one rounding misses the tier and the split keeps O and lse under
    half of it."""
    r = _ratios(512, 32, 32, 128, True, seed)
    assert r["bf16 once"][0] > 1.0, r
    assert max(r["3xbf16"]) < 0.5, r


# bf16 products a visible pair costs each dP scheme, a TF32 product at
# half the bf16 rate
D128_DP_COST = {"dO in three pieces (shipped)": 5, "3xtf32": 2 * 3}


def _d128_dq_smem(scheme, keys=64, stages=2):
    """Shared memory of float32 K2 at head dim 128: a resident 64-row q
    tile in two bf16 pieces and dO, then ``stages`` stages of a
    ``keys``-key k tile in two bf16 pieces and a v tile. Shipped: dO in
    three bf16 pieces, V in two (each k or v slot lands its float32 tile
    first, the pieces' bytes). 3×TF32: dO and V each as a TF32 hi and lo
    (8 bytes an element); wgmma reads TF32 from shared memory K-major,
    which both operands of dP are."""
    d = 128
    if scheme == "dO in three pieces (shipped)":
        return 64 * d * (2 + 3) * _PIECE + stages * 2 * keys * d * 4
    return (64 * d * (2 * _PIECE + _TF32)
            + stages * keys * d * (2 * _PIECE + _TF32))


def test_d128_dq_pieces_keep_two_stages_where_tf32_fits_one():
    """The shipped pieces cost fewer tensor-core products than 3×TF32,
    and take what the kernel lays out (its source's OFF_BAR: q, dO's
    pieces and two stages of 64 keys) within a block's 227 KB; 3×TF32's
    halves of V would leave room for one 64-key stage only, no k and v
    in flight while a tile's products run."""
    limit = 232448 - 512 - 1024          # 227 KB less barriers, alignment
    values = cuda_build.constexprs("flash_bwd_dq_f32_d128_wgmma")
    assert (values["BLOCK_M"], values["BLOCK_N"], values["D"]) == (64, 64, 128)
    assert values["SLOTS"] == 4          # two stages of a v and a k tile
    shipped = _d128_dq_smem("dO in three pieces (shipped)")
    assert shipped == values["OFF_BAR"] <= limit
    assert _d128_dq_smem("3xtf32", stages=1) <= limit
    assert _d128_dq_smem("3xtf32") > limit
    assert D128_DP_COST["dO in three pieces (shipped)"] < D128_DP_COST[
        "3xtf32"]


@pytest.mark.parametrize("keys", [64, 32])
def test_d128_dq_fits_one_block_an_sm_not_two(keys):
    """Float32 K2 at head dim 128 runs one block an SM: its shared
    memory (the tiles up to OFF_BAR, the barriers and the alignment, and
    the 1 KB the SM keeps a block) fits the SM's 228 KB once and not
    twice, with the shipped 64-key stages and with 32-key ones alike;
    256 threads at 255 registers fit the register file, so no setmaxnreg
    is needed."""
    values = cuda_build.constexprs("flash_bwd_dq_f32_d128_wgmma")
    assert "BLOCKS_PER_SM" not in values
    assert values["SMEM_BYTES"] == values["OFF_BAR"] + 512 + 1024
    smem = _d128_dq_smem("dO in three pieces (shipped)", keys) + 512 + 1024
    if keys == values["BLOCK_N"]:
        assert smem == values["SMEM_BYTES"]
    assert smem + 1024 <= 233472 < 2 * (smem + 1024)
    assert values["THREADS"] == 256 and 256 * 255 <= 65536


def test_d128_k1_fits_two_blocks_an_sm():
    """Float32 K1 at head dim 128 takes a resident 64-row q tile and a
    ring of four 32-key k / v slots, sized so that BLOCKS_PER_SM (2) of
    it are resident on an SM: its shared memory times BLOCKS_PER_SM
    within the SM's 228 KB, its threads at the launch's registers
    (setmaxnreg's producer and consumer counts, averaged) times
    BLOCKS_PER_SM within the 65,536 registers. A fifth slot, or 64-key
    tiles in the same four slots, would leave room for one block."""
    values = cuda_build.constexprs("flash_fwd_f32_d128_wgmma")
    assert (values["BLOCK_M"], values["BLOCK_N"], values["D"]) == (64, 32, 128)
    d, slot = 128, 32 * 128 * 4
    assert values["OFF_BAR"] == 64 * d * 2 * _PIECE + values["SLOTS"] * slot
    assert values["SMEM_BYTES"] == values["OFF_BAR"] + 512 + 1024
    blocks = values["BLOCKS_PER_SM"]
    assert blocks == 2
    assert (values["SMEM_BYTES"] + 1024) * blocks <= 233472   # 228 KB
    launch = (values["PRODUCER_REGS"] + values["CONSUMER_REGS"]) // 2
    assert values["THREADS"] == 256 and launch == 128
    assert values["THREADS"] * launch * blocks <= 65536
    assert (values["SMEM_BYTES"] + slot + 1024) * blocks > 233472
    assert (values["SMEM_BYTES"] + values["SLOTS"] * slot + 1024) \
        * blocks > 233472


# --- head dim 128: float32 K3 (csrc/flash_bwd_dkv_f32_d128_wgmma.cu).
# The D = 64 and 256 warpgroup K3s' pieces, or the mma.sync kernel's
# 3xTF32 dPᵀ and dV: TF32 wgmma reads shared memory only K-major, which
# dV's dO operand is not, and TF32 halves take 8 bytes an element ---

DKV_SCHEMES_D128 = {"bf16 once": (_once(_bf16),) * 5,
                    "pieces (shipped)": BWD_SCHEMES_D256["shipped"],
                    "Pᵀ in two pieces": BWD_SCHEMES_D256["runner-up"]}
# (bh, tq, tk, d, causal): every float32 D = 128 case above (the serving
# buckets, the parity shape causal and not, tq < tk, tq > tk, ragged,
# T 2048) and T 32, chip_smoke.py's B·H past 65535 (here B·H 512)
D128_DKV_CASES = {**{k: v for k, v in CASES.items() if v[3] == 128},
                  "T=32": (512, 32, 32, 128, True)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", list(D128_DKV_CASES))
def test_d128_dkv_one_rounding_misses_and_the_pieces_meet_the_margin(
        case, seed):
    """Float32 K3 at head dim 128: one bf16 rounding of the operands puts
    dK and dV past the f32 tier's limit on every case, causal or not;
    the shipped pieces (dO in three bf16 pieces in dPᵀ = V dOᵀ, Pᵀ and
    dO in three in dV = Pᵀ dO, the rest in two) keep both under half of
    it on every case and seed, B·H 65536's T 32 among them."""
    r = _bwd_ratios(*D128_DKV_CASES[case], seed, schemes={
        k: DKV_SCHEMES_D128[k] for k in ("bf16 once", "pieces (shipped)")})
    assert min(r["bf16 once"][1:]) > 1.0, r
    assert max(r["pieces (shipped)"][1:]) < 0.5, r


def test_d128_dkv_takes_pt_in_three_pieces():
    """Why Pᵀ takes a third piece in dV at head dim 128, as at 256: at
    T 32 (B·H 512) Pᵀ in two halves (five products) puts dV past half the
    limit on at least one of seeds 0-2, where the sixth product keeps it
    under on all of them."""
    r = [_bwd_ratios(*D128_DKV_CASES["T=32"], seed, schemes={
        k: DKV_SCHEMES_D128[k] for k in ("Pᵀ in two pieces",
                                         "pieces (shipped)")})
        for seed in (0, 1, 2)]
    assert max(x["Pᵀ in two pieces"][2] for x in r) > 0.5, r
    assert max(x["pieces (shipped)"][2] for x in r) < 0.5, r


@pytest.mark.parametrize("rows,stages,fits", [(32, 2, True), (32, 3, True),
                                              (64, 1, True), (64, 2, False)])
def test_d128_dkv_layouts_and_the_shipped_one(rows, stages, fits):
    """Float32 K3 at head dim 128: k's and v's pieces take 64 KB, a ring
    stage 40 KB at 32-row q tiles and 80 KB at 64, the Pᵀ exchange 16 or
    32 KB. D = 64's 64-row tiles in two stages need 256 KB, past a
    block's 227 KB; 64 rows fit in one stage (no load overlaps a tile's
    products), 32 rows in two or three. The source lays out what the
    reckoning gives for its BLOCK_M and STAGES (its OFF_BAR, where the
    barriers follow the tiles), 32 rows in two stages, and its pieces
    cost fewer tensor-core products for dPᵀ and dV than 3×TF32's."""
    limit = 232448 - 256 - 1024          # 227 KB less barriers, alignment
    assert (_dkv_smem(128, rows, stages) <= limit) == fits
    values = cuda_build.constexprs("flash_bwd_dkv_f32_d128_wgmma")
    assert (values["BLOCK_M"], values["BLOCK_N"], values["D"],
            values["STAGES"]) == (32, 64, 128, 2)
    assert _dkv_smem(128, values["BLOCK_M"], values["STAGES"]) \
        == values["OFF_BAR"] <= limit
    assert values["SMEM_BYTES"] == values["OFF_BAR"] + 256 + 1024
    assert D64_PRODUCT_COST["pieces (shipped)"] < D64_PRODUCT_COST["3xtf32"]
