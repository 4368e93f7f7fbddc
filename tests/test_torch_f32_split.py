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
"""
import math

import numpy as np
import pytest
import torch

import chip_smoke
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


def _bwd_ratios(bh, tq, tk, d, causal, seed):
    """{scheme: (dQ, dK, dV err/limit)} against the float64 plain
    backward rounded to float32, on the inputs the kernels get: float32
    q, k, v, dO, the forward's lse rounded to float32 and
    delta = rowsum(dO O) in float32."""
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
            for how, mms in BWD_SCHEMES.items()}


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
