// Flash-attention backward dK/dV for float32 on Hopper's tensor cores
// (sm_90a, mma.sync with float32 accumulators), plain C interface. It
// serves the float32 head dims past 256 (in 128-column slices) alone:
// head dims 64, 128 and 256 run warpgroup kernels of their own
// (flash_bwd_dkv_f32_d64_wgmma.cu, flash_bwd_dkv_f32_d128_wgmma.cu,
// flash_bwd_dkv_f32_d256_wgmma.cu), which chip_smoke.py times beside
// this one. bf16 and fp16 inputs run flash_bwd_dkv_mma.cu; dQ (K2) is
// flash_bwd_dq_f32mma.cu's.
//
// Replaces paddle_tpu/ops/pallas_attention.py:189 _fa_bwd_dkv_kernel
// (with _recompute_ds, :161; the second pallas_call of
// _flash_bwd_pallas, :290) on the float32 route. Per (batch*head) slice
// of q, do [tq, D] and k, v [tk, D], D 64 or any multiple of 128, it
// computes what
// flash_bwd_dkv_mma.cu computes:
//   P  = exp(S - lse), S = (Q K^T) * scale   (lse from the forward, K1)
//   dS = P o (dO V^T - delta) * scale         (delta per q row, from the
//                                              caller: rowsum(dO o O) - dlse)
//   dV = sum_q P^T dO,   dK = sum_q dS^T Q
// with jax.vjp of _ref_attention_lse's semantics: causal masking is
// bottom-right (key j visible to row i iff j <= i + tk - tq), masked
// entries have P = dS = 0, keys >= tk and rows >= tq take no part, and
// a fully masked row (causal, tq > tk) has P = 1/tk on every key and
// dS = 0 -- recognised by its index, since its float32 lse (-1e30)
// cannot give P back. dK and dV are float32.
//
// Precision: the float32 tier (rtol 2e-4 / atol 2e-5) is beyond one
// rounding of the operands to bf16 or TF32. S^T = K Q^T and
// dK += dS^T Q take their operands as bf16 hi + lo halves and three
// mma.sync m16n8k16 (mma_split3). dP^T = V dO^T (which cancels in
// dP - delta) and dV += P^T dO take TF32 hi + lo halves and three
// mma.sync m16n8k8 (mma_split3_tf32): their 3xbf16 splits leave dK at
// 0.44 and dV at 1.39 of the limit at the f32 serving shape, this
// scheme <= 0.27 and <= 0.25 on every float32 case (CPU emulation,
// tests/test_torch_f32_split.py).
//
// What bounds it on the H100: at the train-parity shape (B*H = 8,
// T = 256, D = 128, causal) it moves 6.3 MB, 0.0019 ms at 3.35 TB/s,
// for 0.27 GFLOP of useful products (K Q^T and dS^T Q at a third of the
// bf16 rate, V dO^T and P^T dO at a third of the TF32 rate, 0.0012 ms):
// bytes bound it, and 64 blocks of 4 warps on 132 SMs leave it
// latency-bound there. At B*H = 64, T = 2048 the operations bound it
// (0.63 ms).
//
// Design (flash_bwd_dkv_mma.cu's structure):
// - one block of WARPS warps per (bh, BLOCK_N-key tile). K is split
//   once into resident bf16 hi and lo tiles; V stays resident as
//   float32 (rows padded to D + 8). Warp w owns keys 16 (w % KGROUPS)
//   .. +15 and WROWS q rows of each q tile, and holds the transposed
//   products S^T and dP^T, so the rows of its accumulators are its keys.
// - each BLOCK_M-row q tile comes as float32 by cp.async: Q into a
//   staging tile split once a block into bf16 hi and lo tiles, dO (with
//   lse and delta) into a padded tile from which the warps read the
//   B fragments of dP^T and dV, split into TF32 halves as they are
//   loaded. The next q tile is copied while this one's products run,
//   the next dO tile while this one's dK is. 134 KB at D = 128: one
//   block a SM.
// - P^T (float32, masked) from the S^T accumulators is the A operand of
//   dV += P^T dO in TF32 halves straight from the registers; dS^T the A
//   operand of dK += dS^T Q in bf16 halves. A q tile's work runs in two
//   halves, S^T -> P^T -> dV, then dP^T -> dS^T -> dK, so that one
//   product's operands are live beside the 2 x D/2 accumulators.
// - the q loop starts at the first tile that sees the block's keys,
//   except when fully masked rows exist (they see every key); a warp
//   whose rows are all left of its keys skips the tile's math; the mask
//   runs only on tiles the diagonal or a ragged end crosses.
// - the warps that share keys add their sums through shared memory at
//   the end; dK and dV go to global memory as float2 pairs.
// - the tile: of those tile_sweep.py times on the H100, 32 keys x 64
//   rows with 4 warps was the fastest at the train-parity shape, 18-21%
//   less time than 64 x 64 with 8 warps, which takes 28-31% less at
//   B*H = 64, T = 2048 (PERF.md); 255 registers at D = 128, a 24-byte
//   spill.
// - B*H above MAX_GRID_Y (gridDim.y's limit) is launched in chunks.
//
// - a head dim past 128 runs the D = 128 kernel in 128-column slices
//   (mma_sm90.cuh HEAD_SLICE): block z of gridDim.z writes columns
//   [128 z, 128 z + 128) of dK and dV. S^T and dP^T sum the slices'
//   products before P^T is formed, each slice's k and q split and its v
//   and dO copied afresh (waited for), the last slice being z, whose q
//   halves and dO tile dK and dV read.
//
// What it leaves: wgmma with TMA; fusing dQ into this pass with atomics
// (nondeterministic dQ); reading GQA KV heads in place.

#include "mma_sm90.cuh"

#include <math.h>

namespace {

using namespace mma_sm90;
using bf16 = __nv_bfloat16;

constexpr int BLOCK_N = 32;   // keys per block
constexpr int BLOCK_M = 64;   // q rows per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int KGROUPS = BLOCK_N / 16;       // warps along the keys
constexpr int RGROUPS = WARPS / KGROUPS;    // warps along the q rows
constexpr int WROWS = BLOCK_M / RGROUPS;    // q rows a warp
constexpr float LOG2E = 1.4426950408889634f;

static_assert(KGROUPS * RGROUPS == WARPS && WROWS % 16 == 0,
              "warp w: keys 16 (w % KGROUPS), q rows WROWS (w / KGROUPS)");

template <int D>
struct Layout {
  static constexpr int LD = D + 8;      // bf16 row stride (ldmatrix)
  static constexpr int LDV = D + 8;     // v, float32 (8-byte loads)
  static constexpr int LDO = D + 4;     // dO, float32 (4-byte column loads)
  static constexpr int ST_ROWS = BLOCK_M > BLOCK_N ? BLOCK_M : BLOCK_N;
  static constexpr int KH = BLOCK_N * LD;    // a k half
  static constexpr int QH = BLOCK_M * LD;    // a q half
  static constexpr int V = BLOCK_N * LDV;
  static constexpr int ST = ST_ROWS * D;     // q (first k) staging
  static constexpr int DO = BLOCK_M * LDO;
  // k halves, q halves; then v, staging, dO, lse, delta (float32)
  static constexpr size_t bytes =
      2 * (2 * KH + 2 * QH) + 4 * (V + ST + DO + 2 * BLOCK_M);
  // the end-of-loop reduction, float4 per lane, overlays the q halves,
  // v, the staging and dO
  static_assert((size_t)KGROUPS * 2 * (D / 8) * 32 * 16 <=
                    2 * 2 * QH + 4 * (V + ST + DO),
                "reduction fits");
};

// dP^T += V dO^T, 3xTF32, 8 head-dim columns a step (k index t is
// column 2t, t + 4 is 2t + 1, in V and dO alike): v_a is this lane's v
// rows, dos the float32 dO tile
template <int RBLK, int LDV, int LDO, int D>
__device__ __forceinline__ void dp_tf32(float (&dp)[RBLK][4],
                                        const float* v_a, const float* dos,
                                        int r0, int g, int tg) {
#pragma unroll 2
  for (int kk = 0; kk < D / 8; ++kk) {
    const float2 x0 = *reinterpret_cast<const float2*>(v_a + kk * 8);
    const float2 x1 =
        *reinterpret_cast<const float2*>(v_a + 8 * LDV + kk * 8);
    uint32_t ah[4], al[4];
    split_tf32_frag(x0.x, x1.x, x0.y, x1.y, ah, al);
#pragma unroll
    for (int n = 0; n < RBLK; ++n) {
      const float2 y = *reinterpret_cast<const float2*>(
          dos + (r0 + 8 * n + g) * LDO + kk * 8 + 2 * tg);
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(y.x, bh0, bl0);
      split_tf32(y.y, bh1, bl1);
      mma_split3_tf32(dp[n], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// WIDE: D = HEAD_SLICE and the head is gridDim.z slices of it
template <int D, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_f32mma_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int tq, int tk, float scale, int causal) {
  using L = Layout<D>;
  constexpr int LD = L::LD, LDV = L::LDV, LDO = L::LDO;
  constexpr int DBLK = D / 8;     // 8-column blocks of dK, dV
  constexpr int RBLK = WROWS / 8; // 8-row blocks of the warp's q rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kh = reinterpret_cast<bf16*>(smem_raw);  // [BLOCK_N][LD]
  bf16* kl = kh + L::KH;
  bf16* qh = kl + L::KH;                         // [BLOCK_M][LD]
  bf16* ql = qh + L::QH;
  float* vs = reinterpret_cast<float*>(ql + L::QH);  // [BLOCK_N][LDV]
  float* st = vs + L::V;                         // [ST_ROWS][D]
  float* dos = st + L::ST;                       // [BLOCK_M][LDO]
  float* lses = dos + L::DO;                     // [BLOCK_M]
  float* dls = lses + BLOCK_M;                   // [BLOCK_M]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int kg = warp % KGROUPS;
  const int rg = warp / KGROUPS;
  const int r0 = rg * WROWS;          // the warp's first row of a q tile
  const int k0 = blockIdx.x * BLOCK_N;
  const long long bh = blockIdx.y;
  const int ns = WIDE ? gridDim.z : 1, z = WIDE ? blockIdx.z : 0;
  const int ld = D * ns;               // global row stride
  const int s0 = WIDE ? slice_at(0, z, ns) : 0;
  const float* qb = q + bh * tq * ld;
  const float* dob = dout + bh * tq * ld;
  const float* kb = k + bh * tk * ld;
  const float* vb = v + bh * tk * ld;
  const float* lseb = lse + bh * tq;
  const float* dlb = delta + bh * tq;

  // causal: row i sees key j iff i >= j - offset, so the first q tile
  // that sees any key of this block starts at row k0 - offset. Rows
  // with no visible key at all (i < -offset, only when tq > tk) see
  // every key with P = 1/tk: then every tile is visited.
  const int offset = tk - tq;
  const int n_tiles = (tq + BLOCK_M - 1) / BLOCK_M;
  int t0 = 0;
  if (causal && offset >= 0) t0 = max(0, k0 - offset) / BLOCK_M;

  auto load_dout = [&](int t) {
    const int q0 = t * BLOCK_M;
    load_tile_async<THREADS, BLOCK_M, D, LDO>(dos, dob + s0 * D, q0, tq, ld);
    if (tid < 2 * BLOCK_M) {
      const int i = tid % BLOCK_M, row = q0 + i;
      const bool in = row < tq;
      const float* src = (tid < BLOCK_M ? lseb : dlb) + (in ? row : 0);
      cp_async_4((tid < BLOCK_M ? lses : dls) + i, src, in);
    }
  };
  // k through the staging tile into its halves; v, the first q and dO
  // tiles after it
  load_tile_async<THREADS, BLOCK_N, D, D>(st, kb + s0 * D, k0, tk, ld);
  load_tile_async<THREADS, BLOCK_N, D, LDV>(vs, vb + s0 * D, k0, tk, ld);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_tile<THREADS, BLOCK_N, D, LD>(kh, kl, st, 0, BLOCK_N);
  __syncthreads();
  load_tile_async<THREADS, BLOCK_M, D, D>(st, qb + s0 * D, t0 * BLOCK_M, tq,
                                          ld);
  load_dout(t0);
  cp_async_commit();

  const int kw = k0 + 16 * kg;           // the warp's first key
  const int key_a = kw + g;              // this lane's keys: key_a, key_a + 8
  const float p_masked_row = 1.f / (float)tk;
  const float scale2 = scale * LOG2E;
  // this lane's v rows, read as TF32 A fragments of dP^T
  const float* v_a = vs + (16 * kg + g) * LDV + 2 * tg;
  float dk_acc[DBLK][4], dv_acc[DBLK][4];
#pragma unroll
  for (int j = 0; j < DBLK; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }

  for (int t = t0; t < n_tiles; ++t) {
    const bool next = t + 1 < n_tiles;
    cp_async_wait<0>();
    __syncthreads();  // tile t staged; every warp done with tile t - 1
    split_tile<THREADS, BLOCK_M, D, LD>(qh, ql, st, 0, BLOCK_M);
    __syncthreads();
    if (next) {  // the staging tile is free again
      load_tile_async<THREADS, BLOCK_M, D, D>(st, qb + s0 * D,
                                              (t + 1) * BLOCK_M, tq, ld);
      cp_async_commit();
    }
    const int q0 = t * BLOCK_M;
    const int w0 = q0 + r0;  // the warp's first row
    // no row or key of the warp exists, or all its rows are left of all
    // its keys and none is fully masked
    const bool skip = w0 >= tq || kw >= tk ||
                      (causal && w0 + offset >= 0 &&
                       w0 + WROWS - 1 + offset < kw);
    const bool edge = q0 + BLOCK_M > tq || k0 + BLOCK_N > tk ||
                      (causal && w0 + offset < kw + 15);
    float p[RBLK][4];
    uint32_t dsh[WROWS / 16][4], dsl[WROWS / 16][4];
    // S^T = K Q^T, 3xbf16: 16 keys x WROWS rows; a wide head also sums
    // dP^T = V dO^T here, slice by slice (the last slice z, which dV and
    // dK read)
    float s[RBLK][4], dp[RBLK][4];
#pragma unroll
    for (int j = 0; j < RBLK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    for (int i = 0; i < ns; ++i) {
      if (WIDE && (i > 0 || t > t0)) {
        // this step's slice of k and v (held slice z since the last
        // tile) and, past the first step, of q and dO, k and q split
        // straight from global memory
        const int sl = slice_at(i, z, ns);
        __syncthreads();
        load_tile_async<THREADS, BLOCK_N, D, LDV>(vs, vb + sl * D, k0, tk, ld);
        if (i > 0)
          load_tile_async<THREADS, BLOCK_M, D, LDO>(dos, dob + sl * D, q0, tq,
                                                    ld);
        cp_async_commit();
        split_tile<THREADS, BLOCK_N, D, LD>(kh, kl, kb + sl * D, k0, tk, ld);
        if (i > 0)
          split_tile<THREADS, BLOCK_M, D, LD>(qh, ql, qb + sl * D, q0, tq,
                                              ld);
        cp_async_wait<0>();
        __syncthreads();
      }
      if (!skip) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t ah[4], al[4];
          ldsm_x4(ah, a_frag<LD>(kh, 16 * kg, kk * 16, lane));
          ldsm_x4(al, a_frag<LD>(kl, 16 * kg, kk * 16, lane));
#pragma unroll
          for (int np = 0; np < RBLK / 2; ++np) {
            uint32_t bh_[4], bl_[4];
            ldsm_x4(bh_, b_frag<LD>(qh, r0 + np * 16, kk * 16, lane));
            ldsm_x4(bl_, b_frag<LD>(ql, r0 + np * 16, kk * 16, lane));
            mma_split3(s[2 * np], ah, al, bh_[0], bh_[1], bl_[0], bl_[1]);
            mma_split3(s[2 * np + 1], ah, al, bh_[2], bh_[3], bl_[2],
                       bl_[3]);
          }
        }
        if (WIDE) dp_tf32<RBLK, LDV, LDO, D>(dp, v_a, dos, r0, g, tg);
      }
    }
    if (!skip) {
      // P^T in float32 with the masks: element e of block j is key
      // key_a + 8 (e >> 1), row r0 + 8 j + 2 tg + (e & 1) of the tile
#pragma unroll
      for (int j = 0; j < RBLK; ++j) {
        const int i = r0 + 8 * j + 2 * tg;
        const float2 lse2 = *reinterpret_cast<const float2*>(lses + i);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = exp2f(s[j][e] * scale2 -
                           ((e & 1) ? lse2.y : lse2.x) * LOG2E);
          if (edge) {
            const int row = q0 + i + (e & 1);
            const int key = key_a + (e >> 1) * 8;
            if (key >= tk || row >= tq)
              pe = 0.f;
            else if (causal && row + offset < 0)
              pe = p_masked_row;            // fully masked row
            else if (causal && row + offset < key)
              pe = 0.f;
          }
          p[j][e] = pe;
        }
      }
      // dV += P^T dO, 3xTF32, 8 q rows a step: the accumulators of block
      // j are the A fragment with k index t as row 2t and t + 4 as 2t + 1
      // (mma_sm90.cuh); dO's B fragments are those rows' columns
#pragma unroll
      for (int j = 0; j < RBLK; ++j) {
        uint32_t ah[4], al[4];
        split_tf32_frag(p[j][0], p[j][2], p[j][1], p[j][3], ah, al);
        const float* d0 = dos + (r0 + 8 * j + 2 * tg) * LDO + g;
#pragma unroll
        for (int n = 0; n < DBLK; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(d0[8 * n], bh0, bl0);
          split_tf32(d0[LDO + 8 * n], bh1, bl1);
          mma_split3_tf32(dv_acc[n], ah, al, bh0, bh1, bl0, bl1);
        }
      }
      if (!WIDE) dp_tf32<RBLK, LDV, LDO, D>(dp, v_a, dos, r0, g, tg);
      // dS^T = P^T o (dP^T - delta) scale: 0 wherever P^T is 0 and on
      // fully masked rows; as the A operand (bf16 hi, lo) of dK += dS^T Q,
      // k-step kk covering the rows of blocks 2 kk, 2 kk + 1
#pragma unroll
      for (int j = 0; j < RBLK; ++j) {
        const int i = r0 + 8 * j + 2 * tg;
        const float2 dl2 = *reinterpret_cast<const float2*>(dls + i);
        const bool lost = edge && causal && q0 + i + offset < 0;
        const bool lost1 = edge && causal && q0 + i + 1 + offset < 0;
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool l = (e & 1) ? lost1 : lost;
          ds[e] = l ? 0.f
                    : p[j][e] * (dp[j][e] - ((e & 1) ? dl2.y : dl2.x)) *
                          scale;
        }
        const int kk = j >> 1, a = (j & 1) * 2;
        split_pack<bf16>(ds[0], ds[1], dsh[kk][a], dsl[kk][a]);
        split_pack<bf16>(ds[2], ds[3], dsh[kk][a + 1], dsl[kk][a + 1]);
      }
    }
    __syncthreads();  // every warp done with dO, lse and delta
    if (next) {
      load_dout(t + 1);
      cp_async_commit();
    }
    if (!skip) {
      // dK += dS^T Q, 3xbf16, Q by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < WROWS / 16; ++kk) {
#pragma unroll
        for (int dpi = 0; dpi < D / 16; ++dpi) {
          uint32_t bh_[4], bl_[4];
          ldsm_x4_trans(bh_, bt_frag<LD>(qh, r0 + kk * 16, dpi * 16, lane));
          ldsm_x4_trans(bl_, bt_frag<LD>(ql, r0 + kk * 16, dpi * 16, lane));
          mma_split3(dk_acc[2 * dpi], dsh[kk], dsl[kk], bh_[0], bh_[1],
                     bl_[0], bl_[1]);
          mma_split3(dk_acc[2 * dpi + 1], dsh[kk], dsl[kk], bh_[2], bh_[3],
                     bl_[2], bl_[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the warps of row groups 1.. hand their sums to row group 0 (same
  // keys, same lane layout) through the q halves, v, staging and dO
  float4* red = reinterpret_cast<float4*>(qh) + kg * (2 * DBLK) * 32 + lane;
  for (int from = 1; from < RGROUPS; ++from) {
    __syncthreads();
    if (rg == from) {
#pragma unroll
      for (int j = 0; j < DBLK; ++j) {
        red[j * 32] = make_float4(dk_acc[j][0], dk_acc[j][1], dk_acc[j][2],
                                  dk_acc[j][3]);
        red[(DBLK + j) * 32] = make_float4(dv_acc[j][0], dv_acc[j][1],
                                           dv_acc[j][2], dv_acc[j][3]);
      }
    }
    __syncthreads();
    if (rg == 0) {
#pragma unroll
      for (int j = 0; j < DBLK; ++j) {
        const float4 a = red[j * 32], b = red[(DBLK + j) * 32];
        dk_acc[j][0] += a.x; dk_acc[j][1] += a.y;
        dk_acc[j][2] += a.z; dk_acc[j][3] += a.w;
        dv_acc[j][0] += b.x; dv_acc[j][1] += b.y;
        dv_acc[j][2] += b.z; dv_acc[j][3] += b.w;
      }
    }
  }
  if (rg != 0) return;
  float* dkb = dk + bh * tk * ld + z * D;
  float* dvb = dv + bh * tk * ld + z * D;
#pragma unroll
  for (int j = 0; j < DBLK; ++j) {
    const int col = 8 * j + 2 * tg;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key_a + 8 * r;
      if (key < tk) {
        const long long at = (long long)key * ld + col;
        *reinterpret_cast<float2*>(dkb + at) =
            make_float2(dk_acc[j][2 * r], dk_acc[j][2 * r + 1]);
        *reinterpret_cast<float2*>(dvb + at) =
            make_float2(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
      }
    }
  }
}

template <int D, bool WIDE>
int launch(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* delta, float* dk, float* dv, int bh,
           int tq, int tk, int d, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_f32mma_kernel<D, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return for_bh_chunks(bh, [&](int b0, int n) {
    const long long qo = (long long)b0 * tq * d, ko = (long long)b0 * tk * d;
    const dim3 grid((tk + BLOCK_N - 1) / BLOCK_N, n, d / D);
    flash_bwd_dkv_f32mma_kernel<D, WIDE><<<grid, THREADS, smem, stream>>>(
        q + qo, k + ko, v + ko, dout + qo, lse + (long long)b0 * tq,
        delta + (long long)b0 * tq, dk + ko, dv + ko, tq, tk, scale, causal);
  });
}

}  // namespace

// dtype: 0 float32 (bf16 and fp16 are flash_bwd_dkv_mma.cu's); d: 64 or
// a multiple of 128. q, dout: [bh, tq, d]; k, v, dk, dv: [bh, tk, d]; lse, delta:
// [bh, tq] float32. All contiguous, 16-byte aligned, on the current
// device. Returns the CUDA error code of the launch (0 = ok).
extern "C" int flash_bwd_dkv_f32mma(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dk, void* dv, int bh, int tq,
                                    int tk, int d, int dtype, float scale,
                                    int causal, void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || dtype != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *qf = static_cast<const float*>(q),
              *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v),
              *df = static_cast<const float*>(dout);
  float *dkf = static_cast<float*>(dk), *dvf = static_cast<float*>(dv);
  if (d == 64)
    return launch<64, false>(qf, kf, vf, df, lse, delta, dkf, dvf, bh, tq,
                             tk, d, scale, causal, s);
  if (d == HEAD_SLICE)
    return launch<HEAD_SLICE, false>(qf, kf, vf, df, lse, delta, dkf, dvf, bh,
                                     tq, tk, d, scale, causal, s);
  if (d > 0 && d % HEAD_SLICE == 0)
    return launch<HEAD_SLICE, true>(qf, kf, vf, df, lse, delta, dkf, dvf, bh,
                                    tq, tk, d, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
