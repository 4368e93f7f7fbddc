// Flash-attention backward dQ for float32 on Hopper's tensor cores
// (sm_90a, mma.sync with float32 accumulators), plain C interface. bf16
// and fp16 inputs run flash_bwd_dq_mma.cu; dK/dV (K3) is
// flash_bwd_dkv_f32mma.cu's.
//
// Where it runs: the float32 route at head dims 64, 128 and 256 runs
// kernels of its own on the warpgroup instructions
// (flash_bwd_dq_f32_d64_wgmma.cu, flash_bwd_dq_f32_d128_wgmma.cu,
// flash_bwd_dq_f32_d256_wgmma.cu), so no model path launches this
// kernel; it takes the head dims past 256 (384, ...) in 128-column
// slices, and chip_smoke.py times it at D = 128 beside the kernel that
// replaced it there. The shapes and bounds below are those it was
// written for.
//
// Replaces paddle_tpu/ops/pallas_attention.py:223 _fa_bwd_dq_kernel
// (with _recompute_ds, :161; the first pallas_call of _flash_bwd_pallas,
// :273) on the float32 route. Per (batch*head) slice of q, do [tq, D] and
// k, v [tk, D], D 64 or any multiple of 128, it computes what
// flash_bwd_dq_mma.cu
// computes:
//   P  = exp(S - lse), S = (Q K^T) * scale   (lse from the forward, K1)
//   dS = P o (dO V^T - delta) * scale         (delta per q row, from the
//                                              caller: rowsum(dO o O) - dlse)
//   dQ = sum_k dS K
// with jax.vjp of _ref_attention_lse's semantics: causal masking is
// bottom-right (key j visible to row i iff j <= i + tk - tq), masked
// entries and keys >= tk have dS = 0, a fully masked row (causal,
// tq > tk) has dS = 0 on every key and so dQ = 0, rows >= tq are never
// written. dQ is float32.
//
// Precision: the float32 tier (rtol 2e-4 / atol 2e-5) is beyond one
// rounding of the operands to bf16 or TF32. S = Q K^T and dQ += dS K
// take their operands as bf16 hi + lo halves and three mma.sync
// m16n8k16 (mma_split3, as flash_fwd_f32mma.cu). dP = dO V^T feeds
// dP - delta, which cancels: its 3xbf16 split leaves dQ at 0.71 of the
// limit at the f32 serving shape, over the 0.5 margin kept for the
// tensor cores' own accumulation order, so dP takes TF32 hi + lo halves
// and three mma.sync m16n8k8 (mma_split3_tf32): dQ <= 0.29 on every
// float32 case (CPU emulation, tests/test_torch_f32_split.py).
//
// What bounds it on the H100: at the train-parity shape (B*H = 8,
// T = 256, D = 128, causal) it moves 5.3 MB, 0.0016 ms at 3.35 TB/s,
// for 0.20 GFLOP of useful products (Q K^T and dS K at a third of the
// bf16 rate, dO V^T at a third of the TF32 rate, 0.0008 ms): bytes
// bound it, and 32 blocks of 4 warps on 132 SMs leave it latency-bound
// there. At B*H = 64, T = 2048 the operations bound it (0.42 ms).
//
// Design (flash_bwd_dq_mma.cu's loop with flash_fwd_f32mma.cu's split):
// - one block of WARPS warps per (bh, BLOCK_M-row q tile); each warp owns
//   16 rows. Q is split once into bf16 hi and lo tiles; dO is kept as
//   float32 (rows padded to D + 8 floats) and its TF32 halves are taken
//   as each warp loads its fragments. Blocks are handed out heaviest
//   first.
// - each BLOCK_N-key k tile comes as float32 by cp.async into a staging
//   tile and is split once a block into bf16 hi and lo tiles (S = Q K^T
//   reads them by ldmatrix, dQ += dS K by ldmatrix.trans); each v tile
//   comes as float32 by cp.async into a padded tile from which the
//   warps read dO V^T's B fragments, split as they are loaded. The next
//   k tile is copied while this one's S and dP are computed, the next v
//   tile while its dS K is. 168 KB at D = 128: one block a SM. Of the
//   tiles tile_sweep.py times on the H100, this one was the fastest at
//   the train-parity shape; 128 rows x 32 keys with 8 warps takes 5-9%
//   less time at B*H = 64, T = 2048 and 31-42% more at the train-parity
//   shape (PERF.md).
// - P and dS are formed in float32 registers from the accumulators (P in
//   base 2), dS split into bf16 halves there as the A operand of dS K.
// - causal: k tiles wholly right of the block's last row are not visited
//   (a block of fully masked rows visits none and writes zeros), a warp
//   skips a tile wholly right of its own rows, and the elementwise mask
//   runs only on tiles the diagonal or the ragged end crosses.
// - dQ goes from the accumulators to global memory as float2 pairs.
// - B*H above MAX_GRID_Y (gridDim.y's limit) is launched in chunks.
//
// - a head dim past 128 runs the D = 128 kernel in 128-column slices
//   (mma_sm90.cuh HEAD_SLICE): block z of gridDim.z writes columns
//   [128 z, 128 z + 128) of dQ. S and dP sum the slices' products, each
//   slice's q and k split and its dO and v copied afresh (waited for),
//   the last slice being z, whose k halves dQ += dS K reads.
//
// What it leaves: wgmma with TMA; overlapping a tile's split with the
// products of the one before (one block a SM); reading GQA KV heads in
// place.

#include "mma_sm90.cuh"

#include <math.h>

namespace {

using namespace mma_sm90;
using bf16 = __nv_bfloat16;

constexpr int BLOCK_M = 64;   // q rows per block
constexpr int BLOCK_N = 64;   // keys per k/v tile
constexpr int WARPS = BLOCK_M / 16;  // one m16 row block per warp
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

static_assert(BLOCK_M % 16 == 0 && BLOCK_N % 16 == 0, "whole mma tiles");

template <int D>
struct Layout {
  static constexpr int LD = D + 8;      // bf16 row stride (ldmatrix)
  static constexpr int LDF = D + 8;     // float32 row stride (8-byte loads)
  static constexpr int QH = BLOCK_M * LD;   // a q half
  static constexpr int DO = BLOCK_M * LDF;  // dO, float32
  static constexpr int KST = BLOCK_N * D;   // k staging, float32
  static constexpr int KH = BLOCK_N * LD;   // a k half
  static constexpr int VST = BLOCK_N * LDF; // v, float32
  static constexpr size_t bytes = 4 * (DO + KST + VST) + 2 * (2 * QH + 2 * KH);
};

// WIDE: D = HEAD_SLICE and the head is gridDim.z slices of it
template <int D, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_f32mma_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int tq, int tk,
                           float scale, int causal) {
  using L = Layout<D>;
  constexpr int LD = L::LD, LDF = L::LDF;
  constexpr int DBLK = D / 8;         // 8-column blocks of dQ
  constexpr int NBLK = BLOCK_N / 8;   // 8-key blocks of S and dP
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dos = reinterpret_cast<float*>(smem_raw);  // [BLOCK_M][LDF]
  float* kst = dos + L::DO;                         // [BLOCK_N][D]
  float* vst = kst + L::KST;                        // [BLOCK_N][LDF]
  bf16* qh = reinterpret_cast<bf16*>(vst + L::VST); // [BLOCK_M][LD]
  bf16* ql = qh + L::QH;
  bf16* kh = ql + L::QH;                            // [BLOCK_N][LD]
  bf16* kl = kh + L::KH;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BLOCK_M;  // heaviest first
  const long long bh = blockIdx.y;
  const int ns = WIDE ? gridDim.z : 1, z = WIDE ? blockIdx.z : 0;
  const int ld = D * ns;               // global row stride
  const int s0 = WIDE ? slice_at(0, z, ns) : 0;
  const float* qb = q + bh * tq * ld;
  const float* dob = dout + bh * tq * ld;
  const float* kb = k + bh * tk * ld;
  const float* vb = v + bh * tk * ld;

  // causal: key j is visible to row i iff j <= i + offset. Keys past the
  // block's last row's limit have dS = 0 for every row of the block; a
  // block of fully masked rows (last row + offset < 0) visits no tile.
  const int offset = tk - tq;
  int n_tiles = (tk + BLOCK_N - 1) / BLOCK_N;
  if (causal) {
    const int last = min(q0 + BLOCK_M, tq) - 1 + offset;
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BLOCK_N + 1);
  }

  // dO and the first k / v tiles in flight while the q tile is split
  load_tile_async<THREADS, BLOCK_M, D, LDF>(dos, dob + s0 * D, q0, tq, ld);
  if (n_tiles > 0) {
    load_tile_async<THREADS, BLOCK_N, D, D>(kst, kb + s0 * D, 0, tk, ld);
    load_tile_async<THREADS, BLOCK_N, D, LDF>(vst, vb + s0 * D, 0, tk, ld);
  }
  cp_async_commit();
  split_tile<THREADS, BLOCK_M, D, LD>(qh, ql, qb + s0 * D, q0, tq, ld);

  const int w0 = q0 + warp * 16;       // the warp's first row
  const int row_a = w0 + g;            // this lane's rows: row_a, row_a + 8
  const int w_last = min(w0 + 15, tq - 1);
  // P = 2^(S scale log2(e) - lse log2(e)); rows >= tq are never written
  const float scale2 = scale * LOG2E;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    lse2[r] = row < tq ? lse[bh * tq + row] * LOG2E : 0.f;
    dl[r] = row < tq ? delta[bh * tq + row] : 0.f;
  }
  // this lane's dO rows in the float32 tile, read as TF32 A fragments
  const float* do_a = dos + (warp * 16 + g) * LDF + 2 * tg;
  float acc[DBLK][4];
#pragma unroll
  for (int j = 0; j < DBLK; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const bool next = t + 1 < n_tiles;
    cp_async_wait<0>();
    __syncthreads();  // tile t staged; every warp done with tile t - 1
    split_tile<THREADS, BLOCK_N, D, LD>(kh, kl, kst, 0, BLOCK_N);
    __syncthreads();
    if (next) {  // the k staging tile is free again
      load_tile_async<THREADS, BLOCK_N, D, D>(kst, kb + s0 * D,
                                              (t + 1) * BLOCK_N, tk, ld);
      cp_async_commit();
    }
    const int k0 = t * BLOCK_N;
    // no row of the warp exists, or every key of the tile is right of
    // each of its rows (fully masked rows included): dS = 0 here
    const bool skip = w0 >= tq || (causal && k0 > w_last + offset);
    float s[NBLK][4], dp[NBLK][4];
#pragma unroll
    for (int j = 0; j < NBLK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    for (int i = 0; i < ns; ++i) {
      // a wide head: this step's slice of q and dO (held slice z since
      // the last tile) and, past the first step, of k and v, straight
      // from global memory; the last step's is slice z, which
      // dQ += dS K reads
      if (WIDE && (i > 0 || t > 0)) {
        const int sl = slice_at(i, z, ns);
        __syncthreads();
        load_tile_async<THREADS, BLOCK_M, D, LDF>(dos, dob + sl * D, q0, tq,
                                                  ld);
        if (i > 0)
          load_tile_async<THREADS, BLOCK_N, D, LDF>(vst, vb + sl * D, k0, tk,
                                                    ld);
        cp_async_commit();
        split_tile<THREADS, BLOCK_M, D, LD>(qh, ql, qb + sl * D, q0, tq, ld);
        if (i > 0)
          split_tile<THREADS, BLOCK_N, D, LD>(kh, kl, kb + sl * D, k0, tk,
                                              ld);
        cp_async_wait<0>();
        __syncthreads();
      }
      if (!skip) {
        // S = Q K^T, 3xbf16
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t ah[4], al[4];
          ldsm_x4(ah, a_frag<LD>(qh, warp * 16, kk * 16, lane));
          ldsm_x4(al, a_frag<LD>(ql, warp * 16, kk * 16, lane));
#pragma unroll
          for (int np = 0; np < NBLK / 2; ++np) {
            uint32_t bh_[4], bl_[4];
            ldsm_x4(bh_, b_frag<LD>(kh, np * 16, kk * 16, lane));
            ldsm_x4(bl_, b_frag<LD>(kl, np * 16, kk * 16, lane));
            mma_split3(s[2 * np], ah, al, bh_[0], bh_[1], bl_[0], bl_[1]);
            mma_split3(s[2 * np + 1], ah, al, bh_[2], bh_[3], bl_[2], bl_[3]);
          }
        }
        // dP = dO V^T, 3xTF32, 8 head-dim columns a step: k index t is
        // column 2t, t + 4 is 2t + 1 (mma_sm90.cuh), in dO and V alike
#pragma unroll 2
        for (int kk = 0; kk < D / 8; ++kk) {
          const float2 x0 = *reinterpret_cast<const float2*>(do_a + kk * 8);
          const float2 x1 =
              *reinterpret_cast<const float2*>(do_a + 8 * LDF + kk * 8);
          uint32_t ah[4], al[4];
          split_tf32_frag(x0.x, x1.x, x0.y, x1.y, ah, al);
#pragma unroll
          for (int n = 0; n < NBLK; ++n) {
            const float2 y = *reinterpret_cast<const float2*>(
                vst + (8 * n + g) * LDF + kk * 8 + 2 * tg);
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(y.x, bh0, bl0);
            split_tf32(y.y, bh1, bl1);
            mma_split3_tf32(dp[n], ah, al, bh0, bh1, bl0, bl1);
          }
        }
      }
    }
    __syncthreads();  // every warp done with the v tile
    if (next) {
      load_tile_async<THREADS, BLOCK_N, D, LDF>(vst, vb + s0 * D,
                                                (t + 1) * BLOCK_N, tk, ld);
      cp_async_commit();
    }
    if (!skip) {
      // dS = P o (dP - delta) scale in place of S, 0 where masked (keys
      // >= tk, right of the diagonal); the mask only where the ragged
      // end or the diagonal crosses
      const bool edge = k0 + BLOCK_N > tk ||
                        (causal && k0 + BLOCK_N - 1 > w0 + offset);
#pragma unroll
      for (int j = 0; j < NBLK; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float x = exp2f(s[j][e] * scale2 - lse2[r]) * (dp[j][e] - dl[r]) *
                    scale;
          if (edge) {
            const int col = k0 + 8 * j + 2 * tg + (e & 1);
            const int row = row_a + 8 * r;
            if (col >= tk || (causal && row + offset < col)) x = 0.f;
          }
          s[j][e] = x;
        }
      }
      // dQ += dS K, 3xbf16, 16 keys a step: dS of blocks 2 kk, 2 kk + 1
      // as the A operand, split in registers; K by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < NBLK / 2; ++kk) {
        uint32_t dh[4], dlo[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * kk + h;
          split_pack<bf16>(s[j][0], s[j][1], dh[2 * h], dlo[2 * h]);
          split_pack<bf16>(s[j][2], s[j][3], dh[2 * h + 1], dlo[2 * h + 1]);
        }
#pragma unroll
        for (int dpi = 0; dpi < D / 16; ++dpi) {
          uint32_t bh_[4], bl_[4];
          ldsm_x4_trans(bh_, bt_frag<LD>(kh, kk * 16, dpi * 16, lane));
          ldsm_x4_trans(bl_, bt_frag<LD>(kl, kk * 16, dpi * 16, lane));
          mma_split3(acc[2 * dpi], dh, dlo, bh_[0], bh_[1], bl_[0], bl_[1]);
          mma_split3(acc[2 * dpi + 1], dh, dlo, bh_[2], bh_[3], bl_[2],
                     bl_[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // dO's copy, also when no tile was visited

  float* dqb = dq + bh * tq * ld + z * D;
#pragma unroll
  for (int j = 0; j < DBLK; ++j) {
    const int col = 8 * j + 2 * tg;
    if (row_a < tq)
      *reinterpret_cast<float2*>(dqb + (long long)row_a * ld + col) =
          make_float2(acc[j][0], acc[j][1]);
    if (row_a + 8 < tq)
      *reinterpret_cast<float2*>(dqb + (long long)(row_a + 8) * ld + col) =
          make_float2(acc[j][2], acc[j][3]);
  }
}

template <int D, bool WIDE>
int launch(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* delta, float* dq, int bh, int tq,
           int tk, int d, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32mma_kernel<D, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return for_bh_chunks(bh, [&](int b0, int n) {
    const long long qo = (long long)b0 * tq * d, ko = (long long)b0 * tk * d;
    const dim3 grid((tq + BLOCK_M - 1) / BLOCK_M, n, d / D);
    flash_bwd_dq_f32mma_kernel<D, WIDE><<<grid, THREADS, smem, stream>>>(
        q + qo, k + ko, v + ko, dout + qo, lse + (long long)b0 * tq,
        delta + (long long)b0 * tq, dq + qo, tq, tk, scale, causal);
  });
}

}  // namespace

// dtype: 0 float32 (bf16 and fp16 are flash_bwd_dq_mma.cu's); d: 64 or
// a multiple of 128. q, dout, dq: [bh, tq, d]; k, v: [bh, tk, d]; lse, delta: [bh, tq]
// float32. All contiguous, 16-byte aligned, on the current device.
// Returns the CUDA error code of the launch (0 = ok).
extern "C" int flash_bwd_dq_f32mma(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, int bh, int tq, int tk, int d,
                                   int dtype, float scale, int causal,
                                   void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || dtype != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *qf = static_cast<const float*>(q),
              *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v),
              *df = static_cast<const float*>(dout);
  float* out = static_cast<float*>(dq);
  if (d == 64)
    return launch<64, false>(qf, kf, vf, df, lse, delta, out, bh, tq, tk, d,
                             scale, causal, s);
  if (d == HEAD_SLICE)
    return launch<HEAD_SLICE, false>(qf, kf, vf, df, lse, delta, out, bh, tq,
                                     tk, d, scale, causal, s);
  if (d > 0 && d % HEAD_SLICE == 0)
    return launch<HEAD_SLICE, true>(qf, kf, vf, df, lse, delta, out, bh, tq,
                                    tk, d, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
