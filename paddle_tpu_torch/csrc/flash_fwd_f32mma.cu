// Flash-attention forward for float32 on Hopper's tensor cores (sm_90a,
// mma.sync m16n8k16 bf16 with float32 accumulators), plain C interface.
// bf16 and fp16 inputs run flash_fwd_mma.cu.
//
// Where it runs: the float32 route at head dims 64, 128 and 256 runs
// kernels of its own on the warpgroup instructions
// (flash_fwd_f32_d64_wgmma.cu, flash_fwd_f32_d128_wgmma.cu,
// flash_fwd_f32_d256_wgmma.cu), so no model path launches this kernel;
// it takes the head dims past 256 (384, ...) in 128-column slices, and
// chip_smoke.py times it at D = 128 beside the kernel that replaced it
// there. The shapes and bounds below are those it was written for.
//
// Replaces paddle_tpu/ops/pallas_attention.py:59 _fa_kernel (launched by
// _flash_fwd_pallas, :111) on the float32 route. Computes exactly what
// flash_fwd_mma.cu computes, per (batch*head) slice of q [tq, D] and
// k, v [tk, D], D 64 or any multiple of 128:
//   S   = (Q K^T) * scale, causal-masked bottom-right (row + tk - tq >= col)
//   O   = softmax(S) V    by online softmax (running max m, sum l)
//   lse = m + log(l)      (l == 0 -> 1), compact [BH, tq] float32
// with _ref_attention_lse's semantics: masked scores are -1e30 (a fully
// masked row, causal with tq > tk, averages V), keys >= tk are -inf and
// take no part, rows >= tq are never written. O is float32.
//
// Precision: the float32 tier (rtol 2e-4 / atol 2e-5) is beyond one
// rounding of the operands to bf16 (2^-9) or TF32 (2^-11). So every
// operand of both products (Q and K in S = Q K^T, P and V in P V) is
// split into bf16 halves x = hi + lo (hi = bf16(x), lo = bf16(x - hi),
// ~2^-17 of x) and each product is taken as three mma.sync,
// hi hi + hi lo + lo hi (mma_split3); the dropped lo lo is ~2^-18 of the
// product. The CPU emulation (tests/test_torch_f32_split.py) puts O and
// lse at <= 0.27 of the tier's limit on every float32 case, where one
// bf16 rounding reads 16-162x and one TF32 rounding 2-17x. The split
// runs at the bf16 tensor rate: three products at 989 TFLOP/s are a
// third of it, twice 3xTF32's on the 495 TFLOP/s TF32 rate.
//
// What bounds it on the H100: at the f32 serving shape (B*H = 4*32,
// T = 256, D = 128, causal) it moves 67.2 MB (q, k, v in; o, lse out),
// 0.020 ms at 3.35 TB/s, for 2.16 GFLOP of useful products (6.47
// executed): 0.0065 ms at a third of the bf16 rate. Memory bounds it.
//
// Design (flash_fwd_mma.cu's structure):
// - one block of WARPS warps per (bh, BLOCK_M-row q tile); each warp owns
//   16 rows, so the online softmax needs no cross-warp traffic. Blocks
//   are handed out heaviest first.
// - the q tile is read once from global memory, split, and kept in
//   shared memory as hi and lo bf16 tiles. Each BLOCK_N-key k and v tile
//   comes as float32 by 16-byte cp.async into a staging tile while the
//   block computes on the previous one; then the block splits it once
//   into hi and lo bf16 tiles, which every warp reads by ldmatrix (V by
//   ldmatrix.trans). Splitting at the copy costs each element one split
//   a block; splitting fragments as they are loaded would cost it one a
//   warp. Rows of the bf16 tiles are padded to D + 8 (ldmatrix's eight
//   row addresses in distinct bank groups). 200 KB at D = 128: one block
//   a SM.
// - the online softmax runs in float32 registers in base 2; P goes
//   straight from the S accumulators into the A operand of P V, split
//   into hi and lo halves there (split_pack), never through shared
//   memory. l sums the float32 P.
// - k tiles wholly right of the causal diagonal are not visited by the
//   block, nor computed by a warp whose rows all lie left of them; the
//   elementwise mask runs only on tiles the diagonal or the ragged end
//   crosses. A block that holds a fully masked row visits every tile.
// - O goes from the accumulators to global memory as float2 pairs.
//
// - a head dim past 128 runs the D = 128 kernel in 128-column slices
//   (mma_sm90.cuh HEAD_SLICE): block z of gridDim.z writes columns
//   [128 z, 128 z + 128) of O (and block 0 lse). Each k tile's S sums
//   the slices' Q K^T, each slice's q and k split afresh straight from
//   global memory; v comes as slice z only.
//
// What it leaves: the staging and split of a tile are not overlapped
// with the tensor-core work of the same block (one block a SM); wgmma
// with TMA and a producer warp; reading GQA KV heads in place.

#include "mma_sm90.cuh"

#include <math.h>

namespace {

using namespace mma_sm90;
using bf16 = __nv_bfloat16;

constexpr int BLOCK_M = 128;  // q rows per block
constexpr int BLOCK_N = 64;   // keys per k/v tile
constexpr int WARPS = BLOCK_M / 16;  // one m16 row block per warp
constexpr int THREADS = WARPS * 32;
constexpr float MASKED = -1e30f;  // the reference's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

static_assert(BLOCK_M % 16 == 0 && BLOCK_N % 16 == 0, "whole mma tiles");

template <int D>
struct Layout {
  static constexpr int LD = D + 8;              // padded bf16 row stride
  static constexpr int STAGE = BLOCK_N * D;     // a float32 k or v tile
  static constexpr int Q = BLOCK_M * LD;        // a q half (hi or lo)
  static constexpr int KV = BLOCK_N * LD;       // a k or v half
  static constexpr size_t bytes = 4 * 2 * STAGE + 2 * (2 * Q + 4 * KV);
};

// WIDE: D = HEAD_SLICE and the head is gridDim.z slices of it
template <int D, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_f32mma_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int tq, int tk, float scale,
                        int causal) {
  using L = Layout<D>;
  constexpr int LD = L::LD;
  constexpr int KSTEPS = D / 16;      // k-steps of Q K^T over the head dim
  constexpr int DBLK = D / 8;         // 8-column blocks of O
  constexpr int NBLK = BLOCK_N / 8;   // 8-key blocks of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* kst = reinterpret_cast<float*>(smem_raw);  // [BLOCK_N][D] staging
  float* vst = kst + L::STAGE;                      // [BLOCK_N][D] staging
  bf16* qh = reinterpret_cast<bf16*>(vst + L::STAGE);  // [BLOCK_M][LD]
  bf16* ql = qh + L::Q;
  bf16* kh = ql + L::Q;                             // [BLOCK_N][LD]
  bf16* kl = kh + L::KV;
  bf16* vh = kl + L::KV;
  bf16* vl = vh + L::KV;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BLOCK_M;  // heaviest first
  const long long bh = blockIdx.y;
  const int ns = WIDE ? gridDim.z : 1, z = WIDE ? blockIdx.z : 0;
  const int ld = D * ns;               // global row stride
  const int s0 = WIDE ? slice_at(0, z, ns) : 0;
  const float* qb = q + bh * tq * ld;
  const float* kb = k + bh * tk * ld;
  const float* vb = v + bh * tk * ld + z * D;

  // causal: key j is visible to row i iff j <= i + offset. A k tile
  // wholly right of the last row's limit contributes exactly zero and is
  // not visited; a block holding a fully masked row (q0 + offset < 0)
  // visits every tile, as the reference averages V over all keys there.
  const int offset = tk - tq;
  int n_tiles = (tk + BLOCK_N - 1) / BLOCK_N;
  if (causal && q0 + offset >= 0)
    n_tiles = min(n_tiles, (q0 + BLOCK_M - 1 + offset) / BLOCK_N + 1);

  // the first k / v tile in flight while the q tile is split
  load_tile_async<THREADS, BLOCK_N, D, D>(kst, kb + s0 * D, 0, tk, ld);
  load_tile_async<THREADS, BLOCK_N, D, D>(vst, vb, 0, tk, ld);
  cp_async_commit();
  split_tile<THREADS, BLOCK_M, D, LD>(qh, ql, qb + s0 * D, q0, tq, ld);
  cp_async_wait<0>();
  __syncthreads();
  split_tile<THREADS, BLOCK_N, D, LD>(kh, kl, kst, 0, BLOCK_N);
  split_tile<THREADS, BLOCK_N, D, LD>(vh, vl, vst, 0, BLOCK_N);
  __syncthreads();

  const int w0 = q0 + warp * 16;       // the warp's first row
  const int row_a = w0 + g;            // this lane's rows: row_a, row_a + 8
  // scores in base 2: x = S log2(e), masked at MASKED log2(e), so that
  // lse = m ln(2) + ln(l) is the reference's m + log(l)
  const float scale2 = scale * LOG2E;
  const float masked2 = MASKED * LOG2E;
  float acc[DBLK][4];
#pragma unroll
  for (int j = 0; j < DBLK; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};             // this lane's share of the row sums

  for (int t = 0; t < n_tiles; ++t) {
    const bool next = t + 1 < n_tiles;
    if (next) {  // the staging tiles were split before the last barrier
      load_tile_async<THREADS, BLOCK_N, D, D>(kst, kb + s0 * D,
                                              (t + 1) * BLOCK_N, tk, ld);
      load_tile_async<THREADS, BLOCK_N, D, D>(vst, vb, (t + 1) * BLOCK_N, tk,
                                              ld);
      cp_async_commit();
    }
    const int k0 = t * BLOCK_N;
    // every key of the tile right of each of the warp's rows, and none
    // of them fully masked: the tile adds nothing to these rows
    const bool skip = causal && w0 + offset >= 0 && k0 > w0 + 15 + offset;
    float s[NBLK][4];
#pragma unroll
    for (int j = 0; j < NBLK; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int i = 0; i < ns; ++i) {
      // a wide head: this step's slice of q (held slice z since the last
      // tile) and, past the first step, of k, split from global memory
      if (WIDE && (i > 0 || t > 0)) {
        const int sl = slice_at(i, z, ns);
        __syncthreads();
        split_tile<THREADS, BLOCK_M, D, LD>(qh, ql, qb + sl * D, q0, tq, ld);
        if (i > 0)
          split_tile<THREADS, BLOCK_N, D, LD>(kh, kl, kb + sl * D, k0, tk,
                                              ld);
        __syncthreads();
      }
      if (!skip) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          uint32_t ah[4], al[4];
          ldsm_x4(ah, a_frag<LD>(qh, warp * 16, kk * 16, lane));
          ldsm_x4(al, a_frag<LD>(ql, warp * 16, kk * 16, lane));
#pragma unroll
          for (int np = 0; np < NBLK / 2; ++np) {
            uint32_t bh_[4], bl_[4];
            ldsm_x4(bh_, b_frag<LD>(kh, np * 16, kk * 16, lane));
            ldsm_x4(bl_, b_frag<LD>(kl, np * 16, kk * 16, lane));
            mma_split3(s[2 * np], ah, al, bh_[0], bh_[1], bl_[0], bl_[1]);
            mma_split3(s[2 * np + 1], ah, al, bh_[2], bh_[3], bl_[2],
                       bl_[3]);
          }
        }
      }
    }
    if (!skip) {
      // the mask, only where the ragged end or the diagonal crosses
      const bool edge = k0 + BLOCK_N > tk ||
                        (causal && k0 + BLOCK_N - 1 > w0 + offset);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NBLK; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale2;
          if (edge) {
            const int col = k0 + 8 * j + 2 * tg + (e & 1);
            const int row = row_a + (e >> 1) * 8;
            if (col >= tk)
              x = -INFINITY;                // not a key at all
            else if (causal && row + offset < col)
              x = masked2;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);  // finite: the tile holds a key
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < DBLK; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }
      // O += P V, 16 keys a step: P = 2^(x - m) of blocks 2 kk, 2 kk + 1
      // as the A operand, split into hi and lo halves
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * kk + h;
          const float p0 = exp2f(s[j][0] - m[0]), p1 = exp2f(s[j][1] - m[0]);
          const float p2 = exp2f(s[j][2] - m[1]), p3 = exp2f(s[j][3] - m[1]);
          l[0] += p0 + p1;
          l[1] += p2 + p3;
          split_pack<bf16>(p0, p1, ph[2 * h], pl[2 * h]);
          split_pack<bf16>(p2, p3, ph[2 * h + 1], pl[2 * h + 1]);
        }
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bh_[4], bl_[4];
          ldsm_x4_trans(bh_, bt_frag<LD>(vh, kk * 16, dp * 16, lane));
          ldsm_x4_trans(bl_, bt_frag<LD>(vl, kk * 16, dp * 16, lane));
          mma_split3(acc[2 * dp], ph, pl, bh_[0], bh_[1], bl_[0], bl_[1]);
          mma_split3(acc[2 * dp + 1], ph, pl, bh_[2], bh_[3], bl_[2],
                     bl_[3]);
        }
      }
    }
    if (next) {
      cp_async_wait<0>();
      __syncthreads();  // tile t + 1 staged; every warp done with tile t
      split_tile<THREADS, BLOCK_N, D, LD>(kh, kl, kst, 0, BLOCK_N);
      split_tile<THREADS, BLOCK_N, D, LD>(vh, vl, vst, 0, BLOCK_N);
      __syncthreads();
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float safe_l = l[r] == 0.f ? 1.f : l[r];
    inv[r] = 1.f / safe_l;
    const int row = row_a + 8 * r;
    if (tg == 0 && row < tq && z == 0)
      lse[bh * tq + row] = m[r] * LN2 + logf(safe_l);
  }
  float* ob = o + bh * tq * ld + z * D;
#pragma unroll
  for (int j = 0; j < DBLK; ++j) {
    const int col = 8 * j + 2 * tg;
    if (row_a < tq)
      *reinterpret_cast<float2*>(ob + (long long)row_a * ld + col) =
          make_float2(acc[j][0] * inv[0], acc[j][1] * inv[0]);
    if (row_a + 8 < tq)
      *reinterpret_cast<float2*>(ob + (long long)(row_a + 8) * ld + col) =
          make_float2(acc[j][2] * inv[1], acc[j][3] * inv[1]);
  }
}

template <int D, bool WIDE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int tq, int tk, int d, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32mma_kernel<D, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return for_bh_chunks(bh, [&](int b0, int n) {
    const long long qo = (long long)b0 * tq * d, ko = (long long)b0 * tk * d;
    const dim3 grid((tq + BLOCK_M - 1) / BLOCK_M, n, d / D);
    flash_fwd_f32mma_kernel<D, WIDE><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q) + qo, static_cast<const float*>(k) + ko,
        static_cast<const float*>(v) + ko, static_cast<float*>(o) + qo,
        lse + (long long)b0 * tq, tq, tk, scale, causal);
  });
}

}  // namespace

// dtype: 0 float32 (bf16 and fp16 are flash_fwd_mma.cu's). q: [bh, tq,
// d]; k, v: [bh, tk, d]; o like q; lse: [bh, tq] float32. All
// contiguous, 16-byte aligned, on the current device; d 64 or a multiple
// of 128.
// Returns the CUDA error code of the launch (0 = ok).
extern "C" int flash_fwd_f32mma(const void* q, const void* k, const void* v,
                                void* o, float* lse, int bh, int tq, int tk,
                                int d, int dtype, float scale, int causal,
                                void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || dtype != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64, false>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, s);
  if (d == HEAD_SLICE)
    return launch<HEAD_SLICE, false>(q, k, v, o, lse, bh, tq, tk, d, scale,
                                     causal, s);
  if (d > 0 && d % HEAD_SLICE == 0)
    return launch<HEAD_SLICE, true>(q, k, v, o, lse, bh, tq, tk, d, scale,
                                    causal, s);
  return (int)cudaErrorInvalidValue;
}
