// Flash-attention forward on Hopper's tensor cores (sm_90a, mma.sync),
// bf16 and fp16, plain C interface. float32 inputs run
// flash_fwd_f32mma.cu.
//
// Replaces paddle_tpu/ops/pallas_attention.py:59 _fa_kernel (launched by
// _flash_fwd_pallas, :111). Computes, per (batch*head) slice of
// q [tq, D] and k, v [tk, D], D 64 or any multiple of 128:
//   S   = (Q K^T) * scale, causal-masked bottom-right (row + tk - tq >= col)
//   O   = softmax(S) V    by online softmax (running max m, sum l)
//   lse = m + log(l)      (l == 0 -> 1), compact [BH, tq] float32
// with _ref_attention_lse's semantics: masked scores are -1e30 (a fully
// masked row, causal with tq > tk, averages V), keys >= tk are -inf and
// take no part, rows >= tq are never written.
//
// What bounds it on the H100: at the training shape (B*H = 2*32,
// T = 2048, D = 128, causal) it does 68.8 GFLOP of useful products
// (4 D FLOP per visible (row, key) pair) against 135 MB moved: the bf16
// tensor-core rate, 0.070 ms. At the serving shape (B*H = 4*32, T = 256)
// it moves 34 MB for 2.2 GFLOP: the 3.35 TB/s of memory, 0.010 ms.
//
// Design (FlashAttention-2's structure with sm_80+ instructions):
// - one block of 8 warps per (bh, 128-row q tile); each warp owns 16
//   rows, so the online softmax needs no cross-warp traffic. Blocks are
//   handed out heaviest first (the last q tiles see the most keys under
//   the causal mask).
// - the q tile and 64-key k / v tiles go to shared memory in bf16 / fp16
//   by 16-byte cp.async (zero-filled past tq / tk), k and v through a
//   two-stage ring so the next tile's copy overlaps this tile's math.
//   Rows are padded to D + 8 elements: the eight row addresses of an
//   ldmatrix then fall in distinct bank groups. 104 KB at D = 128.
// - S = Q K^T runs on mma.sync.m16n8k16 with float32 accumulators, Q's
//   fragments read from the resident q tile by ldmatrix (kept in
//   registers, they cost the 32 registers that let two blocks share an
//   SM: __launch_bounds__(256, 2), 16 warps a SM). The online softmax
//   runs in float32 registers in base 2 (the scale and log2(e) folded
//   into one multiply; row max over a lane quad by shuffles; l summed
//   per lane and reduced once at the end).
// - P goes straight from the S accumulators into the A operand of P V
//   (V through ldmatrix.trans), never through shared memory. P is split
//   into hi + lo 16-bit halves and P V taken twice: one bf16 rounding
//   of P (2^-9) costs O 1.6x the check tier's limit at the training
//   shape, the split keeps P's float32 accuracy at 1.5x the products.
// - k tiles wholly right of the causal diagonal are not visited by the
//   block, nor computed by a warp whose rows all lie left of them; the
//   elementwise mask runs only on tiles the diagonal or the ragged end
//   crosses. A block that holds a fully masked row visits every tile.
// - registers: at D = 128 the 128-register cap of two blocks a SM
//   spills ~56 bytes a thread (loop-invariant values, reloaded from L1
//   once a tile); the uncapped design with Q's fragments in registers
//   held 171 registers without a spill, one block a SM, and ran ~35%
//   slower at the training shape (PERF.md).
//
// - a head dim past 128 runs the D = 128 kernel in 128-column slices
//   (mma_sm90.cuh HEAD_SLICE): block z of gridDim.z writes columns
//   [128 z, 128 z + 128) of O (and block 0 lse). Each k tile's S sums
//   the slices' Q K^T, each slice's q and k tiles copied afresh (the
//   copy waited for, not overlapped); v comes as slice z only. At
//   D = 256 the registers and the 104 KB of shared memory are those of
//   D = 128, where a whole-D tile would hold 128 accumulators a thread
//   for O alone.
//
// What it leaves: wgmma with TMA and a producer warp (warp
// specialisation), the route to the card's full tensor-core rate;
// reading GQA KV heads in place instead of after repeat_interleave.

#include "mma_sm90.cuh"

#include <math.h>

namespace {

using namespace mma_sm90;

constexpr int BLOCK_M = 128;  // q rows per block: 8 warps x 16
constexpr int BLOCK_N = 64;   // keys per k/v tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr float MASKED = -1e30f;  // the reference's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

static_assert(BLOCK_M == WARPS * 16, "one m16 row block per warp");

template <int D>
struct Layout {
  static constexpr int LD = D + 8;              // padded row stride
  static constexpr int Q = BLOCK_M * LD;        // q tile (then O staging)
  static constexpr int KV = BLOCK_N * LD;       // one k or v stage
  static constexpr size_t bytes = 2 * (Q + 4 * KV);
};

// WIDE: D = HEAD_SLICE and the head is gridDim.z slices of it
template <typename T, int D, bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int tq, int tk, float scale,
                     int causal) {
  using M = Mma<T>;
  constexpr int LD = Layout<D>::LD;
  constexpr int KSTEPS = D / 16;  // k-steps of Q K^T over the head dim
  constexpr int DBLK = D / 8;     // 8-column blocks of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);   // [BLOCK_M][LD]
  T* ks = qs + Layout<D>::Q;                // [2][BLOCK_N][LD]
  T* vs = ks + 2 * Layout<D>::KV;           // [2][BLOCK_N][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BLOCK_M;  // heaviest first
  const long long bh = blockIdx.y;
  const int ns = WIDE ? gridDim.z : 1, z = WIDE ? blockIdx.z : 0;
  const int ld = D * ns;               // global row stride
  const int s0 = WIDE ? slice_at(0, z, ns) : 0;
  const T* qb = q + bh * tq * ld;
  const T* kb = k + bh * tk * ld;
  const T* vb = v + bh * tk * ld + z * D;

  // causal: key j is visible to row i iff j <= i + offset. A k tile
  // wholly right of the last row's limit contributes exactly zero (its
  // masked scores underflow against a finite running max) and is not
  // visited; a block holding a fully masked row (q0 + offset < 0)
  // visits every tile, as the reference averages V over all keys there.
  const int offset = tk - tq;
  int n_tiles = (tk + BLOCK_N - 1) / BLOCK_N;
  if (causal && q0 + offset >= 0)
    n_tiles = min(n_tiles, (q0 + BLOCK_M - 1 + offset) / BLOCK_N + 1);

  load_tile_async<THREADS, BLOCK_M, D, LD>(qs, qb + s0 * D, q0, tq, ld);
  load_tile_async<THREADS, BLOCK_N, D, LD>(ks, kb + s0 * D, 0, tk, ld);
  load_tile_async<THREADS, BLOCK_N, D, LD>(vs, vb, 0, tk, ld);
  cp_async_commit();

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
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      load_tile_async<THREADS, BLOCK_N, D, LD>(
          ks + (st ^ 1) * Layout<D>::KV, kb + s0 * D, (t + 1) * BLOCK_N, tk,
          ld);
      load_tile_async<THREADS, BLOCK_N, D, LD>(
          vs + (st ^ 1) * Layout<D>::KV, vb, (t + 1) * BLOCK_N, tk, ld);
      cp_async_commit();
      cp_async_wait<1>();  // tile t (and q) landed; t + 1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = t * BLOCK_N;
    // every key of the tile right of each of the warp's rows, and none
    // of them fully masked: the tile adds nothing to these rows
    const bool skip = causal && w0 + offset >= 0 && k0 > w0 + 15 + offset;
    T* kt = ks + st * Layout<D>::KV;
    const T* vt = vs + st * Layout<D>::KV;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int i = 0; i < ns; ++i) {
      // a wide head: this step's slice of q (held slice z since the last
      // tile) and, past the first step, of k, copied by the whole block
      if (WIDE && (i > 0 || t > 0)) {
        const int sl = slice_at(i, z, ns);
        __syncthreads();
        load_tile_async<THREADS, BLOCK_M, D, LD>(qs, qb + sl * D, q0, tq, ld);
        if (i > 0)
          load_tile_async<THREADS, BLOCK_N, D, LD>(kt, kb + sl * D, k0, tk,
                                                   ld);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      if (!skip) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, a_frag<LD>(qs, warp * 16, kk * 16, lane));
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t b[4];
            ldsm_x4(b, b_frag<LD>(kt, np * 16, kk * 16, lane));
            M::run(s[2 * np], a, b[0], b[1]);
            M::run(s[2 * np + 1], a, b[2], b[3]);
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
      for (int j = 0; j < 8; ++j) {
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
      // O += P V, 16 keys a step: P = exp(S - m) = 2^(x - m) of blocks
      // 2 kk, 2 kk + 1 as the A operand, hi and lo, one step's at a time
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * kk + h;
          const float p0 = exp2f(s[j][0] - m[0]), p1 = exp2f(s[j][1] - m[0]);
          const float p2 = exp2f(s[j][2] - m[1]), p3 = exp2f(s[j][3] - m[1]);
          l[0] += p0 + p1;
          l[1] += p2 + p3;
          split_pack<T>(p0, p1, ph[2 * h], pl[2 * h]);
          split_pack<T>(p2, p3, ph[2 * h + 1], pl[2 * h + 1]);
        }
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t b[4];
          ldsm_x4_trans(b, bt_frag<LD>(vt, kk * 16, dp * 16, lane));
          M::run(acc[2 * dp], ph, b[0], b[1]);
          M::run(acc[2 * dp], pl, b[0], b[1]);
          M::run(acc[2 * dp + 1], ph, b[2], b[3]);
          M::run(acc[2 * dp + 1], pl, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration
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
  // stage O in the warp's own 16 rows of the q tile (read only by this
  // warp), then store 16 bytes a lane
  T* os = qs + warp * 16 * LD;
#pragma unroll
  for (int j = 0; j < DBLK; ++j) {
    const int col = 8 * j + 2 * tg;
    *reinterpret_cast<uint32_t*>(os + g * LD + col) =
        M::pack(acc[j][0] * inv[0], acc[j][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * LD + col) =
        M::pack(acc[j][2] * inv[1], acc[j][3] * inv[1]);
  }
  __syncwarp();
  store_tile<32, 16, D, LD>(o + bh * tq * ld + z * D, os, w0, tq, lane, ld);
}

template <typename T, int D, bool WIDE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int tq, int tk, int d, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<T, D, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return for_bh_chunks(bh, [&](int b0, int n) {
    const long long qo = (long long)b0 * tq * d, ko = (long long)b0 * tk * d;
    const dim3 grid((tq + BLOCK_M - 1) / BLOCK_M, n, d / D);
    flash_fwd_mma_kernel<T, D, WIDE><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q) + qo, static_cast<const T*>(k) + ko,
        static_cast<const T*>(v) + ko, static_cast<T*>(o) + qo,
        lse + (long long)b0 * tq, tq, tk, scale, causal);
  });
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse,
             int bh, int tq, int tk, int d, float scale, int causal,
             cudaStream_t stream) {
  if (d == 64)
    return launch<T, 64, false>(q, k, v, o, lse, bh, tq, tk, d, scale, causal,
                                stream);
  if (d == HEAD_SLICE)
    return launch<T, HEAD_SLICE, false>(q, k, v, o, lse, bh, tq, tk, d, scale,
                                        causal, stream);
  if (d > 0 && d % HEAD_SLICE == 0)
    return launch<T, HEAD_SLICE, true>(q, k, v, o, lse, bh, tq, tk, d, scale,
                                       causal, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 1 bfloat16, 2 float16 (float32 is flash_fwd_f32mma.cu's); d: 64
// or a multiple of 128. q: [bh, tq, d]; k, v: [bh, tk, d]; o like q;
// lse: [bh, tq] float32. All
// contiguous, 16-byte aligned, on the current device. Returns the CUDA
// error code of the launch (0 = ok).
extern "C" int flash_fwd_mma(const void* q, const void* k, const void* v,
                             void* o, float* lse, int bh, int tq, int tk,
                             int d, int dtype, float scale, int causal,
                             void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return launch_d<__nv_bfloat16>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, s);
    case 2: return launch_d<__half>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
