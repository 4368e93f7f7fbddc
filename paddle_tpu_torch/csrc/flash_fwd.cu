// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas_attention.py:_fa_kernel (launched by
// _flash_fwd_pallas). Computes, per (batch*head) slice of q [tq, D] and
// k, v [tk, D]:
//   S   = (Q K^T) * scale, causal-masked bottom-right (row + tk - tq >= col)
//   O   = softmax(S) V    by online softmax (running max m, sum l)
//   lse = m + log(l)      (l == 0 -> 1), compact [BH, tq] float32
// with the semantics of the reference's _ref_attention_lse: masked
// scores are -1e30 (a fully masked row averages V, as the reference
// does), keys >= tk are masked out entirely and rows >= tq are never
// written.
//
// What bounds it: at the serving shapes (B*H = 4*32, T = 256, D = 128,
// causal, bf16) the call moves ~34 MB (q, k, v read, o written) against
// ~2.2 GFLOP of useful work, 64 FLOP per byte — far below the H100's
// ~295 bf16 FLOP/byte ridge, so the card's bound is its 3.35 TB/s of
// memory bandwidth (~10 us).
//
// Design (simple and right first): one block of 256 threads per
// (bh, 64-row q tile). The q tile and each 32-key k/v tile are staged in
// shared memory as float32 (~74 KB for D = 128, dynamic shared memory);
// four threads own one q row: each computes 8 of the tile's 32 scores
// with SIMT float32 FMAs, the row max and sum reduce over the four with
// warp shuffles, and each keeps D/4 output accumulators in registers.
// Whole k tiles above the causal diagonal are skipped.
//
// What it leaves on the table: the products run on the CUDA cores in
// float32, not on the tensor cores (wgmma / mma.sync); tiles are loaded
// synchronously (no TMA / cp.async double buffering), so loads and math
// do not overlap; K/V of a GQA group are re-read once per q head. Each
// is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

namespace {

constexpr int BLOCK_M = 64;   // q rows per block
constexpr int BLOCK_N = 32;   // keys per k/v tile
constexpr int THREADS = 256;  // 4 threads per q row
constexpr int COLS_PER_THREAD = BLOCK_N / 4;
constexpr float MASKED = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // q tile and k tile padded to D + 1 floats a row (no bank conflicts
  // when the four threads of a row read four different keys), v tile
  // unpadded, p tile padded to BLOCK_N + 1.
  return sizeof(float) * (BLOCK_M * (D + 1) + BLOCK_N * (D + 1) +
                          BLOCK_N * D + BLOCK_M * (BLOCK_N + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int tq, int tk, float scale,
                 int causal) {
  constexpr int DP = D + 1;
  constexpr int ACC = D / 4;
  extern __shared__ float smem[];
  float* qs = smem;                       // [BLOCK_M][DP]
  float* ks = qs + BLOCK_M * DP;          // [BLOCK_N][DP]
  float* vs = ks + BLOCK_N * DP;          // [BLOCK_N][D]
  float* ps = vs + BLOCK_N * D;           // [BLOCK_M][BLOCK_N + 1]

  const int tid = threadIdx.x;
  const int r = tid >> 2;                 // q row within the tile
  const int c = tid & 3;                  // quarter of the row
  const int q0 = blockIdx.x * BLOCK_M;
  const long long bh = blockIdx.y;
  const T* qb = q + bh * tq * D;
  const T* kb = k + bh * tk * D;
  const T* vb = v + bh * tk * D;

  for (int i = tid; i < BLOCK_M * D; i += THREADS) {
    const int row = i / D, col = i % D;
    const int g = q0 + row;
    qs[row * DP + col] = g < tq ? to_f32(qb[(long long)g * D + col]) : 0.f;
  }

  // causal: key j is visible to row i iff j <= i + (tk - tq). A k tile
  // wholly right of the last row's limit contributes exactly zero (its
  // masked scores underflow against a finite running max) and is
  // skipped. A block holding a fully masked row (q0 + tk - tq < 0)
  // visits every tile: the reference averages V over all keys there.
  const int offset = tk - tq;
  int n_tiles = (tk + BLOCK_N - 1) / BLOCK_N;
  if (causal && q0 + offset >= 0) {
    const int last_col = q0 + BLOCK_M - 1 + offset;
    n_tiles = min(n_tiles, last_col / BLOCK_N + 1);
  }

  const int row_g = q0 + r;
  float m = -INFINITY, l = 0.f;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BLOCK_N;
    __syncthreads();  // previous tile fully consumed (and q tile stored)
    for (int i = tid; i < BLOCK_N * D; i += THREADS) {
      const int row = i / D, col = i % D;
      const int g = k0 + row;
      const bool in = g < tk;
      ks[row * DP + col] = in ? to_f32(kb[(long long)g * D + col]) : 0.f;
      vs[row * D + col] = in ? to_f32(vb[(long long)g * D + col]) : 0.f;
    }
    __syncthreads();

    float s[COLS_PER_THREAD];
#pragma unroll
    for (int j = 0; j < COLS_PER_THREAD; ++j) s[j] = 0.f;
    const float* qrow = qs + r * DP;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int j = 0; j < COLS_PER_THREAD; ++j)
        s[j] = fmaf(qv, ks[(c + 4 * j) * DP + d], s[j]);
    }
    float m_cur = -INFINITY;
#pragma unroll
    for (int j = 0; j < COLS_PER_THREAD; ++j) {
      const int col = k0 + c + 4 * j;
      float x = s[j] * scale;
      if (col >= tk) {
        x = -INFINITY;                    // not a key at all
      } else if (causal && row_g + offset < col) {
        x = MASKED;
      }
      s[j] = x;
      m_cur = fmaxf(m_cur, x);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 2));
    const float m_new = fmaxf(m, m_cur);  // finite: every tile holds a key
    const float corr = __expf(m - m_new);
    float psum = 0.f;
    float* prow = ps + r * (BLOCK_N + 1);
#pragma unroll
    for (int j = 0; j < COLS_PER_THREAD; ++j) {
      const float p = __expf(s[j] - m_new);
      psum += p;
      prow[c + 4 * j] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // the row's four threads live in one warp
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] *= corr;
    for (int j = 0; j < BLOCK_N; ++j) {
      const float p = prow[j];
      const float* vrow = vs + j * D + c;
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] = fmaf(p, vrow[4 * i], acc[i]);
    }
  }

  const float safe_l = l == 0.f ? 1.f : l;
  const float inv_l = 1.f / safe_l;
  if (c == 0 && row_g < tq) lse[bh * tq + row_g] = m + logf(safe_l);
  // stage O through shared memory so the global store is coalesced
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ACC; ++i) qs[r * DP + c + 4 * i] = acc[i] * inv_l;
  __syncthreads();
  T* ob = o + bh * tq * D;
  for (int i = tid; i < BLOCK_M * D; i += THREADS) {
    const int row = i / D, col = i % D;
    const int g = q0 + row;
    if (g < tq) ob[(long long)g * D + col] = from_f32<T>(qs[row * DP + col]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int tq, int tk, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((tq + BLOCK_M - 1) / BLOCK_M, bh);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, tq, tk, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse,
             int bh, int tq, int tk, int d, float scale, int causal,
             cudaStream_t stream) {
  if (d == 64)
    return launch<T, 64>(q, k, v, o, lse, bh, tq, tk, scale, causal, stream);
  if (d == 128)
    return launch<T, 128>(q, k, v, o, lse, bh, tq, tk, scale, causal, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. q: [bh, tq, d]; k, v:
// [bh, tk, d]; o like q; lse: [bh, tq] float32. All contiguous, on the
// current device. Returns the CUDA error code of the launch (0 = ok).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int bh, int tq, int tk, int d, int dtype,
                         float scale, int causal, void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_d<float>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, s);
    case 1: return launch_d<__nv_bfloat16>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, s);
    case 2: return launch_d<__half>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
