// Flash-attention backward for Hopper (sm_90a), plain C interface: the
// float32 route of K2 (dQ) and K3 (dK/dV). bf16 and fp16 inputs run the
// tensor-core kernels (flash_bwd_dq_mma.cu, flash_bwd_dkv_mma.cu);
// float32 stays on the CUDA cores: one TF32 rounding cannot meet the
// float32 tiers (rtol 2e-4 / atol 2e-5), and the split-operand scheme
// of the float32 forward (flash_fwd_f32mma.cu) is not applied here yet.
//
// Replaces the two Pallas backward kernels of
// paddle_tpu/ops/pallas_attention.py (launched by _flash_bwd_pallas),
// which share the tile math of _recompute_ds:
//   K2 flash_bwd_dq  (_fa_bwd_dq_kernel):  dQ = sum_k dS K
//   K3 flash_bwd_dkv (_fa_bwd_dkv_kernel): dV = sum_q P^T dO,
//                                          dK = sum_q dS^T Q
// where, per (batch*head) slice of q, do [tq, D] and k, v [tk, D],
//   S  = (Q K^T) * scale
//   P  = exp(S - lse)                  (lse from the forward, K1)
//   dS = P o (dO V^T - delta) * scale  (delta per q row, computed by the
//                                       caller: rowsum(dO o O) - dlse)
// with the semantics of jax.vjp of the reference's _ref_attention_lse,
// not of the Pallas kernels' quirks: causal masking is bottom-right
// (key j visible to row i iff j <= i + tk - tq), masked entries get
// P = dS = 0, keys >= tk and rows >= tq take no part, and a row whose
// every key is masked (causal with tq > tk) averages V in the forward,
// so it has P = 1/tk on every key and dS = 0. Its lse from K1 is
// -1e30 + log(tk), which rounds to -1e30 in float32, so P cannot be
// recomputed from it: such rows are recognised by their index instead.
//
// What bounds it: K2 does 6*D FLOP per visible (row, key) pair (QK^T,
// dO V^T, dS K) and K3 8*D (QK^T, dO V^T, P^T dO, dS^T Q), in float32
// outside the tensor cores (67 TFLOP/s on the H100): at chip_smoke.py's
// float32 shape (B*H = 8, T = 256, D = 128, causal) that is 0.20 and
// 0.27 GFLOP against ~5 and ~6 MB, bound by operations (~0.003 and
// ~0.004 ms).
//
// Design (simple and right first, as the first K1 was): SIMT float32
// FMAs, tiles staged in shared memory as float32, rows padded to D + 1
// floats so the four threads that share a row (K2) or a key (K3) and
// the eight rows of a warp hit distinct banks.
//   K2: one block of 256 threads per (bh, 64-row q tile), looping over
//       32-key k/v tiles; four threads own one q row, each computes 8 of
//       the tile's 32 (S, dO V^T) pairs, writes its dS to shared memory,
//       and keeps D/4 dQ accumulators in registers. Tiles right of the
//       causal diagonal are skipped.
//   K3: one block of 256 threads per (bh, 64-key k/v tile), looping over
//       32-row q tiles; four threads own one key, each computes 8 of the
//       tile's 32 rows' (S, dO V^T), writes P and dS to shared memory,
//       and keeps D/4 dK and D/4 dV accumulators in registers. q tiles
//       wholly above the causal diagonal are skipped.
//
// What it leaves on the table: both kernels load tiles synchronously;
// S and dO V^T are recomputed by K2 and K3; K/V of a GQA group are read
// once per q head. A float32 design on the tensor cores needs another
// precision scheme than TF32 (a 3xTF32 split, say).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;  // four threads per row (K2) / per key (K3)
constexpr int PER_THREAD = 8;  // (row, key) pairs per thread per tile
// K2: q rows per block, keys per tile
constexpr int DQ_BLOCK_M = 64;
constexpr int DQ_BLOCK_N = 4 * PER_THREAD;
// K3: keys per block, q rows per tile
constexpr int DKV_BLOCK_N = 64;
constexpr int DKV_BLOCK_M = 4 * PER_THREAD;

// rows [g0, g0 + n) of a [t, D] slice into a padded float32 tile; rows
// past t are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int g0,
                                          int n, int t) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < n * D; i += THREADS) {
    const int row = i / D, col = i % D;
    const int g = g0 + row;
    dst[row * DP + col] = g < t ? src[(long long)g * D + col] : 0.f;
  }
}

// the padded float32 tile's rows [g0, g0 + n) back to a [t, D] slice
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* dst, const float* src, int g0,
                                           int n, int t) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < n * D; i += THREADS) {
    const int row = i / D, col = i % D;
    const int g = g0 + row;
    if (g < t) dst[(long long)g * D + col] = src[row * DP + col];
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // q, do [BLOCK_M][D + 1]; k, v [BLOCK_N][D + 1]; dS [BLOCK_M][BLOCK_N + 1]
  return sizeof(float) * (2 * DQ_BLOCK_M * (D + 1) + 2 * DQ_BLOCK_N * (D + 1) +
                          DQ_BLOCK_M * (DQ_BLOCK_N + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int tq, int tk, float scale, int causal) {
  constexpr int BM = DQ_BLOCK_M, BN = DQ_BLOCK_N;
  constexpr int DP = D + 1;
  constexpr int ACC = D / 4;
  extern __shared__ float smem[];
  float* qs = smem;                 // [BM][DP]
  float* dos = qs + BM * DP;        // [BM][DP]
  float* ks = dos + BM * DP;        // [BN][DP]
  float* vs = ks + BN * DP;         // [BN][DP]
  float* dss = vs + BN * DP;        // [BM][BN + 1]

  const int tid = threadIdx.x;
  const int r = tid >> 2;           // q row within the tile
  const int c = tid & 3;            // quarter of the row
  const int q0 = blockIdx.x * BM;
  const long long bh = blockIdx.y;
  const T* kb = k + bh * tk * D;
  const T* vb = v + bh * tk * D;

  load_tile<T, D>(qs, q + bh * tq * D, q0, BM, tq);
  load_tile<T, D>(dos, dout + bh * tq * D, q0, BM, tq);

  const int row_g = q0 + r;
  const bool row_in = row_g < tq;
  const float lse_r = row_in ? lse[bh * tq + row_g] : 0.f;
  const float delta_r = row_in ? delta[bh * tq + row_g] : 0.f;

  // causal: keys past the last row's limit are masked for every row of
  // the block (dS = 0 there); a row with no visible key (row + offset
  // < 0) has dS = 0 on every key, so a block of only such rows has
  // dQ = 0 and visits no tile
  const int offset = tk - tq;
  int n_tiles = (tk + BN - 1) / BN;
  if (causal) {
    const int last_col = q0 + BM - 1 + offset;
    n_tiles = last_col < 0 ? 0 : min(n_tiles, last_col / BN + 1);
  }

  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // previous tile consumed (and q, do tiles stored)
    load_tile<T, D>(ks, kb, k0, BN, tk);
    load_tile<T, D>(vs, vb, k0, BN, tk);
    __syncthreads();

    float s[PER_THREAD], dp[PER_THREAD];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) s[j] = dp[j] = 0.f;
    const float* qrow = qs + r * DP;
    const float* dorow = dos + r * DP;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = qrow[d], dov = dorow[d];
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) {
        s[j] = fmaf(qv, ks[(c + 4 * j) * DP + d], s[j]);
        dp[j] = fmaf(dov, vs[(c + 4 * j) * DP + d], dp[j]);
      }
    }
    float* dsrow = dss + r * (BN + 1);
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int col = k0 + c + 4 * j;
      const bool live = row_in && col < tk && !(causal && row_g + offset < col);
      const float p = live ? __expf(s[j] * scale - lse_r) : 0.f;
      dsrow[c + 4 * j] = p * (dp[j] - delta_r) * scale;
    }
    __syncwarp();  // the row's four threads live in one warp
    for (int j = 0; j < BN; ++j) {
      const float ds = dsrow[j];
      const float* krow = ks + j * DP + c;
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] = fmaf(ds, krow[4 * i], acc[i]);
    }
  }

  // stage dQ through shared memory so the global store is coalesced
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ACC; ++i) qs[r * DP + c + 4 * i] = acc[i];
  __syncthreads();
  store_tile<T, D>(dq + bh * tq * D, qs, q0, BM, tq);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k, v [BLOCK_N][D + 1]; q, do [BLOCK_M][D + 1]; P, dS
  // [BLOCK_N][BLOCK_M + 1]; lse, delta [BLOCK_M]
  return sizeof(float) * (2 * DKV_BLOCK_N * (D + 1) + 2 * DKV_BLOCK_M * (D + 1) +
                          2 * DKV_BLOCK_N * (DKV_BLOCK_M + 1) + 2 * DKV_BLOCK_M);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int tq, int tk, float scale,
                     int causal) {
  constexpr int BN = DKV_BLOCK_N, BM = DKV_BLOCK_M;
  constexpr int DP = D + 1;
  constexpr int ACC = D / 4;
  extern __shared__ float smem[];
  float* ks = smem;                 // [BN][DP]
  float* vs = ks + BN * DP;         // [BN][DP]
  float* qs = vs + BN * DP;         // [BM][DP]
  float* dos = qs + BM * DP;        // [BM][DP]
  float* ps = dos + BM * DP;        // [BN][BM + 1]
  float* dss = ps + BN * (BM + 1);  // [BN][BM + 1]
  float* lses = dss + BN * (BM + 1);  // [BM]
  float* dls = lses + BM;           // [BM]

  const int tid = threadIdx.x;
  const int r = tid >> 2;           // key within the tile
  const int c = tid & 3;            // quarter of the key's row
  const int k0 = blockIdx.x * BN;
  const long long bh = blockIdx.y;
  const T* qb = q + bh * tq * D;
  const T* dob = dout + bh * tq * D;
  const float* lseb = lse + bh * tq;
  const float* dlb = delta + bh * tq;

  load_tile<T, D>(ks, k + bh * tk * D, k0, BN, tk);
  load_tile<T, D>(vs, v + bh * tk * D, k0, BN, tk);

  const int key_g = k0 + r;
  const bool key_in = key_g < tk;
  const float p_masked_row = 1.f / (float)tk;

  // causal: row i sees key j iff i >= j - offset, so the first q tile
  // that sees any key of this block starts at row k0 - offset. Rows
  // with no visible key at all (i < -offset, only when tq > tk) see
  // every key with P = 1/tk: then every tile is visited.
  const int offset = tk - tq;
  const int n_tiles = (tq + BM - 1) / BM;
  int t0 = 0;
  if (causal && offset >= 0) t0 = max(0, k0 - offset) / BM;

  float dk_acc[ACC], dv_acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int t = t0; t < n_tiles; ++t) {
    const int q0 = t * BM;
    __syncthreads();  // previous tile consumed (and k, v tiles stored)
    load_tile<T, D>(qs, qb, q0, BM, tq);
    load_tile<T, D>(dos, dob, q0, BM, tq);
    for (int i = tid; i < BM; i += THREADS) {
      const int g = q0 + i;
      lses[i] = g < tq ? lseb[g] : 0.f;
      dls[i] = g < tq ? dlb[g] : 0.f;
    }
    __syncthreads();

    float s[PER_THREAD], dp[PER_THREAD];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) s[j] = dp[j] = 0.f;
    const float* krow = ks + r * DP;
    const float* vrow = vs + r * DP;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kv = krow[d], vv = vrow[d];
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) {
        s[j] = fmaf(qs[(c + 4 * j) * DP + d], kv, s[j]);
        dp[j] = fmaf(dos[(c + 4 * j) * DP + d], vv, dp[j]);
      }
    }
    float* prow = ps + r * (BM + 1);
    float* dsrow = dss + r * (BM + 1);
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int i = c + 4 * j;
      const int row = q0 + i;
      float p = 0.f, ds = 0.f;
      if (key_in && row < tq) {
        if (causal && row + offset < 0) {
          p = p_masked_row;               // fully masked row: dS = 0
        } else if (!(causal && row + offset < key_g)) {
          p = __expf(s[j] * scale - lses[i]);
          ds = p * (dp[j] - dls[i]) * scale;
        }
      }
      prow[i] = p;
      dsrow[i] = ds;
    }
    __syncwarp();  // the key's four threads live in one warp
    for (int i = 0; i < BM; ++i) {
      const float p = prow[i], ds = dsrow[i];
      const float* dorow = dos + i * DP + c;
      const float* qrow = qs + i * DP + c;
#pragma unroll
      for (int a = 0; a < ACC; ++a) {
        dv_acc[a] = fmaf(p, dorow[4 * a], dv_acc[a]);
        dk_acc[a] = fmaf(ds, qrow[4 * a], dk_acc[a]);
      }
    }
  }

  // stage dK, dV through shared memory so the global stores are coalesced
  __syncthreads();
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    ks[r * DP + c + 4 * a] = dk_acc[a];
    vs[r * DP + c + 4 * a] = dv_acc[a];
  }
  __syncthreads();
  store_tile<T, D>(dk + bh * tk * D, ks, k0, BN, tk);
  store_tile<T, D>(dv + bh * tk * D, vs, k0, BN, tk);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int bh, tq, tk;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tq + DQ_BLOCK_M - 1) / DQ_BLOCK_M, a.bh);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.tq, a.tk, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tk + DKV_BLOCK_N - 1) / DKV_BLOCK_N, a.bh);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.tq, a.tk,
      a.scale, a.causal);
  return (int)cudaGetLastError();
}

// one of the two launchers above, for the head dim; float32 only:
// bfloat16 and float16 are the tensor-core kernels'
template <template <typename, int> class L>
int dispatch(const Args& a, int d, int dtype) {
  if (a.bh <= 0 || a.tq <= 0 || a.tk <= 0 || a.bh > 65535 || dtype != 0)
    return (int)cudaErrorInvalidValue;
  if (d == 64) return L<float, 64>::run(a);
  if (d == 128) return L<float, 128>::run(a);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int D>
struct DQ {
  static int run(const Args& a) { return launch_dq<T, D>(a); }
};

template <typename T, int D>
struct DKV {
  static int run(const Args& a) { return launch_dkv<T, D>(a); }
};

}  // namespace

// dtype: 0 float32 only (1 bfloat16 and 2 float16 are refused: the
// 16-bit route is flash_bwd_dq_mma.cu and flash_bwd_dkv_mma.cu); d: 64
// or 128. q, dout, dq: [bh, tq, d]; k, v: [bh, tk, d]; lse, delta:
// [bh, tq] float32. All contiguous, on the current device. Return the
// CUDA error code of the launch (0 = ok).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int bh, int tq,
                            int tk, int d, int dtype, float scale,
                            int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, bh, tq, tk,
               scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<DQ>(a, d, dtype);
}

// dk, dv: [bh, tk, d] float32.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv, int bh,
                             int tq, int tk, int d, int dtype, float scale,
                             int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, bh, tq, tk,
               scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<DKV>(a, d, dtype);
}
