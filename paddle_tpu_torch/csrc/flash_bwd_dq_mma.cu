// Flash-attention backward dQ on Hopper's tensor cores (sm_90a,
// mma.sync), bf16 and fp16, plain C interface. The float32 route is
// flash_bwd_dq_f32mma.cu.
//
// Replaces paddle_tpu/ops/pallas_attention.py:223 _fa_bwd_dq_kernel
// (with _recompute_ds, :161; the first pallas_call of _flash_bwd_pallas,
// :273). Per (batch*head) slice of q, do [tq, D] and k, v [tk, D], D 64
// or any multiple of 128, it computes:
//   P  = exp(S - lse), S = (Q K^T) * scale   (lse from the forward, K1)
//   dS = P o (dO V^T - delta) * scale         (delta per q row, from the
//                                              caller: rowsum(dO o O) - dlse)
//   dQ = sum_k dS K                           (in q's dtype)
// with jax.vjp of _ref_attention_lse's semantics: causal masking is
// bottom-right (key j visible to row i iff j <= i + tk - tq), masked
// entries and keys >= tk have dS = 0, and a fully masked row (causal,
// tq > tk; its float32 lse is -1e30) has dS = 0 on every key, so its dQ
// is 0 -- recognised by index, as every one of its keys is masked. Rows
// >= tq are never written.
//
// What bounds it on the H100: at the training shape (B*H = 2*32,
// T = 2048, D = 128, causal) it does 103.1 GFLOP of useful products
// (6 D FLOP per visible pair: Q K^T, dO V^T, dS K) against 169 MB moved:
// the bf16 tensor-core rate, 0.104 ms.
//
// Design (K1's loop of flash_fwd_mma.cu, with dO V^T beside Q K^T, K in
// the place of V and no online softmax, since P comes back from lse):
// - one block of 4 warps per (bh, 64-row q tile); each warp owns 16
//   rows. Q and dO stay in shared memory for the whole key loop; each
//   lane's two rows' lse and delta sit in registers. Blocks are handed
//   out heaviest first (under the causal mask the last q tiles see the
//   most keys).
// - 64-key k and v tiles stream through a two-stage 16-byte cp.async
//   ring (zero-filled past tk), so the next tile's copy overlaps this
//   tile's math. Rows are padded to D + 8 elements for conflict-free
//   ldmatrix. Q + dO + the ring: 104 KB at D = 128, two blocks a SM.
// - S = Q K^T and dP = dO V^T on mma.sync.m16n8k16 with float32
//   accumulators, K and V through ldmatrix as B operands; the
//   accumulator rows are the warp's q rows. P and dS are formed in
//   float32 registers (P in base 2: scale log2(e) and lse log2(e) folded).
// - dS goes from the accumulators straight into the A operand of
//   dQ += dS K (K through ldmatrix.trans, as V in K1's P V); it never
//   touches shared memory. dS is split into hi + lo 16-bit halves and
//   the product taken twice: one bf16 rounding of dS (2^-9) puts dQ at
//   3.0x the check tier's limit at the training shape, the split at
//   0.60x (tests/test_torch_kernel_routing.py, _rounding_ratios). That
//   is 8 D executed FLOP per pair for 6 D of useful work.
// - dQ accumulates in float32 registers (D/2 a lane), is staged as T in
//   the warp's own rows of the q tile and stored 16 bytes a lane.
// - causal: k tiles wholly right of the block's last row are not
//   visited (a block of fully masked rows visits none and writes
//   zeros), a warp skips a tile wholly right of its own rows, and the
//   elementwise mask runs only on tiles the diagonal or the ragged end
//   crosses.
// - registers: __launch_bounds__(128, 2) leaves up to 255 a thread
//   (shared memory, not registers, holds it to two blocks a SM): 224
//   (bf16) / 220 (fp16) at D = 128, 188 at D = 64, no spill. Of the
//   tiles tile_sweep.py times on the H100, this one was fastest:
//   128 rows with 8 warps (one block a SM) ran 11% slower, 32-key tiles
//   with three blocks a SM 2% slower (PERF.md).

// - a head dim past 128 runs the D = 128 kernel in 128-column slices
//   (mma_sm90.cuh HEAD_SLICE): block z of gridDim.z writes columns
//   [128 z, 128 z + 128) of dQ. S and dP sum the slices' products, each
//   slice's q, dO, k and v tiles copied afresh (waited for), the last
//   slice being z, whose k tile dQ += dS K reads.
//
// What it leaves: wgmma with TMA and warp specialisation; fusing dQ into
// K3's pass (flash_bwd_dkv_mma.cu), which would take atomics and give up
// a deterministic dQ; reading GQA KV heads in place instead of after
// repeat_interleave.

#include "mma_sm90.cuh"

#include <math.h>

namespace {

using namespace mma_sm90;

constexpr int BLOCK_M = 64;   // q rows per block: 4 warps x 16
constexpr int BLOCK_N = 64;   // keys per k/v tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

static_assert(BLOCK_M == WARPS * 16, "one m16 row block per warp");
static_assert(BLOCK_N % 16 == 0, "whole k-steps of dQ += dS K");

template <int D>
struct Layout {
  static constexpr int LD = D + 8;              // padded row stride
  static constexpr int Q = BLOCK_M * LD;        // q tile (then dQ staging)
  static constexpr int KV = BLOCK_N * LD;       // one k or v stage
  // q, dO; k [2], v [2]
  static constexpr size_t bytes = 2 * (2 * Q + 4 * KV);
};

// WIDE: D = HEAD_SLICE and the head is gridDim.z slices of it
template <typename T, int D, bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int tq, int tk, float scale, int causal) {
  using M = Mma<T>;
  constexpr int LD = Layout<D>::LD;
  constexpr int KSTEPS = D / 16;  // k-steps of Q K^T over the head dim
  constexpr int DBLK = D / 8;     // 8-column blocks of dQ
  constexpr int NBLK = BLOCK_N / 8;  // 8-key blocks of S and dP
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);   // [BLOCK_M][LD]
  T* dos = qs + Layout<D>::Q;               // [BLOCK_M][LD]
  T* ks = dos + Layout<D>::Q;               // [2][BLOCK_N][LD]
  T* vs = ks + 2 * Layout<D>::KV;           // [2][BLOCK_N][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BLOCK_M;  // heaviest first
  const long long bh = blockIdx.y;
  const int ns = WIDE ? gridDim.z : 1, z = WIDE ? blockIdx.z : 0;
  const int ld = D * ns;               // global row stride
  const int s0 = WIDE ? slice_at(0, z, ns) : 0;
  const T* qb = q + bh * tq * ld;
  const T* dob = dout + bh * tq * ld;
  const T* kb = k + bh * tk * ld;
  const T* vb = v + bh * tk * ld;

  // causal: key j is visible to row i iff j <= i + offset. Keys past the
  // block's last row's limit have dS = 0 for every row of the block; a
  // block of fully masked rows (last row + offset < 0) visits no tile.
  const int offset = tk - tq;
  int n_tiles = (tk + BLOCK_N - 1) / BLOCK_N;
  if (causal) {
    const int last = min(q0 + BLOCK_M, tq) - 1 + offset;
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BLOCK_N + 1);
  }

  load_tile_async<THREADS, BLOCK_M, D, LD>(qs, qb + s0 * D, q0, tq, ld);
  load_tile_async<THREADS, BLOCK_M, D, LD>(dos, dob + s0 * D, q0, tq, ld);
  if (n_tiles > 0) {
    load_tile_async<THREADS, BLOCK_N, D, LD>(ks, kb + s0 * D, 0, tk, ld);
    load_tile_async<THREADS, BLOCK_N, D, LD>(vs, vb + s0 * D, 0, tk, ld);
  }
  cp_async_commit();

  const int w0 = q0 + warp * 16;       // the warp's first row
  const int row_a = w0 + g;            // this lane's rows: row_a, row_a + 8
  // the warp's last row that exists; its limit bounds the warp's keys
  const int w_last = min(w0 + 15, tq - 1);
  // P = 2^(S scale log2(e) - lse log2(e)); rows >= tq are never written,
  // so what they compute does not matter
  const float scale2 = scale * LOG2E;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    lse2[r] = row < tq ? lse[bh * tq + row] * LOG2E : 0.f;
    dl[r] = row < tq ? delta[bh * tq + row] : 0.f;
  }
  float acc[DBLK][4];
#pragma unroll
  for (int j = 0; j < DBLK; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      load_tile_async<THREADS, BLOCK_N, D, LD>(
          ks + (st ^ 1) * Layout<D>::KV, kb + s0 * D, (t + 1) * BLOCK_N, tk,
          ld);
      load_tile_async<THREADS, BLOCK_N, D, LD>(
          vs + (st ^ 1) * Layout<D>::KV, vb + s0 * D, (t + 1) * BLOCK_N, tk,
          ld);
      cp_async_commit();
      cp_async_wait<1>();  // tile t (and q, dO) landed; t + 1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = t * BLOCK_N;
    // no row of the warp exists, or every key of the tile is right of
    // each of its rows (fully masked rows included): dS = 0 here
    const bool skip = w0 >= tq || (causal && k0 > w_last + offset);
    T* kt = ks + st * Layout<D>::KV;
    T* vt = vs + st * Layout<D>::KV;
    float s[NBLK][4], dp[NBLK][4];
#pragma unroll
    for (int j = 0; j < NBLK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    for (int i = 0; i < ns; ++i) {
      // a wide head: this step's slice of q and dO (held slice z since
      // the last tile) and, past the first step, of k and v; the last
      // step's is slice z, which dQ += dS K reads
      if (WIDE && (i > 0 || t > 0)) {
        const int sl = slice_at(i, z, ns);
        __syncthreads();
        load_tile_async<THREADS, BLOCK_M, D, LD>(qs, qb + sl * D, q0, tq, ld);
        load_tile_async<THREADS, BLOCK_M, D, LD>(dos, dob + sl * D, q0, tq,
                                                 ld);
        if (i > 0) {
          load_tile_async<THREADS, BLOCK_N, D, LD>(kt, kb + sl * D, k0, tk,
                                                   ld);
          load_tile_async<THREADS, BLOCK_N, D, LD>(vt, vb + sl * D, k0, tk,
                                                   ld);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      if (!skip) {
        // S = Q K^T and dP = dO V^T: 16 rows x BLOCK_N keys each
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          uint32_t a[4], ad[4];
          ldsm_x4(a, a_frag<LD>(qs, warp * 16, kk * 16, lane));
          ldsm_x4(ad, a_frag<LD>(dos, warp * 16, kk * 16, lane));
#pragma unroll
          for (int np = 0; np < NBLK / 2; ++np) {
            uint32_t b[4];
            ldsm_x4(b, b_frag<LD>(kt, np * 16, kk * 16, lane));
            M::run(s[2 * np], a, b[0], b[1]);
            M::run(s[2 * np + 1], a, b[2], b[3]);
            ldsm_x4(b, b_frag<LD>(vt, np * 16, kk * 16, lane));
            M::run(dp[2 * np], ad, b[0], b[1]);
            M::run(dp[2 * np + 1], ad, b[2], b[3]);
          }
        }
      }
    }
    if (!skip) {
      // dS = P o (dP - delta) scale in place of S, 0 where masked (keys
      // >= tk, right of the diagonal, every key of a fully masked row);
      // the mask only where the ragged end or the diagonal crosses
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
      // dQ += dS K, 16 keys a step: dS of blocks 2 kk, 2 kk + 1 as the A
      // operand, hi and lo
#pragma unroll
      for (int kk = 0; kk < NBLK / 2; ++kk) {
        uint32_t dh[4], dlo[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * kk + h;
          split_pack<T>(s[j][0], s[j][1], dh[2 * h], dlo[2 * h]);
          split_pack<T>(s[j][2], s[j][3], dh[2 * h + 1], dlo[2 * h + 1]);
        }
#pragma unroll
        for (int dpi = 0; dpi < D / 16; ++dpi) {
          uint32_t b[4];
          ldsm_x4_trans(b, bt_frag<LD>(kt, kk * 16, dpi * 16, lane));
          M::run(acc[2 * dpi], dh, b[0], b[1]);
          M::run(acc[2 * dpi], dlo, b[0], b[1]);
          M::run(acc[2 * dpi + 1], dh, b[2], b[3]);
          M::run(acc[2 * dpi + 1], dlo, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration
  }
  // every copy landed (also when no tile was visited) before the q tile
  // is reused
  cp_async_wait<0>();
  __syncthreads();

  // stage dQ in the warp's own 16 rows of the q tile (read only by this
  // warp), then store 16 bytes a lane
  T* os = qs + warp * 16 * LD;
#pragma unroll
  for (int j = 0; j < DBLK; ++j) {
    const int col = 8 * j + 2 * tg;
    *reinterpret_cast<uint32_t*>(os + g * LD + col) =
        M::pack(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * LD + col) =
        M::pack(acc[j][2], acc[j][3]);
  }
  __syncwarp();
  store_tile<32, 16, D, LD>(dq + bh * tq * ld + z * D, os, w0, tq, lane, ld);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void* dq;
  int bh, tq, tk, d;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D, bool WIDE>
int launch(const Args& a) {
  constexpr size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<T, D, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return for_bh_chunks(a.bh, [&](int b0, int n) {
    const long long qo = (long long)b0 * a.tq * a.d;
    const long long ko = (long long)b0 * a.tk * a.d;
    const long long ro = (long long)b0 * a.tq;
    const dim3 grid((a.tq + BLOCK_M - 1) / BLOCK_M, n, a.d / D);
    flash_bwd_dq_mma_kernel<T, D, WIDE><<<grid, THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q) + qo, static_cast<const T*>(a.k) + ko,
        static_cast<const T*>(a.v) + ko, static_cast<const T*>(a.dout) + qo,
        a.lse + ro, a.delta + ro, static_cast<T*>(a.dq) + qo, a.tq, a.tk,
        a.scale, a.causal);
  });
}

template <typename T>
int launch_d(const Args& a) {
  if (a.d == 64) return launch<T, 64, false>(a);
  if (a.d == HEAD_SLICE) return launch<T, HEAD_SLICE, false>(a);
  if (a.d > 0 && a.d % HEAD_SLICE == 0) return launch<T, HEAD_SLICE, true>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 1 bfloat16, 2 float16 (float32 is flash_bwd_dq_f32mma.cu's); d: 64 or
// a multiple of 128. q, dout, dq: [bh, tq, d]; k, v: [bh, tk, d]; lse, delta: [bh, tq]
// float32. All contiguous, the 16-bit tensors 16-byte aligned, on the
// current device. Returns the CUDA error code of the launch (0 = ok).
extern "C" int flash_bwd_dq_mma(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dq, int bh, int tq,
                                int tk, int d, int dtype, float scale,
                                int causal, void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, dq, bh, tq, tk, d,
               scale, causal, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 1: return launch_d<__nv_bfloat16>(a);
    case 2: return launch_d<__half>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
