// Flash-attention backward dK/dV at head dim 256 on Hopper's warpgroup
// tensor cores (sm_90a: wgmma, TMA, warp specialisation), bf16 and fp16,
// plain C interface. Other head dims and float32 run
// flash_bwd_dkv_mma.cu and flash_bwd_dkv_f32mma.cu; dQ (K2) stays
// flash_bwd_dq_mma.cu's at every head dim.
//
// Replaces paddle_tpu/ops/pallas_attention.py:189 _fa_bwd_dkv_kernel
// (with _recompute_ds, :161; the second pallas_call of
// _flash_bwd_pallas, :290) at D = 256. Per (batch*head) slice of q, do
// [tq, 256] and k, v [tk, 256] it computes
//   P  = exp(S - lse), S = (Q K^T) * scale   (lse from the forward, K1)
//   dS = P o (dO V^T - delta) * scale         (delta per q row, from the
//                                              caller: rowsum(dO o O) - dlse)
//   dV = sum_q P^T dO,   dK = sum_q dS^T Q
// with jax.vjp of _ref_attention_lse's semantics: causal masking is
// bottom-right (key j visible to row i iff j <= i + tk - tq), masked
// entries have P = dS = 0, keys >= tk and rows >= tq take no part, and
// a fully masked row (causal, tq > tk) has P = 1/tk on every key and
// dS = 0, recognised by its index.
//
// What bounds it on the H100: at the head_dim_256 training shape
// (B*H = 2*16, T = 2048, D = 256, causal) it does 137.5 GFLOP of useful
// products (8 D FLOP per visible pair: K Q^T, V dO^T, P^T dO, dS^T Q)
// against 201 MB moved: the bf16 tensor-core rate, 0.139 ms.
//
// Design:
// - one block of three warpgroups per (bh, 64-key tile). Warpgroup 0 is
//   the producer (setmaxnreg down to 24 registers; one thread issues
//   every TMA load). Consumer warpgroup 1 accumulates dV = P^T dO and
//   warpgroup 2 dK = dS^T Q, 64 keys x 256 float32 each: 128
//   accumulator registers a thread, at 240 registers.
// - TMA (3-D tensor maps over [bh, t, 256], 128-byte swizzle, rows past
//   t zero-filled) brings the k and v tiles once (resident, 2 x 32 KB)
//   and the 64-row q and dO tiles through a two-stage ring (2 x 64 KB),
//   on full / empty mbarriers. lse and delta are read by each consumer
//   from global memory (16 values a thread a tile) while it waits.
// - S^T = K Q^T (warpgroup 1) and dP^T = V dO^T (warpgroup 2) each run
//   once a q tile over the whole 256-wide head: 16 wgmma m64n64k16, both
//   operands from shared memory. No slice recomputes either (the sliced
//   D = 128 route took each twice).
// - warpgroup 1 forms P^T (float32, with the masks) and hands it to
//   warpgroup 2 through a two-buffer exchange in shared memory (2 x 16
//   KB, one float a thread a register, no bank conflicts; its own
//   mbarrier pair), then takes dV += P^T dO as wgmma m64n256k16 with P^T
//   in registers and dO read MN-major. Warpgroup 2 forms dS^T from dP^T
//   and P^T and takes dK += dS^T Q the same way. P^T and dS^T enter the
//   products as hi + lo 16-bit halves: with one bf16 rounding of each,
//   dK and dV miss the 16-bit check tier about 6x at the training shape
//   on the H100 (split_check.py; 2.8x / 3.2x at D = 128 in
//   flash_bwd_dkv_mma.cu).
// - ptxas (CUDA 12.9): 168 registers at launch, no spill.
// - shared memory: k, v 64 KB; q, dO 128 KB; P exchange 32 KB; 224 KB
//   and the barriers, of the 227 KB.
// - the q loop starts at the first tile that sees the block's keys
//   (max(0, k0 - offset) / 64) unless fully masked rows exist; the mask
//   runs only on tiles the diagonal or a ragged end crosses.
// - dV is staged in the k tile's memory (read only by warpgroup 1), dK
//   in the v tile's (read only by warpgroup 2), swizzled, then stored
//   16 bytes a lane.
//
// What it leaves: overlapping one tile's elementwise work with the next
// tile's products; fusing dQ (K2) into this pass; reading GQA KV heads
// in place instead of after repeat_interleave.

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

#include <math.h>

namespace {

using namespace wgmma_sm90;
using mma_sm90::for_bh_chunks;

constexpr int D = 256;
constexpr int BLOCK_N = 64;   // keys per block
constexpr int BLOCK_M = 64;   // q rows per tile
constexpr int STAGES = 2;
constexpr int THREADS = 3 * 128;

// shared memory, in bytes from a 1024-byte-aligned base
constexpr int TILE_BYTES = 64 * D * 2;                    // 32 KB
constexpr int OFF_V = TILE_BYTES;
constexpr int OFF_Q = 2 * TILE_BYTES;
constexpr int OFF_DO = OFF_Q + STAGES * TILE_BYTES;
constexpr int OFF_P = OFF_DO + STAGES * TILE_BYTES;
constexpr int P_BYTES = 32 * 128 * 4;                     // 16 KB
constexpr int OFF_BAR = OFF_P + STAGES * P_BYTES;         // 224 KB
constexpr int SMEM_BYTES = OFF_BAR + 128 + 1024;          // + barriers, alignment

struct Bars {
  uint64_t kv_full;
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
  uint64_t p_full[STAGES];
  uint64_t p_empty[STAGES];
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_d256_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_do,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                T* __restrict__ dk, T* __restrict__ dv,
                                int b0, int tq, int tk, float scale,
                                int causal) {
  using W = Wgmma<T>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T* ks = reinterpret_cast<T*>(base);
  T* vs = reinterpret_cast<T*>(base + OFF_V);
  T* qs = reinterpret_cast<T*>(base + OFF_Q);
  T* dos = reinterpret_cast<T*>(base + OFF_DO);
  float* pbuf = reinterpret_cast<float*>(base + OFF_P);
  Bars& bar = *reinterpret_cast<Bars*>(base + OFF_BAR);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int k0 = blockIdx.x * BLOCK_N;
  const int bh = b0 + blockIdx.y;

  // causal: row i sees key j iff i >= j - offset, so the first q tile
  // that sees any key of this block starts at row k0 - offset. Rows
  // with no visible key at all (i < -offset, only when tq > tk) see
  // every key with P = 1/tk: then every tile is visited.
  const int offset = tk - tq;
  const int n_tiles = (tq + BLOCK_M - 1) / BLOCK_M;
  int t0 = 0;
  if (causal && offset >= 0) t0 = max(0, k0 - offset) / BLOCK_M;

  if (tid == 0) {
    mbar_init(&bar.kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bar.full[s], 1);
      mbar_init(&bar.empty[s], 2 * 128);  // every consumer thread
      mbar_init(&bar.p_full[s], 128);     // warpgroup 1's threads
      mbar_init(&bar.p_empty[s], 128);    // warpgroup 2's threads
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_expect_tx(&bar.kv_full, 2 * TILE_BYTES);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_3d(ks + c * BLOCK_N * 64, &tm_k, &bar.kv_full, c * 64, k0,
                    bh);
        tma_load_3d(vs + c * BLOCK_N * 64, &tm_v, &bar.kv_full, c * 64, k0,
                    bh);
      }
      for (int t = t0; t < n_tiles; ++t) {
        const int i = t - t0, st = i % STAGES, n = i / STAGES;
        mbar_wait(&bar.empty[st], (n & 1) ^ 1);
        T* qt = qs + st * BLOCK_M * D;
        T* dot = dos + st * BLOCK_M * D;
        mbar_expect_tx(&bar.full[st], 2 * TILE_BYTES);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_3d(qt + c * BLOCK_M * 64, &tm_q, &bar.full[st], c * 64,
                      t * BLOCK_M, bh);
          tma_load_3d(dot + c * BLOCK_M * 64, &tm_do, &bar.full[st], c * 64,
                      t * BLOCK_M, bh);
        }
      }
    }
    return;
  }

  // ---- consumers: both hold the block's 64 keys x 64 q rows of a tile
  // in the same accumulator layout (keys are rows) ----
  setmaxnreg_inc<240>();
  const int cw = wg - 1;  // 0: P^T and dV, 1: dP^T, dS^T and dK
  const int ct = tid - 128 * wg;
  const int warp = ct >> 5, lane = ct & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int key_a = k0 + 16 * warp + g;  // this lane's keys: key_a, + 8
  const float p_masked_row = 1.f / (float)tk;
  const float* rowv = (cw == 0 ? lse : delta) + (long long)bh * tq;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  mbar_wait(&bar.kv_full, 0);
  for (int t = t0; t < n_tiles; ++t) {
    const int it = t - t0, st = it % STAGES;
    const uint32_t par = (it / STAGES) & 1;
    const int q0 = t * BLOCK_M;
    const T* qt = qs + st * BLOCK_M * D;
    const T* dot = dos + st * BLOCK_M * D;
    float* pb = pbuf + st * 32 * 128 + ct;
    const bool edge = q0 + BLOCK_M > tq || k0 + BLOCK_N > tk ||
                      (causal && q0 + offset < k0 + BLOCK_N - 1);
    // lse (warpgroup 1) or delta (warpgroup 2) of this lane's q rows
    // (columns 8 j + 2 tg, + 1 of the tile)
    float rv[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + 8 * j + 2 * tg + h;
        rv[2 * j + h] = row < tq ? rowv[row] : 0.f;
      }
    }
    mbar_wait(&bar.full[st], par);
    float s[32];
    // S^T = K Q^T (warpgroup 1) or dP^T = V dO^T (warpgroup 2)
    const T* a_tile = cw == 0 ? ks : vs;
    const T* b_tile = cw == 0 ? qt : dot;
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        W::ss64(s, desc_k_major(a_tile + c * BLOCK_N * 64 + kk * 16),
                desc_k_major(b_tile + c * BLOCK_M * 64 + kk * 16),
                (c | kk) != 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) reg_fence(s[i]);

    // x[i]: P^T (warpgroup 1) or dS^T (warpgroup 2), float32
    float x[32];
    if (cw == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int j = i >> 2, e = i & 3;
        float p = __expf(s[i] * scale - rv[2 * j + (e & 1)]);
        if (edge) {
          const int row = q0 + 8 * j + 2 * tg + (e & 1);
          const int key = key_a + (e >> 1) * 8;
          if (key >= tk || row >= tq)
            p = 0.f;
          else if (causal && row + offset < 0)
            p = p_masked_row;  // fully masked row
          else if (causal && row + offset < key)
            p = 0.f;
        }
        x[i] = p;
      }
      mbar_wait(&bar.p_empty[st], par ^ 1);
#pragma unroll
      for (int i = 0; i < 32; ++i) pb[i * 128] = x[i];
      mbar_arrive(&bar.p_full[st]);
    } else {
      mbar_wait(&bar.p_full[st], par);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int j = i >> 2, e = i & 3;
        const int row = q0 + 8 * j + 2 * tg + (e & 1);
        // 0 wherever P^T is 0 and on fully masked rows
        const bool lost = edge && causal && row + offset < 0;
        x[i] = lost ? 0.f : pb[i * 128] * (s[i] - rv[2 * j + (e & 1)]) * scale;
      }
      mbar_arrive(&bar.p_empty[st]);
    }
    // x as the A operand of dV += P^T dO or dK += dS^T Q, hi and lo
    // halves: k-step kk (16 q rows) takes accumulator blocks 2 kk, 2 kk + 1
    uint32_t xh[4][4], xl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* xj = x + 4 * (2 * kk + h);
        split_pack<T>(xj[0], xj[1], xh[kk][2 * h], xl[kk][2 * h]);
        split_pack<T>(xj[2], xj[3], xh[kk][2 * h + 1], xl[kk][2 * h + 1]);
      }
    }
    const T* rhs = cw == 0 ? dot : qt;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db =
          desc_mn_major(rhs + kk * 16 * 64, BLOCK_M * 64 * sizeof(T));
      W::rs256(acc, xh[kk], db);
      W::rs256(acc, xl[kk], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 128; ++i) reg_fence(acc[i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        reg_fence(xh[kk][r]);
        reg_fence(xl[kk][r]);
      }
    }
    mbar_arrive(&bar.empty[st]);  // this thread is done with stage st
  }

  // stage dV in the k tile (warpgroup 1) or dK in the v tile
  // (warpgroup 2), each read only by its own warpgroup, then store 16
  // bytes a lane
  named_sync(1 + cw, 128);
  T* os = cw == 0 ? ks : vs;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = 8 * j + 2 * tg;
    const int r0 = 16 * warp + g;
    *reinterpret_cast<uint32_t*>(os + swz<BLOCK_N>(r0, col)) =
        W::pack(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(os + swz<BLOCK_N>(r0 + 8, col)) =
        W::pack(acc[4 * j + 2], acc[4 * j + 3]);
  }
  named_sync(1 + cw, 128);
  T* ob = (cw == 0 ? dv : dk) + ((long long)bh * tk + k0) * D;
#pragma unroll 4
  for (int i = ct; i < BLOCK_N * (D / 8); i += 128) {
    const int r = i / (D / 8), ch = i % (D / 8);
    if (k0 + r < tk)
      *reinterpret_cast<uint4*>(ob + (long long)r * D + ch * 8) =
          *reinterpret_cast<const uint4*>(os + swz<BLOCK_N>(r, ch * 8));
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dk, *dv;
  int bh, tq, tk;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T>
int launch(const Args& a) {
  CUtensorMap mq, mk, mv, mdo;
  int err = make_map<T>(&mq, a.q, a.bh, a.tq, BLOCK_M);
  if (!err) err = make_map<T>(&mdo, a.dout, a.bh, a.tq, BLOCK_M);
  if (!err) err = make_map<T>(&mk, a.k, a.bh, a.tk, BLOCK_N);
  if (!err) err = make_map<T>(&mv, a.v, a.bh, a.tk, BLOCK_N);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_d256_wgmma_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  return for_bh_chunks(a.bh, [&](int b0, int n) {
    const dim3 grid((a.tk + BLOCK_N - 1) / BLOCK_N, n);
    flash_bwd_dkv_d256_wgmma_kernel<T><<<grid, THREADS, SMEM_BYTES,
                                         a.stream>>>(
        mq, mk, mv, mdo, a.lse, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), b0, a.tq, a.tk, a.scale, a.causal);
  });
}

}  // namespace

// dtype: 1 bfloat16, 2 float16; d: 256. q, dout: [bh, tq, 256]; k, v,
// dk, dv: [bh, tk, 256]; lse, delta: [bh, tq] float32. All contiguous,
// the 16-bit tensors 16-byte aligned, on the current device. Returns the
// CUDA error code of the launch (0 = ok).
extern "C" int flash_bwd_dkv_d256_wgmma(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const float* lse, const float* delta,
                                        void* dk, void* dv, int bh, int tq,
                                        int tk, int d, int dtype, float scale,
                                        int causal, void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || d != D)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
               scale, causal, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 1: return launch<__nv_bfloat16>(a);
    case 2: return launch<__half>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
