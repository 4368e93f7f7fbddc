// Flash-attention backward dK/dV at head dim 128 on Hopper's warpgroup
// tensor cores (sm_90a: wgmma, TMA, warp specialisation), bf16 and fp16,
// plain C interface. Head dim 64 and the sliced head dims past 256 run
// flash_bwd_dkv_mma.cu, head dim 256 flash_bwd_dkv_d256_wgmma.cu;
// float32 runs flash_bwd_dkv_f32_d128_wgmma.cu at this head dim; dQ (K2)
// is flash_bwd_dq_d128_wgmma.cu's.
//
// Replaces paddle_tpu/ops/pallas_attention.py:189 _fa_bwd_dkv_kernel
// (with _recompute_ds, :161; the second pallas_call of
// _flash_bwd_pallas, :290) at D = 128. Per (batch*head) slice of q, do
// [tq, 128] and k, v [tk, 128] it computes
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
// What bounds it on the H100: at the Llama training shape (B*H = 2*32,
// T = 2048, D = 128, causal) it does 137.5 GFLOP of useful products
// (8 D FLOP per visible pair: K Q^T, V dO^T, P^T dO, dS^T Q) against
// 202 MB moved: the bf16 tensor-core rate, 0.139 ms.
//
// Design (FlashAttention-3's split of the keys):
// - one block of three warpgroups per (bh, 128-key tile). Warpgroup 0 is
//   the producer (setmaxnreg down to 24 registers): one thread issues
//   every TMA load, and its second warp copies each q tile's lse and
//   delta into shared memory. Consumer warpgroups 1 and 2 own 64 keys
//   each and accumulate both dK and dV of them (64 x 128 float32 each:
//   128 accumulator registers a thread, at 240 registers), so no
//   operand crosses between the consumers and no atomics are needed:
//   the results are deterministic.
// - TMA (3-D tensor maps over [bh, t, 128], 128-byte swizzle, rows past
//   t zero-filled) brings the k and v tiles once (resident, 2 x 32 KB)
//   and the 64-row q and dO tiles through a three-stage ring (3 x 32
//   KB), on full / empty mbarriers.
// - a consumer takes S^T = K Q^T for its 64 keys and a q tile (8 wgmma
//   m64n64k16, both operands from shared memory) and forms P^T (float32,
//   with the masks) in hi + lo halves; then dP^T = V dO^T the same way
//   and dS^T from it and P^T taken back from its halves (S^T and dP^T
//   are never live together beside the 128 accumulators); then issues
//   dV += P^T dO and dK += dS^T Q as wgmma m64n128k16 with P^T and dS^T
//   in registers and dO and Q read MN-major. P^T and dS^T enter the
//   products as hi +
//   lo 16-bit halves: one bf16 rounding of each costs dV and dK 2.8x and
//   3.2x the 16-bit check tier at the training shape
//   (flash_bwd_dkv_mma.cu).
// - ptxas (CUDA 12.9): 168 registers at launch, which setmaxnreg
//   divides (24 x 128 + 240 x 256 = 168 x 384), no spill (it spilled
//   while S^T and dP^T were live together).
// - shared memory: k, v 64 KB; q, dO 96 KB; lse, delta 1.5 KB; 162 KB
//   and the barriers, of the 227 KB.
// - the q loop starts at the first tile that sees the block's keys
//   (max(0, k0 - offset) / 64) unless fully masked rows exist; a
//   consumer whose keys are all right of a tile's rows, or all past tk,
//   skips that tile's math; the mask runs only on tiles the diagonal or
//   a ragged end crosses.
// - dV is staged in the consumer's own rows of the v tile, dK in its own
//   rows of the k tile (read by no one else), swizzled, then stored 16
//   bytes a lane.
//
// What it leaves: ping-pong of the consumers on named barriers (they
// run the same work on their own keys and meet only at the ring's
// stages); fusing dQ (K2) into this pass, which would need atomics;
// reading GQA KV heads in place instead of after repeat_interleave.

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

#include <math.h>

namespace {

using namespace wgmma_sm90;
using mma_sm90::for_bh_chunks;

constexpr int D = 128;
constexpr int BLOCK_N = 128;  // keys per block: 2 consumer warpgroups x 64
constexpr int BLOCK_M = 64;   // q rows per tile
constexpr int STAGES = 3;
constexpr int THREADS = 3 * 128;

// shared memory, in bytes from a 1024-byte-aligned base
constexpr int KV_BYTES = BLOCK_N * D * 2;                 // 32 KB
constexpr int TILE_BYTES = BLOCK_M * D * 2;               // 16 KB
constexpr int OFF_V = KV_BYTES;
constexpr int OFF_Q = 2 * KV_BYTES;
constexpr int OFF_DO = OFF_Q + STAGES * TILE_BYTES;
constexpr int OFF_ROWS = OFF_DO + STAGES * TILE_BYTES;    // lse, delta
constexpr int ROWS_BYTES = 2 * BLOCK_M * 4;               // 512 B a stage
constexpr int OFF_BAR = OFF_ROWS + STAGES * ROWS_BYTES;   // 161.5 KB
constexpr int SMEM_BYTES = OFF_BAR + 128 + 1024;          // + barriers, alignment

struct Bars {
  uint64_t kv_full;
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_d128_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
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
  float* rows_s = reinterpret_cast<float*>(base + OFF_ROWS);
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
      mbar_init(&bar.full[s], 1 + 32);    // the TMA thread + the row warp
      mbar_init(&bar.empty[s], 2 * 128);  // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: thread 0 issues TMA, warp 1 copies lse and delta ----
    setmaxnreg_dec<24>();
    const int warp = tid >> 5, lane = tid & 31;
    if (tid == 0) {
      mbar_expect_tx(&bar.kv_full, 2 * KV_BYTES);
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
    } else if (warp == 1) {
      const float* lse_b = lse + (long long)bh * tq;
      const float* delta_b = delta + (long long)bh * tq;
      for (int t = t0; t < n_tiles; ++t) {
        const int i = t - t0, st = i % STAGES, n = i / STAGES;
        mbar_wait(&bar.empty[st], (n & 1) ^ 1);
        float* rs = rows_s + st * 2 * BLOCK_M;  // lse [64], delta [64]
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = lane + 32 * h, row = t * BLOCK_M + r;
          rs[r] = row < tq ? lse_b[row] : 0.f;
          rs[BLOCK_M + r] = row < tq ? delta_b[row] : 0.f;
        }
        mbar_arrive(&bar.full[st]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns keys k0 + 64 cw .. + 63, the rows
  // of its accumulators ----
  setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int ct = tid - 128 * wg;
  const int warp = ct >> 5, lane = ct & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int kw0 = k0 + 64 * cw;          // the warpgroup's first key
  const int key_a = kw0 + 16 * warp + g;  // this lane's keys: key_a, + 8
  const float p_masked_row = 1.f / (float)tk;
  const T* kw = ks + 64 * cw * 64;       // its keys' rows, column block 0
  const T* vw = vs + 64 * cw * 64;
  float acc_v[64], acc_k[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_v[i] = acc_k[i] = 0.f;

  mbar_wait(&bar.kv_full, 0);
  for (int t = t0; t < n_tiles; ++t) {
    const int it = t - t0, st = it % STAGES;
    const uint32_t par = (it / STAGES) & 1;
    const int q0 = t * BLOCK_M;
    const T* qt = qs + st * BLOCK_M * D;
    const T* dot = dos + st * BLOCK_M * D;
    const float* lse_s = rows_s + st * 2 * BLOCK_M;
    const float* delta_s = lse_s + BLOCK_M;
    // every key past tk, or every key right of the tile's last row with
    // no fully masked row in the tile: nothing to add to these keys
    const bool skip = kw0 >= tk || (causal && q0 + offset >= 0 &&
                                    q0 + BLOCK_M - 1 + offset < kw0);
    const bool edge = q0 + BLOCK_M > tq || kw0 + 64 > tk ||
                      (causal && q0 + offset < kw0 + 63);
    mbar_wait(&bar.full[st], par);
    if (!skip) {
      // S^T = K Q^T, keys as rows, q rows as columns
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          W::ss64(s, desc_k_major(kw + c * BLOCK_N * 64 + kk * 16),
                  desc_k_major(qt + c * BLOCK_M * 64 + kk * 16),
                  (c | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(s[i]);
      // P^T (float32, with the masks); the lane's q columns are 8 j +
      // 2 tg, + 1 of the tile
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int j = i >> 2, e = i & 3;
        const int col = 8 * j + 2 * tg + (e & 1);
        float p = __expf(s[i] * scale - lse_s[col]);
        if (edge) {
          const int row = q0 + col;
          const int key = key_a + (e >> 1) * 8;
          if (key >= tk || row >= tq)
            p = 0.f;
          else if (causal && row + offset < 0)
            p = p_masked_row;  // fully masked row
          else if (causal && row + offset < key)
            p = 0.f;
        }
        s[i] = p;
      }
      // P^T as the A operand of dV += P^T dO, hi and lo halves: k-step kk
      // (16 q rows) takes accumulator blocks 2 kk, 2 kk + 1. P^T lives on
      // in these halves alone (hi + lo is P^T to ~2^-17), so that S^T and
      // dP^T are never live together beside the 128 accumulators
      uint32_t xh[4][4], xl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* xj = s + 4 * (2 * kk + h);
          split_pack<T>(xj[0], xj[1], xh[kk][2 * h], xl[kk][2 * h]);
          split_pack<T>(xj[2], xj[3], xh[kk][2 * h + 1], xl[kk][2 * h + 1]);
        }
      }
      // dP^T = V dO^T
      float dp[32];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          W::ss64(dp, desc_k_major(vw + c * BLOCK_N * 64 + kk * 16),
                  desc_k_major(dot + c * BLOCK_M * 64 + kk * 16),
                  (c | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(dp[i]);
      // dS^T = P^T o (dP^T - delta) * scale, 0 wherever P^T is 0 and on
      // fully masked rows, as the A operand of dK += dS^T Q in hi and lo
      // halves
      uint32_t yh[4][4], yl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float y[4];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float2 ph = W::unpack(xh[kk][2 * h + u]);
            const float2 pl = W::unpack(xl[kk][2 * h + u]);
            const float pv[2] = {ph.x + pl.x, ph.y + pl.y};
#pragma unroll
            for (int e1 = 0; e1 < 2; ++e1) {
              const int i = 4 * (2 * kk + h) + 2 * u + e1;
              const int col = 8 * (2 * kk + h) + 2 * tg + e1;
              const bool lost = edge && causal && q0 + col + offset < 0;
              y[2 * u + e1] =
                  lost ? 0.f : pv[e1] * (dp[i] - delta_s[col]) * scale;
            }
          }
          split_pack<T>(y[0], y[1], yh[kk][2 * h], yl[kk][2 * h]);
          split_pack<T>(y[2], y[3], yh[kk][2 * h + 1], yl[kk][2 * h + 1]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db =
            desc_mn_major(dot + kk * 16 * 64, BLOCK_M * 64 * sizeof(T));
        W::rs128(acc_v, xh[kk], db);
        W::rs128(acc_v, xl[kk], db);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db =
            desc_mn_major(qt + kk * 16 * 64, BLOCK_M * 64 * sizeof(T));
        W::rs128(acc_k, yh[kk], db);
        W::rs128(acc_k, yl[kk], db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      // the registers the products read and wrote are settled only now
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        reg_fence(acc_v[i]);
        reg_fence(acc_k[i]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          reg_fence(xh[kk][r]);
          reg_fence(xl[kk][r]);
          reg_fence(yh[kk][r]);
          reg_fence(yl[kk][r]);
        }
      }
    }
    mbar_arrive(&bar.empty[st]);  // this thread is done with stage st
  }

  // stage dV in the warpgroup's own rows of the v tile and dK in its own
  // rows of the k tile (its last wgmma has read them; the other consumer
  // reads only its own), then store 16 bytes a lane
  named_sync(1 + cw, 128);
  T* sv = vs + 64 * cw * 64;
  T* sk = ks + 64 * cw * 64;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * tg;
    const int r0 = 16 * warp + g;
    *reinterpret_cast<uint32_t*>(sv + swz<BLOCK_N>(r0, col)) =
        W::pack(acc_v[4 * j], acc_v[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(sv + swz<BLOCK_N>(r0 + 8, col)) =
        W::pack(acc_v[4 * j + 2], acc_v[4 * j + 3]);
    *reinterpret_cast<uint32_t*>(sk + swz<BLOCK_N>(r0, col)) =
        W::pack(acc_k[4 * j], acc_k[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(sk + swz<BLOCK_N>(r0 + 8, col)) =
        W::pack(acc_k[4 * j + 2], acc_k[4 * j + 3]);
  }
  named_sync(1 + cw, 128);
  const long long out0 = ((long long)bh * tk + kw0) * D;
#pragma unroll 4
  for (int i = ct; i < 64 * (D / 8); i += 128) {
    const int r = i / (D / 8), ch = i % (D / 8);
    if (kw0 + r < tk) {
      const int o = swz<BLOCK_N>(r, ch * 8);
      *reinterpret_cast<uint4*>(dv + out0 + (long long)r * D + ch * 8) =
          *reinterpret_cast<const uint4*>(sv + o);
      *reinterpret_cast<uint4*>(dk + out0 + (long long)r * D + ch * 8) =
          *reinterpret_cast<const uint4*>(sk + o);
    }
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
  int err = make_map<T, D>(&mq, a.q, a.bh, a.tq, BLOCK_M);
  if (!err) err = make_map<T, D>(&mdo, a.dout, a.bh, a.tq, BLOCK_M);
  if (!err) err = make_map<T, D>(&mk, a.k, a.bh, a.tk, BLOCK_N);
  if (!err) err = make_map<T, D>(&mv, a.v, a.bh, a.tk, BLOCK_N);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_d128_wgmma_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  return for_bh_chunks(a.bh, [&](int b0, int n) {
    const dim3 grid((a.tk + BLOCK_N - 1) / BLOCK_N, n);
    flash_bwd_dkv_d128_wgmma_kernel<T><<<grid, THREADS, SMEM_BYTES,
                                         a.stream>>>(
        mq, mk, mv, mdo, a.lse, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), b0, a.tq, a.tk, a.scale, a.causal);
  });
}

}  // namespace

// dtype: 1 bfloat16, 2 float16; d: 128. q, dout: [bh, tq, 128]; k, v,
// dk, dv: [bh, tk, 128]; lse, delta: [bh, tq] float32. All contiguous,
// the 16-bit tensors 16-byte aligned, on the current device. Returns the
// CUDA error code of the launch (0 = ok).
extern "C" int flash_bwd_dkv_d128_wgmma(const void* q, const void* k,
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
