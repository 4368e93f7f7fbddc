// Flash-attention backward dQ at head dim 128 on Hopper's warpgroup
// tensor cores (sm_90a: wgmma, TMA, warp specialisation), bf16 and fp16,
// plain C interface. Head dim 64, the sliced head dims past 256 and
// float32 run flash_bwd_dq_mma.cu and flash_bwd_dq_f32mma.cu; head dim
// 256 runs flash_bwd_dq_d256_wgmma.cu.
//
// Replaces paddle_tpu/ops/pallas_attention.py:223 _fa_bwd_dq_kernel
// (with _recompute_ds, :161; the first pallas_call of _flash_bwd_pallas,
// :273) at D = 128. Per (batch*head) slice of q, do [tq, 128] and k, v
// [tk, 128] it computes
//   P  = exp(S - lse), S = (Q K^T) * scale   (lse from the forward, K1)
//   dS = P o (dO V^T - delta) * scale         (delta per q row, from the
//                                              caller: rowsum(dO o O) - dlse)
//   dQ = sum_k dS K                           (in q's dtype)
// with jax.vjp of _ref_attention_lse's semantics: causal masking is
// bottom-right (key j visible to row i iff j <= i + tk - tq), masked
// entries and keys >= tk have dS = 0, and a fully masked row (causal,
// tq > tk) has dS = 0 on every key, so its dQ is 0 -- recognised by
// index, as every one of its keys is masked. Rows >= tq are never
// written.
//
// What bounds it on the H100: at the Llama training shape (B*H = 2*32,
// T = 2048, D = 128, causal) it does 103.1 GFLOP of useful products
// (6 D FLOP per visible (row, key) pair: Q K^T, dO V^T, dS K) against
// 168 MB moved: the bf16 tensor-core rate, 0.104 ms. Taking dS as
// hi + lo halves (below) executes 8 D FLOP a pair.
//
// Design (flash_bwd_dq_d256_wgmma.cu's structure at half the head):
// - one block of three warpgroups per (bh, 128-row q tile), heaviest
//   tile first (under the causal mask the last q tiles see the most
//   keys). Warpgroup 0 is the producer: after setmaxnreg gives its
//   registers away (24 a thread), one thread issues every TMA load.
//   Warpgroups 1 and 2 are the consumers, 64 q rows each, at 240
//   registers a thread.
// - TMA (cp.async.bulk.tensor, 3-D tensor maps over [bh, t, 128] with
//   the 128-byte swizzle, rows past t zero-filled) brings the q and dO
//   tiles once, resident for the whole key loop (2 x 32 KB), and the k
//   and v tiles through a three-stage ring of 64 keys (32 KB a stage),
//   each stage completing on one "full" mbarrier; the consumers release
//   a stage on its "empty" mbarrier. Shared memory: 64 + 96 = 160 KB
//   of the 227 KB.
// - S = Q K^T and dP = dO V^T each run once a k tile over the whole
//   128-wide head: 8 wgmma m64n64k16 each, both operands read from
//   shared memory through descriptors.
// - dS = P o (dP - delta) scale is formed in float32 in dP's own
//   registers (P = 2^(S scale log2(e) - lse log2(e)) as one fma and
//   ex2.approx.ftz, whose error is far below the 16-bit tier's and
//   which skips exp2f's range handling; lse and delta of the lane's two
//   rows in registers), and goes straight into the
//   register A operand of dQ += dS K, wgmma m64n128k16 with K read
//   MN-major from its stage; it never touches shared memory. dS is
//   taken as hi + lo 16-bit halves (two products a k-step): one bf16
//   rounding of dS put dQ at 3.0x the 16-bit check tier
//   (flash_bwd_dq_mma.cu); split_check.py measures both at this head
//   dim.
// - registers: dQ (64 x 128 float32) 64 a thread, resident for the
//   whole key loop; S 32, dP 32, dS's halves 16 + 16. That is why a
//   stage holds 64 keys: at 128 keys S, dP and the halves take 128 more
//   and the consumer would spill past 240. The launch has 168 a thread
//   (24 x 128 + 240 x 256 = 168 x 384), so that setmaxnreg can hand
//   the producer's to the consumers; a mismatch leaves the consumers
//   waiting forever. ptxas (CUDA 12.9): 168 registers at launch, no
//   spill (chip_smoke.py logs the build's report).
// - every wgmma group is waited for on the path that issued it, inside
//   the branch that skips a tile's math: ptxas serializes every wgmma
//   of a kernel where a group issued in one branch is waited for in
//   another (C7518).
// - causal: k tiles wholly right of the block's last row are not
//   visited (a block of fully masked rows visits none and writes
//   zeros), a consumer skips the math of a tile wholly right of its own
//   64 rows, and the elementwise mask runs only on tiles the diagonal or
//   the ragged end crosses. lse and delta past tq are not read.
// - dQ is deterministic: no atomics (K2 is not fused into K3's pass). It
//   is staged in the consumer's own rows of the q tile (swizzled, no
//   bank conflicts) and stored 16 bytes a lane.
//
// What it leaves: overlapping one tile's elementwise work with the next
// tile's products (the consumers wait for each wgmma group; ping-pong
// on named barriers as flash_fwd_d128_wgmma.cu does); reading GQA KV
// heads in place instead of after repeat_interleave; caching the tensor
// maps across calls.

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

#include <math.h>

namespace {

using namespace wgmma_sm90;
using mma_sm90::for_bh_chunks;

constexpr int D = 128;
constexpr int BLOCK_M = 128;  // q rows per block: 2 consumer warpgroups x 64
constexpr int BLOCK_N = 64;   // keys per k/v stage
constexpr int STAGES = 3;
constexpr int THREADS = 3 * 128;
constexpr float LOG2E = 1.4426950408889634f;

// shared memory, in bytes from a 1024-byte-aligned base
constexpr int Q_BYTES = BLOCK_M * D * 2;             // 32 KB a q or dO tile
constexpr int KV_BYTES = BLOCK_N * D * 2;            // 16 KB a k or v stage
constexpr int OFF_DO = Q_BYTES;
constexpr int OFF_K = 2 * Q_BYTES;
constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;   // 160 KB
constexpr int SMEM_BYTES = OFF_BAR + 64 + 1024;      // + barriers, alignment

static_assert(BLOCK_N % 16 == 0, "whole k-steps of dQ += dS K");

struct Bars {
  uint64_t q_full;          // q and dO
  uint64_t full[STAGES];    // k and v of a stage
  uint64_t empty[STAGES];
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_d128_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               T* __restrict__ dq, int b0, int tq, int tk,
                               float scale, int causal) {
  using W = Wgmma<T>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T* qs = reinterpret_cast<T*>(base);
  T* dos = reinterpret_cast<T*>(base + OFF_DO);
  T* ks = reinterpret_cast<T*>(base + OFF_K);
  T* vs = reinterpret_cast<T*>(base + OFF_V);
  Bars& bar = *reinterpret_cast<Bars*>(base + OFF_BAR);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BLOCK_M;  // heaviest first
  const int bh = b0 + blockIdx.y;

  // causal: key j is visible to row i iff j <= i + offset. Keys past the
  // block's last row's limit have dS = 0 for every row of the block; a
  // block of fully masked rows (last row + offset < 0) visits no tile.
  const int offset = tk - tq;
  int n_tiles = (tk + BLOCK_N - 1) / BLOCK_N;
  if (causal) {
    const int last = min(q0 + BLOCK_M, tq) - 1 + offset;
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BLOCK_N + 1);
  }

  if (tid == 0) {
    mbar_init(&bar.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bar.full[s], 1);
      mbar_init(&bar.empty[s], 2 * 128);  // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_expect_tx(&bar.q_full, 2 * Q_BYTES);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_3d(qs + c * BLOCK_M * 64, &tm_q, &bar.q_full, c * 64, q0,
                    bh);
        tma_load_3d(dos + c * BLOCK_M * 64, &tm_do, &bar.q_full, c * 64, q0,
                    bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES, n = t / STAGES;
        mbar_wait(&bar.empty[st], (n & 1) ^ 1);
        T* kt = ks + st * BLOCK_N * D;
        T* vt = vs + st * BLOCK_N * D;
        mbar_expect_tx(&bar.full[st], 2 * KV_BYTES);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_3d(kt + c * BLOCK_N * 64, &tm_k, &bar.full[st], c * 64,
                      t * BLOCK_N, bh);
          tma_load_3d(vt + c * BLOCK_N * 64, &tm_v, &bar.full[st], c * 64,
                      t * BLOCK_N, bh);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns q rows q0 + 64 cw .. + 63 ----
  setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int ct = tid - 128 * wg;          // thread within the warpgroup
  const int warp = ct >> 5, lane = ct & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int w0 = q0 + 64 * cw;            // the warpgroup's first row
  const int row_a = w0 + 16 * warp + g;   // this lane's rows: row_a, + 8
  // the warpgroup's last row that exists; its limit bounds its keys
  const int w_last = min(w0 + 63, tq - 1);
  // P = 2^(S scale log2(e) - lse log2(e)); rows >= tq are never written,
  // so what they compute does not matter
  const float scale2 = scale * LOG2E;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    lse2[r] = row < tq ? lse[(long long)bh * tq + row] * LOG2E : 0.f;
    dl[r] = row < tq ? delta[(long long)bh * tq + row] : 0.f;
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const T* qw = qs + 64 * cw * 64;    // the warpgroup's rows of block 0
  const T* dow = dos + 64 * cw * 64;

  mbar_wait(&bar.q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    const uint32_t par = (t / STAGES) & 1;
    const int k0 = t * BLOCK_N;
    // no row of the warpgroup exists, or every key of the tile is right
    // of each of its rows (fully masked rows included): dS = 0 here
    const bool skip = w0 >= tq || (causal && k0 > w_last + offset);
    const T* kt = ks + st * BLOCK_N * D;
    const T* vt = vs + st * BLOCK_N * D;
    mbar_wait(&bar.full[st], par);
    if (!skip) {
      // S = Q K^T and dP = dO V^T, 64 rows x 64 keys each, over D = 128
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          W::ss64(s, desc_k_major(qw + c * BLOCK_M * 64 + kk * 16),
                  desc_k_major(kt + c * BLOCK_N * 64 + kk * 16),
                  (c | kk) != 0);
      }
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          W::ss64(dp, desc_k_major(dow + c * BLOCK_M * 64 + kk * 16),
                  desc_k_major(vt + c * BLOCK_N * 64 + kk * 16),
                  (c | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        reg_fence(s[i]);
        reg_fence(dp[i]);
      }
      // dS = P o (dP - delta) scale in place of dP, 0 where masked (keys
      // >= tk, right of the diagonal, every key of a fully masked row);
      // the mask only where the ragged end or the diagonal crosses
      const bool edge = k0 + BLOCK_N > tk ||
                        (causal && k0 + BLOCK_N - 1 > w0 + offset);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int j = i >> 2, e = i & 3, r = e >> 1;
        float x = ex2_ftz(fmaf(s[i], scale2, -lse2[r])) * (dp[i] - dl[r]) *
                  scale;
        if (edge) {
          const int col = k0 + 8 * j + 2 * tg + (e & 1);
          const int row = row_a + 8 * r;
          if (col >= tk || (causal && row + offset < col)) x = 0.f;
        }
        dp[i] = x;
      }
      // dS as the A operand of dQ += dS K, hi and lo halves: k-step kk
      // (16 keys) takes accumulator blocks 2 kk, 2 kk + 1
      uint32_t dh[BLOCK_N / 16][4], dlo[BLOCK_N / 16][4];
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* xj = dp + 4 * (2 * kk + h);
          split_pack<T>(xj[0], xj[1], dh[kk][2 * h], dlo[kk][2 * h]);
          split_pack<T>(xj[2], xj[3], dh[kk][2 * h + 1], dlo[kk][2 * h + 1]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
        const uint64_t dk =
            desc_mn_major(kt + kk * 16 * 64, BLOCK_N * 64 * sizeof(T));
        W::rs128(acc, dh[kk], dk);
        W::rs128(acc, dlo[kk], dk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      // the registers the products read and wrote are settled only now
#pragma unroll
      for (int i = 0; i < 64; ++i) reg_fence(acc[i]);
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          reg_fence(dh[kk][r]);
          reg_fence(dlo[kk][r]);
        }
      }
    }
    mbar_arrive(&bar.empty[st]);  // this thread is done with stage st
  }

  // stage dQ in the warpgroup's own rows of the q tile (its last wgmma
  // has read them), then store 16 bytes a lane
  named_sync(1 + cw, 128);
  T* ow = qs + 64 * cw * 64;  // row 0 of the warpgroup in column block 0
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * tg;
    const int r0 = 16 * warp + g;
    *reinterpret_cast<uint32_t*>(ow + swz<BLOCK_M>(r0, col)) =
        W::pack(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(ow + swz<BLOCK_M>(r0 + 8, col)) =
        W::pack(acc[4 * j + 2], acc[4 * j + 3]);
  }
  named_sync(1 + cw, 128);
  T* ob = dq + ((long long)bh * tq + w0) * D;
#pragma unroll 4
  for (int i = ct; i < 64 * (D / 8); i += 128) {
    const int r = i / (D / 8), ch = i % (D / 8);
    if (w0 + r < tq)
      *reinterpret_cast<uint4*>(ob + (long long)r * D + ch * 8) =
          *reinterpret_cast<const uint4*>(ow + swz<BLOCK_M>(r, ch * 8));
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void* dq;
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
      flash_bwd_dq_d128_wgmma_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  return for_bh_chunks(a.bh, [&](int b0, int n) {
    const dim3 grid((a.tq + BLOCK_M - 1) / BLOCK_M, n);
    flash_bwd_dq_d128_wgmma_kernel<T><<<grid, THREADS, SMEM_BYTES,
                                        a.stream>>>(
        mq, mk, mv, mdo, a.lse, a.delta, static_cast<T*>(a.dq), b0, a.tq,
        a.tk, a.scale, a.causal);
  });
}

}  // namespace

// dtype: 1 bfloat16, 2 float16; d: 128. q, dout, dq: [bh, tq, 128]; k,
// v: [bh, tk, 128]; lse, delta: [bh, tq] float32. All contiguous, the
// 16-bit tensors 16-byte aligned, on the current device. Returns the
// CUDA error code of the launch (0 = ok).
extern "C" int flash_bwd_dq_d128_wgmma(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       void* dq, int bh, int tq, int tk,
                                       int d, int dtype, float scale,
                                       int causal, void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || d != D)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, dq, bh, tq, tk,
               scale, causal, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 1: return launch<__nv_bfloat16>(a);
    case 2: return launch<__half>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
