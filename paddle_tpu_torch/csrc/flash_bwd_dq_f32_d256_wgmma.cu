// Flash-attention backward dQ for float32 at head dim 256 on Hopper's
// warpgroup tensor cores (sm_90a: wgmma, TMA, a producer warpgroup that
// splits), plain C interface. Other head dims run flash_bwd_dq_f32mma.cu;
// bf16 and fp16 run flash_bwd_dq_mma.cu and flash_bwd_dq_d256_wgmma.cu.
//
// Replaces paddle_tpu/ops/pallas_attention.py:223 _fa_bwd_dq_kernel
// (with _recompute_ds, :161; the first pallas_call of _flash_bwd_pallas,
// :273) on the float32 route at D = 256. Per (batch*head) slice of q, do
// [tq, 256] and k, v [tk, 256] it computes
//   P  = exp(S - lse), S = (Q K^T) * scale   (lse from the forward, K1)
//   dS = P o (dO V^T - delta) * scale         (delta per q row, from the
//                                              caller: rowsum(dO o O) - dlse)
//   dQ = sum_k dS K                           (float32)
// with jax.vjp of _ref_attention_lse's semantics: causal masking is
// bottom-right (key j visible to row i iff j <= i + tk - tq), masked
// entries and keys >= tk have dS = 0, a fully masked row (causal,
// tq > tk) has dS = 0 on every key and so dQ = 0, rows >= tq are never
// written.
//
// Precision: the float32 tier (rtol 2e-4 / atol 2e-5) is beyond one
// rounding of the operands to bf16 or TF32, so every product takes its
// operands in bf16 pieces (tests/test_torch_f32_split.py emulates the
// scheme at D = 256: dQ <= 0.33 of the tier's limit, dK <= 0.23, dV
// <= 0.15 on every case and seed, where one rounding misses it):
//   S  = Q K^T: 3 products of hi + lo halves (hi hi, hi lo, lo hi);
//   dP = dO V^T: dO in three pieces (hi, mid, lo) and V in two, five
//        products (dropping what is below ~2^-24 of the product). dP
//        cancels in dP - delta: a two-piece dO leaves dQ at 0.61 of the
//        limit at D = 256 (0.71 at D = 128), past the 0.5 kept for the
//        tensor cores' own accumulation order;
//   dQ = dS K: 3 products of halves, dS's from registers.
// The D = 128 kernel takes dP as 3xTF32; at D = 256 that needs dO's
// float32 tile and its TF32 remainder resident (128 KB a 64-row block)
// beside q's halves (64 KB), and each 16-key v tile's two (32 KB) beside
// k's halves: 240 KB of the 227. The three bf16 pieces of dO take 96 KB.
//
// What bounds it on the H100: at the head_dim_256 float32 train step's
// shape (B*H = 1*16, T = 256, D = 256, causal) it moves 21.0 MB (q, k, v,
// dO, lse, delta in; dQ out), 0.0063 ms at 3.35 TB/s, against 0.81
// GFLOP of useful products (6 D FLOP per visible pair: Q K^T, dO V^T,
// dS K) at their splits' rates (three, five and three bf16 products:
// 0.0030 ms). Memory bounds it. That shape has 64 blocks of 64 rows,
// under one wave of the 132 SMs: the time is one block's walk over its
// key tiles. At B*H = 4, T = 2048 the operations bound it.
//
// Design (flash_bwd_dq_d256_wgmma.cu's loop, flash_fwd_f32_d256_wgmma.cu's
// producer that splits):
// - one block of two warpgroups per (bh, 64-row q tile), heaviest tile
//   first. Warpgroup 1 is the consumer, the block's 64 rows. Warpgroup 0
//   is the producer: lane 0 of its warp 0 issues every TMA load, its
//   warps 1-3 split what lands. Two warpgroups fit the register file at
//   the launch's count, so no setmaxnreg moves registers between them.
// - TMA (3-D float32 tensor maps over [bh, t, 256], unswizzled boxes of
//   all 256 columns, rows past t zero-filled) brings q's and dO's
//   float32 tiles once (q's into dO's pieces' memory, dO's into the
//   ring's), which the splitters turn into resident q hi + lo and dO
//   hi + mid + lo tiles in wgmma's 128-byte-swizzled layout. Then each
//   16-key v and k tile lands as float32 in a slot of a four-slot ring
//   (v_t, k_t, v_t+1, k_t+1), and is split in place: each splitter
//   holds its share of the tile in registers until all have read
//   theirs, then writes the hi and lo halves over it. A slot has raw,
//   full and empty mbarriers; the splitters fence (fence.proxy.async)
//   before handing a slot to wgmma, which reads through the async proxy.
// - shared memory: q 64 KB, dO 96 KB, ring 4 x 16 KB: 224 KB
//   of the 227 KB. That is why a block has 64 rows (two consumers would
//   need 320 KB of resident pieces) and tiles have 16 keys (32-key slots
//   leave room for two: k_t and v_t, and no tile ahead).
// - S = Q K^T and dP = dO V^T run once a tile over the whole 256-wide
//   head: 48 + 80 wgmma m64n16k16, both operands from shared memory. No
//   slice recomputes them (the sliced D = 128 route took both twice,
//   each slice's q, dO, k and v split afresh from global memory).
// - dS = P o (dP - delta) scale is formed in dP's registers (P in base
//   2 from lse), split into hi and lo halves as the A operand of
//   dQ += dS K, wgmma m64n256k16 with k's halves read MN-major: 3
//   products. dQ (64 x 256 float32, 128 registers a thread) stays in
//   the consumer's registers for the whole key loop; no atomics.
// - registers: ptxas (CUDA 12.9): 170 a thread, no spill.
// - causal: k tiles wholly right of the block's last row are not
//   visited (a block of fully masked rows visits none and writes
//   zeros); the mask runs only on tiles the diagonal or the ragged end
//   crosses. dQ goes from the accumulators to global memory as float2
//   pairs.
//
// What it leaves: overlapping one tile's products with the next (two
// consumers taking alternate key tiles need a deeper ring than fits;
// leaving a tile's dQ += dS K in flight while the next tile's S and dP
// are issued makes ptxas serialize every wgmma, its warning C7515);
// splitting k and v once a head instead of once a block; reading GQA KV
// heads in place.

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

#include <math.h>

namespace {

using namespace wgmma_sm90;
using mma_sm90::for_bh_chunks;
using bf16 = __nv_bfloat16;

constexpr int D = 256;
constexpr int BLOCK_M = 64;   // q rows per block: one consumer warpgroup
constexpr int BLOCK_N = 16;   // keys per k or v tile
constexpr int SLOTS = 4;      // ring of k / v tiles: v_t, k_t in turn
constexpr int THREADS = 2 * 128;
constexpr int SPLITTERS = 96;  // the producer's warps 1-3
constexpr float LOG2E = 1.4426950408889634f;

// shared memory, in bytes from a 1024-byte-aligned base
constexpr int QP_BYTES = BLOCK_M * D * 2;          // 32 KB a q or dO piece
constexpr int OFF_DO = 2 * QP_BYTES;               // q hi, lo; dO hi, mid, lo
constexpr int OFF_RING = OFF_DO + 3 * QP_BYTES;    // 160 KB
constexpr int SLOT_BYTES = BLOCK_N * D * 4;        // 16 KB: float32, or hi + lo
constexpr int OFF_BAR = OFF_RING + SLOTS * SLOT_BYTES;  // 224 KB
constexpr int SMEM_BYTES = OFF_BAR + 256 + 1024;   // + barriers, alignment

static_assert(BLOCK_M * D * 4 <= 3 * QP_BYTES, "q's float32 tile fits dO's");
static_assert(BLOCK_M * D * 4 <= SLOTS * SLOT_BYTES, "dO's fits the ring");
static_assert(SLOTS % 2 == 0, "v tiles in even slots, k tiles in odd");

struct Bars {
  uint64_t q_raw, do_raw;   // q's / dO's float32 tile landed
  uint64_t qdo_full;        // q's and dO's pieces written
  uint64_t ring_free;       // dO's float32 tile read: the ring may refill
  uint64_t raw[SLOTS];      // a slot's float32 tile landed
  uint64_t full[SLOTS];     // its halves written
  uint64_t empty[SLOTS];    // the consumer is done with them
};

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_f32_d256_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                   const __grid_constant__ CUtensorMap tm_k,
                                   const __grid_constant__ CUtensorMap tm_v,
                                   const __grid_constant__ CUtensorMap tm_do,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta,
                                   float* __restrict__ dq, int b0, int tq,
                                   int tk, float scale, int causal) {
  using W = Wgmma<bf16>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* qh = reinterpret_cast<bf16*>(base);
  bf16* ql = qh + BLOCK_M * D;
  bf16* doh = reinterpret_cast<bf16*>(base + OFF_DO);
  bf16* dom = doh + BLOCK_M * D;
  bf16* dol = dom + BLOCK_M * D;
  unsigned char* ring = base + OFF_RING;
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
    mbar_init(&bar.q_raw, 1);
    mbar_init(&bar.do_raw, 1);
    mbar_init(&bar.qdo_full, 1);
    mbar_init(&bar.ring_free, 1);
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&bar.raw[s], 1);
      mbar_init(&bar.full[s], 1);
      mbar_init(&bar.empty[s], 128);  // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    if (tid < 32) {
      // ---- the issuer: q and dO, then v_t and k_t of each tile ----
      if (tid == 0) {
        mbar_expect_tx(&bar.q_raw, BLOCK_M * D * 4);
        tma_load_3d(base + OFF_DO, &tm_q, &bar.q_raw, 0, q0, bh);
        mbar_expect_tx(&bar.do_raw, BLOCK_M * D * 4);
        tma_load_3d(ring, &tm_do, &bar.do_raw, 0, q0, bh);
        mbar_wait(&bar.ring_free, 0);
        for (int j = 0; j < 2 * n_tiles; ++j) {
          const int slot = j % SLOTS, round = j / SLOTS;
          mbar_wait(&bar.empty[slot], (round & 1) ^ 1);
          mbar_expect_tx(&bar.raw[slot], SLOT_BYTES);
          tma_load_3d(ring + slot * SLOT_BYTES, (j & 1) ? &tm_k : &tm_v,
                      &bar.raw[slot], 0, (j >> 1) * BLOCK_N, bh);
        }
      }
      return;
    }
    // ---- the splitters ----
    const int st = tid - 32;
    mbar_wait(&bar.q_raw, 0);
    split_tile<BLOCK_M, 2, SPLITTERS>(
        qh, reinterpret_cast<const float*>(base + OFF_DO), st);
    named_sync(1, SPLITTERS);  // q's float32 tile read: dO's pieces go there
    mbar_wait(&bar.do_raw, 0);
    split_tile<BLOCK_M, 3, SPLITTERS>(
        doh, reinterpret_cast<const float*>(ring), st);
    // the pieces visible to wgmma, the ring's reads ordered before the
    // TMA that refills it
    fence_proxy_async();
    named_sync(1, SPLITTERS);
    if (st == 0) {
      mbar_arrive(&bar.qdo_full);
      mbar_arrive(&bar.ring_free);
    }
    for (int j = 0; j < 2 * n_tiles; ++j) {
      const int slot = j % SLOTS;
      mbar_wait(&bar.raw[slot], (j / SLOTS) & 1);
      split_tile_in_place<BLOCK_N, 2, SPLITTERS>(
          reinterpret_cast<float*>(ring + slot * SLOT_BYTES), st, 1);
      fence_proxy_async();
      named_sync(1, SPLITTERS);
      if (st == 0) mbar_arrive(&bar.full[slot]);
    }
    return;
  }

  // ---- the consumer: the block's 64 rows ----
  const int ct = tid - 128;               // thread within the warpgroup
  const int warp = ct >> 5, lane = ct & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int row_a = q0 + 16 * warp + g;   // this lane's rows: row_a, + 8
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
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  mbar_wait(&bar.qdo_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int jv = 2 * t, jk = 2 * t + 1;
    const int sv = jv % SLOTS, sk = jk % SLOTS;
    const int k0 = t * BLOCK_N;
    const bf16* vh = reinterpret_cast<const bf16*>(ring + sv * SLOT_BYTES);
    const bf16* vl = vh + BLOCK_N * D;
    const bf16* kh = reinterpret_cast<const bf16*>(ring + sk * SLOT_BYTES);
    const bf16* kl = kh + BLOCK_N * D;
    mbar_wait(&bar.full[sv], (jv / SLOTS) & 1);
    mbar_wait(&bar.full[sk], (jk / SLOTS) & 1);
    // S = Q K^T (lo hi + hi lo + hi hi) and dP = dO V^T (dO's three
    // pieces against V's two, the smallest products first), 64 rows x
    // 16 keys each, over D = 256
    float s[8], dp[8];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int qo = c * BLOCK_M * 64 + kk * 16;
        const int ko = c * BLOCK_N * 64 + kk * 16;
        W::ss16(s, desc_k_major(ql + qo), desc_k_major(kh + ko),
                (c | kk) != 0);
        W::ss16(s, desc_k_major(qh + qo), desc_k_major(kl + ko), 1);
        W::ss16(s, desc_k_major(qh + qo), desc_k_major(kh + ko), 1);
      }
    }
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int qo = c * BLOCK_M * 64 + kk * 16;
        const int vo = c * BLOCK_N * 64 + kk * 16;
        W::ss16(dp, desc_k_major(dol + qo), desc_k_major(vh + vo),
                (c | kk) != 0);
        W::ss16(dp, desc_k_major(dom + qo), desc_k_major(vl + vo), 1);
        W::ss16(dp, desc_k_major(doh + qo), desc_k_major(vl + vo), 1);
        W::ss16(dp, desc_k_major(dom + qo), desc_k_major(vh + vo), 1);
        W::ss16(dp, desc_k_major(doh + qo), desc_k_major(vh + vo), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      reg_fence(s[i]);
      reg_fence(dp[i]);
    }
    mbar_arrive(&bar.empty[sv]);  // this thread is done with v's slot
    // dS = P o (dP - delta) scale in place of dP, 0 where masked (keys
    // >= tk, right of the diagonal, every key of a fully masked row);
    // the mask only where the ragged end or the diagonal crosses
    const bool edge = k0 + BLOCK_N > tk ||
                      (causal && k0 + BLOCK_N - 1 > q0 + offset);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = i >> 2, e = i & 3, r = e >> 1;
      float x = exp2f(s[i] * scale2 - lse2[r]) * (dp[i] - dl[r]) * scale;
      if (edge) {
        const int col = k0 + 8 * j + 2 * tg + (e & 1);
        const int row = row_a + 8 * r;
        if (col >= tk || (causal && row + offset < col)) x = 0.f;
      }
      dp[i] = x;
    }
    // dS as the A operand of dQ += dS K (one k-step of 16 keys), hi and
    // lo halves
    uint32_t dh[4], dlo[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) split_pack<bf16>(dp[2 * h], dp[2 * h + 1],
                                                 dh[h], dlo[h]);
    const uint64_t dkh = desc_mn_major(kh, BLOCK_N * 64 * sizeof(bf16));
    const uint64_t dkl = desc_mn_major(kl, BLOCK_N * 64 * sizeof(bf16));
    wgmma_fence();
    W::rs256(acc, dlo, dkh);
    W::rs256(acc, dh, dkl);
    W::rs256(acc, dh, dkh);
    wgmma_commit();
    wgmma_wait<0>();
    // the registers the products read and wrote are settled only now
#pragma unroll
    for (int i = 0; i < 128; ++i) reg_fence(acc[i]);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      reg_fence(dh[h]);
      reg_fence(dlo[h]);
    }
    mbar_arrive(&bar.empty[sk]);  // this thread is done with k's slot
  }

  float* ob = dq + (long long)bh * tq * D;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = 8 * j + 2 * tg;
    if (row_a < tq)
      *reinterpret_cast<float2*>(ob + (long long)row_a * D + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (row_a + 8 < tq)
      *reinterpret_cast<float2*>(ob + (long long)(row_a + 8) * D + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
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

int launch(const Args& a) {
  CUtensorMap mq, mk, mv, mdo;
  int err = make_map_f32(&mq, a.q, a.bh, a.tq, BLOCK_M);
  if (!err) err = make_map_f32(&mdo, a.dout, a.bh, a.tq, BLOCK_M);
  if (!err) err = make_map_f32(&mk, a.k, a.bh, a.tk, BLOCK_N);
  if (!err) err = make_map_f32(&mv, a.v, a.bh, a.tk, BLOCK_N);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_f32_d256_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  return for_bh_chunks(a.bh, [&](int b0, int n) {
    const dim3 grid((a.tq + BLOCK_M - 1) / BLOCK_M, n);
    flash_bwd_dq_f32_d256_wgmma_kernel<<<grid, THREADS, SMEM_BYTES,
                                         a.stream>>>(
        mq, mk, mv, mdo, a.lse, a.delta, static_cast<float*>(a.dq), b0,
        a.tq, a.tk, a.scale, a.causal);
  });
}

}  // namespace

// dtype: 0 float32 (bf16 and fp16 are flash_bwd_dq_mma.cu's and
// flash_bwd_dq_d256_wgmma.cu's); d: 256. q, dout, dq: [bh, tq, 256]; k,
// v: [bh, tk, 256]; lse, delta: [bh, tq] float32. All contiguous,
// 16-byte aligned, on the current device. Returns the CUDA error code of
// the launch (0 = ok).
extern "C" int flash_bwd_dq_f32_d256_wgmma(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const float* lse,
                                           const float* delta, void* dq,
                                           int bh, int tq, int tk, int d,
                                           int dtype, float scale,
                                           int causal, void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || d != D || dtype != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, dq, bh, tq, tk,
               scale, causal, static_cast<cudaStream_t>(stream)};
  return launch(a);
}
