// Flash-attention backward dK/dV for float32 at head dim 128 on Hopper's
// warpgroup tensor cores (sm_90a: wgmma, TMA, a producer warpgroup that
// splits), plain C interface. Head dim 64 runs
// flash_bwd_dkv_f32_d64_wgmma.cu, head dim 256
// flash_bwd_dkv_f32_d256_wgmma.cu, the head dims past 256
// flash_bwd_dkv_f32mma.cu in 128-column slices; bf16 and fp16 run
// flash_bwd_dkv_d128_wgmma.cu at this head dim; dQ (K2) is
// flash_bwd_dq_f32_d128_wgmma.cu's.
//
// Replaces paddle_tpu/ops/pallas_attention.py:189 _fa_bwd_dkv_kernel
// (with _recompute_ds, :161; the second pallas_call of
// _flash_bwd_pallas, :292) on the float32 route at D = 128, the head dim
// of the Llama width's float32 training-parity steps and float32
// pipeline stage. Per (batch*head) slice of q, do [tq, 128] and k, v
// [tk, 128] it computes
//   P  = exp(S - lse), S = (Q K^T) * scale   (lse from the forward, K1)
//   dS = P o (dO V^T - delta) * scale         (delta per q row, from the
//                                              caller: rowsum(dO o O) - dlse)
//   dV = sum_q P^T dO,   dK = sum_q dS^T Q    (float32)
// with jax.vjp of _ref_attention_lse's semantics: causal masking is
// bottom-right (key j visible to row i iff j <= i + tk - tq), masked
// entries have P = dS = 0, keys >= tk and rows >= tq take no part, and
// a fully masked row (causal, tq > tk) has P = 1/tk on every key and
// dS = 0 -- recognised by its index, since its float32 lse (-1e30)
// cannot give P back.
//
// Precision: the float32 warpgroup K3s' pieces (D = 64 and 256), which
// tests/test_torch_f32_split.py chose at D = 128 over the mma.sync
// kernel's 3xTF32 dP^T and dV: on every D = 128 case and seed (T 32 at
// B*H 512 among them) they keep dK <= 0.30 and dV <= 0.31 of the float32
// tier's limit, where P^T in two pieces (five products for dV) reaches
// 0.61 and one bf16 rounding 11-459x the limit. TF32 could serve dP^T
// (both operands K-major) but not dV (dO MN-major, and TF32 wgmma reads
// shared memory only K-major); its halves take 8 bytes an element:
//   S^T  = K Q^T: 3 products of hi + lo halves;
//   dP^T = V dO^T: dO in three pieces, V in two, five products;
//   dV  += P^T dO: P^T (registers) and dO both in three pieces, six
//          products, dO's pieces read MN-major;
//   dK  += dS^T Q: 3 products of halves, dS^T's from registers.
//
// What bounds it on the H100: at the training-parity shape (B*H 8,
// T 256, causal) it moves 6.3 MB (q, k, v, dO, lse, delta in; dK, dV
// out), 0.0019 ms at 3.35 TB/s, against 0.27 GFLOP of useful products
// (8 D FLOP per visible pair) at their pieces' rates (three, five, six
// and three bf16 products: 0.0012 ms): bytes, and 32 blocks on 132 SMs,
// so latency in fact. At the pipeline stage's float32 shape (B*H 32,
// T 512, causal) 50.5 MB, 0.0151 ms, against 0.0185 ms of products; at
// B*H 2*32, T 2048 (causal) 0.591 ms of products (0.626 ms at the
// mma.sync kernel's 3xTF32 rates) against 0.10 ms of bytes: operations
// bound both.
//
// Design (flash_bwd_dkv_f32_d64_wgmma.cu's warpgroups at D = 128):
// - one block of three warpgroups per (bh, 64-key tile). Warpgroup 0 is
//   the producer (setmaxnreg down to 136 registers): lane 0 of its warp
//   0 issues every TMA load, its warps 1-3 split what lands. Consumer
//   warpgroup 1 takes S^T, P^T and dV += P^T dO, warpgroup 2 dP^T, dS^T
//   and dK += dS^T Q: 64 keys x 128 float32 accumulators each (64
//   registers a thread), at 184 registers (136 x 128 + 184 x 256 = the
//   launch's 168 x 384). ptxas (CUDA 12.9): 168 registers at launch, 0
//   bytes of spill (chip_smoke.py logs the build's report).
// - what changes from D = 64 is room. k's and v's pieces take 64 KB,
//   and a stage of a q tile in two pieces and a dO tile in three 40 KB
//   at 32 rows, 80 KB at 64: D = 64's 64-row tiles in two stages would
//   take 256 KB. So a q tile has 32 rows, over a two-stage ring (the P^T
//   exchange 2 x 8 KB: 160 KB of the 227 KB). At 32 rows S^T and dP^T
//   are m64n32k16 (24 and 40 wgmma with both operands in shared
//   memory), dV and dK m64n128k16 over two k-steps of 16 rows (12 and 6
//   wgmma with the pieces of P^T and dS^T in registers). tile_sweep.py
//   timed the layouts that fit on an H100 80GB HBM3 at 700 W (bare
//   calls, cold L2; at the parity shape / B*H 32, T 512 / B*H 64,
//   T 2048, all causal): 32 rows in two stages 0.0314-0.0318 /
//   0.0898-0.0921 / 1.417-1.419 ms; in three stages (200 KB)
//   0.0311-0.0316 / 0.0906-0.0911 / 1.426 ms, no faster; 64 rows in one
//   stage (176 KB; no load overlaps a tile's products, and its
//   splitters hold 88 floats a thread) 0.0365-0.0370 / 0.1068-0.1069 /
//   1.718-1.748 ms at 152 / 176 registers, and at 136 / 184, where the
//   producer spills 260 bytes, 0.0391-0.0395 / 0.1167-0.1174 / 1.916-
//   1.918 ms; flash_bwd_dkv_f32mma.cu in the same turns 0.0395-0.0396 /
//   0.1762-0.1780 / 3.770-3.806 ms.
// - TMA (3-D float32 tensor maps over [bh, t, 128], unswizzled boxes,
//   rows past t zero-filled) brings k's float32 tile into v's pieces'
//   memory and v's into the ring's last stage, split once into resident
//   hi + lo tiles (the ring's first stages fill meanwhile, its last once
//   v's tile is read), then each q and dO tile as float32 into the ring.
//   Each stage's q slot and dO slot are split in place: every splitter
//   holds its share in registers until all have read theirs, then q's
//   hi and lo and dO's hi, mid and lo are written over the tile in
//   wgmma's 128-byte-swizzled layout (two 64-column blocks a piece),
//   behind fence.proxy.async.
// - S^T = K Q^T (warpgroup 1) and dP^T = V dO^T (warpgroup 2) run at
//   once; warpgroup 1 forms P^T (float32, with the masks) and hands it
//   to warpgroup 2 through a two-buffer exchange in shared memory (one
//   float a thread a register, its own mbarrier pair), then takes dV;
//   warpgroup 2 forms dS^T and takes dK. Each warpgroup waits for its
//   products on the branch that issued them (ptxas serializes every
//   wgmma otherwise, C7518).
// - the q loop starts at the first tile that sees the block's keys
//   (max(0, k0 - offset) / BLOCK_M) unless fully masked rows exist; the
//   mask runs only on tiles the diagonal or a ragged end crosses. lse
//   and delta are read by each consumer from global memory before the
//   tile's wait; P^T = 2^(S^T scale log2(e) - lse log2(e)) is one fma
//   and ex2.approx.ftz (relative error ~2^-22, far inside the tier).
// - dK and dV go from the accumulators to global memory as float2
//   pairs; no atomics. B*H past gridDim.y's limit is launched in
//   chunks.
//
// What it leaves: fusing dQ (K2) into this pass; blocks of 128 keys to
// halve the q and dO traffic (room allows it only at one stage); reading
// GQA KV heads in place.

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

#include <math.h>

namespace {

using namespace wgmma_sm90;
using mma_sm90::for_bh_chunks;
using bf16 = __nv_bfloat16;

constexpr int D = 128;
constexpr int BLOCK_N = 64;   // keys per block
constexpr int BLOCK_M = 32;   // q rows per tile
constexpr int STAGES = 2;     // ring stages of a q and a dO tile
constexpr int THREADS = 3 * 128;
constexpr int SPLITTERS = 96;  // the producer's warps 1-3
constexpr float LOG2E = 1.4426950408889634f;

// shared memory, in bytes from a 1024-byte-aligned base
constexpr int KP_BYTES = BLOCK_N * D * 2;         // 16 KB a k or v piece
constexpr int OFF_V = 2 * KP_BYTES;               // k hi, lo; v hi, lo
constexpr int OFF_RING = 4 * KP_BYTES;            // 64 KB
constexpr int QP_BYTES = BLOCK_M * D * 2;         // a q or dO piece
constexpr int Q_SLOT = 2 * QP_BYTES;              // float32, or hi + lo
constexpr int DO_SLOT = 3 * QP_BYTES;             // float32, or 3 pieces
constexpr int STAGE_BYTES = Q_SLOT + DO_SLOT;
constexpr int OFF_P = OFF_RING + STAGES * STAGE_BYTES;
constexpr int P_BYTES = BLOCK_N * BLOCK_M * 4;    // P^T of a tile, float32
constexpr int P_BUFS = 2;
constexpr int OFF_BAR = OFF_P + P_BUFS * P_BYTES;
constexpr int SMEM_BYTES = OFF_BAR + 256 + 1024;  // + barriers, alignment
constexpr int KV_F32_BYTES = BLOCK_N * D * 4;     // 32 KB: k's or v's tile
constexpr int PRODUCER_REGS = 136;  // setmaxnreg: the producer's
constexpr int CONSUMER_REGS = 184;  // and each consumer's

constexpr int NJ = BLOCK_M / 8;   // 8-column blocks of S^T's accumulator
constexpr int NS = BLOCK_M / 2;   // its floats a thread
constexpr int KS = BLOCK_M / 16;  // k-steps of dV and dK

static_assert(BLOCK_M == 32 || BLOCK_M == 64, "m64n32 or m64n64 tiles");
static_assert(KV_F32_BYTES == 2 * KP_BYTES, "k's float32 tile fits v's");
static_assert(KV_F32_BYTES <= STAGE_BYTES, "v's fits the ring's last stage");
static_assert(BLOCK_M * D * 4 <= Q_SLOT, "q's float32 tile fits its slot");
static_assert(SMEM_BYTES <= 232448, "a block's shared memory");
static_assert(PRODUCER_REGS + 2 * CONSUMER_REGS == 3 * 168,
              "setmaxnreg redistributes the launch's 168 registers");

struct Bars {
  uint64_t k_raw, v_raw;    // k's / v's float32 tile landed
  uint64_t kv_full;         // k's and v's halves written
  uint64_t ring_free;       // v's float32 tile read: its stage may fill
  uint64_t raw[STAGES];     // a stage's q and dO float32 tiles landed
  uint64_t full[STAGES];    // their pieces written
  uint64_t empty[STAGES];   // both consumers are done with them
  uint64_t p_full[P_BUFS];
  uint64_t p_empty[P_BUFS];
};
static_assert(sizeof(Bars) <= 256, "the barriers' room");

// d (+)= A B over a 64 x BLOCK_M accumulator (N = BLOCK_M / 2 floats a
// thread), both operands K-major in shared memory
template <int N>
__device__ __forceinline__ void ss_tile(float (&d)[N], uint64_t da,
                                        uint64_t db, int accumulate) {
  if constexpr (N == 16)
    Wgmma<bf16>::ss32(d, da, db, accumulate);
  else
    Wgmma<bf16>::ss64(d, da, db, accumulate);
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_f32_d128_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                    const __grid_constant__ CUtensorMap tm_k,
                                    const __grid_constant__ CUtensorMap tm_v,
                                    const __grid_constant__ CUtensorMap tm_do,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta,
                                    float* __restrict__ dk,
                                    float* __restrict__ dv, int b0, int tq,
                                    int tk, float scale, int causal) {
  using W = Wgmma<bf16>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* kh = reinterpret_cast<bf16*>(base);
  bf16* kl = kh + BLOCK_N * D;
  bf16* vh = reinterpret_cast<bf16*>(base + OFF_V);
  bf16* vl = vh + BLOCK_N * D;
  unsigned char* ring = base + OFF_RING;
  unsigned char* v_f32 = ring + (STAGES - 1) * STAGE_BYTES;
  float* pbuf = reinterpret_cast<float*>(base + OFF_P);
  Bars& bar = *reinterpret_cast<Bars*>(base + OFF_BAR);

  const int tid = threadIdx.x;
  // the warpgroup, from lane 0: the compiler then knows it is uniform
  // in a warp, and does not serialize the consumers' wgmma (which run
  // on either side of a branch on it) behind waits of its own
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
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
    mbar_init(&bar.k_raw, 1);
    mbar_init(&bar.v_raw, 1);
    mbar_init(&bar.kv_full, 1);
    mbar_init(&bar.ring_free, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bar.raw[s], 1);
      mbar_init(&bar.full[s], 1);
      mbar_init(&bar.empty[s], 2 * 128);  // every consumer thread
    }
    for (int s = 0; s < P_BUFS; ++s) {
      mbar_init(&bar.p_full[s], 128);     // warpgroup 1's threads
      mbar_init(&bar.p_empty[s], 128);    // warpgroup 2's threads
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid < 32) {
      // ---- the issuer: k and v, then q and dO of each tile; the last
      // stage's first fill waits until v's float32 tile there is read ----
      if (tid == 0) {
        mbar_expect_tx(&bar.k_raw, KV_F32_BYTES);
        tma_load_3d(base + OFF_V, &tm_k, &bar.k_raw, 0, k0, bh);
        mbar_expect_tx(&bar.v_raw, KV_F32_BYTES);
        tma_load_3d(v_f32, &tm_v, &bar.v_raw, 0, k0, bh);
        for (int t = t0; t < n_tiles; ++t) {
          const int i = t - t0, s = i % STAGES;
          unsigned char* stage = ring + s * STAGE_BYTES;
          if (i == STAGES - 1) mbar_wait(&bar.ring_free, 0);
          mbar_wait(&bar.empty[s], ((i / STAGES) & 1) ^ 1);
          mbar_expect_tx(&bar.raw[s], 2 * BLOCK_M * D * 4);
          tma_load_3d(stage, &tm_q, &bar.raw[s], 0, t * BLOCK_M, bh);
          tma_load_3d(stage + Q_SLOT, &tm_do, &bar.raw[s], 0, t * BLOCK_M,
                      bh);
        }
      }
      return;
    }
    // ---- the splitters ----
    const int st = tid - 32;
    mbar_wait(&bar.k_raw, 0);
    split_tile<BLOCK_N, 2, SPLITTERS, D>(
        kh, reinterpret_cast<const float*>(base + OFF_V), st);
    named_sync(1, SPLITTERS);  // k's float32 tile read: v's halves go there
    mbar_wait(&bar.v_raw, 0);
    split_tile<BLOCK_N, 2, SPLITTERS, D>(
        vh, reinterpret_cast<const float*>(v_f32), st);
    // the halves visible to wgmma, the last stage's reads ordered before
    // the TMA that refills it
    fence_proxy_async();
    named_sync(1, SPLITTERS);
    if (st == 0) {
      mbar_arrive(&bar.kv_full);
      mbar_arrive(&bar.ring_free);
    }
    for (int t = t0; t < n_tiles; ++t) {
      const int i = t - t0, s = i % STAGES;
      unsigned char* stage = ring + s * STAGE_BYTES;
      mbar_wait(&bar.raw[s], (i / STAGES) & 1);
      split_tile_in_place<BLOCK_M, 2, SPLITTERS, D>(
          reinterpret_cast<float*>(stage), st, 1);
      split_tile_in_place<BLOCK_M, 3, SPLITTERS, D>(
          reinterpret_cast<float*>(stage + Q_SLOT), st, 1);
      fence_proxy_async();
      named_sync(1, SPLITTERS);
      if (st == 0) mbar_arrive(&bar.full[s]);
    }
    return;
  }

  // ---- consumers: both hold the block's 64 keys x BLOCK_M q rows of a
  // tile in the same accumulator layout (keys are rows) ----
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;  // 0: S^T, P^T and dV; 1: dP^T, dS^T and dK
  const int ct = tid - 128 * wg;
  const int warp = ct >> 5, lane = ct & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int key_a = k0 + 16 * warp + g;  // this lane's keys: key_a, + 8
  const float p_masked_row = 1.f / (float)tk;
  const float scale2 = scale * LOG2E;
  const float* rowv = (cw == 0 ? lse : delta) + (long long)bh * tq;
  // a q or dO piece's 64-column blocks, the MN-major operands' stride
  const uint32_t blk = BLOCK_M * 64 * sizeof(bf16);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  mbar_wait(&bar.kv_full, 0);
  for (int t = t0; t < n_tiles; ++t) {
    const int it = t - t0, s_ = it % STAGES;
    const uint32_t par = (it / STAGES) & 1;
    const int pi = it % P_BUFS;
    const uint32_t ppar = (it / P_BUFS) & 1;
    const int q0 = t * BLOCK_M;
    unsigned char* stage = ring + s_ * STAGE_BYTES;
    const bf16* qh = reinterpret_cast<const bf16*>(stage);
    const bf16* ql = qh + BLOCK_M * D;
    const bf16* doh = reinterpret_cast<const bf16*>(stage + Q_SLOT);
    const bf16* dom = doh + BLOCK_M * D;
    const bf16* dol = dom + BLOCK_M * D;
    float* pb = pbuf + pi * (P_BYTES / 4) + ct;
    const bool edge = q0 + BLOCK_M > tq || k0 + BLOCK_N > tk ||
                      (causal && q0 + offset < k0 + BLOCK_N - 1);
    // lse log2(e) (warpgroup 1) or delta (warpgroup 2) of this lane's q
    // rows (columns 8 j + 2 tg, + 1 of the tile)
    float rv[2 * NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + 8 * j + 2 * tg + h;
        const float x = row < tq ? rowv[row] : 0.f;
        rv[2 * j + h] = cw == 0 ? x * LOG2E : x;
      }
    }
    mbar_wait(&bar.full[s_], par);
    // element i = 4 j + e of the accumulators: key key_a + 8 (e >> 1),
    // q row q0 + 8 j + 2 tg + (e & 1). k-step kk of the D = 128 products
    // lies in 64-column block kk / 4 of each piece.
    float x[NS];
    if (cw == 0) {
      // S^T = K Q^T: lo hi + hi lo + hi hi, 64 keys x BLOCK_M rows over D
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int ok = (kk >> 2) * BLOCK_N * 64 + (kk & 3) * 16;
        const int oq = (kk >> 2) * BLOCK_M * 64 + (kk & 3) * 16;
        ss_tile(x, desc_k_major(kl + ok), desc_k_major(qh + oq), kk != 0);
        ss_tile(x, desc_k_major(kh + ok), desc_k_major(ql + oq), 1);
        ss_tile(x, desc_k_major(kh + ok), desc_k_major(qh + oq), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NS; ++i) reg_fence(x[i]);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int j = i >> 2, e = i & 3;
        float p = ex2_ftz(fmaf(x[i], scale2, -rv[2 * j + (e & 1)]));
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
      mbar_wait(&bar.p_empty[pi], ppar ^ 1);
#pragma unroll
      for (int i = 0; i < NS; ++i) pb[i * 128] = x[i];
      mbar_arrive(&bar.p_full[pi]);
      // P^T in three pieces as the A operand of dV += P^T dO: k-step kk
      // (16 q rows) takes accumulator blocks 2 kk, 2 kk + 1; against
      // dO's three pieces read MN-major, the smallest products first
      uint32_t ph[KS][4], pm[KS][4], pl[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* xj = x + 4 * (2 * kk + h);
          split3_pack<bf16>(xj[0], xj[1], ph[kk][2 * h], pm[kk][2 * h],
                            pl[kk][2 * h]);
          split3_pack<bf16>(xj[2], xj[3], ph[kk][2 * h + 1],
                            pm[kk][2 * h + 1], pl[kk][2 * h + 1]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int o = kk * 16 * 64;
        W::rs128(acc, pl[kk], desc_mn_major(doh + o, blk));
        W::rs128(acc, ph[kk], desc_mn_major(dol + o, blk));
        W::rs128(acc, pm[kk], desc_mn_major(dom + o, blk));
        W::rs128(acc, pm[kk], desc_mn_major(doh + o, blk));
        W::rs128(acc, ph[kk], desc_mn_major(dom + o, blk));
        W::rs128(acc, ph[kk], desc_mn_major(doh + o, blk));
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          reg_fence(ph[kk][r]);
          reg_fence(pm[kk][r]);
          reg_fence(pl[kk][r]);
        }
      }
    } else {
      // dP^T = V dO^T: V's two pieces against dO's three, the smallest
      // products first
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int ov = (kk >> 2) * BLOCK_N * 64 + (kk & 3) * 16;
        const int od = (kk >> 2) * BLOCK_M * 64 + (kk & 3) * 16;
        ss_tile(x, desc_k_major(vh + ov), desc_k_major(dol + od), kk != 0);
        ss_tile(x, desc_k_major(vl + ov), desc_k_major(dom + od), 1);
        ss_tile(x, desc_k_major(vl + ov), desc_k_major(doh + od), 1);
        ss_tile(x, desc_k_major(vh + ov), desc_k_major(dom + od), 1);
        ss_tile(x, desc_k_major(vh + ov), desc_k_major(doh + od), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NS; ++i) reg_fence(x[i]);
      mbar_wait(&bar.p_full[pi], ppar);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int j = i >> 2, e = i & 3;
        const int row = q0 + 8 * j + 2 * tg + (e & 1);
        // 0 wherever P^T is 0 and on fully masked rows
        const bool lost = edge && causal && row + offset < 0;
        x[i] = lost ? 0.f
                    : pb[i * 128] * (x[i] - rv[2 * j + (e & 1)]) * scale;
      }
      mbar_arrive(&bar.p_empty[pi]);
      // dS^T in hi and lo halves as the A operand of dK += dS^T Q, Q's
      // halves read MN-major
      uint32_t xh[KS][4], xl[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* xj = x + 4 * (2 * kk + h);
          split_pack<bf16>(xj[0], xj[1], xh[kk][2 * h], xl[kk][2 * h]);
          split_pack<bf16>(xj[2], xj[3], xh[kk][2 * h + 1],
                           xl[kk][2 * h + 1]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int o = kk * 16 * 64;
        W::rs128(acc, xl[kk], desc_mn_major(qh + o, blk));
        W::rs128(acc, xh[kk], desc_mn_major(ql + o, blk));
        W::rs128(acc, xh[kk], desc_mn_major(qh + o, blk));
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          reg_fence(xh[kk][r]);
          reg_fence(xl[kk][r]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) reg_fence(acc[i]);
    mbar_arrive(&bar.empty[s_]);  // this thread is done with the stage
  }

  float* ob = (cw == 0 ? dv : dk) + (long long)bh * tk * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * tg;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key_a + 8 * r;
      if (key < tk)
        *reinterpret_cast<float2*>(ob + (long long)key * D + col) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
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

int launch(const Args& a) {
  CUtensorMap mq, mk, mv, mdo;
  int err = make_map_f32<D>(&mq, a.q, a.bh, a.tq, BLOCK_M);
  if (!err) err = make_map_f32<D>(&mdo, a.dout, a.bh, a.tq, BLOCK_M);
  if (!err) err = make_map_f32<D>(&mk, a.k, a.bh, a.tk, BLOCK_N);
  if (!err) err = make_map_f32<D>(&mv, a.v, a.bh, a.tk, BLOCK_N);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_f32_d128_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  return for_bh_chunks(a.bh, [&](int b0, int n) {
    const dim3 grid((a.tk + BLOCK_N - 1) / BLOCK_N, n);
    flash_bwd_dkv_f32_d128_wgmma_kernel<<<grid, THREADS, SMEM_BYTES,
                                          a.stream>>>(
        mq, mk, mv, mdo, a.lse, a.delta, static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), b0, a.tq, a.tk, a.scale, a.causal);
  });
}

}  // namespace

// dtype: 0 float32 (bf16 and fp16 are flash_bwd_dkv_d128_wgmma.cu's); d:
// 128. q, dout: [bh, tq, 128]; k, v, dk, dv: [bh, tk, 128]; lse, delta:
// [bh, tq] float32. All contiguous, 16-byte aligned, on the current
// device. Returns the CUDA error code of the launch (0 = ok).
extern "C" int flash_bwd_dkv_f32_d128_wgmma(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const float* lse,
                                            const float* delta, void* dk,
                                            void* dv, int bh, int tq,
                                            int tk, int d, int dtype,
                                            float scale, int causal,
                                            void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || d != D || dtype != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
               scale, causal, static_cast<cudaStream_t>(stream)};
  return launch(a);
}
