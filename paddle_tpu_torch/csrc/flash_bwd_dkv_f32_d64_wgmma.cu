// Flash-attention backward dK/dV for float32 at head dim 64 on Hopper's
// warpgroup tensor cores (sm_90a: wgmma, TMA, a producer warpgroup that
// splits), plain C interface. Head dim 128 runs
// flash_bwd_dkv_f32_d128_wgmma.cu (this design with 32-row q tiles),
// head dim 256 flash_bwd_dkv_f32_d256_wgmma.cu, the head dims past 256
// flash_bwd_dkv_f32mma.cu; bf16 and fp16 run flash_bwd_dkv_mma.cu at
// this head dim; dQ (K2) is flash_bwd_dq_f32_d64_wgmma.cu's.
//
// Replaces paddle_tpu/ops/pallas_attention.py:189 _fa_bwd_dkv_kernel
// (with _recompute_ds, :161; the second pallas_call of
// _flash_bwd_pallas, :290) on the float32 route at D = 64, the head dim
// of Transformer-base's attention. Per (batch*head) slice of q, do
// [tq, 64] and k, v [tk, 64] it computes
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
// Precision: flash_bwd_dkv_f32_d256_wgmma.cu's scheme, every operand in
// bf16 pieces, chosen over 3xTF32 dP^T and dV (flash_bwd_dkv_f32mma.cu's)
// by tests/test_torch_f32_split.py at the D = 64 shapes: both keep dK
// and dV under 0.33 of the float32 tier's limit on every case and seed
// there, and the pieces cost 11 bf16 products for dP^T and dV where
// 3xTF32 costs 6 TF32 products (12 at the bf16 rate) and a transposed
// dO tile, since TF32 wgmma reads shared memory only K-major:
//   S^T  = K Q^T: 3 products of hi + lo halves;
//   dP^T = V dO^T: dO in three pieces, V in two, five products;
//   dV  += P^T dO: P^T (registers) and dO both in three pieces, six
//          products, dO's pieces read MN-major;
//   dK  += dS^T Q: 3 products of halves, dS^T's from registers.
//
// What bounds it on the H100: at Transformer-base's decoder
// self-attention (B*H = 32*8, T = 256, D = 64, causal) it moves 101 MB
// (q, k, v, dO, lse, delta in; dK, dV out), 0.030 ms at 3.35 TB/s,
// against 4.3 GFLOP of useful products (8 D FLOP per visible pair) at
// their splits' rates (three, five, six and three bf16 products: 0.019
// ms); at its cross-attention (tq 128 over tk 256, non-causal) 84 MB,
// 0.025 ms. Memory bounds it at both.
//
// Design (flash_bwd_dkv_f32_d256_wgmma.cu's warpgroups and producer):
// - one block of three warpgroups per (bh, 64-key tile). Warpgroup 0 is
//   the producer (setmaxnreg down to 136 registers): lane 0 of its warp
//   0 issues every TMA load, its warps 1-3 split what lands. Consumer
//   warpgroup 1 takes S^T, P^T and dV += P^T dO, warpgroup 2 dP^T, dS^T
//   and dK += dS^T Q: 64 keys x 64 float32 accumulators each (32
//   registers a thread), at 184 registers (136 x 128 + 184 x 256 = the
//   launch's 168 x 384). ptxas (CUDA 12.9): 168 registers at launch, no
//   spill (chip_smoke.py logs the build's report). At D = 256's split,
//   104 for the producer, a splitter of a 64-row tile in place (48
//   float32 values held a thread) spilled two addresses (8 bytes).
// - what changes from D = 256 is room: a q tile takes 64 rows, so every
//   product is m64n64k16 (S^T and dP^T with both operands in shared
//   memory, dV and dK with the pieces of P^T and dS^T in registers),
//   where D = 256's 216 KB held it to 16-row tiles and m64n16k16.
// - TMA (3-D float32 tensor maps over [bh, t, 64], unswizzled boxes,
//   rows past t zero-filled) brings k's and v's float32 tiles once into
//   the P^T exchange (free until the first tile's P^T), split into
//   resident hi + lo tiles (4 x 8 KB), and each 64-row q and dO tile as
//   float32 into a two-stage ring from the start, beside the k and v
//   split. Each stage's q slot (16 KB) and dO slot (24 KB) are split in
//   place: every splitter holds its share in registers until all have
//   read theirs, then q's hi and lo and dO's hi, mid and lo are written
//   over the tile in wgmma's 128-byte-swizzled layout, behind
//   fence.proxy.async.
// - shared memory: k, v pieces 32 KB; the ring 2 x 40 KB; the P^T
//   exchange 2 x 16 KB: 144 KB of the 227 KB.
// - S^T = K Q^T (warpgroup 1, 12 wgmma) and dP^T = V dO^T (warpgroup 2,
//   20) run at once; warpgroup 1 forms P^T (float32, with the masks) and
//   hands it to warpgroup 2 through a two-buffer exchange in shared
//   memory (one float a thread a register, its own mbarrier pair), then
//   takes dV += P^T dO (24 wgmma); warpgroup 2 forms dS^T and takes
//   dK += dS^T Q (12). Each warpgroup waits for its products on the
//   branch that issued them (ptxas serializes every wgmma otherwise,
//   C7518).
// - the q loop starts at the first tile that sees the block's keys
//   (max(0, k0 - offset) / 64) unless fully masked rows exist; the mask
//   runs only on tiles the diagonal or a ragged end crosses. lse and
//   delta are read by each consumer from global memory (16 values a
//   thread a tile, before the tile's wait); P^T = 2^(S^T scale log2(e)
//   - lse log2(e)) is one fma and ex2.approx.ftz (relative error
//   ~2^-22, far inside the float32 tier).
// - dK and dV go from the accumulators to global memory as float2
//   pairs; no atomics. B*H past gridDim.y's limit is launched in
//   chunks.
//
// What it leaves: blocks of 128 keys (each consumer all four products
// of its 64 keys, as the bf16 D = 128 kernel) to halve the q and dO
// traffic; fusing dQ (K2) into this pass; reading GQA KV heads in place.

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

#include <math.h>

namespace {

using namespace wgmma_sm90;
using mma_sm90::for_bh_chunks;
using bf16 = __nv_bfloat16;

constexpr int D = 64;
constexpr int BLOCK_N = 64;   // keys per block
constexpr int BLOCK_M = 64;   // q rows per tile
constexpr int STAGES = 2;
constexpr int THREADS = 3 * 128;
constexpr int SPLITTERS = 96;  // the producer's warps 1-3
constexpr float LOG2E = 1.4426950408889634f;

// shared memory, in bytes from a 1024-byte-aligned base
constexpr int KP_BYTES = BLOCK_N * D * 2;         // 8 KB a k or v piece
constexpr int OFF_V = 2 * KP_BYTES;               // k hi, lo; v hi, lo
constexpr int OFF_RING = 4 * KP_BYTES;            // 32 KB
constexpr int QP_BYTES = BLOCK_M * D * 2;         // 8 KB a q or dO piece
constexpr int Q_SLOT = 2 * QP_BYTES;              // 16 KB: float32, or hi + lo
constexpr int DO_SLOT = 3 * QP_BYTES;             // 24 KB: float32, or 3 pieces
constexpr int STAGE_BYTES = Q_SLOT + DO_SLOT;     // 40 KB
constexpr int OFF_P = OFF_RING + STAGES * STAGE_BYTES;  // 112 KB
constexpr int P_BYTES = BLOCK_N * BLOCK_M * 4;    // 16 KB
constexpr int KV_F32_BYTES = BLOCK_N * D * 4;     // 16 KB: k's or v's tile
constexpr int OFF_BAR = OFF_P + STAGES * P_BYTES; // 144 KB
constexpr int SMEM_BYTES = OFF_BAR + 256 + 1024;  // + barriers, alignment
constexpr int PRODUCER_REGS = 136;  // setmaxnreg: the producer's
constexpr int CONSUMER_REGS = 184;  // and each consumer's

static_assert(2 * KV_F32_BYTES <= STAGES * P_BYTES,
              "k's and v's float32 tiles land in the P^T exchange");
static_assert(BLOCK_M * D * 4 <= Q_SLOT, "q's float32 tile fits its slot");
static_assert(PRODUCER_REGS + 2 * CONSUMER_REGS == 3 * 168,
              "setmaxnreg redistributes the launch's 168 registers");

struct Bars {
  uint64_t kv_raw;          // k's and v's float32 tiles landed
  uint64_t kv_full;         // their halves written
  uint64_t raw[STAGES];     // a stage's q and dO float32 tiles landed
  uint64_t full[STAGES];    // their pieces written
  uint64_t empty[STAGES];   // both consumers are done with them
  uint64_t p_full[STAGES];
  uint64_t p_empty[STAGES];
};

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_f32_d64_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
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
    mbar_init(&bar.kv_raw, 1);
    mbar_init(&bar.kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bar.raw[s], 1);
      mbar_init(&bar.full[s], 1);
      mbar_init(&bar.empty[s], 2 * 128);  // every consumer thread
      mbar_init(&bar.p_full[s], 128);     // warpgroup 1's threads
      mbar_init(&bar.p_empty[s], 128);    // warpgroup 2's threads
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid < 32) {
      // ---- the issuer: k and v, then q and dO of each tile ----
      if (tid == 0) {
        mbar_expect_tx(&bar.kv_raw, 2 * KV_F32_BYTES);
        tma_load_3d(pbuf, &tm_k, &bar.kv_raw, 0, k0, bh);
        tma_load_3d(base + OFF_P + KV_F32_BYTES, &tm_v, &bar.kv_raw, 0, k0,
                    bh);
        for (int t = t0; t < n_tiles; ++t) {
          const int i = t - t0, s = i % STAGES;
          unsigned char* stage = ring + s * STAGE_BYTES;
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
    mbar_wait(&bar.kv_raw, 0);
    split_tile<BLOCK_N, 2, SPLITTERS, D>(kh, pbuf, st);
    split_tile<BLOCK_N, 2, SPLITTERS, D>(
        vh, reinterpret_cast<const float*>(base + OFF_P + KV_F32_BYTES), st);
    // the halves visible to wgmma; the exchange they came from is read
    // before any consumer writes P^T there (kv_full)
    fence_proxy_async();
    named_sync(1, SPLITTERS);
    if (st == 0) mbar_arrive(&bar.kv_full);
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

  // ---- consumers: both hold the block's 64 keys x 64 q rows of a tile
  // in the same accumulator layout (keys are rows) ----
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;  // 0: S^T, P^T and dV; 1: dP^T, dS^T and dK
  const int ct = tid - 128 * wg;
  const int warp = ct >> 5, lane = ct & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int key_a = k0 + 16 * warp + g;  // this lane's keys: key_a, + 8
  const float p_masked_row = 1.f / (float)tk;
  const float scale2 = scale * LOG2E;
  const float* rowv = (cw == 0 ? lse : delta) + (long long)bh * tq;
  const uint32_t blk = BLOCK_M * 64 * sizeof(bf16);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  mbar_wait(&bar.kv_full, 0);
  for (int t = t0; t < n_tiles; ++t) {
    const int it = t - t0, s_ = it % STAGES;
    const uint32_t par = (it / STAGES) & 1;
    const int q0 = t * BLOCK_M;
    unsigned char* stage = ring + s_ * STAGE_BYTES;
    const bf16* qh = reinterpret_cast<const bf16*>(stage);
    const bf16* ql = qh + BLOCK_M * D;
    const bf16* doh = reinterpret_cast<const bf16*>(stage + Q_SLOT);
    const bf16* dom = doh + BLOCK_M * D;
    const bf16* dol = dom + BLOCK_M * D;
    float* pb = pbuf + s_ * (P_BYTES / 4) + ct;
    const bool edge = q0 + BLOCK_M > tq || k0 + BLOCK_N > tk ||
                      (causal && q0 + offset < k0 + BLOCK_N - 1);
    // lse log2(e) (warpgroup 1) or delta (warpgroup 2) of this lane's q
    // rows (columns 8 j + 2 tg, + 1 of the tile)
    float rv[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + 8 * j + 2 * tg + h;
        const float x = row < tq ? rowv[row] : 0.f;
        rv[2 * j + h] = cw == 0 ? x * LOG2E : x;
      }
    }
    mbar_wait(&bar.full[s_], par);
    // element i = 4 j + e of the accumulators: key key_a + 8 (e >> 1),
    // q row q0 + 8 j + 2 tg + (e & 1)
    float x[32];
    if (cw == 0) {
      // S^T = K Q^T: lo hi + hi lo + hi hi, 64 keys x 64 rows over D
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        W::ss64(x, desc_k_major(kl + kk * 16), desc_k_major(qh + kk * 16),
                kk != 0);
        W::ss64(x, desc_k_major(kh + kk * 16), desc_k_major(ql + kk * 16), 1);
        W::ss64(x, desc_k_major(kh + kk * 16), desc_k_major(qh + kk * 16), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(x[i]);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
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
      mbar_wait(&bar.p_empty[s_], par ^ 1);
#pragma unroll
      for (int i = 0; i < 32; ++i) pb[i * 128] = x[i];
      mbar_arrive(&bar.p_full[s_]);
      // P^T in three pieces as the A operand of dV += P^T dO: k-step kk
      // (16 q rows) takes accumulator blocks 2 kk, 2 kk + 1; against
      // dO's three pieces read MN-major, the smallest products first
      uint32_t ph[4][4], pm[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
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
      for (int kk = 0; kk < 4; ++kk) {
        const int o = kk * 16 * 64;
        W::rs64(acc, pl[kk], desc_mn_major(doh + o, blk));
        W::rs64(acc, ph[kk], desc_mn_major(dol + o, blk));
        W::rs64(acc, pm[kk], desc_mn_major(dom + o, blk));
        W::rs64(acc, pm[kk], desc_mn_major(doh + o, blk));
        W::rs64(acc, ph[kk], desc_mn_major(dom + o, blk));
        W::rs64(acc, ph[kk], desc_mn_major(doh + o, blk));
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
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
        const int o = kk * 16;
        W::ss64(x, desc_k_major(vh + o), desc_k_major(dol + o), kk != 0);
        W::ss64(x, desc_k_major(vl + o), desc_k_major(dom + o), 1);
        W::ss64(x, desc_k_major(vl + o), desc_k_major(doh + o), 1);
        W::ss64(x, desc_k_major(vh + o), desc_k_major(dom + o), 1);
        W::ss64(x, desc_k_major(vh + o), desc_k_major(doh + o), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(x[i]);
      mbar_wait(&bar.p_full[s_], par);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int j = i >> 2, e = i & 3;
        const int row = q0 + 8 * j + 2 * tg + (e & 1);
        // 0 wherever P^T is 0 and on fully masked rows
        const bool lost = edge && causal && row + offset < 0;
        x[i] = lost ? 0.f
                    : pb[i * 128] * (x[i] - rv[2 * j + (e & 1)]) * scale;
      }
      mbar_arrive(&bar.p_empty[s_]);
      // dS^T in hi and lo halves as the A operand of dK += dS^T Q, Q's
      // halves read MN-major
      uint32_t xh[4][4], xl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
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
      for (int kk = 0; kk < 4; ++kk) {
        const int o = kk * 16 * 64;
        W::rs64(acc, xl[kk], desc_mn_major(qh + o, blk));
        W::rs64(acc, xh[kk], desc_mn_major(ql + o, blk));
        W::rs64(acc, xh[kk], desc_mn_major(qh + o, blk));
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          reg_fence(xh[kk][r]);
          reg_fence(xl[kk][r]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) reg_fence(acc[i]);
    mbar_arrive(&bar.empty[s_]);  // this thread is done with the stage
  }

  float* ob = (cw == 0 ? dv : dk) + (long long)bh * tk * D;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
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
      flash_bwd_dkv_f32_d64_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  return for_bh_chunks(a.bh, [&](int b0, int n) {
    const dim3 grid((a.tk + BLOCK_N - 1) / BLOCK_N, n);
    flash_bwd_dkv_f32_d64_wgmma_kernel<<<grid, THREADS, SMEM_BYTES,
                                         a.stream>>>(
        mq, mk, mv, mdo, a.lse, a.delta, static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), b0, a.tq, a.tk, a.scale, a.causal);
  });
}

}  // namespace

// dtype: 0 float32 (bf16 and fp16 are flash_bwd_dkv_mma.cu's); d: 64.
// q, dout: [bh, tq, 64]; k, v, dk, dv: [bh, tk, 64]; lse, delta: [bh, tq]
// float32. All contiguous, 16-byte aligned, on the current device.
// Returns the CUDA error code of the launch (0 = ok).
extern "C" int flash_bwd_dkv_f32_d64_wgmma(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const float* lse,
                                           const float* delta, void* dk,
                                           void* dv, int bh, int tq, int tk,
                                           int d, int dtype, float scale,
                                           int causal, void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || d != D || dtype != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
               scale, causal, static_cast<cudaStream_t>(stream)};
  return launch(a);
}
