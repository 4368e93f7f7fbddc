// Flash-attention backward dK/dV for float32 at head dim 256 on Hopper's
// warpgroup tensor cores (sm_90a: wgmma, TMA, a producer warpgroup that
// splits), plain C interface. Head dims 64 and 128 run
// flash_bwd_dkv_f32_d64_wgmma.cu and flash_bwd_dkv_f32_d128_wgmma.cu
// (this design with 64- and 32-row q tiles), the head dims past 256
// flash_bwd_dkv_f32mma.cu; bf16 and fp16 run flash_bwd_dkv_d256_wgmma.cu
// at this head dim; dQ (K2) is flash_bwd_dq_f32_d256_wgmma.cu's.
//
// Replaces paddle_tpu/ops/pallas_attention.py:189 _fa_bwd_dkv_kernel
// (with _recompute_ds, :161; the second pallas_call of
// _flash_bwd_pallas, :290) on the float32 route at D = 256. Per
// (batch*head) slice of q, do [tq, 256] and k, v [tk, 256] it computes
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
// Precision: flash_bwd_dq_f32_d256_wgmma.cu's scheme, every operand in
// bf16 pieces (tests/test_torch_f32_split.py: dK <= 0.23 and dV
// <= 0.15 of the float32 tier's limit on every D = 256 case and
// seed, where one rounding misses it):
//   S^T  = K Q^T: 3 products of hi + lo halves;
//   dP^T = V dO^T: dO in three pieces, V in two, five products;
//   dV  += P^T dO: P^T (registers) and dO both in three pieces, six
//          products. dO's pieces are read MN-major, which wgmma allows
//          for 16-bit types only: the D = 128 kernel's 3xTF32 dV would
//          need dO transposed in shared memory (128 KB a 64-row tile).
//          With dO in two pieces (3xbf16) dV reaches 0.89 of the limit;
//          with P^T in two (five products, the runner-up) 0.46, but
//          0.54-0.69 at T 32 (B*H 512), and on the H100 0.84 at B*H
//          65536, T 32 (chip_smoke.py), against 0.23-0.28 with three;
//   dK  += dS^T Q: 3 products of halves, dS^T's from registers.
//
// What bounds it on the H100: at the head_dim_256 float32 train step's
// shape (B*H = 1*16, T = 256, D = 256, causal) it moves 25.2 MB (q, k,
// v, dO, lse, delta in; dK, dV out), 0.0075 ms at 3.35 TB/s, against
// 1.08 GFLOP of useful products (8 D FLOP per visible pair: K Q^T,
// V dO^T, P^T dO, dS^T Q) at their splits' rates (three, five, six
// and three bf16 products: 0.0046 ms). Memory bounds it; 64 blocks of 64
// keys leave it latency-bound there. At B*H = 4, T = 2048 the
// operations bound it.
//
// Design (flash_bwd_dkv_d256_wgmma.cu's warpgroups,
// flash_bwd_dq_f32_d256_wgmma.cu's producer):
// - one block of three warpgroups per (bh, 64-key tile). Warpgroup 0 is
//   the producer (setmaxnreg down to 104 registers): lane 0 of its warp
//   0 issues every TMA load, its warps 1-3 split what lands. Consumer
//   warpgroup 1 takes S^T, P^T and dV += P^T dO, warpgroup 2 dP^T, dS^T
//   and dK += dS^T Q: 64 keys x 256 float32 accumulators each (128
//   registers a thread), at 200 registers (104 x 128 + 200 x 256 = the
//   launch's 168 x 384). ptxas (CUDA 12.9): 168 registers at launch,
//   no spill.
// - TMA (3-D float32 tensor maps over [bh, t, 256], unswizzled boxes,
//   rows past t zero-filled) brings k's and v's float32 tiles once (k's
//   into v's pieces' memory, v's into the ring's), split into resident
//   hi + lo tiles (2 x 64 KB), then each 16-row q and dO tile as float32
//   into a two-stage ring. Each stage's q slot (16 KB) and dO slot (24
//   KB) are split in place: every splitter holds its share in registers
//   until all have read theirs, then q's hi and lo and dO's hi, mid and
//   lo are written over the tile in wgmma's 128-byte-swizzled layout,
//   behind fence.proxy.async.
// - shared memory: k, v 128 KB; the ring 2 x 40 KB; P^T exchange
//   2 x 4 KB: 216 KB of the 227 KB. That is why a q tile has 16 rows:
//   at 32 rows two stages take 160 KB.
// - S^T = K Q^T (warpgroup 1, 48 wgmma m64n16k16) and dP^T = V dO^T
//   (warpgroup 2, 80) run at once, each over the whole 256-wide head,
//   both operands from shared memory; no slice recomputes them.
// - warpgroup 1 forms P^T (float32, with the masks) and hands it to
//   warpgroup 2 through a two-buffer exchange in shared memory (one
//   float a thread a register, its own mbarrier pair), then takes
//   dV += P^T dO as wgmma m64n256k16 with P^T's pieces in registers and
//   dO's read MN-major (6 products). Warpgroup 2 forms dS^T and takes
//   dK += dS^T Q the same way (3 products).
// - the q loop starts at the first tile that sees the block's keys
//   (max(0, k0 - offset) / 16) unless fully masked rows exist; the mask
//   runs only on tiles the diagonal or a ragged end crosses. lse and
//   delta are read by each consumer from global memory (4 values a
//   thread a tile).
// - dK and dV go from the accumulators to global memory as float2
//   pairs; no atomics.
//
// What it leaves: wider q tiles (m64n32 and up) where shared memory
// allows; fusing dQ (K2) into this pass; reading GQA KV heads in place.

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

#include <math.h>

namespace {

using namespace wgmma_sm90;
using mma_sm90::for_bh_chunks;
using bf16 = __nv_bfloat16;

constexpr int D = 256;
constexpr int BLOCK_N = 64;   // keys per block
constexpr int BLOCK_M = 16;   // q rows per tile
constexpr int STAGES = 2;
constexpr int THREADS = 3 * 128;
constexpr int SPLITTERS = 96;  // the producer's warps 1-3
constexpr float LOG2E = 1.4426950408889634f;

// shared memory, in bytes from a 1024-byte-aligned base
constexpr int KP_BYTES = BLOCK_N * D * 2;         // 32 KB a k or v half
constexpr int OFF_V = 2 * KP_BYTES;               // k hi, lo; v hi, lo
constexpr int OFF_RING = 4 * KP_BYTES;            // 128 KB
constexpr int QP_BYTES = BLOCK_M * D * 2;         // 8 KB a q or dO piece
constexpr int Q_SLOT = 2 * QP_BYTES;              // 16 KB: float32, or hi + lo
constexpr int DO_SLOT = 3 * QP_BYTES;             // 24 KB: float32, or 3 pieces
constexpr int STAGE_BYTES = Q_SLOT + DO_SLOT;     // 40 KB
constexpr int OFF_P = OFF_RING + STAGES * STAGE_BYTES;  // 208 KB
constexpr int P_BYTES = BLOCK_N * BLOCK_M * 4;    // 4 KB
constexpr int OFF_BAR = OFF_P + STAGES * P_BYTES; // 216 KB
constexpr int SMEM_BYTES = OFF_BAR + 256 + 1024;  // + barriers, alignment
constexpr int PRODUCER_REGS = 104;  // setmaxnreg: the producer's
constexpr int CONSUMER_REGS = 200;  // and each consumer's

static_assert(BLOCK_N * D * 4 <= 2 * KP_BYTES, "k's float32 tile fits v's");
static_assert(BLOCK_N * D * 4 <= STAGES * STAGE_BYTES, "v's fits the ring");
static_assert(BLOCK_M * D * 4 <= Q_SLOT, "q's float32 tile fits its slot");
static_assert(PRODUCER_REGS + 2 * CONSUMER_REGS == 3 * 168,
              "setmaxnreg redistributes the launch's 168 registers");

struct Bars {
  uint64_t k_raw, v_raw;    // k's / v's float32 tile landed
  uint64_t kv_full;         // k's and v's halves written
  uint64_t ring_free;       // v's float32 tile read: the ring may refill
  uint64_t raw[STAGES];     // a stage's q and dO float32 tiles landed
  uint64_t full[STAGES];    // their pieces written
  uint64_t empty[STAGES];   // both consumers are done with them
  uint64_t p_full[STAGES];
  uint64_t p_empty[STAGES];
};

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_f32_d256_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
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
    mbar_init(&bar.k_raw, 1);
    mbar_init(&bar.v_raw, 1);
    mbar_init(&bar.kv_full, 1);
    mbar_init(&bar.ring_free, 1);
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
        mbar_expect_tx(&bar.k_raw, BLOCK_N * D * 4);
        tma_load_3d(base + OFF_V, &tm_k, &bar.k_raw, 0, k0, bh);
        mbar_expect_tx(&bar.v_raw, BLOCK_N * D * 4);
        tma_load_3d(ring, &tm_v, &bar.v_raw, 0, k0, bh);
        mbar_wait(&bar.ring_free, 0);
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
    mbar_wait(&bar.k_raw, 0);
    split_tile<BLOCK_N, 2, SPLITTERS>(
        kh, reinterpret_cast<const float*>(base + OFF_V), st);
    named_sync(1, SPLITTERS);  // k's float32 tile read: v's halves go there
    mbar_wait(&bar.v_raw, 0);
    split_tile<BLOCK_N, 2, SPLITTERS>(
        vh, reinterpret_cast<const float*>(ring), st);
    // the halves visible to wgmma, the ring's reads ordered before the
    // TMA that refills it
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
      split_tile_in_place<BLOCK_M, 2, SPLITTERS>(
          reinterpret_cast<float*>(stage), st, 1);
      split_tile_in_place<BLOCK_M, 3, SPLITTERS>(
          reinterpret_cast<float*>(stage + Q_SLOT), st, 1);
      fence_proxy_async();
      named_sync(1, SPLITTERS);
      if (st == 0) mbar_arrive(&bar.full[s]);
    }
    return;
  }

  // ---- consumers: both hold the block's 64 keys x 16 q rows of a tile
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
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

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
    float rv[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + 8 * j + 2 * tg + h;
        const float x = row < tq ? rowv[row] : 0.f;
        rv[2 * j + h] = cw == 0 ? x * LOG2E : x;
      }
    }
    mbar_wait(&bar.full[s_], par);
    // S^T = K Q^T (warpgroup 1: lo hi + hi lo + hi hi) or dP^T = V dO^T
    // (warpgroup 2: V's two pieces against dO's three, the smallest
    // products first), 64 keys x 16 rows over D = 256
    float s[8];
    wgmma_fence();
    if (cw == 0) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int ko = c * BLOCK_N * 64 + kk * 16;
          const int qo = c * BLOCK_M * 64 + kk * 16;
          W::ss16(s, desc_k_major(kl + ko), desc_k_major(qh + qo),
                  (c | kk) != 0);
          W::ss16(s, desc_k_major(kh + ko), desc_k_major(ql + qo), 1);
          W::ss16(s, desc_k_major(kh + ko), desc_k_major(qh + qo), 1);
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int vo = c * BLOCK_N * 64 + kk * 16;
          const int qo = c * BLOCK_M * 64 + kk * 16;
          W::ss16(s, desc_k_major(vh + vo), desc_k_major(dol + qo),
                  (c | kk) != 0);
          W::ss16(s, desc_k_major(vl + vo), desc_k_major(dom + qo), 1);
          W::ss16(s, desc_k_major(vl + vo), desc_k_major(doh + qo), 1);
          W::ss16(s, desc_k_major(vh + vo), desc_k_major(dom + qo), 1);
          W::ss16(s, desc_k_major(vh + vo), desc_k_major(doh + qo), 1);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 8; ++i) reg_fence(s[i]);

    // element i = 4 j + e of the accumulators: key key_a + 8 (e >> 1),
    // q row q0 + 8 j + 2 tg + (e & 1)
    float x[8];
    if (cw == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int j = i >> 2, e = i & 3;
        float p = exp2f(s[i] * scale2 - rv[2 * j + (e & 1)]);
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
      for (int i = 0; i < 8; ++i) pb[i * 128] = x[i];
      mbar_arrive(&bar.p_full[s_]);
      // P^T in hi and lo halves as the A operand of dV += P^T dO (one
      // k-step of 16 rows), against dO's three pieces read MN-major, the
      // smallest products first
      uint32_t ph[4], pm[4], pl[4];
#pragma unroll
      for (int h = 0; h < 4; ++h)
        split3_pack<bf16>(x[2 * h], x[2 * h + 1], ph[h], pm[h], pl[h]);
      const uint32_t blk = BLOCK_M * 64 * sizeof(bf16);
      wgmma_fence();
      W::rs256(acc, pl, desc_mn_major(doh, blk));
      W::rs256(acc, ph, desc_mn_major(dol, blk));
      W::rs256(acc, pm, desc_mn_major(dom, blk));
      W::rs256(acc, pm, desc_mn_major(doh, blk));
      W::rs256(acc, ph, desc_mn_major(dom, blk));
      W::rs256(acc, ph, desc_mn_major(doh, blk));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        reg_fence(ph[h]);
        reg_fence(pm[h]);
        reg_fence(pl[h]);
      }
    } else {
      mbar_wait(&bar.p_full[s_], par);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int j = i >> 2, e = i & 3;
        const int row = q0 + 8 * j + 2 * tg + (e & 1);
        // 0 wherever P^T is 0 and on fully masked rows
        const bool lost = edge && causal && row + offset < 0;
        x[i] = lost ? 0.f
                    : pb[i * 128] * (s[i] - rv[2 * j + (e & 1)]) * scale;
      }
      mbar_arrive(&bar.p_empty[s_]);
      // dS^T in hi and lo halves as the A operand of dK += dS^T Q, Q's
      // halves read MN-major
      uint32_t xh[4], xl[4];
#pragma unroll
      for (int h = 0; h < 4; ++h)
        split_pack<bf16>(x[2 * h], x[2 * h + 1], xh[h], xl[h]);
      const uint32_t blk = BLOCK_M * 64 * sizeof(bf16);
      wgmma_fence();
      W::rs256(acc, xl, desc_mn_major(qh, blk));
      W::rs256(acc, xh, desc_mn_major(ql, blk));
      W::rs256(acc, xh, desc_mn_major(qh, blk));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        reg_fence(xh[h]);
        reg_fence(xl[h]);
      }
    }
#pragma unroll
    for (int i = 0; i < 128; ++i) reg_fence(acc[i]);
    mbar_arrive(&bar.empty[s_]);  // this thread is done with the stage
  }

  float* ob = (cw == 0 ? dv : dk) + (long long)bh * tk * D;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
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
  int err = make_map_f32(&mq, a.q, a.bh, a.tq, BLOCK_M);
  if (!err) err = make_map_f32(&mdo, a.dout, a.bh, a.tq, BLOCK_M);
  if (!err) err = make_map_f32(&mk, a.k, a.bh, a.tk, BLOCK_N);
  if (!err) err = make_map_f32(&mv, a.v, a.bh, a.tk, BLOCK_N);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_f32_d256_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  return for_bh_chunks(a.bh, [&](int b0, int n) {
    const dim3 grid((a.tk + BLOCK_N - 1) / BLOCK_N, n);
    flash_bwd_dkv_f32_d256_wgmma_kernel<<<grid, THREADS, SMEM_BYTES,
                                          a.stream>>>(
        mq, mk, mv, mdo, a.lse, a.delta, static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), b0, a.tq, a.tk, a.scale, a.causal);
  });
}

}  // namespace

// dtype: 0 float32 (bf16 and fp16 are flash_bwd_dkv_mma.cu's and
// flash_bwd_dkv_d256_wgmma.cu's); d: 256. q, dout: [bh, tq, 256]; k, v,
// dk, dv: [bh, tk, 256]; lse, delta: [bh, tq] float32. All contiguous,
// 16-byte aligned, on the current device. Returns the CUDA error code of
// the launch (0 = ok).
extern "C" int flash_bwd_dkv_f32_d256_wgmma(const void* q, const void* k,
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
