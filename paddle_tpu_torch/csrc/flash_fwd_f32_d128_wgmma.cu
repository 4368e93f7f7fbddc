// Flash-attention forward for float32 at head dim 128 on Hopper's
// warpgroup tensor cores (sm_90a: wgmma, TMA, a producer warpgroup that
// splits), two blocks an SM, plain C interface. Head dim 64 runs
// flash_fwd_f32_d64_wgmma.cu, head dim 256 flash_fwd_f32_d256_wgmma.cu,
// the head dims past 256 flash_fwd_f32mma.cu in 128-column slices; bf16
// and fp16 run flash_fwd_d128_wgmma.cu at this head dim.
//
// Replaces paddle_tpu/ops/pallas_attention.py:59 _fa_kernel (launched by
// _flash_fwd_pallas, :111) on the float32 route at D = 128, the head dim
// of the Llama width's float32 serving, generation, decode prefill,
// pipeline and training-parity attention. Per (batch*head) slice of
// q [tq, 128] and k, v [tk, 128] it computes
//   S   = (Q K^T) * scale, causal-masked bottom-right (row + tk - tq >= col)
//   O   = softmax(S) V    by online softmax (running max m, sum l)
//   lse = m + log(l)      (l == 0 -> 1), compact [BH, tq] float32
// with _ref_attention_lse's semantics: masked scores are -1e30 (a fully
// masked row, causal with tq > tk, averages V), keys >= tk are -inf and
// take no part, rows >= tq are never written. O is float32.
//
// Precision: the split every float32 K1 ships. Every operand of both
// products (Q and K in S = Q K^T, P and V in P V) is split into bf16
// halves x = hi + lo and each product taken as three wgmma, lo hi +
// hi lo + hi hi; the dropped lo lo is ~2^-18 of the product
// (tests/test_torch_f32_split.py: O and lse under half the float32
// tier's limit at every D = 128 case). P is split in registers
// (split_pack); V's halves are read MN-major, which wgmma allows only in
// 16-bit types.
//
// What bounds it on the H100: at the float32 serving bucket (B*H = 4*32,
// T = 256, causal) it moves 67 MB (q, k, v in; o, lse out), 0.020 ms at
// 3.35 TB/s, against 2.16 GFLOP of useful products (4 D FLOP per visible
// pair), 0.0065 ms at the 3xbf16 rate (a third of 989 TFLOP/s): memory
// bounds it, as at T 128 (34 MB, 0.010 ms) and at the training-parity
// shape (B*H 8, T 256: 4.2 MB, 0.0013 ms, 32 blocks on 132 SMs, so
// latency in fact). At B*H 2*32, T 2048 (causal) its 68.7 GFLOP take
// 0.2086 ms against 0.080 ms of bytes: operations bound it there.
//
// Design (flash_fwd_f32_d64_wgmma.cu's producer that splits and online
// softmax, at D = 128 with 32-key tiles so that two blocks still fit):
// - one block of two warpgroups per (bh, 64-row q tile), heaviest tile
//   first, sized so that two blocks share an SM (BLOCKS_PER_SM): at the
//   serving shape the grid is 512 blocks, 1.9 waves of 264 resident
//   ones, and one block's fill (q landing, the split, the first product)
//   and drain overlap the other's products and exponentials.
//   residency_check.py times this against one block an SM, with the
//   same ring and with a deeper one. Warpgroup 0 is the producer
//   (setmaxnreg down to 88 registers): its thread 0 issues q's TMA load
//   and the ring's first round, and its four warps split what lands.
//   Warpgroup 1 is the consumer, the block's 64 rows, at 168 (88 + 168
//   = 2 x 128, the launch's count under __launch_bounds__(256, 2)); its
//   thread 0 issues each refill as soon as every consumer thread has
//   released the slot, so no producer thread waits on the consumer.
// - TMA (3-D float32 tensor maps over [bh, t, 128], unswizzled boxes of
//   64 q rows or 32 keys, rows past t zero-filled) brings q's float32
//   tile into q's own 32 KB, then each 32-key k and v tile into a slot
//   of a four-slot ring (k_t, v_t, k_t+1, v_t+1). Each is split in place
//   into a group-interleaved hi + lo tile (wgmma_sm90.cuh: an 8-row group
//   of the float32 tile, 4096 bytes, holds its two pieces' two column
//   blocks each), a splitter warp a group at a time with 32 values a
//   lane, so no splitter waits for another before writing; a fence
//   (fence.proxy.async) hands a tile to wgmma, which reads through the
//   async proxy. A slot has raw, full and empty mbarriers.
// - shared memory: q 32 KB, the ring 4 x 16 KB: 96 KB of the 227 KB, so
//   two blocks (with barriers, alignment and the 1 KB the SM keeps a
//   block) take 197 KB of the SM's 228; a fifth slot would not leave
//   room for the second block, and 64-key tiles (32 KB a slot) would
//   leave it three slots.
// - S = Q K^T runs once a k tile: 24 wgmma m64n32k16, both operands
//   from shared memory; the consumer releases k's slot as soon as S is
//   in.
// - the online softmax runs in base 2 in float32 registers: an unmasked
//   tile keeps S raw, takes its row maxima once scaled, x - m as one fma
//   and 2^x as ex2.approx.ftz (flash_fwd_d128_wgmma.cu found that a
//   tile's exponentials and splits, not its products, set K1's time at
//   D = 128). P is split in registers into the A operand of O += P V,
//   wgmma m64n128k16 with V's halves read MN-major from their slot (two
//   column blocks CBLOCK_BYTES apart): 2 k-steps x 3 products. O
//   (64 x 128 float32, 64 registers a thread) stays in registers for the
//   whole key loop. The consumer waits for each group on the path that
//   issued it (C7518 otherwise).
// - registers: ptxas reports 128 a thread and 0 bytes of spill (the
//   build log, which chip_smoke.py prints with any spill it reports:
//   none is allowed), and cudaOccupancyMaxActiveBlocksPerMultiprocessor's
//   count must equal BLOCKS_PER_SM (2 on the H100; chip_smoke.py checks
//   it).
// - causal: k tiles wholly right of the block's last row are not
//   visited; a block holding a fully masked row visits every tile; the
//   elementwise mask runs only on tiles the diagonal or the ragged end
//   crosses, and on every tile under a scale below 0 (which turns the
//   raw row maxima into minima).
// - O goes from the accumulators to global memory as float2 pairs. B*H
//   past gridDim.y's limit is launched in chunks.
//
// What it leaves: overlapping a tile's S with the previous tile's P V
// inside the block (two blocks an SM overlap them instead); splitting k
// and v once a head instead of once a block (every q tile of a head
// splits the k and v tiles it visits again); reading GQA KV heads in
// place; caching the tensor maps across calls.

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

#include <math.h>

namespace {

using namespace wgmma_sm90;
using mma_sm90::for_bh_chunks;
using bf16 = __nv_bfloat16;

constexpr int D = 128;
constexpr int BLOCK_M = 64;   // q rows per block: one consumer warpgroup
constexpr int BLOCK_N = 32;   // keys per k or v tile
constexpr int SLOTS = 4;      // ring of k / v tiles: k_t, v_t in turn
constexpr int THREADS = 2 * 128;
constexpr int BLOCKS_PER_SM = 2;   // resident blocks an SM, by design
constexpr int SPLITTERS = 128;     // the producer warpgroup
constexpr int PRODUCER_REGS = 88;  // setmaxnreg: the producer's
constexpr int CONSUMER_REGS = 168; // and the consumer's
constexpr float MASKED = -1e30f;   // the reference's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// shared memory, in bytes from a 1024-byte-aligned base
constexpr int Q_BYTES = BLOCK_M * D * 4;          // 32 KB: float32, or hi + lo
constexpr int OFF_RING = Q_BYTES;
constexpr int SLOT_BYTES = BLOCK_N * D * 4;       // 16 KB: float32, or hi + lo
constexpr int OFF_BAR = OFF_RING + SLOTS * SLOT_BYTES;  // 96 KB
constexpr int SMEM_BYTES = OFF_BAR + 512 + 1024;  // + barriers, alignment

static_assert(BLOCK_M % 8 == 0 && BLOCK_N % 16 == 0, "whole groups, k-steps");
static_assert(SLOTS % 2 == 0, "k tiles in even slots, v tiles in odd");
static_assert(PRODUCER_REGS + CONSUMER_REGS == 2 * 128,
              "setmaxnreg redistributes the launch's 128 registers");
static_assert(BLOCKS_PER_SM * (SMEM_BYTES + 1024) <= 233472,
              "BLOCKS_PER_SM blocks fit the SM's shared memory");

struct Bars {
  uint64_t q_raw;           // q's float32 tile landed
  uint64_t q_full;          // its halves written
  uint64_t raw[SLOTS];      // a slot's float32 tile landed
  uint64_t full[SLOTS];     // its halves written
  uint64_t empty[SLOTS];    // the consumer is done with them: refill
};
static_assert(sizeof(Bars) <= 512, "the barriers' room");

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
flash_fwd_f32_d128_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                float* __restrict__ o,
                                float* __restrict__ lse, int b0, int tq,
                                int tk, float scale, int causal) {
  using W = Wgmma<bf16>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* qg = reinterpret_cast<bf16*>(base);  // group-interleaved hi + lo
  unsigned char* ring = base + OFF_RING;
  Bars& bar = *reinterpret_cast<Bars*>(base + OFF_BAR);

  const int tid = threadIdx.x;
  // the warpgroup, from lane 0: uniform in a warp to the compiler
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BLOCK_M;  // heaviest first
  const int bh = b0 + blockIdx.y;

  // causal: key j is visible to row i iff j <= i + offset. A k tile
  // wholly right of the last row's limit adds exactly zero and is not
  // visited; a block holding a fully masked row (q0 + offset < 0)
  // visits every tile, as the reference averages V over all keys there.
  const int offset = tk - tq;
  int n_tiles = (tk + BLOCK_N - 1) / BLOCK_N;
  if (causal && q0 + offset >= 0)
    n_tiles = min(n_tiles, (q0 + BLOCK_M - 1 + offset) / BLOCK_N + 1);

  if (tid == 0) {
    mbar_init(&bar.q_raw, 1);
    mbar_init(&bar.q_full, SPLITTERS);     // every splitter thread
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&bar.raw[s], 1);
      mbar_init(&bar.full[s], SPLITTERS);
      mbar_init(&bar.empty[s], 128);       // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  // k_t (j = 2 t) and v_t (j = 2 t + 1) into their ring slot, landing on
  // its raw barrier
  auto load = [&](int j) {
    const int slot = j % SLOTS;
    mbar_expect_tx(&bar.raw[slot], SLOT_BYTES);
    tma_load_3d(ring + slot * SLOT_BYTES, (j & 1) ? &tm_v : &tm_k,
                &bar.raw[slot], 0, (j >> 1) * BLOCK_N, bh);
  };

  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    // q and the ring's first round; the consumer issues each refill as
    // it frees a slot
    if (tid == 0) {
      mbar_expect_tx(&bar.q_raw, Q_BYTES);
      tma_load_3d(base, &tm_q, &bar.q_raw, 0, q0, bh);
      for (int j = 0; j < min(SLOTS, 2 * n_tiles); ++j) load(j);
    }
    // ---- the splitters: warp sw takes 8-row groups sw, sw + 4, ... ----
    const int sw = tid >> 5, lane = tid & 31;
    mbar_wait(&bar.q_raw, 0);
    for (int g = sw; g < BLOCK_M / 8; g += SPLITTERS / 32)
      split_group_in_place<D>(reinterpret_cast<float*>(base), g, lane);
    // the halves visible to wgmma
    fence_proxy_async();
    mbar_arrive(&bar.q_full);
    for (int j = 0; j < 2 * n_tiles; ++j) {
      const int slot = j % SLOTS;
      mbar_wait(&bar.raw[slot], (j / SLOTS) & 1);
      float* tile = reinterpret_cast<float*>(ring + slot * SLOT_BYTES);
      for (int g = sw; g < BLOCK_N / 8; g += SPLITTERS / 32)
        split_group_in_place<D>(tile, g, lane);
      fence_proxy_async();
      mbar_arrive(&bar.full[slot]);
    }
    return;
  }

  // ---- the consumer: the block's 64 rows ----
  setmaxnreg_inc<CONSUMER_REGS>();
  const int ct = tid - 128;               // thread within the warpgroup
  const int warp = ct >> 5, lane = ct & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int row_a = q0 + 16 * warp + g;   // this lane's rows: row_a, + 8
  // scores in base 2: x = S log2(e), masked at MASKED log2(e), so that
  // lse = m ln(2) + ln(l) is the reference's m + log(l)
  const float scale2 = scale * LOG2E;
  const float masked2 = MASKED * LOG2E;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  // this thread is done with tile j's slot; once every consumer thread
  // is, the first refills it with tile j + SLOTS
  auto release = [&](int j) {
    mbar_arrive(&bar.empty[j % SLOTS]);
    if (ct == 0 && j + SLOTS < 2 * n_tiles) {
      mbar_wait(&bar.empty[j % SLOTS], (j / SLOTS) & 1);
      load(j + SLOTS);
    }
  };

  mbar_wait(&bar.q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int jk = 2 * t, jv = 2 * t + 1;
    const int sk = jk % SLOTS, sv = jv % SLOTS;
    const int k0 = t * BLOCK_N;
    const bf16* kg = reinterpret_cast<const bf16*>(ring + sk * SLOT_BYTES);
    const bf16* vg = reinterpret_cast<const bf16*>(ring + sv * SLOT_BYTES);
    mbar_wait(&bar.full[sk], (jk / SLOTS) & 1);
    // S = Q K^T over D = 128 (k-steps 4-7 in the second column block),
    // each product as lo hi + hi lo + hi hi
    float s[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int o = (kk >> 2) * CBLOCK_ELEMS + (kk & 3) * 16;
      W::ss32(s, desc_k_major(qg + LO_ELEMS_D128 + o, GROUP_BYTES_D128),
              desc_k_major(kg + o, GROUP_BYTES_D128), kk != 0);
      W::ss32(s, desc_k_major(qg + o, GROUP_BYTES_D128),
              desc_k_major(kg + LO_ELEMS_D128 + o, GROUP_BYTES_D128), 1);
      W::ss32(s, desc_k_major(qg + o, GROUP_BYTES_D128),
              desc_k_major(kg + o, GROUP_BYTES_D128), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 16; ++i) reg_fence(s[i]);
    release(jk);  // this thread is done with k's slot
    // the mask, only where the ragged end or the diagonal crosses; a
    // scale below 0 also scales S first, since it turns the raw row
    // maxima into the minima
    const bool edge = scale2 < 0.f || k0 + BLOCK_N > tk ||
                      (causal && k0 + BLOCK_N - 1 > q0 + offset);
    float mx[2] = {-INFINITY, -INFINITY};
    // an unmasked tile keeps S raw: its row maxima are scaled once
    // (scale2 >= 0 here keeps them the maxima) and x - m is one fma below
    const float sc = edge ? 1.f : scale2;
    if (edge) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int j = i >> 2, e = i & 3;
        float x = s[i] * scale2;
        const int col = k0 + 8 * j + 2 * tg + (e & 1);
        const int row = row_a + (e >> 1) * 8;
        if (col >= tk)
          x = -INFINITY;  // not a key at all
        else if (causal && row + offset < col)
          x = masked2;
        s[i] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      mx[0] *= scale2;
      mx[1] *= scale2;
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: the tile holds a key
      corr[r] = ex2_ftz(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= corr[(i >> 1) & 1];
    // P = 2^(x - m) as the A operand of O += P V, hi and lo halves:
    // k-step kk (16 keys) takes accumulator blocks 2 kk, 2 kk + 1
    uint32_t ph[2][4], pl[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* sj = s + 4 * (2 * kk + h);
        const float p0 = ex2_ftz(fmaf(sj[0], sc, -m[0]));
        const float p1 = ex2_ftz(fmaf(sj[1], sc, -m[0]));
        const float p2 = ex2_ftz(fmaf(sj[2], sc, -m[1]));
        const float p3 = ex2_ftz(fmaf(sj[3], sc, -m[1]));
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        split_pack<bf16>(p0, p1, ph[kk][2 * h], pl[kk][2 * h]);
        split_pack<bf16>(p2, p3, ph[kk][2 * h + 1], pl[kk][2 * h + 1]);
      }
    }
    mbar_wait(&bar.full[sv], (jv / SLOTS) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      // 16 keys: two 8-row groups of the interleaved tile, each product
      // over both column blocks of V's piece
      const int o = kk * 2 * GROUP_ELEMS_D128;
      const uint64_t dvh =
          desc_mn_major(vg + o, CBLOCK_BYTES, GROUP_BYTES_D128);
      const uint64_t dvl = desc_mn_major(vg + LO_ELEMS_D128 + o, CBLOCK_BYTES,
                                         GROUP_BYTES_D128);
      W::rs128(acc, pl[kk], dvh);
      W::rs128(acc, ph[kk], dvl);
      W::rs128(acc, ph[kk], dvh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    // the registers the products read and wrote are settled only now
#pragma unroll
    for (int i = 0; i < 64; ++i) reg_fence(acc[i]);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        reg_fence(ph[kk][r]);
        reg_fence(pl[kk][r]);
      }
    }
    release(jv);  // this thread is done with v's slot
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float safe_l = l[r] == 0.f ? 1.f : l[r];
    inv[r] = 1.f / safe_l;
    const int row = row_a + 8 * r;
    if (tg == 0 && row < tq)
      lse[(long long)bh * tq + row] = m[r] * LN2 + logf(safe_l);
  }
  float* ob = o + (long long)bh * tq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * tg;
    if (row_a < tq)
      *reinterpret_cast<float2*>(ob + (long long)row_a * D + col) =
          make_float2(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
    if (row_a + 8 < tq)
      *reinterpret_cast<float2*>(ob + (long long)(row_a + 8) * D + col) =
          make_float2(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
  }
}

// the kernel's shared-memory attributes: the dynamic size, and the
// carveout that gives shared memory the most of the SM's 256 KB
cudaError_t set_attributes() {
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32_d128_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_fwd_f32_d128_wgmma_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int tq, int tk, float scale, int causal,
           cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = make_map_f32<D>(&mq, q, bh, tq, BLOCK_M);
  if (!err) err = make_map_f32<D>(&mk, k, bh, tk, BLOCK_N);
  if (!err) err = make_map_f32<D>(&mv, v, bh, tk, BLOCK_N);
  if (err) return err;
  const cudaError_t e = set_attributes();
  if (e != cudaSuccess) return (int)e;
  return for_bh_chunks(bh, [&](int b0, int n) {
    const dim3 grid((tq + BLOCK_M - 1) / BLOCK_M, n);
    flash_fwd_f32_d128_wgmma_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
        mq, mk, mv, static_cast<float*>(o), lse, b0, tq, tk, scale, causal);
  });
}

}  // namespace

// dtype: 0 float32 (bf16 and fp16 are flash_fwd_d128_wgmma.cu's); d: 128.
// q: [bh, tq, 128]; k, v: [bh, tk, 128]; o like q; lse: [bh, tq] float32.
// All contiguous, 16-byte aligned, on the current device. Returns the
// CUDA error code of the launch (0 = ok).
extern "C" int flash_fwd_f32_d128_wgmma(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int bh, int tq, int tk, int d,
                                        int dtype, float scale, int causal,
                                        void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || d != D || dtype != 0)
    return (int)cudaErrorInvalidValue;
  return launch(q, k, v, o, lse, bh, tq, tk, scale, causal,
                static_cast<cudaStream_t>(stream));
}

// the blocks of the kernel resident on one SM at its dynamic shared
// memory, as the card's occupancy calculator counts them (BLOCKS_PER_SM
// by design), or -1 with a CUDA error
extern "C" int flash_fwd_f32_d128_wgmma_blocks_per_sm(void) {
  int n = 0;
  if (set_attributes() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, flash_fwd_f32_d128_wgmma_kernel, THREADS, SMEM_BYTES) !=
          cudaSuccess)
    return -1;
  return n;
}
