// Flash-attention backward dQ for float32 at head dim 128 on Hopper's
// warpgroup tensor cores (sm_90a: wgmma, TMA, a producer warpgroup that
// splits), one block an SM, plain C interface. Head dim 64 runs
// flash_bwd_dq_f32_d64_wgmma.cu, head dim 256
// flash_bwd_dq_f32_d256_wgmma.cu, the head dims past 256
// flash_bwd_dq_f32mma.cu in 128-column slices; bf16 and fp16 run
// flash_bwd_dq_d128_wgmma.cu at this head dim.
//
// Replaces paddle_tpu/ops/pallas_attention.py:223 _fa_bwd_dq_kernel
// (with _recompute_ds, :161; the first pallas_call of _flash_bwd_pallas,
// :252) on the float32 route at D = 128, the head dim of the Llama
// width's float32 training-parity steps and float32 pipeline stage. Per
// (batch*head) slice of q, do [tq, 128] and k, v [tk, 128] it computes
//   P  = exp(S - lse), S = (Q K^T) * scale   (lse from the forward, K1)
//   dS = P o (dO V^T - delta) * scale         (delta per q row, from the
//                                              caller: rowsum(dO o O) - dlse)
//   dQ = sum_k dS K                           (float32)
// with jax.vjp of _ref_attention_lse's semantics: causal masking is
// bottom-right (key j visible to row i iff j <= i + tk - tq), masked
// entries and keys >= tk have dS = 0, a fully masked row (causal,
// tq > tk) has dS = 0 on every key and so dQ = 0 (recognised by its
// index), rows >= tq are never written.
//
// Precision: the float32 warpgroup K2s' pieces (D = 64 and 256), which
// tests/test_torch_f32_split.py chose at D = 128 over the mma.sync
// kernel's 3xTF32 dP: both keep dQ under half the float32 tier's limit
// on every D = 128 case (T 32 at B*H past gridDim.y's limit among them,
// where the pieces read up to 0.44 and two pieces of dO 0.77), the
// pieces at five bf16 products for dP where 3xTF32 costs six at the
// TF32 rate's half, and in half the shared memory (TF32 halves take 8
// bytes an element: V alone 64 KB a 64-key stage):
//   S  = Q K^T: 3 products of hi + lo halves (lo hi, hi lo, hi hi);
//   dP = dO V^T: dO in three pieces (hi, mid, lo) and V in two, five
//        products (dropping what is below ~2^-24 of the product);
//   dQ = dS K: 3 products of halves, dS's from registers, K's read
//        MN-major.
//
// What bounds it on the H100: at the training-parity shape (B*H 8,
// T 256, causal) it moves 5.3 MB (q, k, v, dO, lse, delta in; dQ out),
// 0.0016 ms at 3.35 TB/s: 32 blocks on 132 SMs, so latency in fact. At
// the pipeline stage's float32 shape (B*H 32, T 512, causal) 42 MB,
// 0.013 ms, against 8.6 GFLOP of useful products (6 D FLOP per visible
// pair) at their splits' rates (three, five and three bf16 products:
// 0.024 ms): operations. At B*H 2*32, T 2048 (causal) 103 GFLOP, 0.383
// ms at those rates (0.417 ms had dP kept the mma.sync kernel's
// 3xTF32), against 0.10 ms of bytes: operations bound it there.
//
// Design (flash_bwd_dq_f32_d64_wgmma.cu's loop at D = 128; one block an
// SM, as the shared memory below leaves no room for a second):
// - one block of two warpgroups per (bh, 64-row q tile), heaviest tile
//   first. Warpgroup 0 is the producer: its thread 0 issues the TMA
//   loads of q, dO and the ring's first round (the last slot once dO's
//   float32 tile in it is split), and its four warps split what lands.
//   Warpgroup 1 is the consumer, the block's 64 rows; its thread 0
//   issues each refill as soon as every consumer thread has released
//   the slot. With 256 threads on the SM each may hold 255 registers, so
//   the kernel needs no setmaxnreg (__launch_bounds__(256, 1)).
// - TMA (3-D float32 tensor maps over [bh, t, 128], unswizzled boxes of
//   64 rows, rows past t zero-filled) brings q's float32 tile into q's
//   own 32 KB, dO's into the ring's last slot, then each 64-key v and k
//   tile into a slot of a four-slot ring (v_t, k_t, v_t+1, k_t+1): two
//   stages of a v and a k tile. q, k and v are split in place into
//   group-interleaved hi + lo tiles (wgmma_sm90.cuh: an 8-row group of
//   the float32 tile, 4096 bytes, holds its two pieces' two column
//   blocks each), a splitter warp a group at a time with 32 values a
//   lane; dO goes into three dense swizzled pieces beside them. The
//   splitters fence (fence.proxy.async) before handing a tile to wgmma,
//   which reads through the async proxy; a slot has raw, full and empty
//   mbarriers.
// - shared memory: q 32 KB, dO's pieces 48 KB, the ring 4 x 32 KB:
//   208 KB of the 227 KB. 32-key stages would take 144 KB, still past
//   the ~113 KB a block that two blocks leave.
// - S = Q K^T (24 wgmma m64n64k16) and dP = dO V^T (40) run from shared
//   memory in one group; dS = P o (dP - delta) scale is formed in dP's
//   registers (P = 2^(S scale log2(e) - lse log2(e)) as one fma and
//   ex2.approx.ftz), split into hi and lo halves as the A operand of
//   dQ += dS K (12 wgmma m64n128k16, k's halves read MN-major, two
//   column blocks CBLOCK_BYTES apart). dQ (64 x 128 float32, 64
//   registers a thread) stays in registers for the whole key loop; no
//   atomics. The consumer waits for each group on the path that issued
//   it (ptxas serializes every wgmma otherwise, C7518).
// - registers: ptxas reports 155 a thread and 0 bytes of spill (the
//   build log, which chip_smoke.py prints with any spill it reports:
//   none is allowed).
// - causal: k tiles wholly right of the block's last row are not
//   visited (a block of fully masked rows visits none and writes
//   zeros); the mask runs only on tiles the diagonal or the ragged end
//   crosses. dQ goes from the accumulators to global memory as float2
//   pairs. B*H past gridDim.y's limit is launched in chunks.
//
// What it leaves: overlapping one tile's dQ += dS K with the next
// tile's S and dP inside the block (a second consumer, or the next
// tile's products issued before this tile's dS); splitting k and v once
// a head instead of once a block (every q tile of a head splits the k
// and v tiles it visits again); fusing dQ into K3's pass.

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

#include <math.h>

namespace {

using namespace wgmma_sm90;
using mma_sm90::for_bh_chunks;
using bf16 = __nv_bfloat16;

constexpr int D = 128;
constexpr int BLOCK_M = 64;   // q rows per block: one consumer warpgroup
constexpr int BLOCK_N = 64;   // keys per k or v tile
constexpr int SLOTS = 4;      // ring of k / v tiles: v_t, k_t in turn
constexpr int THREADS = 2 * 128;
constexpr int SPLITTERS = 128;     // the producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// shared memory, in bytes from a 1024-byte-aligned base
constexpr int Q_BYTES = BLOCK_M * D * 4;          // 32 KB: float32, or hi + lo
constexpr int DOP_BYTES = BLOCK_M * D * 2;        // 16 KB a dO piece
constexpr int OFF_DO = Q_BYTES;                   // dO hi, mid, lo
constexpr int OFF_RING = OFF_DO + 3 * DOP_BYTES;  // 80 KB
constexpr int SLOT_BYTES = BLOCK_N * D * 4;       // 32 KB: float32, or hi + lo
constexpr int OFF_BAR = OFF_RING + SLOTS * SLOT_BYTES;  // 208 KB
constexpr int SMEM_BYTES = OFF_BAR + 512 + 1024;  // + barriers, alignment

static_assert(BLOCK_M == BLOCK_N, "one tensor map box for every tile");
static_assert(SLOTS % 2 == 0, "v tiles in even slots, k tiles in odd");
static_assert(SLOT_BYTES == BLOCK_M * D * 4, "dO's float32 tile fits a slot");
static_assert(SMEM_BYTES <= 232448, "a block's shared memory");

struct Bars {
  uint64_t q_raw, do_raw;   // q's / dO's float32 tile landed
  uint64_t qdo_full;        // q's and dO's pieces written
  uint64_t raw[SLOTS];      // a slot's float32 tile landed
  uint64_t full[SLOTS];     // its halves written
  uint64_t empty[SLOTS];    // the consumer is done with them: refill
};
static_assert(sizeof(Bars) <= 512, "the barriers' room");

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_f32_d128_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
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
  bf16* qg = reinterpret_cast<bf16*>(base);  // group-interleaved hi + lo
  bf16* doh = reinterpret_cast<bf16*>(base + OFF_DO);
  bf16* dom = doh + BLOCK_M * D;
  bf16* dol = dom + BLOCK_M * D;
  unsigned char* ring = base + OFF_RING;
  unsigned char* do_f32 = ring + (SLOTS - 1) * SLOT_BYTES;
  Bars& bar = *reinterpret_cast<Bars*>(base + OFF_BAR);

  const int tid = threadIdx.x;
  // the warpgroup, from lane 0: uniform in a warp to the compiler
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
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
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&bar.raw[s], 1);
      mbar_init(&bar.full[s], SPLITTERS);  // every splitter thread
      mbar_init(&bar.empty[s], 128);       // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  // v_t (j = 2 t) and k_t (j = 2 t + 1) into their ring slot, landing on
  // its raw barrier
  auto load = [&](int j) {
    const int slot = j % SLOTS;
    mbar_expect_tx(&bar.raw[slot], SLOT_BYTES);
    tma_load_3d(ring + slot * SLOT_BYTES, (j & 1) ? &tm_k : &tm_v,
                &bar.raw[slot], 0, (j >> 1) * BLOCK_N, bh);
  };

  if (wg == 0) {
    // q, dO and the ring's first round (dO's float32 tile holds the last
    // slot until it is split); the consumer issues each refill as it
    // frees a slot
    const int st = tid, sw = st >> 5, lane = tid & 31;
    if (st == 0) {
      mbar_expect_tx(&bar.q_raw, Q_BYTES);
      tma_load_3d(base, &tm_q, &bar.q_raw, 0, q0, bh);
      mbar_expect_tx(&bar.do_raw, SLOT_BYTES);
      tma_load_3d(do_f32, &tm_do, &bar.do_raw, 0, q0, bh);
      for (int j = 0; j < min(SLOTS - 1, 2 * n_tiles); ++j) load(j);
    }
    // ---- the splitters: warp sw takes 8-row groups sw, sw + 4, ... ----
    mbar_wait(&bar.q_raw, 0);
    for (int g = sw; g < BLOCK_M / 8; g += SPLITTERS / 32)
      split_group_in_place<D>(reinterpret_cast<float*>(base), g, lane);
    mbar_wait(&bar.do_raw, 0);
    split_tile<BLOCK_M, 3, SPLITTERS, D>(
        doh, reinterpret_cast<const float*>(do_f32), st);
    // the pieces visible to wgmma, dO's float32 reads ordered before the
    // TMA that refills its slot
    fence_proxy_async();
    named_sync(1, SPLITTERS);
    if (st == 0) {
      mbar_arrive(&bar.qdo_full);
      if (SLOTS - 1 < 2 * n_tiles) load(SLOTS - 1);
    }
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
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // this thread is done with tile j's slot; once every consumer thread
  // is, the first refills it with tile j + SLOTS
  auto release = [&](int j) {
    mbar_arrive(&bar.empty[j % SLOTS]);
    if (ct == 0 && j + SLOTS < 2 * n_tiles) {
      mbar_wait(&bar.empty[j % SLOTS], (j / SLOTS) & 1);
      load(j + SLOTS);
    }
  };

  mbar_wait(&bar.qdo_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int jv = 2 * t, jk = 2 * t + 1;
    const int sv = jv % SLOTS, sk = jk % SLOTS;
    const int k0 = t * BLOCK_N;
    const bf16* vg = reinterpret_cast<const bf16*>(ring + sv * SLOT_BYTES);
    const bf16* kg = reinterpret_cast<const bf16*>(ring + sk * SLOT_BYTES);
    mbar_wait(&bar.full[sv], (jv / SLOTS) & 1);
    mbar_wait(&bar.full[sk], (jk / SLOTS) & 1);
    // S = Q K^T (lo hi + hi lo + hi hi) and dP = dO V^T (dO's three
    // pieces against V's two, the smallest products first), 64 rows x
    // 64 keys each, over D = 128 (k-steps 4-7 in the second column block)
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int o = (kk >> 2) * CBLOCK_ELEMS + (kk & 3) * 16;
      W::ss64(s, desc_k_major(qg + LO_ELEMS_D128 + o, GROUP_BYTES_D128),
              desc_k_major(kg + o, GROUP_BYTES_D128), kk != 0);
      W::ss64(s, desc_k_major(qg + o, GROUP_BYTES_D128),
              desc_k_major(kg + LO_ELEMS_D128 + o, GROUP_BYTES_D128), 1);
      W::ss64(s, desc_k_major(qg + o, GROUP_BYTES_D128),
              desc_k_major(kg + o, GROUP_BYTES_D128), 1);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int o = (kk >> 2) * CBLOCK_ELEMS + (kk & 3) * 16;
      // dO's dense pieces: column block kk / 4 of 64 rows
      const int od = (kk >> 2) * BLOCK_M * 64 + (kk & 3) * 16;
      const uint64_t dvh = desc_k_major(vg + o, GROUP_BYTES_D128);
      const uint64_t dvl =
          desc_k_major(vg + LO_ELEMS_D128 + o, GROUP_BYTES_D128);
      W::ss64(dp, desc_k_major(dol + od), dvh, kk != 0);
      W::ss64(dp, desc_k_major(dom + od), dvl, 1);
      W::ss64(dp, desc_k_major(doh + od), dvl, 1);
      W::ss64(dp, desc_k_major(dom + od), dvh, 1);
      W::ss64(dp, desc_k_major(doh + od), dvh, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      reg_fence(s[i]);
      reg_fence(dp[i]);
    }
    release(jv);  // this thread is done with v's slot
    // dS = P o (dP - delta) scale in place of dP, 0 where masked (keys
    // >= tk, right of the diagonal, every key of a fully masked row, whose
    // lse of -1e30 makes P infinite: a select, not a product);
    // the mask only where the ragged end or the diagonal crosses
    const bool edge = k0 + BLOCK_N > tk ||
                      (causal && k0 + BLOCK_N - 1 > q0 + offset);
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
    // dS as the A operand of dQ += dS K, hi and lo halves: k-step kk (16
    // keys) takes accumulator blocks 2 kk, 2 kk + 1
    uint32_t dh[4][4], dlo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* xj = dp + 4 * (2 * kk + h);
        split_pack<bf16>(xj[0], xj[1], dh[kk][2 * h], dlo[kk][2 * h]);
        split_pack<bf16>(xj[2], xj[3], dh[kk][2 * h + 1],
                         dlo[kk][2 * h + 1]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // 16 keys: two 8-row groups of the interleaved tile, each product
      // over both column blocks of K's piece
      const int o = kk * 2 * GROUP_ELEMS_D128;
      const uint64_t dkh =
          desc_mn_major(kg + o, CBLOCK_BYTES, GROUP_BYTES_D128);
      const uint64_t dkl = desc_mn_major(kg + LO_ELEMS_D128 + o, CBLOCK_BYTES,
                                         GROUP_BYTES_D128);
      W::rs128(acc, dlo[kk], dkh);
      W::rs128(acc, dh[kk], dkl);
      W::rs128(acc, dh[kk], dkh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    // the registers the products read and wrote are settled only now
#pragma unroll
    for (int i = 0; i < 64; ++i) reg_fence(acc[i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        reg_fence(dh[kk][h]);
        reg_fence(dlo[kk][h]);
      }
    }
    release(jk);  // this thread is done with k's slot
  }

  float* ob = dq + (long long)bh * tq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * tg;
    if (row_a < tq)
      *reinterpret_cast<float2*>(ob + (long long)row_a * D + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (row_a + 8 < tq)
      *reinterpret_cast<float2*>(ob + (long long)(row_a + 8) * D + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// the kernel's shared-memory attributes: the dynamic size, and the
// carveout that gives shared memory the most of the SM's 256 KB
cudaError_t set_attributes() {
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_f32_d128_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dq_f32_d128_wgmma_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
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
  int err = make_map_f32<D>(&mq, a.q, a.bh, a.tq, BLOCK_M);
  if (!err) err = make_map_f32<D>(&mdo, a.dout, a.bh, a.tq, BLOCK_M);
  if (!err) err = make_map_f32<D>(&mk, a.k, a.bh, a.tk, BLOCK_N);
  if (!err) err = make_map_f32<D>(&mv, a.v, a.bh, a.tk, BLOCK_N);
  if (err) return err;
  const cudaError_t e = set_attributes();
  if (e != cudaSuccess) return (int)e;
  return for_bh_chunks(a.bh, [&](int b0, int n) {
    const dim3 grid((a.tq + BLOCK_M - 1) / BLOCK_M, n);
    flash_bwd_dq_f32_d128_wgmma_kernel<<<grid, THREADS, SMEM_BYTES,
                                         a.stream>>>(
        mq, mk, mv, mdo, a.lse, a.delta, static_cast<float*>(a.dq), b0,
        a.tq, a.tk, a.scale, a.causal);
  });
}

}  // namespace

// dtype: 0 float32 (bf16 and fp16 are flash_bwd_dq_d128_wgmma.cu's); d:
// 128. q, dout, dq: [bh, tq, 128]; k, v: [bh, tk, 128]; lse, delta:
// [bh, tq] float32. All contiguous, 16-byte aligned, on the current
// device. Returns the CUDA error code of the launch (0 = ok).
extern "C" int flash_bwd_dq_f32_d128_wgmma(const void* q, const void* k,
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
