// Flash-attention forward for float32 at head dim 256 on Hopper's
// warpgroup tensor cores (sm_90a: wgmma, TMA, a producer warpgroup),
// plain C interface. Other head dims run flash_fwd_f32mma.cu; bf16 and
// fp16 run flash_fwd_mma.cu and flash_fwd_d256_wgmma.cu.
//
// Replaces paddle_tpu/ops/pallas_attention.py:59 _fa_kernel (launched by
// _flash_fwd_pallas, :111) on the float32 route at D = 256. Per
// (batch*head) slice of q [tq, 256] and k, v [tk, 256] it computes
//   S   = (Q K^T) * scale, causal-masked bottom-right (row + tk - tq >= col)
//   O   = softmax(S) V    by online softmax (running max m, sum l)
//   lse = m + log(l)      (l == 0 -> 1), compact [BH, tq] float32
// with _ref_attention_lse's semantics: masked scores are -1e30 (a fully
// masked row, causal with tq > tk, averages V), keys >= tk are -inf and
// take no part, rows >= tq are never written. O is float32.
//
// Precision: flash_fwd_f32mma.cu's split, kept. The float32 tier (rtol
// 2e-4 / atol 2e-5) is beyond one rounding of the operands to bf16 or
// TF32, so every operand of both products (Q and K in S = Q K^T, P and V
// in P V) is split into bf16 halves x = hi + lo (hi = bf16(x), lo =
// bf16(x - hi)) and each product is taken as three wgmma, lo hi + hi lo
// + hi hi; the dropped lo lo is ~2^-18 of the product
// (tests/test_torch_f32_split.py emulates it: O and lse <= 0.27 of the
// tier's limit). A 3xTF32 split would run at half the rate and need V
// transposed in shared memory: wgmma reads an MN-major B operand only
// in 16-bit types.
//
// What bounds it on the H100: at the head_dim_256 float32 train step's
// shape (B*H = 1*16, T = 256, D = 256, causal) it moves 16.8 MB (q, k, v
// in; o, lse out), 0.0050 ms at 3.35 TB/s, against 0.54 GFLOP of useful
// products (4 D FLOP per visible pair), 0.0016 ms with every product at
// the 3xbf16 rate (a third of 989 TFLOP/s). Memory bounds it. That shape
// has 64 blocks of 64 rows, under one wave of the 132 SMs: the time is
// one block's walk over its key tiles, which the design keeps the
// tensor cores and the copies overlapped on.
//
// Design:
// - one block of two warpgroups per (bh, 64-row q tile), heaviest tile
//   first. Warpgroup 0 is the producer: one of its threads issues every
//   TMA load, and all 128 split what lands. Warpgroup 1 is the
//   consumer, the block's 64 rows. Two warpgroups fit the register file
//   at the launch's count (up to 255 a thread x 256 threads), so no
//   setmaxnreg moves registers between them.
// - TMA (cp.async.bulk.tensor, 3-D float32 tensor maps over [bh, t,
//   256], unswizzled boxes of 32 rows x 256 columns, rows past t
//   zero-filled) brings q (two boxes) and then each 32-key k and v tile
//   as float32 into a two-buffer staging ring, so that the next box is
//   in flight while the producer splits the last one. The producer
//   splits each element once into bf16 hi and lo, written in wgmma's
//   128-byte-swizzled layout: q into resident hi and lo tiles, k and v
//   into a ring of three slots (a slot is one k or v tile's hi and lo),
//   each on full / empty mbarriers, after a proxy fence (wgmma reads
//   shared memory through the async proxy).
// - shared memory: q hi + lo 64 x 256 x 2 x 2 B = 64 KB, staging 2 x 32
//   KB, slots 3 x 32 KB: 224 KB of the 227 KB.
// - S = Q K^T runs once a k tile over the whole 256-wide head: 48 wgmma
//   m64n32k16 (16 k-steps x 3 products), both operands from shared
//   memory. No slice recomputes it (the sliced D = 128 route took the
//   3-product Q K^T twice, each slice's q and k split afresh from
//   global memory). The consumer releases k's slot as soon as S is in.
// - the online softmax runs in base 2 in float32 registers; P is split
//   in registers (split_pack) into the A operand of O += P V, wgmma
//   m64n256k16 with V hi and lo read MN-major from their slot: 2
//   k-steps x 3 products. O (64 x 256 float32, 128 registers a thread)
//   stays in the consumer's registers for the whole key loop.
// - registers: ptxas (CUDA 12.9): 179 a thread, no spill.
// - causal: k tiles wholly right of the block's last row are not
//   visited; a block holding a fully masked row visits every tile; the
//   elementwise mask runs only on tiles the diagonal or the ragged end
//   crosses.
// - O goes from the accumulators to global memory as float2 pairs.
//
// What it leaves: 128-row blocks (two consumers would need 128 KB of q
// halves); splitting k and v once a head instead of once a block (four
// blocks of a head split the same tiles at T = 256); reading GQA KV
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
constexpr int BLOCK_N = 32;   // keys per k or v tile
constexpr int SLOTS = 3;      // ring of split k / v tiles
constexpr int THREADS = 2 * 128;
constexpr float MASKED = -1e30f;  // the reference's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// shared memory, in bytes from a 1024-byte-aligned base
constexpr int STAGE_ROWS = 32;                        // rows of a TMA box
constexpr int STAGE_BYTES = STAGE_ROWS * D * 4;       // 32 KB float32
constexpr int QH_BYTES = BLOCK_M * D * 2;             // 32 KB a q half
constexpr int HALF_BYTES = BLOCK_N * D * 2;           // 16 KB a k / v half
constexpr int SLOT_BYTES = 2 * HALF_BYTES;            // hi and lo
constexpr int OFF_QL = QH_BYTES;
constexpr int OFF_STAGE = 2 * QH_BYTES;
constexpr int OFF_SLOT = OFF_STAGE + 2 * STAGE_BYTES;
constexpr int OFF_BAR = OFF_SLOT + SLOTS * SLOT_BYTES;  // 224 KB
constexpr int SMEM_BYTES = OFF_BAR + 128 + 1024;        // + barriers, alignment

static_assert(BLOCK_N == STAGE_ROWS, "a k or v tile is one staging box");
static_assert(BLOCK_M % STAGE_ROWS == 0, "q is whole staging boxes");
constexpr int Q_PIECES = BLOCK_M / STAGE_ROWS;

struct Bars {
  uint64_t staged[2];     // a staging buffer's TMA box landed
  uint64_t q_full;        // q hi and lo written
  uint64_t full[SLOTS];   // a slot's hi and lo written
  uint64_t empty[SLOTS];  // the consumer is done with a slot
};

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_f32_d256_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                float* __restrict__ o,
                                float* __restrict__ lse, int b0, int tq,
                                int tk, float scale, int causal) {
  using W = Wgmma<bf16>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* qh = reinterpret_cast<bf16*>(base);
  bf16* ql = reinterpret_cast<bf16*>(base + OFF_QL);
  float* stage = reinterpret_cast<float*>(base + OFF_STAGE);
  bf16* slots = reinterpret_cast<bf16*>(base + OFF_SLOT);
  Bars& bar = *reinterpret_cast<Bars*>(base + OFF_BAR);

  const int tid = threadIdx.x, wg = tid >> 7;
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
    for (int b = 0; b < 2; ++b) mbar_init(&bar.staged[b], 1);
    mbar_init(&bar.q_full, 1);
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&bar.full[s], 1);
      mbar_init(&bar.empty[s], 128);  // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: q's boxes, then k and v of each tile in turn ----
    const int n_pieces = Q_PIECES + 2 * n_tiles;
    // piece p into staging buffer p % 2 (thread 0 only)
    auto issue = [&](int p) {
      float* buf = stage + (p & 1) * STAGE_ROWS * D;
      mbar_expect_tx(&bar.staged[p & 1], STAGE_BYTES);
      if (p < Q_PIECES) {
        tma_load_3d(buf, &tm_q, &bar.staged[p & 1], 0,
                    q0 + p * STAGE_ROWS, bh);
      } else {
        const int j = p - Q_PIECES;
        tma_load_3d(buf, (j & 1) ? &tm_v : &tm_k, &bar.staged[p & 1], 0,
                    (j >> 1) * BLOCK_N, bh);
      }
    };
    if (tid == 0) issue(0);
    for (int p = 0; p < n_pieces; ++p) {
      // buffer (p + 1) % 2 was last read by piece p - 1, whose split
      // ended at the barrier below
      if (tid == 0 && p + 1 < n_pieces) issue(p + 1);
      mbar_wait(&bar.staged[p & 1], (p >> 1) & 1);
      const float* buf = stage + (p & 1) * STAGE_ROWS * D;
      // each element x into hi = bf16(x) and lo = bf16(x - hi), written
      // swizzled into q's rows or a slot
      if (p < Q_PIECES) {
        split_tile<BLOCK_M, 2, 128>(qh, buf, tid, STAGE_ROWS,
                                    p * STAGE_ROWS);
      } else {
        const int j = p - Q_PIECES, slot = j % SLOTS, round = j / SLOTS;
        mbar_wait(&bar.empty[slot], (round & 1) ^ 1);
        split_tile<BLOCK_N, 2, 128>(slots + slot * (SLOT_BYTES / 2), buf,
                                    tid);
      }
      // the split's writes visible to wgmma, the buffer's reads ordered
      // before the TMA that refills it
      fence_proxy_async();
      named_sync(1, 128);
      if (tid == 0) {
        if (p == Q_PIECES - 1)
          mbar_arrive(&bar.q_full);
        else if (p >= Q_PIECES)
          mbar_arrive(&bar.full[(p - Q_PIECES) % SLOTS]);
      }
    }
    return;
  }

  // ---- consumer: the block's 64 rows ----
  const int ct = tid - 128;               // thread within the warpgroup
  const int warp = ct >> 5, lane = ct & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int row_a = q0 + 16 * warp + g;   // this lane's rows: row_a, + 8
  // scores in base 2: x = S log2(e), masked at MASKED log2(e), so that
  // lse = m ln(2) + ln(l) is the reference's m + log(l)
  const float scale2 = scale * LOG2E;
  const float masked2 = MASKED * LOG2E;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  mbar_wait(&bar.q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int jk = 2 * t, jv = 2 * t + 1;
    const int sk = jk % SLOTS, sv = jv % SLOTS;
    const int k0 = t * BLOCK_N;
    const bf16* kh = slots + sk * (SLOT_BYTES / 2);
    const bf16* kl = kh + BLOCK_N * D;
    mbar_wait(&bar.full[sk], (jk / SLOTS) & 1);
    // S = Q K^T over D = 256, each product as lo hi + hi lo + hi hi
    float s[16];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int qo = c * BLOCK_M * 64 + kk * 16;
        const int ko = c * BLOCK_N * 64 + kk * 16;
        W::ss32(s, desc_k_major(ql + qo), desc_k_major(kh + ko),
                (c | kk) != 0);
        W::ss32(s, desc_k_major(qh + qo), desc_k_major(kl + ko), 1);
        W::ss32(s, desc_k_major(qh + qo), desc_k_major(kh + ko), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 16; ++i) reg_fence(s[i]);
    mbar_arrive(&bar.empty[sk]);  // this thread is done with k's slot
    // the mask, only where the ragged end or the diagonal crosses
    const bool edge = k0 + BLOCK_N > tk ||
                      (causal && k0 + BLOCK_N - 1 > q0 + offset);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = i >> 2, e = i & 3;
      float x = s[i] * scale2;
      if (edge) {
        const int col = k0 + 8 * j + 2 * tg + (e & 1);
        const int row = row_a + (e >> 1) * 8;
        if (col >= tk)
          x = -INFINITY;  // not a key at all
        else if (causal && row + offset < col)
          x = masked2;
      }
      s[i] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: the tile holds a key
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] *= corr[(i >> 1) & 1];
    // P = 2^(x - m) as the A operand of O += P V, hi and lo halves:
    // k-step kk (16 keys) takes accumulator blocks 2 kk, 2 kk + 1
    uint32_t ph[BLOCK_N / 16][4], pl[BLOCK_N / 16][4];
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* sj = s + 4 * (2 * kk + h);
        const float p0 = exp2f(sj[0] - m[0]), p1 = exp2f(sj[1] - m[0]);
        const float p2 = exp2f(sj[2] - m[1]), p3 = exp2f(sj[3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        split_pack<bf16>(p0, p1, ph[kk][2 * h], pl[kk][2 * h]);
        split_pack<bf16>(p2, p3, ph[kk][2 * h + 1], pl[kk][2 * h + 1]);
      }
    }
    const bf16* vh = slots + sv * (SLOT_BYTES / 2);
    const bf16* vl = vh + BLOCK_N * D;
    mbar_wait(&bar.full[sv], (jv / SLOTS) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      const uint64_t dvh =
          desc_mn_major(vh + kk * 16 * 64, BLOCK_N * 64 * sizeof(bf16));
      const uint64_t dvl =
          desc_mn_major(vl + kk * 16 * 64, BLOCK_N * 64 * sizeof(bf16));
      W::rs256(acc, pl[kk], dvh);
      W::rs256(acc, ph[kk], dvl);
      W::rs256(acc, ph[kk], dvh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    // the registers the products read and wrote are settled only now
#pragma unroll
    for (int i = 0; i < 128; ++i) reg_fence(acc[i]);
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        reg_fence(ph[kk][r]);
        reg_fence(pl[kk][r]);
      }
    }
    mbar_arrive(&bar.empty[sv]);  // this thread is done with v's slot
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
  for (int j = 0; j < 32; ++j) {
    const int col = 8 * j + 2 * tg;
    if (row_a < tq)
      *reinterpret_cast<float2*>(ob + (long long)row_a * D + col) =
          make_float2(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
    if (row_a + 8 < tq)
      *reinterpret_cast<float2*>(ob + (long long)(row_a + 8) * D + col) =
          make_float2(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
  }
}

int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int tq, int tk, float scale, int causal,
           cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = make_map_f32(&mq, q, bh, tq, STAGE_ROWS);
  if (!err) err = make_map_f32(&mk, k, bh, tk, STAGE_ROWS);
  if (!err) err = make_map_f32(&mv, v, bh, tk, STAGE_ROWS);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32_d256_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  return for_bh_chunks(bh, [&](int b0, int n) {
    const dim3 grid((tq + BLOCK_M - 1) / BLOCK_M, n);
    flash_fwd_f32_d256_wgmma_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
        mq, mk, mv, static_cast<float*>(o), lse, b0, tq, tk, scale, causal);
  });
}

}  // namespace

// dtype: 0 float32 (bf16 and fp16 are flash_fwd_mma.cu's and
// flash_fwd_d256_wgmma.cu's); d: 256. q: [bh, tq, 256]; k, v: [bh, tk,
// 256]; o like q; lse: [bh, tq] float32. All contiguous, 16-byte
// aligned, on the current device. Returns the CUDA error code of the
// launch (0 = ok).
extern "C" int flash_fwd_f32_d256_wgmma(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int bh, int tq, int tk, int d,
                                        int dtype, float scale, int causal,
                                        void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || d != D || dtype != 0)
    return (int)cudaErrorInvalidValue;
  return launch(q, k, v, o, lse, bh, tq, tk, scale, causal,
                static_cast<cudaStream_t>(stream));
}
