// Flash-attention forward at head dim 128 on Hopper's warpgroup tensor
// cores (sm_90a: wgmma, TMA, warp specialisation), bf16 and fp16, plain
// C interface. Head dim 64, the sliced head dims past 256 and float32
// run flash_fwd_mma.cu and flash_fwd_f32mma.cu; head dim 256 runs
// flash_fwd_d256_wgmma.cu.
//
// Replaces paddle_tpu/ops/pallas_attention.py:59 _fa_kernel (launched by
// _flash_fwd_pallas, :111) at D = 128. Per (batch*head) slice of
// q [tq, 128] and k, v [tk, 128] it computes
//   S   = (Q K^T) * scale, causal-masked bottom-right (row + tk - tq >= col)
//   O   = softmax(S) V    by online softmax (running max m, sum l)
//   lse = m + log(l)      (l == 0 -> 1), compact [BH, tq] float32
// with _ref_attention_lse's semantics: masked scores are -1e30 (a fully
// masked row, causal with tq > tk, averages V), keys >= tk are -inf and
// take no part, rows >= tq are never written.
//
// What bounds it on the H100: at the Llama training shape (B*H = 2*32,
// T = 2048, D = 128, causal) it does 68.8 GFLOP of useful products
// (4 D FLOP per visible (row, key) pair) against 135 MB moved: the bf16
// tensor-core rate, 0.070 ms. At the serving shapes (B*H = 4*32, T 128
// and 256) it moves 17 and 34 MB for 0.6 and 2.2 GFLOP: memory, 0.005
// and 0.010 ms, below a launch's host time (15-28 us on the H100's host
// in chip_smoke.py, the three tensor maps encoded each call within its
// noise).
//
// Design (FlashAttention-3's structure, simplified):
// - one block of three warpgroups per (bh, 128-row q tile), heaviest
//   tile first. Warpgroup 0 is the producer: after setmaxnreg gives its
//   registers away (24 a thread), one thread issues every TMA load.
//   Warpgroups 1 and 2 are the consumers, 64 q rows each, at 240
//   registers a thread.
// - TMA (cp.async.bulk.tensor, 3-D tensor maps over [bh, t, 128] with
//   the 128-byte swizzle, rows past t zero-filled) brings the q tile
//   once and the k and v tiles through a two-stage ring of 128 keys,
//   each completing on its own mbarrier; the consumers release a stage
//   on an "empty" mbarrier. Shared memory: q 128 x 128 x 2 B = 32 KB, k
//   and v 2 x (32 + 32) KB = 128 KB: 160 KB of the 227 KB.
// - S = Q K^T is 8 wgmma m64n128k16 a k tile (64 registers a thread),
//   both operands read from shared memory through descriptors.
// - O (64 x 128 float32, 64 registers a thread) stays in the consumer's
//   registers for the whole key loop. P goes from the S accumulators
//   straight into the register A operand of wgmma m64n128k16 for P V
//   (V read MN-major from its stage), never through shared memory. P is
//   taken as hi + lo 16-bit halves (16 P V products a tile): with one
//   bf16 rounding of P, O misses the 16-bit check tier 1.6x at the
//   training shape (flash_fwd_mma.cu; test_torch_kernel_routing.py).
// - ping-pong: at D = 128 a tile's exponentials and splits weigh as much
//   as half its products, so the two consumers take turns on the tensor
//   cores through two named barriers (SCHED): a consumer issues its
//   Q K^T, hands the turn over, and runs its softmax while the other's
//   products run; then it waits for its turn again to issue P V. The
//   turns alternate strictly (Q K^T of 1, of 2, P V of 1, of 2, ...); a
//   consumer that skips a tile's math still takes and hands over its
//   turns, so both take the same number, and consumer 0 takes the last
//   hand-over after the loop. Each product is waited for on the path
//   that issued it (ptxas serializes every wgmma otherwise, C7518).
// - ptxas (CUDA 12.9): 168 registers at launch, which setmaxnreg
//   divides (24 x 128 + 240 x 256 = 168 x 384), no spill.
// - the online softmax in base 2, the causal tile skip (a consumer skips
//   the math of a k tile wholly right of its 64 rows) and the
//   elementwise mask only on tiles the diagonal or the ragged end
//   crosses are those of flash_fwd_mma.cu. A tile's exponentials and
//   splits, not its products, set the kernel's time (a variant without
//   P V kept most of it), so an unmasked tile takes x - m as one fma on
//   the raw scores and 2^x as ex2.approx.ftz.
// - O is staged in the consumer's own rows of the q tile (swizzled, no
//   bank conflicts) and stored 16 bytes a lane.
//
// What it leaves: a persistent grid, whose blocks would overlap one
// tile's epilogue and prologue with another's loop; TMA stores; caching
// the tensor maps across calls. Overlapping a tile's Q K^T with the
// previous tile's P V inside one consumer (FA3's intra-warpgroup
// pipelining, P of one tile held beside S of the next) was built and
// measured slower at the training shape on the H100 (PERF.md).

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

#include <math.h>

namespace {

using namespace wgmma_sm90;
using mma_sm90::for_bh_chunks;

constexpr int D = 128;
constexpr int BLOCK_M = 128;  // q rows per block: 2 consumer warpgroups x 64
constexpr int BLOCK_N = 128;  // keys per k/v stage
constexpr int STAGES = 2;
constexpr int THREADS = 3 * 128;
constexpr int SCHED = 3;      // named barriers SCHED, SCHED + 1: the turns
constexpr float MASKED = -1e30f;  // the reference's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// shared memory, in bytes from a 1024-byte-aligned base
constexpr int Q_BYTES = BLOCK_M * D * 2;             // 32 KB
constexpr int KV_BYTES = BLOCK_N * D * 2;            // 32 KB a k or v stage
constexpr int OFF_K = Q_BYTES;
constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;   // 160 KB
constexpr int SMEM_BYTES = OFF_BAR + 64 + 1024;      // + barriers, alignment

struct Bars {
  uint64_t q_full;
  uint64_t k_full[STAGES];
  uint64_t v_full[STAGES];
  uint64_t empty[STAGES];
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_d128_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            T* __restrict__ o, float* __restrict__ lse,
                            int b0, int tq, int tk, float scale, int causal) {
  using W = Wgmma<T>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T* qs = reinterpret_cast<T*>(base);
  T* ks = reinterpret_cast<T*>(base + OFF_K);
  T* vs = reinterpret_cast<T*>(base + OFF_V);
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
    mbar_init(&bar.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bar.k_full[s], 1);
      mbar_init(&bar.v_full[s], 1);
      mbar_init(&bar.empty[s], 2 * 128);  // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_expect_tx(&bar.q_full, Q_BYTES);
      for (int c = 0; c < D / 64; ++c)
        tma_load_3d(qs + c * BLOCK_M * 64, &tm_q, &bar.q_full, c * 64, q0,
                    bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES, n = t / STAGES;
        mbar_wait(&bar.empty[st], (n & 1) ^ 1);
        T* kt = ks + st * BLOCK_N * D;
        T* vt = vs + st * BLOCK_N * D;
        mbar_expect_tx(&bar.k_full[st], KV_BYTES);
        for (int c = 0; c < D / 64; ++c)
          tma_load_3d(kt + c * BLOCK_N * 64, &tm_k, &bar.k_full[st], c * 64,
                      t * BLOCK_N, bh);
        mbar_expect_tx(&bar.v_full[st], KV_BYTES);
        for (int c = 0; c < D / 64; ++c)
          tma_load_3d(vt + c * BLOCK_N * 64, &tm_v, &bar.v_full[st], c * 64,
                      t * BLOCK_N, bh);
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
  // the turns: this consumer waits at barrier mine and hands the turn
  // to the other at barrier theirs (each barrier: 128 threads of each)
  const int mine = SCHED + cw, theirs = SCHED + 1 - cw;
  // scores in base 2: x = S log2(e), masked at MASKED log2(e), so that
  // lse = m ln(2) + ln(l) is the reference's m + log(l)
  const float scale2 = scale * LOG2E;
  const float masked2 = MASKED * LOG2E;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  const T* qw = qs + 64 * cw * 64;  // the warpgroup's rows of column block 0

  if (cw == 1) named_arrive(SCHED, 256);  // consumer 0 takes the first turn
  mbar_wait(&bar.q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    const uint32_t par = (t / STAGES) & 1;
    const int k0 = t * BLOCK_N;
    // every key of the tile right of each of the warpgroup's rows, none
    // of them fully masked: the tile adds nothing to these rows
    const bool skip = causal && w0 + offset >= 0 && k0 > w0 + 63 + offset;
    const T* kt = ks + st * BLOCK_N * D;
    const T* vt = vs + st * BLOCK_N * D;
    // P = 2^(x - m) as the A operand of O += P V, hi and lo halves:
    // k-step kk (16 keys) takes accumulator blocks 2 kk, 2 kk + 1
    uint32_t ph[8][4], pl[8][4];
    mbar_wait(&bar.k_full[st], par);
    named_sync(mine, 256);
    // each turn hands over once its products are issued, on both sides
    // of the skip: a product waited for on another path than the one
    // that issued it would make ptxas serialize every wgmma
    if (!skip) {
      float s[64];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          W::ss128(s, desc_k_major(qw + c * BLOCK_M * 64 + kk * 16),
                   desc_k_major(kt + c * BLOCK_N * 64 + kk * 16),
                   (c | kk) != 0);
      }
      wgmma_commit();
      named_arrive(theirs, 256);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) reg_fence(s[i]);
      // the mask, only where the ragged end or the diagonal crosses; a
      // scale below 0 also scales S first, since it turns the raw row
      // maxima into the minima
      const bool edge = scale2 < 0.f || k0 + BLOCK_N > tk ||
                        (causal && k0 + BLOCK_N - 1 > w0 + offset);
      float mx[2] = {-INFINITY, -INFINITY};
      // an unmasked tile keeps S raw: its row maxima are scaled once
      // (scale2 >= 0 here keeps them the maxima) and x - m is one fma below
      const float sc = edge ? 1.f : scale2;
      if (edge) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
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
        for (int i = 0; i < 64; ++i)
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
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* sj = s + 4 * (2 * kk + h);
          const float p0 = ex2_ftz(fmaf(sj[0], sc, -m[0]));
          const float p1 = ex2_ftz(fmaf(sj[1], sc, -m[0]));
          const float p2 = ex2_ftz(fmaf(sj[2], sc, -m[1]));
          const float p3 = ex2_ftz(fmaf(sj[3], sc, -m[1]));
          l[0] += p0 + p1;
          l[1] += p2 + p3;
          split_pack<T>(p0, p1, ph[kk][2 * h], pl[kk][2 * h]);
          split_pack<T>(p2, p3, ph[kk][2 * h + 1], pl[kk][2 * h + 1]);
        }
      }
    } else {
      named_arrive(theirs, 256);
    }
    mbar_wait(&bar.v_full[st], par);
    named_sync(mine, 256);
    if (!skip) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t dv =
            desc_mn_major(vt + kk * 16 * 64, BLOCK_N * 64 * sizeof(T));
        W::rs128(acc, ph[kk], dv);
        W::rs128(acc, pl[kk], dv);
      }
      wgmma_commit();
      named_arrive(theirs, 256);
      wgmma_wait<0>();
      // the registers the products read and wrote are settled only now
#pragma unroll
      for (int i = 0; i < 64; ++i) reg_fence(acc[i]);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          reg_fence(ph[kk][r]);
          reg_fence(pl[kk][r]);
        }
      }
    } else {
      named_arrive(theirs, 256);
    }
    mbar_arrive(&bar.empty[st]);  // this thread is done with stage st
  }

  // consumer 1's last hand-over has no turn after it: consumer 0 takes
  // it here, so that each barrier sees as many arrivals as waits
  if (cw == 0) named_sync(mine, 256);

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
  // stage O in the warpgroup's own rows of the q tile (its last wgmma
  // has read them), then store 16 bytes a lane
  named_sync(1 + cw, 128);
  T* ow = qs + 64 * cw * 64;  // row 0 of the warpgroup in column block 0
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * tg;
    const int r0 = 16 * warp + g;
    *reinterpret_cast<uint32_t*>(ow + swz<BLOCK_M>(r0, col)) =
        W::pack(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
    *reinterpret_cast<uint32_t*>(ow + swz<BLOCK_M>(r0 + 8, col)) =
        W::pack(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
  }
  named_sync(1 + cw, 128);
  T* ob = o + ((long long)bh * tq + w0) * D;
#pragma unroll 4
  for (int i = ct; i < 64 * (D / 8); i += 128) {
    const int r = i / (D / 8), ch = i % (D / 8);
    if (w0 + r < tq)
      *reinterpret_cast<uint4*>(ob + (long long)r * D + ch * 8) =
          *reinterpret_cast<const uint4*>(ow + swz<BLOCK_M>(r, ch * 8));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int tq, int tk, float scale, int causal,
           cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = make_map<T, D>(&mq, q, bh, tq, BLOCK_M);
  if (!err) err = make_map<T, D>(&mk, k, bh, tk, BLOCK_N);
  if (!err) err = make_map<T, D>(&mv, v, bh, tk, BLOCK_N);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_d128_wgmma_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  return for_bh_chunks(bh, [&](int b0, int n) {
    const dim3 grid((tq + BLOCK_M - 1) / BLOCK_M, n);
    flash_fwd_d128_wgmma_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
        mq, mk, mv, static_cast<T*>(o), lse, b0, tq, tk, scale, causal);
  });
}

}  // namespace

// dtype: 1 bfloat16, 2 float16; d: 128. q: [bh, tq, 128]; k, v:
// [bh, tk, 128]; o like q; lse: [bh, tq] float32. All contiguous,
// 16-byte aligned, on the current device. Returns the CUDA error code of
// the launch (0 = ok).
extern "C" int flash_fwd_d128_wgmma(const void* q, const void* k,
                                    const void* v, void* o, float* lse,
                                    int bh, int tq, int tk, int d, int dtype,
                                    float scale, int causal, void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || d != D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return launch<__nv_bfloat16>(q, k, v, o, lse, bh, tq, tk, scale, causal, s);
    case 2: return launch<__half>(q, k, v, o, lse, bh, tq, tk, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
