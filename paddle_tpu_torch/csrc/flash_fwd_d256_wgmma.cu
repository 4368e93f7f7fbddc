// Flash-attention forward at head dim 256 on Hopper's warpgroup tensor
// cores (sm_90a: wgmma, TMA, warp specialisation), bf16 and fp16, plain
// C interface. Other head dims and float32 run flash_fwd_mma.cu and
// flash_fwd_f32mma.cu.
//
// Replaces paddle_tpu/ops/pallas_attention.py:59 _fa_kernel (launched by
// _flash_fwd_pallas, :111) at D = 256. Per (batch*head) slice of
// q [tq, 256] and k, v [tk, 256] it computes
//   S   = (Q K^T) * scale, causal-masked bottom-right (row + tk - tq >= col)
//   O   = softmax(S) V    by online softmax (running max m, sum l)
//   lse = m + log(l)      (l == 0 -> 1), compact [BH, tq] float32
// with _ref_attention_lse's semantics: masked scores are -1e30 (a fully
// masked row, causal with tq > tk, averages V), keys >= tk are -inf and
// take no part, rows >= tq are never written.
//
// What bounds it on the H100: at the head_dim_256 training shape
// (B*H = 2*16, T = 2048, D = 256, causal) it does 68.7 GFLOP of useful
// products (4 D FLOP per visible (row, key) pair) against 134 MB moved:
// the bf16 tensor-core rate, 0.0695 ms. At the served shape (B*H = 1*16,
// T = 256) it moves 8.4 MB for 0.5 GFLOP: memory, 0.0025 ms.
//
// Design (FlashAttention-3's structure, simplified):
// - one block of three warpgroups per (bh, 128-row q tile), heaviest
//   tile first. Warpgroup 0 is the producer: after setmaxnreg gives its
//   registers away (24 a thread), one thread issues every TMA load.
//   Warpgroups 1 and 2 are the consumers, 64 q rows each, at 240
//   registers a thread.
// - TMA (cp.async.bulk.tensor, 3-D tensor maps over [bh, t, 256] with
//   the 128-byte swizzle, rows past t zero-filled) brings the q tile
//   once and the k and v tiles through a two-stage ring of 64 keys, each
//   completing on its own mbarrier; the consumers release a stage on an
//   "empty" mbarrier. Shared memory: q 128 x 256 x 2 B = 64 KB, k and v
//   2 x (32 + 32) KB = 128 KB: 192 KB of the 227 KB.
// - S = Q K^T runs once over the whole 256-wide head: 16 wgmma
//   m64n64k16 a k tile, both operands read from shared memory through
//   descriptors. No slice recomputes it (the sliced D = 128 route took
//   Q K^T twice).
// - O (64 x 256 float32, 128 registers a thread) stays in the consumer's
//   registers for the whole key loop. P goes from the S accumulators
//   straight into the register A operand of wgmma m64n256k16 for P V
//   (V read MN-major from its stage), never through shared memory. P is
//   taken as hi + lo 16-bit halves (two P V products): with one bf16
//   rounding of P, O misses the 16-bit check tier about 3x at the
//   training shape on the H100 (split_check.py; 1.6x at D = 128 in
//   flash_fwd_mma.cu).
// - ptxas (CUDA 12.9): 168 registers at launch (the producer gives 144 a
//   thread to the consumers), no spill.
// - the online softmax in base 2, the causal tile skip (a consumer skips
//   the math of a k tile wholly right of its 64 rows) and the
//   elementwise mask only on tiles the diagonal or the ragged end
//   crosses are those of flash_fwd_mma.cu.
// - O is staged in the consumer's own rows of the q tile (swizzled, no
//   bank conflicts) and stored 16 bytes a lane.
//
// What it leaves: ping-pong scheduling of the two consumers and the
// overlap of one tile's softmax with the next tile's Q K^T (FA3's
// intra-warpgroup pipelining); a persistent grid; TMA stores.

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

#include <math.h>

namespace {

using namespace wgmma_sm90;
using mma_sm90::for_bh_chunks;

constexpr int D = 256;
constexpr int BLOCK_M = 128;  // q rows per block: 2 consumer warpgroups x 64
constexpr int BLOCK_N = 64;   // keys per k/v stage
constexpr int STAGES = 2;
constexpr int THREADS = 3 * 128;
constexpr float MASKED = -1e30f;  // the reference's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// shared memory, in bytes from a 1024-byte-aligned base
constexpr int Q_BYTES = BLOCK_M * D * 2;             // 64 KB
constexpr int KV_BYTES = BLOCK_N * D * 2;            // 32 KB a k or v stage
constexpr int OFF_K = Q_BYTES;
constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;   // 192 KB
constexpr int SMEM_BYTES = OFF_BAR + 64 + 1024;      // + barriers, alignment

struct Bars {
  uint64_t q_full;
  uint64_t k_full[STAGES];
  uint64_t v_full[STAGES];
  uint64_t empty[STAGES];
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_d256_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
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
  // scores in base 2: x = S log2(e), masked at MASKED log2(e), so that
  // lse = m ln(2) + ln(l) is the reference's m + log(l)
  const float scale2 = scale * LOG2E;
  const float masked2 = MASKED * LOG2E;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  const T* qw = qs + 64 * cw * 64;  // the warpgroup's rows of column block 0

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
    mbar_wait(&bar.k_full[st], par);
    if (!skip) {
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          W::ss64(s, desc_k_major(qw + c * BLOCK_M * 64 + kk * 16),
                  desc_k_major(kt + c * BLOCK_N * 64 + kk * 16),
                  (c | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(s[i]);
      // the mask, only where the ragged end or the diagonal crosses
      const bool edge = k0 + BLOCK_N > tk ||
                        (causal && k0 + BLOCK_N - 1 > w0 + offset);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
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
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* sj = s + 4 * (2 * kk + h);
          const float p0 = exp2f(sj[0] - m[0]), p1 = exp2f(sj[1] - m[0]);
          const float p2 = exp2f(sj[2] - m[1]), p3 = exp2f(sj[3] - m[1]);
          l[0] += p0 + p1;
          l[1] += p2 + p3;
          split_pack<T>(p0, p1, ph[kk][2 * h], pl[kk][2 * h]);
          split_pack<T>(p2, p3, ph[kk][2 * h + 1], pl[kk][2 * h + 1]);
        }
      }
      mbar_wait(&bar.v_full[st], par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv =
            desc_mn_major(vt + kk * 16 * 64, BLOCK_N * 64 * sizeof(T));
        W::rs256(acc, ph[kk], dv);
        W::rs256(acc, pl[kk], dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      // the registers the products read and wrote are settled only now
#pragma unroll
      for (int i = 0; i < 128; ++i) reg_fence(acc[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          reg_fence(ph[kk][r]);
          reg_fence(pl[kk][r]);
        }
      }
    } else {
      mbar_wait(&bar.v_full[st], par);
    }
    mbar_arrive(&bar.empty[st]);  // this thread is done with stage st
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
  // stage O in the warpgroup's own rows of the q tile (its last wgmma
  // has read them), then store 16 bytes a lane
  named_sync(1 + cw, 128);
  T* ow = qs + 64 * cw * 64;  // row 0 of the warpgroup in column block 0
#pragma unroll
  for (int j = 0; j < 32; ++j) {
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
  int err = make_map<T>(&mq, q, bh, tq, BLOCK_M);
  if (!err) err = make_map<T>(&mk, k, bh, tk, BLOCK_N);
  if (!err) err = make_map<T>(&mv, v, bh, tk, BLOCK_N);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_d256_wgmma_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  return for_bh_chunks(bh, [&](int b0, int n) {
    const dim3 grid((tq + BLOCK_M - 1) / BLOCK_M, n);
    flash_fwd_d256_wgmma_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
        mq, mk, mv, static_cast<T*>(o), lse, b0, tq, tk, scale, causal);
  });
}

}  // namespace

// dtype: 1 bfloat16, 2 float16; d: 256. q: [bh, tq, 256]; k, v:
// [bh, tk, 256]; o like q; lse: [bh, tq] float32. All contiguous,
// 16-byte aligned, on the current device. Returns the CUDA error code of
// the launch (0 = ok).
extern "C" int flash_fwd_d256_wgmma(const void* q, const void* k,
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
