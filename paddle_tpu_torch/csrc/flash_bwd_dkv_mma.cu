// Flash-attention backward dK/dV on Hopper's tensor cores (sm_90a,
// mma.sync), bf16 and fp16, plain C interface. The float32 route is
// flash_bwd_dkv_f32mma.cu; dQ (K2) is flash_bwd_dq_mma.cu's.
//
// Replaces paddle_tpu/ops/pallas_attention.py:189 _fa_bwd_dkv_kernel
// (with _recompute_ds, :161; the second pallas_call of
// _flash_bwd_pallas, :290). Per (batch*head) slice of q, do [tq, D] and
// k, v [tk, D], D 64 or any multiple of 128, it computes:
//   P  = exp(S - lse), S = (Q K^T) * scale   (lse from the forward, K1)
//   dS = P o (dO V^T - delta) * scale         (delta per q row, from the
//                                              caller: rowsum(dO o O) - dlse)
//   dV = sum_q P^T dO,   dK = sum_q dS^T Q
// with jax.vjp of _ref_attention_lse's semantics: causal masking is
// bottom-right (key j visible to row i iff j <= i + tk - tq), masked
// entries have P = dS = 0, keys >= tk and rows >= tq take no part, and
// a fully masked row (causal, tq > tk) has P = 1/tk on every key and
// dS = 0 -- recognised by its index, since its float32 lse (-1e30)
// cannot give P back.
//
// What bounds it on the H100: at the training shape (B*H = 2*32,
// T = 2048, D = 128, causal) it does 137.5 GFLOP of useful products
// (8 D FLOP per visible pair: K Q^T, V dO^T, P^T dO, dS^T Q) against
// 202 MB moved: the bf16 tensor-core rate, 0.139 ms.
//
// Design:
// - one block of 8 warps per (bh, 64-key tile). The k and v tiles stay
//   resident in shared memory; 64-row q tiles of Q and dO, with their
//   lse and delta, stream through a two-stage cp.async ring (16-byte
//   copies for the tiles, 4-byte for the row vectors, zero-filled past
//   tq / tk), rows padded to D + 8 elements for conflict-free ldmatrix.
//   105 KB at D = 128.
// - warp w owns keys 16 (w % 4) .. +15 and the q rows 32 (w / 4) .. +31
//   of each tile, and computes the transposed products S^T = K Q^T and
//   dP^T = V dO^T on mma.sync.m16n8k16 with float32 accumulators, so
//   the rows of its accumulators are its keys.
// - P^T and dS^T (float32 registers, with the masks) become the A
//   operands of dV += P^T dO and dK += dS^T Q (dO, Q through
//   ldmatrix.trans) without touching shared memory, split into hi + lo
//   16-bit halves: one bf16 rounding of P and dS (2^-9) costs dV / dK
//   2.8x / 3.2x the check tier's limit at the training shape.
// - dK and dV accumulate in float32 registers (2 x D/2 per lane). A q
//   tile's work runs in two halves, S^T -> P^T -> dV, then dP^T -> dS^T
//   -> dK (P taken back from its hi + lo halves), so that one product's
//   operands are live beside those 128 accumulators: at D = 128, 250
//   registers and no spill, where both at once spilled at 255. The two
//   warps that share keys add their halves through shared memory at the
//   end; the sums are staged as T and stored 16 bytes a lane.
// - the q loop starts at the first tile that sees the block's keys
//   (max(0, k0 - offset) / 64), except when fully masked rows exist,
//   which see every key; a warp whose rows are all left of its keys
//   skips the tile's math; the mask runs only on tiles the diagonal or
//   a ragged end crosses.

// - a head dim past 128 runs the D = 128 kernel in 128-column slices
//   (mma_sm90.cuh HEAD_SLICE): block z of gridDim.z writes columns
//   [128 z, 128 z + 128) of dK and dV. S^T and dP^T sum the slices'
//   products before P^T is formed, each slice's k, v, q and dO tiles
//   copied afresh (waited for), the last slice being z, whose q and dO
//   tiles dV and dK read. Both score tiles are live beside the
//   accumulators there.
//
// What it leaves: wgmma with TMA and warp specialisation; fusing dQ
// (K2) into this pass with atomics, as FlashAttention-2 does (dQ stays
// a kernel of its own, flash_bwd_dq_mma.cu: this kernel's dS is held
// transposed, and atomics would make dQ nondeterministic); reading GQA
// KV heads in place instead of after repeat_interleave.

#include "mma_sm90.cuh"

#include <math.h>

namespace {

using namespace mma_sm90;

constexpr int BLOCK_N = 64;   // keys per block: 4 groups of 16
constexpr int BLOCK_M = 64;   // q rows per tile: 2 halves of 32
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

static_assert(BLOCK_N == 16 * (WARPS / 2) && BLOCK_M == 32 * 2,
              "warp w: keys 16 (w % 4), q rows 32 (w / 4)");

template <int D>
struct Layout {
  static constexpr int LD = D + 8;          // padded row stride
  static constexpr int TILE = 64 * LD;      // one k, v, q or dO tile
  // k, v; q [2]; dO [2] (elements), then lse [2][64], delta [2][64]
  static constexpr size_t bytes = 2 * 6 * TILE + 4 * 4 * 64;
  // the end-of-loop reduction, float4 per lane, overlays q and dO
  static_assert(4 * (D / 8) * 2 * 32 * 16 <= 2 * 4 * TILE, "reduction fits");
};

// WIDE: D = HEAD_SLICE and the head is gridDim.z slices of it
template <typename T, int D, bool WIDE>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int tq, int tk, float scale,
                         int causal) {
  using M = Mma<T>;
  constexpr int LD = Layout<D>::LD;
  constexpr int TILE = Layout<D>::TILE;
  constexpr int KSTEPS = D / 16;  // k-steps of K Q^T over the head dim
  constexpr int DBLK = D / 8;     // 8-column blocks of dK, dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [64][LD]
  T* vs = ks + TILE;                       // [64][LD]
  T* qs = vs + TILE;                       // [2][64][LD]
  T* dos = qs + 2 * TILE;                  // [2][64][LD]
  float* lses = reinterpret_cast<float*>(dos + 2 * TILE);  // [2][64]
  float* dls = lses + 2 * BLOCK_M;                          // [2][64]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int kg = warp & 3;          // key group
  const int r0 = (warp >> 2) * 32;  // first q row of the warp's half
  const int k0 = blockIdx.x * BLOCK_N;
  const long long bh = blockIdx.y;
  const int ns = WIDE ? gridDim.z : 1, z = WIDE ? blockIdx.z : 0;
  const int ld = D * ns;               // global row stride
  const int s0 = WIDE ? slice_at(0, z, ns) : 0;
  const T* qb = q + bh * tq * ld;
  const T* dob = dout + bh * tq * ld;
  const T* kb = k + bh * tk * ld;
  const T* vb = v + bh * tk * ld;
  const float* lseb = lse + bh * tq;
  const float* dlb = delta + bh * tq;

  // causal: row i sees key j iff i >= j - offset, so the first q tile
  // that sees any key of this block starts at row k0 - offset. Rows
  // with no visible key at all (i < -offset, only when tq > tk) see
  // every key with P = 1/tk: then every tile is visited.
  const int offset = tk - tq;
  const int n_tiles = (tq + BLOCK_M - 1) / BLOCK_M;
  int t0 = 0;
  if (causal && offset >= 0) t0 = max(0, k0 - offset) / BLOCK_M;

  auto load_q_tile = [&](int t, int st) {
    const int q0 = t * BLOCK_M;
    load_tile_async<THREADS, BLOCK_M, D, LD>(qs + st * TILE, qb + s0 * D, q0,
                                             tq, ld);
    load_tile_async<THREADS, BLOCK_M, D, LD>(dos + st * TILE, dob + s0 * D,
                                             q0, tq, ld);
    if (tid < 2 * BLOCK_M) {
      const int i = tid % BLOCK_M, row = q0 + i;
      const bool in = row < tq;
      const float* src = (tid < BLOCK_M ? lseb : dlb) + (in ? row : 0);
      float* dst = (tid < BLOCK_M ? lses : dls) + st * BLOCK_M + i;
      cp_async_4(dst, src, in);
    }
  };
  load_tile_async<THREADS, BLOCK_N, D, LD>(ks, kb + s0 * D, k0, tk, ld);
  load_tile_async<THREADS, BLOCK_N, D, LD>(vs, vb + s0 * D, k0, tk, ld);
  load_q_tile(t0, 0);
  cp_async_commit();

  const int kw = k0 + 16 * kg;           // the warp's first key
  const int key_a = kw + g;              // this lane's keys: key_a, key_a + 8
  const float p_masked_row = 1.f / (float)tk;
  float dk_acc[DBLK][4], dv_acc[DBLK][4];
#pragma unroll
  for (int j = 0; j < DBLK; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }

  for (int t = t0; t < n_tiles; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < n_tiles) {
      load_q_tile(t + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // tile t (and k, v) landed; t + 1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = t * BLOCK_M;
    const int w0 = q0 + r0;  // the warp's first row
    // all of the warp's rows left of all its keys, none fully masked
    const bool skip = causal && w0 + offset >= 0 && w0 + 31 + offset < kw;
    T* qt = qs + st * TILE;
    T* dot = dos + st * TILE;
    // S^T = K Q^T: 16 keys x 32 rows; a wide head also sums dP^T = V dO^T
    // here, slice by slice (the last slice z, which dV and dK read)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    for (int i = 0; i < ns; ++i) {
      if (WIDE && (i > 0 || t > t0)) {
        // this step's slice of k and v (held slice z since the last
        // tile) and, past the first step, of q and dO
        const int sl = slice_at(i, z, ns);
        __syncthreads();
        load_tile_async<THREADS, BLOCK_N, D, LD>(ks, kb + sl * D, k0, tk, ld);
        load_tile_async<THREADS, BLOCK_N, D, LD>(vs, vb + sl * D, k0, tk, ld);
        if (i > 0) {
          load_tile_async<THREADS, BLOCK_M, D, LD>(qt, qb + sl * D, q0, tq,
                                                   ld);
          load_tile_async<THREADS, BLOCK_M, D, LD>(dot, dob + sl * D, q0, tq,
                                                   ld);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      if (!skip) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, a_frag<LD>(ks, 16 * kg, kk * 16, lane));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t b[4];
            ldsm_x4(b, b_frag<LD>(qt, r0 + np * 16, kk * 16, lane));
            M::run(s[2 * np], a, b[0], b[1]);
            M::run(s[2 * np + 1], a, b[2], b[3]);
          }
        }
        if (WIDE) {
#pragma unroll
          for (int kk = 0; kk < KSTEPS; ++kk) {
            uint32_t a[4];
            ldsm_x4(a, a_frag<LD>(vs, 16 * kg, kk * 16, lane));
#pragma unroll
            for (int np = 0; np < 2; ++np) {
              uint32_t b[4];
              ldsm_x4(b, b_frag<LD>(dot, r0 + np * 16, kk * 16, lane));
              M::run(dp[2 * np], a, b[0], b[1]);
              M::run(dp[2 * np + 1], a, b[2], b[3]);
            }
          }
        }
      }
    }
    if (!skip) {
      const float* lt = lses + st * BLOCK_M;
      const float* dlt = dls + st * BLOCK_M;
      // in two halves, so that only one product's operands are live
      // beside the accumulators: S^T -> P^T -> dV, then dP^T -> dS^T -> dK
      const bool edge = q0 + BLOCK_M > tq || k0 + BLOCK_N > tk ||
                        (causal && w0 + offset < kw + 15);
      // P^T in float32 with the masks, as the A operand (hi, lo) of
      // dV += P^T dO: k-step kk covers the rows of blocks 2 kk, 2 kk + 1
      uint32_t ph[2][4], pl[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = r0 + 8 * j + 2 * tg;  // row within the tile (and i + 1)
        const float2 lse2 = *reinterpret_cast<const float2*>(lt + i);
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = __expf(s[j][e] * scale - ((e & 1) ? lse2.y : lse2.x));
          if (edge) {
            const int row = q0 + i + (e & 1);
            const int key = key_a + (e >> 1) * 8;
            if (key >= tk || row >= tq)
              pe = 0.f;
            else if (causal && row + offset < 0)
              pe = p_masked_row;            // fully masked row
            else if (causal && row + offset < key)
              pe = 0.f;
          }
          p[e] = pe;
        }
        const int kk = j >> 1, a = (j & 1) * 2;
        split_pack<T>(p[0], p[1], ph[kk][a], pl[kk][a]);
        split_pack<T>(p[2], p[3], ph[kk][a + 1], pl[kk][a + 1]);
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int dpi = 0; dpi < D / 16; ++dpi) {
          uint32_t b[4];
          ldsm_x4_trans(b, bt_frag<LD>(dot, r0 + kk * 16, dpi * 16, lane));
          M::run(dv_acc[2 * dpi], ph[kk], b[0], b[1]);
          M::run(dv_acc[2 * dpi], pl[kk], b[0], b[1]);
          M::run(dv_acc[2 * dpi + 1], ph[kk], b[2], b[3]);
          M::run(dv_acc[2 * dpi + 1], pl[kk], b[2], b[3]);
        }
      }
      // dP^T = V dO^T
#pragma unroll
      for (int kk = 0; kk < (WIDE ? 0 : KSTEPS); ++kk) {
        uint32_t a[4];
        ldsm_x4(a, a_frag<LD>(vs, 16 * kg, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          ldsm_x4(b, b_frag<LD>(dot, r0 + np * 16, kk * 16, lane));
          M::run(dp[2 * np], a, b[0], b[1]);
          M::run(dp[2 * np + 1], a, b[2], b[3]);
        }
      }
      // dS^T = P^T o (dP^T - delta) scale, P^T = hi + lo to ~2^-16; 0
      // wherever P^T is 0 and on fully masked rows
      uint32_t dsh[2][4], dsl[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = r0 + 8 * j + 2 * tg;
        const float2 dl2 = *reinterpret_cast<const float2*>(dlt + i);
        const bool lost = edge && causal && q0 + i + offset < 0;
        const bool lost1 = edge && causal && q0 + i + 1 + offset < 0;
        const int kk = j >> 1, a = (j & 1) * 2;
        float ds[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 h = Mma<T>::unpack(ph[kk][a + r]);
          const float2 lo = Mma<T>::unpack(pl[kk][a + r]);
          ds[2 * r] = lost ? 0.f
                           : (h.x + lo.x) * (dp[j][2 * r] - dl2.x) * scale;
          ds[2 * r + 1] = lost1 ? 0.f
                                : (h.y + lo.y) * (dp[j][2 * r + 1] - dl2.y) *
                                      scale;
        }
        split_pack<T>(ds[0], ds[1], dsh[kk][a], dsl[kk][a]);
        split_pack<T>(ds[2], ds[3], dsh[kk][a + 1], dsl[kk][a + 1]);
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int dpi = 0; dpi < D / 16; ++dpi) {
          uint32_t b[4];
          ldsm_x4_trans(b, bt_frag<LD>(qt, r0 + kk * 16, dpi * 16, lane));
          M::run(dk_acc[2 * dpi], dsh[kk], b[0], b[1]);
          M::run(dk_acc[2 * dpi], dsl[kk], b[0], b[1]);
          M::run(dk_acc[2 * dpi + 1], dsh[kk], b[2], b[3]);
          M::run(dk_acc[2 * dpi + 1], dsl[kk], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration
  }
  cp_async_wait<0>();

  // warps 4..7 hand their partial sums to warps 0..3 (same keys, same
  // lane layout) through the q/dO stages, float4 per lane
  float4* red = reinterpret_cast<float4*>(qs) + kg * (2 * DBLK) * 32 + lane;
  if (r0 != 0) {
#pragma unroll
    for (int j = 0; j < DBLK; ++j) {
      red[j * 32] = make_float4(dk_acc[j][0], dk_acc[j][1], dk_acc[j][2],
                                dk_acc[j][3]);
      red[(DBLK + j) * 32] = make_float4(dv_acc[j][0], dv_acc[j][1],
                                         dv_acc[j][2], dv_acc[j][3]);
    }
  }
  __syncthreads();
  if (r0 == 0) {
    // k and v are no longer read: stage dK in ks, dV in vs
    T* dks = ks + 16 * kg * LD;
    T* dvs = vs + 16 * kg * LD;
#pragma unroll
    for (int j = 0; j < DBLK; ++j) {
      const float4 a = red[j * 32], b = red[(DBLK + j) * 32];
      const int col = 8 * j + 2 * tg;
      *reinterpret_cast<uint32_t*>(dks + g * LD + col) =
          M::pack(dk_acc[j][0] + a.x, dk_acc[j][1] + a.y);
      *reinterpret_cast<uint32_t*>(dks + (g + 8) * LD + col) =
          M::pack(dk_acc[j][2] + a.z, dk_acc[j][3] + a.w);
      *reinterpret_cast<uint32_t*>(dvs + g * LD + col) =
          M::pack(dv_acc[j][0] + b.x, dv_acc[j][1] + b.y);
      *reinterpret_cast<uint32_t*>(dvs + (g + 8) * LD + col) =
          M::pack(dv_acc[j][2] + b.z, dv_acc[j][3] + b.w);
    }
  }
  __syncthreads();
  store_tile<THREADS, BLOCK_N, D, LD>(dk + bh * tk * ld + z * D, ks, k0, tk,
                                      tid, ld);
  store_tile<THREADS, BLOCK_N, D, LD>(dv + bh * tk * ld + z * D, vs, k0, tk,
                                      tid, ld);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dk, *dv;
  int bh, tq, tk, d;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D, bool WIDE>
int launch(const Args& a) {
  constexpr size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel<T, D, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return for_bh_chunks(a.bh, [&](int b0, int n) {
    const long long qo = (long long)b0 * a.tq * a.d;
    const long long ko = (long long)b0 * a.tk * a.d;
    const long long ro = (long long)b0 * a.tq;
    const dim3 grid((a.tk + BLOCK_N - 1) / BLOCK_N, n, a.d / D);
    flash_bwd_dkv_mma_kernel<T, D, WIDE><<<grid, THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q) + qo, static_cast<const T*>(a.k) + ko,
        static_cast<const T*>(a.v) + ko, static_cast<const T*>(a.dout) + qo,
        a.lse + ro, a.delta + ro, static_cast<T*>(a.dk) + ko,
        static_cast<T*>(a.dv) + ko, a.tq, a.tk, a.scale, a.causal);
  });
}

template <typename T>
int launch_d(const Args& a) {
  if (a.d == 64) return launch<T, 64, false>(a);
  if (a.d == HEAD_SLICE) return launch<T, HEAD_SLICE, false>(a);
  if (a.d > 0 && a.d % HEAD_SLICE == 0) return launch<T, HEAD_SLICE, true>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 1 bfloat16, 2 float16 (float32 is flash_bwd_dkv_f32mma.cu's); d: 64 or
// a multiple of 128. q, dout: [bh, tq, d]; k, v, dk, dv: [bh, tk, d]; lse, delta:
// [bh, tq] float32. All contiguous, the 16-bit tensors 16-byte aligned,
// on the current device. Returns the CUDA error code of the launch
// (0 = ok).
extern "C" int flash_bwd_dkv_mma(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dk, void* dv,
                                 int bh, int tq, int tk, int d, int dtype,
                                 float scale, int causal, void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d,
               scale, causal, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 1: return launch_d<__nv_bfloat16>(a);
    case 2: return launch_d<__half>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
