// PTX helpers shared by the tensor-core attention kernels
// (flash_fwd_mma.cu, flash_bwd_dq_mma.cu, flash_bwd_dkv_mma.cu, and the
// float32 flash_fwd_f32mma.cu, flash_bwd_dq_f32mma.cu,
// flash_bwd_dkv_f32mma.cu): cp.async tile copies, ldmatrix fragment
// loads and mma.sync.m16n8k16 with float32 accumulators, for bf16 and
// fp16; the split of float32 operands into bf16 hi + lo halves; and
// mma.sync.m16n8k8 on TF32 hi + lo halves. sm_80+ instructions, built
// for sm_90a.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), which the kernels' index arithmetic relies on:
//   A (16 x 16, row major), four 32-bit registers of two halves each:
//     a0 (row g,     cols 2t, 2t+1)   a2 (row g,     cols 2t+8, 2t+9)
//     a1 (row g + 8, cols 2t, 2t+1)   a3 (row g + 8, cols 2t+8, 2t+9)
//   B (16 x 8, k x n, "col"), two registers:
//     b0 (k 2t, 2t+1, col g)          b1 (k 2t+8, 2t+9, col g)
//   C / D (16 x 8) float32:
//     c0, c1 (row g, cols 2t, 2t+1)   c2, c3 (row g + 8, cols 2t, 2t+1)
// So the accumulators of two neighbouring 8-column blocks j = 2s, 2s+1
// are, packed in pairs, the A fragment of k-step s of the next product:
// a[2 (j & 1)] = (c0, c1), a[2 (j & 1) + 1] = (c2, c3). A probability
// tile never leaves the registers between its two products.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_sm90 {

// gridDim.y's limit: the launchers put B*H there and launch a larger
// B*H in chunks of at most this many slices
constexpr int MAX_GRID_Y = 65535;

// Head dims past 128 (any multiple of it) run in 128-column slices: the
// kernels are instantiated at D = HEAD_SLICE with ns = d / HEAD_SLICE
// slices on gridDim.z. A block owns slice blockIdx.z of its output and
// takes the products that sum over the head dim (Q K^T, dO V^T) slice
// by slice through its D = 128 tiles, ending on its own slice, so the
// tiles its output product reads hold that slice when it runs. Each
// block recomputes the scores of its slice: ns times the Q K^T work.
constexpr int HEAD_SLICE = 128;

// the slice of step i of a block's slice loop: its own slice z last
__device__ __forceinline__ int slice_at(int i, int z, int ns) {
  return (z + 1 + i) % ns;
}

// Calls launch_chunk(b0, n) for each chunk of at most MAX_GRID_Y of the
// bh slices: b0 is its first slice and n its size, which the launcher
// puts on gridDim.y after offsetting its pointers by b0. Returns the
// first launch error as a CUDA error code (0 = ok).
template <class F>
int for_bh_chunks(int bh, F launch_chunk) {
  for (int b0 = 0; b0 < bh; b0 += MAX_GRID_Y) {
    launch_chunk(b0, bh - b0 < MAX_GRID_Y ? bh - b0 : MAX_GRID_Y);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; with pred false nothing is
// read and the 16 bytes are zero-filled (src must still be a valid
// address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when pred is false
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [g0, g0 + ROWS) of a row-major [t, D] slice into a shared tile of
// row stride LD elements, 16 bytes a copy; rows past t are zero. The
// slice's rows lie ldg elements apart (D unless the slice is D columns
// of a wider head, see HEAD_SLICE)
template <int THREADS, int ROWS, int D, int LD, typename T>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, int g0,
                                                int t, int ldg = D) {
  constexpr int CHUNKS = D * (int)sizeof(T) / 16;
  constexpr int PER = 16 / (int)sizeof(T);
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int row = i / CHUNKS, ch = i % CHUNKS;
    const int g = g0 + row;
    const bool in = g < t;
    cp_async_16(dst + row * LD + ch * PER,
                src + (long long)(in ? g : 0) * ldg + ch * PER, in);
  }
}

// the shared tile's rows [0, ROWS) to rows [g0, g0 + ROWS) of a [t, D]
// slice (rows ldg elements apart), 16 bytes a store, rows past t not
// written; one group of NTHREADS threads (thread index ti) does it
template <int NTHREADS, int ROWS, int D, int LD, typename T>
__device__ __forceinline__ void store_tile(T* dst, const T* src, int g0,
                                           int t, int ti, int ldg = D) {
  constexpr int CHUNKS = D * (int)sizeof(T) / 16;
  constexpr int PER = 16 / (int)sizeof(T);
  for (int i = ti; i < ROWS * CHUNKS; i += NTHREADS) {
    const int row = i / CHUNKS, ch = i % CHUNKS;
    const int g = g0 + row;
    if (g < t)
      *reinterpret_cast<uint4*>(dst + (long long)g * ldg + ch * PER) =
          *reinterpret_cast<const uint4*>(src + row * LD + ch * PER);
  }
}

// four 8 x 8 matrices of 16-bit values; lanes 8i .. 8i+7 give the row
// addresses of matrix i, register i receives it
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Lane addresses for ldmatrix.x4 on a row-major shared tile of row
// stride LD (elements), relative to the 16 x 16 block at (r0, c0):
//   a_frag: the A fragment of the block (rows r0.., k = cols c0..)
//   b_frag: the B fragments of two 8-column blocks of a product whose
//           B^T is stored (rows = n, cols = k): registers 0, 1 for
//           n-rows r0..r0+7, registers 2, 3 for r0+8..r0+15
//   bt_frag (with ldsm_x4_trans): the B fragments of two 8-column
//           blocks of a product whose B is stored (rows = k, cols = n):
//           registers 0, 1 for cols c0..c0+7, 2, 3 for c0+8..c0+15
template <int LD, typename T>
__device__ __forceinline__ const T* a_frag(const T* s, int r0, int c0,
                                           int lane) {
  return s + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8;
}
template <int LD, typename T>
__device__ __forceinline__ const T* b_frag(const T* s, int r0, int c0,
                                           int lane) {
  return s + (r0 + (lane & 7) + (lane >> 4) * 8) * LD + c0 +
         ((lane >> 3) & 1) * 8;
}
template <int LD, typename T>
__device__ __forceinline__ const T* bt_frag(const T* s, int r0, int c0,
                                            int lane) {
  return s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 +
         (lane >> 4) * 8;
}

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  // c += a b
  static __device__ __forceinline__ void run(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // (x, y) rounded to a bf16 pair, x in the low half
  static __device__ __forceinline__ uint32_t pack(float x, float y) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float x, float y) {
    __half2 h = __floats2half2_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __half22float2(*reinterpret_cast<__half2*>(&u));
  }
};

// (x, y) as a pair rounded to T (hi) and the pair of what that rounding
// lost, rounded again (lo): hi + lo carries ~16 significant bits, so a
// product a = hi + lo taken as two mma.sync keeps a float32 operand's
// accuracy to ~2^-16 where one 16-bit rounding (2^-9 in bf16) would not
// meet the kernels' check tier
template <typename T>
__device__ __forceinline__ void split_pack(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  hi = Mma<T>::pack(x, y);
  const float2 h = Mma<T>::unpack(hi);
  lo = Mma<T>::pack(x - h.x, y - h.y);
}

// rows [g0, g0 + ROWS) of a row-major float32 [t, D] slice (global or
// shared memory, rows 16-byte aligned), each element x split into
// hi = bf16(x) and lo = bf16(x - hi), into two shared bf16 tiles of row
// stride LD; rows past t are zero; the slice's rows lie ldg elements
// apart. bf16 keeps float32's exponent range, so lo is a normal number
// wherever x is: hi + lo holds x to ~2^-17.
template <int THREADS, int ROWS, int D, int LD>
__device__ __forceinline__ void split_tile(__nv_bfloat16* hi,
                                           __nv_bfloat16* lo,
                                           const float* src, int g0, int t,
                                           int ldg = D) {
  constexpr int CHUNKS = D / 4;
  static_assert(ROWS * CHUNKS % THREADS == 0, "whole passes of the block");
#pragma unroll
  for (int it = 0; it < ROWS * CHUNKS / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int row = i / CHUNKS, ch = i % CHUNKS;
    const int g = g0 + row;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < t)
      x = *reinterpret_cast<const float4*>(src + (long long)g * ldg + ch * 4);
    uint2 h, l;
    split_pack<__nv_bfloat16>(x.x, x.y, h.x, l.x);
    split_pack<__nv_bfloat16>(x.z, x.w, h.y, l.y);
    *reinterpret_cast<uint2*>(hi + row * LD + ch * 4) = h;
    *reinterpret_cast<uint2*>(lo + row * LD + ch * 4) = l;
  }
}

// c += a b for float32 operands held as bf16 halves a = ah + al,
// b = (bh0, bh1) + (bl0, bl1): three products, the small ones first;
// al bl (~2^-18 of a b) is dropped
__device__ __forceinline__ void mma_split3(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  Mma<__nv_bfloat16>::run(c, al, bh0, bh1);
  Mma<__nv_bfloat16>::run(c, ah, bl0, bl1);
  Mma<__nv_bfloat16>::run(c, ah, bh0, bh1);
}

// ---- TF32: mma.sync.m16n8k8, float32 accumulators ----
//
// Fragment layouts of mma.m16n8k8.tf32 (lane = 4 g + t), one 32-bit
// register a value:
//   A (16 x 8, row major): a0 (row g, k t)   a1 (row g + 8, k t)
//                          a2 (row g, k t+4) a3 (row g + 8, k t+4)
//   B (8 x 8, k x n):      b0 (k t, col g)   b1 (k t+4, col g)
//   C / D: as m16n8k16's.
// A sum over k does not depend on the order of k, so a kernel may read
// k index t as its column 2t and t + 4 as 2t + 1, in A and B alike:
// then a0, a2 (and b0, b1 of a B stored n-major) are neighbours in
// memory, one 8-byte load, and the accumulators c0, c1 (c2, c3) of a
// product with rows m are straight away a0, a2 (a1, a3) of the next
// product over those columns.

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from
// zero), as the bits of a float32 whose low 13 bits are 0
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as hi = tf32(x) and lo = tf32(x - hi): hi + lo holds x to ~2^-22
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a b on TF32 operands
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b for float32 operands held as TF32 halves a = ah + al,
// b = (bh0, bh1) + (bl0, bl1): three products, the small ones first;
// al bl (~2^-22 of a b) is dropped. Half mma_split3's tensor rate, for
// products whose 3xbf16 split misses the float32 tier
__device__ __forceinline__ void mma_split3_tf32(float (&c)[4],
                                                const uint32_t (&ah)[4],
                                                const uint32_t (&al)[4],
                                                uint32_t bh0, uint32_t bh1,
                                                uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// the four values of an A fragment (a0..a3) split into TF32 halves
__device__ __forceinline__ void split_tf32_frag(float x0, float x1, float x2,
                                                float x3, uint32_t (&hi)[4],
                                                uint32_t (&lo)[4]) {
  split_tf32(x0, hi[0], lo[0]);
  split_tf32(x1, hi[1], lo[1]);
  split_tf32(x2, hi[2], lo[2]);
  split_tf32(x3, hi[3], lo[3]);
}

}  // namespace mma_sm90
