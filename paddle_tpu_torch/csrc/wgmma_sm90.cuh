// Hopper-only helpers shared by the warpgroup attention kernels at head
// dim 256 (flash_fwd_d256_wgmma.cu, flash_bwd_dq_d256_wgmma.cu,
// flash_bwd_dkv_d256_wgmma.cu, flash_fwd_f32_d256_wgmma.cu,
// flash_bwd_dq_f32_d256_wgmma.cu, flash_bwd_dkv_f32_d256_wgmma.cu), at
// head dim 128 (flash_fwd_d128_wgmma.cu, flash_bwd_dq_d128_wgmma.cu,
// flash_bwd_dkv_d128_wgmma.cu, flash_fwd_f32_d128_wgmma.cu,
// flash_bwd_dq_f32_d128_wgmma.cu, flash_bwd_dkv_f32_d128_wgmma.cu) and at
// head dim 64
// (flash_bwd_dkv_f32_d64_wgmma.cu, flash_bwd_dq_f32_d64_wgmma.cu,
// flash_fwd_f32_d64_wgmma.cu): TMA tile loads completing on
// mbarriers, the shared-memory matrix descriptors of wgmma, the seven
// wgmma shapes the kernels run (m64n128k16, m64n64k16, m64n32k16 and
// m64n16k16 with both operands in shared memory, m64n256k16, m64n128k16
// and m64n64k16 with A in registers), the two- and three-piece 16-bit
// splits of float32 values (at head dims 64 and 128 also in place, a warp
// an 8-row group), warpgroup register reallocation
// (setmaxnreg), named barriers, the proxy fence that lets wgmma read
// what threads wrote, the hardware's 2^x, and the host-side tensor maps
// (16-bit tiles swizzled, float32 tiles plain).
// sm_90a only: wgmma and setmaxnreg do not exist on plain sm_90.
//
// Shared tiles are in the layout that TMA's 128-byte swizzle writes and
// wgmma's 128-byte-swizzle descriptors read: a [rows, 256] 16-bit tile
// is four column blocks of 64 (one 128-byte row each; a [rows, 128]
// tile two, a [rows, 64] tile one), each block
// [rows][64] with rows 128 bytes apart and its 16-byte chunk c of row r
// stored at chunk c ^ (r % 8). Every block starts on 1024 bytes.
//
// wgmma fragment layouts (warp w of the warpgroup holds rows 16 w ..
// 16 w + 15; lane = 4 g + t), the same per warp as mma.sync.m16n8k16's:
//   accumulator of m64nN: d[4 j + e], j the 8-column block:
//     e 0, 1: (row g,     cols 8 j + 2 t, + 1)
//     e 2, 3: (row g + 8, cols 8 j + 2 t, + 1)
//   A of m64n256k16 (m64n128k16, m64n64k16) in registers, four 32-bit registers of
//   two halves:
//     a0 (row g, k 2t, 2t+1)  a1 (row g + 8, k 2t, 2t+1)
//     a2 (row g, k 2t+8, +9)  a3 (row g + 8, k 2t+8, +9)
// so accumulator blocks 2 s, 2 s + 1 of one product are, packed in
// pairs, the A registers of k-step s of the next.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgmma_sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive once and expect `bytes` more of TMA traffic in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ----

// box (c0, c1, c2) of the tensor map into shared memory at dst; the
// bytes complete on bar. Coordinates past the tensor's extent read as 0.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// ---- warpgroups ----

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// barrier `id` (1..15) over the `n` threads that reach it
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// arrive at barrier `id` of `n` threads without waiting for it: the
// other side of a named_sync (n counts both sides' threads)
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// order this thread's generic-proxy accesses of shared memory before
// later async-proxy ones (wgmma operand reads, TMA writes): each thread
// that wrote a wgmma operand, or read a buffer TMA refills, fences
// before the barrier that hands it over
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2^x by the hardware's approximation (relative error ~2^-22, results
// below 2^-126 flushed to 0): exp2f's range handling costs a tile of
// exponentials more than its products can hide
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- wgmma ----

// descriptor of a 128-byte-swizzled K-major operand (rows 128 bytes
// apart, 8-row groups `group` bytes apart: 1024 in a dense tile, 2048 in
// a group-interleaved one) starting at p; a k-step of 16 elements
// inside the 64-wide block is p + 16
__device__ __forceinline__ uint64_t desc_k_major(const void* p,
                                                 uint32_t group = 1024) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(group >> 4) << 32) | (1ull << 62);
}

// descriptor of a 128-byte-swizzled MN-major operand: the MN dim runs
// along the 64-wide column blocks (block_bytes apart), the K dim along
// the rows (8-row groups `group` bytes apart, as desc_k_major's); a
// k-step of 16 rows is p + 16 rows
__device__ __forceinline__ uint64_t desc_mn_major(const void* p,
                                                  uint32_t block_bytes,
                                                  uint32_t group = 1024) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(block_bytes >> 4) << 16) |
         ((uint64_t)(group >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving register reads or writes of x across a
// wgmma that is still in flight
__device__ __forceinline__ void reg_fence(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

#define WG_F8(d, i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_F32(d, i) WG_F8(d, i), WG_F8(d, i + 8), WG_F8(d, i + 16), \
                     WG_F8(d, i + 24)

#define WG_REGS32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31}"
#define WG_REGS16                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_REGS64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "       \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "        \
  "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "        \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "        \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "        \
  "%62, %63}"
#define WG_REGS128                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "       \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "        \
  "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "        \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "        \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "        \
  "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "        \
  "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "        \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "        \
  "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "          \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "        \
  "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

template <typename T>
struct Wgmma;

// d (+)= A B, A [64 x 16] and B [16 x 128] both K-major in shared memory
// (descriptors da, db); accumulate: 0 overwrites d, 1 adds to it
#define WG_SS_128(TY)                                                    \
  static __device__ __forceinline__ void ss128(float (&d)[64],           \
                                               uint64_t da, uint64_t db, \
                                               int accumulate) {         \
    asm volatile(                                                        \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                     \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "     \
        WG_REGS64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"                       \
        : WG_F32(d, 0), WG_F32(d, 32)                                    \
        : "l"(da), "l"(db), "r"(accumulate));                            \
  }

// d (+)= A B, A [64 x 16] and B [16 x 64] both K-major in shared memory
// (descriptors da, db); accumulate: 0 overwrites d, 1 adds to it
#define WG_SS_64(TY)                                                     \
  static __device__ __forceinline__ void ss64(float (&d)[32], uint64_t da, \
                                              uint64_t db, int accumulate) { \
    asm volatile(                                                        \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                     \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "      \
        WG_REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"                      \
        : WG_F32(d, 0)                                                   \
        : "l"(da), "l"(db), "r"(accumulate));                            \
  }

// d (+)= A B, A [64 x 16] and B [16 x 32] both K-major in shared memory
#define WG_SS_32(TY)                                                     \
  static __device__ __forceinline__ void ss32(float (&d)[16], uint64_t da, \
                                              uint64_t db, int accumulate) { \
    asm volatile(                                                        \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                     \
        "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "      \
        WG_REGS16 ", %16, %17, p, 1, 1, 0, 0;\n}\n"                      \
        : WG_F8(d, 0), WG_F8(d, 8)                                       \
        : "l"(da), "l"(db), "r"(accumulate));                            \
  }

// d (+)= A B, A [64 x 16] and B [16 x 16] both K-major in shared memory
#define WG_SS_16(TY)                                                     \
  static __device__ __forceinline__ void ss16(float (&d)[8], uint64_t da, \
                                              uint64_t db, int accumulate) { \
    asm volatile(                                                        \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"                     \
        "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " "      \
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"  \
        : WG_F8(d, 0)                                                    \
        : "l"(da), "l"(db), "r"(accumulate));                            \
  }

// d += A B, A [64 x 16] in registers (a), B [16 x 256] MN-major in
// shared memory (descriptor db)
#define WG_RS_256(TY)                                                    \
  static __device__ __forceinline__ void rs256(float (&d)[128],          \
                                               const uint32_t (&a)[4],   \
                                               uint64_t db) {            \
    asm volatile(                                                        \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                    \
        "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "     \
        WG_REGS128 ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"  \
        : WG_F32(d, 0), WG_F32(d, 32), WG_F32(d, 64), WG_F32(d, 96)      \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));  \
  }

// d += A B, A [64 x 16] in registers (a), B [16 x 128] MN-major in
// shared memory (descriptor db)
#define WG_RS_128(TY)                                                    \
  static __device__ __forceinline__ void rs128(float (&d)[64],           \
                                               const uint32_t (&a)[4],   \
                                               uint64_t db) {            \
    asm volatile(                                                        \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                     \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "     \
        WG_REGS64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"         \
        : WG_F32(d, 0), WG_F32(d, 32)                                    \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));  \
  }

// d += A B, A [64 x 16] in registers (a), B [16 x 64] MN-major in shared
// memory (descriptor db)
#define WG_RS_64(TY)                                                     \
  static __device__ __forceinline__ void rs64(float (&d)[32],            \
                                              const uint32_t (&a)[4],    \
                                              uint64_t db) {             \
    asm volatile(                                                        \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                     \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "      \
        WG_REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"         \
        : WG_F32(d, 0)                                                   \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));  \
  }

template <>
struct Wgmma<__nv_bfloat16> {
  WG_SS_128("bf16")
  WG_SS_64("bf16")
  WG_SS_32("bf16")
  WG_SS_16("bf16")
  WG_RS_256("bf16")
  WG_RS_128("bf16")
  WG_RS_64("bf16")
  static __device__ __forceinline__ uint32_t pack(float x, float y) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  }
  static constexpr CUtensorMapDataType TMA_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

template <>
struct Wgmma<__half> {
  WG_SS_128("f16")
  WG_SS_64("f16")
  WG_SS_32("f16")
  WG_SS_16("f16")
  WG_RS_256("f16")
  WG_RS_128("f16")
  WG_RS_64("f16")
  static __device__ __forceinline__ uint32_t pack(float x, float y) {
    __half2 h = __floats2half2_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __half22float2(*reinterpret_cast<__half2*>(&u));
  }
  static constexpr CUtensorMapDataType TMA_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

#undef WG_SS_128
#undef WG_SS_64
#undef WG_SS_32
#undef WG_SS_16
#undef WG_RS_256
#undef WG_RS_128
#undef WG_RS_64

// (x, y) as a pair rounded to T (hi) and the pair of what that rounding
// lost, rounded again (lo): hi + lo keeps ~16 significant bits
template <typename T>
__device__ __forceinline__ void split_pack(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  hi = Wgmma<T>::pack(x, y);
  const float2 h = Wgmma<T>::unpack(hi);
  lo = Wgmma<T>::pack(x - h.x, y - h.y);
}

// (x, y) in three pieces: hi as split_pack's, mid the pair of what hi
// lost rounded to T, lo the pair of what hi + mid lost rounded again:
// hi + mid + lo keeps ~24 significant bits in bf16 (the float32 value,
// within its exponent range)
template <typename T>
__device__ __forceinline__ void split3_pack(float x, float y, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  hi = Wgmma<T>::pack(x, y);
  const float2 h = Wgmma<T>::unpack(hi);
  const float rx = x - h.x, ry = y - h.y;
  mid = Wgmma<T>::pack(rx, ry);
  const float2 m = Wgmma<T>::unpack(mid);
  lo = Wgmma<T>::pack(rx - m.x, ry - m.y);
}

// element offset of (row r, column c) in a swizzled [rows, 256] tile of
// `rows` rows (four [rows][64] column blocks; the first two of them in a
// [rows, 128] tile, the first in a [rows, 64] one)
template <int ROWS>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * ROWS * 64 + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) +
         (c & 7);
}

// the NP 16-bit pieces (split_pack's for NP 2, split3_pack's for NP 3)
// of the 8 float32 values a, b at row r, columns c .. c + 7, into the
// swizzled [ROWS, COLS] tiles dst + p ROWS COLS (piece p)
template <int ROWS, int NP, int COLS = 256>
__device__ __forceinline__ void store_pieces(__nv_bfloat16* dst, int r,
                                             int c, float4 a, float4 b) {
  using bf16 = __nv_bfloat16;
  static_assert(NP == 2 || NP == 3, "two or three pieces");
  const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t pc[3][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (NP == 2)
      split_pack<bf16>(x[2 * i], x[2 * i + 1], pc[0][i], pc[1][i]);
    else
      split3_pack<bf16>(x[2 * i], x[2 * i + 1], pc[0][i], pc[1][i],
                        pc[2][i]);
  }
  const int o = swz<ROWS>(r, c);
#pragma unroll
  for (int p = 0; p < NP; ++p)
    *reinterpret_cast<uint4*>(dst + p * ROWS * COLS + o) =
        make_uint4(pc[p][0], pc[p][1], pc[p][2], pc[p][3]);
}

// split the row-major [rows][COLS] float32 tile src into rows [r0, r0 +
// rows) of the NP pieces of a ROWS-row tile at dst (store_pieces),
// thread i of N taking 8 columns a pass
template <int ROWS, int NP, int N, int COLS = 256>
__device__ __forceinline__ void split_tile(__nv_bfloat16* dst,
                                           const float* src, int i,
                                           int rows = ROWS, int r0 = 0) {
  constexpr int U = COLS / 8;  // 8-column units a row
#pragma unroll 4
  for (int u = i; u < rows * U; u += N) {
    const int r = u / U, c = (u % U) * 8;
    store_pieces<ROWS, NP, COLS>(
        dst, r0 + r, c, *reinterpret_cast<const float4*>(src + r * COLS + c),
        *reinterpret_cast<const float4*>(src + r * COLS + c + 4));
  }
}

// the same in place: the NP pieces overwrite the float32 tile they come
// from, so each of the N threads holds its share of the tile in
// registers until all N have read theirs (named barrier `bar`)
template <int ROWS, int NP, int N, int COLS = 256>
__device__ __forceinline__ void split_tile_in_place(float* tile, int i,
                                                    int bar) {
  constexpr int U = COLS / 8;
  constexpr int PASSES = (ROWS * U + N - 1) / N;
  float4 a[PASSES], b[PASSES];
#pragma unroll
  for (int k = 0; k < PASSES; ++k) {
    const int u = i + k * N, r = u / U, c = (u % U) * 8;
    if (u < ROWS * U) {
      a[k] = *reinterpret_cast<const float4*>(tile + r * COLS + c);
      b[k] = *reinterpret_cast<const float4*>(tile + r * COLS + c + 4);
    }
  }
  named_sync(bar, N);
#pragma unroll
  for (int k = 0; k < PASSES; ++k) {
    const int u = i + k * N;
    if (u < ROWS * U)
      store_pieces<ROWS, NP, COLS>(reinterpret_cast<__nv_bfloat16*>(tile),
                                   u / U, (u % U) * 8, a[k], b[k]);
  }
}

// ---- head dims 64 and 128: tiles interleaved by 8-row group ----
//
// A float32 row of 64 columns is 256 bytes and a 16-bit piece's row 128,
// so an 8-row group of a row-major [rows][64] float32 tile (2048 bytes)
// is exactly as long as its hi and lo pieces' groups (1024 bytes each).
// In a group-interleaved [rows, 64] tile group g's hi block lies at
// byte 2048 g and its lo block at 2048 g + 1024, each the
// 128-byte-swizzled [8][64] block wgmma reads (desc_k_major and
// desc_mn_major with `group` GROUP_BYTES): a float32 tile landed there
// by TMA is split in place one group at a time, by one warp holding 16
// values a lane, with no other thread waiting for it.
//
// At head dim 128 a float32 row is 512 bytes and a group 4096: group g
// of a group-interleaved [rows, 128] tile holds its hi piece's two
// column blocks at byte 4096 g and 4096 g + 1024 and its lo piece's at
// 4096 g + 2048 and + 3072 (`group` GROUP_BYTES_D128; a K-major k-step
// past column 64 starts CBLOCK_ELEMS further on, and an MN-major
// operand's two column blocks lie CBLOCK_BYTES apart). One warp splits
// a group holding 32 values a lane.
constexpr uint32_t GROUP_BYTES = 2048;
constexpr int GROUP_ELEMS = GROUP_BYTES / 2;  // 16-bit elements a group
constexpr int LO_ELEMS = GROUP_ELEMS / 2;     // the lo block's offset
constexpr uint32_t GROUP_BYTES_D128 = 4096;
constexpr int GROUP_ELEMS_D128 = GROUP_BYTES_D128 / 2;
constexpr int LO_ELEMS_D128 = GROUP_ELEMS_D128 / 2;
constexpr uint32_t CBLOCK_BYTES = 1024;       // one swizzled [8][64] block
constexpr int CBLOCK_ELEMS = CBLOCK_BYTES / 2;

// split 8-row group g of the row-major [rows][COLS] float32 tile at
// `tile` (COLS 64 or 128) in place into its bf16 hi and lo blocks
// (split_pack), by the 32 lanes of one warp
template <int COLS = 64>
__device__ __forceinline__ void split_group_in_place(float* tile, int g,
                                                     int lane) {
  static_assert(COLS == 64 || COLS == 128, "head dim 64 or 128");
  constexpr int VEC = COLS / 16;   // float4 a lane
  constexpr int ROW4 = COLS / 4;   // float4 a row
  float* src = tile + g * 8 * COLS;
  float4 x[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    x[k] = reinterpret_cast<const float4*>(src)[lane + 32 * k];
  __syncwarp();
  __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(src);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int f = lane + 32 * k, r = f / ROW4, c = (f % ROW4) * 4;
    const int cc = c & 63;
    uint32_t h0, l0, h1, l1;
    split_pack<__nv_bfloat16>(x[k].x, x[k].y, h0, l0);
    split_pack<__nv_bfloat16>(x[k].z, x[k].w, h1, l1);
    const int o = (c >> 6) * CBLOCK_ELEMS + r * 64 +
                  ((((cc >> 3) ^ r) & 7) << 3) + (cc & 7);
    *reinterpret_cast<uint2*>(dst + o) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(dst + 8 * COLS + o) = make_uint2(l0, l1);
  }
}

// ---- host: tensor maps ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled through the runtime, so that the
// library links against the runtime alone
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? (EncodeTiledFn)p : nullptr;
  }();
  return fn;
}

// tensor map of a contiguous [bh, t, COLS] 16-bit tensor (COLS 256 or
// 128) read in boxes of (64 columns, rows, 1 slice), 128-byte swizzled;
// rows past t read as 0. Returns a CUDA error code (0 = ok).
template <typename T, int COLS = 256>
int make_map(CUtensorMap* map, const void* base, int bh, int t, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {COLS, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {COLS * sizeof(T),
                                 (cuuint64_t)t * COLS * sizeof(T)};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, Wgmma<T>::TMA_TYPE, 3, const_cast<void*>(base),
                        dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// tensor map of a contiguous [bh, t, COLS] float32 tensor (COLS 256, 128
// or 64) read in boxes of (all COLS columns, rows, 1 slice), unswizzled: a
// box lands as a row-major [rows][COLS] float32 tile; rows past t read
// as 0. Returns a CUDA error code (0 = ok).
template <int COLS = 256>
int make_map_f32(CUtensorMap* map, const void* base, int bh, int t,
                 int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {COLS, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {COLS * sizeof(float),
                                 (cuuint64_t)t * COLS * sizeof(float)};
  const cuuint32_t box[3] = {COLS, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace wgmma_sm90
