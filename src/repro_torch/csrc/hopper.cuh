// Hopper (sm_90a) primitives shared by the port's tensor-core kernels
// (matmul.cu, flash_attention.cu): shared-memory addresses, mbarriers, 4-D
// TMA loads, wgmma (fence, commit, wait, the m64nNk16 bf16 -> fp32
// products with A from shared memory or from registers), the 128-byte
// swizzled shared-memory layout and its descriptors, and libcuda's
// cuTensorMapEncodeTiled.  The library built from each source hashes this
// header too (kernels/build.py library_path), so an edit rebuilds both.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// The retry loop lives inside the asm: a loop the compiler can see would
// make the wgmma after it look divergent, and ptxas then serializes them.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from reading an accumulator before wgmma_wait.
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// setmaxnreg: a warpgroup gives up (dec) or takes (inc) registers, all
// its warps together; the counts must sum to what the CTA launched with.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// fence_regs for bf16 pairs held as the A operand of a wgmma: keeps the
// registers live, unchanged, until after wgmma_wait.
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// The fp32 accumulator fragment of a wgmma as asm operands, four and
// sixteen registers from d[i].
#define REPRO_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define REPRO_D16(i) \
  REPRO_D4(i), REPRO_D4(i + 4), REPRO_D4(i + 8), REPRO_D4(i + 12)

// D (+)= A B, wgmma m64nNk16 bf16 x bf16 -> fp32, A and B from shared
// memory.  TA / TB are the transpose bits: 0 for a K-major tile, 1 for an
// MN-major one.  ``acc`` 0 overwrites D, anything else adds to it.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int acc) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: N 32, 64, 128");
  if constexpr (N == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n"
        "}\n"
        : REPRO_D16(0)
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n"
        "}\n"
        : REPRO_D16(0), REPRO_D16(16)
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n"
        "}\n"
        : REPRO_D16(0), REPRO_D16(16), REPRO_D16(32), REPRO_D16(48)
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
}

// D (+)= A B, wgmma m64nNk16 bf16 x bf16 -> fp32, A from registers (four
// bf16 pairs a thread, the accumulator's fragment layout), B from shared
// memory with transpose bit TB.  ``acc`` 0 overwrites D.
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db, int acc) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : REPRO_D16(0), REPRO_D16(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
          "n"(TB));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
        "}\n"
        : REPRO_D16(0), REPRO_D16(16), REPRO_D16(32), REPRO_D16(48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
          "n"(TB));
  }
}

#undef REPRO_D16
#undef REPRO_D4

// Shared-memory matrix descriptor for wgmma, 128-byte swizzle (layout type
// 1 in bits 62-63), 8-row groups 1024 B apart (SBO).  LBO is unused by a
// K-major tile (1); for an MN-major one it is the distance between its
// 64-wide MN blocks.  Every tile starts on a 1024-byte boundary.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// The matmul's tiles: a K-major tile is rows of 64 bf16 (128 B), a k16
// step moves the start 32 B along the row.  An MN-major tile is 64-wide
// MN blocks of 64 k-rows (8 KB apart, LBO), a k16 step moves the start 16
// k-rows (2048 B).
template <int T>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int kk) {
  return T == 0 ? desc_sw128(addr + kk * 32, 16)
                : desc_sw128(addr + kk * 2048, 8192);
}

// Byte offset of element (r, kk) of a tile in the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk index XOR the row index
// within its 8-row (1024-byte) group.
template <int T>
__device__ __forceinline__ uint32_t swizzled(int r, int kk) {
  if (T == 0) return r * 128 + ((((kk >> 3) ^ r) & 7) << 4) + (kk & 7) * 2;
  return (r >> 6) * 8192 + kk * 128 + (((((r & 63) >> 3) ^ kk) & 7) << 4) +
         (r & 7) * 2;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime so that
// the library needs no -lcuda; null where libcuda lacks it.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(sym);
  }
  return fn;
}

}  // namespace
