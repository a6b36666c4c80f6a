// Hopper (sm_90a) primitives shared by the kernels of this directory:
// wgmma with shared-memory operand descriptors and the fences around it.
// Only inline PTX: no CUTLASS, no PyTorch headers.
//
// Shared-memory operand layout ("no swizzle", K-major). wgmma reads an
// operand tile as 8-row x 16-byte core matrices (8 rows of 8 bf16 each,
// 128 contiguous bytes). The kernels store a ROWS x KC tile as
//     16-byte unit (row m, k-unit u = k / 8) at byte (u * ROWS + m) * 16,
// so rows of a core matrix are 16 B apart, the next 8-row group is
// SBO = 128 B away and the next k-unit is LBO = ROWS * 16 B away. One
// wgmma k16 step covers k-units (2s, 2s + 1): its descriptor starts at
// byte 2 s LBO of the tile.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// Matrix descriptor: start address, leading-dimension byte offset (LBO,
// between core matrices adjacent in K), stride-dimension byte offset (SBO,
// between 8-row groups), base offset 0, layout type 0 (no swizzle).
__device__ __forceinline__ uint64_t desc(const void* smem, uint32_t lbo,
                                         uint32_t sbo) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16;
  d |= static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Thread writes to shared memory become visible to wgmma (async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Pins the accumulator registers in program order: the compiler may not
// move their reads or writes across this point (wgmma writes them
// asynchronously, behind the compiler's back, until wgmma_wait_all).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64x64, f32) += A(64x16, bf16) B(16x64, bf16), A and B K-major in
// shared memory. Accumulator layout (thread t of the warpgroup, warp
// w = t / 32, lane l): d[4c + 2i + j] is row 16 w + l / 4 + 8 i, column
// 8 c + 2 (l % 4) + j.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

}  // namespace hopper
