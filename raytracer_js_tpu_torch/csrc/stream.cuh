// Helpers shared by the search kernels (nearest_hit.cu) and the tiled bounce
// kernels (trace_tiled.cu): lane ids and the cp.async copies that fill their
// shared-memory staging rings. Included inside each source's anonymous
// namespace, so every translation unit keeps its own internal copy.
#pragma once

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copies bypass L1 (.cg); 8- and 4-byte copies must go through it
// (.ca is the only form the PTX ISA allows for them).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
