// Asynchronous global -> shared copies (sm_80+ `cp.async`) for the
// pipelined kernels K2 (chunk-major form) and K6. A copy of `src_bytes`
// < `bytes` fills the rest of the destination with zeros, so a masked
// element is staged as 0 without a branch around the copy.

#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, cached in L2 only; dst and src 16-byte aligned; src_bytes 0 or 16
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes; dst and src 4-byte aligned; src_bytes 0 or 4
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
