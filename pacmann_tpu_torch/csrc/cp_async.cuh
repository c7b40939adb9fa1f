// Asynchronous global -> shared copies for the pipelined kernels K2, K6,
// K7a and K7c: sm_80+ `cp.async`, where a copy of `src_bytes` < `bytes`
// fills the rest of the destination with zeros (a masked element is staged
// as 0 without a branch around the copy); and sm_90's bulk copy
// (`cp.async.bulk`, the TMA engine moving one contiguous range), whose
// completion a shared-memory mbarrier counts in bytes.

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

// an mbarrier in shared memory, expecting `count` arrivals a phase; the
// init is made visible to the bulk-copy engine before any copy names it
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` more to land in this phase
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16; dst and src 16-byte aligned) from global to
// shared memory by the TMA engine, counted on `bar` as they land
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// one box of a 3-D tensor map (`map`: a CUtensorMap in parameter, constant
// or global memory) at coordinates (x, y, z), innermost first, from global
// to shared memory (128-byte aligned) by the TMA engine, counted on `bar`;
// elements outside the tensor land as zeros
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, int x,
                                            int y, int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(x), "r"(y), "r"(z), "r"(smem_addr(bar))
      : "memory");
}
