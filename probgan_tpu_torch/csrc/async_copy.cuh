// Copy helpers shared by the kernels that stream tiles through a ring of
// shared-memory stages: cp.async (rank_topk_bf16.cu, packed_conv_wgrad.cu,
// packed_conv.cu's "none" kernel) and the Tensor Memory Accelerator's bulk
// copies with their mbarriers (rank_ring.cuh: rank_scores.cu, rank_topk.cu).
#pragma once

#include <cuda_runtime.h>

namespace probgan {

// 16 bytes from global to shared memory, bypassing L1 (.cg). With `valid`
// false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int src_size = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(src_size)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n committed groups are still in flight (n in 0..3).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0:
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      break;
    case 1:
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      break;
    case 2:
      asm volatile("cp.async.wait_group 2;\n" ::: "memory");
      break;
    default:
      asm volatile("cp.async.wait_group 3;\n" ::: "memory");
      break;
  }
}

// One-dimensional bulk copies (cp.async.bulk, the Tensor Memory Accelerator):
// one thread starts a copy of any multiple of 16 bytes between 16-byte
// aligned addresses, and its completion is counted in bytes on an mbarrier
// in shared memory. A phase of the barrier ends when its one expected
// arrival (arrive_expect_tx, which also adds the bytes to wait for) has come
// and every one of those bytes has landed.
__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_address(bar)),
               "r"(arrivals)
               : "memory");
}

// Makes the initialized barriers visible to the copy engine; a
// __syncthreads() must follow before any thread uses them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_address(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has ended.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\tWAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@!P1 bra WAIT;\n\t}\n" ::"r"(smem_address(bar)),
      "r"(parity)
      : "memory");
}

// Orders this thread's earlier generic-proxy accesses to shared memory
// before later bulk copies into it (a __syncthreads() then hands the order to
// the thread that issues them).
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` from global to shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(void* smem_dst, const void* gmem_src,
                                              unsigned bytes, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_address(smem_dst)),
      "l"(gmem_src), "r"(bytes), "r"(smem_address(bar))
      : "memory");
}

}  // namespace probgan
