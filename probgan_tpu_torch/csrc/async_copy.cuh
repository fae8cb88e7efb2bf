// cp.async helpers shared by the kernels that stream tiles through a ring of
// shared-memory stages (rank_topk_bf16.cu, packed_conv_wgrad.cu).
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

}  // namespace probgan
