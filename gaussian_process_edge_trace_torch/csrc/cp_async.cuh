// cp.async helpers shared by the kernels that stage device memory in shared
// memory (K1, K5, K6): each copy goes from global to shared memory without a
// register, so every copy of a block is in flight at once; the caller waits
// with cp_async_wait_all() and a block barrier.
#pragma once

#include <cuda_runtime.h>

__device__ inline void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ inline void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}
