// cp.async helpers shared by the kernels that stage device memory in shared
// memory (K1, K2, K4, K5, K6): each copy goes from global to shared memory
// without a register, so every copy of a block is in flight at once; the
// caller waits with cp_async_wait_all() and a block barrier.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

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

// n consecutive floats from src into smem (16-byte aligned), the copies
// spread over nthreads threads: 16-byte copies where src is 16-byte aligned
// (then a scalar tail), else 4-byte copies.
__device__ inline void cp_async_row(float* smem, const float* src, int n,
                                    int tid, int nthreads) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = tid; i < n4; i += nthreads)
      cp_async16(smem + 4 * i, src + 4 * i);
    done = 4 * n4;
  }
  for (int i = done + tid; i < n; i += nthreads) cp_async4(smem + i, src + i);
}
