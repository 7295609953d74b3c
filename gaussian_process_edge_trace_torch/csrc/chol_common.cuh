// Shared pieces of K5 (batched_chol_kernel.cu) and K6
// (batched_trsm_kernel.cu): the shared-memory row stride and the copy-in of
// a lower triangle with cp.async, so that every 16-byte load of a block is
// in flight at once instead of one row after another.
#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace gpet_chol {

constexpr int kSmemLimit = 232448;  // dynamic shared memory of one block

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Row stride of a matrix in shared memory, in floats: n rounded up to a
// multiple of 4 with an odd number of float4s, so float4 reads of 8
// consecutive rows at one column (a quarter warp) hit 8 distinct 16-byte
// bank groups. ops/cuda_chol.py::smem_ld mirrors it.
__host__ __device__ inline int smem_ld(int n) {
  const int q = (n + 3) >> 2;
  return 4 * (q | 1);
}


// Start the copy of the lower triangle of the (n, n) row-major matrix src
// into dst with row stride ld: row i, columns < round4(i + 1) with 16-byte
// copies when vec (n % 4 == 0 and src 16-byte aligned), else columns <= i.
// The caller waits with cp_async_wait_all() and a block barrier.
__device__ inline void copy_lower_async(const float* __restrict__ src,
                                        float* dst, int n, int ld, int vec) {
  if (vec) {
    const int q4 = n >> 2;
    for (int idx = threadIdx.x; idx < n * q4; idx += blockDim.x) {
      const int i = idx / q4;
      const int j = 4 * (idx - i * q4);
      if (j <= i) cp_async16(dst + i * ld + j, src + (size_t)i * n + j);
    }
  } else {
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
      const int i = idx / n;
      const int j = idx - i * n;
      if (j <= i) cp_async4(dst + i * ld + j, src + idx);
    }
  }
}

}  // namespace gpet_chol
