// K5: batched Cholesky factorisation for Hopper (sm_90a).
//
// Replaces gaussian_process_edge_trace_tpu/ops/pallas_chol.py::
// _batched_cholesky_impl (body _chol_kernel_body :36, call _chunk_call
// :148-163), reached through batched_cholesky :302 and cholesky_auto :334.
// For each of B symmetric positive-definite (n, n) matrices it returns the
// lower factor L with L Lᵀ = K and a zero strict upper triangle. A matrix
// that is not positive definite gives NaN from the square root of a
// negative pivot, not an error, as on the TPU; the callers sanitise NaN.
//
// What bounds it on this card: the final fit factors B = 48 to 109 matrices
// of n = 104 per call, ~n³/3 = 0.4 Mflop each. That is far below any
// throughput limit; the n sequential pivot steps, each ending in a block
// barrier, bound it.
//
// Design: one block per matrix, so the batch spreads over the SMs. The
// matrix is factored in place in shared memory (n = 104: 43 KB; n = 160,
// the largest the direct path takes: 100 KB, above the 48 KB default, so the
// launcher raises the dynamic shared-memory limit). Right-looking, no
// pivoting: at step k every thread takes the pivot, the column below it is
// scaled, and the trailing lower triangle gets the rank-1 update, one row per
// warp with the lanes along the row. The scaled column is also copied to a
// small vector so the update reads it without bank conflicts. Each element
// is updated in the same order on every run: the result is deterministic.

#include <cuda_runtime.h>

namespace {

__global__ void batched_chol_kernel(const float* __restrict__ K,
                                    float* __restrict__ L, int n) {
  extern __shared__ float sm[];
  float* a = sm;          // n * n, row-major
  float* colk = sm + n * n;  // n: the scaled column of the current step
  const size_t base = (size_t)blockIdx.x * n * n;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;

  for (int i = tid; i < n * n; i += nt) a[i] = K[base + i];
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    const float d = sqrtf(a[k * n + k]);  // NaN for a negative pivot
    for (int i = k + 1 + tid; i < n; i += nt) {
      const float v = a[i * n + k] / d;
      a[i * n + k] = v;
      colk[i] = v;
    }
    __syncthreads();
    if (tid == 0) a[k * n + k] = d;
    for (int i = k + 1 + warp; i < n; i += nwarps) {
      const float ci = colk[i];
      for (int j = k + 1 + lane; j <= i; j += 32) a[i * n + j] -= ci * colk[j];
    }
    __syncthreads();
  }

  for (int idx = tid; idx < n * n; idx += nt) {
    const int i = idx / n;
    const int j = idx - i * n;
    L[base + idx] = j <= i ? a[idx] : 0.0f;
  }
}

}  // namespace

extern "C" int gpet_batched_cholesky(const float* K, float* L, int B, int n,
                                     void* stream) {
  const size_t smem = (size_t)(n * n + n) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        batched_chol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  batched_chol_kernel<<<B, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      K, L, n);
  return (int)cudaGetLastError();
}
