// K6: batched triangular solves for Hopper (sm_90a).
//
// Replaces gaussian_process_edge_trace_tpu/ops/pallas_chol.py::
// _solve_one_block (:274; bodies _fwd_solve_kernel_body :93 and
// _bwd_solve_kernel_body :119), reached through batched_forward_solve :307,
// batched_backward_solve :312 and the m-chunking of _batched_solve_impl :245.
// For B lower-triangular (n, n) factors L and right-hand sides R (B, n, m):
//
//   transpose = 0:  solve L  Z = R   (forward substitution)
//   transpose = 1:  solve Lᵀ Z = R   (backward substitution)
//
// What bounds it on this card: the final fit solves with m = 1 (the dual
// coefficients) and with m = n = 104 (the identity right-hand side that forms
// K⁻¹), B = 48 to 109. The work is n²·m/2 multiply-adds per matrix, a few
// Mflop per call; the n dependent row steps of each column bound it.
//
// Design: one block per (matrix, chunk of up to 128 right-hand-side
// columns), one thread per column. L and the chunk of Z sit in shared memory
// (n = 104, 128 columns: 43 + 53 KB; n = 160: 100 + 80 KB, so the launcher
// raises the dynamic shared-memory limit). Z is stored column-minor, so the
// threads of a warp touch consecutive words; the row of L (forward) or the
// column of L (backward) is the same address for every thread, a broadcast.
// Every column is substituted row by row in a fixed order: no atomics, and
// the result is deterministic.

#include <cuda_runtime.h>

namespace {

__global__ void batched_trsm_kernel(const float* __restrict__ L,
                                    const float* __restrict__ R,
                                    float* __restrict__ Z, int n, int m,
                                    int transpose) {
  extern __shared__ float sm[];
  const int nt = blockDim.x;
  float* l = sm;           // n * n
  float* z = sm + n * n;   // n * nt, z[i * nt + t]
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * nt;
  const int tid = threadIdx.x;
  const int col = c0 + tid;
  const bool active = col < m;
  const size_t lbase = (size_t)b * n * n;
  const size_t rbase = (size_t)b * n * m;

  for (int i = tid; i < n * n; i += nt) l[i] = L[lbase + i];
  if (active)
    for (int i = 0; i < n; ++i) z[i * nt + tid] = R[rbase + (size_t)i * m + col];
  __syncthreads();

  if (active) {
    if (!transpose) {
      for (int i = 0; i < n; ++i) {
        float acc = z[i * nt + tid];
        const float* li = l + i * n;
        for (int j = 0; j < i; ++j) acc -= li[j] * z[j * nt + tid];
        z[i * nt + tid] = acc / li[i];
      }
    } else {
      for (int i = n - 1; i >= 0; --i) {
        float acc = z[i * nt + tid];
        for (int j = i + 1; j < n; ++j) acc -= l[j * n + i] * z[j * nt + tid];
        z[i * nt + tid] = acc / l[i * n + i];
      }
    }
    for (int i = 0; i < n; ++i) Z[rbase + (size_t)i * m + col] = z[i * nt + tid];
  }
}

}  // namespace

extern "C" int gpet_batched_trsm(const float* L, const float* R, float* Z,
                                 int B, int n, int m, int transpose,
                                 void* stream) {
  // Up to 128 columns a block; a narrow right-hand side gets one warp.
  int threads = ((m + 31) / 32) * 32;
  if (threads > 128) threads = 128;
  const size_t smem = (size_t)(n * n + n * threads) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        batched_trsm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((m + threads - 1) / threads, B);
  batched_trsm_kernel<<<grid, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(L, R, Z, n, m,
                                                            transpose);
  return (int)cudaGetLastError();
}
