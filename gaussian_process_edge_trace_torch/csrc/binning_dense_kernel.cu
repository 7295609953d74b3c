// K4: dense per-column KDE binning for Hopper (sm_90a).
//
// Replaces gaussian_process_edge_trace_tpu/trace/pallas_kde.py::
// _binning_pallas (kernel _binning_kernel at :25, pallas_call :209): the
// same function as K3,
//
//   H[m, e] = sum_s wv[e,s] * max(0, 1 - |(y[e,s] + 1) - m|),
//   wv[e,s] = w[s] if 0 <= y[e,s] <= M-1, else 0,
//
// in K4's own formulation, a per-column GEMV of the dense (M+2, S) hat with
// the weights.
//
// What bounds it on this card: the function moves the same 8 MB as K3 at
// E = M = S_keep = 1000 (2.4 us at 3.35 TB/s), but this formulation evaluates
// the hat at every (m, e, s), 10^9 taps of ~5 operations there, so its own
// arithmetic bounds it, not the bytes. It is reached only with
// use_pallas_binning=True; the main path runs K3.
//
// Design: one thread per output (m, e) for kRowsPerThread rows m of one
// column e; a warp covers 32 consecutive columns, so the stores of a row are
// coalesced. The block stages a tile of its 32 columns' samples and the
// weights in shared memory (rows padded by one float, so the per-column
// reads hit distinct banks). Each thread sums over the samples in index
// order, with each tap's product rounded as in the plain version (_rn
// intrinsics, no FMA contraction). No atomics: reruns are bitwise equal.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;          // columns per block (blockDim.x)
constexpr int kRowThreads = 8;     // blockDim.y
constexpr int kRowsPerThread = 8;  // rows of H per thread
constexpr int kTile = 256;         // samples staged per pass

__global__ void binning_dense_kernel(const float* __restrict__ y,
                                     const float* __restrict__ w,
                                     float* __restrict__ H, int E, int S,
                                     int M) {
  __shared__ float sy[kCols][kTile + 1];
  __shared__ float sw[kTile];
  const int tid = threadIdx.y * kCols + threadIdx.x;
  const int e0 = blockIdx.x * kCols;
  const int e = e0 + threadIdx.x;
  const int m0 = (blockIdx.y * kRowThreads + threadIdx.y) * kRowsPerThread;
  const float top = (float)(M - 1);

  float acc[kRowsPerThread];
  float rows[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    acc[i] = 0.0f;
    rows[i] = (float)(m0 + i);
  }

  for (int s0 = 0; s0 < S; s0 += kTile) {
    const int n = min(kTile, S - s0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kCols * kTile; i += kCols * kRowThreads) {
      const int cc = i / kTile;
      const int k = i - cc * kTile;
      sy[cc][k] = (e0 + cc < E && k < n) ? y[(size_t)(e0 + cc) * S + s0 + k]
                                         : -10.0f;  // out of image: weight 0
    }
    for (int i = tid; i < kTile; i += kCols * kRowThreads)
      sw[i] = i < n ? w[s0 + i] : 0.0f;
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float yv = sy[threadIdx.x][k];
      const float wv = (yv >= 0.0f && yv <= top) ? sw[k] : 0.0f;
      const float yp = __fadd_rn(yv, 1.0f);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float hat =
            fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(yp, rows[i]))));
        acc[i] = __fadd_rn(acc[i], __fmul_rn(hat, wv));
      }
    }
  }

  if (e >= E) return;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
    if (m0 + i < M + 2) H[(size_t)(m0 + i) * E + e] = acc[i];
}

}  // namespace

extern "C" int gpet_binning_dense(const float* y, const float* w, float* H,
                                  int E, int S, int M, void* stream) {
  const int rows_per_block = kRowThreads * kRowsPerThread;
  dim3 grid((E + kCols - 1) / kCols,
            (M + 2 + rows_per_block - 1) / rows_per_block);
  dim3 block(kCols, kRowThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  binning_dense_kernel<<<grid, block, 0, st>>>(y, w, H, E, S, M);
  return (int)cudaGetLastError();
}
