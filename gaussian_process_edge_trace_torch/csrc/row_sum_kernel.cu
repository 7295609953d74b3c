// K9: the sum of each row of a (rows, n) float32 matrix, every row in one
// launch, in an order set by n alone (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's sums are XLA's. It serves the
// tracing loop's sums over a frame's row (models/gpr.py::frame_sum: the
// sampling round's masked mean and std over the n training slots, and the
// kept curves' weights over S_keep), one row per frame. It is written by
// hand because torch.sum on the card picks its thread layout, and so its
// order of adds, from the number of rows: a batch frame would round apart
// from its single trace. ops/sums.py::tree_sum keeps one order too, but in
// log2(n) launches a sum.
//
// Order: one warp per row; lane l adds elements l, l + 32, l + 64, ... in
// turn from +0, then the 32 partial sums meet in a fixed butterfly of
// __shfl_xor_sync (offsets 16, 8, 4, 2, 1). It depends on n alone: a row's
// sum is the same bits in any launch.
//
// What bounds it on this card: the rows' bytes (rows · n floats) at
// 3.35 TB/s, a few kilobytes on the loop's path: the launch itself.
//
// ops/cuda_frames.py::row_sum_launch_plan mirrors the grid
// (gpet_row_sum_blocks).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
row_sum_kernel(const float* __restrict__ X, float* __restrict__ out, int rows,
               int n) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // a whole warp leaves together
  const float* x = X + (size_t)row * n;
  float acc = 0.f;
  for (int k = lane; k < n; k += 32) acc = __fadd_rn(acc, x[k]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) out[row] = acc;
}

}  // namespace

// Blocks of one launch; ops/cuda_frames.py::row_sum_launch_plan mirrors it.
extern "C" int gpet_row_sum_blocks(int rows) {
  return (rows + kRowsPerBlock - 1) / kRowsPerBlock;
}

extern "C" int gpet_row_sum(const float* X, float* out, int rows, int n,
                            void* stream) {
  if (rows <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  row_sum_kernel<<<gpet_row_sum_blocks(rows), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(X, out, rows, n);
  return (int)cudaGetLastError();
}
