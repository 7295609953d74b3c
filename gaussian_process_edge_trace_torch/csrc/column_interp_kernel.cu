// K2: per-column linear interpolation for Hopper (sm_90a).
//
// Replaces gaussian_process_edge_trace_tpu/ops/pallas_interp.py::
// _column_interp_pallas_2l (kernel :124, pallas_call :200) and
// ::_column_interp_pallas (kernel :40, pallas_call :69), which are two TPU
// forms of one function:
//
//   out[e, s] = lerp(cols[e, :], clip(ys[e, s], 0, M-1)) + add_const
//
// Frames: ys may hold B frames, (B, E, S), each with its own (E, M) columns
// or all sharing one (cols_shared: the frames of a multi-edge trace). The
// frames' rows simply follow each other, B*E rows in all; the arithmetic of
// an element does not depend on B, so a frame's output is bitwise that of a
// single-frame launch.
//
// Where the path runs it: the curve cost of every iteration whose edge
// length E is odd (K1 serves only an even E), over the whole (E, S) sample
// grid (E = 999, M = 1000, S = 10^4 on the 1000^2 config with its right
// endpoint one column in), and the final cost of every trace (S = 1).
//
// What bounds it on this card: it reads ys and writes out once, 8 bytes per
// element, and needs at most two entries of cols per sample: 83.9 MB at
// E = 999, M = 1000, S = 10^4, 0.025 ms at 3.35 TB/s. Its arithmetic is ~15
// instructions per element, well under the bytes. At S = 1 it is a few
// thousand elements, and launch latency bounds it.
//
// Design (the launch plan is ops/cuda_interp.py::k2_launch_plan):
// - Tiled layout, for a sample count that outweighs the column: a 2-D grid
//   of (column e, sample tile), so no thread divides an index by S. A block
//   stages cols[e, :] (4 KB at M = 1000) in shared memory with cp.async and
//   reads both taps of every sample from there. Each thread takes 4
//   consecutive samples at a time, with one 16-byte load of ys and one
//   16-byte store of out, the next load in flight while it computes; a
//   block's range that does not start on 16 bytes (S % 4 != 0) takes a
//   scalar head and tail. The first load is issued before the staging is
//   waited for.
// - Flat layout, for few samples per column (the final cost, S = 1): one
//   thread per element, taps from L1/L2; staging a column there would read
//   4 KB to use 8 bytes of it.
// - One arithmetic for both, that of _column_interp_gather
//   (pallas_interp.py:458-466). The multiply and adds use the _rn intrinsics
//   so that nvcc does not contract them into an FMA: each op rounds once, as
//   in the plain PyTorch version, and the two agree bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

namespace {

__device__ __forceinline__ float lerp_col(const float* row, float yv, int M,
                                          float add_const) {
  const float y = fminf(fmaxf(yv, 0.0f), (float)(M - 1));
  const int r0 = min((int)floorf(y), M - 2);
  const float f = __fsub_rn(y, (float)r0);
  const float v0 = row[r0];
  const float v1 = row[r0 + 1];
  const float res = __fadd_rn(v0, __fmul_rn(f, __fsub_rn(v1, v0)));
  return add_const != 0.0f ? __fadd_rn(res, add_const) : res;
}

// Row r of the B*E rows reads column r, or r % E where the frames share
// one (E, M) set of columns.
__device__ __forceinline__ const float* col_of(const float* cols, int r,
                                               int E, int M,
                                               int cols_shared) {
  return cols + (size_t)(cols_shared ? r % E : r) * M;
}

__global__ void column_interp_flat_kernel(const float* __restrict__ cols,
                                          const float* __restrict__ ys,
                                          float* __restrict__ out, int total,
                                          int E, int M, int S,
                                          float add_const, int cols_shared) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int r = idx / S;
  out[idx] = lerp_col(col_of(cols, r, E, M, cols_shared), ys[idx], M,
                      add_const);
}

// gridDim = (B*E, tiles): block (r, t) takes samples [t*span, (t+1)*span)
// of row r. vec: ys and out share their 16-byte phase, so float4 is usable.
__global__ void column_interp_tiled_kernel(const float* __restrict__ cols,
                                           const float* __restrict__ ys,
                                           float* __restrict__ out, int E,
                                           int M, int S, int span,
                                           float add_const, int vec,
                                           int cols_shared) {
  extern __shared__ __align__(16) float row[];
  const int r = blockIdx.x;
  const int s_b = blockIdx.y * span;
  const int n = min(S, s_b + span) - s_b;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  cp_async_row(row, col_of(cols, r, E, M, cols_shared), M, tid, nt);

  const float* yr = ys + (size_t)r * S + s_b;
  float* orow = out + (size_t)r * S + s_b;
  const int head =
      vec ? min(n, (int)(((16 - (reinterpret_cast<uintptr_t>(yr) & 15)) & 15)
                         >> 2))
          : n;
  const int n4 = (n - head) >> 2;
  const float4* y4 = reinterpret_cast<const float4*>(yr + head);
  float4* o4 = reinterpret_cast<float4*>(orow + head);
  int i = tid;
  float4 v = i < n4 ? __ldg(y4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  cp_async_wait_all();
  __syncthreads();  // the column is staged

  for (; i < n4; i += nt) {
    const int j = i + nt;
    const float4 next = j < n4 ? __ldg(y4 + j) : v;
    float4 r;
    r.x = lerp_col(row, v.x, M, add_const);
    r.y = lerp_col(row, v.y, M, add_const);
    r.z = lerp_col(row, v.z, M, add_const);
    r.w = lerp_col(row, v.w, M, add_const);
    o4[i] = r;
    v = next;
  }
  for (int k = tid; k < head; k += nt)
    orow[k] = lerp_col(row, yr[k], M, add_const);
  for (int k = head + 4 * n4 + tid; k < n; k += nt)
    orow[k] = lerp_col(row, yr[k], M, add_const);
}

}  // namespace

// Shared-memory bytes of one block (not a kernel): the staged column of the
// tiled layout, none for the flat one.
extern "C" int gpet_column_interp_smem(int M, int tiled) {
  return tiled ? M * (int)sizeof(float) : 0;
}

// tiles == 0: the flat layout, ceil(B*E*S / threads) blocks; else the tiled
// one, a (B*E, tiles) grid of blocks of span samples each.
extern "C" int gpet_column_interp(const float* cols, const float* ys,
                                  float* out, int E, int M, int S,
                                  float add_const, int tiles, int span,
                                  int threads, int frames, int cols_shared,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (frames < 1) return (int)cudaErrorInvalidValue;
  if (tiles == 0) {
    const int total = frames * E * S;
    column_interp_flat_kernel<<<(total + threads - 1) / threads, threads, 0,
                                st>>>(cols, ys, out, total, E, M, S,
                                      add_const, cols_shared);
    return (int)cudaGetLastError();
  }
  const int smem = gpet_column_interp_smem(M, 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        column_interp_tiled_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec = ((reinterpret_cast<uintptr_t>(ys) ^
                    reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  column_interp_tiled_kernel<<<dim3(frames * E, tiles), threads, smem, st>>>(
      cols, ys, out, E, M, S, span, add_const, vec, cols_shared);
  return (int)cudaGetLastError();
}
