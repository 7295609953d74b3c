// K2: per-column linear interpolation for Hopper (sm_90a).
//
// Replaces gaussian_process_edge_trace_tpu/ops/pallas_interp.py::
// _column_interp_pallas_2l (kernel :124, pallas_call :200) and
// ::_column_interp_pallas (kernel :40, pallas_call :69), which are two TPU
// forms of one function:
//
//   out[e, s] = lerp(cols[e, :], clip(ys[e, s], 0, M-1)) + add_const
//
// What bounds it on this card: it reads ys and writes out once, 8 bytes per
// element, plus two 4-byte reads of cols that hit L1/L2. At the path's shapes
// (the final cost, S = 1, and the unfused cost at S < 128) the call is a few
// hundred to a few thousand elements, so launch latency bounds it.
//
// Design: one thread per (e, s), the arithmetic of _column_interp_gather
// (pallas_interp.py:458-466). The multiply and adds use the _rn intrinsics so
// that nvcc does not contract them into an FMA: each op rounds once, as in the
// plain PyTorch version, and the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

__global__ void column_interp_kernel(const float* __restrict__ cols,
                                     const float* __restrict__ ys,
                                     float* __restrict__ out, int E, int M,
                                     int S, float add_const) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)E * S) return;
  const int e = (int)(idx / S);
  const float y = fminf(fmaxf(ys[idx], 0.0f), (float)(M - 1));
  const int r0 = min((int)floorf(y), M - 2);
  const float f = __fsub_rn(y, (float)r0);
  const float* row = cols + (size_t)e * M;
  const float v0 = row[r0];
  const float v1 = row[r0 + 1];
  const float res = __fadd_rn(v0, __fmul_rn(f, __fsub_rn(v1, v0)));
  out[idx] = add_const != 0.0f ? __fadd_rn(res, add_const) : res;
}

}  // namespace

extern "C" int gpet_column_interp(const float* cols, const float* ys,
                                  float* out, int E, int M, int S,
                                  float add_const, void* stream) {
  const int threads = 256;
  const size_t total = (size_t)E * S;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  column_interp_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      cols, ys, out, E, M, S, add_const);
  return (int)cudaGetLastError();
}
