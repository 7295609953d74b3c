// K1: fused curve cost for Hopper (sm_90a).
//
// Replaces gaussian_process_edge_trace_tpu/ops/pallas_interp.py::_fused_cost_call
// (kernel at :303, pallas_call at :391). For every posterior curve s it returns
//
//   line[s] = non-uniform Simpson pair rule over the rows e < E-1 of
//             g[e] = lerp(cols[e, :], clip(ys[e, s], 0, M-1)) + kde_thresh
//             with widths h[p] = step[p+1],  step[e] = sqrt(1 + (ys[e+1,s]-ys[e,s])^2)
//   arc[s]  = uniform Simpson over step[0 .. E-2]
//
// and, when asked (the with_transpose arm at :303-311 and :387-390, used by
// the reference driver at S >= 8192), ys transposed to (S, E): samples_t[s, e]
// = ys[e, s], written from the rows the kernel already reads, so that
// best_curves takes the kept curves as rows.
//
// E must be even, so both quadratures have an odd point count and split into
// (E-2)/2 pair windows: pair j covers rows 2j .. 2j+3.
//
// What bounds it on this card: at the demo shape (E = M = 500, S = 1000) one
// call reads 2 MB of ys and 1 MB of cols and does ~30 flops per (e, s). That
// is microseconds of bandwidth; the kernel is bound by latency and occupancy,
// because S = 1000 samples give only 8 blocks of 128 threads for 132 SMs.
// At E = M = 1000, S = 10^4 it reads 44 MB and, with the transposed copy,
// writes 40 MB more: 13 us of bandwidth without the copy, 25 us with it.
//
// Design:
// - One thread per sample s. ys is (E, S) row-major, so a warp reads 32
//   consecutive samples of one row: every load is coalesced.
// - The pair windows are split into chunks on gridDim.y (8 blocks x 32 chunks
//   at the demo), which fills the card. Each chunk writes its partial
//   (line, arc) to an (n_chunks, 2, S) scratch buffer; a second launch sums
//   the chunks in chunk order. No atomics: reruns are bitwise equal.
// - Every thread of a block reads the same rows of cols, so the block stages
//   its chunk's 2*pairs+1 rows of cols in shared memory once.
// - Within a chunk a thread walks the pairs in order and carries y, g and the
//   step of the shared row from one pair to the next in registers.
// - The transposed copy: the chunks' row windows overlap at their boundary
//   rows 2*j1 and 2*j1+1, so chunk c writes only the rows [2*j0, 2*j1) it
//   owns, and the last chunk also rows E-2 and E-1, which begin no pair of
//   their own. A thread puts each owned row's value in a shared-memory tile
//   (one column per sample, padded by one float) as it reads it; the block
//   then stores the tile sample by sample, consecutive threads on
//   consecutive columns e. Every element of samples_t is written by exactly
//   one thread, and the line and arc sums do not depend on whether it is
//   asked for.
// - The pair-rule coefficients are written as in ops/integrate.py
//   (_pair_contributions) and pallas_interp.py:339-348. The sums run in
//   another order than the plain PyTorch version, so the two agree to f32
//   rounding, not bit for bit.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float lerp_row(const float* __restrict__ row, float y,
                                          int M, float add) {
  float yc = fminf(fmaxf(y, 0.0f), (float)(M - 1));
  int r0 = min((int)floorf(yc), M - 2);
  float f = yc - (float)r0;
  float v0 = row[r0];
  float v1 = row[r0 + 1];
  return (v0 + f * (v1 - v0)) + add;
}

__device__ __forceinline__ float step_len(float ya, float yb) {
  float d = yb - ya;
  return sqrtf(1.0f + d * d);
}

__global__ void fused_cost_partial_kernel(const float* __restrict__ cols,
                                          const float* __restrict__ ys,
                                          float* __restrict__ partial,
                                          float* __restrict__ samples_t, int E,
                                          int M, int S, float kde_thresh,
                                          int pairs_per_chunk) {
  // (2 * pairs_per_chunk + 1) rows of M, then with samples_t the transpose
  // tile of (2 * pairs_per_chunk + 2) rows of blockDim.x + 1.
  extern __shared__ float srow[];
  const int P = (E - 2) / 2;       // pair windows of each quadrature
  const int j0 = blockIdx.y * pairs_per_chunk;
  const int j1 = min(P, j0 + pairs_per_chunk);
  const int r0 = 2 * j0;
  const int nrows = j1 > j0 ? 2 * (j1 - j0) + 1 : 0;
  const int own1 = j1 == P ? E : 2 * j1;  // rows [r0, own1) are this chunk's
  const int tw = blockDim.x + 1;          // transpose tile row width
  float* tile = srow + (size_t)(2 * pairs_per_chunk + 1) * M;

  const float* src = cols + (size_t)r0 * M;
  for (int i = threadIdx.x; i < nrows * M; i += blockDim.x) srow[i] = src[i];
  __syncthreads();

  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool keep = samples_t != nullptr;
  float* trow = tile + threadIdx.x;
  float line = 0.0f;
  float arc = 0.0f;
  if (s < S && j1 > j0) {
    const float third = 2.0f / 6.0f;  // simpson_weights' hsum/6 at unit spacing
    const float* yp = ys + s;
    float y1 = yp[(size_t)(r0 + 1) * S];
    float y0 = yp[(size_t)r0 * S];
    if (keep) {  // rows r0 and r0 + 1 are always this chunk's
      trow[0] = y0;
      trow[tw] = y1;
    }
    float g0 = lerp_row(srow, y0, M, kde_thresh);
    float st0 = step_len(y0, y1);
    for (int j = j0; j < j1; ++j) {
      const int lr = 2 * (j - j0);
      const int e = 2 * j;
      float y2 = yp[(size_t)(e + 2) * S];
      float y3 = yp[(size_t)(e + 3) * S];
      if (keep) {
        if (e + 2 < own1) trow[(size_t)(lr + 2) * tw] = y2;
        if (e + 3 < own1) trow[(size_t)(lr + 3) * tw] = y3;
      }
      float g1 = lerp_row(srow + (size_t)(lr + 1) * M, y1, M, kde_thresh);
      float g2 = lerp_row(srow + (size_t)(lr + 2) * M, y2, M, kde_thresh);
      float h0 = step_len(y1, y2);  // step[2j+1]
      float h1 = step_len(y2, y3);  // step[2j+2]
      float hsum = h0 + h1;
      float c0 = (hsum / 6.0f) * (2.0f - h1 / h0);
      float c1 = (hsum / 6.0f) * (hsum * hsum / (h0 * h1));
      float c2 = (hsum / 6.0f) * (2.0f - h0 / h1);
      line += c0 * g0 + c1 * g1 + c2 * g2;
      arc += third * st0 + (4.0f * third) * h0 + third * h1;
      y1 = y3;
      g0 = g2;
      st0 = h1;
    }
  }
  if (keep) {
    __syncthreads();
    const int nown = own1 - r0;
    const int sb = blockIdx.x * blockDim.x;
    const int ns = min((int)blockDim.x, S - sb);
    for (int i = threadIdx.x; i < ns * nown; i += blockDim.x) {
      const int sl = i / nown;
      const int r = i - sl * nown;
      samples_t[(size_t)(sb + sl) * E + r0 + r] = tile[(size_t)r * tw + sl];
    }
  }
  if (s >= S) return;
  partial[((size_t)blockIdx.y * 2 + 0) * S + s] = line;
  partial[((size_t)blockIdx.y * 2 + 1) * S + s] = arc;
}

__global__ void fused_cost_reduce_kernel(const float* __restrict__ partial,
                                         float* __restrict__ line,
                                         float* __restrict__ arc, int S,
                                         int n_chunks) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  float l = 0.0f;
  float a = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {  // fixed order: deterministic
    l += partial[((size_t)c * 2 + 0) * S + s];
    a += partial[((size_t)c * 2 + 1) * S + s];
  }
  line[s] = l;
  arc[s] = a;
}

}  // namespace

extern "C" int gpet_fused_cost(const float* cols, const float* ys,
                               float* partial, float* line, float* arc,
                               float* samples_t, int E, int M, int S,
                               float kde_thresh, int pairs_per_chunk,
                               int n_chunks, void* stream) {
  const int threads = 128;
  size_t smem = (size_t)(2 * pairs_per_chunk + 1) * M * sizeof(float);
  if (samples_t != nullptr)
    smem += (size_t)(2 * pairs_per_chunk + 2) * (threads + 1) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_cost_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((S + threads - 1) / threads, n_chunks);
  fused_cost_partial_kernel<<<grid, threads, smem, st>>>(
      cols, ys, partial, samples_t, E, M, S, kde_thresh, pairs_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_cost_reduce_kernel<<<(S + threads - 1) / threads, threads, 0, st>>>(
      partial, line, arc, S, n_chunks);
  return (int)cudaGetLastError();
}
