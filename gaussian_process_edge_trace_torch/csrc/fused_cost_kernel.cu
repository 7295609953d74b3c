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
// Frames: ys may hold B frames, (B, E, S), each with its own (E, M) columns
// or all sharing one (the frames of a multi-edge trace: frame stride 0, no
// copy); line/arc are then (B, S) and samples_t (B, S, E). The frame is
// gridDim.z of both launches and only offsets the pointers: the chunks and
// sample groups come from (E, M, S) alone, so every frame's sums are
// bitwise those of a single-frame launch (the reference vmaps this kernel
// over frames in trace_batch_vmap).
//
// What bounds it on this card: at E = M = 1000, S = 10^4 one call reads 40 MB
// of ys and 4 MB of cols and, with the transposed copy, writes 40 MB more:
// 13 us of bandwidth without the copy, 25 us with it. The two interpolation
// taps of every (e, s) are gathers: on the 1000^2 trace a warp's 32
// posterior curves span ~580 of the 1000 rows at one e (printed by
// tests/torch_kernel_variants.py), so its taps touch ~32 sectors of cols.
// At the demo shape (E = M = 500, S = 1000) the bytes take 1 us: there the
// kernel is bound by launch and load latency.
//
// Design (the launch plan is ops/cuda_interp.py::k1_launch_plan, which sizes
// every chunk and sample group and which the wrapper passes here):
// - The pair windows are split into chunks of at most kPairs = 8 (gridDim.y)
//   and the samples into groups (gridDim.x), one wave of two blocks per SM.
//   A block copies its chunk's 2*np+1 rows of cols into shared memory once,
//   with cp.async, and then walks its group's samples, one per thread at a
//   time, so the taps are shared-memory reads. (The previous design staged 11
//   rows in each of 7,900 blocks for 128 samples each: 348 MB from L2 per
//   1000^2 call. Reading the taps from L2 instead, with no staging, is
//   gather-bound; tests/torch_kernel_variants.py times that variant.)
// - ys is (E, S) row-major, so a warp reads 32 consecutive samples of one
//   row: every load of ys is coalesced. A thread loads the 2*np+2 rows of
//   its next sample while it works on the current one.
// - Each chunk writes its partial (line, arc) to an (n_chunks, 2, S)
//   scratch buffer; a second launch sums the chunks in a fixed order. No
//   atomics: reruns are bitwise equal.
// - Within a chunk a thread walks the pairs in order and carries g and the
//   step of the shared row from one pair to the next in registers.
// - The transposed copy: the chunks' row windows overlap at their boundary
//   rows 2*j1 and 2*j1+1, so chunk c writes only the rows [2*j0, 2*j1) it
//   owns, and the last chunk also rows E-2 and E-1, which begin no pair of
//   their own. Each warp puts its 32 samples' owned rows into its own
//   shared-memory tile and stores them two samples per instruction: every
//   store is a run of 2*np floats of a row of samples_t, 64 bytes in full
//   chunks, and every element is written by exactly one thread. The line
//   and arc sums do not depend on whether the copy is asked for, nor do
//   the chunks.
// - The pair-rule coefficients are those of ops/integrate.py
//   (_pair_contributions) and pallas_interp.py:339-348, with the step
//   lengths as x * rsqrt(x) and the ratios through approximate reciprocals
//   (2 ulp each) in place of IEEE square roots and divisions, which take
//   longer (tests/torch_kernel_variants.py times both). The sums run in
//   another order than the plain PyTorch version, so the two agree to f32
//   rounding, not bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int kPairs = 8;            // most pair windows of one chunk
constexpr int kRows = 2 * kPairs + 2;  // rows of ys a chunk reads
// Transpose tile: 2*kPairs rows of 32 samples, padded to 34 so that a warp
// reading two samples' rows (lanes 0-15 and 16-31) hits all 32 banks once.
constexpr int kTileLd = 34;

// row is a row of cols staged in shared memory.
__device__ __forceinline__ float lerp_row(const float* row, float y, int M,
                                          float add) {
  float yc = fminf(fmaxf(y, 0.0f), (float)(M - 1));
  int r0 = min((int)floorf(yc), M - 2);
  float f = yc - (float)r0;
  float v0 = row[r0];
  float v1 = row[r0 + 1];
  return (v0 + f * (v1 - v0)) + add;
}

// sqrt(1 + d^2) as x * rsqrt(x): the hardware's approximate reciprocal
// square root (2 ulp), not the IEEE square root's longer sequence.
__device__ __forceinline__ float step_len(float ya, float yb) {
  float d = yb - ya;
  float x = 1.0f + d * d;
  return x * rsqrtf(x);
}

__global__ void fused_cost_partial_kernel(const float* __restrict__ cols,
                                          const float* __restrict__ ys,
                                          float* __restrict__ partial,
                                          float* __restrict__ samples_t, int E,
                                          int M, int S, float kde_thresh,
                                          int pairs_per_chunk,
                                          int samples_per_block,
                                          int cols_shared) {
  // The chunk's 2*np+1 rows of cols, then with samples_t one
  // (2*kPairs) x kTileLd transpose tile per warp.
  extern __shared__ float srow[];
  const size_t frame = blockIdx.z;
  cols += cols_shared ? 0 : frame * E * M;
  ys += frame * E * S;
  partial += frame * gridDim.y * 2 * S;
  if (samples_t != nullptr) samples_t += frame * S * E;
  const int P = (E - 2) / 2;  // pair windows of each quadrature
  const int j0 = blockIdx.y * pairs_per_chunk;
  const int np = min(P, j0 + pairs_per_chunk) - j0;  // this chunk's pairs
  const int r0 = 2 * j0;
  const bool last = j0 + np == P;
  const int lane = threadIdx.x & 31;
  const bool keep = samples_t != nullptr;
  float* tile = srow + (size_t)(2 * pairs_per_chunk + 1) * M +
                (threadIdx.x >> 5) * (2 * kPairs) * kTileLd;
  const float* src = cols + (size_t)r0 * M;
  const int nstage = (2 * np + 1) * M;
  const int n16 = (reinterpret_cast<uintptr_t>(src) & 15) ? 0 : nstage & ~3;
  for (int i = 4 * threadIdx.x; i < n16; i += 4 * blockDim.x)
    cp_async16(srow + i, src + i);
  for (int i = n16 + threadIdx.x; i < nstage; i += blockDim.x)
    cp_async4(srow + i, src + i);

  // Lanes past the block's samples read a real sample and store nothing:
  // the warp stays whole for the tile.
  const int s_end = min(S, (blockIdx.x + 1) * samples_per_block);
  const float* yr = ys + (size_t)r0 * S;
  int sb = blockIdx.x * samples_per_block;
  float yn[kRows];  // the next tile's rows r0 .. r0+2*np+1, in flight
  {
    const float* yq = yr + min(sb + (int)threadIdx.x, S - 1);
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      yn[k] = k < 2 * np + 2 ? __ldg(yq + (size_t)k * S) : 0.0f;
  }
  cp_async_wait_all();
  __syncthreads();  // phase: K1 stage cols

  const float third = 2.0f / 6.0f;  // simpson_weights' hsum/6 at unit spacing
  for (; sb < s_end; sb += blockDim.x) {
    const int s = sb + threadIdx.x;
    float y[kRows];  // rows r0 .. r0+2*np+1 of sample s
#pragma unroll
    for (int k = 0; k < kRows; ++k) y[k] = yn[k];
    if (sb + (int)blockDim.x < s_end) {
      const float* yq = yr + min(s + (int)blockDim.x, S - 1);
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        yn[k] = k < 2 * np + 2 ? __ldg(yq + (size_t)k * S) : 0.0f;
    }
    if (keep) {  // rows r0 .. r0+2*np-1: this chunk's own
#pragma unroll
      for (int k = 0; k < 2 * kPairs; ++k)
        if (k < 2 * np) tile[k * kTileLd + lane] = y[k];
      __syncwarp();
      // Two samples per store: lanes 0-15 the rows of one, 16-31 the next.
      const int r = lane & 15;
      const int s2 = s - lane + (lane >> 4);
#pragma unroll
      for (int sl = 0; sl < 32; sl += 2)
        if (r < 2 * np && s2 + sl < s_end)
          samples_t[(size_t)(s2 + sl) * E + r0 + r] =
              tile[r * kTileLd + sl + (lane >> 4)];
      __syncwarp();  // phase: K1 transposed copy
      if (last && s < s_end) {  // rows E-2 and E-1 close the last chunk
#pragma unroll
        for (int k = 0; k < kRows; k += 2)
          if (k == 2 * np) {
            samples_t[(size_t)s * E + E - 2] = y[k];
            samples_t[(size_t)s * E + E - 1] = y[k + 1];
          }
      }
    }
    float g0 = lerp_row(srow, y[0], M, kde_thresh);
    float st0 = step_len(y[0], y[1]);
    float line = 0.0f;
    float arc = 0.0f;
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      if (p < np) {  // pair j0+p: rows r0+2p .. r0+2p+3
        const float* rows = srow + (size_t)(2 * p + 1) * M;
        const float g1 = lerp_row(rows, y[2 * p + 1], M, kde_thresh);
        const float g2 = lerp_row(rows + M, y[2 * p + 2], M, kde_thresh);
        const float h0 = step_len(y[2 * p + 1], y[2 * p + 2]);  // step[2j+1]
        const float h1 = step_len(y[2 * p + 2], y[2 * p + 3]);  // step[2j+2]
        const float hsum = h0 + h1;
        const float i0 = __fdividef(1.0f, h0);
        const float i1 = __fdividef(1.0f, h1);
        const float q = hsum * (1.0f / 6.0f);
        const float c0 = q * (2.0f - h1 * i0);
        const float c1 = q * (hsum * hsum * (i0 * i1));
        const float c2 = q * (2.0f - h0 * i1);
        line += c0 * g0 + c1 * g1 + c2 * g2;
        arc += third * st0 + (4.0f * third) * h0 + third * h1;
        g0 = g2;
        st0 = h1;
      }
    }
    if (s < s_end) {
      partial[((size_t)blockIdx.y * 2 + 0) * S + s] = line;
      partial[((size_t)blockIdx.y * 2 + 1) * S + s] = arc;
    }  // phase: K1 gathers and pair sums
  }
}

// The chunk sums: output i of the 2S outputs (line of every sample, then
// arc) in column threadIdx.x of a block of kReduceRows x 32 threads; row y
// sums its slice of the chunks, the slices are then added in row order. A
// fixed order, so reruns are bitwise equal, with every load of a slice in
// flight at once.
constexpr int kReduceRows = 8;

__global__ void fused_cost_reduce_kernel(const float* __restrict__ partial,
                                         float* __restrict__ line,
                                         float* __restrict__ arc, int S,
                                         int n_chunks) {
  __shared__ float slice[kReduceRows][33];
  const size_t frame = blockIdx.y;  // one frame per row of the grid
  partial += frame * n_chunks * 2 * S;
  line += frame * S;
  arc += frame * S;
  const int i = blockIdx.x * 32 + threadIdx.x;
  const int k = i >= S;  // 0: line, 1: arc
  const int s = i - k * S;
  const int per = (n_chunks + kReduceRows - 1) / kReduceRows;
  const int c0 = threadIdx.y * per;
  const int c1 = min(n_chunks, c0 + per);
  float v = 0.0f;
  if (i < 2 * S) {
#pragma unroll 8
    for (int c = c0; c < c1; ++c) v += partial[((size_t)c * 2 + k) * S + s];
  }
  slice[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && i < 2 * S) {
    float t = slice[0][threadIdx.x];
#pragma unroll
    for (int y = 1; y < kReduceRows; ++y) t += slice[y][threadIdx.x];
    (k ? arc : line)[s] = t;
  }
}

}  // namespace

// Shared-memory bytes of one block of the partial kernel (not a kernel).
extern "C" int gpet_fused_cost_smem(int M, int pairs_per_chunk, int threads,
                                    int transpose) {
  const int tiles = transpose ? (threads / 32) * 2 * kPairs * kTileLd : 0;
  return ((2 * pairs_per_chunk + 1) * M + tiles) * (int)sizeof(float);
}

extern "C" int gpet_fused_cost(const float* cols, const float* ys,
                               float* partial, float* line, float* arc,
                               float* samples_t, int E, int M, int S,
                               float kde_thresh, int pairs_per_chunk,
                               int n_chunks, int samples_per_block,
                               int threads, int frames, int cols_shared,
                               void* stream) {
  if (pairs_per_chunk < 1 || pairs_per_chunk > kPairs || frames < 1 ||
      frames > 65535)
    return (int)cudaErrorInvalidValue;
  const int smem = gpet_fused_cost_smem(M, pairs_per_chunk, threads,
                                        samples_t != nullptr);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_cost_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((S + samples_per_block - 1) / samples_per_block, n_chunks,
            frames);
  fused_cost_partial_kernel<<<grid, threads, smem, st>>>(
      cols, ys, partial, samples_t, E, M, S, kde_thresh, pairs_per_chunk,
      samples_per_block, cols_shared);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_cost_reduce_kernel<<<dim3((2 * S + 31) / 32, frames),
                             dim3(32, kReduceRows), 0, st>>>(
      partial, line, arc, S, n_chunks);
  return (int)cudaGetLastError();
}
