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
// Only the lower triangle of L is read. What bounds it on this card: the
// final fit solves with m = 1 (the dual coefficients, three of every four
// launches) and with m = n (the identity right-hand side that forms K⁻¹),
// B = 12 to 109, n = 104 or 208: n²·m/2 multiply-adds per matrix, far below
// any throughput limit. What bounds it is the chain of dependent row steps.
//
// Design: blocked substitution in row tiles of 32, one block of 256 threads
// per (matrix, chunk of 32 right-hand-side columns), the lower triangle of L
// copied in with cp.async and held whole in shared memory (n = 208:
// 176 KB). For each row tile, in the direction of the solve:
//   (a) update: all threads apply the finished rows as one small product,
//       R_t −= L[t, done] · Z[done, :], each element summed in one fixed
//       order;
//   (b) diagonal: one warp solves the 32 × 32 triangle, no block barrier,
//       multiplying by reciprocals of the diagonal taken off the chain.
// That is two block barriers per tile (8 at n = 104) instead of a serial
// chain of n²/2 steps per column.
//   - m > 1 (batched_trsm_kernel): in (a) thread (warp w, lane c) owns rows
//     4w..4w+3 of the tile in column c; the rows of L are float4 broadcasts
//     (forward) or one float4 of a row of L covers the four rows
//     (backward). In (b) each lane solves its column with the tile's
//     entries of L as broadcasts.
//   - m = 1 (batched_trsv_kernel): forward, (a) gives each warp four rows
//     whose dot products are split over the lanes and reduced by a fixed
//     __shfl_down_sync tree; backward, lane c takes tile column c and warp w
//     every eighth finished row, and warp 0 adds the eight partial sums in
//     order. In (b) lane i holds z_i and the finished value is broadcast by
//     __shfl_sync: 32 steps, no barrier.
// The row stride ld of L in shared memory is n rounded up to a multiple of 4
// with ld/4 odd, so the float4 reads of 8 consecutive rows at one column
// (the diagonal tile held row-wise in registers) hit 8 distinct 16-byte
// bank groups; every other read of L is a broadcast or runs along a row.
// No atomics: a rerun is bitwise identical. Plain f32 throughout.
//
// The shared-memory layout is mirrored by ops/cuda_chol.py::launch_plan,
// which decides the largest n the direct path takes (_DIRECT_N).

#include <cuda_runtime.h>

#include "chol_common.cuh"

namespace {

using namespace gpet_chol;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;
constexpr int kChunk = 32;  // right-hand-side columns per block (m > 1)

// ---- m > 1 -----------------------------------------------------------------

// (b) of the wide kernel: warp 0 solves the tile's triangle for the chunk's
// 32 columns, one per lane, v[i] = Z[t0 + i][lane]; rdg[j] = 1/L[t0+j][t0+j].
// kFull (tr == 32) makes the unrolled chain straight-line code, so the
// compiler can issue the broadcast reads of L ahead of the arithmetic.
template <bool kFull>
__device__ inline void tile_columns(const float* l, const float* rdg, float* z,
                                    int ld, int t0, int tr, int transpose) {
  const int lane = threadIdx.x & 31;
  float v[kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
    v[i] = (kFull || i < tr) ? z[(t0 + i) * kChunk + lane] : 0.f;
  if (!transpose) {
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (kFull || j < tr) {
        v[j] *= rdg[j];
#pragma unroll
        for (int i = j + 1; i < kTile; ++i)
          if (kFull || i < tr) v[i] -= l[(t0 + i) * ld + t0 + j] * v[j];
      }
    }
  } else {
#pragma unroll
    for (int j = kTile - 1; j >= 0; --j) {
      if (kFull || j < tr) {
        const float* lj = l + (t0 + j) * ld + t0;
        v[j] *= rdg[j];
#pragma unroll
        for (int i = 0; i < j; ++i) v[i] -= lj[i] * v[j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kTile; ++i)
    if (kFull || i < tr) z[(t0 + i) * kChunk + lane] = v[i];
}

__global__ void __launch_bounds__(kThreads)
batched_trsm_kernel(const float* __restrict__ L, const float* __restrict__ R,
                    float* __restrict__ Z, int n, int m, int chunks,
                    int transpose, int vec) {
  extern __shared__ float sm[];
  const int ld = smem_ld(n);
  float* l = sm;            // n * ld
  float* z = sm + n * ld;   // n * kChunk, z[i * kChunk + c]
  float* rdg = z + n * kChunk;  // kTile: reciprocals of the tile's diagonal
  const int b = blockIdx.x / chunks;
  const int c0 = (blockIdx.x - b * chunks) * kChunk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t rbase = (size_t)b * n * m;

  copy_lower_async(L + (size_t)b * n * n, l, n, ld, vec);
  for (int idx = tid; idx < n * kChunk; idx += kThreads) {
    const int i = idx / kChunk;
    const int c = idx - i * kChunk;
    if (c0 + c < m)
      cp_async4(z + idx, R + rbase + (size_t)i * m + c0 + c);
    else
      z[idx] = 0.f;
  }
  cp_async_wait_all();
  __syncthreads();  // phase: K6 m > 1 copy-in

  const int ntiles = (n + kTile - 1) / kTile;
  for (int s = 0; s < ntiles; ++s) {
    const int t = transpose ? ntiles - 1 - s : s;
    const int t0 = t * kTile;
    const int tr = min(kTile, n - t0);
    const int t1 = t0 + tr;
    const int i0 = t0 + 4 * warp;  // this thread's first row of the tile

    // (a) Update from the finished rows, k in ascending order.
    if (tid < tr) rdg[tid] = 1.f / l[(t0 + tid) * ld + t0 + tid];
    if (i0 < t1) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (!transpose) {
#pragma unroll 2
        for (int k = 0; k < t0; k += 4) {
          const float zk0 = z[k * kChunk + lane];
          const float zk1 = z[(k + 1) * kChunk + lane];
          const float zk2 = z[(k + 2) * kChunk + lane];
          const float zk3 = z[(k + 3) * kChunk + lane];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = min(i0 + r, n - 1);
            const float4 a =
                reinterpret_cast<const float4*>(l + i * ld + k)[0];
            acc[r] += a.x * zk0;
            acc[r] += a.y * zk1;
            acc[r] += a.z * zk2;
            acc[r] += a.w * zk3;
          }
        }
      } else {
#pragma unroll 4
        for (int k = t1; k < n; ++k) {
          const float zk = z[k * kChunk + lane];
          const float4 a = reinterpret_cast<const float4*>(l + k * ld + i0)[0];
          acc[0] += a.x * zk;
          acc[1] += a.y * zk;
          acc[2] += a.z * zk;
          acc[3] += a.w * zk;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (i0 + r < t1) z[(i0 + r) * kChunk + lane] -= acc[r];
    }
    __syncthreads();  // phase: K6 m > 1 (a) update

    // (b) The diagonal triangle: warp 0, one column per lane.
    if (warp == 0) {
      if (tr == kTile)
        tile_columns<true>(l, rdg, z, ld, t0, tr, transpose);
      else
        tile_columns<false>(l, rdg, z, ld, t0, tr, transpose);
    }
    __syncthreads();  // phase: K6 m > 1 (b) diagonal triangle
  }

  for (int idx = tid; idx < n * kChunk; idx += kThreads) {
    const int i = idx / kChunk;
    const int c = idx - i * kChunk;
    if (c0 + c < m) Z[rbase + (size_t)i * m + c0 + c] = z[idx];
  }
}

// ---- m = 1 -----------------------------------------------------------------

// (b) of the m = 1 kernel: warp 0, lane i holds v = z_{t0+i}; returns it
// solved. Forward, a[j] = L[t0+i][t0+j] (row i of the tile); backward,
// a[j] = L[t0+j][t0+i] (column i). rdiag = 1/L[t0+i][t0+i], taken before
// the chain. Each step: the owner scales, __shfl_sync broadcasts.
template <bool kFull>
__device__ inline float tile_vector(const float* l, float v, float rdiag,
                                    int ld, int t0, int tr, int transpose) {
  const int lane = threadIdx.x & 31;
  const bool ok = lane < tr;
  float a[kTile];
  if (!transpose) {
    const float* src = l + (t0 + lane) * ld + t0;
#pragma unroll
    for (int q = 0; q < kTile / 4; ++q) {
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      if ((kFull || ok) && 4 * q <= lane)
        w = reinterpret_cast<const float4*>(src)[q];
      a[4 * q] = w.x;
      a[4 * q + 1] = w.y;
      a[4 * q + 2] = w.z;
      a[4 * q + 3] = w.w;
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (kFull || j < tr) {
        if (lane == j) v *= rdiag;
        const float zj = __shfl_sync(0xffffffffu, v, j);
        if (lane > j) v -= a[j] * zj;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTile; ++j)
      a[j] = ((kFull || j < tr) && lane <= j) ? l[(t0 + j) * ld + t0 + lane]
                                              : 0.f;
#pragma unroll
    for (int j = kTile - 1; j >= 0; --j) {
      if (kFull || j < tr) {
        if (lane == j) v *= rdiag;
        const float zj = __shfl_sync(0xffffffffu, v, j);
        if (lane < j) v -= a[j] * zj;
      }
    }
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
batched_trsv_kernel(const float* __restrict__ L, const float* __restrict__ R,
                    float* __restrict__ Z, int n, int transpose, int vec) {
  extern __shared__ float sm[];
  const int ld = smem_ld(n);
  float* l = sm;                 // n * ld
  float* z = sm + n * ld;        // ld
  float* part = z + ld;          // kWarps * 32: backward partial sums
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t rbase = (size_t)b * n;

  copy_lower_async(L + (size_t)b * n * n, l, n, ld, vec);
  for (int i = tid; i < n; i += kThreads) cp_async4(z + i, R + rbase + i);
  cp_async_wait_all();
  __syncthreads();  // phase: K6 m = 1 copy-in

  const int ntiles = (n + kTile - 1) / kTile;
  for (int s = 0; s < ntiles; ++s) {
    const int t = transpose ? ntiles - 1 - s : s;
    const int t0 = t * kTile;
    const int tr = min(kTile, n - t0);
    const int t1 = t0 + tr;

    // (a) Update from the finished rows.
    if (!transpose) {
      if (t0 > 0) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = t0 + 4 * warp + r;
          if (i < t1) {
            const float* li = l + i * ld;
            float acc = 0.f;
            for (int k = lane; k < t0; k += 32) acc += li[k] * z[k];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              acc += __shfl_down_sync(0xffffffffu, acc, off);
            if (lane == 0) z[i] -= acc;
          }
        }
      }
    } else {
      float acc = 0.f;
      if (lane < tr) {
        const float* lc = l + t0 + lane;  // column t0 + lane of L
        for (int k = t1 + warp; k < n; k += kWarps) acc += lc[k * ld] * z[k];
      }
      part[warp * 32 + lane] = acc;
    }
    __syncthreads();  // phase: K6 m = 1 (a) update

    // (b) The diagonal triangle: warp 0, lane i holds z_{t0+i}.
    if (warp == 0) {
      const bool ok = lane < tr;
      float v = ok ? z[t0 + lane] : 0.f;
      const float rdiag = ok ? 1.f / l[(t0 + lane) * ld + t0 + lane] : 0.f;
      if (transpose) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += part[w * 32 + lane];
        v -= sum;
      }
      v = tr == kTile ? tile_vector<true>(l, v, rdiag, ld, t0, tr, transpose)
                      : tile_vector<false>(l, v, rdiag, ld, t0, tr, transpose);
      if (ok) z[t0 + lane] = v;
    }
    __syncthreads();  // phase: K6 m = 1 (b) diagonal triangle
  }

  for (int i = tid; i < n; i += kThreads) Z[rbase + i] = z[i];
}

cudaError_t raise_smem_limit() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      batched_trsm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimit);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(batched_trsv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
  if (err != cudaSuccess) return err;
  done = true;
  return cudaSuccess;
}

}  // namespace

// Shared-memory bytes of one block; ops/cuda_chol.py::launch_plan mirrors it.
extern "C" int gpet_batched_trsm_smem(int n, int m) {
  const int ld = smem_ld(n);
  if (m == 1) return (int)sizeof(float) * (n * ld + ld + kThreads);
  return (int)sizeof(float) * (n * (ld + kChunk) + kTile);
}

extern "C" int gpet_batched_trsm(const float* L, const float* R, float* Z,
                                 int B, int n, int m, int transpose,
                                 void* stream) {
  const int smem = gpet_batched_trsm_smem(n, m);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = raise_smem_limit();
  if (err != cudaSuccess) return (int)err;
  const int vec = (n % 4 == 0) && (reinterpret_cast<size_t>(L) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 1) {
    batched_trsv_kernel<<<B, kThreads, smem, s>>>(L, R, Z, n, transpose, vec);
  } else {
    const int chunks = (m + kChunk - 1) / kChunk;
    batched_trsm_kernel<<<B * chunks, kThreads, smem, s>>>(
        L, R, Z, n, m, chunks, transpose, vec);
  }
  return (int)cudaGetLastError();
}
