// K5: batched Cholesky factorisation for Hopper (sm_90a).
//
// Replaces gaussian_process_edge_trace_tpu/ops/pallas_chol.py::
// _batched_cholesky_impl (body _chol_kernel_body :36, call _chunk_call
// :148-163), reached through batched_cholesky :302 and cholesky_auto :334.
// For each of B symmetric positive-definite (n, n) matrices it returns the
// lower factor L with L Lᵀ = K and a zero strict upper triangle; only the
// lower triangle of K is read. A matrix that is not positive definite gives
// NaN, not an error, as on the TPU: a pivot that is not positive puts NaN on
// its diagonal entry, which spreads to everything factored after it. The
// callers sanitise NaN. The pivot's 1/sqrt is rsqrtf, approximate to 2 ulp,
// and the columns are scaled by it instead of divided by a correctly rounded
// sqrt as on the TPU: the correctly rounded pair (__fsqrt_rn, __frcp_rn)
// lies on the tile factor's dependent chain and made this kernel 1.3-1.45×
// slower on an H100 (PERF.md §6).
//
// What bounds it on this card: the final fit factors B = 12 to 109 matrices
// of n = 104 or 208 per call, ~n³/3 multiply-adds each (0.4 and 3 Mflop),
// far below any throughput limit. What bounds it is the chain of dependent
// steps inside one matrix and the block barriers between them.
//
// Design: one block of 256 threads per matrix, the lower triangle copied in
// with cp.async (every 16-byte copy of the block in flight at once), the
// whole matrix in shared memory (n = 208: 176 KB), factored as a blocked
// right-looking Cholesky with panels of 32 columns. For each panel:
//   (a) one warp factors the 32 × 32 diagonal tile in registers: lane i
//       holds row i of the tile, column j's entries are broadcast by
//       __shfl_sync; no block barrier inside the tile;
//   (b) every thread solves one row of the panel below against the tile's
//       transpose (rows are independent), reading the tile transposed from
//       a small buffer as float4 broadcasts and multiplying by the
//       reciprocals of its diagonal;
//   (c) every thread updates 4 × 4 register tiles of the trailing lower
//       triangle, A₂₂ −= P Pᵀ, reading the panel from a k-major copy as
//       float4s.
// That is three block barriers per panel (12 at n = 104, 21 at n = 208)
// instead of two per pivot. The row stride ld of the matrix in shared memory
// is n rounded up to a multiple of 4 with ld/4 odd, so float4 reads of 8
// consecutive rows at one column (a quarter warp) hit 8 distinct 16-byte
// bank groups. Every element is summed in one fixed order and no atomics
// are used: a rerun is bitwise identical. Plain f32 throughout (no TF32,
// no tensor cores), as the reference requires.
//
// The shared-memory layout is mirrored by ops/cuda_chol.py::launch_plan,
// which decides the largest n the direct path takes (_DIRECT_N).

#include <cuda_runtime.h>

#include "chol_common.cuh"

namespace {

using namespace gpet_chol;

constexpr int kThreads = 256;
constexpr int kPanel = 32;

__host__ __device__ inline int panel_ld(int n) {
  return round4(n > kPanel ? n - kPanel : 1);
}

// (a): one warp factors the pw × pw diagonal tile at (p0, p0) of a in
// registers, lane i holding tile row i. At step j the pivot's rsqrtf scales
// column j and pivot·rsqrtf(pivot) is the diagonal entry (a pivot that is
// not positive gives a NaN diagonal: rsqrtf(0) is inf, 0·inf NaN); the
// column's entries are fetched from their lanes by __shfl_sync, all before
// the updates that use them, so the shuffles' latency overlaps. The
// factored rows go back to a, the tile transposed to ut (ut[k][i] = l_ik,
// zero above the diagonal) and the reciprocals of its diagonal to rin.
// kFull (pw == 32) makes the unrolled steps straight-line code.
template <bool kFull>
__device__ inline void factor_tile(float* a, float* ut, float* rin, int ld,
                                   int p0, int pw) {
  const int lane = threadIdx.x & 31;
  const bool row_ok = kFull || lane < pw;
  float r[kPanel];
  const float* src = a + (p0 + lane) * ld + p0;
#pragma unroll
  for (int q = 0; q < kPanel / 4; ++q) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row_ok && (kFull || 4 * q < pw))
      v = reinterpret_cast<const float4*>(src)[q];
    r[4 * q] = v.x;
    r[4 * q + 1] = v.y;
    r[4 * q + 2] = v.z;
    r[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    if (kFull || j < pw) {
      const float pivot = __shfl_sync(0xffffffffu, r[j], j);
      const float rd = rsqrtf(pivot);
      if (lane == j) r[j] = pivot * rd;
      if (lane > j) r[j] *= rd;
      float col[kPanel];
#pragma unroll
      for (int k = j + 1; k < kPanel; ++k)
        col[k] = __shfl_sync(0xffffffffu, r[j], k);
#pragma unroll
      for (int k = j + 1; k < kPanel; ++k)
        if (lane >= k) r[k] -= r[j] * col[k];
    }
  }
  float* dst = a + (p0 + lane) * ld + p0;
#pragma unroll
  for (int k = 0; k < kPanel; ++k) {
    if (row_ok && k <= lane) dst[k] = r[k];
    ut[k * kPanel + lane] = row_ok && k <= lane ? r[k] : 0.f;
  }
  if (row_ok) rin[lane] = 1.f / dst[lane];
}

__global__ void __launch_bounds__(kThreads)
batched_chol_kernel(const float* __restrict__ K, float* __restrict__ L,
                    int n, int vec) {
  extern __shared__ float sm[];
  const int ld = smem_ld(n);
  const int np = panel_ld(n);
  float* a = sm;                 // n * ld: the matrix, factored in place
  float* pk = a + n * ld;        // kPanel * np: the panel below, k-major
  float* ut = pk + kPanel * np;  // kPanel * kPanel: diagonal tile, transposed
  float* rin = ut + kPanel * kPanel;  // kPanel: 1 / its diagonal
  const size_t base = (size_t)blockIdx.x * n * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads >> 5;

  copy_lower_async(K + base, a, n, ld, vec);
  cp_async_wait_all();
  __syncthreads();  // phase: K5 copy-in

  for (int p0 = 0; p0 < n; p0 += kPanel) {
    const int pw = min(kPanel, n - p0);
    const int p1 = p0 + pw;

    // (a) The diagonal tile, one warp.
    if (warp == 0) {
      if (pw == kPanel)
        factor_tile<true>(a, ut, rin, ld, p0, pw);
      else
        factor_tile<false>(a, ut, rin, ld, p0, pw);
    }
    __syncthreads();  // phase: K5 (a) diagonal tile
    if (p1 >= n) break;

    // (b) The panel below (pw == kPanel here): row i solves
    // x L_ddᵀ = a[i, p0:p1], column by column (x_j final, then pushed into
    // x_k for k > j).
    for (int i = p1 + tid; i < n; i += kThreads) {
      float x[kPanel];
      const float* src = a + i * ld + p0;
#pragma unroll
      for (int q = 0; q < kPanel / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(src)[q];
        x[4 * q] = v.x;
        x[4 * q + 1] = v.y;
        x[4 * q + 2] = v.z;
        x[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        const float* uj = ut + j * kPanel;  // column j of L_dd
        x[j] *= rin[j];
#pragma unroll
        for (int q = (j + 1) / 4; q < kPanel / 4; ++q) {
          const float4 u = reinterpret_cast<const float4*>(uj)[q];
          if (4 * q > j) x[4 * q] -= x[j] * u.x;
          if (4 * q + 1 > j) x[4 * q + 1] -= x[j] * u.y;
          if (4 * q + 2 > j) x[4 * q + 2] -= x[j] * u.z;
          if (4 * q + 3 > j) x[4 * q + 3] -= x[j] * u.w;
        }
      }
      float* dst = a + i * ld + p0;
      const int row = i - p1;
#pragma unroll
      for (int k = 0; k < kPanel; ++k) {
        dst[k] = x[k];
        pk[k * np + row] = x[k];
      }
    }
    __syncthreads();  // phase: K5 (b) panel below

    // (c) Trailing update of the lower triangle, 4 × 4 tiles (I, J), J <= I,
    // numbered row by row; neighbouring threads take neighbouring J.
    const int nr = n - p1;
    const int nb = (nr + 3) >> 2;
    const int ntiles = nb * (nb + 1) / 2;
    for (int t = tid; t < ntiles; t += kThreads) {
      int I = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
      while (I * (I + 1) / 2 > t) --I;
      while ((I + 1) * (I + 2) / 2 <= t) ++I;
      const int J = t - I * (I + 1) / 2;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int k = 0; k < pw; ++k) {
        const float4 pi = reinterpret_cast<const float4*>(pk + k * np)[I];
        const float4 pj = reinterpret_cast<const float4*>(pk + k * np)[J];
        const float vi[4] = {pi.x, pi.y, pi.z, pi.w};
        const float vj[4] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += vi[r] * vj[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = p1 + 4 * I + r;
        if (i < n) {
          float4* dst = reinterpret_cast<float4*>(a + i * ld + p1) + J;
          float4 v = *dst;
          v.x -= acc[r][0];
          v.y -= acc[r][1];
          v.z -= acc[r][2];
          v.w -= acc[r][3];
          *dst = v;
        }
      }
    }
    __syncthreads();  // phase: K5 (c) trailing update
  }

  // Copy-out with a zero strict upper triangle.
  for (int i = warp; i < n; i += nwarps) {
    const float* src = a + i * ld;
    float* dst = L + base + (size_t)i * n;
    if (vec) {
      for (int q = lane; q < (n >> 2); q += 32) {
        const int j = 4 * q;
        float4 v = reinterpret_cast<const float4*>(src)[q];
        v.x = j <= i ? v.x : 0.f;
        v.y = j + 1 <= i ? v.y : 0.f;
        v.z = j + 2 <= i ? v.z : 0.f;
        v.w = j + 3 <= i ? v.w : 0.f;
        reinterpret_cast<float4*>(dst)[q] = v;
      }
    } else {
      for (int j = lane; j < n; j += 32) dst[j] = j <= i ? src[j] : 0.f;
    }
  }
}

}  // namespace

// Shared-memory bytes of one block; ops/cuda_chol.py::launch_plan mirrors it.
extern "C" int gpet_batched_cholesky_smem(int n) {
  return (int)sizeof(float) *
         (n * smem_ld(n) + kPanel * panel_ld(n) + kPanel * kPanel + kPanel);
}

extern "C" int gpet_batched_cholesky(const float* K, float* L, int B, int n,
                                     void* stream) {
  static bool attr_set = false;
  const int smem = gpet_batched_cholesky_smem(n);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        batched_chol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int vec = (n % 4 == 0) && ((reinterpret_cast<size_t>(K) |
                                    reinterpret_cast<size_t>(L)) % 16 == 0);
  // The copy-in's 16-byte copies need only K aligned; the copy-out's
  // float4 stores need L aligned too.
  batched_chol_kernel<<<B, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(K, L, n, vec);
  return (int)cudaGetLastError();
}
