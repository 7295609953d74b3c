// K3: two-level adjoint KDE binning for Hopper (sm_90a).
//
// Replaces gaussian_process_edge_trace_tpu/trace/pallas_kde.py::_binning_2l
// (kernel :75, pallas_call :171, compact-tap unfold :185-195). For the kept
// curves y (E, S) and their weights w (S,) it returns H (M+2, E):
//
//   H[m, e] = sum_s wv[e,s] * max(0, 1 - |y[e,s] + 1 - m|),
//   wv[e,s] = w[s] if 0 <= y[e,s] <= M-1, else 0
//
// as the adjoint of linear interpolation: each sample puts two taps,
// wv*(1-f) at row lo and wv*f at row lo+1, with yp = clip(y, -1, M) + 1,
// lo = floor(yp), f = yp - lo (pallas_kde.py:112-121, the same f32 terms).
//
// What bounds it on this card: the function reads E*S + S floats and writes
// (M+2)*E (8 MB at E = M = S_keep = 1000, 2.4 us at 3.35 TB/s) and does ~10
// operations per sample, so bytes bound it. The dense hat (K4, and the plain
// version) evaluates (M+2)*E*S taps instead, 10^9 at that shape. This kernel
// compares each sample against the NB = M/Hb + 1 row blocks of its column
// (Hb = 8/16/32 at M = 500/1000/2000, _hb_for in pallas_kde.py:49-56), Hb
// times fewer compares than the dense hat.
//
// Design:
// - One block holds kCols columns; each column has one thread per row block
//   b, which owns Hb+1 accumulators in shared memory (the block's Hb rows and
//   the straddle tap at row (b+1)*Hb).
// - Samples are staged kTile at a time: the block first turns each (column,
//   sample) into (lo, wv*(1-f), wv*f) in shared memory, then every row-block
//   thread scans the tile in sample order and adds the taps of the samples
//   whose lo falls in its block. A warp shares one column, so the scan's
//   loads are broadcasts.
// - No float atomics: every accumulator has one owner thread that adds its
//   terms in sample order, so reruns are bitwise equal (the reference's
//   determinism contract, PARITY.md:101-104). The TPU kernel's one-hot MXU
//   contraction and its exact bf16 3-way split (:124-142) exist only for the
//   TPU's matrix unit and are not carried over; the sums run in another order
//   than the dense hat's, so the two agree to f32 rounding.
// - The straddle tap of block b is folded into row 0 of block b+1 at the
//   end, as the unfold at :185-194 does, and the rows are cropped to M+2.
//   Consecutive threads write consecutive columns of one row of H.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 4;    // columns per block (blockDim.y)
constexpr int kTile = 256;  // samples staged per pass

__global__ void binning_2l_kernel(const float* __restrict__ y,
                                  const float* __restrict__ w,
                                  float* __restrict__ H, int E, int S, int M,
                                  int Hb, int NB) {
  extern __shared__ float smem[];
  const int Tt = Hb + 1;
  float* acc = smem;                                 // [kCols][NB][Tt]
  int* slo = reinterpret_cast<int*>(acc + kCols * NB * Tt);  // [kCols][kTile]
  float* sw1 = reinterpret_cast<float*>(slo + kCols * kTile);
  float* sw2 = sw1 + kCols * kTile;

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int e0 = blockIdx.x * kCols;
  const int c = threadIdx.y;
  const int e = e0 + c;
  for (int i = tid; i < kCols * NB * Tt; i += nthreads) acc[i] = 0.0f;

  const float top = (float)(M - 1);
  for (int s0 = 0; s0 < S; s0 += kTile) {
    const int n = min(kTile, S - s0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kCols * kTile; i += nthreads) {
      const int cc = i / kTile;
      const int k = i - cc * kTile;
      int lo = -Hb - 1;  // a row no block owns
      float w1 = 0.0f;
      float w2 = 0.0f;
      if (e0 + cc < E && k < n) {
        const float yv = y[(size_t)(e0 + cc) * S + s0 + k];
        const float wv = (yv >= 0.0f && yv <= top) ? w[s0 + k] : 0.0f;
        const float yp = __fadd_rn(fminf(fmaxf(yv, -1.0f), (float)M), 1.0f);
        const float lof = floorf(yp);
        const float f = __fsub_rn(yp, lof);
        lo = (int)lof;
        w1 = __fmul_rn(wv, __fsub_rn(1.0f, f));
        w2 = __fmul_rn(wv, f);
      }
      slo[i] = lo;
      sw1[i] = w1;
      sw2[i] = w2;
    }
    __syncthreads();
    if (e < E) {
      const int* tlo = slo + c * kTile;
      const float* t1 = sw1 + c * kTile;
      const float* t2 = sw2 + c * kTile;
      for (int b = threadIdx.x; b < NB; b += blockDim.x) {
        float* a = acc + (c * NB + b) * Tt;
        const int base = b * Hb;
        for (int k = 0; k < n; ++k) {
          const int r = tlo[k] - base;
          if ((unsigned)r < (unsigned)Hb) {
            a[r] = __fadd_rn(a[r], t1[k]);
            a[r + 1] = __fadd_rn(a[r + 1], t2[k]);
          }
        }
      }
    }
  }
  __syncthreads();

  // Unfold: row m = b*Hb + j is tap j of block b; row 0 of block b > 0 adds
  // the straddle tap of block b-1 (main + inter at pallas_kde.py:194).
  for (int i = tid; i < (M + 2) * kCols; i += nthreads) {
    const int m = i / kCols;
    const int cc = i - m * kCols;
    if (e0 + cc >= E) continue;
    const float* ac = acc + cc * NB * Tt;
    const int b = m / Hb;
    const int j = m - b * Hb;
    float v;
    if (b == NB) {
      v = ac[(NB - 1) * Tt + Hb];  // the last block's straddle row
    } else if (j == 0 && b > 0) {
      v = __fadd_rn(ac[b * Tt], ac[(b - 1) * Tt + Hb]);
    } else {
      v = ac[b * Tt + j];
    }
    H[(size_t)m * E + e0 + cc] = v;
  }
}

}  // namespace

extern "C" int gpet_binning_2l(const float* y, const float* w, float* H, int E,
                               int S, int M, int Hb, void* stream) {
  const int NB = M / Hb + 1;
  const int bx = min(256, ((NB + 31) / 32) * 32);
  const size_t smem = (size_t)kCols * NB * (Hb + 1) * sizeof(float) +
                      (size_t)kCols * kTile * (sizeof(int) + 2 * sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        binning_2l_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 block(bx, kCols);
  binning_2l_kernel<<<(E + kCols - 1) / kCols, block, smem, st>>>(
      y, w, H, E, S, M, Hb, NB);
  return (int)cudaGetLastError();
}
