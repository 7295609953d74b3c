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
// operations per sample, so bytes bound it. What it must not do is spend
// work per (row, sample): the dense hat (K4, and the plain version) takes
// (M+2)*E*S taps, 10^9 at that shape, and the previous design had each of
// a column's 63 row-block threads scan all of its samples (63,000 serial
// steps per column to place 2,000 taps).
//
// Frames: y may hold B frames, (B, E, S), with w (B, S) and H (B, M+2, E).
// The frame is gridDim.y and only offsets the pointers; the plan comes from
// (E, S, M) alone, so each frame's rows are summed in the order of a
// single-frame launch, bit for bit.
//
// Design (the launch plan is trace/cuda_kde.py::k3_launch_plan):
// - A block holds `cols` columns (4, fewer only for tall M); a column has
//   `warps_per_col` warps, each with its own range of whole batches of 32
//   samples and its own M+3 accumulators in shared memory (lo+1 reaches row
//   M+2 only with zero weight; it is cropped). The warps per column are
//   chosen so that the card holds ~16 warps per SM.
// - A warp takes its samples 32 at a time, in sample order, one per lane,
//   with the next batch's loads in flight (a warp reads 128 consecutive bytes
//   of its column's row of y).
// - Group and sum, per batch: the lanes are sorted by (lo, lane), each
//   lane's place being the number of smaller keys among the warp's 32 (read
//   back from shared memory as 8 broadcast int4 loads), and moved to that
//   place through a 32-entry buffer, so that the lanes that hit one row are
//   a run. A segmented scan over shuffles, in a fixed tree order, leaves
//   each run's two totals in its last lane. That lane adds the wv*(1-f)
//   total at row lo, then, after a __syncwarp, the wv*f total at row lo+1:
//   within a step no two lanes share an address. The cost does not depend
//   on the rows. (__match_any_sync grouped the lanes in a first version;
//   its time grows with the number of distinct rows, and the traces' kept
//   curves put a warp's 32 samples on ~29 rows:
//   tests/torch_kernel_variants.py times both.)
// - At the end the block sums a column's accumulators in warp order and
//   writes H's rows, consecutive threads on consecutive columns.
// - No float atomics and a fixed summation order everywhere, so reruns are
//   bitwise equal (the reference's determinism contract, PARITY.md:101-104).
//   The TPU kernel's one-hot MXU contraction and its exact bf16 3-way split
//   (:124-142) exist only for the TPU's matrix unit and are not carried
//   over; the sums run in another order than the dense hat's, so the two
//   agree to f32 rounding.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__global__ void binning_2l_kernel(const float* __restrict__ y,
                                  const float* __restrict__ w,
                                  float* __restrict__ H, int E, int S, int M,
                                  int cols, int warps_per_col,
                                  int batches_per_warp) {
  extern __shared__ float smem[];
  const size_t frame = blockIdx.y;
  y += frame * E * S;
  w += frame * S;
  H += frame * (M + 2) * E;
  const int R = M + 3;  // accumulator rows of one warp
  const int nwarps = cols * warps_per_col;
  int* xlo = reinterpret_cast<int*>(smem);  // [nwarps][32]: keys, group order
  float* xw1 = smem + nwarps * 32;
  float* xw2 = xw1 + nwarps * 32;
  float* acc = xw2 + nwarps * 32;           // [cols][warps_per_col][R]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int i = tid; i < nwarps * R; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();  // phase: K3 zero

  const int c = warp / warps_per_col;
  const int part = warp - c * warps_per_col;
  const int e = blockIdx.x * cols + c;
  if (e < E) {  // warp-uniform
    float* a = acc + (size_t)warp * R;
    float* b1 = xw1 + warp * 32;
    float* b2 = xw2 + warp * 32;
    int* bl = xlo + warp * 32;
    const float* yr = y + (size_t)e * S;
    const float top = (float)(M - 1);
    const int s_begin = part * batches_per_warp * 32;
    const int s_end = min(S, s_begin + batches_per_warp * 32);
    // Lanes past the end carry y = 0 with weight 0: taps of zero at rows 1, 2.
    int sn = s_begin + lane;
    float yn = sn < s_end ? __ldg(yr + sn) : 0.0f;
    float wn = sn < s_end ? __ldg(w + sn) : 0.0f;
    for (int s0 = s_begin; s0 < s_end; s0 += 32) {
      const float yv = yn;
      const float wt = wn;
      sn += 32;
      yn = sn < s_end ? __ldg(yr + sn) : 0.0f;
      wn = sn < s_end ? __ldg(w + sn) : 0.0f;
      const float wv = (yv >= 0.0f && yv <= top) ? wt : 0.0f;
      const float yp = __fadd_rn(fminf(fmaxf(yv, -1.0f), (float)M), 1.0f);
      const float lof = floorf(yp);
      const float f = __fsub_rn(yp, lof);
      const int lo = (int)lof;
      const float w1 = __fmul_rn(wv, __fsub_rn(1.0f, f));
      const float w2 = __fmul_rn(wv, f);  // phase: K3 taps

      // Group order: the lanes sorted by (lo, lane). A lane's place is the
      // number of smaller keys, counted from the warp's 32 keys read back
      // as 8 broadcast int4 loads.
      const int key = (lo << 5) | lane;
      bl[lane] = key;
      __syncwarp();
      int dst = 0;
      const int4* k4 = reinterpret_cast<const int4*>(bl);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int4 q = k4[j];
        dst += (q.x < key) + (q.y < key) + (q.z < key) + (q.w < key);
      }
      __syncwarp();
      b1[dst] = w1;
      b2[dst] = w2;
      bl[dst] = lo;
      __syncwarp();
      float v1 = b1[lane];
      float v2 = b2[lane];
      const int l = bl[lane];
      const int lprev = lane > 0 ? bl[lane - 1] : -1;
      const int lnext = lane < 31 ? bl[lane + 1] : -1;
      __syncwarp();  // phase: K3 group order

      // Segmented inclusive scan; a group's totals end in its last lane.
      const unsigned heads = __ballot_sync(kFull, l != lprev);
      const int start = 31 - __clz(heads & ((2u << lane) - 1u));
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float t1 = __shfl_up_sync(kFull, v1, d);
        const float t2 = __shfl_up_sync(kFull, v2, d);
        if (lane - d >= start) {
          v1 = __fadd_rn(v1, t1);
          v2 = __fadd_rn(v2, t2);
        }
      }
      const bool tail = l != lnext;
      if (tail) a[l] = __fadd_rn(a[l], v1);
      __syncwarp();
      if (tail) a[l + 1] = __fadd_rn(a[l + 1], v2);
      __syncwarp();  // phase: K3 scan and accumulate
    }
  }
  __syncthreads();  // phase: K3 bin

  // Row m of column cc: its warps' accumulators summed in warp order. The
  // block's size is a multiple of cols, so a thread keeps one column.
  const int cc = tid % cols;
  const int e0 = blockIdx.x * cols;
  if (e0 + cc < E) {
    const float* ac = acc + (size_t)cc * warps_per_col * R;
    for (int m = tid / cols; m < M + 2; m += blockDim.x / cols) {
      float v = ac[m];
      for (int p = 1; p < warps_per_col; ++p)
        v = __fadd_rn(v, ac[(size_t)p * R + m]);
      H[(size_t)m * E + e0 + cc] = v;  // phase: K3 write
    }
  }
}

}  // namespace

// Shared-memory bytes of one block (not a kernel): the accumulators and the
// group-order buffers of every warp.
extern "C" int gpet_binning_2l_smem(int M, int cols, int warps_per_col) {
  return cols * warps_per_col * (M + 3 + 3 * 32) * (int)sizeof(float);
}

extern "C" int gpet_binning_2l(const float* y, const float* w, float* H, int E,
                               int S, int M, int cols, int warps_per_col,
                               int batches_per_warp, int frames,
                               void* stream) {
  if (frames < 1 || frames > 65535) return (int)cudaErrorInvalidValue;
  const int smem = gpet_binning_2l_smem(M, cols, warps_per_col);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        binning_2l_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  binning_2l_kernel<<<dim3((E + cols - 1) / cols, frames),
                      cols * warps_per_col * 32, smem, st>>>(
      y, w, H, E, S, M, cols, warps_per_col, batches_per_warp);
  return (int)cudaGetLastError();
}
