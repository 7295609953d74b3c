// K4: dense-order KDE binning for Hopper (sm_90a).
//
// Replaces gaussian_process_edge_trace_tpu/trace/pallas_kde.py::
// _binning_pallas (kernel _binning_kernel at :25, pallas_call :209): the
// same function as K3,
//
//   H[m, e] = sum_s wv[e,s] * max(0, 1 - |(y[e,s] + 1) - m|),
//   wv[e,s] = w[s] if 0 <= y[e,s] <= M-1, else 0,
//
// in K4's own formulation, the dense per-column hat GEMV: every output sums
// its column's terms over all samples in index order. It is reached only
// with use_pallas_binning=True; the main path runs K3.
//
// What bounds it on this card: the function reads E*S + S floats and
// writes (M+2)*E (8 MB at E = M = S_keep = 1000, 2.4 us at 3.35 TB/s). The
// previous design evaluated the hat at every (m, e, s), 10^9 taps there,
// and took 0.265 ms (one H100 80GB HBM3 at 700 W); yet a sample's hat is
// nonzero only at the rows lo = floor(y+1) and lo+1, 2*10^6 terms in all.
// This design is bound by its shared-memory traffic: ~10 scattered
// accesses per sample.
//
// Design (the launch plan is trace/cuda_kde.py::k4_launch_plan): skip the
// exact zeros and keep the dense order. A ±0 product added to a sum that
// starts at +0 never changes its bits, and a sample with wv = 0 adds only
// such products, so a row that adds only its nonzero terms, in increasing
// s, each the same _rn expression fmaxf(0, 1 - |yp - m|) * wv, gives the
// dense form's output bit for bit (for finite weights).
// - A block takes `cols` consecutive columns, two warps each, and a tile
//   of each column's samples at a time (more tiles only where S exceeds
//   it), staged with cp.async with the tile's weights. Warp h takes half h
//   of the tile.
// - A stable counting sort of the taps by row. Count: each weighted sample
//   adds 1 to its lo's 16-bit count for its half (a shared atomic add); row
//   r's taps number the counts of lo = r-1 and lo = r. Scan: one pass over
//   (row, half) turns those into each half's cursor in each row's segment. Scatter: each warp walks its half, 32 samples at a time
//   in order, and puts each tap, hat·w already computed, at its cursor plus
//   its rank among the batch's lanes that tap the same row; that row's
//   first such lane then moves the cursor past them. A weighted sample at
//   lo taps one odd and one even row: the lanes that tap odd row 2a+1 are
//   those with lo>>1 = a, and those that tap even row 2a are the odd-lo
//   lanes with lo>>1 = a-1 and the even-lo lanes with lo>>1 = a. So each
//   lane ORs its bit into the mask of its lo>>1 in a per-warp table, reads
//   two masks back and clears its entry (no __match_any_sync, whose time
//   grows with the distinct rows).
// - Sum: each row's taps are now a contiguous run in s order, and one
//   thread adds them to the row's running sum, which carries over from tile
//   to tile; then the block writes its columns side by side, so a row's
//   stores are `cols` consecutive floats.
// - No float atomics: reruns are bitwise equal. The worst case is every
//   sample in one row: two rows add all S terms, one after another.
//
// Frames: y may hold B frames, (B, E, S), with w (B, S) and H (B, M+2, E).
// The frame is gridDim.y and only offsets the pointers; the plan comes from
// (E, S, M) alone, so each frame's rows are summed in the order of a
// single-frame launch, bit for bit.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 2;                 // warps per column, one per half
constexpr int kColThreads = 32 * kWarps;  // threads per column

// Shared memory: the tile's weights sw[tile] (rounded up to 4 words), then
// one slice per column, in 4-byte words: sy[tile] (the tile's samples),
// term[2*tile] (the taps in row order), acc[R] (the rows' sums),
// wsum[kWarps] (the scan's warp totals), grp[kWarps][K] (each warp's lane
// masks by lo>>1, K = M/2 + 2 keys), cnt[R] (two 16-bit counts, then
// cursors, per row: one per half); each part 16-byte aligned.
__host__ __device__ inline int n_keys(int M) { return M / 2 + 2; }
__host__ __device__ inline int weight_words(int tile) {
  return (tile + 3) & ~3;
}
__host__ __device__ inline int slice_words(int M, int tile) {
  return (3 * tile + 2 * (M + 2) + kWarps + kWarps * n_keys(M) + 3) & ~3;
}

// One tap's term, rounded as the dense form rounds it.
__device__ __forceinline__ float tap(float yp, int row, float wv) {
  return __fmul_rn(
      fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(yp, (float)row)))), wv);
}

__global__ void binning_dense_kernel(const float* __restrict__ y,
                                     const float* __restrict__ w,
                                     float* __restrict__ H, int E, int S,
                                     int M, int tile) {
  extern __shared__ __align__(16) float smem[];
  const size_t frame = blockIdx.y;
  y += frame * E * S;
  w += frame * S;
  H += frame * (M + 2) * E;
  const int R = M + 2;
  const int cols = blockDim.x / kColThreads;  // a power of two
  const int g = threadIdx.x / kColThreads;    // the block's column g ...
  const int t = threadIdx.x % kColThreads;    // ... and its thread t
  const int q = t >> 5;                       // the column's warp q
  const int lane = t & 31;
  const unsigned bit = 1u << lane;
  const unsigned lt = bit - 1u;
  const int e0 = blockIdx.x * cols;
  const bool live = e0 + g < E;               // warp-uniform
  float* sw = smem;
  float* slices = smem + weight_words(tile);
  float* sy = slices + (size_t)g * slice_words(M, tile);
  float* term = sy + tile;
  float* acc = term + 2 * tile;
  int* wsum = reinterpret_cast<int*>(acc + R);
  unsigned* grp = reinterpret_cast<unsigned*>(wsum + kWarps) + q * n_keys(M);
  unsigned* cntw = reinterpret_cast<unsigned*>(wsum + kWarps) +
                   kWarps * n_keys(M);
  unsigned short* cnt = reinterpret_cast<unsigned short*>(cntw);
  const float* yrow = y + (size_t)(e0 + g) * S;
  const float top = (float)(M - 1);

  for (int s0 = 0; s0 < S; s0 += tile) {
    const int n = live ? min(tile, S - s0) : 0;
    cp_async_row(sw, w + s0, min(tile, S - s0), threadIdx.x, blockDim.x);
    cp_async_row(sy, yrow + s0, n, t, kColThreads);
    for (int r = t; r < R; r += kColThreads) cntw[r] = 0u;
    cp_async_wait_all();
    __syncthreads();  // phase: K4 stage

    // Count: sample counts by lo per half (lo = floor(y+1) of a weighted
    // sample); its taps are rows lo and lo+1, so row r's taps number the
    // counts of lo = r-1 and lo = r.
    const int span = (n + kWarps - 1) / kWarps;
    for (int k = t; k < n; k += kColThreads) {
      const float yv = sy[k];
      if (yv >= 0.0f && yv <= top)
        atomicAdd(cntw + (int)floorf(__fadd_rn(yv, 1.0f)),
                  k >= span ? 0x10000u : 1u);
    }
    if (s0 == 0) {  // the sums, and the group tables (they clear themselves)
      for (int r = t; r < R; r += kColThreads) acc[r] = 0.0f;
      for (int k = lane; k < n_keys(M); k += 32) grp[k] = 0u;
    }
    __syncthreads();  // phase: K4 count

    // Scan over (row, half) of the tap counts: thread t owns an odd number
    // of consecutive rows (odd, so that a warp's words fall in distinct
    // banks). cntw[r] holds row r's two lo counts, and becomes its two
    // cursors.
    const int rp = ((R + kColThreads - 1) / kColThreads) | 1;
    const int r_b = min(R, t * rp);
    const int r_e = min(R, r_b + rp);
    const unsigned before = r_b > 0 && r_b < r_e ? cntw[r_b - 1] : 0u;
    int mine = 0;
    unsigned prev = before;
#pragma unroll 4
    for (int r = r_b; r < r_e; ++r) {
      const unsigned v = cntw[r];
      mine += (v & 0xffff) + (v >> 16) + (prev & 0xffff) + (prev >> 16);
      prev = v;
    }
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += u;
    }
    if (lane == 31) wsum[q] = incl;
    __syncthreads();
    unsigned base = incl - mine;
    for (int p = 0; p < q; ++p) base += wsum[p];
    prev = before;
#pragma unroll 4
    for (int r = r_b; r < r_e; ++r) {
      const unsigned v = cntw[r];
      const unsigned b1 = base + (v & 0xffff) + (prev & 0xffff);
      cntw[r] = base | b1 << 16;
      base = b1 + (v >> 16) + (prev >> 16);
      prev = v;
    }
    __syncthreads();  // phase: K4 scan

    // Scatter: warp q takes half q of the tile, batch by batch in sample
    // order; a batch without weighted samples is skipped.
    const int k_b = q * span;
    const int k_e = min(n, k_b + span);
    float y_next = k_b + lane < k_e ? sy[k_b + lane] : -1.0f;
    for (int k0 = k_b; k0 < k_e; k0 += 32) {
      const int k = k0 + lane;
      const float yv = y_next;
      y_next = k + 32 < k_e ? sy[k + 32] : -1.0f;
      const bool valid = yv >= 0.0f && yv <= top;
      if (__ballot_sync(kFull, valid) == 0u) continue;
      const float yp = __fadd_rn(yv, 1.0f);
      const int lo = valid ? (int)floorf(yp) : 0;
      const int ka = lo >> 1;
      const int ia = (lo | 1) * kWarps + q;         // the odd row's cursor
      const int ib = ((lo + 1) & ~1) * kWarps + q;  // the even row's
      const unsigned ca = valid ? cnt[ia] : 0u;
      const unsigned cb = valid ? cnt[ib] : 0u;
      const unsigned odd = __ballot_sync(kFull, valid && (lo & 1));
      if (valid) atomicOr(grp + ka, bit);
      __syncwarp();
      unsigned ma = 0, mb = 0;  // the lanes that tap the odd / even row
      if (valid) {
        ma = grp[ka];
        mb = lo & 1 ? (ma & odd) | (grp[ka + 1] & ~odd)
                    : (grp[ka - 1] & odd) | (ma & ~odd);
      }
      __syncwarp();
      // Every lane has read its cursors and masks: clear the table, place
      // the taps, and let each row's first lane move its cursor.
      if (valid) {
        grp[ka] = 0u;
        const float t0 = tap(yp, lo, sw[k]), t1 = tap(yp, lo + 1, sw[k]);
        term[ca + __popc(ma & lt)] = lo & 1 ? t0 : t1;
        term[cb + __popc(mb & lt)] = lo & 1 ? t1 : t0;
        if ((ma & lt) == 0) cnt[ia] = ca + __popc(ma);
        if ((mb & lt) == 0) cnt[ib] = cb + __popc(mb);
      }
      __syncwarp();
    }
    __syncthreads();  // phase: K4 scatter

    // Row m's taps now lie in s order in [end[m-1], end[m]), end being the
    // last half's cursor; row 0 has none (lo >= 1).
    for (int m = t; m < R; m += kColThreads) {
      const int p_b = m ? cnt[(m - 1) * kWarps + kWarps - 1] : 0;
      const int p_e = cnt[m * kWarps + kWarps - 1];
      float a = acc[m];
#pragma unroll 4
      for (int p = p_b; p < p_e; ++p) a = __fadd_rn(a, term[p]);
      acc[m] = a;
    }
    __syncthreads();  // phase: K4 sum
  }

  // The block's columns side by side: consecutive threads write
  // consecutive columns of a row.
  if (S == 0)
    for (int r = t; r < R; r += kColThreads) acc[r] = 0.0f;
  __syncthreads();
  const int col_shift = __ffs(cols) - 1;
  for (int i = threadIdx.x; i < R * cols; i += blockDim.x) {
    const int m = i >> col_shift;
    const int c = i & (cols - 1);
    if (e0 + c < E)
      H[(size_t)m * E + e0 + c] =
          slices[(size_t)c * slice_words(M, tile) + 3 * tile + m];
  }  // phase: K4 write
}

}  // namespace

// Shared-memory bytes of one block of `cols` columns (not a kernel).
extern "C" int gpet_binning_dense_smem(int M, int tile, int cols) {
  return (weight_words(tile) + cols * slice_words(M, tile)) *
         (int)sizeof(float);
}

extern "C" int gpet_binning_dense(const float* y, const float* w, float* H,
                                  int E, int S, int M, int tile, int cols,
                                  int frames, void* stream) {
  if (frames < 1 || frames > 65535) return (int)cudaErrorInvalidValue;
  const int smem = gpet_binning_dense_smem(M, tile, cols);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        binning_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  binning_dense_kernel<<<dim3((E + cols - 1) / cols, frames),
                         cols * kColThreads, smem, st>>>(y, w, H, E, S, M,
                                                         tile);
  return (int)cudaGetLastError();
}
