// K8: C[f] = A[f] @ B[f] for every frame f in one launch, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves these products to XLA.
// It serves three products of the tracing loop: the sampling round's cross
// product K(X*, X) · A (models/gpr.py::fit_and_sample, (E, n) @ (n, S), both
// per frame) and the KDE blur's two Toeplitz products Ty @ g and g @ Tx
// (trace/kde.py::_separable_blur, a (M+2)² or (N+2)² factor shared by every
// frame). It is written by hand because cuBLAS's batched product picks its
// kernel, and so its order of adds, by the number of frames: a batch frame
// would round apart from its single trace. Here the order of every sum is
// fixed by the shapes of one frame.
//
// Operands, row-major and contiguous per matrix: A (F, M, K), or one (M, K)
// shared by all frames (frame stride 0, not copied); B (F, K, N), or one
// (K, N) shared; C (F, M, N).
//
// Order: each C[f, i, j] is one chain of float32 fused multiply-adds in
// ascending k from +0, c = fma(a_ik, b_kj, c). The chain depends on neither
// F, nor the tile that holds the element, nor the other rows and columns,
// so a frame's bits are those of its single launch and a column's those of
// any launch over a slice of the columns (a rank's sample shard). No TF32,
// no split-K, no atomics: a rerun is bitwise identical.
//
// Band: where the shared A (or B) is zero more than `band` off its
// diagonal (the blur's Toeplitz factors, 2·8 + 1 wide), a tile walks only
// the k-tiles that meet the band over its rows (columns). The products
// skipped are exact zeros times finite values, and adding an exact zero
// leaves a float32 sum unchanged, so the values are those of the full walk.
//
// What bounds it on this card: float32 FMAs, 2·M·N·K operations a frame at
// 67 TFLOP/s (the band: 2·M·N·(2·band + 1) that the product needs), far
// above its bytes (M·K + K·N + M·N floats a frame) for every shape it
// serves (K >= 100).
//
// Design: one block of 256 threads per (128 × 128 output tile, frame); each
// thread holds an 8 × 8 register tile of C, as two 4-row by two 4-column
// quarters 64 apart, so its shared-memory reads are float4 broadcasts (A)
// and conflict-free float4 runs (B). The k axis runs in tiles of 8 staged in
// shared memory (A transposed, its rows padded by 4 so the transposing
// stores fall in distinct banks), double-buffered: the next tile's global
// loads are in registers while the current tile's 64 FMAs a step run. Loads
// are float4 where the row length is a multiple of 4 and the base 16-byte
// aligned, else scalar; out-of-range rows, columns and k load as 0.
//
// ops/cuda_frames.py::product_launch_plan mirrors the grid and the shared
// memory (gpet_frames_product_smem, gpet_frames_product_blocks).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 128;
constexpr int kTileN = 128;
constexpr int kTileK = 8;
constexpr int kLdA = kTileM + 4;  // padded row of the transposed A tile

struct Stage {
  float a[kTileK][kLdA];
  float b[kTileK][kTileN];
};

// This thread's share of one k-tile: A row tid / 2, k 4·(tid % 2) .. +3;
// B row tid / 32, columns 4·(tid % 32) .. +3.
template <bool kVecA, bool kVecB>
__device__ inline void load_tile(const float* __restrict__ A,
                                 const float* __restrict__ B, int M, int N,
                                 int K, int row0, int col0, int k0,
                                 float (&ra)[4], float (&rb)[4]) {
  const int tid = threadIdx.x;
  const int i = row0 + (tid >> 1);
  const int ka = k0 + 4 * (tid & 1);
  if (kVecA && i < M && ka < K) {
    const float4 v = *reinterpret_cast<const float4*>(A + (size_t)i * K + ka);
    ra[0] = v.x;
    ra[1] = v.y;
    ra[2] = v.z;
    ra[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      ra[q] = (i < M && ka + q < K) ? A[(size_t)i * K + ka + q] : 0.f;
  }
  const int kb = k0 + (tid >> 5);
  const int j = col0 + 4 * (tid & 31);
  if (kVecB && kb < K && j < N) {
    const float4 v = *reinterpret_cast<const float4*>(B + (size_t)kb * N + j);
    rb[0] = v.x;
    rb[1] = v.y;
    rb[2] = v.z;
    rb[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      rb[q] = (kb < K && j + q < N) ? B[(size_t)kb * N + j + q] : 0.f;
  }
}

__device__ inline void store_tile(Stage& s, const float (&ra)[4],
                                  const float (&rb)[4]) {
  const int tid = threadIdx.x;
  const int r = tid >> 1;
  const int ka = 4 * (tid & 1);
#pragma unroll
  for (int q = 0; q < 4; ++q) s.a[ka + q][r] = ra[q];
  *reinterpret_cast<float4*>(&s.b[tid >> 5][4 * (tid & 31)]) =
      make_float4(rb[0], rb[1], rb[2], rb[3]);
}

template <bool kVecA, bool kVecB>
__global__ void __launch_bounds__(kThreads)
frames_product_kernel(const float* __restrict__ A, const float* __restrict__ B,
                      float* __restrict__ C, int M, int N, int K,
                      long long a_stride, long long b_stride, int band_a,
                      int band_b) {
  __shared__ __align__(16) Stage st[2];
  const int f = blockIdx.z;
  const int row0 = blockIdx.y * kTileM;
  const int col0 = blockIdx.x * kTileN;
  A += f * a_stride;
  B += f * b_stride;
  C += (size_t)f * M * N;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns 4·tx .. +3 and 64 + 4·tx .. +3
  const int ty = tid >> 4;  // rows 4·ty .. +3 and 64 + 4·ty .. +3

  // The k range this tile has to walk: all of K, or where a band operand
  // is nonzero over the tile's rows (A) or columns (B).
  int klo = 0, khi = K;
  if (band_a >= 0) {
    klo = max(klo, row0 - band_a);
    khi = min(khi, row0 + kTileM + band_a);
  }
  if (band_b >= 0) {
    klo = max(klo, col0 - band_b);
    khi = min(khi, col0 + kTileN + band_b);
  }
  klo = klo / kTileK * kTileK;
  const int ntiles = khi > klo ? (khi - klo + kTileK - 1) / kTileK : 0;

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  float ra[4], rb[4];
  if (ntiles > 0) {
    load_tile<kVecA, kVecB>(A, B, M, N, K, row0, col0, klo, ra, rb);
    store_tile(st[0], ra, rb);
  }
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const bool more = t + 1 < ntiles;
    if (more)
      load_tile<kVecA, kVecB>(A, B, M, N, K, row0, col0,
                              klo + (t + 1) * kTileK, ra, rb);
    const Stage& s = st[t & 1];
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.a[k][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&s.a[k][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s.b[k][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&s.b[k][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[r][c] = __fmaf_rn(a[r], b[c], acc[r][c]);
    }
    if (more) store_tile(st[(t + 1) & 1], ra, rb);
    __syncthreads();  // phase: K8 k-tile
  }

  const bool vec_c =
      (N % 4 == 0) && (reinterpret_cast<uintptr_t>(C) % 16 == 0);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = row0 + (r < 4 ? 4 * ty + r : 64 + 4 * ty + r - 4);
    if (i >= M) continue;
    float* ci = C + (size_t)i * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = col0 + 64 * h + 4 * tx;
      const float* v = &acc[r][4 * h];
      if (vec_c && j + 3 < N) {
        *reinterpret_cast<float4*>(ci + j) = make_float4(v[0], v[1], v[2],
                                                         v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j + q < N) ci[j + q] = v[q];
      }
    }
  }
}

template <bool kVecA, bool kVecB>
void launch(const float* A, const float* B, float* C, int F, int M, int N,
            int K, long long a_stride, long long b_stride, int band_a,
            int band_b, cudaStream_t s) {
  const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM, F);
  frames_product_kernel<kVecA, kVecB><<<grid, kThreads, 0, s>>>(
      A, B, C, M, N, K, a_stride, b_stride, band_a, band_b);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Static shared memory of one block; ops/cuda_frames.py mirrors it.
extern "C" int gpet_frames_product_smem() { return (int)(2 * sizeof(Stage)); }

// Blocks of one launch; ops/cuda_frames.py::product_launch_plan mirrors it.
extern "C" int gpet_frames_product_blocks(int F, int M, int N) {
  return F * ((M + kTileM - 1) / kTileM) * ((N + kTileN - 1) / kTileN);
}

// a_shared / b_shared: the operand is one matrix for every frame. band_a /
// band_b: the shared operand's band (zero more than band off the diagonal),
// or -1 for none.
extern "C" int gpet_frames_product(const float* A, const float* B, float* C,
                                   int F, int M, int N, int K, int a_shared,
                                   int b_shared, int band_a, int band_b,
                                   void* stream) {
  if (F <= 0 || M <= 0 || N <= 0 || K <= 0 || F > 65535)
    return (int)cudaErrorInvalidValue;
  const long long a_stride = a_shared ? 0 : (long long)M * K;
  const long long b_stride = b_shared ? 0 : (long long)K * N;
  // A float4 load needs every row start 16-byte aligned: the base, the row
  // length and the frame stride (a multiple of the row length).
  const bool va = K % 4 == 0 && aligned16(A);
  const bool vb = N % 4 == 0 && aligned16(B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (va && vb)
    launch<true, true>(A, B, C, F, M, N, K, a_stride, b_stride, band_a,
                       band_b, s);
  else if (va)
    launch<true, false>(A, B, C, F, M, N, K, a_stride, b_stride, band_a,
                        band_b, s);
  else if (vb)
    launch<false, true>(A, B, C, F, M, N, K, a_stride, b_stride, band_a,
                        band_b, s);
  else
    launch<false, false>(A, B, C, F, M, N, K, a_stride, b_stride, band_a,
                         band_b, s);
  return (int)cudaGetLastError();
}
