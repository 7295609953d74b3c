// K7: the JAX package's random draws -- threefry2x32 bits, uniforms and
// normals -- for Hopper (sm_90a), a whole table of draws per launch.
//
// Not a port of a Pallas kernel: the JAX package draws through XLA
// (jax.random.normal / uniform under jax_threefry_partitionable=True), and
// this kernel computes the same numbers on the card, bit for bit the plain
// version in ops/prng.py, which equals jax.random's CPU draws bit for bit.
//
// Element (i, j) of a (rows, S_tot) draw hashes the 64-bit counter
// i*S_tot + j, split into (high, low) words, with the 20-round threefry2x32
// under the key (k0, k1), and takes bits1 ^ bits2. A draw covers the column
// window [c0, c0 + ncols) of every row, so a sample shard draws its own
// columns and they equal the full draw's. Mode 0 writes the bits, mode 1
// the uniform max(lo, f*span + lo) with f = bitcast((bits >> 9) | 1.0) - 1,
// mode 2 the normal sqrt(2)*erf_inv(u) of the uniform on
// [nextafter(-1, 0), 1), with the erf_inv and log1p that XLA compiles for
// the CPU: fmaf exactly where its compiled code fuses, __fmul_rn /
// __fadd_rn / __fdiv_rn / __fsqrt_rn elsewhere, so nvcc contracts nothing.
//
// What bounds it on this card: the issue rate. threefry2x32 is 73 32-bit
// adds, rotates and xors per element (20 rounds of three, two key words
// injected after every four rounds, the final xor); Hopper runs 32-bit
// integer work on 64 INT32 lanes per SM per clock and integer multiply-adds
// on the FMA pipe's 64 more, so integer instructions alone can fill its
// issue of 4 warp-instructions per SM per clock; the normal transform adds
// ~41 instructions the function needs, mostly float32. At (208, 10^4),
// 2.08 M normals, ~114 instructions each take ~7 us at the issue rate,
// against ~2.5 us for the 8 MB written (chip_smoke.py::work_threefry
// counts it).
//
// Design, to issue fewer instructions per draw and to split the integer
// ones between the ALU and the FMA pipe:
//   - one launch per table of up to kMaxDraws draws, each a descriptor in
//     the kernel's parameters (__grid_constant__: read in place) with its
//     own key, shape, window, mode and output rows (pointer and row
//     stride), so an iteration's prior and noise draws, or every member of
//     an ensemble, take one launch and land in their stacked tensors;
//   - a grid of (column tiles, rows of the whole table): blockIdx.y picks
//     the draw by a prefix over row counts, so there is no division;
//   - kPerThread consecutive elements per thread: one 64-bit counter per
//     thread and row, after which each element's counter is the low word
//     plus its offset (the high word is the thread's, unless the low word
//     wraps inside the thread's run, which takes a path of its own), eight
//     independent threefry chains for the scheduler, and 16-byte stores
//     where the row is aligned (scalar stores otherwise and at the edge);
//     128 threads keep a tile at 1024 columns, so the demo's rows of 1000
//     fill their blocks;
//   - threefry's adds issued as integer multiply-adds on the FMA pipe
//     (add_on_fma), which leaves the ALU its rotates and xors;
//   - 32-bit offsets inside a row; the wrapper raises on a draw whose row
//     length, window or row count does not fit them;
//   - the normal transform without integer-side selects: both arms of
//     log1p computed and one selected (36% of the lanes take the log arm,
//     so a warp would run both anyway), and erf_inv's common chain with its
//     coefficients as immediates on the FMA pipe, the rare w >= 5 chain and
//     its square root behind a branch.
// tests/torch_kernel_variants.py times each choice against the others.

#include <cstdint>
#include <cuda_runtime.h>

// One draw as the wrapper passes it (ops/prng.py::_DrawArgs). Outside the
// unnamed namespace: the exported entry point takes it.
struct GpetDrawArgs {
  void* out;          // row 0 of the window
  uint32_t k0, k1;    // the key
  int rows, S_tot;    // the full draw's rows and row length
  int c0, ncols;      // the column window
  int row_stride;     // elements between output rows
  int mode;           // 0 bits, 1 uniform, 2 normal
  float lo, span;     // the uniform's minval and maxval - minval
};

namespace {

// Threads per block and consecutive elements per thread: a tile of 1024
// columns per block row (tests/torch_kernel_variants.py times others).
constexpr int kThreads = 128;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;
// Draws per launch; ops/prng.py::_MAX_DRAWS mirrors it (the launcher
// refuses a longer table).
constexpr int kMaxDraws = 64;

struct Table {
  GpetDrawArgs d[kMaxDraws];
  int row0[kMaxDraws + 1];  // first row of each draw in the table
  int n;
};

__device__ __forceinline__ float bits_f(uint32_t b) {
  return __uint_as_float(b);
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// a + b as a*one + b: one is 1 at run time but not to the compiler, so the
// add stays an integer multiply-add, which Hopper runs on the FMA pipe,
// beside the ALU's rotates and xors, and is not folded into an IADD3.
__device__ __forceinline__ uint32_t add_on_fma(uint32_t a, uint32_t b,
                                               uint32_t one) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(one), "r"(b));
  return d;
}

// bits1 ^ bits2 of threefry2x32 of the counter (x0, x1) under (k0, k1, k2).
__device__ __forceinline__ uint32_t threefry(uint32_t k0, uint32_t k1,
                                             uint32_t k2, uint32_t x0,
                                             uint32_t x1, uint32_t one) {
  const uint32_t ks[3] = {k0, k1, k2};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 = add_on_fma(x0, x1, one);
      x1 = rotl32(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 = add_on_fma(x0, ks[(i + 1) % 3], one);
    x1 = add_on_fma(x1, ks[(i + 2) % 3] + (uint32_t)(i + 1), one);
  }
  return x0 ^ x1;
}

// The bits of one counter, for the thread whose run of kPerThread counters
// wraps the low word (the high word steps inside the run): out of line, as
// it is rare.
__device__ __noinline__ uint32_t threefry_at(uint32_t k0, uint32_t k1,
                                             uint32_t k2,
                                             unsigned long long c,
                                             uint32_t one) {
  return threefry(k0, k1, k2, (uint32_t)(c >> 32), (uint32_t)c, one);
}

// XLA's CPU float32 log for a in (0, inf): a Cephes polynomial.
__device__ __forceinline__ float xla_log(float a) {
  a = fmaxf(a, bits_f(0x00800000u));
  const int bits = __float_as_int(a);
  const float e0 = __fadd_rn(__int2float_rn((bits >> 23) - 127), 1.0f);
  const float m = __int_as_float((bits & 0x007FFFFF) | 0x3F000000);
  const bool small = m < bits_f(0x3F3504F3u);
  const float e = small ? __fsub_rn(e0, 1.0f) : e0;
  const float z = __fadd_rn(__fadd_rn(m, -1.0f), small ? m : 0.0f);
  const float z2 = __fmul_rn(z, z);
  const float z3 = __fmul_rn(z2, z);
  float y = fmaf(fmaf(bits_f(0x3D9021BBu), z, bits_f(0xBDEBD1B8u)), z,
                 bits_f(0x3DEF251Au));
  const float y1 = fmaf(fmaf(bits_f(0xBDFE5D4Fu), z, bits_f(0x3E11E9BFu)), z,
                        bits_f(0xBE2AAE50u));
  const float y2 = fmaf(fmaf(bits_f(0x3E4CCEACu), z, bits_f(0xBE7FFFFCu)), z,
                        bits_f(0x3EAAAAAAu));
  y = fmaf(y, z3, y1);
  y = fmaf(y, z3, y2);
  y = fmaf(y, z3, __fmul_rn(e, bits_f(0xB95E8083u)));
  const float lg = __fadd_rn(fmaf(-z2, 0.5f, z), y);
  return fmaf(e, bits_f(0x3F318000u), lg);
}

// XLA's CPU float32 log1p of t = -x*x in (-1, 0]: a rational form (Cephes)
// for |t| below sqrt(2) - 1, log(1 + t) above it. Both arms are computed
// and one selected, as ~36% of a warp's lanes take the second.
__device__ __forceinline__ float xla_log1p(float t) {
  const float large = xla_log(__fadd_rn(t, 1.0f));
  const float t2 = __fmul_rn(t, t);
  float den = 1.0f;
  den = fmaf(den, t, bits_f(0x417101ADu));
  den = fmaf(den, t, bits_f(0x42A6185Bu));
  den = fmaf(den, t, bits_f(0x435DC32Du));
  den = fmaf(den, t, bits_f(0x439A8CA3u));
  den = fmaf(den, t, bits_f(0x43586D8Au));
  den = fmaf(den, t, bits_f(0x42707982u));
  float num = bits_f(0x383DE04Bu);
  num = fmaf(num, t, bits_f(0x3EFF40C5u));
  num = fmaf(num, t, bits_f(0x40D284FAu));
  num = fmaf(num, t, bits_f(0x41EF4B9Cu));
  num = fmaf(num, t, bits_f(0x4273CC76u));
  num = fmaf(num, t, bits_f(0x426473ADu));
  num = fmaf(num, t, bits_f(0x41A05101u));
  const float r = __fmul_rn(__fmul_rn(t, t2), __fdiv_rn(num, den));
  const float small = __fadd_rn(t, fmaf(-t2, 0.5f, r));
  return fabsf(t) < bits_f(0x3ED413CDu) ? small : large;
}

// XLA's float32 erf_inv for x in (-1, 1) (Giles), w = -log1p(-x*x): a
// Horner chain for w < 5 and one for w >= 5. The second (with its square
// root) is behind a branch: ~0.3% of the elements take it, so ~90% of
// warps skip it.
__device__ __forceinline__ float xla_erf_inv(float x) {
  const float l1p = xla_log1p(__fmul_rn(x, -x));
  float p;
  if (l1p > -5.0f) {
    const float w = __fsub_rn(-2.5f, l1p);
    p = fmaf(bits_f(0x32F16588u), w, bits_f(0x34B84B36u));
    p = fmaf(w, p, bits_f(0xB66C7357u));
    p = fmaf(w, p, bits_f(0xB6935AC1u));
    p = fmaf(w, p, bits_f(0x396532DBu));
    p = fmaf(w, p, bits_f(0xBAA45408u));
    p = fmaf(w, p, bits_f(0xBB88E4EFu));
    p = fmaf(w, p, bits_f(0x3E7C8F63u));
    p = fmaf(w, p, bits_f(0x3FC02E2Fu));
  } else {
    const float w = __fadd_rn(__fsqrt_rn(-l1p), -3.0f);
    p = fmaf(bits_f(0xB951F09Bu), w, bits_f(0x38D3B56Bu));
    p = fmaf(w, p, bits_f(0x3AB0DC72u));
    p = fmaf(w, p, bits_f(0xBB70BDE7u));
    p = fmaf(w, p, bits_f(0x3BBC127Bu));
    p = fmaf(w, p, bits_f(0xBBF9C5D7u));
    p = fmaf(w, p, bits_f(0x3C1AA57Eu));
    p = fmaf(w, p, bits_f(0x3F8036DBu));
    p = fmaf(w, p, bits_f(0x40354F7Eu));
  }
  return __fmul_rn(x, p);
}

__device__ __forceinline__ float uniform_of(uint32_t bits, float lo,
                                            float span) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u),
                            1.0f);
  return fmaxf(lo, __fadd_rn(__fmul_rn(f, span), lo));
}

// n values to dst: 16-byte stores where the whole run is there and dst is
// aligned to them, scalar stores otherwise.
__device__ __forceinline__ void store(float* dst, const float (&v)[kPerThread],
                                      int n) {
  constexpr int kVec = kPerThread < 4 ? kPerThread : 4;
  if (n == kPerThread &&
      (reinterpret_cast<uintptr_t>(dst) & (sizeof(float) * kVec - 1)) == 0) {
#pragma unroll
    for (int j = 0; j < kPerThread; j += kVec) {
      if constexpr (kVec == 4)
        *reinterpret_cast<float4*>(dst + j) =
            make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      else
        *reinterpret_cast<float2*>(dst + j) = make_float2(v[j], v[j + 1]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (j < n) dst[j] = v[j];
  }
}

__global__ void __launch_bounds__(kThreads)
threefry_table_kernel(const __grid_constant__ Table t) {
  const int total = t.row0[t.n];
  const uint32_t one = t.n > 0;  // 1, unknown to the compiler (add_on_fma)
  const int col = blockIdx.x * kTile + threadIdx.x * kPerThread;
  int d = 0;
  for (int g = blockIdx.y; g < total; g += gridDim.y) {
    while (g >= t.row0[d + 1]) ++d;  // rows only grow: d only grows
    const GpetDrawArgs& a = t.d[d];
    if (col >= a.ncols) continue;
    const int row = g - t.row0[d];
    const uint32_t k2 = a.k0 ^ a.k1 ^ 0x1BD11BDAu;
    const unsigned long long ctr =
        (unsigned long long)row * (unsigned)a.S_tot + (unsigned)(a.c0 + col);
    uint32_t bits[kPerThread];
    const uint32_t hi = (uint32_t)(ctr >> 32), lo = (uint32_t)ctr;
    if (lo > 0xFFFFFFFFu - (kPerThread - 1)) {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        bits[j] = threefry_at(a.k0, a.k1, k2, ctr + j, one);
    } else {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        bits[j] = threefry(a.k0, a.k1, k2, hi, lo + j, one);
    }
    float v[kPerThread];
    if (a.mode == 2) {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        v[j] = __fmul_rn(xla_erf_inv(uniform_of(bits[j], a.lo, a.span)),
                         bits_f(0x3FB504F3u));
    } else if (a.mode == 1) {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        v[j] = uniform_of(bits[j], a.lo, a.span);
    } else {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) v[j] = __uint_as_float(bits[j]);
    }
    float* dst = static_cast<float*>(a.out) + (size_t)row * a.row_stride + col;
    store(dst, v, min(kPerThread, a.ncols - col));
  }
}

}  // namespace

// draws: n descriptors, 1 <= n <= kMaxDraws, each writing its (rows, ncols)
// window to out with rows row_stride elements apart (float32, int32 bits in
// mode 0). One launch of (column tiles of the widest window, rows of all
// draws) blocks, at most 65535 along y (a block then takes every 65535th
// row). The wrapper checks that every size fits 32 bits.
extern "C" int gpet_threefry_table(const GpetDrawArgs* draws, int n,
                                   void* stream) {
  if (n < 1 || n > kMaxDraws) return (int)cudaErrorInvalidValue;
  Table t;
  t.n = n;
  t.row0[0] = 0;
  int widest = 0;
  long long rows = 0;
  for (int i = 0; i < n; ++i) {
    const GpetDrawArgs& a = draws[i];
    // A thread's first column, blockIdx.x * kTile + ..., stays an int.
    if (a.rows < 0 || a.ncols < 0 || a.ncols > 0x7FFFFFFF - kTile ||
        a.c0 < 0 || a.S_tot < 0 || (long long)a.c0 + a.ncols > a.S_tot ||
        a.row_stride < a.ncols || a.mode < 0 || a.mode > 2)
      return (int)cudaErrorInvalidValue;
    t.d[i] = a;
    rows += a.ncols > 0 ? a.rows : 0;
    if (rows > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    t.row0[i + 1] = (int)rows;
    if (a.rows > 0 && a.ncols > widest) widest = a.ncols;
  }
  if (rows == 0) return 0;
  const unsigned int bx = (unsigned int)((widest + kTile - 1) / kTile);
  const unsigned int by = (unsigned int)(rows < 65535 ? rows : 65535);
  threefry_table_kernel<<<dim3(bx, by), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(t);
  return (int)cudaGetLastError();
}
