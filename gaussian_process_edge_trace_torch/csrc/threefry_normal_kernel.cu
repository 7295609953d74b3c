// The JAX package's random draws: threefry2x32 bits, uniforms and normals.
//
// Not a port of a Pallas kernel: the JAX package draws through XLA
// (jax.random.normal / uniform under jax_threefry_partitionable=True), and
// this kernel computes the same numbers on the card, bit for bit the plain
// version in ops/prng.py, which equals jax.random's CPU draws bit for bit.
//
// Element (i, j) of a (rows, S_tot) draw hashes the 64-bit counter
// i*S_tot + j, split into (high, low) words, with the 20-round threefry2x32
// under the key (k0, k1), and takes bits1 ^ bits2. The launch covers the
// column window [c0, c0 + ncols) of every row, so a sample shard draws its
// own columns and they equal the full draw's. Mode 0 writes the bits, mode 1
// the uniform max(lo, f*span + lo) with f = bitcast((bits >> 9) | 1.0) - 1,
// mode 2 the normal sqrt(2)*erf_inv(u) of the uniform on
// [nextafter(-1, 0), 1), with the erf_inv and log1p that XLA compiles for
// the CPU: fmaf exactly where its compiled code fuses, __fmul_rn /
// __fadd_rn / __fdiv_rn / __fsqrt_rn elsewhere, so nvcc contracts nothing.
//
// What bounds it: operations. One element is ~75 integer operations of
// threefry and ~60 float operations of the normal transform for 4 bytes
// written. One thread per element, grid-stride, no shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__device__ __forceinline__ float bits_f(uint32_t b) {
  return __uint_as_float(b);
}

// XLA's CPU float32 log for a in (0, inf): a Cephes polynomial.
__device__ float xla_log(float a) {
  a = fmaxf(a, bits_f(0x00800000u));
  const int bits = __float_as_int(a);
  float e = __fadd_rn(__int2float_rn((bits >> 23) - 127), 1.0f);
  const float m = __int_as_float((bits & 0x007FFFFF) | 0x3F000000);
  const bool small = m < bits_f(0x3F3504F3u);
  if (small) e = __fsub_rn(e, 1.0f);
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

// XLA's CPU float32 log1p of t = -x*x in (-1, 0].
__device__ float xla_log1p(float t) {
  if (!(fabsf(t) < bits_f(0x3ED413CDu))) return xla_log(__fadd_rn(t, 1.0f));
  const uint32_t den_c[6] = {0x417101ADu, 0x42A6185Bu, 0x435DC32Du,
                             0x439A8CA3u, 0x43586D8Au, 0x42707982u};
  const uint32_t num_c[7] = {0x383DE04Bu, 0x3EFF40C5u, 0x40D284FAu,
                             0x41EF4B9Cu, 0x4273CC76u, 0x426473ADu,
                             0x41A05101u};
  const float t2 = __fmul_rn(t, t);
  float den = 1.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) den = fmaf(den, t, bits_f(den_c[i]));
  float num = bits_f(num_c[0]);
#pragma unroll
  for (int i = 1; i < 7; ++i) num = fmaf(num, t, bits_f(num_c[i]));
  const float r = __fmul_rn(__fmul_rn(t, t2), __fdiv_rn(num, den));
  return __fadd_rn(t, fmaf(-t2, 0.5f, r));
}

// XLA's float32 erf_inv for x in (-1, 1) (Giles), w = -log1p(-x*x).
__device__ float xla_erf_inv(float x) {
  const uint32_t lt5[9] = {0x32F16588u, 0x34B84B36u, 0xB66C7357u,
                           0xB6935AC1u, 0x396532DBu, 0xBAA45408u,
                           0xBB88E4EFu, 0x3E7C8F63u, 0x3FC02E2Fu};
  const uint32_t ge5[9] = {0xB951F09Bu, 0x38D3B56Bu, 0x3AB0DC72u,
                           0xBB70BDE7u, 0x3BBC127Bu, 0xBBF9C5D7u,
                           0x3C1AA57Eu, 0x3F8036DBu, 0x40354F7Eu};
  const float l1p = xla_log1p(__fmul_rn(x, -x));
  const bool lt = l1p > -5.0f;
  const float w = lt ? __fsub_rn(-2.5f, l1p)
                     : __fadd_rn(__fsqrt_rn(-l1p), -3.0f);
  float p = fmaf(bits_f(lt ? lt5[0] : ge5[0]), w,
                 bits_f(lt ? lt5[1] : ge5[1]));
#pragma unroll
  for (int i = 2; i < 9; ++i) p = fmaf(w, p, bits_f(lt ? lt5[i] : ge5[i]));
  return __fmul_rn(x, p);
}

__global__ void threefry_kernel(float* __restrict__ out, uint32_t k0,
                                uint32_t k1, long long rows, long long S_tot,
                                long long c0, long long ncols, int mode,
                                float lo, float span) {
  // Rows along y, columns along x, both grid-stride: no division.
  for (long long i = blockIdx.y; i < rows; i += gridDim.y) {
    for (long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         c < ncols; c += (long long)gridDim.x * blockDim.x) {
      const unsigned long long idx =
          (unsigned long long)(i * S_tot + c0 + c);
      uint32_t x0 = (uint32_t)(idx >> 32), x1 = (uint32_t)idx;
      threefry2x32(k0, k1, x0, x1);
      const uint32_t bits = x0 ^ x1;
      const long long o = i * ncols + c;
      if (mode == 0) {
        reinterpret_cast<uint32_t*>(out)[o] = bits;
        continue;
      }
      const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u),
                                1.0f);
      const float u = fmaxf(lo, __fadd_rn(__fmul_rn(f, span), lo));
      out[o] = mode == 1 ? u
                         : __fmul_rn(xla_erf_inv(u), bits_f(0x3FB504F3u));
    }
  }
}

}  // namespace

// out: (rows, ncols) float32 (int32 bits in mode 0), contiguous. A grid of
// (column blocks, rows) blocks, at most 65535 along y and 1024 along x.
extern "C" int gpet_threefry(void* out, unsigned int k0, unsigned int k1,
                             long long rows, long long S_tot, long long c0,
                             long long ncols, int mode, float lo, float span,
                             int threads, void* stream) {
  if (rows < 0 || ncols < 0 || c0 < 0 || c0 + ncols > S_tot || mode < 0 ||
      mode > 2 || threads < 32 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || ncols == 0) return 0;
  long long bx = (ncols + threads - 1) / threads;
  if (bx > 1024) bx = 1024;
  const long long by = rows < 65535 ? rows : 65535;
  threefry_kernel<<<dim3((unsigned int)bx, (unsigned int)by), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), k0, k1, rows, S_tot, c0, ncols, mode, lo,
      span);
  return (int)cudaGetLastError();
}
