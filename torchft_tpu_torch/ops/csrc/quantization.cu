// Blockwise quantize, dequantize and fused int8 reduce of the replica-axis
// allreduce payload for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes).
//
// Replaces three Pallas TPU kernels of torchft_tpu/ops/quantization.py:
//   tft_quantize_rows    <- _quantize_kernel    (via _quantize_rows)
//   tft_dequantize_rows  <- _dequantize_kernel  (via fused_dequantize)
//   tft_reduce_rows_int8 <- _reduce_kernel      (via fused_reduce_int8)
//
// What they compute is the wire format of the host quantizer
// (torchft_tpu_torch/collectives.py quantize_blockwise / dequantize_blockwise),
// bit for bit:
//   quantize, per row of 512 values of a flat fp32 array (the tail row
//     zero-padded): absmax = max |x| (NaN if the row holds a NaN, as numpy's
//     max); scale = absmax / qmax, correctly rounded, or 1.0 where that is 0;
//     q = clip(rint(x / scale), -qmax, qmax) as int8, rint rounding half to
//     even, a NaN quotient written as 0 (what the host's float->int8 cast
//     writes). qmax is 127 (int8) or 7 (int4; the caller packs the nibbles).
//   dequantize: out = (float)q * scale of its row, for the first n values.
//   reduce (int8 only), per row of 512 values of R quantized copies:
//     acc = sum over r = 0..R-1, in rank order, of (float)q[r] * scale[r],
//     each product and each sum rounded on its own (__fmul_rn, __fadd_rn,
//     which nvcc never contracts into an FMA);
//     acc / R if averaging; then the quantize above with qmax 127. Those are
//     the host's steps (sum dequantize_blockwise of each rank, divide by
//     np.float32(R), quantize_blockwise), so the output is the host's bytes.
// The divides are __fdiv_rn and the products __fmul_rn: correctly rounded, so
// no reciprocal multiply and no approximate divide can move a value across a
// rounding boundary. Nothing here may be built with --use_fast_math (the
// build adds no such flag): it would flush subnormal inputs, which the host
// quantizer keeps. CUDA C++ and not Triton for the same reason: Triton's fp32
// '/' lowers to an approximate divide unless a correctly rounded one is asked
// for, and the port already builds CUDA sources (ops/_cuda_build.py).
//
// What bounds them on the H100: each moves ~5 bytes per value (quantize
// reads 4 and writes 1 + 4/512; dequantize the reverse) for a handful of
// operations, far below the card's ridge: bound by HBM bandwidth. So the
// design is about moving bytes in wide, coalesced accesses:
//   - quantize: one warp per 512-value row, 8 rows per 256-thread block. Each
//     lane loads 4 float4 (16 values); on each of the 4 loads the warp reads
//     512 contiguous bytes. The row max is a warp shuffle, nothing touches
//     shared memory, and q leaves as one 4-byte store per 4 values. Where
//     the TPU kernel took row tiles of 32 (its int8 min tile) on a
//     sequential grid, blocks here are independent and the tail row is
//     masked in the kernel, so the caller passes the unpadded array.
//   - dequantize: 4 values per thread, one 4-byte load of q, one 16-byte
//     store; the 4 values always share a row (512 % 4 == 0), so one scale.
//   - reduce: one warp per row, as quantize. Each lane owns 16 contiguous
//     values: per rank one 16-byte load of 16 int8 (the warp reads the
//     rank's 512-byte row at once) and one broadcast load of the rank's
//     scale; the quotient and the row max reuse quantize's helpers, and q
//     leaves as one 16-byte store per lane. It reads R * (n + 4n/512) bytes
//     and writes n + 4n/512 for about 3R + 6 operations per value, far below
//     the ridge: bound by HBM bandwidth too. Where the TPU kernel padded the
//     row count to its tile of 32, the caller passes exactly `rows` here.
//     Measured, it reaches about half of that bound, and its time follows
//     the per-value correctly rounded divide of the requantize more than
//     its bytes (PERF.md, row 9 of the kernel table).
//   - Rows of an unaligned array, and the ragged tail, take scalar accesses.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kBlock = 512;       // values per scale
constexpr int kRowsPerCta = 8;    // quantize and reduce: one warp per row
constexpr int kThreads = 256;

// max that keeps a NaN from either side (fmaxf would drop it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ signed char quantize_one(float x, float scale,
                                                    float qmax) {
  float r = rintf(__fdiv_rn(x, scale));
  // Comparisons are false for NaN, so a NaN passes the clamp unchanged.
  r = r > qmax ? qmax : (r < -qmax ? -qmax : r);
  return r != r ? (signed char)0 : (signed char)(int)r;
}

// The scale of a row whose 512 values the warp holds, 16 a lane: absmax /
// qmax correctly rounded (NaN if the row holds a NaN), 1.0 where that is 0.
__device__ __forceinline__ float row_scale(const float (&v)[16], float qmax) {
  float m = 0.0f;
#pragma unroll
  for (int e = 0; e < 16; ++e) m = nan_max(m, fabsf(v[e]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float scale = __fdiv_rn(m, qmax);
  return scale == 0.0f ? 1.0f : scale;
}

__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const float* __restrict__ x, long long n,
                     signed char* __restrict__ q, float* __restrict__ scales,
                     long long rows, float qmax) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerCta + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long base = row * kBlock;
  const bool vector = base + kBlock <= n &&
                      (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  float v[16];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long i = base + (long long)(j * 32 + lane) * 4;
    if (vector) {
      const float4 f = *reinterpret_cast<const float4*>(x + i);
      v[4 * j] = f.x;
      v[4 * j + 1] = f.y;
      v[4 * j + 2] = f.z;
      v[4 * j + 3] = f.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[4 * j + e] = i + e < n ? x[i + e] : 0.0f;
    }
  }
  const float scale = row_scale(v, qmax);
  if (lane == 0) scales[row] = scale;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    char4 c;
    c.x = quantize_one(v[4 * j], scale, qmax);
    c.y = quantize_one(v[4 * j + 1], scale, qmax);
    c.z = quantize_one(v[4 * j + 2], scale, qmax);
    c.w = quantize_one(v[4 * j + 3], scale, qmax);
    *reinterpret_cast<char4*>(q + base + (long long)(j * 32 + lane) * 4) = c;
  }
}

__global__ void __launch_bounds__(kThreads)
dequantize_rows_kernel(const signed char* __restrict__ q,
                       const float* __restrict__ scales, long long n,
                       float* __restrict__ out) {
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (i >= n) return;
  const float s = scales[i / kBlock];
  const bool vector = i + 4 <= n &&
                      (reinterpret_cast<uintptr_t>(q) & 3) == 0 &&
                      (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (vector) {
    const char4 c = *reinterpret_cast<const char4*>(q + i);
    float4 f;
    f.x = __fmul_rn((float)c.x, s);
    f.y = __fmul_rn((float)c.y, s);
    f.z = __fmul_rn((float)c.z, s);
    f.w = __fmul_rn((float)c.w, s);
    *reinterpret_cast<float4*>(out + i) = f;
  } else {
    for (long long e = i; e < n && e < i + 4; ++e)
      out[e] = __fmul_rn((float)q[e], s);
  }
}

// The 16 int8 values of one lane, packed four to a 32-bit word (lowest
// address in the low byte): one 16-byte access where the pointer allows it.
__device__ __forceinline__ int4 load16(const signed char* p, bool vector) {
  if (vector) return *reinterpret_cast<const int4*>(p);
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    w[e >> 2] |= (unsigned)(unsigned char)p[e] << (8 * (e & 3));
  return make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
}

__device__ __forceinline__ void store16(signed char* p, int4 v, bool vector) {
  if (vector) {
    *reinterpret_cast<int4*>(p) = v;
    return;
  }
  const unsigned w[4] = {(unsigned)v.x, (unsigned)v.y, (unsigned)v.z,
                         (unsigned)v.w};
#pragma unroll
  for (int e = 0; e < 16; ++e) p[e] = (signed char)(w[e >> 2] >> (8 * (e & 3)));
}

__global__ void __launch_bounds__(kThreads)
reduce_rows_int8_kernel(const signed char* __restrict__ q,
                        const float* __restrict__ scales, long long ranks,
                        long long rows, bool avg, signed char* __restrict__ q_out,
                        float* __restrict__ s_out) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerCta + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long col = (long long)lane * 16;
  const bool vector = ((reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(q_out)) & 15) == 0;
  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.0f;
#pragma unroll 4
  for (long long r = 0; r < ranks; ++r) {
    const int4 b = load16(q + (r * rows + row) * kBlock + col, vector);
    const unsigned w[4] = {(unsigned)b.x, (unsigned)b.y, (unsigned)b.z,
                           (unsigned)b.w};
    const float s = scales[r * rows + row];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float x = (float)(signed char)(w[e >> 2] >> (8 * (e & 3)));
      acc[e] = __fadd_rn(acc[e], __fmul_rn(x, s));
    }
  }
  if (avg) {
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = __fdiv_rn(acc[e], (float)ranks);
  }
  const float scale = row_scale(acc, 127.0f);
  if (lane == 0) s_out[row] = scale;
  unsigned c[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    c[e >> 2] |= (unsigned)(unsigned char)quantize_one(acc[e], scale, 127.0f)
                 << (8 * (e & 3));
  store16(q_out + row * kBlock + col,
          make_int4((int)c[0], (int)c[1], (int)c[2], (int)c[3]), vector);
}

}  // namespace

extern "C" {

// x: fp32 [n]; q: int8 [rows * 512]; scales: fp32 [rows]; rows =
// ceil(n / 512). Returns the launch's CUDA error code (0 on success).
int tft_quantize_rows(const void* x, long long n, void* q, void* scales,
                      float qmax, void* stream) {
  const long long rows = (n + kBlock - 1) / kBlock;
  if (rows == 0) return 0;
  const long long grid = (rows + kRowsPerCta - 1) / kRowsPerCta;
  quantize_rows_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, n, (signed char*)q, (float*)scales, rows, qmax);
  return (int)cudaGetLastError();
}

// q: int8 [>= n], row-major rows of 512; scales: fp32 [ceil(n / 512)];
// out: fp32 [n]. Returns the launch's CUDA error code (0 on success).
int tft_dequantize_rows(const void* q, const void* scales, long long n,
                        void* out, void* stream) {
  if (n == 0) return 0;
  const long long grid = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  dequantize_rows_kernel<<<(unsigned)grid, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const signed char*)q, (const float*)scales, n, (float*)out);
  return (int)cudaGetLastError();
}

// q: int8 [ranks, rows, 512]; scales: fp32 [ranks, rows]; q_out: int8
// [rows, 512]; s_out: fp32 [rows]. avg != 0 divides the sum by ranks.
// Returns the launch's CUDA error code (0 on success).
int tft_reduce_rows_int8(const void* q, const void* scales, long long ranks,
                         long long rows, int avg, void* q_out, void* s_out,
                         void* stream) {
  if (rows == 0) return 0;
  const long long grid = (rows + kRowsPerCta - 1) / kRowsPerCta;
  reduce_rows_int8_kernel<<<(unsigned)grid, kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const signed char*)q, (const float*)scales, ranks, rows, avg != 0,
      (signed char*)q_out, (float*)s_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
