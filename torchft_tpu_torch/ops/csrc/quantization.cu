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
// Every product and sum is __fmul_rn or __fadd_rn and every divide __fdiv_rn:
// correctly rounded. The reduce's requantize multiplies by a reciprocal
// instead, and takes __fdiv_rn wherever that multiply could fall on the
// other side of a rounding boundary (below), so it writes the same bytes.
// Nothing here may be built with --use_fast_math (the
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
//   - reduce: one warp per row. Each lane owns 16 contiguous values: per
//     rank one 16-byte load of 16 int8 (the warp reads the rank's 512-byte
//     row at once) and one broadcast load of the rank's scale; q leaves as
//     one 16-byte store per lane. It reads R * (n + 4n/512) bytes and
//     writes n + 4n/512, so HBM bounds it (R=2 at a 32 MiB bucket: 0.0076
//     ms on an H100 SXM). Its first version, a divide per value, reached
//     41% of that at R=2 and 52% at R=4. Its SASS held, per value, an I2F
//     per rank, the MUFU.RCP, FCHK and slow-path branch of a correctly
//     rounded divide, an FRND for rintf and an F2I for the cast:
//     instructions that issue 16 a clock per SM where an fp32 add or
//     multiply issues 128 (CUDA programming guide, compute capability 9.0).
//     A copy of its bytes alone took half its time, and a multiply in place
//     of its divide saved a sixth (PERF.md, kernel 9, measured by
//     ops/reduce_split.py). Its per-value work now runs on the fp32 and
//     integer pipes, exact by construction
//     (each step is exact, or rounds once as the host's numpy step does):
//       * int8 -> fp32 without I2F: the float with bits kDecodeBits |
//         (b ^ 0x80) is 2^23 + 128 + b, exactly; minus kDecodeBias leaves
//         b. One PRMT and one FADD a value.
//       * The average: for R a power of two a multiply by 1/R, which
//         denotes the same real number as acc / R and so rounds to the
//         same float, subnormals included; for other R the correctly
//         rounded divide by R, passed as a float from the host.
//       * The quotient: per row scale = fl(absmax / 127) and inv = fl(1 /
//         scale), both correctly rounded; per value t = fl(x * inv), which
//         lies within kQuotientGuard of the host's fl(x / scale) (the
//         argument sits beside it). A lane with a t within the guard of a
//         half-integer takes __fdiv_rn for its 16 values, and so does a
//         row whose inv is not a finite positive number (scale NaN, inf
//         or below 2^-128), a branch uniform over the warp.
//       * rint and the cast without FRND and F2I: t + kRintMagic rounds to
//         nearest even on the integers, and the low byte of the sum's
//         bits is rint(t) as a two's-complement int8. PRMT packs four.
//     That leaves about 14 instructions a value at R=2 (decode, product
//     and sum per rank; |x| max; multiply, magic add, rint and the guard's
//     distance; packing), all on full-rate pipes, and the kernel bound by
//     how many bytes it keeps in flight. So R = 1..kMaxFixedRanks are
//     compiled with R fixed, a lane's R loads issue together, and on a
//     grid capped at kWaves waves of resident 128-thread blocks each warp
//     issues its next row's loads before the current row's arithmetic.
//     A ring of cp.async.bulk copies into shared memory was slower on the
//     card, and is not kept (PERF.md, kernel 9).
//   - Rows of an unaligned array, and the ragged tail, take scalar accesses.

#include <cuda_runtime.h>

#include <float.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 512;       // values per scale
constexpr int kRowsPerCta = 8;    // quantize: one warp per row
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

// ---- kernel 9: the fused int8 reduce -------------------------------------

// One warp per row, 4 rows per 128-thread block: a finer grain of resident
// blocks than quantize's 8 rows, for the reduce's 48-80 registers a thread.
constexpr int kReduceRows = 4;
constexpr int kReduceThreads = 32 * kReduceRows;

// int8 -> fp32 without I2F: for the int8 b, the float with bits kDecodeBits |
// (b ^ 0x80) is 2^23 + 128 + b exactly, and subtracting kDecodeBias (exact:
// both lie in [2^23, 2^24)) leaves b.
constexpr unsigned kDecodeBits = 0x4B000000u;  // the bits of 2^23
constexpr unsigned kDecodeFlip = 0x80808080u;  // b ^ 0x80 in each byte
constexpr float kDecodeBias = 8388736.0f;      // 2^23 + 128
// rint and the int8 cast without FRND and F2I: for |t| <= 127.5 the sum
// m = t + kRintMagic lies in [2^23, 2^24), where the adder's round to
// nearest even lands on 1.5 * 2^23 + rint(t). The low byte of m's bits is
// then rint(t) as a two's-complement int8, and m - kRintMagic is rint(t),
// both exactly.
constexpr float kRintMagic = 12582912.0f;      // 1.5 * 2^23
// The guard band of the reciprocal quotient. Per row, scale = fl(absmax /
// 127) and inv = fl(1 / scale); per value the host divides, fl(x / scale),
// and the kernel multiplies, t = fl(x * inv). Every x of the row has |x| <=
// absmax, so |x / scale| <= 127 / (1 - u) with u = 2^-24 (and below 127 (1 +
// 2^-21) where scale is subnormal but inv finite: scale > 2^-128 keeps 22
// bits). inv is normal (scale < 2^128 / 127), so t = (x / scale)(1 + e1)(1 +
// e2) and fl(x / scale) = (x / scale)(1 + e3) with each |e| <= u, or an
// error of at most 2^-150 where a result is subnormal. Hence
//   |t - fl(x / scale)| <= 3u * 127 (1 + 2^-21) + O(u^2) ~= 2.28e-5 < G.
// Where t lies closer than 0.5 - G to its nearest integer k, fl(x / scale)
// lies closer than 0.5 to k, and both round to k; elsewhere the value (with
// its lane) takes __fdiv_rn. The same bound keeps |t| < 127.5, so the fast
// path needs no
// clamp (the bounds are integers: clamp then rint is rint then clamp), and
// t is never NaN: a NaN or an inf in the row makes scale NaN or inf, and a
// row whose inv is not finite and positive takes __fdiv_rn throughout.
constexpr float kQuotientGuard = 0x1p-15f;
constexpr float kNearHalf = 0.5f - kQuotientGuard;  // exact in fp32
// R = 1..kMaxFixedRanks are compiled with R fixed; above it R is a run-time
// loop.
constexpr int kMaxFixedRanks = 8;

// max that keeps a NaN from either side, in one instruction (sm_80+).
__device__ __forceinline__ float max_keep_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Adds one rank's 16 values, q (4 to a word) times its scale s, to acc:
// each product and each sum rounded once, in rank order, as the host. The
// first rank's products are taken as they are where the host adds them to
// 0: the two differ only where a product is -0, which leaves every output
// bit as it is (|-0| = 0 in the max, and -0 + kRintMagic = +0 + kRintMagic).
template <bool kFirst>
__device__ __forceinline__ void add_rank(float (&acc)[16], int4 b, float s) {
  const unsigned w[4] = {(unsigned)b.x ^ kDecodeFlip,
                         (unsigned)b.y ^ kDecodeFlip,
                         (unsigned)b.z ^ kDecodeFlip,
                         (unsigned)b.w ^ kDecodeFlip};
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    // Byte e & 3 of the word under the three high bytes of kDecodeBits.
    const float f =
        __uint_as_float(__byte_perm(w[e >> 2], kDecodeBits, 0x7540 | (e & 3)));
    const float p = __fmul_rn(__fadd_rn(f, -kDecodeBias), s);
    acc[e] = kFirst ? p : __fadd_rn(acc[e], p);
  }
}

// The host's requantize step on the slow pipes: rint(fl(x / scale)) clamped
// to +-127, a NaN quotient as 0, returned as the bits of 1.5 * 2^23 plus it.
__device__ __forceinline__ unsigned exact_rint_bits(float x, float scale) {
  float t = __fdiv_rn(x, scale);
  t = t != t ? 0.0f : fminf(fmaxf(t, -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(t, kRintMagic));
}

// The low bytes of four words, in order, as one word.
__device__ __forceinline__ unsigned pack_low_bytes(unsigned a, unsigned b,
                                                   unsigned c, unsigned d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// max |x| over the lane's 16 values as a tree (NaN if one is NaN).
__device__ __forceinline__ float lane_absmax(const float (&x)[16]) {
  float m[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = max_keep_nan(fabsf(x[2 * i]), fabsf(x[2 * i + 1]));
#pragma unroll
  for (int w = 4; w > 0; w >>= 1) {
#pragma unroll
    for (int i = 0; i < w; ++i) m[i] = max_keep_nan(m[i], m[i + w]);
  }
  return m[0];
}

// Requantizes a row whose 512 values the warp holds, 16 a lane: the row's
// scale (absmax / 127 correctly rounded, NaN if the row holds a NaN, 1.0
// where it is 0) and the lane's 16 int8, four to a word. A lane with any
// value within the guard band takes the divide for all 16: a warp runs a
// value's divide if any of its lanes needs it, so on a tie-heavy row that
// costs what a per-value choice would, and elsewhere it is rare (about one
// lane in 2^10 on values with no ties).
__device__ __forceinline__ int4 requantize_row(const float (&x)[16],
                                               float& scale_out) {
  float amax = lane_absmax(x);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = max_keep_nan(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  float scale = __fdiv_rn(amax, 127.0f);
  scale = scale == 0.0f ? 1.0f : scale;
  scale_out = scale;
  const float inv = __frcp_rn(scale);
  unsigned c[4];
  // false for NaN; the same in every lane
  const bool fast = inv > 0.0f && inv <= FLT_MAX;
  float far = 0.0f;  // the largest |t - rint(t)| of the lane
  if (fast) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned m[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float t = __fmul_rn(x[4 * j + i], inv);
        const float m_i = __fadd_rn(t, kRintMagic);
        m[i] = __float_as_uint(m_i);
        far = fmaxf(far, fabsf(__fadd_rn(t, -__fadd_rn(m_i, -kRintMagic))));
      }
      c[j] = pack_low_bytes(m[0], m[1], m[2], m[3]);
    }
  }
  if (!fast || far >= kNearHalf) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[j] = pack_low_bytes(exact_rint_bits(x[4 * j], scale),
                            exact_rint_bits(x[4 * j + 1], scale),
                            exact_rint_bits(x[4 * j + 2], scale),
                            exact_rint_bits(x[4 * j + 3], scale));
  }
  return make_int4((int)c[0], (int)c[1], (int)c[2], (int)c[3]);
}

// One lane's loads of one row: R 16-byte payload pieces and R scales.
template <int kRanks>
__device__ __forceinline__ void load_row(const signed char* __restrict__ q,
                                         const float* __restrict__ scales,
                                         long long rows, long long row,
                                         long long col, bool vector,
                                         int4 (&b)[kRanks], float (&s)[kRanks]) {
#pragma unroll
  for (int r = 0; r < kRanks; ++r) {
    b[r] = load16(q + (r * rows + row) * kBlock + col, vector);
    s[r] = scales[r * rows + row];
  }
}

// The average, the requantize and the row's stores.
__device__ __forceinline__ void finish_row(float (&acc)[16], int avg_mode,
                                           float avg_arg, long long row,
                                           int lane, long long col, bool vector,
                                           signed char* __restrict__ q_out,
                                           float* __restrict__ s_out) {
  if (avg_mode == 1) {
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = __fmul_rn(acc[e], avg_arg);
  } else if (avg_mode == 2) {
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = __fdiv_rn(acc[e], avg_arg);
  }
  float scale;
  const int4 c = requantize_row(acc, scale);
  if (lane == 0) s_out[row] = scale;
  store16(q_out + row * kBlock + col, c, vector);
}

// One warp per row, over the rows at a stride of the grid's warps.
// kRanks in 1..kMaxFixedRanks: R fixed; the grid is capped at kWaves waves
// of resident blocks, and each warp issues its next row's R loads before
// the arithmetic of the current one, so a warp keeps its loads in flight
// while it computes. kRanks == 0: R = ranks at run time, one row per warp.
// avg_mode 0 sums; 1 multiplies the sum by avg_arg = 1/R (R a power of two);
// 2 divides it by avg_arg = R.
template <int kRanks>
__global__ void __launch_bounds__(kReduceThreads)
reduce_rows_int8_kernel(const signed char* __restrict__ q,
                        const float* __restrict__ scales, int ranks,
                        long long rows, int avg_mode, float avg_arg,
                        signed char* __restrict__ q_out,
                        float* __restrict__ s_out) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kReduceRows;
  long long row = (long long)blockIdx.x * kReduceRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long col = (long long)lane * 16;
  const bool vector = ((reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(q_out)) & 15) == 0;
  if constexpr (kRanks > 0) {
    int4 b[kRanks];
    float s[kRanks];
    load_row<kRanks>(q, scales, rows, row, col, vector, b, s);
    for (;;) {
      float acc[16];
      add_rank<true>(acc, b[0], s[0]);
#pragma unroll
      for (int r = 1; r < kRanks; ++r) add_rank<false>(acc, b[r], s[r]);
      const long long next = row + stride;
      if (next < rows) load_row<kRanks>(q, scales, rows, next, col, vector, b, s);
      finish_row(acc, avg_mode, avg_arg, row, lane, col, vector, q_out, s_out);
      if (next >= rows) break;
      row = next;
    }
  } else {
    for (; row < rows; row += stride) {
      float acc[16];
      add_rank<true>(acc, load16(q + row * kBlock + col, vector), scales[row]);
#pragma unroll 4
      for (int r = 1; r < ranks; ++r)
        add_rank<false>(acc, load16(q + (r * rows + row) * kBlock + col, vector),
                        scales[r * rows + row]);
      finish_row(acc, avg_mode, avg_arg, row, lane, col, vector, q_out, s_out);
    }
  }
}

// Waves of resident blocks the fixed-R grid is capped at.
constexpr int kWaves = 2;

template <int kRanks>
void launch_reduce(const void* q, const void* scales, int ranks,
                   long long rows, int avg_mode, float avg_arg, void* q_out,
                   void* s_out, cudaStream_t stream) {
  long long grid = (rows + kReduceRows - 1) / kReduceRows;
  if constexpr (kRanks > 0) {
    // Resident blocks of this instantiation on the current card, asked once
    // per process (a cap only: any grid computes the same bytes).
    static const long long cap = [] {
      int dev = 0, sms = 0, per_sm = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, reduce_rows_int8_kernel<kRanks>, kReduceThreads, 0);
      return (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1) * kWaves;
    }();
    grid = grid < cap ? grid : cap;
  }
  reduce_rows_int8_kernel<kRanks><<<(unsigned)grid, kReduceThreads, 0, stream>>>(
      (const signed char*)q, (const float*)scales, ranks, rows, avg_mode,
      avg_arg, (signed char*)q_out, (float*)s_out);
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
  // The average's operand, made here so the kernel converts no integer.
  const bool pow2 = (ranks & (ranks - 1)) == 0;
  const int avg_mode = avg == 0 ? 0 : (pow2 ? 1 : 2);
  const float avg_arg = pow2 ? 1.0f / (float)ranks : (float)ranks;
  using Launch = void (*)(const void*, const void*, int, long long, int, float,
                          void*, void*, cudaStream_t);
  constexpr Launch kLaunch[kMaxFixedRanks + 1] = {
      launch_reduce<0>, launch_reduce<1>, launch_reduce<2>,
      launch_reduce<3>, launch_reduce<4>, launch_reduce<5>,
      launch_reduce<6>, launch_reduce<7>, launch_reduce<8>};
  kLaunch[ranks <= kMaxFixedRanks ? ranks : 0](
      q, scales, (int)ranks, rows, avg_mode, avg_arg, q_out, s_out,
      (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
