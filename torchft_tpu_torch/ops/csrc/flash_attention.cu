// GQA flash attention for Hopper (sm_90a): forward, backward dq and backward
// dk/dv, over a whole causal sequence and over one offset block of a ring,
// bound to Python through a plain C interface (ctypes).
//
// Replaces the six Pallas TPU kernels of torchft_tpu/ops/flash_attention.py:
//   tft_flash_fwd           <- _flash_kernel               (online softmax)
//   tft_flash_bwd_dq        <- _flash_bwd_dq_kernel        (P from lse)
//   tft_flash_bwd_dkv       <- _flash_bwd_dkv_kernel       (GQA group summed)
//   tft_flash_block_fwd     <- _flash_block_fwd_kernel
//   tft_flash_block_bwd_dq  <- _flash_block_bwd_dq_kernel
//   tft_flash_block_bwd_dkv <- _flash_block_bwd_dkv_kernel
// A block kernel is the same body with q [B, Sq, ...] against k/v
// [B, Skv, ...], the causal mask taken at global positions (q row i is at
// q_off + i, k row j at k_off + j; the key is visible iff
// q_off + i >= k_off + j) and, in the backward, the lse cotangent dlse folded
// into dS, since the ring merge differentiates through lse. The whole-sequence
// kernels are the case q_off = k_off = 0, Sq = Skv, no dlse; each entry point
// is its own launch.
//
// What each computes is the TPU kernel's function, not its block structure:
//   s = (q . k) * scale in fp32, masked to -1e30 where the key is not visible;
//   forward: online softmax over kv tiles, out = sum_j p_ij v_j / l_i with p
//     rounded to the input dtype before the P.V product (as the TPU kernel's
//     p.astype(v.dtype)), lse_i = m_i + log(l_i) in fp32;
//   backward: p = exp(s - lse), dS = p * (dO.V^T - delta [+ dlse]), with
//     delta = rowsum(dO * O) computed by the caller; dq = dS.K * scale,
//     dk = dS^T.Q * scale, dv = P^T.dO, dS and P rounded to the input dtype
//     before their products, every sum accumulated in fp32.
//
// Layout: q/out/dq/dO are [B, S, Hq, D] and k/v/dk/dv [B, S, Hkv, D], read
// and written through their (batch, seq, head) strides with D contiguous, so
// the model's layout needs no transpose. lse, delta and dlse are fp32
// [B, Hq, Sq].
// q head h reads kv head h / (Hq / Hkv).
//
// What bounds it on the H100, and what the design does about it. At the
// training shapes (S = 1024, D = 64) each (q tile, kv tile) pair does
// 2 * 64 * 64 * D flops per product on 64 * D inputs, far above the card's
// ~295 flop/byte ridge, so the kernels are bound by arithmetic, not by HBM.
// This first version computes the products with fp32 FMAs on the CUDA cores
// (67 TFLOP/s peak) instead of the tensor cores (989 TFLOP/s in bf16): it is
// the simple, exact-to-the-reference form, and moving the two products onto
// mma/wgmma is later work. Within that, the design keeps the FMA units fed:
//   - One thread block of 256 threads per (q tile of 64 rows, head, batch)
//     (per kv tile of 64 rows for dk/dv). A loop inside the block walks the
//     kv tiles the mask keeps (the q tiles, for dk/dv; at zero offsets, up to
//     and from the diagonal): this
//     loop replaces the TPU's sequential grid axis, whose VMEM scratch carries
//     the running max/sum/accumulator between grid steps. Nothing carries
//     between CUDA blocks; here the running state lives in registers.
//   - Tiles are staged in shared memory as fp32. Operands of the S-shaped
//     products are stored transposed ([D][64]) so that each thread reads four
//     rows or columns with one 16-byte load per d; each thread owns a 4x4
//     block of the 64x64 score tile (16 FMAs per pair of loads).
//   - A (q tile, kv tile) pair whose keys all lie after all its queries is
//     never visited: the TPU block kernel's skip predicate
//     k0 + k_off <= q0 + q_off + 63, at 64-row tiles. The tiles a q tile
//     visits are a prefix of the kv tiles, and the q tiles that visit a kv
//     tile a suffix, so the loops only run over those. Elements are masked
//     in the visited tiles only (at zero offsets: the diagonal tile).
//   - A row of a block whose tiles were all skipped (a k/v block wholly in
//     the q shard's future) writes out 0 and lse = -1e30 + log(1e-30), which
//     is -1e30 in fp32, never NaN or -inf: the ring merge weighs it to 0.
//     A row that sees no key inside a visited tile gets P = exp(0) = 1 there,
//     as the TPU kernel does; only offsets that are not multiples of the
//     shard make such rows, and the ring never does.
//   - dk/dv loop over the q_per_kv heads of the GQA group and their q tiles
//     inside one block, so each kv row's gradient is summed by one thread in
//     a fixed order: no atomics, the result is the same run to run.
//   - Masked scores are -1e30, not -inf, so exp(m_prev - m_new) is never NaN.
//   - Shared memory above 48 KB is opted into with cudaFuncSetAttribute
//     (dk/dv at D = 128 uses 230,144 of the 232,448 bytes a block may have).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // rows of a q tile and of a kv tile
constexpr int kThreads = 256;  // 16 x 16 threads, each owning 4 x 4 scores
constexpr float kNegInf = -1e30f;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ void load4(const float* p, float* o) {
    float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                               float* o) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float2 a = __bfloat1622float2(h[0]);
    float2 b = __bfloat1622float2(h[1]);
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
  // Round to the input dtype and back (round to nearest even), as the TPU
  // kernel's astype(bf16) before a product.
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

struct Strides {
  long long b, s, h;  // in elements; the last (D) dim is contiguous
};

// Tile of 64 rows x D from global memory into shared memory, transposed:
// dst[d * 64 + r]. Consecutive threads take consecutive rows (four values of
// d each), so the shared-memory writes do not conflict. Rows at or past S
// are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile_t(float* dst, const T* base,
                                            long long row_stride, int row0,
                                            int S) {
  constexpr int kChunks = D / 4;
  for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
    const int r = e % kTile;
    const int c = e / kTile;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < S) {
      Elem<T>::load4(base + (long long)(row0 + r) * row_stride + c * 4, v);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[(c * 4 + i) * kTile + r] = v[i];
  }
}

// Tile of 64 rows x D into shared memory, row-major: dst[r * D + d].
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long row_stride, int row0,
                                          int S) {
  constexpr int kChunks = D / 4;
  for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = e % kChunks;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < S) {
      Elem<T>::load4(base + (long long)(row0 + r) * row_stride + c * 4, v);
    }
    *reinterpret_cast<float4*>(dst + r * D + c * 4) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// acc[i][j] += sum_d a[d][ra + i] * b[d][cb + j] over transposed tiles.
template <int D>
__device__ __forceinline__ void mm_tt(float (&acc)[4][4], const float* a,
                                      int ra, const float* b, int cb) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(a + d * kTile + ra);
    const float4 y = *reinterpret_cast<const float4*>(b + d * kTile + cb);
    const float xa[4] = {x.x, x.y, x.z, x.w};
    const float ya[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], ya[j], acc[i][j]);
  }
}

// acc[i][jd] += sum_n p[n][r + i] * v[n][c0 + jd]: a [64][64] tile whose
// rows are the contraction index, times a row-major [64][D] tile.
template <int D>
__device__ __forceinline__ void mm_pv(float (&acc)[4][D / 16], const float* p,
                                      int r, const float* v, int c0) {
  constexpr int DC = D / 16;
#pragma unroll 4
  for (int n = 0; n < kTile; ++n) {
    const float4 x = *reinterpret_cast<const float4*>(p + n * kTile + r);
    const float xa[4] = {x.x, x.y, x.z, x.w};
    float va[DC];
    if constexpr (DC % 4 == 0) {
#pragma unroll
      for (int jd = 0; jd < DC; jd += 4) {
        const float4 y =
            *reinterpret_cast<const float4*>(v + n * D + c0 + jd);
        va[jd] = y.x; va[jd + 1] = y.y; va[jd + 2] = y.z; va[jd + 3] = y.w;
      }
    } else {
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) va[jd] = v[n * D + c0 + jd];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jd = 0; jd < DC; ++jd)
        acc[i][jd] = fmaf(xa[i], va[jd], acc[i][jd]);
  }
}

// Writes x[i][j] (rows r + i, columns c + j of a 64x64 tile) transposed,
// dst[(c + j) * 64 + r + i], rounded to the input dtype, one 16-byte store
// per column.
template <typename T>
__device__ __forceinline__ void store_t(float* dst, const float (&x)[4][4],
                                        int r, int c) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(dst + (c + j) * kTile + r) =
        make_float4(Elem<T>::round(x[0][j]), Elem<T>::round(x[1][j]),
                    Elem<T>::round(x[2][j]), Elem<T>::round(x[3][j]));
}

// Reduction over the 16 threads that share a row group (lanes differing in
// their low four bits).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Which keys a query sees. The whole-sequence kernels pass q_off = k_off = 0
// and Sq = Skv; the block kernels the ring's global offsets.
struct Mask {
  int Sq, Skv;       // rows of q and of k/v
  int q_off, k_off;  // global positions of q row 0 and of k row 0
  int causal;
};

// Key `col` is hidden from query `row` (or either lies past its tensor).
__device__ __forceinline__ bool hidden(const Mask& m, int row, int col) {
  return row >= m.Sq || col >= m.Skv ||
         (m.causal && col + m.k_off > row + m.q_off);
}

// The kv tiles the q tile at row q0 visits are 0 .. end-1: kv tile kt runs
// iff kt * 64 + k_off <= q0 + q_off + 63.
__device__ __forceinline__ int kv_tiles_end(const Mask& m, int q0) {
  const int n_kv = (m.Skv + kTile - 1) / kTile;
  if (!m.causal) return n_kv;
  const long long last = (long long)q0 + m.q_off + kTile - 1 - m.k_off;
  if (last < 0) return 0;
  return (int)min((long long)n_kv, last / kTile + 1);
}

// The q tiles that visit the kv tile at row k0 are begin .. n_q-1: q tile qt
// runs iff qt * 64 >= k0 + k_off - q_off - 63.
__device__ __forceinline__ int q_tiles_begin(const Mask& m, int k0) {
  if (!m.causal) return 0;
  const long long first = (long long)k0 + m.k_off - m.q_off - (kTile - 1);
  if (first <= 0) return 0;
  return (int)min((long long)(m.Sq + kTile - 1) / kTile,
                  (first + kTile - 1) / kTile);
}

// ---------------------------------------------------------------------------
// Forward. Grid (q tiles, Hq, B). Shared: Qt [D][64], Kt [D][64],
// V [64][D], Pt [64][64] (P transposed: kv index major).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Mask m, int Hq, int q_per_kv,
                 Strides qs, Strides ks, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* Kt = Qt + D * kTile;
  float* Vs = Kt + D * kTile;
  float* Pt = Vs + kTile * D;
  constexpr int DC = D / 16;

  // Heaviest (latest) q tiles first, so the causal tail is short.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / q_per_kv;
  const int q0 = qt * kTile;
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * ks.b + hk * ks.h;
  load_tile_t<T, D>(Qt, qb, qs.s, q0, m.Sq);

  float m_i[4], l_i[4], o[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DC; ++jd) o[i][jd] = 0.f;
  }

  const int kv_end = kv_tiles_end(m, q0);
  for (int kt = 0; kt < kv_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // previous tile's readers are done
    load_tile_t<T, D>(Kt, kb, ks.s, k0, m.Skv);
    load_tile<T, D>(Vs, vb, ks.s, k0, m.Skv);
    __syncthreads();

    float s[4][4] = {};
    mm_tt<D>(s, Qt, tr * 4, Kt, tc * 4);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tc * 4 + j;
        float x = s[i][j] * scale;
        // Rows past Sq are never written, so only the key side is checked.
        if (col >= m.Skv || (m.causal && col + m.k_off > row + m.q_off))
          x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = group_max(mx);
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = __expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = __expf(s[i][j] - m_new);  // p, unrounded for the sum
        rs += s[i][j];
      }
      rs = group_sum(rs);
      l_i[i] = alpha * l_i[i] + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) o[i][jd] *= alpha;
    }
    store_t<T>(Pt, s, tr * 4, tc * 4);
    __syncthreads();
    mm_pv<D>(o, Pt, tr * 4, Vs, tc * DC);
  }

  // A row with no visited tile keeps l = 0 and m = -1e30: out 0 and
  // lse = -1e30 + log(1e-30), which is -1e30 in fp32.
  T* ob = out + b * qs.b + h * qs.h;
  float* lb = lse + ((long long)b * Hq + h) * m.Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= m.Sq) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
    const float inv = 1.f / denom;
#pragma unroll
    for (int jd = 0; jd < DC; ++jd)
      Elem<T>::store(ob + (long long)row * qs.s + tc * DC + jd,
                     o[i][jd] * inv);
    if (tc == 0) lb[row] = m_i[i] + __logf(denom);
  }
}

// ---------------------------------------------------------------------------
// Backward dq. Grid (q tiles, Hq, B). Shared: Qt, dOt, Kt, Vt [D][64],
// K [64][D], dSt [64][64]. dlse is null for the whole-sequence kernel.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ dlse, T* __restrict__ dq,
                    Mask m, int Hq, int q_per_kv, Strides qs, Strides ks,
                    float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* dOt = Qt + D * kTile;
  float* Kt = dOt + D * kTile;
  float* Vt = Kt + D * kTile;
  float* Ks = Vt + D * kTile;
  float* dSt = Ks + kTile * D;
  constexpr int DC = D / 16;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / q_per_kv;
  const int q0 = qt * kTile;
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;

  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * ks.b + hk * ks.h;
  load_tile_t<T, D>(Qt, q + b * qs.b + h * qs.h, qs.s, q0, m.Sq);
  load_tile_t<T, D>(dOt, dout + b * qs.b + h * qs.h, qs.s, q0, m.Sq);

  const long long row0 = ((long long)b * Hq + h) * m.Sq;
  float lse_i[4], delta_i[4], dlse_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    const bool in = row < m.Sq;
    lse_i[i] = in ? lse[row0 + row] : 0.f;
    delta_i[i] = in ? delta[row0 + row] : 0.f;
    dlse_i[i] = in && dlse != nullptr ? dlse[row0 + row] : 0.f;
#pragma unroll
    for (int jd = 0; jd < DC; ++jd) acc[i][jd] = 0.f;
  }

  const int kv_end = kv_tiles_end(m, q0);
  for (int kt = 0; kt < kv_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile_t<T, D>(Kt, kb, ks.s, k0, m.Skv);
    load_tile_t<T, D>(Vt, vb, ks.s, k0, m.Skv);
    load_tile<T, D>(Ks, kb, ks.s, k0, m.Skv);
    __syncthreads();

    float s[4][4] = {};
    float dp[4][4] = {};
    mm_tt<D>(s, Qt, tr * 4, Kt, tc * 4);
    mm_tt<D>(dp, dOt, tr * 4, Vt, tc * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tc * 4 + j;
        const float p =
            hidden(m, row, col) ? 0.f : __expf(s[i][j] * scale - lse_i[i]);
        float dsum = dp[i][j] - delta_i[i];
        if (dlse != nullptr) dsum += dlse_i[i];  // the TPU kernel's order
        s[i][j] = p * dsum;                      // dS
      }
    }
    store_t<T>(dSt, s, tr * 4, tc * 4);
    __syncthreads();
    mm_pv<D>(acc, dSt, tr * 4, Ks, tc * DC);
  }

  T* qb = dq + b * qs.b + h * qs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= m.Sq) continue;
#pragma unroll
    for (int jd = 0; jd < DC; ++jd)
      Elem<T>::store(qb + (long long)row * qs.s + tc * DC + jd,
                     acc[i][jd] * scale);
  }
}

// ---------------------------------------------------------------------------
// Backward dk/dv. Grid (kv tiles, Hkv, B). Shared: Kt, Vt, Qt, dOt [D][64],
// Q, dO [64][D], P, dS [64 q][64 kv], lse, delta and dlse of the q tile [64].
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ dlse, T* __restrict__ dk,
                     T* __restrict__ dv, Mask m, int Hq, int q_per_kv,
                     Strides qs, Strides ks, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;
  float* Vt = Kt + D * kTile;
  float* Qt = Vt + D * kTile;
  float* dOt = Qt + D * kTile;
  float* Qs = dOt + D * kTile;
  float* dOs = Qs + kTile * D;
  float* Ps = dOs + kTile * D;
  float* dSs = Ps + kTile * kTile;
  float* lse_s = dSs + kTile * kTile;
  float* delta_s = lse_s + kTile;
  float* dlse_s = delta_s + kTile;
  constexpr int DC = D / 16;

  const int kt = gridDim.x - 1 - blockIdx.x;  // early kv tiles do most work
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * kTile;
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;

  load_tile_t<T, D>(Kt, k + b * ks.b + hk * ks.h, ks.s, k0, m.Skv);
  load_tile_t<T, D>(Vt, v + b * ks.b + hk * ks.h, ks.s, k0, m.Skv);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jd = 0; jd < DC; ++jd) {
      dk_acc[i][jd] = 0.f;
      dv_acc[i][jd] = 0.f;
    }

  const int n_q = (m.Sq + kTile - 1) / kTile;
  const int q_begin = q_tiles_begin(m, k0);
  for (int g = 0; g < q_per_kv; ++g) {
    const int h = hk * q_per_kv + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* ob = dout + b * qs.b + h * qs.h;
    const long long row0 = ((long long)b * Hq + h) * m.Sq;
    for (int qt = q_begin; qt < n_q; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_tile_t<T, D>(Qt, qb, qs.s, q0, m.Sq);
      load_tile_t<T, D>(dOt, ob, qs.s, q0, m.Sq);
      load_tile<T, D>(Qs, qb, qs.s, q0, m.Sq);
      load_tile<T, D>(dOs, ob, qs.s, q0, m.Sq);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        const bool in = row < m.Sq;
        lse_s[threadIdx.x] = in ? lse[row0 + row] : 0.f;
        delta_s[threadIdx.x] = in ? delta[row0 + row] : 0.f;
        dlse_s[threadIdx.x] = in && dlse != nullptr ? dlse[row0 + row] : 0.f;
      }
      __syncthreads();

      // Transposed scores: st[i][j] = s(q row tc*4+j, kv row tr*4+i).
      float st[4][4] = {};
      float dpt[4][4] = {};
      mm_tt<D>(st, Kt, tr * 4, Qt, tc * 4);
      mm_tt<D>(dpt, Vt, tr * 4, dOt, tc * 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = tc * 4 + j;
        const int row = q0 + qi;
        const float l = lse_s[qi];
        const float dl = delta_s[qi];
        const float dll = dlse_s[qi];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = k0 + tr * 4 + i;
          const float p =
              hidden(m, row, col) ? 0.f : __expf(st[i][j] * scale - l);
          float dsum = dpt[i][j] - dl;
          if (dlse != nullptr) dsum += dll;
          dpt[i][j] = p * dsum;  // dS^T
          st[i][j] = p;          // P^T
        }
      }
      store_t<T>(Ps, st, tr * 4, tc * 4);
      store_t<T>(dSs, dpt, tr * 4, tc * 4);
      __syncthreads();
      mm_pv<D>(dv_acc, Ps, tr * 4, dOs, tc * DC);
      mm_pv<D>(dk_acc, dSs, tr * 4, Qs, tc * DC);
    }
  }

  T* kb = dk + b * ks.b + hk * ks.h;
  T* vb = dv + b * ks.b + hk * ks.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + tr * 4 + i;
    if (row >= m.Skv) continue;
#pragma unroll
    for (int jd = 0; jd < DC; ++jd) {
      Elem<T>::store(kb + (long long)row * ks.s + tc * DC + jd,
                     dk_acc[i][jd] * scale);
      Elem<T>::store(vb + (long long)row * ks.s + tc * DC + jd,
                     dv_acc[i][jd]);
    }
  }
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * D * kTile + kTile * kTile);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (5 * D * kTile + kTile * kTile);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (6 * D * kTile + 2 * kTile * kTile + 3 * kTile);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// One launch's sizes, strides and mask.
struct Problem {
  int B, Hq, Hkv;
  Strides qs, ks;
  Mask m;
  float scale;
};

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, Problem p, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, fwd_smem<D>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.m.Sq + kTile - 1) / kTile, p.Hq, p.B);
  kernel<<<grid, kThreads, fwd_smem<D>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, p.m, p.Hq,
      p.Hq / p.Hkv, p.qs, p.ks, p.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const float* dlse,
              void* dq, Problem p, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, dq_smem<D>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.m.Sq + kTile - 1) / kTile, p.Hq, p.B);
  kernel<<<grid, kThreads, dq_smem<D>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      dlse, (T*)dq, p.m, p.Hq, p.Hq / p.Hkv, p.qs, p.ks, p.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const float* dlse,
               void* dk, void* dv, Problem p, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, dkv_smem<D>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.m.Skv + kTile - 1) / kTile, p.Hkv, p.B);
  kernel<<<grid, kThreads, dkv_smem<D>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      dlse, (T*)dk, (T*)dv, p.m, p.Hq, p.Hq / p.Hkv, p.qs, p.ks, p.scale);
  return (int)cudaGetLastError();
}

// Returned for a head_dim or dtype code the library was not built for.
constexpr int kUnsupported = -1;

Problem make_problem(int B, int Sq, int Skv, int Hq, int Hkv, long long qsb,
                     long long qss, long long qsh, long long ksb,
                     long long kss, long long ksh, int q_off, int k_off,
                     int causal, float scale) {
  Problem p;
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.qs = Strides{qsb, qss, qsh};
  p.ks = Strides{ksb, kss, ksh};
  p.m = Mask{Sq, Skv, q_off, k_off, causal};
  p.scale = scale;
  return p;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. head_dim in {16, 32, 64, 128}.
#define TFT_DISPATCH(FN, ...)                                        \
  {                                                                  \
    if (dtype == 0) {                                                \
      switch (D) {                                                   \
        case 16: return FN<float, 16>(__VA_ARGS__);                  \
        case 32: return FN<float, 32>(__VA_ARGS__);                  \
        case 64: return FN<float, 64>(__VA_ARGS__);                  \
        case 128: return FN<float, 128>(__VA_ARGS__);                \
      }                                                              \
    } else if (dtype == 1) {                                         \
      switch (D) {                                                   \
        case 16: return FN<__nv_bfloat16, 16>(__VA_ARGS__);          \
        case 32: return FN<__nv_bfloat16, 32>(__VA_ARGS__);          \
        case 64: return FN<__nv_bfloat16, 64>(__VA_ARGS__);          \
        case 128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);        \
      }                                                              \
    }                                                                \
    return kUnsupported;                                             \
  }

extern "C" {

// Whole-sequence kernels: q [B, S, Hq, D], k/v [B, S, Hkv, D], causal or not.

int tft_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  void* lse, int B, int S, int Hq, int Hkv, int D,
                  long long qsb, long long qss, long long qsh, long long ksb,
                  long long kss, long long ksh, int causal, int dtype,
                  float scale, void* stream) {
  const Problem p = make_problem(B, S, S, Hq, Hkv, qsb, qss, qsh, ksb, kss,
                                 ksh, 0, 0, causal, scale);
  TFT_DISPATCH(launch_fwd, q, k, v, out, (float*)lse, p, (cudaStream_t)stream);
}

int tft_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int S, int Hq, int Hkv, int D,
                     long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh, int causal,
                     int dtype, float scale, void* stream) {
  const Problem p = make_problem(B, S, S, Hq, Hkv, qsb, qss, qsh, ksb, kss,
                                 ksh, 0, 0, causal, scale);
  TFT_DISPATCH(launch_dq, q, k, v, dout, (const float*)lse,
               (const float*)delta, nullptr, dq, p, (cudaStream_t)stream);
}

int tft_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int S, int Hq, int Hkv,
                      int D, long long qsb, long long qss, long long qsh,
                      long long ksb, long long kss, long long ksh, int causal,
                      int dtype, float scale, void* stream) {
  const Problem p = make_problem(B, S, S, Hq, Hkv, qsb, qss, qsh, ksb, kss,
                                 ksh, 0, 0, causal, scale);
  TFT_DISPATCH(launch_dkv, q, k, v, dout, (const float*)lse,
               (const float*)delta, nullptr, dk, dv, p, (cudaStream_t)stream);
}

// Block kernels: q [B, Sq, Hq, D] against k/v [B, Skv, Hkv, D], causal at
// global positions q_off + i >= k_off + j; the backward folds dlse [B, Hq, Sq]
// into dS.

int tft_flash_block_fwd(const void* q, const void* k, const void* v,
                        void* out, void* lse, int B, int Sq, int Skv, int Hq,
                        int Hkv, int D, long long qsb, long long qss,
                        long long qsh, long long ksb, long long kss,
                        long long ksh, int q_off, int k_off, int dtype,
                        float scale, void* stream) {
  const Problem p = make_problem(B, Sq, Skv, Hq, Hkv, qsb, qss, qsh, ksb,
                                 kss, ksh, q_off, k_off, 1, scale);
  TFT_DISPATCH(launch_fwd, q, k, v, out, (float*)lse, p, (cudaStream_t)stream);
}

int tft_flash_block_bwd_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, const void* dlse, void* dq,
                           int B, int Sq, int Skv, int Hq, int Hkv, int D,
                           long long qsb, long long qss, long long qsh,
                           long long ksb, long long kss, long long ksh,
                           int q_off, int k_off, int dtype, float scale,
                           void* stream) {
  const Problem p = make_problem(B, Sq, Skv, Hq, Hkv, qsb, qss, qsh, ksb,
                                 kss, ksh, q_off, k_off, 1, scale);
  TFT_DISPATCH(launch_dq, q, k, v, dout, (const float*)lse,
               (const float*)delta, (const float*)dlse, dq, p,
               (cudaStream_t)stream);
}

int tft_flash_block_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* dlse, void* dk,
                            void* dv, int B, int Sq, int Skv, int Hq,
                            int Hkv, int D, long long qsb, long long qss,
                            long long qsh, long long ksb, long long kss,
                            long long ksh, int q_off, int k_off, int dtype,
                            float scale, void* stream) {
  const Problem p = make_problem(B, Sq, Skv, Hq, Hkv, qsb, qss, qsh, ksb,
                                 kss, ksh, q_off, k_off, 1, scale);
  TFT_DISPATCH(launch_dkv, q, k, v, dout, (const float*)lse,
               (const float*)delta, (const float*)dlse, dk, dv, p,
               (cudaStream_t)stream);
}

}  // extern "C"
