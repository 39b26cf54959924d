// Causal GQA flash attention for Hopper (sm_90a): forward, backward dq and
// backward dk/dv, bound to Python through a plain C interface (ctypes).
//
// Replaces the three Pallas TPU kernels of torchft_tpu/ops/flash_attention.py:
//   tft_flash_fwd     <- _flash_kernel          (forward, online softmax)
//   tft_flash_bwd_dq  <- _flash_bwd_dq_kernel   (dq, P recomputed from lse)
//   tft_flash_bwd_dkv <- _flash_bwd_dkv_kernel  (dk/dv over the GQA group)
//
// What each computes is the TPU kernel's function, not its block structure:
//   s = (q . k) * scale in fp32, masked to -1e30 above the causal diagonal;
//   forward: online softmax over kv tiles, out = sum_j p_ij v_j / l_i with p
//     rounded to the input dtype before the P.V product (as the TPU kernel's
//     p.astype(v.dtype)), lse_i = m_i + log(l_i) in fp32;
//   backward: p = exp(s - lse), dS = p * (dO.V^T - delta), with delta =
//     rowsum(dO * O) computed by the caller; dq = dS.K * scale,
//     dk = dS^T.Q * scale, dv = P^T.dO, dS and P rounded to the input dtype
//     before their products, every sum accumulated in fp32.
//
// Layout: q/out/dq/dO are [B, S, Hq, D] and k/v/dk/dv [B, S, Hkv, D], read
// and written through their (batch, seq, head) strides with D contiguous, so
// the model's layout needs no transpose. lse and delta are fp32 [B, Hq, S].
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
//     kv tiles up to the diagonal (q tiles from the diagonal for dk/dv): this
//     loop replaces the TPU's sequential grid axis, whose VMEM scratch carries
//     the running max/sum/accumulator between grid steps. Nothing carries
//     between CUDA blocks; here the running state lives in registers.
//   - Tiles are staged in shared memory as fp32. Operands of the S-shaped
//     products are stored transposed ([D][64]) so that each thread reads four
//     rows or columns with one 16-byte load per d; each thread owns a 4x4
//     block of the 64x64 score tile (16 FMAs per pair of loads).
//   - Tiles strictly above the causal diagonal are never visited; only the
//     diagonal tile is masked. q and kv tiles have the same size (64), so the
//     diagonal is always one tile.
//   - dk/dv loop over the q_per_kv heads of the GQA group and their q tiles
//     inside one block, so each kv row's gradient is summed by one thread in
//     a fixed order: no atomics, the result is the same run to run.
//   - Masked scores are -1e30, not -inf, so exp(m_prev - m_new) is never NaN.
//   - Shared memory above 48 KB is opted into with cudaFuncSetAttribute
//     (dk/dv at D = 128 uses 229,888 of the 232,448 bytes a block may have).

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

// ---------------------------------------------------------------------------
// Forward. Grid (q tiles, Hq, B). Shared: Qt [D][64], Kt [D][64],
// V [64][D], Pt [64][64] (P transposed: kv index major).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int Hq, int q_per_kv,
                 Strides qs, Strides ks, int causal, float scale) {
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
  load_tile_t<T, D>(Qt, qb, qs.s, q0, S);

  float m_i[4], l_i[4], o[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DC; ++jd) o[i][jd] = 0.f;
  }

  const int n_kv = (S + kTile - 1) / kTile;
  const int kv_end = causal ? min(qt + 1, n_kv) : n_kv;
  for (int kt = 0; kt < kv_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // previous tile's readers are done
    load_tile_t<T, D>(Kt, kb, ks.s, k0, S);
    load_tile<T, D>(Vs, vb, ks.s, k0, S);
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
        if (col >= S || (causal && col > row)) x = kNegInf;
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

  T* ob = out + b * qs.b + h * qs.h;
  float* lb = lse + ((long long)b * Hq + h) * S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= S) continue;
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
// K [64][D], dSt [64][64].
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int Hq, int q_per_kv, Strides qs, Strides ks,
                    int causal, float scale) {
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
  load_tile_t<T, D>(Qt, q + b * qs.b + h * qs.h, qs.s, q0, S);
  load_tile_t<T, D>(dOt, dout + b * qs.b + h * qs.h, qs.s, q0, S);

  const float* lb = lse + ((long long)b * Hq + h) * S;
  const float* db = delta + ((long long)b * Hq + h) * S;
  float lse_i[4], delta_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    lse_i[i] = row < S ? lb[row] : 0.f;
    delta_i[i] = row < S ? db[row] : 0.f;
#pragma unroll
    for (int jd = 0; jd < DC; ++jd) acc[i][jd] = 0.f;
  }

  const int n_kv = (S + kTile - 1) / kTile;
  const int kv_end = causal ? min(qt + 1, n_kv) : n_kv;
  for (int kt = 0; kt < kv_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile_t<T, D>(Kt, kb, ks.s, k0, S);
    load_tile_t<T, D>(Vt, vb, ks.s, k0, S);
    load_tile<T, D>(Ks, kb, ks.s, k0, S);
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
        const bool masked = row >= S || col >= S || (causal && col > row);
        const float p = masked ? 0.f : __expf(s[i][j] * scale - lse_i[i]);
        s[i][j] = p * (dp[i][j] - delta_i[i]);  // dS
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
    if (row >= S) continue;
#pragma unroll
    for (int jd = 0; jd < DC; ++jd)
      Elem<T>::store(qb + (long long)row * qs.s + tc * DC + jd,
                     acc[i][jd] * scale);
  }
}

// ---------------------------------------------------------------------------
// Backward dk/dv. Grid (kv tiles, Hkv, B). Shared: Kt, Vt, Qt, dOt [D][64],
// Q, dO [64][D], P, dS [64 q][64 kv], lse and delta of the q tile [64].
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int Hq, int q_per_kv,
                     Strides qs, Strides ks, int causal, float scale) {
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
  constexpr int DC = D / 16;

  const int kt = gridDim.x - 1 - blockIdx.x;  // early kv tiles do most work
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * kTile;
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;

  load_tile_t<T, D>(Kt, k + b * ks.b + hk * ks.h, ks.s, k0, S);
  load_tile_t<T, D>(Vt, v + b * ks.b + hk * ks.h, ks.s, k0, S);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jd = 0; jd < DC; ++jd) {
      dk_acc[i][jd] = 0.f;
      dv_acc[i][jd] = 0.f;
    }

  const int n_q = (S + kTile - 1) / kTile;
  const int q_begin = causal ? kt : 0;
  for (int g = 0; g < q_per_kv; ++g) {
    const int h = hk * q_per_kv + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* ob = dout + b * qs.b + h * qs.h;
    const float* lb = lse + ((long long)b * Hq + h) * S;
    const float* db = delta + ((long long)b * Hq + h) * S;
    for (int qt = q_begin; qt < n_q; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_tile_t<T, D>(Qt, qb, qs.s, q0, S);
      load_tile_t<T, D>(dOt, ob, qs.s, q0, S);
      load_tile<T, D>(Qs, qb, qs.s, q0, S);
      load_tile<T, D>(dOs, ob, qs.s, q0, S);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < S ? lb[row] : 0.f;
        delta_s[threadIdx.x] = row < S ? db[row] : 0.f;
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
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = k0 + tr * 4 + i;
          const bool masked = row >= S || col >= S || (causal && col > row);
          const float p = masked ? 0.f : __expf(st[i][j] * scale - l);
          dpt[i][j] = p * (dpt[i][j] - dl);  // dS^T
          st[i][j] = p;                      // P^T
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
    if (row >= S) continue;
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
  return sizeof(float) * (6 * D * kTile + 2 * kTile * kTile + 2 * kTile);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int S, int Hq, int Hkv, Strides qs,
               Strides ks, int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, fwd_smem<D>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, Hq, B);
  kernel<<<grid, kThreads, fwd_smem<D>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, S, Hq, Hq / Hkv,
      qs, ks, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int S,
              int Hq, int Hkv, Strides qs, Strides ks, int causal,
              float scale, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, dq_smem<D>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, Hq, B);
  kernel<<<grid, kThreads, dq_smem<D>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, S, Hq, Hq / Hkv, qs, ks, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int S, int Hq, int Hkv, Strides qs, Strides ks,
               int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, dkv_smem<D>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, Hkv, B);
  kernel<<<grid, kThreads, dkv_smem<D>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, S, Hq, Hq / Hkv, qs, ks, causal, scale);
  return (int)cudaGetLastError();
}

// Returned for a head_dim or dtype code the library was not built for.
constexpr int kUnsupported = -1;

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

int tft_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  void* lse, int B, int S, int Hq, int Hkv, int D,
                  long long qsb, long long qss, long long qsh, long long ksb,
                  long long kss, long long ksh, int causal, int dtype,
                  float scale, void* stream) {
  const Strides qs{qsb, qss, qsh};
  const Strides ks{ksb, kss, ksh};
  TFT_DISPATCH(launch_fwd, q, k, v, out, (float*)lse, B, S, Hq, Hkv, qs, ks,
               causal, scale, (cudaStream_t)stream);
}

int tft_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int S, int Hq, int Hkv, int D,
                     long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh, int causal,
                     int dtype, float scale, void* stream) {
  const Strides qs{qsb, qss, qsh};
  const Strides ks{ksb, kss, ksh};
  TFT_DISPATCH(launch_dq, q, k, v, dout, (const float*)lse,
               (const float*)delta, dq, B, S, Hq, Hkv, qs, ks, causal, scale,
               (cudaStream_t)stream);
}

int tft_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int S, int Hq, int Hkv,
                      int D, long long qsb, long long qss, long long qsh,
                      long long ksb, long long kss, long long ksh, int causal,
                      int dtype, float scale, void* stream) {
  const Strides qs{qsb, qss, qsh};
  const Strides ks{ksb, kss, ksh};
  TFT_DISPATCH(launch_dkv, q, k, v, dout, (const float*)lse,
               (const float*)delta, dk, dv, B, S, Hq, Hkv, qs, ks, causal,
               scale, (cudaStream_t)stream);
}

}  // extern "C"
