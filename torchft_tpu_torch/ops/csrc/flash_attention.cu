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
// ~295 flop/byte ridge, so every body is bound by arithmetic, not by HBM:
// the bf16 bodies at the tensor-core peak (989 TFLOP/s), the fp32 FMA
// bodies at the CUDA-core peak (67 TFLOP/s).
//
// bf16 forward, dq and dk/dv: the tensor cores (flash_fwd_wgmma_kernel,
// flash_bwd_dq_wgmma_kernel, flash_bwd_dkv_wgmma_kernel).
//   - Every product of each tile pair is wgmma.mma_async m64nNk16 (bf16 in,
//     fp32 accumulate), issued by one warpgroup of 128 threads that owns the
//     block's 64 output rows. 64 q rows per forward block, not 128: the skip
//     predicate and the causal loops stay at the 64-row tiles of the FMA
//     bodies and of the TPU block kernel's test, a block needs 41 KB of
//     shared memory and 128 registers a thread at D = 64, so four blocks
//     share an SM and one block's softmax runs while another's wgmma does
//     (the overlap that warp specialisation would otherwise have to build),
//     and the path's grid is 1536 blocks for 132 SMs.
//   - Tiles live in shared memory as bf16 in the swizzled layout the wgmma
//     descriptor names (TileLayout: 128-byte swizzle at D = 64, two 128-byte
//     atoms along D at D = 128, the 64- and 32-byte modes at D = 32 and 16).
//     One copy of each tile serves both products: K-major where D is
//     contracted (Q.K^T and dO.V^T; K.Q^T and V.dO^T in dk/dv), MN-major
//     where the rows are (P.V and dS.K; P^T.dO and dS^T.Q), so nothing is
//     stored transposed.
//   - The last product(s) take the A operand from registers: an fp32
//     accumulator fragment of a 64 x 64 product, rounded to packed bf16
//     pairs (the TPU kernel's p.astype(v.dtype), ds.astype(k.dtype)), is
//     already the A fragment of the next wgmma. dq forms dS element by
//     element in the S accumulator's layout, from S and dP issued as one
//     batch. In dk/dv the block stays on one 64-row kv tile, so S^T and dP^T
//     come out kv-row-major and P^T and dS^T feed dV and dK directly.
//   - cp.async 16-byte copies (zero-filled past S) write each tile's swizzled
//     addresses themselves, double-buffered: the next K/V tile (the next
//     Q/dO tile and its lse/delta/dlse in dk/dv) is in flight while the
//     tensor cores work on this one. No TMA: a tensor map per call would
//     cost a host encode and a link to libcuda for tiles this small.
//   - dq stays a kernel of its own, one block per 64 q rows summing over its
//     kv tiles in order; it is not folded into dk/dv with atomicAdd, which
//     would make the sums' order, and so the bits, vary from run to run.
//   - Shared memory a block: forward 5 tiles + 1 KB alignment (11,264,
//     21,504, 41,984 and 82,944 bytes at D = 16, 32, 64, 128); dq 6 tiles +
//     1 KB (13,312, 25,600, 50,176, 99,328), the rows' lse, delta and dlse
//     in registers; dk/dv 6 tiles + 1.5 KB of rows + 1 KB (14,848, 27,136,
//     51,712, 100,864). Registers a thread from ptxas (CUDA 12.8, sm_90a):
//     forward 84, 94, 128, 165; dq 104, 118, 141, 189; dk/dv 113, 127, 167,
//     249; no stack and no spills at any D. The build keeps the report
//     (flash_attention.ptxas.txt); chip_smoke.py prints it with the SASS's
//     HGMMA counts.
//
// fp32: the FMA bodies (flash_fwd_kernel, flash_bwd_dq_kernel,
// flash_bwd_dkv_kernel), in all three kernels by design, not as a fallback.
// The tensor cores take fp32 only as TF32 (10 mantissa bits), which cannot
// meet the fp32 limit of 1e-5 of each element's terms, so fp32 stays on the
// CUDA cores. No bf16 instantiation of these bodies is built.
//   - One thread block of 256 threads per (q tile of 64 rows, head, batch)
//     (per kv tile of 64 rows for dk/dv). Tiles are staged in shared memory
//     as fp32; operands of the S-shaped products are stored transposed
//     ([D][64]) so that each thread reads four rows or columns with one
//     16-byte load per d; each thread owns a 4x4 block of the 64x64 score
//     tile (16 FMAs per pair of loads). Shared memory above 48 KB is opted
//     into with cudaFuncSetAttribute (dk/dv at D = 128 uses 230,144 of the
//     232,448 bytes a block may have).
//
// Common to every body:
//   - A loop inside the block walks the kv tiles the mask keeps (the q
//     tiles, for dk/dv): this loop replaces the TPU's sequential grid axis,
//     whose VMEM scratch carries the running max/sum/accumulator between
//     grid steps. Nothing carries between CUDA blocks; here the running
//     state lives in registers. Heaviest tiles first.
//   - A (q tile, kv tile) pair whose keys all lie after all its queries is
//     never visited: the TPU block kernel's skip predicate
//     k0 + k_off <= q0 + q_off + 63, at 64-row tiles. The tiles a q tile
//     visits are a prefix of the kv tiles, and the q tiles that visit a kv
//     tile a suffix, so the loops only run over those. The tensor-core
//     bodies mask elements only in the visited edge tiles (across the
//     diagonal or past the end).
//   - A row of a block whose tiles were all skipped (a k/v block wholly in
//     the q shard's future) writes out 0 and lse = -1e30 + log(1e-30), which
//     is -1e30 in fp32, never NaN or -inf: the ring merge weighs it to 0.
//     A row that sees no key inside a visited tile gets P = exp(0) = 1 there,
//     as the TPU kernel does; only offsets that are not multiples of the
//     shard make such rows, and the ring never does.
//   - dk/dv loop over the q_per_kv heads of the GQA group and their q tiles
//     inside one block, so each kv row's gradient is summed in a fixed
//     order: no atomics, the result is the same run to run.
//   - Masked scores are -1e30, not -inf, so exp(m_prev - m_new) is never NaN.
//   - The whole-sequence and block entry points share each body, so the
//     block kernels at offsets (0,0) without dlse compute the whole-sequence
//     kernels' bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;      // rows of a q tile and of a kv tile
constexpr int kThreads = 256;  // 16 x 16 threads, each owning 4 x 4 scores
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

struct Strides {
  long long b, s, h;  // in elements; the last (D) dim is contiguous
};

// Tile of 64 rows x D from global memory into shared memory, transposed:
// dst[d * 64 + r]. Consecutive threads take consecutive rows (four values of
// d each), so the shared-memory writes do not conflict. Rows at or past S
// are zero.
template <int D>
__device__ __forceinline__ void load_tile_t(float* dst, const float* base,
                                            long long row_stride, int row0,
                                            int S) {
  constexpr int kChunks = D / 4;
  for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
    const int r = e % kTile;
    const int c = e / kTile;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < S) {
      load4(base + (long long)(row0 + r) * row_stride + c * 4, v);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[(c * 4 + i) * kTile + r] = v[i];
  }
}

// Tile of 64 rows x D into shared memory, row-major: dst[r * D + d].
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long row_stride, int row0,
                                          int S) {
  constexpr int kChunks = D / 4;
  for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = e % kChunks;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < S) {
      load4(base + (long long)(row0 + r) * row_stride + c * 4, v);
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
// dst[(c + j) * 64 + r + i], one 16-byte store per column.
__device__ __forceinline__ void store_t(float* dst, const float (&x)[4][4],
                                        int r, int c) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(dst + (c + j) * kTile + r) =
        make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
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
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
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

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * ks.b + hk * ks.h;
  load_tile_t<D>(Qt, qb, qs.s, q0, m.Sq);

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
    load_tile_t<D>(Kt, kb, ks.s, k0, m.Skv);
    load_tile<D>(Vs, vb, ks.s, k0, m.Skv);
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
    store_t(Pt, s, tr * 4, tc * 4);
    __syncthreads();
    mm_pv<D>(o, Pt, tr * 4, Vs, tc * DC);
  }

  // A row with no visited tile keeps l = 0 and m = -1e30: out 0 and
  // lse = -1e30 + log(1e-30), which is -1e30 in fp32.
  float* ob = out + b * qs.b + h * qs.h;
  float* lb = lse + ((long long)b * Hq + h) * m.Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= m.Sq) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
    const float inv = 1.f / denom;
#pragma unroll
    for (int jd = 0; jd < DC; ++jd)
      ob[(long long)row * qs.s + tc * DC + jd] = o[i][jd] * inv;
    if (tc == 0) lb[row] = m_i[i] + __logf(denom);
  }
}

// ---------------------------------------------------------------------------
// Backward dq. Grid (q tiles, Hq, B). Shared: Qt, dOt, Kt, Vt [D][64],
// K [64][D], dSt [64][64]. dlse is null for the whole-sequence kernel.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ dlse, float* __restrict__ dq,
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

  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * ks.b + hk * ks.h;
  load_tile_t<D>(Qt, q + b * qs.b + h * qs.h, qs.s, q0, m.Sq);
  load_tile_t<D>(dOt, dout + b * qs.b + h * qs.h, qs.s, q0, m.Sq);

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
    load_tile_t<D>(Kt, kb, ks.s, k0, m.Skv);
    load_tile_t<D>(Vt, vb, ks.s, k0, m.Skv);
    load_tile<D>(Ks, kb, ks.s, k0, m.Skv);
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
    store_t(dSt, s, tr * 4, tc * 4);
    __syncthreads();
    mm_pv<D>(acc, dSt, tr * 4, Ks, tc * DC);
  }

  float* qb = dq + b * qs.b + h * qs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= m.Sq) continue;
#pragma unroll
    for (int jd = 0; jd < DC; ++jd)
      qb[(long long)row * qs.s + tc * DC + jd] = acc[i][jd] * scale;
  }
}

// ---------------------------------------------------------------------------
// Backward dk/dv. Grid (kv tiles, Hkv, B). Shared: Kt, Vt, Qt, dOt [D][64],
// Q, dO [64][D], P, dS [64 q][64 kv], lse, delta and dlse of the q tile [64].
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ dlse, float* __restrict__ dk,
                     float* __restrict__ dv, Mask m, int Hq, int q_per_kv,
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

  load_tile_t<D>(Kt, k + b * ks.b + hk * ks.h, ks.s, k0, m.Skv);
  load_tile_t<D>(Vt, v + b * ks.b + hk * ks.h, ks.s, k0, m.Skv);

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
    const float* qb = q + b * qs.b + h * qs.h;
    const float* ob = dout + b * qs.b + h * qs.h;
    const long long row0 = ((long long)b * Hq + h) * m.Sq;
    for (int qt = q_begin; qt < n_q; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_tile_t<D>(Qt, qb, qs.s, q0, m.Sq);
      load_tile_t<D>(dOt, ob, qs.s, q0, m.Sq);
      load_tile<D>(Qs, qb, qs.s, q0, m.Sq);
      load_tile<D>(dOs, ob, qs.s, q0, m.Sq);
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
      store_t(Ps, st, tr * 4, tc * 4);
      store_t(dSs, dpt, tr * 4, tc * 4);
      __syncthreads();
      mm_pv<D>(dv_acc, Ps, tr * 4, dOs, tc * DC);
      mm_pv<D>(dk_acc, dSs, tr * 4, Qs, tc * DC);
    }
  }

  float* kb = dk + b * ks.b + hk * ks.h;
  float* vb = dv + b * ks.b + hk * ks.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + tr * 4 + i;
    if (row >= m.Skv) continue;
#pragma unroll
    for (int jd = 0; jd < DC; ++jd) {
      kb[(long long)row * ks.s + tc * DC + jd] = dk_acc[i][jd] * scale;
      vb[(long long)row * ks.s + tc * DC + jd] = dv_acc[i][jd];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 bodies on the tensor cores: forward, dq and dk/dv. One warpgroup (128
// threads) per block owns the block's 64 output rows; products are
// wgmma.mma_async m64nNk16 (bf16 in, fp32 accumulate). The source note at the
// top of the file says why 64 rows and what bounds these bodies.
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;  // one warpgroup

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A [64 rows][D] bf16 tile in shared memory, in the layout a wgmma
// descriptor names: D is cut into chunks of W = min(D, 64) values, each chunk
// a [64][W] block of rows of 2W bytes (32, 64 or 128), and the 16-byte units
// of each row are XOR-swizzled by the row (the 32-, 64- and 128-byte modes).
// The same bytes serve as a K-major operand (D contracted: Q.K^T) and as an
// MN-major one (the rows contracted: P.V, P^T.dO, dS^T.Q). Tiles start on
// 1024-byte boundaries, the period of every mode.
template <int D>
struct TileLayout {
  static constexpr int kW = D < 64 ? D : 64;
  static constexpr uint32_t kRowBytes = 2 * kW;
  static constexpr uint32_t kChunkBytes = kTile * kRowBytes;
  static constexpr uint32_t kBytes = kTile * D * 2;
  // Descriptor layout code: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle.
  static constexpr uint64_t kMode =
      kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static constexpr uint32_t kSwizzle = kRowBytes / 16 - 1;  // 7, 3 or 1

  // Byte offset of values (r, c .. c + 7), c a multiple of 8.
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    const uint32_t off = (c / kW) * kChunkBytes + r * kRowBytes + (c % kW) * 2;
    return off ^ (((off >> 7) & kSwizzle) << 4);
  }
};

__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (mode << 62);
}

// The tile as a K-major operand, k-step kk (values 16kk .. 16kk + 15 of D):
// 8-row groups SBO apart; within a swizzled row the start moves by 32 bytes.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using L = TileLayout<D>;
  const uint32_t start =
      tile + (kk * 16 / L::kW) * L::kChunkBytes + (kk * 16 % L::kW) * 2;
  return wgmma_desc(start, 16, 8 * L::kRowBytes, L::kMode);
}

// The tile as an MN-major operand, k-step kk (rows 16kk .. 16kk + 15): the
// D chunks LBO apart, 8-row groups SBO apart.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  using L = TileLayout<D>;
  return wgmma_desc(tile + kk * 16 * L::kRowBytes, L::kChunkBytes,
                    8 * L::kRowBytes, L::kMode);
}

// 16 bytes global -> shared without registers; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Makes this thread's completed copies visible to the async proxy (wgmma).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows of a [64 rows][D] bf16 tile from global memory (row stride in
// elements) into its swizzled shared layout; rows at or past S are zero.
template <int D>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* base,
                                                long long row_stride,
                                                int row0, int S) {
  constexpr int kUnits = D / 8;  // 16-byte units per row
#pragma unroll
  for (int i = 0; i < kTile * kUnits / kWgThreads; ++i) {
    const int e = i * kWgThreads + threadIdx.x;
    const int r = e / kUnits;
    const int c = (e % kUnits) * 8;
    const bool in = row0 + r < S;
    const __nv_bfloat16* src =
        in ? base + (long long)(row0 + r) * row_stride + c : base;
    cp_async16(dst + TileLayout<D>::offset(r, c), src, in);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence/commit/wait instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d (+)= A . B^T on 64 x 64 outputs: A (64 rows x 16) and B (64 rows x 16)
// both K-major in shared memory; accumulate 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}


// d += A . B on 64 x N outputs (N = D): A (64 rows x 16) from registers, in
// the fragment layout of an fp32 accumulator's rows (acc_to_a); B (16 rows x
// N) MN-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// A 64 x 64 fp32 accumulator (thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 and 8 below it, columns 8j + 2 (t % 4) and the
// next: s[4j + 2i + c]) rounded to bf16 as the register-A operand of k-step
// kk (columns 16kk .. 16kk + 15): the accumulator's layout is the operand's.
__device__ __forceinline__ void acc_to_a(const float (&s)[32], int kk,
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// Forward on the tensor cores. Grid (q tiles, Hq, B), one warpgroup. Shared:
// Q, then K and V twice (double buffer), each a swizzled [64][D] bf16 tile.
// S = Q.K^T takes both operands K-major from shared memory; P.V takes P from
// registers (the S accumulator rounded to bf16 is already the A fragment) and
// V MN-major. The next K/V tile is copied in while this one is worked on.
template <int D>
__global__ void __launch_bounds__(kWgThreads)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, Mask m, int Hq, int q_per_kv,
                       Strides qs, Strides ks, float scale) {
  using L = TileLayout<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t Qs = (smem_addr(smem_raw) + 1023) & ~1023u;
  auto Ks = [&](int buf) { return Qs + (1 + 2 * buf) * L::kBytes; };
  auto Vs = [&](int buf) { return Qs + (2 + 2 * buf) * L::kBytes; };

  // Heaviest (latest) q tiles first, so the causal tail is short.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / q_per_kv;
  const int q0 = qt * kTile;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16 + lane / 4;  // rows r0 and r0 + 8
  const int c0 = (lane % 4) * 2;  // columns c0, c0 + 1 of each 8 columns

  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * ks.b + hk * ks.h;
  const int kv_end = kv_tiles_end(m, q0);
  if (kv_end > 0) {
    load_tile_async<D>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, m.Sq);
    load_tile_async<D>(Ks(0), kb, ks.s, 0, m.Skv);
    load_tile_async<D>(Vs(0), vb, ks.s, 0, m.Skv);
  }
  cp_async_commit();

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.f, 0.f};

  for (int kt = 0; kt < kv_end; ++kt) {
    const int buf = kt & 1;
    const int k0 = kt * kTile;
    if (kt + 1 < kv_end) {
      load_tile_async<D>(Ks(buf ^ 1), kb, ks.s, k0 + kTile, m.Skv);
      load_tile_async<D>(Vs(buf ^ 1), vb, ks.s, k0 + kTile, m.Skv);
    }
    cp_async_commit();
    cp_async_wait_prior();  // tile kt (and Q) have landed
    fence_async_shared();
    __syncthreads();

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc_k<D>(Qs, kk), desc_k<D>(Ks(buf), kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Elements are masked in edge tiles only: past Skv or across the
    // diagonal. Rows past Sq read zeros and are never written.
    const bool edge =
        k0 + kTile > m.Skv ||
        (m.causal && k0 + kTile - 1 + m.k_off > q0 + m.q_off);
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r0 + 8 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[4 * j + 2 * i + c] * scale;
          const int col = k0 + 8 * j + c0 + c;
          if (edge && (col >= m.Skv ||
                       (m.causal && col + m.k_off > row + m.q_off)))
            x = kNegInf;
          s[4 * j + 2 * i + c] = x;
          mx = fmaxf(mx, x);
        }
      // The four threads of a row are lanes differing in their low 2 bits.
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[i], mx);
      alpha[i] = __expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = __expf(s[4 * j + 2 * i + c] - m_new);
          s[4 * j + 2 * i + c] = p;  // unrounded for the sum
          rs += p;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_i[i] = alpha[i] * l_i[i] + rs;
      m_i[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }

    // P rounded to bf16 (the TPU kernel's p.astype(v.dtype)), then P.V.
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(s, kk, pa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(o, pa[kk], desc_mn<D>(Vs(buf), kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);
    __syncthreads();  // buffer buf is refilled at tile kt + 2
  }

  // A row with no visited tile keeps l = 0 and m = -1e30: out 0 and
  // lse = -1e30 + log(1e-30), which is -1e30 in fp32.
  __nv_bfloat16* ob = out + b * qs.b + h * qs.h;
  float* lb = lse + ((long long)b * Hq + h) * m.Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= m.Sq) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
    const float inv = 1.f / denom;
    __nv_bfloat16* orow = ob + (long long)row * qs.s + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const uint32_t pair =
          pack_bf16(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      *reinterpret_cast<uint32_t*>(orow + 8 * j) = pair;
    }
    if (lane % 4 == 0) lb[row] = m_i[i] + __logf(denom);
  }
}

// dq on the tensor cores: the forward's skeleton with the dk/dv body's dS.
// Grid (q tiles, Hq, B), one warpgroup that owns the block's 64 q rows and
// sums their dq over the visited kv tiles in order (no atomics). Shared: Q
// and dO once, K and V twice (double buffer), each a swizzled [64][D] bf16
// tile; each thread keeps the lse, delta and dlse of its two rows in
// registers. S = Q.K^T and dP = dO.V^T take all operands K-major and go as
// one batch; dS is formed in their accumulator layout and, rounded to bf16,
// is the A operand of dQ += dS.K, K MN-major from the same tile.
template <int D>
__global__ void __launch_bounds__(kWgThreads)
flash_bwd_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ dlse,
                          __nv_bfloat16* __restrict__ dq, Mask m, int Hq,
                          int q_per_kv, Strides qs, Strides ks, float scale) {
  using L = TileLayout<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t Qs = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t dOs = Qs + L::kBytes;
  auto Ks = [&](int buf) { return Qs + (2 + 2 * buf) * L::kBytes; };
  auto Vs = [&](int buf) { return Qs + (3 + 2 * buf) * L::kBytes; };

  // Heaviest (latest) q tiles first, so the causal tail is short.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / q_per_kv;
  const int q0 = qt * kTile;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16 + lane / 4;  // rows r0 and r0 + 8
  const int c0 = (lane % 4) * 2;  // columns c0, c0 + 1 of each 8 columns

  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * ks.b + hk * ks.h;
  const int kv_end = kv_tiles_end(m, q0);
  if (kv_end > 0) {
    load_tile_async<D>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, m.Sq);
    load_tile_async<D>(dOs, dout + b * qs.b + h * qs.h, qs.s, q0, m.Sq);
    load_tile_async<D>(Ks(0), kb, ks.s, 0, m.Skv);
    load_tile_async<D>(Vs(0), vb, ks.s, 0, m.Skv);
  }
  cp_async_commit();

  const long long rows = ((long long)b * Hq + h) * m.Sq;
  float lse_i[2], delta_i[2], dlse_i[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    const bool in = row < m.Sq;
    lse_i[i] = in ? lse[rows + row] : 0.f;
    delta_i[i] = in ? delta[rows + row] : 0.f;
    dlse_i[i] = in && dlse != nullptr ? dlse[rows + row] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < kv_end; ++kt) {
    const int buf = kt & 1;
    const int k0 = kt * kTile;
    if (kt + 1 < kv_end) {
      load_tile_async<D>(Ks(buf ^ 1), kb, ks.s, k0 + kTile, m.Skv);
      load_tile_async<D>(Vs(buf ^ 1), vb, ks.s, k0 + kTile, m.Skv);
    }
    cp_async_commit();
    cp_async_wait_prior();  // tile kt (and Q, dO) have landed
    fence_async_shared();
    __syncthreads();

    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc_k<D>(Qs, kk), desc_k<D>(Ks(buf), kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, desc_k<D>(dOs, kk), desc_k<D>(Vs(buf), kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // s[4j + 2i + c] = s(q row q0 + r0 + 8i, kv row k0 + 8j + c0 + c).
    // Masked in edge tiles only: past Skv or across the diagonal. Rows past
    // Sq read zeros and are never written.
    const bool edge =
        k0 + kTile > m.Skv ||
        (m.causal && k0 + kTile - 1 + m.k_off > q0 + m.q_off);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r0 + 8 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          const float p = edge && hidden(m, row, k0 + 8 * j + c0 + c)
                              ? 0.f
                              : __expf(s[e] * scale - lse_i[i]);
          float dsum = dp[e] - delta_i[i];
          if (dlse != nullptr) dsum += dlse_i[i];  // the TPU kernel's order
          s[e] = p * dsum;                         // dS
        }
    }

    // dS rounded to bf16 (the TPU kernel's ds.astype(k.dtype)), then dQ +=
    // dS.K with K's rows contracted.
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(s, kk, da[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(acc, da[kk], desc_mn<D>(Ks(buf), kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(da);
    __syncthreads();  // buffer buf is refilled at tile kt + 2
  }

  // A row with no visited tile writes dq = 0.
  __nv_bfloat16* qb = dq + b * qs.b + h * qs.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= m.Sq) continue;
    __nv_bfloat16* qrow = qb + (long long)row * qs.s + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int e = 4 * j + 2 * i;
      *reinterpret_cast<uint32_t*>(qrow + 8 * j) =
          pack_bf16(acc[e] * scale, acc[e + 1] * scale);
    }
  }
}

// dk/dv on the tensor cores. Grid (kv tiles, Hkv, B), one warpgroup that
// stays on one 64-row kv tile and walks the q tiles of every q head of the
// GQA group in a fixed order (no atomics). Shared: K and V once; Q, dO and
// the q tile's lse, delta and dlse twice (double buffer). S^T = K.Q^T and
// dP^T = V.dO^T take all operands K-major; their accumulators are kv-row
// major, so P^T and dS^T feed dV += P^T.dO and dK += dS^T.Q as register
// operands with dO and Q MN-major: no transpose goes through shared memory.
template <int D>
__global__ void __launch_bounds__(kWgThreads)
flash_bwd_dkv_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const float* __restrict__ dlse,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, Mask m, int Hq,
                           int q_per_kv, Strides qs, Strides ks, float scale) {
  using L = TileLayout<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t Ks = smem_addr(smem);
  const uint32_t Vs = Ks + L::kBytes;
  auto Qs = [&](int buf) { return Ks + (2 + 2 * buf) * L::kBytes; };
  auto dOs = [&](int buf) { return Ks + (3 + 2 * buf) * L::kBytes; };
  // lse, delta, dlse of the q tile: float [3][64] per buffer.
  auto rows = [&](int buf) {
    return reinterpret_cast<float*>(smem + 6 * L::kBytes) + buf * 3 * kTile;
  };

  const int kt = gridDim.x - 1 - blockIdx.x;  // early kv tiles do most work
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * kTile;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16 + lane / 4;  // kv rows r0, r0 + 8
  const int c0 = (lane % 4) * 2;  // q columns c0, c0 + 1 of each 8 columns

  const int n_q = (m.Sq + kTile - 1) / kTile;
  const int q_begin = q_tiles_begin(m, k0);
  const int per_head = n_q - q_begin;
  const int n_steps = q_per_kv * per_head;

  // Copies step `step`'s q tile (head g = step / per_head) into buffer buf.
  auto issue = [&](int step, int buf) {
    const int h = hk * q_per_kv + step / per_head;
    const int q0 = (q_begin + step % per_head) * kTile;
    load_tile_async<D>(Qs(buf), q + b * qs.b + h * qs.h, qs.s, q0, m.Sq);
    load_tile_async<D>(dOs(buf), dout + b * qs.b + h * qs.h, qs.s, q0, m.Sq);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const bool in = row < m.Sq;
      const long long at = ((long long)b * Hq + h) * m.Sq + (in ? row : 0);
      const uint32_t dst = smem_addr(rows(buf) + threadIdx.x);
      cp_async4(dst, lse + at, in);
      cp_async4(dst + 4 * kTile, delta + at, in);
      if (dlse != nullptr) cp_async4(dst + 8 * kTile, dlse + at, in);
    }
  };

  if (n_steps > 0) {
    load_tile_async<D>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, m.Skv);
    load_tile_async<D>(Vs, v + b * ks.b + hk * ks.h, ks.s, k0, m.Skv);
    issue(0, 0);
  }
  cp_async_commit();

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1;
    const int q0 = (q_begin + step % per_head) * kTile;
    if (step + 1 < n_steps) issue(step + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prior();  // this step's tiles (and K, V) have landed
    fence_async_shared();
    __syncthreads();

    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(st, desc_k<D>(Ks, kk), desc_k<D>(Qs(buf), kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dpt, desc_k<D>(Vs, kk), desc_k<D>(dOs(buf), kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // Transposed: st[4j + 2i + c] = s(q row q0 + 8j + c0 + c, kv row
    // k0 + r0 + 8i). Masked in edge tiles only.
    const float* lse_s = rows(buf);
    const bool edge = q0 + kTile > m.Sq || k0 + kTile > m.Skv ||
                      (m.causal && k0 + kTile - 1 + m.k_off > q0 + m.q_off);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qi = 8 * j + c0 + c;
        const float l = lse_s[qi];
        const float dl = lse_s[kTile + qi];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * j + 2 * i + c;
          const float p =
              edge && hidden(m, q0 + qi, k0 + r0 + 8 * i)
                  ? 0.f
                  : __expf(st[e] * scale - l);
          float dsum = dpt[e] - dl;
          if (dlse != nullptr) dsum += lse_s[2 * kTile + qi];  // TPU order
          dpt[e] = p * dsum;  // dS^T
          st[e] = p;          // P^T
        }
      }

    // P^T and dS^T rounded to bf16, then dV += P^T.dO and dK += dS^T.Q.
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc_to_a(st, kk, pa[kk]);
      acc_to_a(dpt, kk, da[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(dv_acc, pa[kk], desc_mn<D>(dOs(buf), kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(dk_acc, da[kk], desc_mn<D>(Qs(buf), kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pa);
    fence_regs(da);
    __syncthreads();  // buffer buf is refilled at step + 2
  }

  __nv_bfloat16* kb = dk + b * ks.b + hk * ks.h;
  __nv_bfloat16* vb = dv + b * ks.b + hk * ks.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + r0 + 8 * i;
    if (row >= m.Skv) continue;
    __nv_bfloat16* krow = kb + (long long)row * ks.s + c0;
    __nv_bfloat16* vrow = vb + (long long)row * ks.s + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int e = 4 * j + 2 * i;
      *reinterpret_cast<uint32_t*>(krow + 8 * j) =
          pack_bf16(dk_acc[e] * scale, dk_acc[e + 1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + 8 * j) =
          pack_bf16(dv_acc[e], dv_acc[e + 1]);
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
// The tensor-core bodies: bf16 tiles (forward: Q, K and V twice; dq: Q, dO,
// K and V twice; dk/dv: K, V, and Q and dO twice with the q tile's three
// fp32 rows twice), plus 1024 bytes to align the first tile to the swizzle
// period.
template <int D>
constexpr size_t fwd_wgmma_smem() {
  return 5 * TileLayout<D>::kBytes + 1024;
}
template <int D>
constexpr size_t dq_wgmma_smem() {
  return 6 * TileLayout<D>::kBytes + 1024;
}
template <int D>
constexpr size_t dkv_wgmma_smem() {
  return 6 * TileLayout<D>::kBytes + 2 * 3 * kTile * sizeof(float) + 1024;
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

// Launches `kernel` on `grid` after opting into its shared memory.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Every kernel routes by dtype at compile time: bf16 to its tensor-core
// body, fp32 to its FMA body (the tensor cores have no fp32 product that
// meets the fp32 limit).
template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, Problem p, cudaStream_t stream) {
  const dim3 grid((p.m.Sq + kTile - 1) / kTile, p.Hq, p.B);
  const auto args = [&](auto kernel, int threads, size_t smem) {
    return launch(kernel, grid, threads, smem, stream, (const T*)q,
                  (const T*)k, (const T*)v, (T*)out, lse, p.m, p.Hq,
                  p.Hq / p.Hkv, p.qs, p.ks, p.scale);
  };
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return args(flash_fwd_wgmma_kernel<D>, kWgThreads, fwd_wgmma_smem<D>());
  else
    return args(flash_fwd_kernel<D>, kThreads, fwd_smem<D>());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const float* dlse,
              void* dq, Problem p, cudaStream_t stream) {
  const dim3 grid((p.m.Sq + kTile - 1) / kTile, p.Hq, p.B);
  const auto args = [&](auto kernel, int threads, size_t smem) {
    return launch(kernel, grid, threads, smem, stream, (const T*)q,
                  (const T*)k, (const T*)v, (const T*)dout, lse, delta, dlse,
                  (T*)dq, p.m, p.Hq, p.Hq / p.Hkv, p.qs, p.ks, p.scale);
  };
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return args(flash_bwd_dq_wgmma_kernel<D>, kWgThreads, dq_wgmma_smem<D>());
  else
    return args(flash_bwd_dq_kernel<D>, kThreads, dq_smem<D>());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const float* dlse,
               void* dk, void* dv, Problem p, cudaStream_t stream) {
  const dim3 grid((p.m.Skv + kTile - 1) / kTile, p.Hkv, p.B);
  const auto args = [&](auto kernel, int threads, size_t smem) {
    return launch(kernel, grid, threads, smem, stream, (const T*)q,
                  (const T*)k, (const T*)v, (const T*)dout, lse, delta, dlse,
                  (T*)dk, (T*)dv, p.m, p.Hq, p.Hq / p.Hkv, p.qs, p.ks,
                  p.scale);
  };
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return args(flash_bwd_dkv_wgmma_kernel<D>, kWgThreads,
                dkv_wgmma_smem<D>());
  else
    return args(flash_bwd_dkv_kernel<D>, kThreads, dkv_smem<D>());
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
