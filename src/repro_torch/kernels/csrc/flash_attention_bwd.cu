// The gradient of flash attention (grouped-query heads, lengths, the
// decode-aligned causal mask), for Hopper.
//
// It replaces the gradient of the TPU kernel flash_attention
// (src/repro/kernels/flash_attention/kernel.py:87), which has no backward
// of its own: the reference differentiates its plain jnp attention with
// XLA (src/repro/models/attention.py:38, _gqa_scores).  The port's models
// run the forward on the hand-written kernel in flash_attention.cu, so its
// gradient is this file's.  It computes (dq, dk, dv) from q, k, v, the
// forward's output o and the output's gradient do, with the forward's
// masking: key kp is live for the query at position i of batch entry b
// when kp < lengths[b] and, when causal, kp <= i + (Sk - Sq).  A masked
// score has P = 0 and dS = 0 exactly, so a row with no live key gets zero
// gradients and a key past a length moves no bit of dq.
//
// Both routes split the work as FA2 does, two kernels and no float
// atomics, so a run repeats bit for bit: a dq kernel a query tile, which
// finds each row's log-sum-exp in a first pass over the live keys (the
// forward kernels stay as they are and save nothing) and writes it and
// Delta = rowsum(do * o) (float32 scratch); and a dkdv kernel a 64-key
// tile, which keeps its K and V tile and walks the query tiles of all G
// heads of its KV head, skipping the tiles the causal mask hides, and
// recomputes P = exp(scale S - lse) and dS = P (dP - Delta).  A key tile
// past the batch entry's length is written as zeros without a loop.
//
// Bound on an H100 SXM: bytes.  At the training call (B 8, H 24, KV 8,
// S 511, head_dim 64, bf16) the function reads q, k, v, o and do once and
// writes dq, dk and dv once, 67 MB, 0.020 ms at 3.35 TB/s; its 10 FLOPs
// a live (query head, key, dim) triple, 16.1 GFLOP, take 0.016 ms on the
// tensor cores at 989 TFLOP/s.  Two routes; ops.route_bwd picks one by an
// explicit rule:
//
// - "wgmma" (bf16, head_dim a multiple of 16 up to 128, TMA-legal q, k,
//   v, o and do): every product on the tensor cores, fed by TMA.  Each
//   kernel is one consumer warpgroup and a producer warp (160 threads).
//   fa_bwd_dq_wgmma_kernel: a block holds 64 query positions of one head.
//   Its producer warp loads the Q and dO tiles once, then the live K tiles
//   (pass 1) and K/V tiles (pass 2) into a double-buffered ring, stopping
//   at the live prefix.  S = Q K^T and dP = dO V^T are wgmmas from shared
//   memory (K and V as the K-major B operand); the softmax (in log2
//   units), P and dS stay on the accumulator fragments; dQ += dS K takes
//   dS from registers and K as the MN-major B operand (the transpose
//   bit).  fa_bwd_dkdv_wgmma_kernel: a block holds a 64-key tile of one
//   KV head; K and V are loaded once, then Q, dO, lse and Delta stream
//   through a ring (the last two by bulk copy).  It computes S^T = K Q^T
//   and dP^T = V dO^T, 32 queries at a time, so P^T and dS^T land in
//   registers in the A layout of dV += P^T dO and dK += dS^T Q (dO and Q
//   MN-major), and the two halves of 32 keep S^T, dP^T and the A operands
//   beside the dK and dV accumulators in 168 registers: two blocks an SM
//   without spills (one at head_dim > 64, 227 registers).  P and dS enter
//   those products as bf16 hi + lo pairs, x_hi = bf16(x),
//   x_lo = bf16(x - x_hi), two wgmmas into one float32 sum: one bf16 P
//   or dS alone breaks the bf16 tolerance (tests/test_torch_lm_routes.py
//   shows it).  A tile whose pairs are all live skips the per-element
//   mask.  The split and the pairs cost 22 tensor FLOPs a triple against
//   the function's 10, so the bound stays bytes; head_dim below 64 is
//   read as 64 through TMA's zero fill.  At the training call the dq grid
//   is 1,536 blocks (5.8 waves of two blocks on 132 SMs), the dkdv grid
//   512 (1.9 waves), the longest causal rows or keys first.  Neither
//   bound holds this design back but latency: each warpgroup waits on its
//   own products around the element-wise passes, with only two
//   warpgroups an SM to cover the waits.
// - "simt" (the first design): both kernels on the CUDA cores in float32,
//   operations bound.  256 threads as 16 row groups x 16 column groups;
//   thread (r, c) holds S entries of rows r + 16 i and columns c + 16 j
//   (i, j < 4), so shared-memory reads of a row stride of d + 1 floats do
//   not conflict, and accumulator columns c + 16 j (j < 8) of head_dim
//   <= 128.  It takes float32, any head_dim up to 128 and operands TMA
//   cannot read.
#include "hopper.cuh"
#include "hopper_wgmma.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ============================================================= route "simt"

constexpr int kTile = 64;            // query rows a tile, keys a tile
constexpr int kThreads = 256;        // 16 row groups x 16 column groups
constexpr int kMaxHeadDim = 128;
constexpr int kPer = kTile / 16;     // S rows (cols) a thread holds
constexpr int kDPer = kMaxHeadDim / 16;
constexpr int kPs = kTile + 1;       // padded row stride of P and dS
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ int64_t imin(int64_t x, int64_t y) { return x < y ? x : y; }

template <typename T> __device__ __forceinline__ float load_f32(const T* p);
template <> __device__ __forceinline__ float load_f32(const float* p) { return *p; }
template <> __device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32(float x) {
  return __float2bfloat16(x);
}

// reduce over the 16 lanes of a half warp (one row group)
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o >= 1; o /= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o >= 1; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The shape of one call, and the map from a tile row (a (group head,
// position) pair of one KV head) to its element offset.
struct Shape {
  int64_t heads, kv_heads, sq, sk;
  int d, causal;
  float scale;
  __device__ int64_t row_offset(int64_t b, int64_t kvh, int64_t row) const {
    const int64_t g = heads / kv_heads;
    const int64_t h = kvh * g + row / sq, pos = row % sq;
    return ((b * heads + h) * sq + pos) * d;
  }
  __device__ int64_t row_index(int64_t b, int64_t kvh, int64_t row) const {
    return row_offset(b, kvh, row) / d;
  }
  // the last query position among rows [row0, row0 + kTile)
  __device__ int64_t last_pos(int64_t row0, int64_t rows) const {
    const int64_t row_end = imin(row0 + kTile, rows) - 1;
    return (row0 / sq != row_end / sq) ? sq - 1 : row_end % sq;
  }
  __device__ bool live(int64_t qpos, int64_t kp, int64_t len) const {
    return qpos >= 0 && kp < len && (!causal || kp <= qpos + (sk - sq));
  }
};

// rows [row0, row0 + kTile) of x (zero past ``rows``) into xs (stride ld)
template <typename T>
__device__ void load_rows(const T* __restrict__ x, float* xs, int ld,
                          const Shape& sh, int64_t b, int64_t kvh, int64_t row0,
                          int64_t rows) {
  for (int i = threadIdx.x; i < kTile * sh.d; i += kThreads) {
    const int lr = i / sh.d, dd = i % sh.d;
    const int64_t row = row0 + lr;
    xs[lr * ld + dd] =
        row < rows ? load_f32(x + sh.row_offset(b, kvh, row) + dd) : 0.0f;
  }
}

// keys [k0, k0 + kTile) of k (and v) into ks (vs), zero past sk
template <typename T>
__device__ void load_keys(const T* __restrict__ kb, const T* __restrict__ vb,
                          float* ks, float* vs, int ld, int d, int64_t k0,
                          int64_t sk) {
  for (int i = threadIdx.x; i < kTile * d; i += kThreads) {
    const int kr = i / d, dd = i % d;
    const int64_t kp = k0 + kr;
    const bool in = kp < sk;
    ks[kr * ld + dd] = in ? load_f32(kb + kp * d + dd) : 0.0f;
    if (vs) vs[kr * ld + dd] = in ? load_f32(vb + kp * d + dd) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout,
                 const int32_t* __restrict__ lengths, T* __restrict__ dq,
                 float* __restrict__ lse_out, float* __restrict__ delta_out,
                 Shape sh) {
  extern __shared__ float smem[];
  const int d = sh.d, ld = d + 1;
  float* qs = smem;                    // kTile x ld
  float* dos = qs + kTile * ld;        // kTile x ld
  float* ks = dos + kTile * ld;        // kTile x ld
  float* vs = ks + kTile * ld;         // kTile x ld
  float* dss = vs + kTile * ld;        // kTile x kPs

  const int64_t g = sh.heads / sh.kv_heads;
  const int64_t b = blockIdx.y / sh.kv_heads, kvh = blockIdx.y % sh.kv_heads;
  const int64_t rows = g * sh.sq;
  const int64_t row0 = (int64_t)blockIdx.x * kTile;
  const int tid = threadIdx.x, r = tid / 16, c = tid % 16;
  const int64_t len = imin((int64_t)lengths[b], sh.sk);
  const int64_t limit =
      sh.causal ? imin(len, sh.last_pos(row0, rows) + (sh.sk - sh.sq) + 1) : len;
  const T* kb = k + (b * sh.kv_heads + kvh) * sh.sk * d;
  const T* vb = v + (b * sh.kv_heads + kvh) * sh.sk * d;

  load_rows(q, qs, ld, sh, b, kvh, row0, rows);
  load_rows(dout, dos, ld, sh, b, kvh, row0, rows);
  __syncthreads();

  int64_t qpos[kPer];
  float delta[kPer], m[kPer], l[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int64_t row = row0 + r + 16 * i;
    qpos[i] = row < rows ? row % sh.sq : -1;
    float s = 0.0f;
    if (row < rows) {
      const T* orow = o + sh.row_offset(b, kvh, row);
#pragma unroll
      for (int j = 0; j < kDPer; ++j) {
        const int dd = c + 16 * j;
        if (dd < d) s += dos[(r + 16 * i) * ld + dd] * load_f32(orow + dd);
      }
    }
    delta[i] = half_warp_sum(s);
    m[i] = kNegInf;
    l[i] = 0.0f;
  }

  // pass 1: each row's max and sum over its live keys, as the forward
  for (int64_t k0 = 0; k0 < limit; k0 += kTile) {
    __syncthreads();
    load_keys(kb, (const T*)nullptr, ks, nullptr, ld, d, k0, sh.sk);
    __syncthreads();
    float s[kPer][kPer] = {};
    for (int dd = 0; dd < d; ++dd) {
      float qv[kPer], kv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) qv[i] = qs[(r + 16 * i) * ld + dd];
#pragma unroll
      for (int j = 0; j < kPer; ++j) kv[j] = ks[(c + 16 * j) * ld + dd];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) s[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float mx = kNegInf;
      bool lv[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        lv[j] = sh.live(qpos[i], k0 + c + 16 * j, len);
        s[i][j] = lv[j] ? s[i][j] * sh.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) rs += lv[j] ? expf(s[i][j] - m_new) : 0.0f;
      l[i] = l[i] * expf(m[i] - m_new) + half_warp_sum(rs);
      m[i] = m_new;
    }
  }
  float lse[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) lse[i] = l[i] > 0.0f ? m[i] + logf(l[i]) : 0.0f;

  // pass 2: dS = P (dP - Delta), dq += dS K
  float acc[kPer][kDPer] = {};
  for (int64_t k0 = 0; k0 < limit; k0 += kTile) {
    __syncthreads();
    load_keys(kb, vb, ks, vs, ld, d, k0, sh.sk);
    __syncthreads();
    float s[kPer][kPer] = {}, dp[kPer][kPer] = {};
    for (int dd = 0; dd < d; ++dd) {
      float qv[kPer], dv[kPer], kv[kPer], vv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        qv[i] = qs[(r + 16 * i) * ld + dd];
        dv[i] = dos[(r + 16 * i) * ld + dd];
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        kv[j] = ks[(c + 16 * j) * ld + dd];
        vv[j] = vs[(c + 16 * j) * ld + dd];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += dv[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const bool lv = sh.live(qpos[i], k0 + c + 16 * j, len);
        const float p = lv ? expf(s[i][j] * sh.scale - lse[i]) : 0.0f;
        dss[(r + 16 * i) * kPs + c + 16 * j] = p * (dp[i][j] - delta[i]);
      }
    __syncthreads();
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) dsv[i] = dss[(r + 16 * i) * kPs + kk];
#pragma unroll
      for (int j = 0; j < kDPer; ++j) {
        const int dd = c + 16 * j;
        if (dd < d) {
          const float kval = ks[kk * ld + dd];
#pragma unroll
          for (int i = 0; i < kPer; ++i) acc[i][j] += dsv[i] * kval;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int64_t row = row0 + r + 16 * i;
    if (row >= rows) continue;
    T* out = dq + sh.row_offset(b, kvh, row);
#pragma unroll
    for (int j = 0; j < kDPer; ++j) {
      const int dd = c + 16 * j;
      if (dd < d) out[dd] = from_f32<T>(acc[i][j] * sh.scale);
    }
    if (c == 0) {
      const int64_t idx = sh.row_index(b, kvh, row);
      lse_out[idx] = lse[i];
      delta_out[idx] = delta[i];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const int32_t* __restrict__ lengths,
                   const float* __restrict__ lse_in,
                   const float* __restrict__ delta_in, T* __restrict__ dk,
                   T* __restrict__ dv, Shape sh) {
  extern __shared__ float smem[];
  const int d = sh.d, ld = d + 1;
  float* ks = smem;                    // kTile x ld
  float* vs = ks + kTile * ld;         // kTile x ld
  float* qs = vs + kTile * ld;         // kTile x ld
  float* dos = qs + kTile * ld;        // kTile x ld
  float* ps = dos + kTile * ld;        // kTile x kPs: P
  float* dss = ps + kTile * kPs;       // kTile x kPs: dS
  float* ls = dss + kTile * kPs;       // kTile: lse
  float* dl = ls + kTile;              // kTile: Delta

  const int64_t g = sh.heads / sh.kv_heads;
  const int64_t b = blockIdx.y / sh.kv_heads, kvh = blockIdx.y % sh.kv_heads;
  const int64_t rows = g * sh.sq;
  const int64_t k0 = (int64_t)blockIdx.x * kTile;
  const int tid = threadIdx.x, r = tid / 16, c = tid % 16;
  const int64_t len = imin((int64_t)lengths[b], sh.sk);
  const int64_t base = (b * sh.kv_heads + kvh) * sh.sk * d;

  // accumulators of keys k0 + r + 16 i, dims c + 16 j
  float adk[kPer][kDPer] = {}, adv[kPer][kDPer] = {};
  if (k0 < len) {
    load_keys(k + base, v + base, ks, vs, ld, d, k0, sh.sk);
    for (int64_t row0 = 0; row0 < rows; row0 += kTile) {
      // no query of this tile sees a key of ours: skip (uniform per block)
      if (sh.causal && sh.last_pos(row0, rows) + (sh.sk - sh.sq) < k0) continue;
      __syncthreads();                 // the previous tile's reads are done
      load_rows(q, qs, ld, sh, b, kvh, row0, rows);
      load_rows(dout, dos, ld, sh, b, kvh, row0, rows);
      if (tid < kTile) {
        const int64_t row = row0 + tid;
        const bool in = row < rows;
        const int64_t idx = in ? sh.row_index(b, kvh, row) : 0;
        ls[tid] = in ? lse_in[idx] : 0.0f;
        dl[tid] = in ? delta_in[idx] : 0.0f;
      }
      __syncthreads();
      float s[kPer][kPer] = {}, dp[kPer][kPer] = {};
      for (int dd = 0; dd < d; ++dd) {
        float qv[kPer], dov[kPer], kv[kPer], vv[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          qv[i] = qs[(r + 16 * i) * ld + dd];
          dov[i] = dos[(r + 16 * i) * ld + dd];
        }
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          kv[j] = ks[(c + 16 * j) * ld + dd];
          vv[j] = vs[(c + 16 * j) * ld + dd];
        }
#pragma unroll
        for (int i = 0; i < kPer; ++i)
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            s[i][j] += qv[i] * kv[j];
            dp[i][j] += dov[i] * vv[j];
          }
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int lr = r + 16 * i;
        const int64_t row = row0 + lr;
        const int64_t qpos = row < rows ? row % sh.sq : -1;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const bool lv = sh.live(qpos, k0 + c + 16 * j, len);
          const float p = lv ? expf(s[i][j] * sh.scale - ls[lr]) : 0.0f;
          ps[lr * kPs + c + 16 * j] = p;
          dss[lr * kPs + c + 16 * j] = p * (dp[i][j] - dl[lr]);
        }
      }
      __syncthreads();
      for (int qq = 0; qq < kTile; ++qq) {
        float pv[kPer], dsv[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          pv[i] = ps[qq * kPs + r + 16 * i];
          dsv[i] = dss[qq * kPs + r + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < kDPer; ++j) {
          const int dd = c + 16 * j;
          if (dd < d) {
            const float dov = dos[qq * ld + dd], qv = qs[qq * ld + dd];
#pragma unroll
            for (int i = 0; i < kPer; ++i) {
              adv[i][j] += pv[i] * dov;
              adk[i][j] += dsv[i] * qv;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int64_t kp = k0 + r + 16 * i;
    if (kp >= sh.sk) continue;
#pragma unroll
    for (int j = 0; j < kDPer; ++j) {
      const int dd = c + 16 * j;
      if (dd < d) {
        dk[base + kp * d + dd] = from_f32<T>(adk[i][j] * sh.scale);
        dv[base + kp * d + dd] = from_f32<T>(adv[i][j]);
      }
    }
  }
}

size_t dq_smem(int d) {
  return sizeof(float) * ((size_t)4 * kTile * (d + 1) + (size_t)kTile * kPs);
}
size_t dkdv_smem(int d) {
  return sizeof(float) *
         ((size_t)4 * kTile * (d + 1) + (size_t)2 * kTile * kPs + 2 * kTile);
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lengths, void* dq, void* lse,
              void* delta, long long batch, const Shape& sh,
              cudaStream_t stream) {
  static bool opted_in = false;        // above 48 KB only after opting in
  if (!opted_in) {
    cudaFuncSetAttribute(fa_bwd_dq_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)dq_smem(kMaxHeadDim));
    opted_in = true;
  }
  const long long rows = sh.heads / sh.kv_heads * sh.sq;
  const dim3 grid((unsigned)((rows + kTile - 1) / kTile),
                  (unsigned)(batch * sh.kv_heads));
  fa_bwd_dq_kernel<T><<<grid, kThreads, dq_smem(sh.d), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,
      (const int32_t*)lengths, (T*)dq, (float*)lse, (float*)delta, sh);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const void* lengths, const void* lse, const void* delta,
                void* dk, void* dv, long long batch, const Shape& sh,
                cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    cudaFuncSetAttribute(fa_bwd_dkdv_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)dkdv_smem(kMaxHeadDim));
    opted_in = true;
  }
  const dim3 grid((unsigned)((sh.sk + kTile - 1) / kTile),
                  (unsigned)(batch * sh.kv_heads));
  fa_bwd_dkdv_kernel<T><<<grid, kThreads, dkdv_smem(sh.d), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const int32_t*)lengths, (const float*)lse, (const float*)delta, (T*)dk,
      (T*)dv, sh);
  return (int)cudaGetLastError();
}

Shape make_shape(long long heads, long long kv_heads, long long sq,
                 long long sk, long long d, int causal, float scale) {
  Shape sh;
  sh.heads = heads;
  sh.kv_heads = kv_heads;
  sh.sq = sq;
  sh.sk = sk;
  sh.d = (int)d;
  sh.causal = causal;
  sh.scale = scale;
  return sh;
}


// ============================================================ route "wgmma"

constexpr int kBwRows = 64;                // query positions a dq tile
constexpr int kBwKeys = 64;                // keys a K/V tile
constexpr int kBwChunk = 64 * 64 * 2;      // 64 rows x 128 bytes (64 bf16)

// DC: head_dim in 64-wide chunks, 1 (d <= 64) or 2 (d <= 128).  Both
// kernels are one consumer warpgroup and a producer warp (160 threads).

// Q and dO of the block's head, a 2-stage K and V ring, 5 mbarriers
template <int DC>
__host__ __device__ constexpr int dq_wgmma_smem() {
  return 6 * DC * kBwChunk + 1024 + 8 * 8;
}

// K and V, a 2-stage ring of Q, dO, lse and Delta, 5 mbarriers
template <int DC>
__host__ __device__ constexpr int dkdv_wgmma_smem() {
  return 6 * DC * kBwChunk + 2 * 2 * kBwRows * 4 + 1024 + 8 * 8;
}

// S (or S^T) = A B^T over head_dim: A a K-major 64-row tile and B an
// N-row one (N = 64 or 32), each of DC 64-wide chunks, into ``acc``
// (which the caller zeroes).  The caller fences, commits and waits.  A
// descriptor's low 14 bits are the start address over 16, so a k-step
// adds its byte offset over 16 to it.
template <int DC, int N>
__device__ __forceinline__ void bw_qk(float (&acc)[N / 2], const uint8_t* a,
                                      const uint8_t* b) {
  using namespace hopper;
  const uint64_t da = desc_b128(a, 16, 1024), db = desc_b128(b, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < 4 * DC; ++kk) {
    const uint32_t off = ((kk / 4) * kBwChunk + (kk % 4) * 32) >> 4;
    if constexpr (N == 64)
      ss_m64n64k16<0>(acc, da + off, db + off, 1);
    else
      ss_m64n32k16<0>(acc, da + off, db + off, 1);
  }
}

// x (64 x N, float32, on the accumulator fragments) as bf16 hi + lo
// pairs, x_hi = bf16(x), x_lo = bf16(x - x_hi), in the A-operand layout:
// four registers a 16-column chunk u, from x[8 u .. 8 u + 7].  All are
// written before the products that read them are issued, so no wgmma
// waits for another's A registers.
template <int N>
__device__ __forceinline__ void bw_split(const float (&x)[N / 2],
                                         uint32_t (&hi)[N / 16][4],
                                         uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int u = 0; u < N / 16; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = x[8 * u + 2 * r], x1 = x[8 * u + 2 * r + 1];
      const __nv_bfloat16 b0 = __float2bfloat16(x0), b1 = __float2bfloat16(x1);
      hi[u][r] = hopper::pack_bf16(__bfloat162float(b0), __bfloat162float(b1));
      lo[u][r] = hopper::pack_bf16(x0 - __bfloat162float(b0),
                                   x1 - __bfloat162float(b1));
    }
}

// acc += X B over U 16-position k-steps: X as bw_split's hi + lo pair
// from registers, two wgmmas into one float32 sum; B 16 U rows of a tile
// of DC chunks read MN-major (the transpose bit).
template <int DC, int U>
__device__ __forceinline__ void bw_xb(float (&acc)[32 * DC],
                                      const uint32_t (&hi)[U][4],
                                      const uint32_t (&lo)[U][4],
                                      const uint8_t* b) {
  using namespace hopper;
  const uint64_t db = desc_b128(b, kBwChunk, 1024);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const uint64_t du = db + ((u * 16 * 128) >> 4);   // 16 rows on
    if constexpr (DC == 1) {
      rs_m64n64k16<1>(acc, hi[u], du, 1);
      rs_m64n64k16<1>(acc, lo[u], du, 1);
    } else {
      rs_m64n128k16<1>(acc, hi[u], du, 1);
      rs_m64n128k16<1>(acc, lo[u], du, 1);
    }
  }
}

// Accumulator fragment i of a thread (lane) of a 64 x 64 tile: row
// 16 warp + lane / 4 + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 (lane % 4) + (i & 1).
__device__ __forceinline__ int frag_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
}

// The (query, key) pairs a call keeps: qp < sq, kp < len and, when
// causal, kp <= qp + shift.  A tile whose pairs are all kept skips the
// per-element test (kMask = false below).
struct BwMask {
  int sq, len, shift, causal;
  __device__ __forceinline__ bool live(int qp, int kp) const {
    return qp < sq && kp < len && (!causal || kp <= qp + shift);
  }
  // every pair of queries [q0, q0 + nq) and keys [k0, k0 + 64) kept
  __device__ __forceinline__ bool full(int q0, int nq, int k0) const {
    return q0 + nq <= sq && k0 + kBwKeys <= len &&
           (!causal || k0 + kBwKeys - 1 <= q0 + shift);
  }
};

// Pass 1 of dq, one K tile: the scores in log2 units (S scale log2 e),
// folded into each row's running max m_r and sum l_r (rows qp0, qp0 + 8).
template <bool kMask>
__device__ __forceinline__ void dq_stats(float (&sc)[32], float (&m_r)[2],
                                         float (&l_r)[2], const BwMask& mk,
                                         int qp0, int k0, int lane,
                                         float scale2) {
  float mx[2] = {kNegInf, kNegInf};
  uint32_t live = 0xffffffffu;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hh = (i >> 1) & 1;
    float x = sc[i] * scale2;
    if (kMask && !mk.live(qp0 + 8 * hh, k0 + frag_col(i, lane))) {
      live &= ~(1u << i);
      x = kNegInf;
    }
    sc[i] = x;
    mx[hh] = fmaxf(mx[hh], x);
  }
  float m_new[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    m_new[hh] = fmaxf(m_r[hh], mx[hh]);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hh = (i >> 1) & 1;
    rs[hh] += (live >> i) & 1u ? exp2f(sc[i] - m_new[hh]) : 0.0f;
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
    rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
    l_r[hh] = l_r[hh] * exp2f(m_r[hh] - m_new[hh]) + rs[hh];
    m_r[hh] = m_new[hh];
  }
}

// Pass 2 of dq, one K tile: dS = P (dP - Delta) into sc, with
// P = 2^(S scale log2 e - lse2) and zero where masked.
template <bool kMask>
__device__ __forceinline__ void dq_ds(float (&sc)[32], const float (&dp)[32],
                                      const BwMask& mk, int qp0, int k0,
                                      int lane, float scale2,
                                      const float (&lse2)[2],
                                      const float (&delta)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hh = (i >> 1) & 1;
    const float p = exp2f(fmaf(sc[i], scale2, -lse2[hh]));
    const float ds = p * (dp[i] - delta[hh]);
    sc[i] = !kMask || mk.live(qp0 + 8 * hh, k0 + frag_col(i, lane)) ? ds
                                                                     : 0.0f;
  }
}

// dkdv, 32 queries of a Q tile: P^T into st and dS^T = P^T (dP^T - Delta)
// into dpt, rows keys (kp0, kp0 + 8), columns queries q0 + c; ls and dl
// hold those queries' lse2 and Delta.
template <bool kMask>
__device__ __forceinline__ void dkdv_ds(float (&st)[16], float (&dpt)[16],
                                        const float* ls, const float* dl,
                                        const BwMask& mk, int kp0, int q0,
                                        int lane, float scale2) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
    const float2 d2 = *reinterpret_cast<const float2*>(dl + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const bool on = !kMask || mk.live(q0 + c + (e & 1),
                                        kp0 + 8 * ((e >> 1) & 1));
      const float p = exp2f(fmaf(st[i], scale2, -((e & 1) ? l2.y : l2.x)));
      const float ds = p * (dpt[i] - ((e & 1) ? d2.y : d2.x));
      st[i] = on ? p : 0.0f;
      dpt[i] = on ? ds : 0.0f;
    }
  }
}

template <int DC>
__global__ void __launch_bounds__(160, 2)
fa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout,
                       const int32_t* __restrict__ lengths,
                       __nv_bfloat16* __restrict__ dq,
                       float* __restrict__ lse_out,
                       float* __restrict__ delta_out, int heads, int kv_heads,
                       int sq, int sk, int sq_pad, int d, int causal,
                       float scale) {
  using namespace hopper;
  constexpr int kT = DC * kBwChunk;        // Q, dO, one K or one V tile
  const int bh = blockIdx.x;               // b * heads + head
  const int b = bh / heads, kvh = bh % heads / (heads / kv_heads);
  const int q_tiles = (sq + kBwRows - 1) / kBwRows;
  // causal: the longest rows first, so the last wave is short
  const int q0 =
      (causal ? q_tiles - 1 - (int)blockIdx.y : (int)blockIdx.y) * kBwRows;
  const int q_last = min(q0 + kBwRows, sq) - 1;
  const int len = min(lengths[b], sk);
  const int shift = sk - sq;
  const int limit = causal ? min(len, q_last + shift + 1) : len;
  const int n_tiles = limit > 0 ? (limit + kBwKeys - 1) / kBwKeys : 0;
  const int tid = threadIdx.x;

  extern __shared__ uint8_t bw_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(bw_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_t = smem;                                 // kT
  uint8_t* do_t = q_t + kT;                            // kT
  uint8_t* ks = do_t + kT;                             // 2 stages x kT
  uint8_t* vs = ks + 2 * kT;                           // 2 stages x kT
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + 2 * kT);
  uint64_t* q_bar = bars;
  uint64_t* full = bars + 1;                           // [2]
  uint64_t* empty = bars + 3;                          // [2]
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);             // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128) {                        // the producer warp
    if (tid == 128) {
      prefetch_map(&map_q);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      prefetch_map(&map_do);
      mbar_expect_tx(q_bar, 2 * kT);
      for (int c = 0; c < DC; ++c) {
        tma_load_3d(q_t + c * kBwChunk, &map_q, q_bar, 64 * c, q0, bh);
        tma_load_3d(do_t + c * kBwChunk, &map_do, q_bar, 64 * c, q0, bh);
      }
      // pass 1 reads the live K tiles, pass 2 the K and V tiles
      int s = 0;
      uint32_t ph = 0;
      for (int pass = 0; pass < 2; ++pass)
        for (int t = 0; t < n_tiles; ++t) {
          mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], (pass + 1) * kT);
          for (int c = 0; c < DC; ++c) {
            tma_load_3d(ks + s * kT + c * kBwChunk, &map_k, &full[s], 64 * c,
                        t * kBwKeys, b * kv_heads + kvh);
            if (pass)
              tma_load_3d(vs + s * kT + c * kBwChunk, &map_v, &full[s],
                          64 * c, t * kBwKeys, b * kv_heads + kvh);
          }
          if (++s == 2) { s = 0; ph ^= 1; }
        }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int qp0 = q0 + warp * 16 + lane / 4;   // rows qp0 and qp0 + 8
  const BwMask mk = {sq, len, shift, causal};
  const float scale2 = scale * 1.4426950408889634f;   // scale log2 e

  // Delta = rowsum(dO * O) of rows qp0 and qp0 + 8, each quad of lanes a
  // row's column pairs, from device memory
  float delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qp = qp0 + 8 * hh;
    float sum = 0.0f;
    if (qp < sq) {
      const int64_t row = ((int64_t)bh * sq + qp) * d;
      for (int c = 2 * (lane % 4); c < d; c += 8) {
        const float2 ov = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(o + row + c));
        const float2 dov = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dout + row + c));
        sum += ov.x * dov.x + ov.y * dov.y;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    delta[hh] = sum;
  }
  mbar_wait(q_bar, 0);

  // pass 1: each row's max and sum over its live keys, as the forward
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.0f, 0.0f};
  int s = 0;
  uint32_t ph = 0;
  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(&full[s], ph);
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    fence_regs(sc);
    wgmma_fence();
    bw_qk<DC, 64>(sc, q_t, ks + s * kT);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == 2) { s = 0; ph ^= 1; }

    const int k0 = t * kBwKeys;
    if (mk.full(q0, kBwRows, k0))
      dq_stats<false>(sc, m_r, l_r, mk, qp0, k0, lane, scale2);
    else
      dq_stats<true>(sc, m_r, l_r, mk, qp0, k0, lane, scale2);
  }
  float lse2[2];                           // log2 units
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    lse2[hh] = l_r[hh] > 0.0f ? m_r[hh] + log2f(l_r[hh]) : 0.0f;

  // pass 2: dS = P (dP - Delta), dQ += dS K
  float acc[32 * DC];
#pragma unroll
  for (int i = 0; i < 32 * DC; ++i) acc[i] = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(&full[s], ph);
    const uint8_t* k_t = ks + s * kT;
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.0f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    bw_qk<DC, 64>(sc, q_t, k_t);
    bw_qk<DC, 64>(dp, do_t, vs + s * kT);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    const int k0 = t * kBwKeys;
    if (mk.full(q0, kBwRows, k0))
      dq_ds<false>(sc, dp, mk, qp0, k0, lane, scale2, lse2, delta);
    else
      dq_ds<true>(sc, dp, mk, qp0, k0, lane, scale2, lse2, delta);
    uint32_t hi[4][4], lo[4][4];
    bw_split<64>(sc, hi, lo);
    fence_regs(acc);
    wgmma_fence();
    bw_xb<DC, 4>(acc, hi, lo, k_t);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == 2) { s = 0; ph ^= 1; }
  }

  // head_dim % 16 == 0: a column pair is wholly in or out
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qp = qp0 + 8 * hh;
    if (lane % 4 == 0) {                   // rows past sq: zeros
      const int64_t idx = (int64_t)bh * sq_pad + qp;
      lse_out[idx] = qp < sq ? lse2[hh] : 0.0f;
      delta_out[idx] = qp < sq ? delta[hh] : 0.0f;
    }
    if (qp >= sq) continue;
    __nv_bfloat16* row = dq + ((int64_t)bh * sq + qp) * d;
#pragma unroll
    for (int j = 0; j < 8 * DC; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * hh] * scale, acc[4 * j + 2 * hh + 1] * scale);
    }
  }
}

template <int DC>
__global__ void __launch_bounds__(160, DC == 1 ? 2 : 1)
fa_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const int32_t* __restrict__ lengths,
                         const float* __restrict__ lse_in,
                         const float* __restrict__ delta_in,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int heads,
                         int kv_heads, int sq, int sk, int sq_pad, int d,
                         int causal, float scale) {
  using namespace hopper;
  constexpr int kT = DC * kBwChunk;
  const int g = heads / kv_heads;
  const int b = blockIdx.x / kv_heads, kvh = blockIdx.x % kv_heads;
  const int k0 = (int)blockIdx.y * kBwKeys;   // causal: the longest first
  const int len = min(lengths[b], sk);
  const int shift = sk - sq;
  const int q_tiles = (sq + kBwRows - 1) / kBwRows;
  // the query tiles that see a key of ours: all, or when causal those
  // from the one holding position k0 - shift on
  const bool any = k0 < len && (!causal || k0 - shift <= sq - 1);
  const int qt0 = causal && k0 - shift > 0 ? (k0 - shift) / kBwRows : 0;
  const int per_head = q_tiles - qt0;
  const int n_iter = any ? g * per_head : 0;
  const int tid = threadIdx.x;

  extern __shared__ uint8_t bw_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(bw_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = smem;                                  // kT
  uint8_t* vs = ks + kT;                               // kT
  uint8_t* qs = vs + kT;                               // 2 stages x kT
  uint8_t* dos = qs + 2 * kT;                          // 2 stages x kT
  float* lses = reinterpret_cast<float*>(dos + 2 * kT);  // 2 x kBwRows
  float* dls = lses + 2 * kBwRows;                     // 2 x kBwRows
  uint64_t* bars = reinterpret_cast<uint64_t*>(dls + 2 * kBwRows);
  uint64_t* kv_bar = bars;
  uint64_t* full = bars + 1;                           // [2]
  uint64_t* empty = bars + 3;                          // [2]
  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);             // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128) {                        // the producer warp
    if (tid == 128 && n_iter > 0) {
      prefetch_map(&map_q);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      prefetch_map(&map_do);
      mbar_expect_tx(kv_bar, 2 * kT);
      for (int c = 0; c < DC; ++c) {
        tma_load_3d(ks + c * kBwChunk, &map_k, kv_bar, 64 * c, k0,
                    b * kv_heads + kvh);
        tma_load_3d(vs + c * kBwChunk, &map_v, kv_bar, 64 * c, k0,
                    b * kv_heads + kvh);
      }
      int s = 0;
      uint32_t ph = 0;
      for (int it = 0; it < n_iter; ++it) {
        const int z = b * heads + kvh * g + it / per_head;
        const int q0 = (qt0 + it % per_head) * kBwRows;
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], 2 * kT + 2 * kBwRows * 4);
        for (int c = 0; c < DC; ++c) {
          tma_load_3d(qs + s * kT + c * kBwChunk, &map_q, &full[s], 64 * c, q0,
                      z);
          tma_load_3d(dos + s * kT + c * kBwChunk, &map_do, &full[s], 64 * c,
                      q0, z);
        }
        bulk_load(lses + s * kBwRows, lse_in + (int64_t)z * sq_pad + q0,
                  kBwRows * 4, &full[s]);
        bulk_load(dls + s * kBwRows, delta_in + (int64_t)z * sq_pad + q0,
                  kBwRows * 4, &full[s]);
        if (++s == 2) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int kp0 = k0 + warp * 16 + lane / 4;   // keys kp0 and kp0 + 8
  const BwMask mk = {sq, len, shift, causal};
  const float scale2 = scale * 1.4426950408889634f;   // scale log2 e
  float adk[32 * DC], adv[32 * DC];
#pragma unroll
  for (int i = 0; i < 32 * DC; ++i) adk[i] = adv[i] = 0.0f;
  if (n_iter > 0) mbar_wait(kv_bar, 0);
  int s = 0;
  uint32_t ph = 0;
  for (int it = 0; it < n_iter; ++it) {
    const int q0 = (qt0 + it % per_head) * kBwRows;
    mbar_wait(&full[s], ph);
    // two halves of 32 queries, so that S^T, dP^T and the A operands
    // fit beside the dK and dV accumulators; a half the causal mask or
    // the end of the rows hides is skipped
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qh = q0 + 32 * half;
      if (qh >= sq || (causal && qh + 31 + shift < k0)) continue;
      const uint8_t* q_h = qs + s * kT + half * 32 * 128;
      const uint8_t* do_h = dos + s * kT + half * 32 * 128;
      float st[16], dpt[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) st[i] = dpt[i] = 0.0f;
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
      bw_qk<DC, 32>(st, ks, q_h);          // S^T = K Q^T
      bw_qk<DC, 32>(dpt, vs, do_h);        // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T on the fragments: rows keys, columns queries
      const float* ls = lses + s * kBwRows + 32 * half;
      const float* dl = dls + s * kBwRows + 32 * half;
      if (mk.full(qh, 32, k0))
        dkdv_ds<false>(st, dpt, ls, dl, mk, kp0, qh, lane, scale2);
      else
        dkdv_ds<true>(st, dpt, ls, dl, mk, kp0, qh, lane, scale2);
      uint32_t p_hi[2][4], p_lo[2][4], ds_hi[2][4], ds_lo[2][4];
      bw_split<32>(st, p_hi, p_lo);
      bw_split<32>(dpt, ds_hi, ds_lo);
      fence_regs(adv);
      fence_regs(adk);
      wgmma_fence();
      bw_xb<DC, 2>(adv, p_hi, p_lo, do_h);    // dV += P^T dO
      bw_xb<DC, 2>(adk, ds_hi, ds_lo, q_h);   // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(adv);
      fence_regs(adk);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == 2) { s = 0; ph ^= 1; }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kp = kp0 + 8 * hh;
    if (kp >= sk) continue;
    const int64_t row = ((int64_t)(b * kv_heads + kvh) * sk + kp) * d;
#pragma unroll
    for (int j = 0; j < 8 * DC; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(dk + row + col) =
            __floats2bfloat162_rn(adk[4 * j + 2 * hh] * scale,
                                  adk[4 * j + 2 * hh + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + row + col) =
            __floats2bfloat162_rn(adv[4 * j + 2 * hh], adv[4 * j + 2 * hh + 1]);
      }
    }
  }
}

// The four tensor maps of a call: q and do over (B H, Sq, d), k and v over
// (B KV, Sk, d), 64 x 64 boxes.  A host thread whose first CUDA call this
// is (autograd's backward thread) has no current context yet, and
// cuTensorMapEncodeTiled encodes no map without one: cudaSetDevice makes
// the device's primary context current first.
struct BwMaps {
  CUtensorMap q, k, v, dout;
  bool make(const void* qp, const void* kp, const void* vp, const void* dop,
            long long batch, long long heads, long long kv_heads, long long sq,
            long long sk, int d) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess)
      return false;
    return hopper::make_map_3d(&q, qp, d, sq, batch * heads, d, sq * d, 64) &&
           hopper::make_map_3d(&dout, dop, d, sq, batch * heads, d, sq * d,
                               64) &&
           hopper::make_map_3d(&k, kp, d, sk, batch * kv_heads, d, sk * d,
                               64) &&
           hopper::make_map_3d(&v, vp, d, sk, batch * kv_heads, d, sk * d, 64);
  }
};

long long pad_rows(long long sq) {
  return (sq + kBwRows - 1) / kBwRows * kBwRows;
}

template <int DC>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const void* lengths,
                    void* dq, void* lse, void* delta, long long batch,
                    long long heads, long long kv_heads, long long sq,
                    long long sk, int d, int causal, float scale,
                    cudaStream_t stream) {
  BwMaps maps;
  if (!maps.make(q, k, v, dout, batch, heads, kv_heads, sq, sk, d))
    return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    cudaFuncSetAttribute(fa_bwd_dq_wgmma_kernel<DC>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         dq_wgmma_smem<DC>());
    opted_in = true;
  }
  const dim3 grid((unsigned)(batch * heads),
                  (unsigned)((sq + kBwRows - 1) / kBwRows));
  fa_bwd_dq_wgmma_kernel<DC><<<grid, 160, dq_wgmma_smem<DC>(), stream>>>(
      maps.q, maps.k, maps.v, maps.dout, (const __nv_bfloat16*)o,
      (const __nv_bfloat16*)dout, (const int32_t*)lengths,
      (__nv_bfloat16*)dq, (float*)lse, (float*)delta, (int)heads,
      (int)kv_heads, (int)sq, (int)sk, (int)pad_rows(sq), d, causal, scale);
  return (int)cudaGetLastError();
}

template <int DC>
int launch_dkdv_wgmma(const void* q, const void* k, const void* v,
                      const void* dout, const void* lengths, const void* lse,
                      const void* delta, void* dk, void* dv, long long batch,
                      long long heads, long long kv_heads, long long sq,
                      long long sk, int d, int causal, float scale,
                      cudaStream_t stream) {
  BwMaps maps;
  if (!maps.make(q, k, v, dout, batch, heads, kv_heads, sq, sk, d))
    return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    cudaFuncSetAttribute(fa_bwd_dkdv_wgmma_kernel<DC>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         dkdv_wgmma_smem<DC>());
    opted_in = true;
  }
  const dim3 grid((unsigned)(batch * kv_heads),
                  (unsigned)((sk + kBwKeys - 1) / kBwKeys));
  fa_bwd_dkdv_wgmma_kernel<DC><<<grid, 160, dkdv_wgmma_smem<DC>(), stream>>>(
      maps.q, maps.k, maps.v, maps.dout, (const int32_t*)lengths,
      (const float*)lse, (const float*)delta, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, (int)heads, (int)kv_heads, (int)sq, (int)sk,
      (int)pad_rows(sq), d, causal, scale);
  return (int)cudaGetLastError();
}

bool wgmma_shape_ok(long long heads, long long kv_heads, long long d) {
  return d >= 16 && d <= kMaxHeadDim && d % 16 == 0 && kv_heads >= 1 &&
         heads % kv_heads == 0;
}

}  // namespace

// dq, and each row's log-sum-exp and Delta (float32, (B, H, Sq)) for the
// second kernel.  Contiguous (B, H, Sq, D) q, o, do, dq and (B, KV, Sk, D)
// k, v, checked by the caller (ops.attention_bwd).
extern "C" int lm_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lengths, void* dq, void* lse, void* delta,
    long long batch, long long heads, long long kv_heads, long long sq,
    long long sk, long long d, int causal, float scale, int bf16,
    void* stream) {
  if (d < 1 || d > kMaxHeadDim || kv_heads < 1 || heads % kv_heads)
    return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(heads, kv_heads, sq, sk, d, causal, scale);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_dq<__nv_bfloat16>(q, k, v, o, dout, lengths, dq, lse, delta,
                                    batch, sh, s);
  return launch_dq<float>(q, k, v, o, dout, lengths, dq, lse, delta, batch, sh,
                          s);
}

// dk and dv from the first kernel's lse and Delta.
extern "C" int lm_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lengths, const void* lse, const void* delta, void* dk,
    void* dv, long long batch, long long heads, long long kv_heads,
    long long sq, long long sk, long long d, int causal, float scale, int bf16,
    void* stream) {
  if (d < 1 || d > kMaxHeadDim || kv_heads < 1 || heads % kv_heads)
    return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(heads, kv_heads, sq, sk, d, causal, scale);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_dkdv<__nv_bfloat16>(q, k, v, dout, lengths, lse, delta, dk,
                                      dv, batch, sh, s);
  return launch_dkdv<float>(q, k, v, dout, lengths, lse, delta, dk, dv, batch,
                            sh, s);
}

// The wgmma route's dq, with each row's lse and Delta (float32, (B, H,
// Sq rounded up to 64), rows past Sq zero) for its dkdv.  bf16,
// head_dim % 16 == 0 and <= 128, TMA-legal contiguous operands (checked
// by the caller, ops.route_bwd).
extern "C" int lm_flash_attention_bwd_dq_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lengths, void* dq, void* lse, void* delta,
    long long batch, long long heads, long long kv_heads, long long sq,
    long long sk, long long d, int causal, float scale, void* stream) {
  if (!wgmma_shape_ok(heads, kv_heads, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 64)
    return launch_dq_wgmma<1>(q, k, v, o, dout, lengths, dq, lse, delta,
                              batch, heads, kv_heads, sq, sk, (int)d, causal,
                              scale, s);
  return launch_dq_wgmma<2>(q, k, v, o, dout, lengths, dq, lse, delta, batch,
                            heads, kv_heads, sq, sk, (int)d, causal, scale, s);
}

// The wgmma route's dk and dv from its dq kernel's lse and Delta.
extern "C" int lm_flash_attention_bwd_dkdv_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lengths, const void* lse, const void* delta, void* dk,
    void* dv, long long batch, long long heads, long long kv_heads,
    long long sq, long long sk, long long d, int causal, float scale,
    void* stream) {
  if (!wgmma_shape_ok(heads, kv_heads, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 64)
    return launch_dkdv_wgmma<1>(q, k, v, dout, lengths, lse, delta, dk, dv,
                                batch, heads, kv_heads, sq, sk, (int)d, causal,
                                scale, s);
  return launch_dkdv_wgmma<2>(q, k, v, dout, lengths, lse, delta, dk, dv,
                              batch, heads, kv_heads, sq, sk, (int)d, causal,
                              scale, s);
}
