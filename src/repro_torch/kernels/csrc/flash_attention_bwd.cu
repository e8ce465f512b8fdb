// The gradient of flash attention (grouped-query heads, lengths, the
// decode-aligned causal mask), for Hopper.
//
// The TPU kernel src/repro/kernels/flash_attention/kernel.py has no
// backward: the reference differentiates its plain jnp attention with XLA
// (src/repro/models/attention.py, _gqa_scores).  The port's models run the
// forward on the hand-written kernel in flash_attention.cu, so its gradient
// is this file's.  It computes (dq, dk, dv) from q, k, v, the forward's
// output o and the output's gradient do, with the forward's masking: key kp
// is live for the query at position i of batch entry b when kp < lengths[b]
// and, when causal, kp <= i + (Sk - Sq).  A masked score has P = 0, so a row
// with no live key gets zero gradients.
//
// Two kernels (the FA2 layout), both on the CUDA cores in float32, no float
// atomics, so a run repeats bit for bit:
//
// - fa_bwd_dq_kernel, one block a 64-row query tile of one (batch, KV head):
//   the rows are (group head, position) pairs, so the G query heads of a KV
//   head share each K/V tile load.  Pass 1 finds each row's log-sum-exp
//   (online max and sum over the live KV tiles, as the forward); then
//   Delta = rowsum(do * o); pass 2 recomputes P = exp(S - lse),
//   dP = do V^T, dS = P (dP - Delta) and accumulates dq = scale dS K.  It
//   writes lse and Delta (float32 scratch) for the second kernel.
// - fa_bwd_dkdv_kernel, one block a 64-key tile of one (batch, KV head):
//   it keeps its K and V tile in shared memory and walks every query row of
//   the group (all G heads), skipping query tiles the causal mask hides,
//   recomputing P and dS from lse and Delta, and accumulating
//   dv = P^T do and dk = scale dS^T q in registers.  A key tile past the
//   batch entry's length is written as zeros without a loop.
//
// Thread layout (both): 256 threads as 16 row groups x 16 column groups;
// thread (r, c) holds S entries of rows r + 16 i and columns c + 16 j
// (i, j < 4), so shared-memory reads of a row stride of d + 1 floats do not
// conflict, and accumulator columns c + 16 j (j < 8) of head_dim <= 128.
//
// Bound on an H100 SXM: bytes.  At the training call (B 8, H 24, KV 8,
// S 511, head_dim 64, bf16) the function reads q, k, v, o and do once and
// writes dq, dk and dv once, about 67 MB, 0.020 ms at 3.35 TB/s; its 10
// FLOPs per (query, key, dim) triple the mask keeps, 16.1 GFLOP, take
// 0.016 ms on the tensor cores at 989 TFLOP/s.  This design does about
// 12 FLOPs per triple (pass 1's S, pass 2's S and dP, dq; the second
// kernel's S, dP, dv and dk) on the CUDA cores' 67 TFLOP/s instead, so
// operations bound it: it is the simple first design, and wgmma and TMA
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
