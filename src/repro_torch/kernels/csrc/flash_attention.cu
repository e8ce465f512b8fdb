// Flash attention with KV-tile skipping and grouped-query heads, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (flash_attention / _kernel): online-softmax attention with float32 m, l
// and accumulator; keys masked by per-batch lengths and, when causal, by
// the decode-style rule kpos <= qpos + (Sk - Sq); KV tiles at or past
// min(len, q_last + 1) never loaded; -1e30 for masked scores, l clamped
// at 1e-30, output in q's type.
//
// Differences from the TPU kernel, none of which changes the function:
// - grouped-query attention: q has H heads, k and v KV heads, and query
//   head h reads KV head h / G (G = H / KV).  One block serves the G
//   query heads of a KV head together, so their rows share each K/V tile
//   load (rows are (group, query position) pairs);
// - ragged Sq, Sk and head_dim (<= 128) are masked in the kernel, so
//   decode's single query row needs no padding;
// - the TPU's sequential KV grid axis is a loop inside the block.
//
// Bound on an H100 SXM: bytes (q, k, v read once, o written once) for
// decode and for prefill at head_dim 64 with 512 positions.  This first
// kernel computes on the CUDA cores in float32 (no wgmma, no TMA): per KV
// tile, S = Q K^T into registers (each thread 4 rows x 4 columns, rows
// r + 16i and columns c + 16j so shared-memory reads do not conflict),
// the row max and sum by warp shuffles across the 16 threads of a row
// group, P through shared memory, then O += P V.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileK = 64;          // keys per KV tile
constexpr int kThreads = 256;       // 16 row groups x 16 column groups
constexpr int kMaxHeadDim = 128;
constexpr int kColsPerThread = kTileK / 16;
constexpr int kOutColsPerThread = kMaxHeadDim / 16;
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

// Q tile of TQ rows; each thread owns rows r + 16 i (i < TQ / 16).
template <typename T, int TQ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int32_t* __restrict__ lengths,
                       T* __restrict__ o, int64_t heads, int64_t kv_heads,
                       int64_t sq, int64_t sk, int d, int causal,
                       float scale) {
  constexpr int kRows = TQ / 16;
  extern __shared__ float smem[];
  const int ld = d + 1;                       // padded row stride
  float* qs = smem;                           // TQ x ld
  float* ks = qs + TQ * ld;                   // kTileK x ld
  float* vs = ks + kTileK * ld;               // kTileK x ld
  float* ps = vs + kTileK * ld;               // TQ x (kTileK + 1)

  const int64_t g = heads / kv_heads;
  const int64_t b = blockIdx.y / kv_heads, kvh = blockIdx.y % kv_heads;
  const int64_t rows = g * sq;                // (group, position) pairs
  const int64_t row0 = (int64_t)blockIdx.x * TQ;
  const int tid = threadIdx.x;
  const int r = tid / 16, c = tid % 16;

  // the last query position in this tile (decides the live KV prefix)
  const int64_t row_end = imin(row0 + TQ, rows) - 1;
  const int64_t q_last = (row0 / sq != row_end / sq) ? sq - 1 : row_end % sq;
  const int64_t len = imin((int64_t)lengths[b], sk);
  const int64_t limit = causal ? imin(len, q_last + (sk - sq) + 1) : len;

  const T* kb = k + (b * kv_heads + kvh) * sk * d;
  const T* vb = v + (b * kv_heads + kvh) * sk * d;
  for (int i = tid; i < TQ * d; i += kThreads) {
    const int lr = i / d, dd = i % d;
    const int64_t row = row0 + lr;
    float x = 0.0f;
    if (row < rows) {
      const int64_t h = kvh * g + row / sq, pos = row % sq;
      x = load_f32(q + ((b * heads + h) * sq + pos) * d + dd);
    }
    qs[lr * ld + dd] = x;
  }

  float m[kRows], l[kRows], acc[kRows][kOutColsPerThread];
  int64_t qpos[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
    const int64_t row = row0 + r + 16 * i;
    qpos[i] = row < rows ? row % sq : -1;
#pragma unroll
    for (int j = 0; j < kOutColsPerThread; ++j) acc[i][j] = 0.0f;
  }

  for (int64_t k0 = 0; k0 < limit; k0 += kTileK) {
    __syncthreads();                          // previous tile's reads done
    for (int i = tid; i < kTileK * d; i += kThreads) {
      const int kr = i / d, dd = i % d;
      const int64_t kp = k0 + kr;
      const bool in = kp < sk;
      ks[kr * ld + dd] = in ? load_f32(kb + kp * d + dd) : 0.0f;
      vs[kr * ld + dd] = in ? load_f32(vb + kp * d + dd) : 0.0f;
    }
    __syncthreads();

    float s[kRows][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) s[i][j] = 0.0f;
    for (int dd = 0; dd < d; ++dd) {
      float qv[kRows], kv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(r + 16 * i) * ld + dd];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) kv[j] = ks[(c + 16 * j) * ld + dd];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = kNegInf;
      bool live[kColsPerThread];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int64_t kp = k0 + c + 16 * j;
        live[j] = qpos[i] >= 0 && kp < len &&
                  (!causal || kp <= qpos[i] + (sk - sq));
        s[i][j] = live[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.0f;
        ps[(r + 16 * i) * (kTileK + 1) + c + 16 * j] = p;
        rs += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOutColsPerThread; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < kTileK; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(r + 16 * i) * (kTileK + 1) + kk];
#pragma unroll
      for (int j = 0; j < kOutColsPerThread; ++j) {
        const int dd = c + 16 * j;
        if (dd < d) {
          const float vv = vs[kk * ld + dd];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] += pv[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t row = row0 + r + 16 * i;
    if (row >= rows) continue;
    const int64_t h = kvh * g + row / sq, pos = row % sq;
    T* orow = o + ((b * heads + h) * sq + pos) * d;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kOutColsPerThread; ++j) {
      const int dd = c + 16 * j;
      if (dd < d) orow[dd] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int TQ>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, long long batch, long long heads, long long kv_heads,
           long long sq, long long sk, int d, int causal, float scale,
           cudaStream_t stream) {
  auto smem_for = [](int dim) {
    return sizeof(float) *
           ((size_t)(TQ + 2 * kTileK) * (dim + 1) + TQ * (kTileK + 1));
  };
  static bool opted_in = false;     // above 48 KB only after opting in
  if (!opted_in) {
    cudaFuncSetAttribute(flash_attention_kernel<T, TQ>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_for(kMaxHeadDim));
    opted_in = true;
  }
  const size_t smem = smem_for(d);
  const long long rows = heads / kv_heads * sq;
  const dim3 grid((unsigned)((rows + TQ - 1) / TQ),
                  (unsigned)(batch * kv_heads));
  flash_attention_kernel<T, TQ><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)lengths, (T*)o,
      heads, kv_heads, sq, sk, d, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* lengths,
             void* o, long long batch, long long heads, long long kv_heads,
             long long sq, long long sk, int d, int causal, float scale,
             cudaStream_t stream) {
  // a short query block (decode: G rows) takes 16-row tiles
  if (heads / kv_heads * sq <= 16)
    return launch<T, 16>(q, k, v, lengths, o, batch, heads, kv_heads, sq, sk,
                         d, causal, scale, stream);
  return launch<T, 64>(q, k, v, lengths, o, batch, heads, kv_heads, sq, sk, d,
                       causal, scale, stream);
}

}  // namespace

extern "C" int lm_flash_attention(const void* q, const void* k, const void* v,
                                  const void* lengths, void* o,
                                  long long batch, long long heads,
                                  long long kv_heads, long long sq,
                                  long long sk, long long d, int causal,
                                  float scale, int bf16, void* stream) {
  if (d < 1 || d > kMaxHeadDim) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, lengths, o, batch, heads, kv_heads,
                                   sq, sk, (int)d, causal, scale, s);
  return dispatch<float>(q, k, v, lengths, o, batch, heads, kv_heads, sq, sk,
                         (int)d, causal, scale, s);
}
