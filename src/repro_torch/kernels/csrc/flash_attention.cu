// Flash attention with KV-tile skipping and grouped-query heads, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (flash_attention / _kernel): online-softmax attention with float32 m, l
// and accumulator; keys masked by per-batch lengths and, when causal, by
// the decode-style rule kpos <= qpos + (Sk - Sq); KV tiles at or past
// min(len, q_last + 1 + (Sk - Sq)) never loaded; -1e30 for masked scores,
// l clamped at 1e-30, output in q's type.
//
// Differences from the TPU kernel, none of which changes the function:
// - grouped-query attention: q has H heads, k and v KV heads, and query
//   head h reads KV head h / G (G = H / KV).  A block serves query heads
//   of one KV head together, so they share each K/V tile load;
// - ragged Sq, Sk and head_dim (<= 128) are masked in the kernel, so
//   decode's single query row needs no padding;
// - the TPU's sequential KV grid axis is a loop inside the block.
//
// Bound on an H100 SXM: bytes (q, k, v read once, o written once) for
// decode and for prefill at head_dim 64 with 512 positions.  Two kernels,
// one C entry point each; ops.route picks one by an explicit rule:
//
// - "wgmma" (bf16, head_dim a multiple of 16 up to 128, more than 16 query
//   rows, TMA-legal q/k/v: prefill).  A block holds 64 query positions of
//   up to 3 query heads of one KV head (2 at head_dim > 64), one consumer
//   warpgroup per head, so
//   their causal limits are equal and each K/V tile is read once for all
//   of them.  A producer warp loads the Q tiles and then 64-key K and V
//   tiles by TMA into a double-buffered ring (mbarriers), stopping at the
//   live prefix: dead tiles are never loaded.  S = Q K^T is a wgmma from
//   shared memory (K as the K-major B operand); mask, scale, running max
//   and sum stay on the accumulator fragments, the row reductions by quad
//   shuffles; O += P V is a wgmma with P from registers and V as the
//   MN-major B operand (the transpose bit).  P is rounded to bf16 as a hi
//   + lo pair, P_hi = bf16(P), P_lo = bf16(P - P_hi), two wgmmas into the
//   same float32 accumulator: one bf16 P alone breaks the bf16 tolerance.
//   A masked key has P = 0 exactly, P_lo too, so keys past a length change
//   no bit.  head_dim below 64 is read as 64 with TMA's zero fill.
// - "simt" (the first design): the CUDA cores in float32.  Per KV tile, S =
//   Q K^T into registers (each thread 4 rows x 4 columns, rows r + 16i and
//   columns c + 16j so shared-memory reads do not conflict), the row max
//   and sum by warp shuffles across the 16 threads of a row group, P
//   through shared memory, then O += P V.  It takes float32, head_dim not
//   a multiple of 16 and decode's rows.
//
// The partial output (lm_flash_attention given an ``lse`` pointer): decode's
// rows (at most 16 per KV head) on the "simt" or "split" route, the output
// in float32 and each row's log-sum-exp m + log(l) beside it (-inf and a
// zero output for a row with no live key), so that attention over a cache
// split by key ranges merges exactly: o = sum_r exp(lse_r - M) o_r /
// sum_r exp(lse_r - M) with M = max_r lse_r.  The kernel is the same
// template; only the output's type and the extra store differ.
#include "hopper.cuh"
#include "hopper_wgmma.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ============================================================= route "simt"


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
// split_tiles > 0 (route "split"): block z of gridDim.z takes KV tiles
// [z split_tiles, (z + 1) split_tiles) of the live prefix, writes its
// partial (m, l, acc) rows to ``part``, and the last block of its (batch,
// KV head) to arrive (``counters``, reset by that block) combines the
// partials in the order z = 0, 1, ..., so the result does not depend on
// which block finishes first.  TO: the output's type (T, or float for the
// partial output); ``lse`` (may be null): each row's m + log(l).
template <typename T, typename TO, int TQ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int32_t* __restrict__ lengths,
                       TO* __restrict__ o, float* __restrict__ lse,
                       int64_t heads, int64_t kv_heads,
                       int64_t sq, int64_t sk, int d, int causal,
                       float scale, int split_tiles, float* __restrict__ part,
                       int32_t* __restrict__ counters) {
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

  int64_t k_begin = 0, k_end = limit;
  if (split_tiles > 0) {
    k_begin = (int64_t)blockIdx.z * split_tiles * kTileK;
    k_end = imin(limit, k_begin + (int64_t)split_tiles * kTileK);
  }
  for (int64_t k0 = k_begin; k0 < k_end; k0 += kTileK) {
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

  if (split_tiles > 0) {
    // this block's partial rows: m, l, then acc[d]
    const int splits = gridDim.z;
    const int64_t slot = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
    float* mine = part + ((slot * splits + blockIdx.z) * TQ) * (d + 2);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float* pr = mine + (r + 16 * i) * (d + 2);
      if (c == 0) { pr[0] = m[i]; pr[1] = l[i]; }
#pragma unroll
      for (int j = 0; j < kOutColsPerThread; ++j)
        if (c + 16 * j < d) pr[2 + c + 16 * j] = acc[i][j];
    }
    __threadfence();
    __syncthreads();
    __shared__ int last;
    if (tid == 0) last = atomicAdd(&counters[slot], 1) == splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const float* all = part + slot * splits * TQ * (d + 2);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int lr = r + 16 * i;
      float mx = kNegInf;
      for (int z = 0; z < splits; ++z)
        mx = fmaxf(mx, __ldcg(all + (z * TQ + lr) * (d + 2)));
      float sum = 0.0f, out[kOutColsPerThread] = {};
      for (int z = 0; z < splits; ++z) {
        const float* pr = all + (z * TQ + lr) * (d + 2);
        const float w = expf(__ldcg(pr) - mx);
        sum += __ldcg(pr + 1) * w;
#pragma unroll
        for (int j = 0; j < kOutColsPerThread; ++j)
          if (c + 16 * j < d) out[j] += __ldcg(pr + 2 + c + 16 * j) * w;
      }
      m[i] = mx;
      l[i] = sum;
#pragma unroll
      for (int j = 0; j < kOutColsPerThread; ++j) acc[i][j] = out[j];
    }
    if (tid == 0) counters[slot] = 0;         // ready for the next launch
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t row = row0 + r + 16 * i;
    if (row >= rows) continue;
    const int64_t h = kvh * g + row / sq, pos = row % sq;
    TO* orow = o + ((b * heads + h) * sq + pos) * d;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kOutColsPerThread; ++j) {
      const int dd = c + 16 * j;
      if (dd < d) orow[dd] = from_f32<TO>(acc[i][j] * inv);
    }
    if (lse != nullptr && c == 0)
      lse[(b * heads + h) * sq + pos] =
          l[i] > 0.0f ? m[i] + logf(l[i]) : -INFINITY;
  }
}

template <typename T, typename TO, int TQ>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, float* lse, long long batch, long long heads,
           long long kv_heads, long long sq, long long sk, int d, int causal,
           float scale, int split_tiles, void* part, void* counters,
           cudaStream_t stream) {
  auto smem_for = [](int dim) {
    return sizeof(float) *
           ((size_t)(TQ + 2 * kTileK) * (dim + 1) + TQ * (kTileK + 1));
  };
  static bool opted_in = false;     // above 48 KB only after opting in
  if (!opted_in) {
    cudaFuncSetAttribute(flash_attention_kernel<T, TO, TQ>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_for(kMaxHeadDim));
    opted_in = true;
  }
  const size_t smem = smem_for(d);
  const long long rows = heads / kv_heads * sq;
  const long long tiles = (sk + kTileK - 1) / kTileK;
  const unsigned splits =
      split_tiles > 0 ? (unsigned)((tiles + split_tiles - 1) / split_tiles) : 1;
  const dim3 grid((unsigned)((rows + TQ - 1) / TQ),
                  (unsigned)(batch * kv_heads), splits);
  flash_attention_kernel<T, TO, TQ><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)lengths, (TO*)o,
      lse, heads, kv_heads, sq, sk, d, causal, scale, split_tiles,
      (float*)part, (int32_t*)counters);
  return (int)cudaGetLastError();
}

// lse null: o in T; else o in float32 with lse beside it (decode's rows)
template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* lengths,
             void* o, float* lse, long long batch, long long heads,
             long long kv_heads, long long sq, long long sk, int d, int causal,
             float scale, int split_tiles, void* part, void* counters,
             cudaStream_t stream) {
  const bool decode = heads / kv_heads * sq <= 16;
  if (lse != nullptr)
    return decode ? launch<T, float, 16>(q, k, v, lengths, o, lse, batch,
                                         heads, kv_heads, sq, sk, d, causal,
                                         scale, split_tiles, part, counters,
                                         stream)
                  : (int)cudaErrorInvalidValue;
  // a short query block (decode: G rows) takes 16-row tiles
  if (decode)
    return launch<T, T, 16>(q, k, v, lengths, o, nullptr, batch, heads,
                            kv_heads, sq, sk, d, causal, scale, split_tiles,
                            part, counters, stream);
  if (split_tiles > 0) return (int)cudaErrorInvalidValue;
  return launch<T, T, 64>(q, k, v, lengths, o, nullptr, batch, heads,
                          kv_heads, sq, sk, d, causal, scale, 0, nullptr,
                          nullptr, stream);
}


// ============================================================ route "wgmma"

constexpr int kFaRows = 64;                // query positions a block holds
constexpr int kFaKeys = 64;                // keys in a K/V tile
constexpr int kFaChunk = 64 * 64 * 2;      // 64 rows x 128 bytes (64 bf16)

// DC: head_dim in 64-wide chunks, 1 (d <= 64) or 2 (d <= 128).  Consumer
// warpgroups (query heads) a block: 3, the G of the granite serve, at
// d <= 64; 2 at d <= 128, whose accumulators would spill at 3 (ptxas caps
// a 416-thread block at 128 registers a thread).
template <int DC>
__host__ __device__ constexpr int fa_heads() { return DC == 1 ? 3 : 2; }

template <int DC>
__host__ __device__ constexpr int fa_smem() {
  return (fa_heads<DC>() + 4) * DC * kFaChunk + 1024 + 8 * 8;
}

template <int DC>
__global__ void __launch_bounds__(128 * fa_heads<DC>() + 32, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const int32_t* __restrict__ lengths,
                __nv_bfloat16* __restrict__ o, int heads, int kv_heads, int sq,
                int sk, int d, int causal, float scale) {
  using namespace hopper;
  constexpr int kTile = DC * kFaChunk;     // one head's Q, or one K or V tile
  constexpr int kFaHeads = fa_heads<DC>();
  const int g = heads / kv_heads;
  const int b = blockIdx.y / kv_heads, kvh = blockIdx.y % kv_heads;
  const int h0 = blockIdx.z * kFaHeads;
  const int nw_launch = g < kFaHeads ? g : kFaHeads;
  const int nw = g - h0 < kFaHeads ? g - h0 : kFaHeads;   // heads here
  const int q_tiles = (sq + kFaRows - 1) / kFaRows;
  // causal: the longest rows first, so the last wave is short
  const int q0 = (causal ? q_tiles - 1 - (int)blockIdx.x : (int)blockIdx.x) * kFaRows;
  const int q_last = min(q0 + kFaRows, sq) - 1;
  const int len = min(lengths[b], sk);
  const int limit = causal ? min(len, q_last + (sk - sq) + 1) : len;
  const int n_tiles = limit > 0 ? (limit + kFaKeys - 1) / kFaKeys : 0;
  const int tid = threadIdx.x;

  extern __shared__ uint8_t fa_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(fa_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;                                  // kFaHeads x kTile
  uint8_t* ks = qs + kFaHeads * kTile;                 // 2 stages x kTile
  uint8_t* vs = ks + 2 * kTile;                        // 2 stages x kTile
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + 2 * kTile);
  uint64_t* q_bar = bars;
  uint64_t* full = bars + 1;                           // [2]
  uint64_t* empty = bars + 3;                          // [2]
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * nw);        // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128 * nw_launch) {            // the producer warp
    if (tid == 128 * nw_launch) {
      prefetch_map(&map_q);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      mbar_expect_tx(q_bar, nw * kTile);
      for (int i = 0; i < nw; ++i)
        for (int c = 0; c < DC; ++c)
          tma_load_3d(qs + i * kTile + c * kFaChunk, &map_q, q_bar, 64 * c, q0,
                      b * heads + kvh * g + h0 + i);
      int s = 0;
      uint32_t ph = 0;
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], 2 * kTile);
        for (int c = 0; c < DC; ++c) {
          tma_load_3d(ks + s * kTile + c * kFaChunk, &map_k, &full[s], 64 * c,
                      t * kFaKeys, b * kv_heads + kvh);
          tma_load_3d(vs + s * kTile + c * kFaChunk, &map_v, &full[s], 64 * c,
                      t * kFaKeys, b * kv_heads + kvh);
        }
        if (++s == 2) { s = 0; ph ^= 1; }
      }
    }
    return;
  }
  const int wg = tid / 128;
  if (wg >= nw) return;                    // the last head group is short

  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int head = kvh * g + h0 + wg;
  const int qp0 = q0 + warp * 16 + lane / 4;   // rows qp0 and qp0 + 8
  const int shift = sk - sq;
  const uint8_t* q_t = qs + wg * kTile;
  float acc[32 * DC];
#pragma unroll
  for (int i = 0; i < 32 * DC; ++i) acc[i] = 0.0f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.0f, 0.0f};
  mbar_wait(q_bar, 0);

  int s = 0;
  uint32_t ph = 0;
  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(&full[s], ph);
    const uint8_t* k_t = ks + s * kTile;
    const uint8_t* v_t = vs + s * kTile;

    // S = Q K^T over head_dim in k-steps of 16
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * DC; ++kk) {
      const int off = (kk / 4) * kFaChunk + (kk % 4) * 32;
      ss_m64n64k16<0>(sc, desc_b128(q_t + off, 16, 1024),
                      desc_b128(k_t + off, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // fragment i: row qp0 + 8 ((i >> 1) & 1), key 8 (i >> 2) + 2 (lane % 4)
    // + (i & 1) of this tile
    const int k0 = t * kFaKeys;
    uint32_t live = 0;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      const int qp = qp0 + 8 * hh;
      const int key = k0 + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
      const bool on = qp < sq && key < len && (!causal || key <= qp + shift);
      live |= (uint32_t)on << i;
      sc[i] = on ? sc[i] * scale : kNegInf;
      mx[hh] = fmaxf(mx[hh], sc[i]);
    }
    float m_new[2], rs[2] = {0.0f, 0.0f}, alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      m_new[hh] = fmaxf(m_r[hh], mx[hh]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      sc[i] = (live >> i) & 1u ? expf(sc[i] - m_new[hh]) : 0.0f;
      rs[hh] += sc[i];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
      alpha[hh] = expf(m_r[hh] - m_new[hh]);
      l_r[hh] = l_r[hh] * alpha[hh] + rs[hh];
      m_r[hh] = m_new[hh];
    }
#pragma unroll
    for (int i = 0; i < 32 * DC; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V, P as bf16 hi + lo, each from registers in the A layout
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < kFaKeys / 16; ++u) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = sc[8 * u + 2 * r], x1 = sc[8 * u + 2 * r + 1];
        const __nv_bfloat16 b0 = __float2bfloat16(x0), b1 = __float2bfloat16(x1);
        hi[r] = pack_bf16(__bfloat162float(b0), __bfloat162float(b1));
        lo[r] = pack_bf16(x0 - __bfloat162float(b0), x1 - __bfloat162float(b1));
      }
      const uint64_t dv = desc_b128(v_t + u * 16 * 128, kFaChunk, 1024);
      if constexpr (DC == 1) {
        rs_m64n64k16<1>(acc, hi, dv, 1);
        rs_m64n64k16<1>(acc, lo, dv, 1);
      } else {
        rs_m64n128k16<1>(acc, hi, dv, 1);
        rs_m64n128k16<1>(acc, lo, dv, 1);
      }
    }
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
    if (qp >= sq) continue;
    const float inv = 1.0f / fmaxf(l_r[hh], 1e-30f);
    __nv_bfloat16* orow = o + (((int64_t)b * heads + head) * sq + qp) * d;
#pragma unroll
    for (int j = 0; j < 8 * DC; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * hh] * inv, acc[4 * j + 2 * hh + 1] * inv);
    }
  }
}

template <int DC>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* lengths, void* o, long long batch, long long heads,
                 long long kv_heads, long long sq, long long sk, int d,
                 int causal, float scale, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  if (!hopper::make_map_3d(&map_q, q, d, sq, batch * heads, d, sq * d, 64) ||
      !hopper::make_map_3d(&map_k, k, d, sk, batch * kv_heads, d, sk * d, 64) ||
      !hopper::make_map_3d(&map_v, v, d, sk, batch * kv_heads, d, sk * d, 64))
    return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    cudaFuncSetAttribute(fa_wgmma_kernel<DC>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         fa_smem<DC>());
    opted_in = true;
  }
  constexpr int kFaHeads = fa_heads<DC>();
  const long long g = heads / kv_heads;
  const int nw = (int)(g < kFaHeads ? g : kFaHeads);
  const dim3 grid((unsigned)((sq + kFaRows - 1) / kFaRows),
                  (unsigned)(batch * kv_heads),
                  (unsigned)((g + kFaHeads - 1) / kFaHeads));
  fa_wgmma_kernel<DC><<<grid, 128 * nw + 32, fa_smem<DC>(), stream>>>(
      map_q, map_k, map_v, (const int32_t*)lengths, (__nv_bfloat16*)o,
      (int)heads, (int)kv_heads, (int)sq, (int)sk, d, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// lse (may be null): the partial output, o in float32 and each row's
// log-sum-exp in lse (B, H, Sq), decode's rows only.
extern "C" int lm_flash_attention(const void* q, const void* k, const void* v,
                                  const void* lengths, void* o, void* lse,
                                  long long batch, long long heads,
                                  long long kv_heads, long long sq,
                                  long long sk, long long d, int causal,
                                  float scale, int bf16, int split_tiles,
                                  void* part, void* counters, void* stream) {
  if (d < 1 || d > kMaxHeadDim) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, lengths, o, (float*)lse, batch,
                                   heads, kv_heads, sq, sk, (int)d, causal,
                                   scale, split_tiles, part, counters, s);
  return dispatch<float>(q, k, v, lengths, o, (float*)lse, batch, heads,
                         kv_heads, sq, sk, (int)d, causal, scale, split_tiles,
                         part, counters, s);
}

// bf16, head_dim % 16 == 0 and <= 128, 16-byte-aligned bases (checked by
// the caller, ops.route).
extern "C" int lm_flash_attention_wgmma(const void* q, const void* k,
                                        const void* v, const void* lengths,
                                        void* o, long long batch,
                                        long long heads, long long kv_heads,
                                        long long sq, long long sk,
                                        long long d, int causal, float scale,
                                        void* stream) {
  if (d < 16 || d > kMaxHeadDim || d % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 64)
    return launch_wgmma<1>(q, k, v, lengths, o, batch, heads, kv_heads, sq, sk,
                           (int)d, causal, scale, s);
  return launch_wgmma<2>(q, k, v, lengths, o, batch, heads, kv_heads, sq, sk,
                         (int)d, causal, scale, s);
}
