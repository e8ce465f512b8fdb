// Dynamically masked block matmul (the MoE expert GEMM), for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/wavefront_matmul/kernel.py
// (wavefront_matmul / _kernel): C = A @ B with a float32 accumulator and
// C in A's type, where a 128-row tile of A and C whose activity flag is 0
// skips its whole K loop and is written as zeros.  A leading batch axis
// (one matrix per expert) runs every expert of a layer in one launch;
// M, N and K may be ragged (the edge tiles are masked, nothing is padded).
//
// Bound on an H100 SXM: at the MoE's shapes (M = capacity, K and N =
// d_model or expert d_ff, bf16) the FLOPs over the bf16 tensor-core peak
// and the bytes over HBM bandwidth are about equal.  This first kernel
// runs on the CUDA cores in float32 (no wgmma, no TMA), so its own limit
// is the CUDA cores' FMA rate: a 128 x 64 block tile, a 16-deep K slab
// staged through shared memory (bf16 upcast on load), 8 x 4 outputs a
// thread.  Tensor cores are a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 128;   // the activity tile, as on the TPU
constexpr int kTileN = 64;
constexpr int kTileK = 16;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kTileM / 16;   // 8
constexpr int kColsPerThread = kTileN / 16;   // 4

template <typename T> __device__ __forceinline__ float load_f32(const T* p);
template <> __device__ __forceinline__ float load_f32(const float* p) { return *p; }
template <> __device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32(float x) {
  return __float2bfloat16(x);   // round to nearest even, as astype does
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wavefront_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        const int32_t* __restrict__ active,
                        T* __restrict__ c, int64_t m, int64_t n, int64_t k) {
  const int64_t e = blockIdx.z;
  const int64_t tile = blockIdx.y;
  const int64_t m0 = tile * kTileM, n0 = (int64_t)blockIdx.x * kTileN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t m_tiles = (m + kTileM - 1) / kTileM;
  a += e * m * k;
  b += e * k * n;
  c += e * m * n;

  if (active[e * m_tiles + tile] == 0) {      // inactive: no K loop, zeros
    for (int i = tid; i < kTileM * kTileN; i += kThreads) {
      const int64_t r = m0 + i / kTileN, col = n0 + i % kTileN;
      if (r < m && col < n) c[r * n + col] = from_f32<T>(0.0f);
    }
    return;
  }

  __shared__ float as[kTileK][kTileM + 1];    // A slab, k-major, padded
  __shared__ float bs[kTileK][kTileN];
  float acc[kRowsPerThread][kColsPerThread] = {};

  for (int64_t k0 = 0; k0 < k; k0 += kTileK) {
    // A: 128 x 16 elements, 8 per thread; consecutive threads walk k
    for (int i = tid; i < kTileM * kTileK; i += kThreads) {
      const int r = i / kTileK, kk = i % kTileK;
      const int64_t gr = m0 + r, gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k) ? load_f32(a + gr * k + gk) : 0.0f;
    }
    // B: 16 x 64 elements, 4 per thread; consecutive threads walk n
    for (int i = tid; i < kTileK * kTileN; i += kThreads) {
      const int kk = i / kTileN, col = i % kTileN;
      const int64_t gk = k0 + kk, gc = n0 + col;
      bs[kk][col] = (gk < k && gc < n) ? load_f32(b + gk * n + gc) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float av[kRowsPerThread], bv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t r = m0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int64_t col = n0 + tx + 16 * j;
      if (col < n) c[r * n + col] = from_f32<T>(acc[i][j]);
    }
  }
}

}  // namespace

extern "C" int lm_wavefront_matmul(const void* a, const void* b,
                                   const void* active, void* c,
                                   long long batch, long long m, long long n,
                                   long long k, int bf16, void* stream) {
  const dim3 grid((unsigned)((n + kTileN - 1) / kTileN),
                  (unsigned)((m + kTileM - 1) / kTileM), (unsigned)batch);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    wavefront_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)b,
        (const int32_t*)active, (__nv_bfloat16*)c, m, n, k);
  } else {
    wavefront_matmul_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)a, (const float*)b, (const int32_t*)active, (float*)c,
        m, n, k);
  }
  return (int)cudaGetLastError();
}
