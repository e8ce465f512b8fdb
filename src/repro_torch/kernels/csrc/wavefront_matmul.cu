// Dynamically masked block matmul (the MoE expert GEMM), for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/wavefront_matmul/kernel.py
// (wavefront_matmul / _kernel): C = A @ B with a float32 accumulator and
// C in A's type, where a 128-row tile of A and C whose activity flag is 0
// skips its whole K loop and is written as zeros.  A leading batch axis
// (one matrix per expert) runs every expert of a layer in one launch;
// M, N and K may be ragged (the edge tiles are masked, nothing is padded).
//
// Three kernels of the product, one C entry point each; ops.route picks
// one by an explicit rule (never a fallback):
//
// - "wgmma" (bf16, M > 16, TMA-legal operands).  Bound at the MoE's
//   prefill shapes by the tensor cores and HBM about equally.  A block
//   owns one 128-row activity tile x 128 columns of one expert: an
//   inactive tile stores zeros and loads nothing.  One producer warp keeps
//   TMA loads of A (128 x 64, K-major) and B (64 x 128, N contiguous, so
//   MN-major: wgmma's transpose bit) in flight through a ring of 3 stages
//   of shared memory, each on its own pair of mbarriers (99 KB, so two
//   blocks share an SM and one's epilogue overlaps the other's loads:
//   faster than 4 stages and one block at K = 512); two consumer
//   warpgroups each run wgmma.m64n128k16 on 64 of the rows into float32
//   registers and round to bf16 in the epilogue.  The tensor maps are 3-D
//   over (expert, rows, cols), so TMA zero-fills the ragged edges of M and
//   K inside each expert.
// - "small_m" (M <= 16 rows per expert, float32 or bf16: decode).  Bound
//   by the bytes of B, which is read exactly once: a block owns one
//   (expert, 64-column slice); each thread streams 16-byte vectors of its
//   B rows through a private ring of cp.async stages and keeps float32
//   sums for its columns over all M rows (rounded up to 1, 2, 4, 8 or 16),
//   with A's rows in shared memory; the partial sums meet in a fixed order.
// - "simt" (the first design): the CUDA cores in float32, a
//   128 x 64 tile, a 16-deep K slab staged through shared memory.  It takes
//   float32 at M > 16 (TF32 tensor cores would break float32's tolerance)
//   and any operand TMA cannot take.
//
// A fourth kernel computes the gradient of the bf16 product in place
// (lm_wavefront_matmul_grad_wgmma, ops.route_bwd's "wgmma"; see its
// section below).  The gradient of other operands runs the three kernels
// above on transposed and padded copies (ops.py).
#include "hopper.cuh"
#include "hopper_wgmma.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ============================================================ route "simt"


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

constexpr int kSmemLimit = 227 * 1024;   // a block's most, opted in

// ========================================================= route "small_m"

constexpr int kSmThreads = 256;
constexpr int kSmCols = 64;      // columns a block owns
constexpr int kSmStages = 8;     // 16-byte copies in flight per thread
constexpr int kSmWarps = kSmThreads / 32;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void unpack(const uint4& u, float (&x)[4]) {
    x[0] = __uint_as_float(u.x); x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z); x[3] = __uint_as_float(u.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void unpack(const uint4& u, float (&x)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // bf16 -> f32 is exact: the high half
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};

inline size_t small_m_smem(int mt, long long k, size_t elem) {
  const size_t a = ((size_t)mt * k * elem + 15) / 16 * 16;
  return a + (size_t)kSmStages * kSmThreads * 16 +
         (size_t)kSmWarps * mt * kSmCols * sizeof(float);
}

template <typename T, int MT>
__global__ void __launch_bounds__(kSmThreads)
small_m_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const int32_t* __restrict__ active, T* __restrict__ c,
                      int m, int n, int k) {
  constexpr int kVec = Vec<T>::n;              // columns a 16-byte vector holds
  constexpr int kTpr = kSmCols / kVec;         // threads on one B row: 16 or 8
  constexpr int kRp = kSmThreads / kTpr;       // B rows a pass covers
  const int e = blockIdx.y, n0 = blockIdx.x * kSmCols;
  const int tid = threadIdx.x, cg = tid % kTpr, rg = tid / kTpr;
  const int col = n0 + cg * kVec;
  a += (int64_t)e * m * k;
  b += (int64_t)e * k * n;
  c += (int64_t)e * m * n;

  if (active[e] == 0) {                        // M <= 128: one activity tile
    for (int i = tid; i < m * kSmCols; i += kSmThreads) {
      const int r = i / kSmCols, cc = n0 + i % kSmCols;
      if (cc < n) c[(int64_t)r * n + cc] = from_f32<T>(0.0f);
    }
    return;
  }

  extern __shared__ __align__(16) uint8_t sm_raw[];
  T* as = reinterpret_cast<T*>(sm_raw);                          // MT x k
  uint4* ring = reinterpret_cast<uint4*>(
      sm_raw + ((size_t)MT * k * sizeof(T) + 15) / 16 * 16);      // stages x threads
  float* red = reinterpret_cast<float*>(ring + kSmStages * kSmThreads);

  for (int i = tid; i < MT * k; i += kSmThreads)
    as[i] = i < m * k ? a[i] : from_f32<T>(0.0f);

  const bool col_ok = col < n;
  const int passes = (k + kRp - 1) / kRp;
  auto issue = [&](int p) {
    const int row = p * kRp + rg;
    if (col_ok && p < passes && row < k)
      cp_async16(ring + (p % kSmStages) * kSmThreads + tid,
                 b + (int64_t)row * n + col);
    cp_async_commit();                         // one group per pass, even empty
  };
#pragma unroll
  for (int p = 0; p < kSmStages - 1; ++p) issue(p);
  __syncthreads();                             // A's rows are in

  float acc[MT][kVec];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[i][j] = 0.0f;

  for (int p = 0; p < passes; ++p) {
    issue(p + kSmStages - 1);                  // the slot read one pass ago
    cp_async_wait<kSmStages - 1>();            // pass p's copy has landed
    const int row = p * kRp + rg;
    if (row < k) {
      float bv[kVec];
      Vec<T>::unpack(ring[(p % kSmStages) * kSmThreads + tid], bv);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float av = load_f32(as + i * k + row);
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[i][j] += av * bv[j];
      }
    }
  }
  cp_async_wait<0>();

  // rows of one warp that share columns, then the warps, in a fixed order
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float x = acc[i][j];
#pragma unroll
      for (int o = kTpr; o < 32; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane < kTpr) red[(warp * MT + i) * kSmCols + cg * kVec + j] = x;
    }
  __syncthreads();
  for (int i = tid; i < m * kSmCols; i += kSmThreads) {
    const int r = i / kSmCols, cc = i % kSmCols;
    if (n0 + cc >= n) continue;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kSmWarps; ++w) sum += red[(w * MT + r) * kSmCols + cc];
    c[(int64_t)r * n + n0 + cc] = from_f32<T>(sum);
  }
}

template <typename T, int MT>
int launch_small_m(const void* a, const void* b, const void* active, void* c,
                   long long batch, long long m, long long n, long long k,
                   cudaStream_t stream) {
  const size_t smem = small_m_smem(MT, k, sizeof(T));
  static bool opted_in = false;      // above 48 KB only after opting in
  if (!opted_in) {
    cudaFuncSetAttribute(small_m_matmul_kernel<T, MT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemLimit);
    opted_in = true;
  }
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kSmCols - 1) / kSmCols), (unsigned)batch);
  small_m_matmul_kernel<T, MT><<<grid, kSmThreads, smem, stream>>>(
      (const T*)a, (const T*)b, (const int32_t*)active, (T*)c, (int)m, (int)n,
      (int)k);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_small_m(const void* a, const void* b, const void* active, void* c,
                     long long batch, long long m, long long n, long long k,
                     cudaStream_t s) {
  if (m <= 1) return launch_small_m<T, 1>(a, b, active, c, batch, m, n, k, s);
  if (m <= 2) return launch_small_m<T, 2>(a, b, active, c, batch, m, n, k, s);
  if (m <= 4) return launch_small_m<T, 4>(a, b, active, c, batch, m, n, k, s);
  if (m <= 8) return launch_small_m<T, 8>(a, b, active, c, batch, m, n, k, s);
  if (m <= 16) return launch_small_m<T, 16>(a, b, active, c, batch, m, n, k, s);
  return (int)cudaErrorInvalidValue;
}

// =========================================================== route "wgmma"

constexpr int kWgBM = 128;                     // the activity tile
constexpr int kWgBN = 128;
constexpr int kWgBK = 64;                      // 128 bytes of bf16: one swizzle row
constexpr int kWgStages = 3;            // 99 KB: two blocks an SM
constexpr int kWgConsumers = 2;                // warpgroups, 64 rows each
constexpr int kWgThreads = 128 * kWgConsumers + 32;   // + one producer warp
constexpr int kATileBytes = kWgBM * kWgBK * 2;        // 16 KB
constexpr int kBChunkBytes = kWgBK * 64 * 2;          // 64 K rows x 64 columns
constexpr int kStageBytes = kATileBytes + 2 * kBChunkBytes;
constexpr int kWgSmem = kWgStages * kStageBytes + 1024 + 2 * kWgStages * 8;

__global__ void __launch_bounds__(kWgThreads, 2)
wgmma_matmul_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const int32_t* __restrict__ active,
                    __nv_bfloat16* __restrict__ c, int m, int n, int k) {
  using namespace hopper;
  const int e = blockIdx.z, tile = blockIdx.y;
  const int m0 = tile * kWgBM, n0 = blockIdx.x * kWgBN;
  const int tid = threadIdx.x;
  c += (int64_t)e * m * n;

  if (active[e * gridDim.y + tile] == 0) {     // inactive: no loads, zeros
    for (int i = tid; i < kWgBM * kWgBN / 2; i += kWgThreads) {
      const int r = m0 + i / (kWgBN / 2), col = n0 + 2 * (i % (kWgBN / 2));
      if (r < m && col < n)
        *reinterpret_cast<__nv_bfloat162*>(c + (int64_t)r * n + col) =
            __floats2bfloat162_rn(0.0f, 0.0f);
    }
    return;
  }

  extern __shared__ uint8_t wg_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(wg_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWgStages * kStageBytes);
  uint64_t* empty = full + kWgStages;
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumers * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int k_tiles = (k + kWgBK - 1) / kWgBK;

  if (tid >= 128 * kWgConsumers) {             // the producer warp
    if (tid == 128 * kWgConsumers) {
      prefetch_map(&map_a);
      prefetch_map(&map_b);
      // a B chunk wholly past N is not loaded: it feeds only columns >= N,
      // which are never stored
      const bool second = n0 + 64 < n;
      const uint32_t bytes = kATileBytes + (second ? 2 : 1) * kBChunkBytes;
      int s = 0;
      uint32_t ph = 0;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(&empty[s], ph ^ 1);
        uint8_t* st = smem + s * kStageBytes;
        mbar_expect_tx(&full[s], bytes);
        tma_load_3d(st, &map_a, &full[s], kt * kWgBK, m0, e);
        tma_load_3d(st + kATileBytes, &map_b, &full[s], n0, kt * kWgBK, e);
        if (second)
          tma_load_3d(st + kATileBytes + kBChunkBytes, &map_b, &full[s],
                      n0 + 64, kt * kWgBK, e);
        if (++s == kWgStages) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  int s = 0, prev = -1;
  uint32_t ph = 0;
  for (int kt = 0; kt < k_tiles; ++kt) {
    mbar_wait(&full[s], ph);
    const uint8_t* a_t = smem + s * kStageBytes + wg * (64 * 128);
    const uint8_t* b_t = smem + s * kStageBytes + kATileBytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk)
      ss_m64n128k16<1>(acc, desc_b128(a_t + 32 * kk, 16, 1024),
                       desc_b128(b_t + 2048 * kk, kBChunkBytes, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();                           // the previous tile's products
    fence_regs(acc);
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = s;
    if (++s == kWgStages) { s = 0; ph ^= 1; }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // accumulator fragment: rows 16 warp + lane / 4 (+ 8), columns 8 j + 2
  // (lane % 4) (+ 1); N % 8 == 0, so a pair is wholly in or out
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < kWgBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r < m)
        *reinterpret_cast<__nv_bfloat162*>(c + (int64_t)r * n + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// ================================================== the gradient, "wgmma"
//
// dA = dC B^T under row_active and dB = A^T dC, both read from A, B and dC
// where they lie: no operand is transposed, padded or masked into a copy.
// A block owns a 128 x 256 tile of dA or of dB, and one launch may cover
// both products (dA's blocks first, then dB's).  The forward's pipeline,
// wider: one producer warp keeps TMA loads in flight through 4 stages of
// 48 KB (64 x 64 boxes, 128-byte swizzle; one block an SM) and two
// consumer warpgroups run wgmma.m64n256k16 on 64 rows each into float32,
// rounded to bf16 once, then stored by TMA from shared memory.  A 128 x
// 256 tile moves 48 KB a 64-deep stage for 4.2 MFLOP where the forward's
// 128 x 128 moves 32 KB for 2.1.
//
// - dA (M x K, contracting N): dC is the K-major A operand exactly as the
//   forward's A; B, stored (K, N) with N contiguous, is K-major for this
//   product (wgmma's B transpose bit 0), its 256 rows four 64-row boxes.
//   An inactive 128-row tile stores zeros and loads nothing.
// - dB (K x N, contracting the M rows): A, stored (M, K) with K
//   contiguous, is an MN-major A operand (the A transpose bit, which bf16
//   from shared memory allows), one 64-column box a warpgroup; dC is the
//   MN-major B, as the forward's B.  A 64-row stage of M inside an
//   inactive tile is neither loaded nor multiplied (so an expert with no
//   live tile writes zeros), and TMA's zero fill of the 3-D maps ends M
//   inside each expert.
//
// Bound by the tensor cores and HBM about equally at the MoE's training
// shapes (A, B and dC read once, dA and dB written once).

constexpr int kGrBox = 64;                      // a box: 64 rows x 128 bytes
constexpr int kGrBoxBytes = kGrBox * kGrBox * 2;
constexpr int kGrBM = 128;                      // two consumer warpgroups
constexpr int kGrBN = 256;                      // wgmma's widest N
constexpr int kGrStageBytes = (kGrBM + kGrBN) / kGrBox * kGrBoxBytes;
constexpr int kGrStages = 4;                    // 192 KB: one block an SM
constexpr int kGrSmem = kGrStages * kGrStageBytes + 1024 + 2 * kGrStages * 8;
static_assert(kGrBM * kGrBN * 2 <= kGrStages * kGrStageBytes,
              "C's tile is staged in the ring");

// One tile: the producer loads, per live stage, A's two 64-row (dA) or
// 64-column (dB) boxes and B's four; the consumers multiply, then stage C
// (``map_c``: dA's or dB's tensor map) in shared memory for TMA to store.
template <bool kDB>
__device__ __forceinline__ void grad_tile(
    const CUtensorMap* map_x, const CUtensorMap* map_y,
    const CUtensorMap* map_c, const int32_t* __restrict__ act, int e, int r0,
    int c0, int depth, uint8_t* smem) {
  using namespace hopper;
  const int tid = threadIdx.x;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kGrStages * kGrStageBytes);
  uint64_t* empty = full + kGrStages;
  if (tid == 0) {
    for (int s = 0; s < kGrStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumers * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int stages = (depth + kGrBox - 1) / kGrBox;
  // dB's stage kt lies in activity tile kt / 2: skipped where it is 0
  auto live = [&](int kt) { return !kDB || act[kt >> 1] != 0; };

  if (tid >= 128 * kWgConsumers) {             // the producer warp
    if (tid == 128 * kWgConsumers) {
      prefetch_map(map_x);
      prefetch_map(map_y);
      int s = 0;
      uint32_t ph = 0;
      for (int kt = 0; kt < stages; ++kt) {
        if (!live(kt)) continue;
        mbar_wait(&empty[s], ph ^ 1);
        uint8_t* st = smem + s * kGrStageBytes;
        mbar_expect_tx(&full[s], kGrStageBytes);
        const int d0 = kt * kGrBox;
        for (int h = 0; h < kGrBM / kGrBox; ++h) {
          uint8_t* x = st + h * kGrBoxBytes;
          if (kDB)    // A: (K cols, M rows) boxes
            tma_load_3d(x, map_x, &full[s], r0 + h * kGrBox, d0, e);
          else        // dC: (N cols, M rows) boxes
            tma_load_3d(x, map_x, &full[s], d0, r0 + h * kGrBox, e);
        }
        for (int h = 0; h < kGrBN / kGrBox; ++h) {
          uint8_t* y = st + (kGrBM / kGrBox + h) * kGrBoxBytes;
          if (kDB)    // dC: (N cols, M rows) boxes
            tma_load_3d(y, map_y, &full[s], c0 + h * kGrBox, d0, e);
          else        // B: (N cols, K rows) boxes
            tma_load_3d(y, map_y, &full[s], d0, c0 + h * kGrBox, e);
        }
        if (++s == kGrStages) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  int s = 0, prev = -1;
  uint32_t ph = 0;
  for (int kt = 0; kt < stages; ++kt) {
    if (!live(kt)) continue;
    mbar_wait(&full[s], ph);
    const uint8_t* a_t = smem + s * kGrStageBytes + wg * kGrBoxBytes;
    const uint8_t* b_t = smem + s * kGrStageBytes + 2 * kGrBoxBytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGrBox / 16; ++kk) {
      if (kDB)      // MN-major A and B: a k-step is 16 rows of 128 bytes
        ss_m64n256k16<1, 1>(acc, desc_b128(a_t + 2048 * kk, kGrBoxBytes, 1024),
                            desc_b128(b_t + 2048 * kk, kGrBoxBytes, 1024), 1);
      else          // K-major A and B: a k-step is 32 bytes of each row
        ss_m64n256k16<0, 0>(acc, desc_b128(a_t + 32 * kk, 16, 1024),
                            desc_b128(b_t + 32 * kk, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();                           // the previous stage's products
    fence_regs(acc);
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = s;
    if (++s == kGrStages) { s = 0; ph ^= 1; }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // both warpgroups are past their last product, so the ring is free: a
  // warpgroup's 64 rows go into four 64-column boxes in TMA's 128-byte
  // swizzle (the fragment's 8 rows a store land in 8 bank groups), and TMA
  // stores them, leaving out rows and columns past C's edge
  bar_sync<1, 128 * kWgConsumers>();
  uint8_t* out = smem + wg * (kGrBN / kGrBox) * kGrBoxBytes;
#pragma unroll
  for (int j = 0; j < kGrBN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);   // rows 16 warp + lane / 4 (+8)
    const int chunk = (col % 64) / 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * 16 + lane / 4 + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(
          out + col / 64 * kGrBoxBytes + row * 128 +
          ((chunk ^ (row & 7)) << 4) + (col % 8) * 2) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  fence_proxy_async();
  bar_sync<1, 128 * kWgConsumers>();
  if (tid % 128 == 0) {
    for (int box = 0; box < kGrBN / kGrBox; ++box)
      tma_store_3d(map_c, out + box * kGrBoxBytes, c0 + box * kGrBox,
                   r0 + wg * 64, e);
    bulk_store_wait();
  }
}

// blocks [0, da_blocks): dA tiles, (expert, row tile, column tile) with the
// column tile fastest; then dB tiles, (expert, K tile, N tile) alike
__global__ void __launch_bounds__(kWgThreads, 1)
wgmma_grad_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const __grid_constant__ CUtensorMap map_dc,
                  const __grid_constant__ CUtensorMap map_da,
                  const __grid_constant__ CUtensorMap map_db,
                  const int32_t* __restrict__ active,
                  __nv_bfloat16* __restrict__ da, int m, int n, int k,
                  long long da_blocks) {
  extern __shared__ uint8_t gr_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(gr_raw) + 1023) & ~uintptr_t(1023));
  const int m_tiles = (m + kGrBM - 1) / kGrBM;
  const long long blk = blockIdx.x;
  if (blk < da_blocks) {
    const int k_cols = (k + kGrBN - 1) / kGrBN;
    const int tile = (int)(blk / k_cols % m_tiles);
    const int e = (int)(blk / k_cols / m_tiles);
    const int r0 = tile * kGrBM, c0 = (int)(blk % k_cols) * kGrBN;
    if (active[(int64_t)e * m_tiles + tile] == 0) {   // no loads, zeros
      __nv_bfloat16* c = da + (int64_t)e * m * k;
      for (int i = threadIdx.x; i < kGrBM * kGrBN / 2; i += kWgThreads) {
        const int r = r0 + i / (kGrBN / 2), col = c0 + 2 * (i % (kGrBN / 2));
        if (r < m && col < k)
          *reinterpret_cast<__nv_bfloat162*>(c + (int64_t)r * k + col) =
              __floats2bfloat162_rn(0.0f, 0.0f);
      }
      return;
    }
    grad_tile<false>(&map_dc, &map_b, &map_da, nullptr, e, r0, c0, n, smem);
  } else {
    const long long i = blk - da_blocks;
    const int n_cols = (n + kGrBN - 1) / kGrBN;
    const int k_rows = (k + kGrBM - 1) / kGrBM;
    const int e = (int)(i / n_cols / k_rows);
    grad_tile<true>(&map_a, &map_dc, &map_db, active + (int64_t)e * m_tiles,
                    e, (int)(i / n_cols % k_rows) * kGrBM,
                    (int)(i % n_cols) * kGrBN, m, smem);
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

// bf16 only; the caller has checked TMA's rules: 16-byte-aligned bases,
// K % 8 == 0 and N % 8 == 0 (row strides multiples of 16 bytes).
extern "C" int lm_wavefront_matmul_wgmma(const void* a, const void* b,
                                         const void* active, void* c,
                                         long long batch, long long m,
                                         long long n, long long k,
                                         void* stream) {
  CUtensorMap map_a, map_b;
  if (!hopper::make_map_3d(&map_a, a, k, m, batch, k, m * k, kWgBM) ||
      !hopper::make_map_3d(&map_b, b, n, k, batch, n, k * n, kWgBK))
    return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    cudaFuncSetAttribute(wgmma_matmul_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
    opted_in = true;
  }
  const dim3 grid((unsigned)((n + kWgBN - 1) / kWgBN),
                  (unsigned)((m + kWgBM - 1) / kWgBM), (unsigned)batch);
  wgmma_matmul_kernel<<<grid, kWgThreads, kWgSmem, (cudaStream_t)stream>>>(
      map_a, map_b, (const int32_t*)active, (__nv_bfloat16*)c, (int)m, (int)n,
      (int)k);
  return (int)cudaGetLastError();
}

// M <= 16; 16-byte-aligned bases and N * sizeof(T) % 16 == 0.
extern "C" int lm_wavefront_matmul_small_m(const void* a, const void* b,
                                           const void* active, void* c,
                                           long long batch, long long m,
                                           long long n, long long k, int bf16,
                                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return dispatch_small_m<__nv_bfloat16>(a, b, active, c, batch, m, n, k, s);
  return dispatch_small_m<float>(a, b, active, c, batch, m, n, k, s);
}

// The gradient in place: ``which`` bit 0 computes dA, bit 1 dB, in one
// launch.  bf16 only; the caller has checked TMA's rules for A, B and dC
// (16-byte-aligned bases, K % 8 == 0, N % 8 == 0; dA and dB are fresh)
// and that M, N, K > 0.  Autograd's backward thread may have no current
// context yet: cudaSetDevice makes the device's primary context current,
// without which cuTensorMapEncodeTiled encodes no map.
extern "C" int lm_wavefront_matmul_grad_wgmma(
    const void* a, const void* b, const void* dc, const void* active,
    void* da, void* db, long long batch, long long m, long long n,
    long long k, int which, void* stream) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  // dA has A's geometry and dB B's; a product not asked for gets a map of
  // its operand, which it never stores to
  CUtensorMap map_a, map_b, map_dc, map_da, map_db;
  if (!hopper::make_map_3d(&map_a, a, k, m, batch, k, m * k, kGrBox) ||
      !hopper::make_map_3d(&map_b, b, n, k, batch, n, k * n, kGrBox) ||
      !hopper::make_map_3d(&map_dc, dc, n, m, batch, n, m * n, kGrBox) ||
      !hopper::make_map_3d(&map_da, (which & 1) ? da : a, k, m, batch, k,
                           m * k, kGrBox) ||
      !hopper::make_map_3d(&map_db, (which & 2) ? db : b, n, k, batch, n,
                           k * n, kGrBox))
    return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    cudaFuncSetAttribute(wgmma_grad_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kGrSmem);
    opted_in = true;
  }
  const long long mt = (m + kGrBM - 1) / kGrBM, kr = (k + kGrBM - 1) / kGrBM,
                  kc = (k + kGrBN - 1) / kGrBN, nc = (n + kGrBN - 1) / kGrBN;
  const long long da_blocks = (which & 1) ? batch * mt * kc : 0;
  const long long blocks = da_blocks + ((which & 2) ? batch * kr * nc : 0);
  if (blocks == 0 || blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  wgmma_grad_kernel<<<(unsigned)blocks, kWgThreads, kGrSmem,
                      (cudaStream_t)stream>>>(
      map_a, map_b, map_dc, map_da, map_db, (const int32_t*)active,
      (__nv_bfloat16*)da, (int)m, (int)n, (int)k, da_blocks);
  return (int)cudaGetLastError();
}
