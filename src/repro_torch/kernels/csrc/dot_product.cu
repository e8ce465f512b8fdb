// The eGPU DOT/SUM extension unit, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/dot_product/kernel.py
// (dot_product / _kernel): the sum over the active 8-row tiles of a * b,
// float32 or bfloat16 inputs upcast to float32, one float32 result.  The
// TPU carried one accumulator across a sequential grid; blocks on a GPU
// run in no order, so here one block owns one sum (a leading batch axis
// gives one sum per eGPU core) and the grid's sequence becomes a loop
// inside the block.  The order is fixed to the reference's det_sum
// (repro/core/semantics.py): each lane accumulates its rows in order,
// starting from the first active row's product, then the lanes are
// reduced by the halving tree acc[:s] + acc[s:2s], the left operand kept
// left (x86 NaN selection keeps the first operand).  With 16 lanes the
// result is bit-identical to det_sum.  A batch element with no active
// tile sums to +0.
//
// Bound on an H100 SXM: bytes (each input read once, four bytes out per
// sum) at large sizes; on the eGPU main path a call reads (B, T/16, 16)
// -- a few KB -- so the sequential row loop and the launch dominate.
// Design: one thread per lane, rows in order, tree in shared memory.
#include "egpu_fp32.cuh"

namespace {

constexpr int kTileRows = 8;

__device__ __forceinline__ uint32_t load_bits(const void* p, int64_t i, int bf16) {
  if (bf16) return ((uint32_t)((const uint16_t*)p)[i]) << 16;   // exact upcast
  return ((const uint32_t*)p)[i];
}

__global__ void dot_product_kernel(const void* __restrict__ a,
                                   const void* __restrict__ b,
                                   const int32_t* __restrict__ active,
                                   uint32_t* __restrict__ out,
                                   int64_t rows, int64_t lanes, int bf16) {
  extern __shared__ uint32_t acc[];
  const int64_t core = blockIdx.x;
  const int64_t tiles = (rows + kTileRows - 1) / kTileRows;
  const int lane = threadIdx.x;
  const int64_t base = core * rows * lanes;
  uint32_t s = 0;                 // +0 when no row is active
  bool started = false;
  for (int64_t r = 0; r < rows; ++r) {
    if (active[core * tiles + r / kTileRows] == 0) continue;
    const int64_t i = base + r * lanes + lane;
    const uint32_t p = egpu::mul(load_bits(a, i, bf16), load_bits(b, i, bf16));
    s = started ? egpu::add(s, p) : p;
    started = true;
  }
  acc[lane] = s;
  __syncthreads();
  for (int h = (int)lanes / 2; h >= 1; h /= 2) {
    uint32_t v = 0;
    if (lane < h) v = egpu::add(acc[lane], acc[lane + h]);
    __syncthreads();
    if (lane < h) acc[lane] = v;
    __syncthreads();
  }
  if (lane == 0) out[core] = acc[0];
}

}  // namespace

extern "C" int egpu_dot_product(const void* a, const void* b,
                                const void* active, void* out,
                                long long batch, long long rows,
                                long long lanes, int bf16, void* stream) {
  if (batch > 0) {
    dot_product_kernel<<<(unsigned)batch, (unsigned)lanes,
                         (size_t)lanes * sizeof(uint32_t),
                         (cudaStream_t)stream>>>(
        a, b, (const int32_t*)active, (uint32_t*)out, rows, lanes, bf16);
  }
  return (int)cudaGetLastError();
}
