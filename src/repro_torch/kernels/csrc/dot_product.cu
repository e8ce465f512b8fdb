// The eGPU DOT/SUM extension unit, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/dot_product/kernel.py
// (dot_product / _kernel): the sum over the active 8-row tiles of a * b,
// float32 or bfloat16 inputs upcast to float32, one float32 result.  The
// TPU carried one accumulator across a sequential grid; blocks on a GPU
// run in no order, so here one group of threads owns one sum and the
// grid's sequence becomes a loop inside it.  The order is fixed to the
// reference's det_sum (repro/core/semantics.py): each lane accumulates
// its rows in order, starting from the first active row's product, then
// the lanes are reduced by the halving tree acc[:s] + acc[s:2s], the left
// operand kept left (x86 NaN selection keeps the first operand).  With 16
// lanes the result is bit-identical to det_sum.  Two entries share the
// arithmetic (egpu::mul, egpu::add, see egpu_fp32.cuh):
//
// * egpu_dot_product, the "tile" route: the TPU kernel's own function,
//   one block a sum (a leading batch axis gives one sum per eGPU core),
//   one thread a lane, the tree in shared memory.  A batch element with no
//   active tile sums to +0.
//
// * egpu_ext_step, the "step" route, which the eGPU main path runs: one
//   launch is a whole DOT/SUM instruction step of every core of a batch,
//   in place on the register file.  Each core's opcode, registers and TSC
//   code come from its row of the uploaded instruction trace.  A block
//   serves one core: its threads form every eGPU thread's product at once
//   (a = mask ? Ra : +0, b = DOT ? (mask ? Rb : +0) : 1.0f) into shared
//   memory, then 16 lanes (the eGPU's wavefront width) add their lane's
//   products in wavefront order and the tree runs on warp shuffles.
//   Every tile of the core is active: a tile of zeros skipped would turn
//   a -0 sum into +0.  Thread 0 writes thread 0's Rd, whatever thread 0's
//   mask, as the reference does.
//
// Bound on an H100 SXM: bytes (each input read once, four bytes out per
// sum) at large sizes; on the eGPU main path a step reads one core's Ra
// and Rb, about 4.6 KB at 512 threads -- a few nanoseconds of the card's
// memory -- so the launch, its host issue and the sequential chain of
// T/16 + 4 dependent adds are what a step costs.  So the loads and the
// products (each an exact float64 product rounded once) are spread over
// the block, and only the adds, whose order the reference fixes, stay
// sequential.  The first design, a half warp a core with each lane
// loading and multiplying its own wavefronts, measured about twice the
// time on an H100 (PERF.md).  The tile entry loads a chunk of 16 rows'
// operands at once, then forms the chunk's products, then adds them in
// order, as straight-line code: a load per row inside the chain made
// each row a memory round trip.
#include "egpu_fp32.cuh"

namespace {

constexpr int kTileRows = 8;
constexpr int kLanes = 16;                          // the eGPU's wavefront
constexpr int kStepThreads = 256;                   // a block a core
constexpr int kChunk = 16;                          // rows loaded at once
constexpr uint32_t kOne = 0x3f800000u;              // 1.0f, SUM's b
enum ExtOp : int { kDot = 0, kSum = 1, kExtOps = 2 };

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
  for (int64_t r0 = 0; r0 < rows; r0 += kChunk) {
    // the chunk's flags and operands first, unguarded (a row past the last
    // one reads the last one again and is not summed): one wait on memory
    uint32_t x[kChunk], y[kChunk];
    bool on[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int64_t r = min(r0 + j, rows - 1);
      const int64_t i = base + r * lanes + lane;
      on[j] = active[core * tiles + r / kTileRows] != 0;
      x[j] = load_bits(a, i, bf16);
      y[j] = load_bits(b, i, bf16);
    }
    uint32_t prod[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) prod[j] = egpu::mul(x[j], y[j]);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {           // selects, not branches
      const bool take = r0 + j < rows && on[j];
      const uint32_t next = started ? egpu::add(s, prod[j]) : prod[j];
      s = take ? next : s;
      started = started || take;
    }
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

// regs (B, T, R) int32 bit patterns, written in place; row (B, 7) int64,
// this step's trace row of each core; masks (B, 16, T) bool; pred (B, T)
// bool, the predicate mask in force when the step began, or null.
// Grid: B blocks of 256 threads, T * 4 bytes of shared memory.
__global__ void ext_step_kernel(uint32_t* __restrict__ regs,
                                const int64_t* __restrict__ row,
                                const uint8_t* __restrict__ masks,
                                const uint8_t* __restrict__ pred,
                                unsigned long long opcodes, int64_t threads,
                                int64_t nregs) {
  extern __shared__ uint32_t prod[];            // (T / 16, 16) products
  const int64_t core = blockIdx.x;
  const int64_t* f = row + core * egpu::kRowLen;
  const int op = egpu::step_op(f[egpu::kRowOp], opcodes, kExtOps);
  if (op < 0) return;              // this core runs no DOT/SUM this step
  const int64_t ra = f[egpu::kRowRa], rb = f[egpu::kRowRb],
                tsc = f[egpu::kRowTsc];
  const uint8_t* m = masks + (core * egpu::kTscCodes + tsc) * threads;
  // no predicate: the TSC mask ANDed with itself, so no branch on a load
  const uint8_t* p = pred == nullptr ? m : pred + core * threads;
  const uint32_t* r = regs + core * threads * nregs;
  // every eGPU thread's product, all at once: a = mask ? Ra : +0,
  // b = DOT ? (mask ? Rb : +0) : 1.0f
  for (int64_t t = threadIdx.x; t < threads; t += blockDim.x) {
    const uint32_t x = r[t * nregs + ra], y = r[t * nregs + rb];
    const bool on = (m[t] & p[t]) != 0;
    const uint32_t a = on ? x : 0u;
    const uint32_t b = op == kDot ? (on ? y : 0u) : kOne;
    prod[t] = egpu::mul(a, b);
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  // the first warp: lane l adds its lane's products in wavefront order
  // (lanes 16..31 repeat lanes 0..15 and take part in the shuffles only)
  const int lane = threadIdx.x % kLanes;
  const int64_t waves = threads / kLanes;
  uint32_t s = prod[lane];
#pragma unroll 8
  for (int64_t w = 1; w < waves; ++w) {
    s = egpu::add(s, prod[w * kLanes + lane]);
  }
  // the halving tree over 16 lanes: acc[l] = add(acc[l], acc[l + h])
  for (int h = kLanes / 2; h >= 1; h /= 2) {
    s = egpu::add(s, __shfl_down_sync(0xffffffffu, s, h, kLanes));
  }
  // thread 0's Rd, whatever thread 0's mask; every read came before
  if (threadIdx.x == 0) regs[core * threads * nregs + f[egpu::kRowRd]] = s;
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

extern "C" int egpu_ext_step(void* regs, const void* row, const void* masks,
                             const void* pred, unsigned long long opcodes,
                             long long batch, long long threads,
                             long long nregs, void* stream) {
  if (batch > 0 && threads > 0) {
    ext_step_kernel<<<(unsigned)batch, kStepThreads,
                      (size_t)threads * sizeof(uint32_t),
                      (cudaStream_t)stream>>>(
        (uint32_t*)regs, (const int64_t*)row, (const uint8_t*)masks,
        (const uint8_t*)pred, opcodes, threads, nregs);
  }
  return (int)cudaGetLastError();
}
