// The eGPU's TSC-gated FP execute and write-back stage, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/wavefront_alu/kernel.py
// (wavefront_alu / _kernel): out = active[tile] ? op(a, b) : init over a
// (rows, lanes) array of float32 bit patterns, in tiles of 8 rows.  An
// inactive tile computes nothing and copies init (the eGPU's
// write-enable = 0).  Two entries share the arithmetic (egpu::apply, with
// the reference's x86 rules, see egpu_fp32.cuh):
//
// * egpu_wavefront_alu, the "tile" route: the TPU kernel's own function.
//   The TPU prefetched the activity bitmap as scalars; here each block
//   handles one tile and loads that tile's flag itself.  The TPU's
//   rows % 8 == 0 assert was a VMEM tiling rule: the ragged last tile is
//   masked instead, so a 32-thread core (2 rows of 16) works.
//
// * egpu_fp_step, the "step" route, which the eGPU main path runs: one
//   launch is a whole FADD/FSUB/FMUL/FMAX/FMIN instruction step of every
//   core of a batch, in place on the register file.  Each core's opcode,
//   registers and TSC code come from its row of the uploaded instruction
//   trace; the write mask (TSC mask & predicate mask) and each tile's
//   activity, which the TPU got as a prefetched bitmap, are computed
//   where they are used.  In place, init is Rd itself, so an inactive
//   tile writes nothing.
//
// Bound on an H100 SXM: bytes.  A step reads Ra and Rb and writes Rd, 12
// bytes an active eGPU thread, plus a byte of TSC mask (and of predicate
// mask) a thread; a handful of integer and float operations an element,
// far below the card's ops-per-byte balance.  But a step moves a few KB
// (one core: 512 threads, about 6.7 KB), which the card's memory would
// take about 2 ns to move; what a step costs is the launch and its host
// issue, microseconds.  Design: one launch a step, whatever FP opcodes
// the cores mix (a core whose opcode is not FP returns at once), no copy
// around it; one block of 128 threads serves one (core, 8-row tile), one
// eGPU thread a thread; operands and masks are loaded together, before
// the tile's activity is known, so a step costs two dependent memory
// round trips (trace row, then operands).
#include "egpu_fp32.cuh"

namespace {

constexpr int kTileRows = 8;
constexpr int kThreads = 128;
constexpr int kLanes = 16;                        // the eGPU's wavefront
constexpr int kTileThreads = kTileRows * kLanes;  // eGPU threads a tile
constexpr int kAluOps = 5;                        // egpu::AluOp

static_assert(kTileThreads == kThreads, "one thread an eGPU thread");

__global__ void wavefront_alu_kernel(const uint32_t* __restrict__ a,
                                     const uint32_t* __restrict__ b,
                                     const uint32_t* __restrict__ init,
                                     const int32_t* __restrict__ active,
                                     uint32_t* __restrict__ out,
                                     int64_t rows, int64_t lanes, int op) {
  const int64_t tile = blockIdx.x;
  const bool on = active[tile] != 0;
  const int64_t r0 = tile * kTileRows;
  const int64_t r1 = min(r0 + kTileRows, rows);      // ragged last tile
  const int64_t begin = r0 * lanes, end = r1 * lanes;
  for (int64_t i = begin + threadIdx.x; i < end; i += blockDim.x) {
    out[i] = on ? egpu::apply(op, a[i], b[i]) : init[i];
  }
}

// regs (B, T, R) int32 bit patterns, written in place; row (B, 7) int64,
// this step's trace row of each core; masks (B, 16, T) bool; pred (B, T)
// bool, the predicate mask in force when the step began, or null.
// Grid: (B, ceil(T / 128)); block (core, tile).
__global__ void fp_step_kernel(uint32_t* __restrict__ regs,
                               const int64_t* __restrict__ row,
                               const uint8_t* __restrict__ masks,
                               const uint8_t* __restrict__ pred,
                               unsigned long long opcodes, int64_t threads,
                               int64_t nregs) {
  const int64_t core = blockIdx.x;
  const int64_t* f = row + core * egpu::kRowLen;
  const int op = egpu::step_op(f[egpu::kRowOp], opcodes, kAluOps);
  if (op < 0) return;                   // this core runs no FP op this step
  const int64_t rd = f[egpu::kRowRd], ra = f[egpu::kRowRa],
                rb = f[egpu::kRowRb], tsc = f[egpu::kRowTsc];
  const int64_t t = (int64_t)blockIdx.y * kTileThreads + threadIdx.x;
  uint32_t* r = regs + (core * threads + t) * nregs;
  const uint8_t* m = masks + (core * egpu::kTscCodes + tsc) * threads;
  // no predicate: the TSC mask ANDed with itself, so no branch on a load
  const uint8_t* p = pred == nullptr ? m : pred + core * threads;
  bool wm = false;
  uint32_t x = 0, y = 0;
  if (t < threads) {                    // ragged last tile
    wm = (m[t] & p[t]) != 0;
    x = r[ra];
    y = r[rb];
  }
  // the tile's activity bit: one of its threads writes
  if (!__syncthreads_or(wm)) return;
  // each thread read its own Ra and Rb above: rd == ra or rb is safe
  if (wm) r[rd] = egpu::apply(op, x, y);
}

}  // namespace

extern "C" int egpu_wavefront_alu(const void* a, const void* b,
                                  const void* init, const void* active,
                                  void* out, long long rows, long long lanes,
                                  int op, void* stream) {
  const long long tiles = (rows + kTileRows - 1) / kTileRows;
  if (tiles > 0) {
    wavefront_alu_kernel<<<(unsigned)tiles, kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (const uint32_t*)init,
        (const int32_t*)active, (uint32_t*)out, rows, lanes, op);
  }
  return (int)cudaGetLastError();
}

extern "C" int egpu_fp_step(void* regs, const void* row, const void* masks,
                            const void* pred, unsigned long long opcodes,
                            long long batch, long long threads,
                            long long nregs, void* stream) {
  const long long tiles = (threads + kTileThreads - 1) / kTileThreads;
  if (batch > 0 && tiles > 0) {
    fp_step_kernel<<<dim3((unsigned)batch, (unsigned)tiles), kThreads, 0,
                     (cudaStream_t)stream>>>(
        (uint32_t*)regs, (const int64_t*)row, (const uint8_t*)masks,
        (const uint8_t*)pred, opcodes, threads, nregs);
  }
  return (int)cudaGetLastError();
}
