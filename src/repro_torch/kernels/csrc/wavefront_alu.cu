// The eGPU's TSC-gated FP execute and write-back stage, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/wavefront_alu/kernel.py
// (wavefront_alu / _kernel): out = active[tile] ? op(a, b) : init over a
// (rows, lanes) array of float32 bit patterns, in tiles of 8 rows.  An
// inactive tile computes nothing and copies init (the eGPU's
// write-enable = 0).  The TPU prefetched the activity bitmap as scalars;
// here each block handles one tile and loads that tile's flag itself.
// The TPU's rows % 8 == 0 assert was a VMEM tiling rule: the ragged last
// tile is masked instead, so a 32-thread core (2 rows of 16) works.
//
// Bound on an H100 SXM: bytes.  An active tile reads a and b and writes
// out, 12 bytes an element; an inactive one reads init and writes out,
// 8 bytes; each tile reads its flag.  Against that, a handful of integer
// and float operations an element (the op with the reference's x86 rules,
// see egpu_fp32.cuh) -- far below the card's ops-per-byte balance.  The
// eGPU main path calls it on one register column, (B * T / 16, 16), a
// few KB to a few hundred KB, so at those sizes launch latency, not
// bandwidth, is what a call costs.  Design: one element per thread, one
// block per 8-row tile, coalesced 4-byte loads; nothing to stage.
#include "egpu_fp32.cuh"

namespace {

constexpr int kTileRows = 8;
constexpr int kThreads = 128;

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
