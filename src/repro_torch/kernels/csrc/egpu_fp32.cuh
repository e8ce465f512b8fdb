// The reference's float32 arithmetic, bit for bit, as device functions.
//
// The JAX reference runs on XLA:CPU: x86 SSE with DAZ and FTZ set, x86
// NaN selection, and LLVM's x86 lowering of maximum/minimum.  CUDA's own
// defaults differ on every one of those (canonical NaN 0x7fffffff, fmaxf
// dropping NaNs, gradual underflow), so each rule is written out on raw
// uint32 bit patterns.  The plain PyTorch versions of these functions are
// in repro_torch/kernels/fp32.py; the two must stay in step.
//
// Build with -ftz=true (flush like XLA:CPU) and -fmad=false (XLA rounds a
// multiply and a following add separately; nvcc would contract them).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace egpu {

constexpr uint32_t kSign = 0x80000000u;
constexpr uint32_t kAbs = 0x7fffffffu;
constexpr uint32_t kExp = 0x7f800000u;
constexpr uint32_t kQuiet = 0x00400000u;
constexpr uint32_t kDefaultNaN = 0xffc00000u;   // x86 "real indefinite"

__device__ __forceinline__ float as_f(uint32_t x) { return __uint_as_float(x); }
__device__ __forceinline__ uint32_t as_u(float x) { return __float_as_uint(x); }

__device__ __forceinline__ bool is_nan(uint32_t x) { return (x & kAbs) > kExp; }

// DAZ: a subnormal operand reads as a zero of its own sign (also FTZ on
// a result, since flushing is the same bit operation).
__device__ __forceinline__ uint32_t daz(uint32_t x) {
  return (x & kExp) == 0 ? (x & kSign) : x;
}

// x86 NaN selection: the first NaN operand, quieted; else the default
// NaN where the operation was invalid (inf - inf, 0 * inf).  Written as
// selects, not branches, so that a caller's unrolled loop stays one
// block of straight-line code that the compiler can schedule across.
__device__ __forceinline__ uint32_t nan_rules(uint32_t a, uint32_t b, uint32_t r) {
  r = is_nan(r) ? kDefaultNaN : r;
  r = is_nan(b) ? (b | kQuiet) : r;
  return is_nan(a) ? (a | kQuiet) : r;
}

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  // a sum in the subnormal range is exact, so flushing it is x86 FTZ
  uint32_t r = daz(as_u(__fadd_rn(as_f(daz(a)), as_f(daz(b)))));
  return nan_rules(a, b, r);
}

__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  uint32_t r = daz(as_u(__fsub_rn(as_f(daz(a)), as_f(daz(b)))));
  return nan_rules(a, b, r);
}

__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  // The float64 product of two float32 values is exact: one rounding to
  // float32 follows, and tininess is judged after rounding to 24 bits,
  // as x86 does, whatever the card's own FTZ rule for mul.f32 is.
  uint32_t da = daz(a), db = daz(b);
  double p = __dmul_rn((double)as_f(da), (double)as_f(db));
  double m = fabs(p);
  uint32_t sign = (da ^ db) & kSign;
  uint32_t r = as_u(__double2float_rn(p));
  r = m < 0x1p-126 ? (sign | 0x00800000u) : r;    // rounds up to the least normal
  r = m < 0x1p-126 - 0x1p-151 ? sign : r;         // tiny: flushed to a signed zero
  return nan_rules(a, b, r);
}

// maximum/minimum as LLVM lowers llvm.maximum/llvm.minimum on x86: the
// sign bit of the first operand orders the pair, a NaN in the reordered
// first operand is returned as it is, else maxss/minss, which return the
// second operand on a NaN or a tie.
__device__ __forceinline__ uint32_t maximum(uint32_t a, uint32_t b) {
  bool neg = (int32_t)a < 0;
  uint32_t x = neg ? a : b, y = neg ? b : a;
  if (is_nan(x)) return x;
  uint32_t dx = daz(x), dy = daz(y);
  return as_f(dy) < as_f(dx) ? dx : dy;
}

__device__ __forceinline__ uint32_t minimum(uint32_t a, uint32_t b) {
  bool neg = (int32_t)a < 0;
  uint32_t x = neg ? b : a, y = neg ? a : b;
  if (is_nan(x)) return x;
  uint32_t dx = daz(x), dy = daz(y);
  return as_f(dx) < as_f(dy) ? dx : dy;
}

// operation codes shared with the Python wrappers (wavefront_alu OPS order)
enum AluOp : int { kAdd = 0, kSub = 1, kMul = 2, kMax = 3, kMin = 4 };

__device__ __forceinline__ uint32_t apply(int op, uint32_t a, uint32_t b) {
  switch (op) {
    case kAdd: return add(a, b);
    case kSub: return sub(a, b);
    case kMul: return mul(a, b);
    case kMax: return maximum(a, b);
    default: return minimum(a, b);
  }
}

// The step entries (egpu_fp_step, egpu_ext_step) read each core's eGPU
// opcode from its trace row and serve it if it is one of theirs: byte k
// of `opcodes` is the eGPU opcode of the entry's operation k (the Python
// wrappers pack it, repro_torch/kernels/egpu_step.py).  Returns k, or -1
// for an opcode the entry does not serve.
__device__ __forceinline__ int step_op(int64_t opcode, unsigned long long opcodes,
                                       int n) {
  for (int k = 0; k < n; ++k) {
    if (opcode == (int64_t)((opcodes >> (8 * k)) & 0xffu)) return k;
  }
  return -1;
}

// A trace row's columns (repro_torch/core/executor.py PROG_FIELDS).
enum RowField : int { kRowOp = 0, kRowRd = 2, kRowRa = 3, kRowRb = 4,
                      kRowTsc = 6, kRowLen = 7 };

// The TSC mask table holds one (16, T) plane a core.
constexpr int kTscCodes = 16;

}  // namespace egpu
