"""The reference's float32 arithmetic, bit for bit, on int32 bit patterns.

The JAX reference runs on XLA:CPU, whose float32 results follow x86 SSE
with the denormals-are-zero (DAZ) and flush-to-zero (FTZ) flags set.
Neither PyTorch on the CPU nor CUDA's defaults give the same bits, so
every rule is written out here on raw ``int32`` bit patterns, with
PyTorch ops only, so the result is the same on any device:

* DAZ: a subnormal operand reads as a zero of its own sign;
* FTZ: a result that is tiny after rounding becomes a zero of its sign;
* an add/sub/mul with a NaN operand returns the first NaN operand,
  quieted; an invalid operation (``inf - inf``, ``0 * inf``) returns the
  x86 default NaN ``0xffc00000``;
* ``maximum``/``minimum`` follow LLVM's x86 lowering of
  ``llvm.maximum``/``llvm.minimum``: a sign-bit test orders the operands
  (``max(-0, +0) = +0`` and ``min(-0, +0) = -0`` in either order), a NaN
  in the reordered first operand is returned as it is, else ``maxss``/
  ``minss`` return the second operand on a NaN or a tie.

The CUDA kernels (``csrc/egpu_fp32.cuh``) implement the same rules; the
functions here are their plain versions.
"""
from __future__ import annotations

import pathlib

import torch

SIGN = -0x80000000                 # int32 0x80000000
ABS_MASK = 0x7FFFFFFF
EXP_MASK = 0x7F800000
QUIET_BIT = 0x00400000
DEFAULT_NAN = -0x00400000          # int32 0xffc00000
#: |p| below this (as a float64) is tiny after rounding to 24 bits
TINY_F64 = 2.0 ** -126 - 2.0 ** -151


def as_f32(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.float32)


def as_bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def is_nan(x: torch.Tensor) -> torch.Tensor:
    return (x & ABS_MASK) > EXP_MASK


def quiet(x: torch.Tensor) -> torch.Tensor:
    return x | QUIET_BIT


def daz(x: torch.Tensor) -> torch.Tensor:
    """Subnormal bit patterns read as a zero of their own sign."""
    return torch.where((x & EXP_MASK) == 0, x & SIGN, x)


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Subnormal results become a zero of their own sign."""
    return daz(x)


def _nan_rules(a, b, r):
    """x86 NaN selection for a two-operand arithmetic op: the first NaN
    operand (quieted), else the default NaN where the op was invalid."""
    r = torch.where(is_nan(r), DEFAULT_NAN, r)
    r = torch.where(is_nan(b), quiet(b), r)
    return torch.where(is_nan(a), quiet(a), r)


def add(a, b):
    a_, b_ = daz(a), daz(b)
    # a sum that lands in the subnormal range is exact, so flushing the
    # IEEE result is the same as x86 FTZ
    r = ftz(as_bits(as_f32(a_) + as_f32(b_)))
    return _nan_rules(a, b, r)


def sub(a, b):
    a_, b_ = daz(a), daz(b)
    r = ftz(as_bits(as_f32(a_) - as_f32(b_)))
    return _nan_rules(a, b, r)


def mul(a, b):
    a_, b_ = daz(a), daz(b)
    # the product of two float32 is exact in float64, so one rounding to
    # float32 follows; tininess is judged after rounding to 24 bits
    p = as_f32(a_).double() * as_f32(b_).double()
    r = as_bits(p.float())
    tiny = p.abs() < TINY_F64
    r = torch.where(tiny, (a_ ^ b_) & SIGN, r)
    return _nan_rules(a, b, r)


def _lt(x, y):
    """``x < y`` on DAZ'd, non-NaN-aware float32 bit patterns."""
    return as_f32(x) < as_f32(y)


def maximum(a, b):
    neg = a < 0
    nx, ny = torch.where(neg, a, b), torch.where(neg, b, a)
    dx, dy = daz(nx), daz(ny)
    r = torch.where(_lt(dy, dx), dx, dy)         # maxss: x > y ? x : y
    return torch.where(is_nan(nx), nx, r)


def minimum(a, b):
    neg = a < 0
    nx, ny = torch.where(neg, b, a), torch.where(neg, a, b)
    dx, dy = daz(nx), daz(ny)
    r = torch.where(_lt(dx, dy), dx, dy)         # minss: x < y ? x : y
    return torch.where(is_nan(nx), nx, r)


#: the x86 ``vrsqrtps`` estimate over [1, 4), from ``data/rsqrtps_table.c``
RSQRT_TABLE = pathlib.Path(__file__).resolve().parent / "data" \
    / "rsqrtps_table.txt"
RSQRT_MANT_BITS = 10
_rsqrt_tables: dict = {}


def _rsqrt_table(device) -> torch.Tensor:
    key = str(device)
    if key not in _rsqrt_tables:
        words = [int(w, 16) for w in RSQRT_TABLE.read_text().splitlines()
                 if w and not w.startswith("#")]
        if len(words) != 2 << RSQRT_MANT_BITS:
            raise ValueError(f"{RSQRT_TABLE}: {len(words)} entries")
        _rsqrt_tables[key] = torch.tensor(words, dtype=torch.int32,
                                          device=device)
    return _rsqrt_tables[key]


def _estimate(a):
    """``vrsqrtps`` of a positive normal float32: the table entry of the
    exponent's parity and top mantissa bits, its exponent field lowered by
    half the input's distance from [1, 4)."""
    e = (a >> 23) & 0xFF
    par = (e - 127) & 1
    idx = (par << RSQRT_MANT_BITS) + ((a & 0x7FFFFF) >> (23 - RSQRT_MANT_BITS))
    return _rsqrt_table(a.device)[idx] - (((e - 127 - par) // 2) << 23)


def _fma_f32(a, b, c):
    """``fma(a, b, c)`` rounded once to float32, for float32 tensors whose
    product is exact in float64: the float64 sum is taken to odd (its two-
    sum error sets the low bit), so the rounding to float32 is the only
    one that counts."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + step, bits)
    return bits.view(torch.float64).float()


def rsqrt(a):
    """XLA:CPU's ``lax.rsqrt``, bit for bit on the CPU the estimate table
    was made on.  A positive normal input takes the ``vrsqrtps`` estimate
    ``y`` and two Newton steps, each ``t = x*y; u = fma(y, t, -1);
    y = fma(-0.5*y, u, y)``; every other class returns the estimate itself,
    which is ``1/sqrt`` of the DAZ'd operand with x86's NaN rules."""
    x = as_f32(a)
    y = as_f32(_estimate(a))
    for _ in range(2):
        t = (x.double() * y.double()).float()
        u = _fma_f32(y, t, torch.full_like(y, -1.0))
        y = _fma_f32(y * -0.5, u, y)
    normal = (a > 0) & ((a & EXP_MASK) != 0) & ((a & EXP_MASK) != EXP_MASK)
    special = ftz(as_bits((1.0 / torch.sqrt(as_f32(daz(a)).double())).float()))
    special = torch.where(is_nan(special), DEFAULT_NAN, special)
    special = torch.where(is_nan(a), quiet(a), special)
    return torch.where(normal, as_bits(y), special)


def compare(a, b, op: str):
    """Float comparison on DAZ'd operands (``cmpss`` honours DAZ)."""
    fa, fb = as_f32(daz(a)), as_f32(daz(b))
    return {"eq": fa == fb, "ne": fa != fb, "lt": fa < fb, "le": fa <= fb,
            "gt": fa > fb, "ge": fa >= fb}[op]


def det_sum(v: torch.Tensor, num_sps: int = 16) -> torch.Tensor:
    """The reference's deterministic thread-space reduction on float32
    bit patterns ``(..., T)`` -> ``(...)``: sequential over wavefronts,
    pairwise tree within the 16-lane wavefront, x86 float rules (the
    order of DOT/SUM, which the ``dot_product`` kernels keep)."""
    T = v.shape[-1]
    m = v.reshape(v.shape[:-1] + (T // num_sps, num_sps))
    acc = m[..., 0, :]
    for i in range(1, T // num_sps):
        acc = add(acc, m[..., i, :])
    s = num_sps // 2
    while s >= 1:
        acc = add(acc[..., :s], acc[..., s:2 * s])
        s //= 2
    return acc[..., 0]


#: the wavefront ALU's five operations, by the reference kernel's names
BINARY = {"add": add, "sub": sub, "mul": mul, "max": maximum,
          "min": minimum}
