"""Per-opcode semantics of the eGPU ISA on PyTorch tensors.

The port of ``repro.core.semantics``: the 33 value functions, the 18
IF.cc conditions, the predicate/call/loop stack helpers and ``det_sum``,
bit for bit.  Thread-space tensors carry an optional leading batch axis
(every function works on the *last* axis), so the same code serves one
core ``(T,)`` and a fleet ``(B, T)``.

Registers hold 32-bit patterns in **int32**: PyTorch has no uint32
arithmetic, so unsigned compare, shift, max and min are emulated (the
sign bit flipped for compares, a mask after arithmetic shifts).  The
FP ops FADD/FSUB/FMUL/FMAX/FMIN go through the ``wavefront_alu`` kernel
wrapper and DOT/SUM through the ``dot_product`` wrapper, which carry the
reference's x86 float32 rules (:mod:`repro_torch.kernels.fp32`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from ..kernels import fp32
from ..kernels.dot_product.ops import dot_product
from ..kernels.wavefront_alu.ops import wavefront_alu
from .config import EGPUConfig
from .isa import NUM_OPCODES, Op

_SIGN = -0x80000000           # int32 0x80000000
_I32 = torch.int32


# ---------------------------------------------------------------------------
# Bit-exact integer helpers on int32 bit patterns
# ---------------------------------------------------------------------------

def _srl(x, n):
    """Logical right shift of 32-bit patterns by ``n`` in [0, 31]."""
    return ((x.to(torch.int64) & 0xFFFFFFFF) >> n).to(_I32)


def _ult(a, b):
    """Unsigned ``a < b`` on 32-bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _sext16(x):
    x = x & 0xFFFF
    return torch.where(x >= 1 << 15, x - (1 << 16), x)


def _sext24(x):
    x = x & 0xFFFFFF
    return torch.where(x >= 1 << 23, x - (1 << 24), x)


def _bit_reverse32(x):
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return (x << 16) | ((x >> 16) & 0xFFFF)


def _popcount(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def _mul24(a, b, signed: bool):
    """24x24 -> 48-bit product as (hi24, lo24) limbs, as the reference."""
    if signed:
        sa, sb = _sext24(a), _sext24(b)
        neg = (sa < 0) ^ (sb < 0)
        a, b = sa.abs(), sb.abs()
    else:
        neg = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
        a, b = a & 0xFFFFFF, b & 0xFFFFFF
    m12, m24 = (1 << 12) - 1, (1 << 24) - 1
    ah, al = a >> 12, a & m12
    bh, bl = b >> 12, b & m12
    low = al * bl
    mid = ah * bl + al * bh
    t = mid + (low >> 12)
    hi = ah * bh + (t >> 12)
    lo = ((t & m12) << 12) | (low & m12)
    nlo = (-lo) & m24
    borrow = (lo != 0).to(_I32)
    nhi = (((~hi) & m24) + 1 - borrow) & m24
    return torch.where(neg, nhi, hi), torch.where(neg, nlo, lo), neg


def _sel(c, a, b):
    """``torch.where`` that folds when the predicate is a Python bool."""
    if isinstance(c, bool):
        return a if c else b
    return torch.where(c, a, b)


def det_sum(v: torch.Tensor, num_sps: int = 16) -> torch.Tensor:
    """The reference's deterministic thread-space reduction on float32
    bit patterns ``(..., T)`` -> ``(...)``: sequential over wavefronts,
    pairwise tree within the 16-lane wavefront, x86 float rules.  The
    main path runs the same order in the ``dot_product`` kernel; this
    plain form is what the kernel is checked against."""
    T = v.shape[-1]
    m = v.reshape(v.shape[:-1] + (T // num_sps, num_sps))
    acc = m[..., 0, :]
    for i in range(1, T // num_sps):
        acc = fp32.add(acc, m[..., i, :])
    s = num_sps // 2
    while s >= 1:
        acc = fp32.add(acc[..., :s], acc[..., s:2 * s])
        s //= 2
    return acc[..., 0]


# ---------------------------------------------------------------------------
# The kernels in the main path's layout
# ---------------------------------------------------------------------------

def fp_alu(op: str, a, b, init, wmask=None, num_sps: int = 16):
    """The wavefront ALU on register columns ``(..., T)``: laid out as
    ``(rows, 16)`` (rows = wavefronts, lanes = SPs; a batch stacks its
    cores' rows), a tile of 8 rows active iff one of its threads writes.
    Without ``wmask`` every tile computes."""
    shape = a.shape
    rows = a.numel() // num_sps
    tiles = -(-rows // 8)
    if wmask is None:
        active = torch.ones((tiles,), dtype=_I32, device=a.device)
    else:
        on = wmask.reshape(rows, num_sps).any(1)
        active = F.pad(on, (0, tiles * 8 - rows)).view(tiles, 8).any(1)
    out = wavefront_alu(fp32.as_f32(a.reshape(rows, num_sps)),
                        fp32.as_f32(b.reshape(rows, num_sps)),
                        fp32.as_f32(init.reshape(rows, num_sps)),
                        active.to(_I32), op)
    return fp32.as_bits(out).reshape(shape)


def ext_dot(a, b, core_on=None, num_sps: int = 16):
    """DOT/SUM on the extension unit: ``(..., T)`` operands (already
    masked to +0 outside the active thread space) -> one sum per core as
    bit patterns ``(...)``.  ``core_on`` ``(...)`` marks the cores that
    run the op; every tile of such a core is active (skipping a tile of
    zeros would turn a -0 sum into +0)."""
    lead = a.shape[:-1]
    T = a.shape[-1]
    batch = a.numel() // T
    rows = T // num_sps
    tiles = -(-rows // 8)
    on = (torch.ones((batch,), dtype=torch.bool, device=a.device)
          if core_on is None else core_on.reshape(batch))
    active = on[:, None].expand(batch, tiles).to(_I32)
    s = dot_product(fp32.as_f32(a.reshape(batch, rows, num_sps)),
                    fp32.as_f32(b.reshape(batch, rows, num_sps)), active)
    return fp32.as_bits(s).reshape(lead)


# ---------------------------------------------------------------------------
# The operand environment
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OpEnv:
    """Everything an opcode's value function reads.

    ``rav/rbv/rdv`` are the Ra/Rb/Rd operand columns ``(..., T)`` int32;
    ``signed``/``imm`` are Python constants (one core) or tensors that
    broadcast against ``(..., T)`` (a fleet step: ``(B, 1)``); ``mask``
    is the active-thread mask (TSC x predicates); ``wmask`` the write
    mask, which decides the kernels' tile activity (``None``: all
    active); ``shared`` is ``(..., S)`` or longer (a drop slot past
    ``S``); ``tdx_dim`` an int or a ``(..., 1)`` tensor.
    """

    cfg: EGPUConfig
    rav: Any
    rbv: Any
    rdv: Any
    signed: Any
    imm: Any
    mask: Any
    tid: Any
    shared: Any
    tdx_dim: Any
    wmask: Any = None

    def imask(self, v):
        """Integer ALU precision (16-bit ALU configs clip to alu_bits)."""
        return v & 0xFFFF if self.cfg.alu_bits == 16 else v

    @property
    def addr(self):
        """LOD/STO effective address: Ra + offset, per thread (int32
        arithmetic, wrapping as the reference's)."""
        return self.rav + self.imm

    def load(self, addr):
        """Shared-memory gather with the hardware's address clamp."""
        a = addr.clamp(0, self.cfg.shared_words - 1).long()
        if self.shared.dim() == 1:
            return self.shared[a]
        return torch.gather(self.shared, -1, a)

    def core_on(self):
        return None if self.wmask is None else self.wmask.any(-1)


# ---------------------------------------------------------------------------
# Per-opcode value / condition functions
# ---------------------------------------------------------------------------

def build_spec(env: OpEnv) -> list:
    """``spec[op] = (value_fn | None, cond_fn | None)`` over all opcodes,
    as the reference's ``build_spec``; values are int32 bit patterns."""
    cfg = env.cfg
    rav, rbv = env.rav, env.rbv
    signed = env.signed
    imask = env.imask

    def full(v):
        # a Python int becomes a fill kernel's argument: building a
        # device tensor from it would copy from the host and sync
        if isinstance(v, int):
            return torch.full(rav.shape, v, dtype=_I32, device=rav.device)
        return torch.broadcast_to(v.to(_I32), rav.shape)

    def shift_amt():
        return rbv & (cfg.alu_bits - 1 if cfg.shift_bits > 1 else 1)

    def f_add(): return imask(rav + rbv)
    def f_sub(): return imask(rav - rbv)
    def f_negi(): return imask(-rav)
    def f_absi(): return imask(rav.abs())

    def f_mul16lo():
        p_s = _sext16(rav) * _sext16(rbv)
        p_u = (rav & 0xFFFF) * (rbv & 0xFFFF)
        return imask(_sel(signed, p_s, p_u))

    def f_mul16hi():
        p_s = (_sext16(rav) * _sext16(rbv)) >> 16
        p_u = _srl((rav & 0xFFFF) * (rbv & 0xFFFF), 16)
        return imask(_sel(signed, p_s, p_u))

    def f_mul24lo():
        hi, lo, _ = _mul24(rav, rbv, False)
        hi_s, lo_s, _ = _mul24(rav, rbv, True)
        return imask(_sel(signed, lo_s | (hi_s << 24), lo | (hi << 24)))

    def f_mul24hi():
        hi, _, _ = _mul24(rav, rbv, False)
        hi_s, _, _ = _mul24(rav, rbv, True)
        # arithmetic >>24 of the 48-bit product: extend from bit 47
        s = torch.where((hi_s & 0x800000) != 0, hi_s | -0x1000000, hi_s)
        return imask(_sel(signed, s, hi))

    def f_and(): return imask(rav & rbv)
    def f_or(): return imask(rav | rbv)
    def f_xor(): return imask(rav ^ rbv)
    def f_not(): return imask(~rav)
    def f_cnot(): return imask((rav == 0).to(_I32))
    def f_bvs(): return imask(_bit_reverse32(rav))
    def f_shl(): return imask(rav << shift_amt())

    def f_shr():
        amt = shift_amt()
        return imask(_sel(signed, rav >> amt, _srl(rav, amt)))

    def f_pop(): return imask(_popcount(rav))

    def f_max():
        s = torch.where(rav > rbv, rav, rbv)
        u = torch.where(_ult(rbv, rav), rav, rbv)
        return imask(_sel(signed, s, u))

    def f_min():
        s = torch.where(rav < rbv, rav, rbv)
        u = torch.where(_ult(rav, rbv), rav, rbv)
        return imask(_sel(signed, s, u))

    # FP: the wavefront ALU kernel, TSC-gated by the write mask
    def fp(op):
        return lambda: fp_alu(op, rav, rbv, env.rdv, env.wmask, cfg.num_sps)

    def f_fneg(): return rav ^ _SIGN
    def f_fabs(): return rav & 0x7FFFFFFF

    # memory / immediates / thread ids (LOD and the FP units bypass the
    # integer ALU's alu_bits clip, as in the reference)
    def f_lod(): return env.load(env.addr)
    def f_lodi(): return imask(full(env.imm))

    def f_tdx():
        return imask(torch.broadcast_to(
            torch.remainder(env.tid, env.tdx_dim), rav.shape).to(_I32))

    def f_tdy():
        return imask(torch.broadcast_to(
            torch.div(env.tid, env.tdx_dim, rounding_mode="floor"),
            rav.shape).to(_I32))

    # extension units: DOT/SUM land in thread 0's Rd
    def f_dot():
        a = torch.where(env.mask, rav, 0)
        b = torch.where(env.mask, rbv, 0)
        s = ext_dot(a, b, env.core_on(), cfg.num_sps)
        return torch.broadcast_to(s[..., None], rav.shape)

    def f_sum():
        a = torch.where(env.mask, rav, 0)
        one = torch.full_like(a, 0x3F800000)          # 1.0f
        s = ext_dot(a, one, env.core_on(), cfg.num_sps)
        return torch.broadcast_to(s[..., None], rav.shape)

    def f_invsqr(): return fp32.rsqrt(rav)

    spec: list = [None] * NUM_OPCODES
    for o, f in [(Op.ADD, f_add), (Op.SUB, f_sub), (Op.NEG, f_negi),
                 (Op.ABS, f_absi), (Op.MUL16LO, f_mul16lo),
                 (Op.MUL16HI, f_mul16hi), (Op.MUL24LO, f_mul24lo),
                 (Op.MUL24HI, f_mul24hi), (Op.AND, f_and), (Op.OR, f_or),
                 (Op.XOR, f_xor), (Op.NOT, f_not), (Op.CNOT, f_cnot),
                 (Op.BVS, f_bvs), (Op.SHL, f_shl), (Op.SHR, f_shr),
                 (Op.POP, f_pop), (Op.MAX, f_max), (Op.MIN, f_min),
                 (Op.FADD, fp("add")), (Op.FSUB, fp("sub")),
                 (Op.FNEG, f_fneg), (Op.FABS, f_fabs), (Op.FMUL, fp("mul")),
                 (Op.FMAX, fp("max")), (Op.FMIN, fp("min")),
                 (Op.LOD, f_lod), (Op.LODI, f_lodi), (Op.TDX, f_tdx),
                 (Op.TDY, f_tdy), (Op.DOT, f_dot), (Op.SUM, f_sum),
                 (Op.INVSQR, f_invsqr)]:
        spec[o] = (f, None)
    for o, f in [(Op.IF_EQ, lambda: rav == rbv),
                 (Op.IF_NE, lambda: rav != rbv),
                 (Op.IF_LT, lambda: rav < rbv),
                 (Op.IF_LO, lambda: _ult(rav, rbv)),
                 (Op.IF_LE, lambda: rav <= rbv),
                 (Op.IF_LS, lambda: ~_ult(rbv, rav)),
                 (Op.IF_GT, lambda: rav > rbv),
                 (Op.IF_HI, lambda: _ult(rbv, rav)),
                 (Op.IF_GE, lambda: rav >= rbv),
                 (Op.IF_HS, lambda: ~_ult(rav, rbv)),
                 (Op.IF_FEQ, lambda: fp32.compare(rav, rbv, "eq")),
                 (Op.IF_FNE, lambda: fp32.compare(rav, rbv, "ne")),
                 (Op.IF_FLT, lambda: fp32.compare(rav, rbv, "lt")),
                 (Op.IF_FLE, lambda: fp32.compare(rav, rbv, "le")),
                 (Op.IF_FGT, lambda: fp32.compare(rav, rbv, "gt")),
                 (Op.IF_FGE, lambda: fp32.compare(rav, rbv, "ge")),
                 (Op.IF_Z, lambda: rav == 0),
                 (Op.IF_NZ, lambda: rav != 0)]:
        spec[o] = (None, f)
    return spec


def store(shared, sidx, val):
    """STO to shared memory, the one scatter, in place.

    ``shared`` is ``(S + 1,)`` or ``(B, S + 1)``: slot ``S`` is the drop
    slot that inactive and out-of-range threads point at.  All stores of
    one step go in as one flattened scatter.  Where threads of one core
    store to one word, the highest tid wins, as in the reference (whose
    scatter applies updates in order); CUDA's ``index_put_`` names no
    winner, so the winner is found first with ``scatter_reduce(amax)``
    and only winners write.
    """
    W = shared.shape[-1]
    n = shared.numel() // W
    base = (torch.arange(n, device=shared.device) * W).reshape(
        sidx.shape[:-1] + (1,)) if sidx.dim() > 1 else 0
    flat = (sidx.long() + base).reshape(-1)
    order = torch.arange(flat.numel(), device=shared.device)
    win = torch.full((n * W,), -1, dtype=torch.long, device=shared.device)
    win.scatter_reduce_(0, flat, order, "amax")
    drop = (flat % W) == W - 1
    keep = (win[flat] == order) & ~drop
    dest = torch.where(keep, flat, (flat // W) * W + W - 1)
    shared.view(-1).index_put_((dest,), val.reshape(-1))
    return shared


# ---------------------------------------------------------------------------
# Structural updates: predicate stacks (divergence, Fig. 2)
# ---------------------------------------------------------------------------

def pred_ok(pstack, pdepth, D: int):
    """Threads whose every pushed predicate level is True: ``(..., T)``."""
    lvl = torch.arange(D, dtype=_I32, device=pstack.device)
    return torch.all(pstack | (lvl >= pdepth[..., :, None]), dim=-1)


def pred_push(pstack, pdepth, cond, tsc_mask, D: int, en=True):
    """IF.cc: push ``cond`` at the current depth for TSC-active threads."""
    lvl = torch.arange(D, dtype=_I32, device=pstack.device)
    oh = (lvl == pdepth[..., :, None]) & tsc_mask[..., :, None] & en
    ps = torch.where(oh, cond[..., :, None], pstack)
    pd = pdepth + ((tsc_mask & (pdepth < D) & en).to(_I32))
    return ps, pd


def pred_else(pstack, pdepth, tsc_mask, D: int, en=True):
    """ELSE: flip the top predicate level of TSC-active threads."""
    lvl = torch.arange(D, dtype=_I32, device=pstack.device)
    oh = (lvl == (pdepth[..., :, None] - 1)) & tsc_mask[..., :, None] \
        & (pdepth[..., :, None] > 0) & en
    return pstack ^ oh


def pred_pop(pdepth, tsc_mask, en=True):
    """ENDIF: pop one predicate level from TSC-active threads."""
    return pdepth - (tsc_mask & (pdepth > 0) & en).to(_I32)


# ---------------------------------------------------------------------------
# Sequencer stacks (host side: control never depends on data)
# ---------------------------------------------------------------------------

def gather_index(i: int, n: int) -> int:
    """JAX's dynamic-gather index rule: a negative index wraps once,
    then the index is clamped into ``[0, n)``."""
    if i < 0:
        i += n
    return min(max(i, 0), n - 1)


def call_push(cstack: list, csp: int, ret_pc: int) -> int:
    """JSR: push the return address (write dropped when out of range;
    the pointer still moves).  Returns the new ``csp``."""
    if 0 <= csp < len(cstack):
        cstack[csp] = ret_pc
    return csp + 1


def call_top(cstack: list, csp: int) -> int:
    """RTS target: the last pushed return address."""
    return cstack[gather_index(csp - 1, len(cstack))]


def loop_init(lctr: list, lsp: int, count: int) -> int:
    """INIT: push a loop counter; returns the new ``lsp``."""
    if 0 <= lsp < len(lctr):
        lctr[lsp] = count
    return lsp + 1


def loop_step(lctr: list, lsp: int) -> tuple[bool, int]:
    """LOOP: decrement the top counter; returns ``(taken, lsp')``."""
    ltop = lctr[gather_index(lsp - 1, len(lctr))]
    taken = ltop > 0
    if 0 <= lsp - 1 < len(lctr):
        lctr[lsp - 1] = ltop - 1
    return taken, (lsp if taken else lsp - 1)
