"""A NumPy reference executor for whole-program verification (a copy of
the reference's framework-free ``repro.analysis.concrete``).

The interpreter is the semantic ground truth, but it runs a device step
per instruction — far too slow to run the analyzer's soundness suite
over hundreds of *generated* programs.  This module walks the same
static path with plain NumPy (the eGPU has no data-dependent branches,
so control flow is a host loop) and, unlike the device tiers, it
*observes* what the analyzer predicts:

* every LOD/STO effective address per pc (min/max over active threads,
  plus whether any active thread went out of bounds),
* peak predicate/loop/call stack depths and every underflow/overflow
  attempt,
* executed steps (to check the analyzer's static step count).

Data semantics mirror ``repro_torch.core.semantics`` bit-for-bit for the
integer ISA (the differential test in ``tests/`` cross-checks whole
machine states against the interpreter); FP ops are implemented
best-effort with NumPy float32 and are exact for add/sub/mul/min/max on
the CPU backend.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core import isa
from ..core.assembler import ProgramImage
from ..core.isa import Op, Typ

_U32 = np.uint32
_I32 = np.int32
_IF_SET = frozenset(int(o) for o in isa.IF_OPS)


def _f32(x):
    return x.view(np.float32)


def _bits(x):
    return np.asarray(x, np.float32).view(_U32)


def _sext16(x):
    v = (x & _U32(0xFFFF)).astype(np.int64)
    return np.where(v >= 1 << 15, v - (1 << 16), v)


def _sext24(x):
    v = (x & _U32(0xFFFFFF)).astype(np.int64)
    return np.where(v >= 1 << 23, v - (1 << 24), v)


def _bitrev32(x):
    x = ((x & _U32(0x55555555)) << _U32(1)) | ((x >> _U32(1)) & _U32(0x55555555))
    x = ((x & _U32(0x33333333)) << _U32(2)) | ((x >> _U32(2)) & _U32(0x33333333))
    x = ((x & _U32(0x0F0F0F0F)) << _U32(4)) | ((x >> _U32(4)) & _U32(0x0F0F0F0F))
    x = ((x & _U32(0x00FF00FF)) << _U32(8)) | ((x >> _U32(8)) & _U32(0x00FF00FF))
    return (x << _U32(16)) | (x >> _U32(16))


def _det_sum(v, num_sps: int):
    """The deterministic DOT/SUM reduction order (see semantics.det_sum)."""
    T = v.shape[-1]
    m = v.reshape(T // num_sps, num_sps)
    acc = m[0].copy()
    for i in range(1, T // num_sps):
        acc = acc + m[i]
    s = num_sps // 2
    while s >= 1:
        acc = acc[:s] + acc[s:2 * s]
        s //= 2
    return acc[0]


@dataclass
class ConcreteResult:
    """Everything the soundness tests compare against the analyzer."""

    halted: bool
    steps: int
    regs: np.ndarray                    # (T, R) uint32
    shared: np.ndarray                  # (S,) uint32
    #: pc -> (min, max) effective address over active threads
    observed_addr: dict[int, tuple[int, int]] = field(default_factory=dict)
    #: pcs where some active thread addressed outside [0, shared_words)
    oob_pcs: set[int] = field(default_factory=set)
    max_pred_depth: int = 0
    max_loop_depth: int = 0
    max_call_depth: int = 0
    #: attempted pushes beyond / pops below the configured stack limits
    stack_faults: set[str] = field(default_factory=set)
    executed_pcs: set[int] = field(default_factory=set)


def concrete_run(image: ProgramImage, threads: int | None = None, *,
                 tdx_dim: int = 16, shared_init: np.ndarray | None = None,
                 max_steps: int | None = None) -> ConcreteResult:
    cfg = image.cfg
    if threads is None:
        threads = image.threads_active or cfg.max_threads
    T, R, S = cfg.max_threads, cfg.regs_per_thread, cfg.shared_words
    LD, CD = cfg.max_loop_depth, cfg.max_call_depth
    D = max(1, cfg.predicate_levels)
    num_sps = cfg.num_sps
    w_rt = -(-threads // num_sps)
    wfs_by_depth = (1, w_rt, max(1, -(-w_rt // 2)), max(1, -(-w_rt // 4)))
    alu_mask = _U32((1 << cfg.alu_bits) - 1 if cfg.alu_bits < 32
                    else 0xFFFFFFFF)
    amt_mask = _U32(cfg.alu_bits - 1 if cfg.shift_bits > 1 else 1)
    cap = cfg.max_steps if max_steps is None else max_steps

    regs = np.zeros((T, R), _U32)
    shared = np.zeros(S, _U32)
    if shared_init is not None:
        buf = np.asarray(shared_init)
        if buf.dtype != _U32:
            buf = buf.astype(np.float32).view(_U32) \
                if buf.dtype.kind == "f" else buf.astype(_U32)
        shared[:len(buf)] = buf[:S]
    pstack = np.zeros((T, D), bool)
    pdepth = np.zeros(T, _I32)
    lctr = np.zeros(LD, np.int64)
    cstack = np.zeros(CD, np.int64)
    lsp = csp = 0
    tid = np.arange(T)
    lvl = np.arange(D)

    res = ConcreteResult(halted=False, steps=0, regs=regs, shared=shared)
    n = image.n
    op_a, typ_a, rd_a = image.op, image.typ, image.rd
    ra_a, rb_a, imm_a, tsc_a = image.ra, image.rb, image.imm, image.tsc
    pc = steps = 0

    def gidx(i: int, m: int) -> int:
        if i < 0:
            i += m
        return min(max(i, 0), m - 1)

    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        while 0 <= pc < n and steps < cap:
            op = int(op_a[pc])
            typ, rd = int(typ_a[pc]), int(rd_a[pc])
            ra, rb = int(ra_a[pc]), int(rb_a[pc])
            imm, tsc = int(imm_a[pc]), int(tsc_a[pc])
            res.executed_pcs.add(pc)
            lanes = isa.WIDTH_LANES[(tsc >> 2) & 3]
            wfs = wfs_by_depth[tsc & 3]
            tsc_mask = ((tid % num_sps < lanes) & (tid // num_sps < wfs)
                        & (tid < threads))
            pok = np.all(pstack | (lvl >= pdepth[:, None]), axis=-1)
            mask = tsc_mask & pok
            av, bv, dv = regs[:, ra], regs[:, rb], regs[:, rd]
            signed = typ == int(Typ.I32)
            steps += 1

            if op == int(Op.STOP):
                res.halted = True
                break
            if op == int(Op.JMP):
                pc = imm
                continue
            if op == int(Op.JSR):
                if csp >= CD:
                    res.stack_faults.add("call-overflow")
                else:
                    cstack[csp] = pc + 1
                csp += 1
                res.max_call_depth = max(res.max_call_depth, csp)
                pc = imm
                continue
            if op == int(Op.RTS):
                if csp <= 0:
                    res.stack_faults.add("call-underflow")
                pc = int(cstack[gidx(csp - 1, CD)])
                csp -= 1
                continue
            if op == int(Op.INIT):
                if lsp >= LD:
                    res.stack_faults.add("loop-overflow")
                else:
                    lctr[lsp] = imm
                lsp += 1
                res.max_loop_depth = max(res.max_loop_depth, lsp)
                pc += 1
                continue
            if op == int(Op.LOOP):
                if lsp <= 0:
                    res.stack_faults.add("loop-underflow")
                ltop = int(lctr[gidx(lsp - 1, LD)])
                if 0 <= lsp - 1 < LD:
                    lctr[lsp - 1] = ltop - 1
                if ltop > 0:
                    pc = imm
                else:
                    lsp -= 1
                    pc += 1
                continue
            if op == int(Op.NOP):
                pc += 1
                continue

            # ---- predicate ops
            if op in _IF_SET:
                cond = _if_cond(op, av, bv)
                oh = (lvl == pdepth[:, None]) & tsc_mask[:, None]
                pstack[:] = np.where(oh, cond[:, None], pstack)
                if np.any(tsc_mask & (pdepth >= D)):
                    res.stack_faults.add("pred-overflow")
                pdepth += np.where(tsc_mask & (pdepth < D), 1, 0)
                res.max_pred_depth = max(res.max_pred_depth,
                                         int(pdepth.max()))
                pc += 1
                continue
            if op == int(Op.ELSE):
                if np.any(tsc_mask & (pdepth == 0)):
                    res.stack_faults.add("pred-underflow")
                oh = (lvl == (pdepth[:, None] - 1)) & tsc_mask[:, None] \
                    & (pdepth[:, None] > 0)
                pstack[:] = pstack ^ oh
                pc += 1
                continue
            if op == int(Op.ENDIF):
                if np.any(tsc_mask & (pdepth == 0)):
                    res.stack_faults.add("pred-underflow")
                pdepth -= np.where(tsc_mask & (pdepth > 0), 1, 0)
                pc += 1
                continue

            # ---- memory
            if op in (int(Op.LOD), int(Op.STO)):
                addr = av.astype(_I32).astype(np.int64) + imm
                act = addr[mask]
                if len(act):
                    key = (int(act.min()), int(act.max()))
                    old = res.observed_addr.get(pc)
                    res.observed_addr[pc] = key if old is None else \
                        (min(old[0], key[0]), max(old[1], key[1]))
                    if key[0] < 0 or key[1] >= S:
                        res.oob_pcs.add(pc)
                if op == int(Op.LOD):
                    a = np.clip(addr, 0, S - 1)
                    val = shared[a]
                    regs[:, rd] = np.where(mask, val, dv)
                else:
                    ok = mask & (addr >= 0) & (addr < S)
                    shared[addr[ok]] = regs[ok, rd]
                pc += 1
                continue

            # ---- value ops
            val = _value(op, typ, signed, av, bv, imm, tid, tdx_dim,
                         mask, num_sps, alu_mask, amt_mask, cfg)
            if val is not None:
                wmask = mask & (tid == 0) \
                    if op in (int(Op.DOT), int(Op.SUM)) else mask
                regs[:, rd] = np.where(wmask, val, dv)
            pc += 1

    res.steps = steps
    if not res.halted and not (0 <= pc < n):
        res.halted = True      # fell into the padded STOP tail
    return res


def _if_cond(op: int, av, bv):
    fa, fb = _f32(av), _f32(bv)
    ia, ib = av.astype(_I32), bv.astype(_I32)
    table = {
        int(Op.IF_EQ): av == bv, int(Op.IF_NE): av != bv,
        int(Op.IF_LT): ia < ib, int(Op.IF_LO): av < bv,
        int(Op.IF_LE): ia <= ib, int(Op.IF_LS): av <= bv,
        int(Op.IF_GT): ia > ib, int(Op.IF_HI): av > bv,
        int(Op.IF_GE): ia >= ib, int(Op.IF_HS): av >= bv,
        int(Op.IF_FEQ): fa == fb, int(Op.IF_FNE): fa != fb,
        int(Op.IF_FLT): fa < fb, int(Op.IF_FLE): fa <= fb,
        int(Op.IF_FGT): fa > fb, int(Op.IF_FGE): fa >= fb,
        int(Op.IF_Z): av == 0, int(Op.IF_NZ): av != 0,
    }
    return table[op]


def _value(op, typ, signed, av, bv, imm, tid, tdx_dim, mask, num_sps,
           alu_mask, amt_mask, cfg):
    """Result vector of one value op, or None for non-writing ops."""
    def im(x):
        return x.astype(_U32) & alu_mask

    amt = (bv & amt_mask).astype(np.uint64)
    if op == int(Op.ADD):
        return im(av + bv)
    if op == int(Op.SUB):
        return im(av - bv)
    if op == int(Op.NEG):
        return im((-av.astype(_I32)).astype(_U32))
    if op == int(Op.ABS):
        return im(np.abs(av.astype(_I32)).astype(_U32))
    if op == int(Op.MUL16LO):
        p_s = _sext16(av) * _sext16(bv)
        p_u = (av & _U32(0xFFFF)).astype(np.uint64) * (bv & _U32(0xFFFF))
        return im((p_s if signed else p_u) & 0xFFFFFFFF)
    if op == int(Op.MUL16HI):
        p_s = (_sext16(av) * _sext16(bv)) >> 16
        p_u = (((av & _U32(0xFFFF)).astype(np.uint64)
                * (bv & _U32(0xFFFF))) & 0xFFFFFFFF) >> 16
        return im((p_s if signed else p_u.astype(np.int64)) & 0xFFFFFFFF)
    if op == int(Op.MUL24LO):
        p = (_sext24(av) * _sext24(bv)) if signed else \
            (av & _U32(0xFFFFFF)).astype(np.int64) * (bv & _U32(0xFFFFFF))
        return im(p & 0xFFFFFFFF)
    if op == int(Op.MUL24HI):
        if signed:
            return im(((_sext24(av) * _sext24(bv)) >> 24) & 0xFFFFFFFF)
        p = (av & _U32(0xFFFFFF)).astype(np.int64) * (bv & _U32(0xFFFFFF))
        return im(p >> 24)
    if op == int(Op.AND):
        return im(av & bv)
    if op == int(Op.OR):
        return im(av | bv)
    if op == int(Op.XOR):
        return im(av ^ bv)
    if op == int(Op.NOT):
        return im(~av)
    if op == int(Op.CNOT):
        return im(np.where(av == 0, _U32(1), _U32(0)))
    if op == int(Op.BVS):
        return im(_bitrev32(av))
    if op == int(Op.SHL):
        return im((av.astype(np.uint64) << amt) & 0xFFFFFFFF)
    if op == int(Op.SHR):
        if signed:
            return im((av.astype(_I32).astype(np.int64) >> amt.astype(
                np.int64)).astype(np.int64) & 0xFFFFFFFF)
        return im(av.astype(np.uint64) >> amt)
    if op == int(Op.POP):
        return im(np.array([bin(int(v)).count("1") for v in av],
                           np.uint32))
    if op == int(Op.MAX):
        return im(np.where(av.astype(_I32) > bv.astype(_I32), av, bv)
                  if signed else np.maximum(av, bv))
    if op == int(Op.MIN):
        return im(np.where(av.astype(_I32) < bv.astype(_I32), av, bv)
                  if signed else np.minimum(av, bv))
    if op == int(Op.LODI):
        return im(np.full(av.shape, np.int64(imm) & 0xFFFFFFFF,
                          np.uint64))
    if op == int(Op.TDX):
        return im((tid % max(1, tdx_dim)).astype(_U32))
    if op == int(Op.TDY):
        return im((tid // max(1, tdx_dim)).astype(_U32))
    if op == int(Op.FADD):
        return _bits(_f32(av) + _f32(bv))
    if op == int(Op.FSUB):
        return _bits(_f32(av) - _f32(bv))
    if op == int(Op.FNEG):
        return av ^ _U32(0x80000000)
    if op == int(Op.FABS):
        return av & _U32(0x7FFFFFFF)
    if op == int(Op.FMUL):
        return _bits(_f32(av) * _f32(bv))
    if op == int(Op.FMAX):
        return _bits(np.maximum(_f32(av), _f32(bv)))
    if op == int(Op.FMIN):
        return _bits(np.minimum(_f32(av), _f32(bv)))
    if op == int(Op.DOT):
        s = _det_sum(np.where(mask, _f32(av) * _f32(bv),
                              np.float32(0.0)), num_sps)
        return np.broadcast_to(_bits(s), av.shape)
    if op == int(Op.SUM):
        s = _det_sum(np.where(mask, _f32(av), np.float32(0.0)), num_sps)
        return np.broadcast_to(_bits(s), av.shape)
    if op == int(Op.INVSQR):
        return _bits(np.float32(1.0) / np.sqrt(_f32(av)))
    return None
