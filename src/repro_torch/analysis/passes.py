"""CFG dataflow passes over the packed eGPU program image
(a copy of the reference's framework-free ``repro.analysis.passes``).

One forward worklist fixpoint carries three abstract domains at once —
they share the walk because they feed each other:

* **stacks** — concrete predicate depth, loop-counter stack (values +
  provenance of the INIT that pushed them) and call stack (return
  addresses).  The ISA pushes immediates only, so depths and return
  targets are usually *exactly* known; a join of conflicting depths
  degrades the stack to unknown and reports a balance conflict.
* **register coverage** (reaching definitions per thread-space
  personality) — per register, the set of maximal `(lanes, wavefronts)`
  rectangles definitely written on *every* path.  Thread spaces are
  origin-anchored rectangles in the (lane, wavefront) grid, so "read
  covered by prior writes" reduces to single-rectangle dominance.
* **register intervals** — `[lo, hi]` value ranges over the uint32
  register file, with exact constant evaluation when operands are
  singletons (shared with the optimizer's constant folder) and per-op
  interval rules otherwise.  A predicated or narrow-TSC write *joins*
  with the old value (threads outside the mask keep theirs) — only an
  unpredicated full-space write replaces.

After the fixpoint a single reporting walk over the stable entry states
emits :class:`Diagnostic` objects with path witnesses, then the
structural passes run: unreachable code, halt reachability, structured
trip-count / static step estimation, trace-budget prediction, and a
backward liveness pass for dead writes.
"""
from __future__ import annotations

import threading
from collections import Counter, OrderedDict, deque
from typing import Any

import numpy as np

from ..core import cfg as cfg_mod
from ..core import isa
from ..core.assembler import ProgramImage
from ..core.config import EGPUConfig
from ..core.executor import (_PF_IMM, _PF_OP, _PF_RA, _PF_RB, _PF_RD,
                             _PF_TSC, _PF_TYP)
from ..core.isa import NUM_OPCODES, Op
from .diagnostics import AnalysisReport, Diagnostic, Severity

_M32 = 0xFFFFFFFF

#: semantic read sets (the hazard sets in ``isa`` are conservative: SUM
#: is scheduled as two-source but only reads Ra)
_READS_RA = frozenset(int(o) for o in isa.READS_RA)
_READS_RB = frozenset(int(o) for o in isa.READS_RB if o != Op.SUM)
_READS_RD = frozenset(int(o) for o in isa.READS_RD)
_WRITES = frozenset(int(o) for o in isa.REG_WRITE_OPS)
_IF_OPS = frozenset(int(o) for o in isa.IF_OPS)

#: integer value ops with an exact Python evaluator (= the foldable set)
_INT_EVAL_OPS = frozenset(int(o) for o in (
    Op.ADD, Op.SUB, Op.NEG, Op.ABS, Op.MUL16LO, Op.MUL16HI,
    Op.MUL24LO, Op.MUL24HI, Op.AND, Op.OR, Op.XOR, Op.NOT, Op.CNOT,
    Op.BVS, Op.SHL, Op.SHR, Op.POP, Op.MAX, Op.MIN))

_WIDEN_AT = 8            # joins per block before interval widening
_MAX_BLOCK_EXECS = 20000  # fixpoint budget (blocks are re-run on change)
_WITNESS_CAP = 24


# ---------------------------------------------------------------------------
# Exact integer semantics (Python ints, mirrors ``semantics.build_spec``)
# ---------------------------------------------------------------------------

def _sext(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >= 1 << (bits - 1) else v


def eval_int(op: int, typ: int, a: int, b: int, cfg: EGPUConfig) -> int | None:
    """Bit-exact result of one integer value op on uint32 operands, or
    ``None`` for ops without a pure integer evaluator (FP, LOD, ...).

    This is the single constant-evaluation routine shared by the
    interval analysis and the optimizer's constant folder, so a folded
    LODI is bit-identical to the instruction it replaces by
    construction."""
    if op not in _INT_EVAL_OPS:
        return None
    mask = (1 << cfg.alu_bits) - 1 if cfg.alu_bits < 32 else _M32
    signed = typ == int(isa.Typ.I32)
    amt = b & (cfg.alu_bits - 1 if cfg.shift_bits > 1 else 1)
    if op == int(Op.ADD):
        r = (a + b) & _M32
    elif op == int(Op.SUB):
        r = (a - b) & _M32
    elif op == int(Op.NEG):
        r = (-_sext(a, 32)) & _M32
    elif op == int(Op.ABS):
        r = abs(_sext(a, 32)) & _M32
    elif op == int(Op.MUL16LO):
        r = ((_sext(a, 16) * _sext(b, 16)) if signed
             else (a & 0xFFFF) * (b & 0xFFFF)) & _M32
    elif op == int(Op.MUL16HI):
        if signed:
            r = ((_sext(a, 16) * _sext(b, 16)) >> 16) & _M32
        else:
            r = (((a & 0xFFFF) * (b & 0xFFFF)) & _M32) >> 16
    elif op == int(Op.MUL24LO):
        p = (_sext(a, 24) * _sext(b, 24)) if signed \
            else (a & 0xFFFFFF) * (b & 0xFFFFFF)
        r = p & _M32
    elif op == int(Op.MUL24HI):
        if signed:
            r = ((_sext(a, 24) * _sext(b, 24)) >> 24) & _M32
        else:
            r = ((a & 0xFFFFFF) * (b & 0xFFFFFF)) >> 24
    elif op == int(Op.AND):
        r = a & b
    elif op == int(Op.OR):
        r = a | b
    elif op == int(Op.XOR):
        r = a ^ b
    elif op == int(Op.NOT):
        r = (~a) & _M32
    elif op == int(Op.CNOT):
        r = 1 if a == 0 else 0
    elif op == int(Op.BVS):
        r = int(f"{a:032b}"[::-1], 2)
    elif op == int(Op.SHL):
        r = (a << amt) & _M32
    elif op == int(Op.SHR):
        r = (_sext(a, 32) >> amt) & _M32 if signed else a >> amt
    elif op == int(Op.POP):
        r = bin(a).count("1")
    elif op == int(Op.MAX):
        r = (a if _sext(a, 32) > _sext(b, 32) else b) if signed \
            else max(a, b)
    else:  # MIN
        r = (a if _sext(a, 32) < _sext(b, 32) else b) if signed \
            else min(a, b)
    return r & mask


# ---------------------------------------------------------------------------
# Interval domain (uint32; None == unknown == [0, 2**32))
# ---------------------------------------------------------------------------

def _iv_join(a, b):
    if a is None or b is None:
        return None
    return (min(a[0], b[0]), max(a[1], b[1]))


def _masked(iv, mask: int):
    """Post-ALU precision clip: a known hull survives only if masking is
    the identity on it; otherwise the mask itself is the bound."""
    if iv is not None and 0 <= iv[0] and iv[1] <= mask:
        return iv
    return (0, mask) if mask < _M32 else None


def _iv_signed(iv):
    """uint32 hull -> signed int32 hull, or None when it straddles."""
    if iv is None:
        return None
    lo, hi = iv
    if hi < 1 << 31:
        return (lo, hi)
    if lo >= 1 << 31:
        return (lo - (1 << 32), hi - (1 << 32))
    return None


def _iv_transfer(op: int, typ: int, a, b, imm: int, cfg: EGPUConfig,
                 threads: int, tdx_dim: int):
    """Per-op interval rule for non-constant operands."""
    mask = (1 << cfg.alu_bits) - 1 if cfg.alu_bits < 32 else _M32
    signed = typ == int(isa.Typ.I32)

    if op == int(Op.LODI):
        v = (imm & _M32) & mask if imm >= 0 else (imm + (1 << 32)) & mask
        return (v, v)
    if op == int(Op.TDX):
        return _masked((0, max(0, min(tdx_dim, threads) - 1)), mask)
    if op == int(Op.TDY):
        return _masked((0, (threads - 1) // max(1, tdx_dim)), mask)
    if op == int(Op.CNOT):
        return (0, 1)
    if op == int(Op.POP):
        return _masked((0, 32), mask)
    unk = _masked(None, mask) if op in _INT_EVAL_OPS else None
    if a is None or (op in _READS_RB and b is None):
        return unk
    if op == int(Op.ADD) and b is not None:
        hi = a[1] + b[1]
        return _masked((a[0] + b[0], hi), mask) if hi <= _M32 else \
            _masked(None, mask)
    if op == int(Op.SUB) and b is not None:
        if a[0] - b[1] >= 0:
            return _masked((a[0] - b[1], a[1] - b[0]), mask)
        return _masked(None, mask)
    if op == int(Op.AND) and b is not None:
        return _masked((0, min(a[1], b[1])), mask)
    if op in (int(Op.OR), int(Op.XOR)) and b is not None:
        bits = max(a[1].bit_length(), b[1].bit_length())
        lo = max(a[0], b[0]) if op == int(Op.OR) else 0
        return _masked((lo, (1 << bits) - 1), mask)
    if op == int(Op.SHL) and b is not None and b[0] == b[1]:
        amt = b[0] & (cfg.alu_bits - 1 if cfg.shift_bits > 1 else 1)
        hi = a[1] << amt
        return _masked((a[0] << amt, hi), mask) if hi <= _M32 else \
            _masked(None, mask)
    if op == int(Op.SHR) and b is not None and b[0] == b[1]:
        if signed and a[1] >= 1 << 31:
            return _masked(None, mask)
        amt = b[0] & (cfg.alu_bits - 1 if cfg.shift_bits > 1 else 1)
        return _masked((a[0] >> amt, a[1] >> amt), mask)
    if op in (int(Op.MIN), int(Op.MAX)) and b is not None:
        if signed and (a[1] >= 1 << 31 or b[1] >= 1 << 31):
            return _masked(None, mask)
        f = min if op == int(Op.MIN) else max
        return _masked((f(a[0], b[0]), f(a[1], b[1])), mask)
    if op == int(Op.MUL16LO) and b is not None \
            and a[1] <= 0xFFFF and b[1] <= 0xFFFF \
            and (not signed or (a[1] <= 0x7FFF and b[1] <= 0x7FFF)):
        return _masked((a[0] * b[0], a[1] * b[1]), mask)
    if op == int(Op.MUL24LO) and b is not None \
            and a[1] <= 0xFFFFFF and b[1] <= 0xFFFFFF \
            and a[1] * b[1] <= _M32 \
            and (not signed or (a[1] <= 0x7FFFFF and b[1] <= 0x7FFFFF)):
        return _masked((a[0] * b[0], a[1] * b[1]), mask)
    if op == int(Op.ABS) and (not signed or a[1] < 1 << 31):
        return _masked(a, mask)
    if op in _INT_EVAL_OPS:
        return _masked(None, mask)
    return None          # FP / LOD / DOT / SUM / INVSQR: full uint32


# ---------------------------------------------------------------------------
# Coverage domain: maximal origin-anchored (lanes, wavefronts) rectangles
# ---------------------------------------------------------------------------

def _rects_max(rects) -> frozenset:
    out = set()
    for r in rects:
        if not any(o != r and o[0] >= r[0] and o[1] >= r[1] for o in rects):
            out.add(r)
    return frozenset(out)


def _cov_join(a: frozenset, b: frozenset) -> frozenset:
    """Intersection of the two covered sets (must-analysis join)."""
    if a == b:
        return a
    return _rects_max({(min(x[0], y[0]), min(x[1], y[1]))
                       for x in a for y in b})


def _cov_add(cov: frozenset, rect) -> frozenset:
    return cov if _covers(cov, rect) else _rects_max(set(cov) | {rect})


def _cov_union(a: frozenset, b: frozenset) -> frozenset:
    """Union of two covered sets (both writes are guaranteed)."""
    return _rects_max(set(a) | set(b))


def _covers(cov: frozenset, rect) -> bool:
    return any(l >= rect[0] and w >= rect[1] for l, w in cov)


# ---------------------------------------------------------------------------
# The abstract state
# ---------------------------------------------------------------------------
#
# state = (pred, loops, calls, regs)
#   pred  : int predicate depth | None (unknown/conflicting)
#   loops : tuple of (counter_value | None, init_pc | None) | None
#   calls : tuple of return pcs (int | None) | None
#   regs  : tuple per register of (interval, coverage, maybe_written)

_REG0 = ((0, 0), frozenset(), False)     # zero-initialised, never written


def _join_stacks(a, b, kind: str, conflicts: set):
    if a is None or b is None:
        return None
    if len(a) != len(b):
        conflicts.add(kind)
        return None
    if kind == "loops":
        return tuple((va if va == vb else None, pa if pa == pb else None)
                     for (va, pa), (vb, pb) in zip(a, b))
    return tuple(x if x == y else None for x, y in zip(a, b))


def _join_state(a, b, conflicts: set):
    if a is None:
        return b
    pa, la, ca, ra = a
    pb, lb, cb, rb = b
    if pa is None or pb is None:
        pred = None
    elif pa == pb:
        pred = pa
    else:
        conflicts.add("pred")
        pred = None
    loops = _join_stacks(la, lb, "loops", conflicts)
    calls = _join_stacks(ca, cb, "calls", conflicts)
    regs = tuple(
        (x if x == y else
         (_iv_join(x[0], y[0]), _cov_join(x[1], y[1]), x[2] or y[2]))
        for x, y in zip(ra, rb))
    return (pred, loops, calls, regs)


def _widen(new, old):
    """Drop intervals that are still moving (guarantees termination)."""
    if old is None:
        return new
    pred, loops, calls, regs = new
    regs = tuple(
        (None if (x[0] != y[0] and x[0] is not None) else x[0], x[1], x[2])
        for x, y in zip(regs, old[3]))
    return (pred, loops, calls, regs)


# ---------------------------------------------------------------------------
# The analyzer
# ---------------------------------------------------------------------------

class _Reporter:
    """Diagnostic sink for the post-fixpoint reporting walk."""

    def __init__(self):
        self.diags: list[Diagnostic] = []
        self._seen: set[tuple[str, int]] = set()
        self.access_verdicts: dict[int, str] = {}
        self.loop_trips: dict[int, Any] = {}
        self.fold_candidates: dict[int, int] = {}
        self.pred_at: dict[int, int | None] = {}
        self.max_depth = {"pred": 0, "loops": 0, "calls": 0}

    def diag(self, sev: Severity, code: str, pc: int, msg: str,
             path=()) -> None:
        if (code, pc) in self._seen:
            return
        self._seen.add((code, pc))
        self.diags.append(Diagnostic(sev, code, pc, msg, tuple(path)))


class _Analyzer:
    def __init__(self, image: ProgramImage, threads: int, tdx_dim: int):
        cfg = image.cfg
        self.cfg = cfg
        self.n = image.n
        self.threads = threads
        self.tdx_dim = max(1, int(tdx_dim))
        self.packed = np.stack(
            [image.op, image.typ, image.rd, image.ra, image.rb,
             image.imm, image.tsc], axis=1).astype(np.int64)
        self.g = cfg_mod.build_cfg(self.packed, self.n)
        w_rt = -(-threads // cfg.num_sps)
        self.w_rt = w_rt
        self.wfs_table = (1, w_rt, max(1, -(-w_rt // 2)),
                          max(1, -(-w_rt // 4)))
        self.D = max(1, cfg.predicate_levels)
        self.S = cfg.shared_words
        self.nregs = cfg.regs_per_thread
        self.states: dict[int, Any] = {}
        self.witness: dict[int, tuple] = {}
        self.conflicts: set = set()
        self.hard_faults: dict[tuple[str, int], str] = {}

    def _fault(self, rep, code: str, pc: int, msg: str, path=()) -> None:
        """Record a stack-discipline ERROR.  These must be captured even
        during the fixpoint pass (``rep is None``): the fault degrades the
        abstract stack to ``None``, and the CFG join can erase that
        evidence before the reporting replay ever sees a concrete stack
        at the faulting block again."""
        self.hard_faults.setdefault((code, pc), msg)
        if rep:
            rep.diag(Severity.ERROR, code, pc, msg, path)

    # ------------------------------------------------------------ fields
    def _ins(self, pc: int):
        row = self.packed[pc]
        return (int(row[_PF_OP]), int(row[_PF_TYP]), int(row[_PF_RD]),
                int(row[_PF_RA]), int(row[_PF_RB]), int(row[_PF_IMM]),
                int(row[_PF_TSC]))

    def _space(self, tsc: int):
        """(lanes, wavefronts, is_full) of one instruction's TSC."""
        lanes = isa.WIDTH_LANES[(tsc >> 2) & 3]
        wfs = self.wfs_table[tsc & 3]
        return lanes, wfs, (lanes == self.cfg.num_sps and wfs == self.w_rt)

    @staticmethod
    def _pers(lanes: int, wfs: int) -> str:
        return f"{lanes} lane(s) x {wfs} wavefront(s)"

    # ---------------------------------------------------------- transfer
    def _exec_block(self, st, bi: int, rep: _Reporter | None):
        """Run one block's transfer; returns ``{(succ_block, kind): state}``
        restricted to feasible edges."""
        cfg = self.cfg
        s, e = self.g.blocks[bi]
        pred, loops, calls, regs = st
        regs = list(regs)
        path = self.witness.get(bi, ()) + (s,) if rep else ()
        halt_rts = False
        # In-block IF/ELSE arm tracking: a register written in *both*
        # arms of a predicate region is, at the matching ENDIF, covered
        # by the intersection of the arm rectangles — the two masks are
        # complementary, so together the writes reach every thread the
        # enclosing context enables.  IF/ELSE/ENDIF are straight-line
        # ops here (not branches), so the whole region sits in one
        # block.  Frames: [state(0=then,1=else,2=dead), thn, els]; a
        # second ELSE flips the mask back, so it kills the frame.
        frames: list = []
        frames_ok = True
        for pc in range(s, e):
            op, typ, rd, ra, rb, imm, tsc = self._ins(pc)
            if op >= NUM_OPCODES:
                if rep:
                    rep.diag(Severity.ERROR, "bad-opcode", pc,
                             f"opcode {op} is not in the 61-op ISA", path)
                continue
            if (tsc >> 2) & 3 == 3 and rep:
                rep.diag(Severity.ERROR, "undefined-tsc-width", pc,
                         "TSC width coding '11' is undefined (Table 3)",
                         path)
            lanes, wfs, full = self._space(tsc)
            predicated = pred is None or pred > 0
            if rep:
                rep.pred_at[pc] = pred
                self._check_reads(rep, pc, op, ra, rb, rd, regs,
                                  lanes, wfs, path, frames, frames_ok)
            # ---- sequencer / predicate structure
            if op == int(Op.JSR):
                if calls is not None:
                    if len(calls) >= cfg.max_call_depth:
                        self._fault(rep, "call-overflow", pc,
                                    f"JSR beyond max_call_depth="
                                    f"{cfg.max_call_depth} drops the "
                                    f"return address", path)
                        calls = None
                    else:
                        calls = calls + (pc + 1,)
                        if rep:
                            rep.max_depth["calls"] = max(
                                rep.max_depth["calls"], len(calls))
            elif op == int(Op.RTS):
                if calls is not None and not calls:
                    self._fault(rep, "call-underflow", pc,
                                "RTS with an empty call stack jumps to "
                                "an undefined return address", path)
                    halt_rts = True
                elif calls is not None:
                    calls = calls[:-1]
            elif op == int(Op.INIT):
                if loops is not None:
                    if len(loops) >= cfg.max_loop_depth:
                        self._fault(rep, "loop-overflow", pc,
                                    f"INIT beyond max_loop_depth="
                                    f"{cfg.max_loop_depth} drops the "
                                    f"counter", path)
                        loops = None
                    else:
                        loops = loops + ((imm, pc),)
                        if rep:
                            rep.max_depth["loops"] = max(
                                rep.max_depth["loops"], len(loops))
            elif op == int(Op.LOOP):
                if loops is not None and not loops:
                    self._fault(rep, "loop-underflow", pc,
                                "LOOP with an empty loop stack reads an "
                                "undefined counter", path)
                    loops = None
            elif op in _IF_OPS:
                if cfg.predicate_levels == 0 and rep:
                    rep.diag(Severity.WARN, "no-predicate-hw", pc,
                             "IF.cc on a config with predicate_levels=0 "
                             "(runtime emulates a single level)", path)
                if not full:
                    # the push reaches only TSC-active threads: the
                    # per-thread depths diverge and the scalar model
                    # loses them
                    pred = None
                    frames_ok = False
                elif pred is not None:
                    if pred >= self.D:
                        self._fault(rep, "pred-overflow", pc,
                                    f"IF.cc beyond predicate_levels="
                                    f"{self.D} drops the push and "
                                    f"desynchronises ENDIF", path)
                        frames_ok = False
                    else:
                        pred += 1
                        frames.append([0, {}, {}])
                        if rep:
                            rep.max_depth["pred"] = max(
                                rep.max_depth["pred"], pred)
                else:
                    frames_ok = False
            elif op == int(Op.ELSE):
                if pred == 0:
                    self._fault(rep, "pred-underflow", pc,
                                "ELSE without an open IF", path)
                if not full:
                    frames_ok = False    # flips only a subset of threads
                if frames:
                    frames[-1][0] = min(frames[-1][0] + 1, 2)
            elif op == int(Op.ENDIF):
                if not full:
                    pred = None          # pops only a subset of threads
                    frames_ok = False
                elif pred == 0:
                    self._fault(rep, "pred-underflow", pc,
                                "ENDIF without an open IF", path)
                elif pred is not None:
                    pred -= 1
                    if frames:
                        fstate, thn, els = frames.pop()
                        if frames_ok and fstate == 1:
                            for r in thn.keys() & els.keys():
                                m = _cov_join(thn[r], els[r])
                                if frames:
                                    f = frames[-1]
                                    arm = f[2] if f[0] else f[1]
                                    arm[r] = _cov_union(
                                        arm.get(r, frozenset()), m)
                                elif pred == 0:
                                    iv, cov, _w = regs[r]
                                    regs[r] = (iv, _cov_union(cov, m),
                                               True)
                else:
                    frames_ok = False
            # ---- memory bounds
            if op in (int(Op.LOD), int(Op.STO)) and rep:
                self._check_access(rep, pc, op, regs[ra][0], imm,
                                   predicated, path)
            # ---- register writes
            if op in _WRITES:
                a_iv, b_iv = regs[ra][0], regs[rb][0]
                iv = None
                if a_iv is not None and a_iv[0] == a_iv[1] \
                        and op in _INT_EVAL_OPS \
                        and (op not in _READS_RB
                             or (b_iv is not None and b_iv[0] == b_iv[1])):
                    bval = b_iv[0] if b_iv is not None else 0
                    v = eval_int(op, typ, a_iv[0], bval, cfg)
                    if v is not None:
                        iv = (v, v)
                        if rep and not predicated:
                            rep.fold_candidates[pc] = v
                if iv is None:
                    iv = _iv_transfer(op, typ, a_iv, b_iv, imm, cfg,
                                      self.threads, self.tdx_dim)
                rect = (1, 1) if op in (int(Op.DOT), int(Op.SUM)) \
                    else (lanes, wfs)
                old = regs[rd]
                if full and not predicated \
                        and op not in (int(Op.DOT), int(Op.SUM)):
                    regs[rd] = (iv, _cov_add(old[1], rect), True)
                else:
                    cov = old[1] if predicated else _cov_add(old[1], rect)
                    regs[rd] = (_iv_join(old[0], iv), cov, True)
                    if frames_ok and frames and frames[-1][0] < 2 \
                            and pred is not None:
                        arm = frames[-1][1 + frames[-1][0]]
                        arm[rd] = _cov_union(arm.get(rd, frozenset()),
                                             frozenset((rect,)))
        # ------------------------------------------------------ edges
        out_state = (pred, loops, calls, tuple(regs))
        outs: dict[tuple[int, str], Any] = {}
        term_op = self._ins(e - 1)[0]
        for sb, kind in self.g.succs[bi]:
            if kind == "loop_back":
                if loops is None:
                    outs[(sb, kind)] = out_state
                elif loops:
                    v, ip = loops[-1]
                    if v is None or v > 0:
                        outs[(sb, kind)] = (pred, loops[:-1] + ((None, ip),),
                                            calls, tuple(regs))
            elif kind == "loop_exit":
                if loops is None:
                    outs[(sb, kind)] = out_state
                elif loops:
                    v, _ = loops[-1]
                    if v is None or v <= 0:
                        outs[(sb, kind)] = (pred, loops[:-1], calls,
                                            tuple(regs))
            elif kind == "return":
                if halt_rts:
                    continue
                if calls is None:
                    outs[(sb, kind)] = (pred, loops, None, tuple(regs))
                else:
                    ret = calls[-1] if calls else None
                    popped = (pred, loops, calls[:-1], tuple(regs))
                    if ret is None:
                        outs[(sb, kind)] = popped
                    elif self.g.block_of.get(ret) == sb:
                        outs[(sb, kind)] = popped
            else:
                outs[(sb, kind)] = out_state
        if rep and term_op == int(Op.LOOP) and loops not in (None, ()):
            v, ip = loops[-1]
            init_imm = self._ins(ip)[5] if ip is not None else None
            prev = rep.loop_trips.get(e - 1, "unset")
            trips = (max(init_imm, 0) + 1) if init_imm is not None else None
            rep.loop_trips[e - 1] = trips if prev in ("unset", trips) \
                else None
        return outs

    # -------------------------------------------------------- read checks
    def _check_reads(self, rep, pc, op, ra, rb, rd, regs, lanes, wfs, path,
                     frames=(), frames_ok=False):
        reads = []
        if op in _READS_RA:
            reads.append(("Ra", ra))
        if op in _READS_RB:
            reads.append(("Rb", rb))
        if op in _READS_RD:
            reads.append(("Rd", rd))
        for role, r in reads:
            iv, cov, maybe = regs[r]
            if _covers(cov, (lanes, wfs)):
                continue
            # a write earlier in a still-open predicate arm is seen by
            # exactly the threads that made it: a read under the same
            # (or deeper) mask chain is defined where it executes
            if frames_ok and any(
                    f[0] < 2 and _covers(f[1 + f[0]].get(r, frozenset()),
                                         (lanes, wfs))
                    for f in frames):
                continue
            if not cov and not maybe:
                rep.diag(Severity.WARN, "undefined-read", pc,
                         f"{Op(op).name} reads {role}=r{r} which no path "
                         f"writes first (reads as 0 here; undefined in "
                         f"hardware)", path)
            else:
                rep.diag(Severity.WARN, "partial-def-read", pc,
                         f"{Op(op).name} reads {role}=r{r} over "
                         f"{self._pers(lanes, wfs)} but definite writes "
                         f"cover a narrower thread space (or are "
                         f"predicate-gated)", path)

    def _check_access(self, rep, pc, op, ra_iv, imm, predicated, path):
        name = Op(op).name
        sv = _iv_signed(ra_iv)
        if sv is None:
            rep.access_verdicts[pc] = "unproven"
            rep.diag(Severity.INFO, "unproven-bounds", pc,
                     f"{name} address Ra{imm:+d} has unknown range "
                     f"(interval analysis lost it)", path)
            return
        lo, hi = sv[0] + imm, sv[1] + imm
        if hi < 0 or lo >= self.S:
            rep.access_verdicts[pc] = "oob"
            sev = Severity.WARN if predicated else Severity.ERROR
            code = "oob-access-predicated" if predicated else "oob-access"
            rep.diag(sev, code, pc,
                     f"{name} address in [{lo}, {hi}] is entirely outside "
                     f"shared memory [0, {self.S})"
                     + (" (predicate-gated)" if predicated else ""), path)
        elif lo >= 0 and hi < self.S:
            rep.access_verdicts[pc] = "proved"
        else:
            rep.access_verdicts[pc] = "unproven"
            rep.diag(Severity.INFO, "unproven-bounds", pc,
                     f"{name} address in [{lo}, {hi}] may straddle shared "
                     f"memory [0, {self.S})", path)

    # ----------------------------------------------------------- fixpoint
    def run(self) -> AnalysisReport:
        entry = (0, (), (), tuple([_REG0] * self.nregs))
        self.states[0] = entry
        self.witness[0] = ()
        visits: Counter = Counter()
        work = deque([0])
        budget = _MAX_BLOCK_EXECS
        clipped = False
        while work and budget:
            budget -= 1
            bi = work.popleft()
            outs = self._exec_block(self.states[bi], bi, None)
            for (sb, _kind), ost in outs.items():
                joined = _join_state(self.states.get(sb), ost,
                                     self.conflicts)
                if joined != self.states.get(sb):
                    visits[sb] += 1
                    if visits[sb] > _WIDEN_AT:
                        joined = _widen(joined, self.states.get(sb))
                    if joined != self.states.get(sb):
                        self.states[sb] = joined
                        self.witness[sb] = (self.witness.get(bi, ())
                                            + (self.g.blocks[bi][0],)
                                            )[-_WITNESS_CAP:]
                        if sb not in work:
                            work.append(sb)
        if work:
            clipped = True

        rep = _Reporter()
        for bi in sorted(self.states):
            self._exec_block(self.states[bi], bi, rep)
        self._structural(rep, clipped)
        facts = self._facts(rep, clipped)
        report = AnalysisReport(diagnostics=rep.diags, facts=facts)
        return report

    # --------------------------------------------------------- structural
    def _structural(self, rep: _Reporter, clipped: bool) -> None:
        g = self.g
        if clipped:
            rep.diag(Severity.INFO, "analysis-budget", -1,
                     "fixpoint budget exhausted; remaining findings are "
                     "best-effort")
        for pc, op, tgt in g.bad_targets:
            rep.diag(Severity.ERROR, "bad-branch-target", pc,
                     f"{Op(op).name} target {tgt} is outside the "
                     f"{self.n}-instruction image")
        for kind in sorted(self.conflicts):
            rep.diag(Severity.ERROR, "stack-conflict", -1,
                     f"conflicting {kind.rstrip('s')} stack depths meet at "
                     f"a CFG join (unbalanced push/pop across paths, or "
                     f"recursion)")
        # stack faults seen only on fixpoint paths (the fault poisons the
        # abstract stack to None, and the join can erase the evidence
        # before the reporting replay runs)
        seen = {(d.code, d.pc) for d in rep.diags}
        for (code, pc), msg in sorted(self.hard_faults.items(),
                                      key=lambda kv: kv[0][1]):
            if (code, pc) not in seen:
                rep.diag(Severity.ERROR, code, pc,
                         msg + " (reached along a fixpoint path whose "
                               "stack state was later lost at a join)")
        # unreachable code (skip the assembler's auto-appended final STOP)
        for bi, (s, e) in enumerate(g.blocks):
            if bi in self.states:
                continue
            if s == self.n - 1 and self._ins(s)[0] == int(Op.STOP):
                continue
            rep.diag(Severity.WARN, "unreachable-code", s,
                     f"block [{s}, {e}) is unreachable from entry")
        # halt reachability
        can_halt = False
        for bi in self.states:
            s, e = g.blocks[bi]
            term = self._ins(e - 1)[0]
            if term == int(Op.STOP):
                can_halt = True
            elif not g.succs[bi] and term != int(Op.RTS):
                can_halt = True     # falls off the image into padded STOP
        if not can_halt:
            rep.diag(Severity.ERROR, "no-halt", -1,
                     "no reachable path reaches STOP or leaves the image "
                     "(the program cannot halt)")
        for pc, trips in sorted(rep.loop_trips.items()):
            if trips is None:
                rep.diag(Severity.INFO, "trip-unknown", pc,
                         "loop trip count is not statically determined "
                         "(counter or INIT provenance lost at a join)")
        self._dead_writes(rep)

    def _dead_writes(self, rep: _Reporter) -> None:
        """Backward liveness over the reached blocks; INFO per dead def."""
        g = self.g
        reached = sorted(self.states)
        live_in: dict[int, int] = {bi: 0 for bi in reached}
        preds: dict[int, list[int]] = {bi: [] for bi in reached}
        for bi in reached:
            for sb, _k in g.succs[bi]:
                if sb in preds:
                    preds[sb].append(bi)

        def back(bi: int, live: int, sink: list | None) -> int:
            s, e = g.blocks[bi]
            for pc in range(e - 1, s - 1, -1):
                op, typ, rd, ra, rb, imm, tsc = self._ins(pc)
                if op >= NUM_OPCODES:
                    continue
                if op in _WRITES:
                    if sink is not None and not (live >> rd) & 1:
                        sink.append(pc)
                    lanes, wfs, full = self._space(tsc)
                    strong = (full and rep.pred_at.get(pc) == 0
                              and op not in (int(Op.DOT), int(Op.SUM)))
                    if strong:
                        live &= ~(1 << rd)
                if op in _READS_RA:
                    live |= 1 << ra
                if op in _READS_RB:
                    live |= 1 << rb
                if op in _READS_RD:
                    live |= 1 << rd
            return live

        work = deque(reached)
        while work:
            bi = work.popleft()
            out = 0
            for sb, _k in g.succs[bi]:
                out |= live_in.get(sb, 0)
            new_in = back(bi, out, None)
            if new_in != live_in[bi]:
                live_in[bi] = new_in
                for pb in preds[bi]:
                    if pb not in work:
                        work.append(pb)
        dead: list[int] = []
        for bi in reached:
            out = 0
            for sb, _k in g.succs[bi]:
                out |= live_in.get(sb, 0)
            back(bi, out, dead)
        for pc in sorted(dead)[:16]:
            op = self._ins(pc)[0]
            rd = self._ins(pc)[2]
            rep.diag(Severity.INFO, "dead-write", pc,
                     f"{Op(op).name} writes r{rd} which nothing reads "
                     f"before the program halts")

    # -------------------------------------------------------------- facts
    def _facts(self, rep: _Reporter, clipped: bool) -> dict:
        reached = sorted(self.states)
        distinct = sum(e - s for bi, (s, e) in enumerate(self.g.blocks)
                       if bi in self.states)
        static_steps = self._static_steps(rep)
        facts = {
            "threads": self.threads,
            "tdx_dim": self.tdx_dim,
            "n_blocks": len(self.g.blocks),
            "reached_blocks": len(reached),
            "distinct_reachable_instrs": distinct,
            "predicted_superblock_eligible": distinct <= cfg_mod.MAX_TRACE,
            "loop_trips": dict(rep.loop_trips),
            "static_steps": static_steps,
            "access_verdicts": dict(rep.access_verdicts),
            "proved_accesses": tuple(
                pc for pc, v in sorted(rep.access_verdicts.items())
                if v == "proved"),
            "max_pred_depth": rep.max_depth["pred"],
            "max_loop_depth": rep.max_depth["loops"],
            "max_call_depth": rep.max_depth["calls"],
            "fold_candidates": dict(rep.fold_candidates),
            "pred_at": dict(rep.pred_at),
            "analysis_clipped": clipped,
        }
        if distinct > cfg_mod.MAX_TRACE:
            rep.diag(Severity.INFO, "trace-budget", -1,
                     f"{distinct} distinct reachable instructions exceed "
                     f"the {cfg_mod.MAX_TRACE}-instruction superblock "
                     f"trace budget; the runner will fall back to the "
                     f"blocks tier")
        if static_steps is not None and static_steps > self.cfg.max_steps:
            rep.diag(Severity.ERROR, "steps-exceeded", -1,
                     f"statically determined execution length "
                     f"{static_steps} exceeds max_steps="
                     f"{self.cfg.max_steps} (the interpreter would stop "
                     f"mid-flight)")
        return facts

    def _static_steps(self, rep: _Reporter) -> int | None:
        """Exact executed-instruction count for *structured* programs: no
        JMP/JSR/RTS, every LOOP a known-trip backward branch, loop bodies
        laminar (properly nested).  Matches the path simulator's ``steps``
        bit-for-bit when it returns a value (tested)."""
        ops = self.packed[:self.n, _PF_OP]
        imms = self.packed[:self.n, _PF_IMM]
        for bad in (Op.JMP, Op.JSR, Op.RTS):
            if np.any(ops == int(bad)):
                return None
        stops = np.flatnonzero(ops == int(Op.STOP))
        if not len(stops):
            return None
        s0 = int(stops[0])
        loops = []
        for pc in np.flatnonzero(ops == int(Op.LOOP)):
            pc = int(pc)
            if pc > s0:
                continue
            t = int(imms[pc])
            trips = rep.loop_trips.get(pc)
            if trips is None or not 0 <= t < pc:
                return None
            loops.append((t, pc, trips))
        for (a1, b1, _t1) in loops:          # laminar check
            for (a2, b2, _t2) in loops:
                if a1 < a2 <= b1 < b2:
                    return None
        total = 0
        for pc in range(s0 + 1):
            mult = 1
            for (a, b, trips) in loops:
                if a <= pc <= b:
                    mult *= trips
            total += mult
        return total


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def analyze(image: ProgramImage, threads: int | None = None, *,
            tdx_dim: int = 16) -> AnalysisReport:
    """Run every static pass over one assembled program.

    ``threads``/``tdx_dim`` fix the thread-space geometry the analysis
    is exact for (wavefront counts, TDX/TDY ranges); they default to the
    image's ``threads_active`` (falling back to the config maximum) and
    the conventional 16-wide thread grid.
    """
    cfg = image.cfg
    if threads is None:
        threads = image.threads_active or cfg.max_threads
    if threads < 1 or threads > cfg.max_threads:
        raise ValueError(f"threads {threads} invalid for max "
                         f"{cfg.max_threads}")
    return _Analyzer(image, threads, tdx_dim).run()


_CACHE: OrderedDict = OrderedDict()
_CACHE_LOCK = threading.Lock()
_CACHE_MAX = 256


def analyze_cached(image: ProgramImage, threads: int | None = None, *,
                   tdx_dim: int = 16) -> AnalysisReport:
    """LRU-cached :func:`analyze` keyed on (config, program bits,
    threads, tdx_dim) — the admission path calls this per submit, so
    repeated submits of the same program cost one dict lookup."""
    cfg = image.cfg
    t = threads if threads is not None \
        else (image.threads_active or cfg.max_threads)
    key = (cfg, image.words.tobytes(), t, tdx_dim)
    with _CACHE_LOCK:
        hit = _CACHE.get(key)
        if hit is not None:
            _CACHE.move_to_end(key)
            return hit
    report = analyze(image, threads, tdx_dim=tdx_dim)
    with _CACHE_LOCK:
        _CACHE[key] = report
        while len(_CACHE) > _CACHE_MAX:
            _CACHE.popitem(last=False)
    return report
