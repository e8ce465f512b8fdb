"""eGPU assembler: a Python-embedded builder, plus the NOP scheduler.

The paper's benchmarks "were written in assembly code (we have not written
our compiler yet)" — this module is that assembler.  It provides:

* a builder API with one method per mnemonic, labels, and structured
  ``loop``/``if`` helpers that lower to the sequencer's INIT/LOOP and the
  predicate IF/ELSE/ENDIF instructions;
* per-instruction thread-space control (the paper's dynamic scalability):
  every emit accepts ``tsc=`` as a personality name (``"full"``, ``"wf0"``,
  ``"cpu"``, ``"mcu"``, ...), an ``(width, depth)`` tuple, or a raw 4-bit
  coding;
* :func:`schedule` — the hazard pass.  The eGPU has an 8-stage pipeline
  and **no hazard hardware**, so read-after-write distances shorter than
  the producer's latency must be covered with NOPs.  The scheduler models
  per-wavefront issue skew exactly (see ``_ready_constraint``) so that
  e.g. a full-depth chain needs no padding (issue occupancy hides the
  pipe) while a ``wf0``-only chain gets 7 NOPs — reproducing the NOP
  profiles of Fig. 6.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from . import cost, isa
from .config import EGPUConfig
from .isa import Instr, Op, Typ


def _resolve_tsc(tsc) -> int:
    if isinstance(tsc, str):
        return isa.PERSONALITIES[tsc]
    if isinstance(tsc, tuple):
        return isa.tsc_encode(*tsc)
    return int(tsc)


@dataclasses.dataclass
class Label:
    name: str


@dataclasses.dataclass
class ProgramImage:
    """An assembled program: decoded field arrays + encoded words."""

    cfg: EGPUConfig
    op: np.ndarray
    typ: np.ndarray
    rd: np.ndarray
    ra: np.ndarray
    rb: np.ndarray
    imm: np.ndarray
    tsc: np.ndarray
    words: np.ndarray       # bit-packed IWs (uint64)
    listing: list[str]
    threads_active: int     # thread count the schedule was built for

    @property
    def n(self) -> int:
        return int(self.op.shape[0])

    def static_cycle_estimate(self) -> int:
        """Straight-line issue-cycle count (no branches taken)."""
        wfs = max(1, -(-self.threads_active // self.cfg.num_sps))
        return int(sum(
            cost.issue_cycles(int(o), int(t), wfs, self.cfg)
            for o, t in zip(self.op, self.tsc)
        ))


class Asm:
    """Two-pass assembler with symbolic labels."""

    #: virtual register slots for hazard tracking (beyond architectural regs)
    _VPRED = "pred"   # predicate stack state
    _VMEM = "mem"     # shared memory RAW-through-memory

    def __init__(self, cfg: EGPUConfig):
        self.cfg = cfg
        self.items: list = []        # Instr (imm may be a str label) | ("label", name)
        self._auto = 0

    # ------------------------------------------------------------------ emit
    def label(self, name: str | None = None) -> str:
        if name is None:
            name = f"_L{self._auto}"
            self._auto += 1
        self.items.append(Label(name))
        return name

    def emit(self, op: Op, *, typ=Typ.U32, rd=0, ra=0, rb=0, imm=0,
             tsc="full") -> None:
        t = _resolve_tsc(tsc)
        if isa.tsc_width(t) == 3:
            raise ValueError("TSC width '11' is undefined")
        if op == Op.SHL or op == Op.SHR:
            if self.cfg.shift_bits == 1:
                # min-ALU configs support single-bit shifts only; the shift
                # amount register is still read but must hold 1.
                pass
        self.items.append(Instr(op=int(op), typ=int(typ), rd=rd, ra=ra,
                                rb=rb, imm=imm, tsc=t))

    # --- integer -----------------------------------------------------------
    def add(s, rd, ra, rb, typ=Typ.I32, tsc="full"): s.emit(Op.ADD, rd=rd, ra=ra, rb=rb, typ=typ, tsc=tsc)
    def sub(s, rd, ra, rb, typ=Typ.I32, tsc="full"): s.emit(Op.SUB, rd=rd, ra=ra, rb=rb, typ=typ, tsc=tsc)
    def neg(s, rd, ra, typ=Typ.I32, tsc="full"): s.emit(Op.NEG, rd=rd, ra=ra, typ=typ, tsc=tsc)
    def abs_(s, rd, ra, typ=Typ.I32, tsc="full"): s.emit(Op.ABS, rd=rd, ra=ra, typ=typ, tsc=tsc)
    def mul16lo(s, rd, ra, rb, typ=Typ.U32, tsc="full"): s.emit(Op.MUL16LO, rd=rd, ra=ra, rb=rb, typ=typ, tsc=tsc)
    def mul16hi(s, rd, ra, rb, typ=Typ.U32, tsc="full"): s.emit(Op.MUL16HI, rd=rd, ra=ra, rb=rb, typ=typ, tsc=tsc)
    def mul24lo(s, rd, ra, rb, typ=Typ.U32, tsc="full"): s.emit(Op.MUL24LO, rd=rd, ra=ra, rb=rb, typ=typ, tsc=tsc)
    def mul24hi(s, rd, ra, rb, typ=Typ.U32, tsc="full"): s.emit(Op.MUL24HI, rd=rd, ra=ra, rb=rb, typ=typ, tsc=tsc)
    def and_(s, rd, ra, rb, tsc="full"): s.emit(Op.AND, rd=rd, ra=ra, rb=rb, tsc=tsc)
    def or_(s, rd, ra, rb, tsc="full"): s.emit(Op.OR, rd=rd, ra=ra, rb=rb, tsc=tsc)
    def xor(s, rd, ra, rb, tsc="full"): s.emit(Op.XOR, rd=rd, ra=ra, rb=rb, tsc=tsc)
    def not_(s, rd, ra, tsc="full"): s.emit(Op.NOT, rd=rd, ra=ra, tsc=tsc)
    def cnot(s, rd, ra, tsc="full"): s.emit(Op.CNOT, rd=rd, ra=ra, tsc=tsc)
    def bvs(s, rd, ra, tsc="full"): s.emit(Op.BVS, rd=rd, ra=ra, tsc=tsc)
    def shl(s, rd, ra, rb, typ=Typ.U32, tsc="full"): s.emit(Op.SHL, rd=rd, ra=ra, rb=rb, typ=typ, tsc=tsc)
    def shr(s, rd, ra, rb, typ=Typ.U32, tsc="full"): s.emit(Op.SHR, rd=rd, ra=ra, rb=rb, typ=typ, tsc=tsc)
    def pop(s, rd, ra, tsc="full"): s.emit(Op.POP, rd=rd, ra=ra, tsc=tsc)
    def max_(s, rd, ra, rb, typ=Typ.I32, tsc="full"): s.emit(Op.MAX, rd=rd, ra=ra, rb=rb, typ=typ, tsc=tsc)
    def min_(s, rd, ra, rb, typ=Typ.I32, tsc="full"): s.emit(Op.MIN, rd=rd, ra=ra, rb=rb, typ=typ, tsc=tsc)

    # --- FP ------------------------------------------------------------------
    def fadd(s, rd, ra, rb, tsc="full"): s.emit(Op.FADD, rd=rd, ra=ra, rb=rb, typ=Typ.F32, tsc=tsc)
    def fsub(s, rd, ra, rb, tsc="full"): s.emit(Op.FSUB, rd=rd, ra=ra, rb=rb, typ=Typ.F32, tsc=tsc)
    def fneg(s, rd, ra, tsc="full"): s.emit(Op.FNEG, rd=rd, ra=ra, typ=Typ.F32, tsc=tsc)
    def fabs(s, rd, ra, tsc="full"): s.emit(Op.FABS, rd=rd, ra=ra, typ=Typ.F32, tsc=tsc)
    def fmul(s, rd, ra, rb, tsc="full"): s.emit(Op.FMUL, rd=rd, ra=ra, rb=rb, typ=Typ.F32, tsc=tsc)
    def fmax(s, rd, ra, rb, tsc="full"): s.emit(Op.FMAX, rd=rd, ra=ra, rb=rb, typ=Typ.F32, tsc=tsc)
    def fmin(s, rd, ra, rb, tsc="full"): s.emit(Op.FMIN, rd=rd, ra=ra, rb=rb, typ=Typ.F32, tsc=tsc)

    # --- memory / immediates / thread ids ---------------------------------
    def lod(s, rd, ra, offset=0, tsc="full"): s.emit(Op.LOD, rd=rd, ra=ra, imm=offset, tsc=tsc)
    def sto(s, rd, ra, offset=0, tsc="full"): s.emit(Op.STO, rd=rd, ra=ra, imm=offset, tsc=tsc)
    def lodi(s, rd, imm, tsc="full"):
        if not -32768 <= imm <= 65535:
            raise ValueError("LODI immediate out of 16-bit range")
        if imm > 32767:
            imm -= 0x10000
        s.emit(Op.LODI, rd=rd, imm=imm, tsc=tsc)
    def tdx(s, rd, tsc="full"): s.emit(Op.TDX, rd=rd, tsc=tsc)
    def tdy(s, rd, tsc="full"): s.emit(Op.TDY, rd=rd, tsc=tsc)

    def lodi32(self, rd: int, value: int, s1: int, s2: int, tsc="full") -> None:
        """Load a full 32-bit constant.

        Paper-faithful lowering: LODI sign-extends a 16-bit immediate and
        SHL takes a *register* shift amount (Table 2), so two scratch
        registers are needed.  SHL-by-16 discards the hi half's sign
        extension; a logical SHL/SHR pair zero-extends the low half.
        """
        value &= 0xFFFFFFFF
        hi, lo = value >> 16, value & 0xFFFF
        if hi == 0 and lo < 0x8000:
            self.lodi(rd, lo, tsc=tsc)
            return
        self.lodi(s1, 16, tsc=tsc)
        self.lodi(rd, hi if hi < 0x8000 else hi - 0x10000, tsc=tsc)
        self.shl(rd, rd, s1, typ=Typ.U32, tsc=tsc)
        self.lodi(s2, lo if lo < 0x8000 else lo - 0x10000, tsc=tsc)
        if lo & 0x8000:  # zero-extend the low half
            self.shl(s2, s2, s1, typ=Typ.U32, tsc=tsc)
            self.shr(s2, s2, s1, typ=Typ.U32, tsc=tsc)
        self.or_(rd, rd, s2, tsc=tsc)

    def fconst(self, rd: int, value: float, s1: int, s2: int, tsc="full") -> None:
        bits = int(np.float32(value).view(np.uint32))
        self.lodi32(rd, bits, s1, s2, tsc=tsc)

    # --- extension ---------------------------------------------------------
    def dot(s, rd, ra, rb, tsc="full"):
        if not s.cfg.has_dot:
            raise ValueError("this eGPU configuration has no dot-product core")
        s.emit(Op.DOT, rd=rd, ra=ra, rb=rb, typ=Typ.F32, tsc=tsc)
    def sum_(s, rd, ra, rb=0, tsc="full"):
        if not s.cfg.has_dot:
            raise ValueError("SUM uses the dot-product core (not configured)")
        s.emit(Op.SUM, rd=rd, ra=ra, rb=rb, typ=Typ.F32, tsc=tsc)
    def invsqr(s, rd, ra, tsc="full"):
        if not s.cfg.has_invsqr:
            raise ValueError("this eGPU configuration has no SFU")
        s.emit(Op.INVSQR, rd=rd, ra=ra, typ=Typ.F32, tsc=tsc)

    # --- control -------------------------------------------------------------
    def jmp(s, target): s.emit(Op.JMP, imm=target)
    def jsr(s, target): s.emit(Op.JSR, imm=target)
    def rts(s): s.emit(Op.RTS)
    def loop_(s, target): s.emit(Op.LOOP, imm=target)
    def init(s, count): s.emit(Op.INIT, imm=count)
    def stop(s): s.emit(Op.STOP)
    def nop(s, n=1):
        for _ in range(n):
            s.emit(Op.NOP)

    # --- predicates ----------------------------------------------------------
    def if_(s, cc: str, ra=0, rb=0, typ=Typ.I32, tsc="full"):
        if not s.cfg.has_predicates:
            raise ValueError("this eGPU configuration has no predicates")
        op = Op[f"IF_{cc.upper()}"]
        s.emit(op, ra=ra, rb=rb, typ=typ, tsc=tsc)
    def else_(s, tsc="full"): s.emit(Op.ELSE, tsc=tsc)
    def endif(s, tsc="full"): s.emit(Op.ENDIF, tsc=tsc)

    # --- structured helpers ------------------------------------------------
    def loop(self, count: int):
        """``with a.loop(n):`` — runs the body n times (INIT n-1 ... LOOP)."""
        asm = self

        class _Loop:
            def __enter__(ctx):
                if count < 1:
                    raise ValueError("loop count must be >= 1")
                asm.init(count - 1)
                ctx.top = asm.label()
                return ctx

            def __exit__(ctx, *exc):
                if exc[0] is None:
                    asm.loop_(ctx.top)

        return _Loop()

    # ------------------------------------------------------------- assembly
    def assemble(self, threads_active: int | None = None, *,
                 schedule_nops: bool = True) -> ProgramImage:
        threads_active = threads_active or self.cfg.max_threads
        items = list(self.items)
        if schedule_nops:
            items = schedule(items, self.cfg, threads_active)
        # pass 1: resolve label addresses
        addr, labels = 0, {}
        for it in items:
            if isinstance(it, Label):
                if it.name in labels:
                    raise ValueError(f"duplicate label {it.name!r}")
                labels[it.name] = addr
            else:
                addr += 1
        # pass 2: emit
        instrs: list[Instr] = []
        for it in items:
            if isinstance(it, Label):
                continue
            if isinstance(it.imm, str):
                it = it._replace(imm=labels[it.imm])
            instrs.append(it)
        if not instrs or instrs[-1].op != Op.STOP:
            instrs.append(Instr(op=int(Op.STOP)))
        arr = lambda f: np.array([getattr(i, f) for i in instrs], dtype=np.int32)
        words = np.array(
            [isa.encode_word(i, self.cfg.regs_per_thread) for i in instrs],
            dtype=np.uint64)
        listing = [repr(i) for i in instrs]
        return ProgramImage(cfg=self.cfg, op=arr("op"), typ=arr("typ"),
                            rd=arr("rd"), ra=arr("ra"), rb=arr("rb"),
                            imm=arr("imm"), tsc=arr("tsc"), words=words,
                            listing=listing, threads_active=threads_active)


# ---------------------------------------------------------------------------
# Hazard scheduling
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Write:
    start: int        # issue-start cycle of the producer
    per_wf: int       # producer issue cycles per wavefront
    wfs: int          # producer wavefront count
    lat: int          # result latency


def _per_wf(op: int, tsc: int, cfg: EGPUConfig) -> int:
    o = Op(op)
    width = isa.WIDTH_LANES[isa.tsc_width(tsc)]
    if o == Op.LOD:
        return -(-width // cfg.cost.sp_read_ports)
    if o == Op.STO:
        return -(-width // cfg.write_ports)
    return 1


def _ready_constraint(w: _Write, per_wf_c: int, wfs_c: int) -> int:
    """Earliest issue-start cycle for a consumer reading ``w``'s register.

    Producer wavefront ``k`` finishes issuing at ``start + per_wf*(k+1) - 1``
    and its result is readable ``lat`` cycles later.  The consumer's
    wavefront ``k`` reads at ``c_start + per_wf_c*k``.  The binding
    constraint is the max over the wavefronts both touch.
    """
    k_max = min(w.wfs, wfs_c) - 1
    d = w.per_wf - per_wf_c
    k = k_max if d > 0 else 0
    return w.start + w.per_wf * (k + 1) - 1 + w.lat - per_wf_c * k


def _reads(ins: Instr, cfg: EGPUConfig) -> list:
    o = Op(ins.op)
    rs: list = []
    if o in isa.READS_RA:
        rs.append(ins.ra)
    if o in isa.READS_RB:
        rs.append(ins.rb)
    if o in isa.READS_RD:
        rs.append(ins.rd)
    if o == Op.LOD:
        rs.append(Asm._VMEM)
    # every masked vector op consumes the predicate state
    if cfg.has_predicates and o not in isa.SCALAR_OPS:
        rs.append(Asm._VPRED)
    return rs


def _writes(ins: Instr, cfg: EGPUConfig) -> list:
    o = Op(ins.op)
    ws: list = []
    if o in isa.REG_WRITE_OPS:
        ws.append(ins.rd)
    if o == Op.STO:
        ws.append(Asm._VMEM)
    if o in isa.PRED_WRITE_OPS:
        ws.append(Asm._VPRED)
    return ws


def schedule(items: Sequence, cfg: EGPUConfig, threads_active: int) -> list:
    """Insert NOPs so that no read-after-write hazard remains.

    Linear pass with exact per-wavefront skew modelling; backward branches
    (LOOP/JMP to an earlier label) additionally drain any writes that are
    re-read at the loop head.
    """
    wfs_rt = max(1, -(-threads_active // cfg.num_sps))
    out: list = []
    ready: dict = {}          # reg -> _Write
    now = 0
    label_pos: dict[str, int] = {}

    def wf_count(tsc: int) -> int:
        return cost.depth_wavefronts(isa.tsc_depth(tsc), wfs_rt)

    for it in items:
        if isinstance(it, Label):
            label_pos[it.name] = len(out)
            out.append(it)
            continue
        ins: Instr = it
        o = Op(ins.op)

        # --- subroutine boundaries: drain every pending write ----------
        # (the linear pass cannot see call-graph edges; the paper's 8-deep
        # pipe makes the full drain at most 7 NOPs per JSR/RTS)
        # Forward JMPs drain too: the jump path reaches the target with
        # only one cycle elapsed, while the linear pass advances ``now``
        # through the whole skipped region — pending pre-JMP writes would
        # look settled at the join when at runtime they are not.
        if o in (Op.JSR, Op.RTS) or (
                o == Op.JMP and not (isinstance(ins.imm, str)
                                     and ins.imm in label_pos)):
            need = 0
            for w in ready.values():
                need = max(need,
                           w.start + w.per_wf * w.wfs - 1 + w.lat + 1)
            stall = max(0, need - now)
            for _ in range(stall):
                out.append(Instr(op=int(Op.NOP)))
                now += 1

        # --- backward-branch drain ------------------------------------
        if o in (Op.LOOP, Op.JMP, Op.JSR) and isinstance(ins.imm, str) \
                and ins.imm in label_pos:
            body = [x for x in out[label_pos[ins.imm]:] if isinstance(x, Instr)]
            need = 0
            for b in body:
                for r in _reads(b, cfg):
                    w = ready.get(r)
                    if w is not None:
                        need = max(need, _ready_constraint(
                            w, _per_wf(b.op, b.tsc, cfg), wf_count(b.tsc)))
            # +1: the branch itself takes a cycle before the head re-issues
            stall = max(0, need - (now + 1))
            for _ in range(stall):
                out.append(Instr(op=int(Op.NOP)))
                now += 1

        # --- RAW stall --------------------------------------------------
        if o not in (Op.NOP,):
            per_wf_c = _per_wf(ins.op, ins.tsc, cfg)
            wfs_c = wf_count(ins.tsc)
            need = 0
            for r in _reads(ins, cfg):
                w = ready.get(r)
                if w is not None:
                    need = max(need, _ready_constraint(w, per_wf_c, wfs_c))
            # WAW: preserve write order to the same register
            for r in _writes(ins, cfg):
                w = ready.get(r)
                if w is not None:
                    lat_c = cost.result_latency(ins.op, cfg)
                    need = max(need, w.start + w.lat - lat_c + 1)
            stall = max(0, need - now)
            for _ in range(stall):
                out.append(Instr(op=int(Op.NOP)))
                now += 1

        # --- issue ------------------------------------------------------
        start = now
        now += cost.issue_cycles(ins.op, ins.tsc, wfs_rt, cfg) \
            if o not in isa.SCALAR_OPS else 1
        for r in _writes(ins, cfg):
            ready[r] = _Write(start=start, per_wf=_per_wf(ins.op, ins.tsc, cfg),
                              wfs=wf_count(ins.tsc),
                              lat=cost.result_latency(ins.op, cfg))
        out.append(ins)
    return out
