"""Seeded random CFG program generator for analyzer soundness fuzzing
(a copy of the reference's framework-free ``repro.programs.generator``).

Emits structured eGPU programs whose shape is drawn from the full ISA
grammar the static verifier must cover: nested counted loops
(INIT/LOOP), predicate regions (IF/ELSE/ENDIF, optionally with an ELSE
arm), subroutines (JSR/RTS, acyclic call chains), forward JMPs,
LOD/STO address arithmetic, and the narrow thread-space personalities
("wf0"/"cpu"/"mcu"/...).  All value ops are *integer* ops so a numpy
reference run is bit-exact against the interpreter.

With ``hostility > 0`` a program may also contain deliberately broken
constructs — constant out-of-bounds stores, stray ELSE/ENDIF, stack
overflows past the configured limits, out-of-image branch targets —
which the verifier is expected to reject.  The soundness property under
test: whenever the reference's ``repro.analysis.analyze`` reports no ERROR, the
concrete run must halt cleanly with no stack faults, every access the
analyzer *proved* in bounds must stay in bounds, and a static step
count must match the executed count exactly.
"""
from __future__ import annotations

import random

from ..core import isa
from ..core.assembler import Asm, ProgramImage
from ..core.config import EGPUConfig
from ..core.isa import Typ

#: thread-space personalities the generator samples for value ops
_PERSONALITIES = ("full", "full", "full", "wf0", "cpu", "mcu", "quarter")


class _Gen:
    def __init__(self, cfg: EGPUConfig, rng: random.Random,
                 n_target: int, hostility: float):
        self.cfg = cfg
        self.rng = rng
        self.a = Asm(cfg)
        self.budget = n_target
        self.hostility = hostility
        self.regs = list(range(1, min(cfg.regs_per_thread, 12)))
        self.S = cfg.shared_words
        self.loop_depth = 0
        self.pred_depth = 0
        self.max_loop = min(cfg.max_loop_depth, 3)
        self.max_pred = min(cfg.predicate_levels, 3) \
            if cfg.has_predicates else 0
        self.subs: list[str] = []

    # ------------------------------------------------------------ helpers
    def r(self) -> int:
        return self.rng.choice(self.regs)

    def tsc(self) -> str:
        return self.rng.choice(_PERSONALITIES)

    def bad(self, p: float) -> bool:
        return self.hostility > 0 and self.rng.random() < p * self.hostility

    # ------------------------------------------------------------- pieces
    def value_op(self) -> None:
        a, rng = self.a, self.rng
        k = rng.randrange(9)
        rd, ra, rb = self.r(), self.r(), self.r()
        tsc = self.tsc()
        typ = rng.choice((Typ.U32, Typ.I32))
        if k == 0:
            a.lodi(rd, rng.randrange(-64, 256), tsc=tsc)
        elif k == 1:
            a.tdx(rd, tsc=tsc)
        elif k == 2:
            a.add(rd, ra, rb, typ=typ, tsc=tsc)
        elif k == 3:
            a.sub(rd, ra, rb, typ=typ, tsc=tsc)
        elif k == 4:
            a.xor(rd, ra, rb, tsc=tsc)
        elif k == 5:
            a.and_(rd, ra, rb, tsc=tsc)
        elif k == 6:
            a.shr(rd, ra, rb, typ=typ, tsc=tsc)
        elif k == 7:
            a.min_(rd, ra, rb, typ=typ, tsc=tsc)
        else:
            a.cnot(rd, ra, tsc=tsc)
        self.budget -= 1

    def memory_op(self) -> None:
        a, rng = self.a, self.rng
        addr, rv = self.r(), self.r()
        if rng.random() < 0.7:
            # provably in-bounds: small constant base + tdx lane id
            base = rng.randrange(0, max(1, self.S - 64))
            a.lodi(addr, min(base, 32767))
            if rng.random() < 0.5:
                a.tdx(rv)
                a.add(addr, addr, rv, typ=Typ.U32)
            off = rng.randrange(0, 16)
        elif self.bad(0.6):
            # constant, provably out of bounds (expected: ERROR)
            a.lodi(addr, min(self.S + rng.randrange(1, 64), 32767))
            off = rng.randrange(0, 8)
        else:
            # derived address the intervals may or may not bound
            a.xor(addr, self.r(), self.r())
            off = rng.randrange(0, 8)
        self.budget -= 2
        if rng.random() < 0.5:
            a.lod(rv, addr, off, tsc=self.tsc())
        else:
            a.sto(rv, addr, off, tsc=self.tsc())
        self.budget -= 1

    def loop(self, depth_left: int) -> None:
        a = self.a
        if self.loop_depth >= self.max_loop or self.budget < 4:
            self.value_op()
            return
        trips = self.rng.randrange(0, 4)     # INIT c -> body runs c+1 times
        a.init(trips)
        head = a.label()
        self.loop_depth += 1
        self.budget -= 2
        self.body(depth_left - 1, self.budget // 2 + 1)
        self.loop_depth -= 1
        a.loop_(head)

    def predicate(self, depth_left: int) -> None:
        a, rng = self.a, self.rng
        if self.pred_depth >= self.max_pred or self.budget < 4:
            self.value_op()
            return
        cc = rng.choice(("eq", "lt", "gt", "nz"))
        if cc == "nz":
            a.if_(cc, self.r())
        else:
            a.if_(cc, self.r(), self.r(), typ=Typ.I32)
        self.pred_depth += 1
        self.budget -= 2
        self.body(depth_left - 1, self.budget // 2 + 1)
        if rng.random() < 0.6:
            a.else_()
            self.budget -= 1
            self.body(depth_left - 1, self.budget // 2 + 1)
        self.pred_depth -= 1
        a.endif()

    def jump_over(self) -> None:
        """Forward JMP across a (now unreachable) chunk."""
        a = self.a
        tgt = f"_fwd{a._auto}"
        a._auto += 1
        a.jmp(tgt)
        self.budget -= 1
        for _ in range(self.rng.randrange(1, 3)):
            self.value_op()
        a.label(tgt)

    def broken(self) -> None:
        """One deliberately malformed construct (verifier food)."""
        a, rng = self.a, self.rng
        k = rng.randrange(4)
        if k == 0:
            a.endif()                      # stray ENDIF (underflow)
        elif k == 1:
            a.else_()                      # stray ELSE
        elif k == 2:
            a.emit(isa.Op.JMP, imm=4096)   # out-of-image target
        else:
            for _ in range(self.cfg.max_loop_depth + 1):
                a.init(0)                  # overflow the loop stack
                self.budget -= 1
            lbl = a.label()
            self.value_op()
            for _ in range(self.cfg.max_loop_depth + 1):
                a.loop_(lbl)
                self.budget -= 1
        self.budget -= 1

    def call(self) -> None:
        if not self.subs:
            self.value_op()
            return
        self.a.jsr(self.rng.choice(self.subs))
        self.budget -= 1

    # --------------------------------------------------------------- body
    def body(self, depth_left: int, budget_cap: int) -> None:
        spent = 0
        n = self.rng.randrange(2, 6)
        for _ in range(n):
            if self.budget <= 1 or spent >= budget_cap:
                break
            before = self.budget
            roll = self.rng.random()
            if self.bad(0.05):
                self.broken()
            elif roll < 0.15 and depth_left > 0:
                self.loop(depth_left)
            elif roll < 0.30 and depth_left > 0 and self.max_pred:
                self.predicate(depth_left)
            elif roll < 0.38:
                self.memory_op()
            elif roll < 0.43:
                self.jump_over()
            elif roll < 0.48:
                self.call()
            else:
                self.value_op()
            spent += before - self.budget

    # -------------------------------------------------------------- build
    def build(self, threads: int) -> ProgramImage:
        a, rng = self.a, self.rng
        n_subs = rng.randrange(0, 3)
        self.subs = [f"_sub{i}" for i in range(n_subs)]
        while self.budget > 2:
            self.body(3, self.budget)
        a.stop()
        for i, name in enumerate(self.subs):
            a.label(name)
            # a sub may tail-call a strictly later sub: chains stay
            # acyclic and at most n_subs deep
            self.subs = [f"_sub{j}" for j in range(i + 1, n_subs)]
            self.budget = rng.randrange(2, 6)
            self.body(1, self.budget)
            a.rts()
        return a.assemble(threads_active=threads)


def generate_program(cfg: EGPUConfig, seed: int, *, n_target: int = 40,
                     hostility: float = 0.0,
                     threads: int | None = None) -> ProgramImage:
    """One seeded random program.  ``n_target`` bounds the pre-schedule
    instruction count; ``hostility`` in [0, 1] scales the probability of
    deliberately broken constructs (0 disables them); ``threads``
    defaults to a random multiple of the wavefront width."""
    rng = random.Random(seed)
    if threads is None:
        w = cfg.max_threads // cfg.num_sps
        threads = cfg.num_sps * rng.randrange(1, w + 1)
    return _Gen(cfg, rng, n_target, hostility).build(threads)
