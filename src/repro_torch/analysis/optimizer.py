"""Verified pre-compile optimizer: constant folding + DCE over the CFG
(a copy of the reference's framework-free ``repro.analysis.optimizer``).

The ISA has no data-dependent control flow, so every transform here is
justified by *input-independent* static facts:

* **NOP strip + re-schedule** — hand-written or previously scheduled
  hazard NOPs are removed and the assembler's exact per-wavefront
  scheduler re-derives the minimal set for the transformed program
  (removing instructions can both remove *and create* hazards).
* **Constant folding** — an instruction whose result the interval
  analysis proved to be a single constant for every active thread on
  every path (and which issues unpredicated) is replaced by a ``LODI``
  with the same destination and thread-space coding, when the value is
  representable as a sign-extended 16-bit immediate under the config's
  ALU mask.  The constant comes from :func:`repro_torch.analysis.passes.eval_int`
  — the same evaluator the analysis uses — so the replacement is
  bit-identical by construction.
* **Dead-code elimination** — register writes that are overwritten by a
  statically unpredicated full-thread-space write on *every* path
  before any read are dropped.  Liveness treats program exit as
  all-registers-live, so the final architectural register file (not
  just shared memory) is preserved bit-for-bit.

The contract is full bit-identity of the architectural end state
(register file, shared memory, halt flag) for any shared-memory input.
``optimize_image`` enforces it twice: the optimized image is re-analyzed
(no new ERROR diagnostics allowed) and, with ``verify=True`` (default),
differentially executed against the original on a deterministic
non-trivial shared-memory pattern via the numpy reference executor.  On
any doubt the original image is returned unchanged.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict, deque
from typing import Sequence

import numpy as np

from ..core import cfg as cfg_mod
from ..core import isa
from ..core.assembler import Asm, Label, ProgramImage
from ..core.config import EGPUConfig
from ..core.isa import NUM_OPCODES, Instr, Op, Typ
from .diagnostics import AnalysisReport
from .passes import analyze

_M32 = 0xFFFFFFFF
_TARGETS = frozenset(int(o) for o in cfg_mod.TARGET_OPS)
_WRITES = frozenset(int(o) for o in isa.REG_WRITE_OPS)
_READS_RA = frozenset(int(o) for o in isa.READS_RA)
_READS_RB = frozenset(int(o) for o in isa.READS_RB if o != Op.SUM)
_READS_RD = frozenset(int(o) for o in isa.READS_RD)
_NOP = int(Op.NOP)


class OptimizationError(RuntimeError):
    """The optimized program failed differential verification.

    This is a bug in the optimizer, never in the input program — it is
    raised instead of silently shipping a miscompile."""


@dataclasses.dataclass
class OptResult:
    """Outcome of :func:`optimize_image`."""

    image: ProgramImage           # optimized (== original when unchanged)
    original: ProgramImage
    changed: bool
    rounds: int
    folds: int                    # instructions replaced by LODI
    dce_removed: int              # dead register writes dropped
    nops_before: int              # NOP count in the input image
    nops_after: int               # NOP count after re-scheduling
    report: AnalysisReport | None  # analysis of the final image
    reason: str = ""              # why unchanged, when bailing out

    @property
    def instrs_before(self) -> int:
        return self.original.n

    @property
    def instrs_after(self) -> int:
        return self.image.n


def _instrs(image: ProgramImage) -> list[Instr]:
    return [Instr(op=int(image.op[i]), typ=int(image.typ[i]),
                  rd=int(image.rd[i]), ra=int(image.ra[i]),
                  rb=int(image.rb[i]), imm=int(image.imm[i]),
                  tsc=int(image.tsc[i]))
            for i in range(image.n)]


def _reassemble(instrs: Sequence[Instr], cfg: EGPUConfig,
                threads_active: int | None, *,
                drop: frozenset = frozenset(),
                repl: dict | None = None,
                schedule_nops: bool) -> ProgramImage:
    """Rebuild an image from ``instrs`` with branch targets re-expressed
    as labels, so dropping NOPs / dead writes (and the scheduler adding
    NOPs back) retargets every JMP/JSR/LOOP automatically.  A label on a
    dropped instruction floats to the next retained one."""
    repl = repl or {}
    n = len(instrs)
    targets = {int(i.imm) for i in instrs
               if int(i.op) in _TARGETS and 0 <= int(i.imm) <= n}
    a = Asm(cfg)
    for pc, ins in enumerate(instrs):
        if pc in targets:
            a.items.append(Label(f"_T{pc}"))
        if int(ins.op) == _NOP or pc in drop:
            continue
        ins = repl.get(pc, ins)
        if int(ins.op) in _TARGETS and int(ins.imm) in targets:
            ins = ins._replace(imm=f"_T{int(ins.imm)}")
        a.items.append(ins)
    if n in targets:
        a.items.append(Label(f"_T{n}"))
    # a trailing label must resolve inside the image: anchor it on an
    # explicit STOP (assemble() only auto-appends after label resolution
    # when the last instruction is not already a STOP)
    if a.items and isinstance(a.items[-1], Label):
        a.items.append(Instr(op=int(Op.STOP)))
    return a.assemble(threads_active, schedule_nops=schedule_nops)


def _lodi_imm(value: int, cfg: EGPUConfig) -> int | None:
    """The 16-bit immediate whose LODI result equals ``value`` under the
    config's ALU mask, or None when not representable."""
    mask = (1 << cfg.alu_bits) - 1 if cfg.alu_bits < 32 else _M32
    for cand in (value, value - (mask + 1 if mask < _M32 else 1 << 32)):
        if -32768 <= cand <= 32767 and (cand & mask) == value:
            return cand
    return None


def _fold_replacements(instrs: Sequence[Instr], cfg: EGPUConfig,
                       report: AnalysisReport) -> dict[int, Instr]:
    repl: dict[int, Instr] = {}
    for pc, value in report.facts.get("fold_candidates", {}).items():
        if not 0 <= pc < len(instrs):
            continue
        ins = instrs[pc]
        op = int(ins.op)
        if op not in _WRITES or op in (int(Op.DOT), int(Op.SUM)):
            continue
        imm = _lodi_imm(int(value), cfg)
        if imm is None:
            continue
        if op == int(Op.LODI) and int(ins.imm) == imm:
            continue                      # already canonical
        repl[pc] = Instr(op=int(Op.LODI), typ=int(Typ.U32), rd=int(ins.rd),
                         ra=0, rb=0, imm=imm, tsc=int(ins.tsc))
    return repl


def _dead_pcs(image: ProgramImage, report: AnalysisReport,
              threads: int) -> frozenset:
    """Register writes safe to drop: on every path to exit the value is
    strongly overwritten (unpredicated, full thread space) before any
    read.  Exit live-set is *all registers* — the final register file is
    part of the preserved state."""
    cfg = image.cfg
    n = image.n
    packed = np.stack([image.op, image.typ, image.rd, image.ra,
                       image.rb, image.imm, image.tsc],
                      axis=1).astype(np.int64)
    g = cfg_mod.build_cfg(packed, n)
    pred_at = report.facts.get("pred_at", {})
    nregs = cfg.regs_per_thread
    all_live = (1 << nregs) - 1
    w_rt = max(1, -(-threads // cfg.num_sps))
    wfs_table = (1, w_rt, max(1, -(-w_rt // 2)), max(1, -(-w_rt // 4)))

    def full_space(tsc: int) -> bool:
        lanes = isa.WIDTH_LANES[(tsc >> 2) & 3]
        return lanes == cfg.num_sps and wfs_table[tsc & 3] == w_rt

    def back(bi: int, live: int, sink: list | None) -> int:
        s, e = g.blocks[bi]
        for pc in range(e - 1, s - 1, -1):
            ins = packed[pc]
            op, rd, ra, rb, tsc = (int(ins[0]), int(ins[2]), int(ins[3]),
                                   int(ins[4]), int(ins[6]))
            if op >= NUM_OPCODES:
                continue
            if op in _WRITES:
                if sink is not None and not (live >> rd) & 1:
                    sink.append(pc)
                if (full_space(tsc) and pred_at.get(pc) == 0
                        and op not in (int(Op.DOT), int(Op.SUM))):
                    live &= ~(1 << rd)
            if op in _READS_RA:
                live |= 1 << ra
            if op in _READS_RB:
                live |= 1 << rb
            if op in _READS_RD:
                live |= 1 << rd
        return live

    def live_out_base(bi: int) -> int:
        term = int(packed[g.blocks[bi][1] - 1][0])
        if term in (int(Op.STOP), int(Op.RTS)) or not g.succs[bi]:
            return all_live           # exit (RTS may underflow-halt)
        return 0

    nb = len(g.blocks)
    live_in = {bi: 0 for bi in range(nb)}
    preds: dict[int, list[int]] = {bi: [] for bi in range(nb)}
    for bi in range(nb):
        for sb, _k in g.succs[bi]:
            preds[sb].append(bi)
    work = deque(range(nb))
    while work:
        bi = work.popleft()
        out = live_out_base(bi)
        for sb, _k in g.succs[bi]:
            out |= live_in[sb]
        new_in = back(bi, out, None)
        if new_in != live_in[bi]:
            live_in[bi] = new_in
            for pb in preds[bi]:
                if pb not in work:
                    work.append(pb)
    dead: list[int] = []
    for bi in range(nb):
        out = live_out_base(bi)
        for sb, _k in g.succs[bi]:
            out |= live_in[sb]
        back(bi, out, dead)
    return frozenset(dead)


def _verify_pattern(n_words: int) -> np.ndarray:
    """Deterministic, non-trivial shared-memory image for differential
    runs: a Knuth-multiplicative scramble of the address."""
    a = np.arange(n_words, dtype=np.uint64) * np.uint64(2654435761)
    return (a & np.uint64(_M32)).astype(np.uint32)


def optimize_image(image: ProgramImage, threads: int | None = None, *,
                   tdx_dim: int = 16, max_rounds: int = 8,
                   verify: bool = True) -> OptResult:
    """Optimize one assembled program; see the module docstring for the
    transforms and the equivalence contract.

    Never degrades: on analysis ERRORs in the *input*, or when a round
    fails re-verification, the original image is returned with
    ``changed=False`` and a ``reason``.  A differential mismatch under
    ``verify=True`` raises :class:`OptimizationError` (optimizer bug).
    """
    cfg = image.cfg
    if threads is None:
        threads = image.threads_active or cfg.max_threads
    orig_instrs = _instrs(image)
    nops_before = sum(1 for i in orig_instrs if int(i.op) == _NOP)

    def bail(reason: str, report=None) -> OptResult:
        return OptResult(image=image, original=image, changed=False,
                         rounds=0, folds=0, dce_removed=0,
                         nops_before=nops_before, nops_after=nops_before,
                         report=report, reason=reason)

    report = analyze(image, threads, tdx_dim=tdx_dim)
    if not report.ok:
        return bail("input-has-errors", report)
    if report.facts.get("analysis_clipped"):
        return bail("analysis-budget", report)

    # ---- iterate fold / DCE on a NOP-free image ------------------------
    tight = _reassemble(orig_instrs, cfg, image.threads_active,
                        schedule_nops=False)
    folds = dce = rounds = 0
    rep_t = analyze(tight, threads, tdx_dim=tdx_dim)
    while rounds < max_rounds:
        if not rep_t.ok:                 # a transform introduced an ERROR
            return bail("round-verification-failed", rep_t)
        instrs = _instrs(tight)
        repl = _fold_replacements(instrs, cfg, rep_t)
        drop = frozenset() if repl else _dead_pcs(tight, rep_t, threads)
        if not repl and not drop:
            break
        rounds += 1
        folds += len(repl)
        dce += len(drop)
        tight = _reassemble(instrs, cfg, image.threads_active,
                            drop=drop, repl=repl, schedule_nops=False)
        rep_t = analyze(tight, threads, tdx_dim=tdx_dim)

    # ---- re-derive hazard NOPs and verify ------------------------------
    final = _reassemble(_instrs(tight), cfg, image.threads_active,
                        schedule_nops=True)
    final_report = analyze(final, threads, tdx_dim=tdx_dim)
    if not final_report.ok:
        return bail("final-verification-failed", final_report)
    changed = final.words.tobytes() != image.words.tobytes()
    if changed and verify:
        from .concrete import concrete_run
        shared = _verify_pattern(cfg.shared_words)
        a = concrete_run(image, threads, tdx_dim=tdx_dim, shared_init=shared)
        b = concrete_run(final, threads, tdx_dim=tdx_dim, shared_init=shared)
        if (a.halted != b.halted
                or not np.array_equal(a.regs, b.regs)
                or not np.array_equal(a.shared, b.shared)):
            raise OptimizationError(
                f"optimized program diverges from the original "
                f"(halted {a.halted}->{b.halted}; "
                f"regs equal: {np.array_equal(a.regs, b.regs)}; "
                f"shared equal: {np.array_equal(a.shared, b.shared)})")
    nops_after = int(np.sum(final.op == _NOP))
    return OptResult(image=final if changed else image, original=image,
                     changed=changed, rounds=rounds, folds=folds,
                     dce_removed=dce, nops_before=nops_before,
                     nops_after=nops_after if changed else nops_before,
                     report=final_report)


_CACHE: OrderedDict = OrderedDict()
_CACHE_LOCK = threading.Lock()
_CACHE_MAX = 128


def optimize_image_cached(image: ProgramImage, threads: int | None = None,
                          *, tdx_dim: int = 16,
                          verify: bool = True) -> OptResult:
    """LRU-cached :func:`optimize_image` keyed on (config, program bits,
    threads, tdx_dim) — the ``compile_program(optimize=True)`` path calls
    this, so a hot program pays the optimizer once."""
    cfg = image.cfg
    t = threads if threads is not None \
        else (image.threads_active or cfg.max_threads)
    key = (cfg, image.words.tobytes(), t, tdx_dim, verify)
    with _CACHE_LOCK:
        hit = _CACHE.get(key)
        if hit is not None:
            _CACHE.move_to_end(key)
            return hit
    res = optimize_image(image, threads, tdx_dim=tdx_dim, verify=verify)
    with _CACHE_LOCK:
        _CACHE[key] = res
        while len(_CACHE) > _CACHE_MAX:
            _CACHE.popitem(last=False)
    return res
