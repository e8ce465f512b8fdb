"""The eGPU block compiler on PyTorch: the blocks and superblock tiers.

The port of ``repro.core.blockc``.  Every :class:`ProgramImage` is
static and the eGPU ISA has no data-dependent branch: JMP/JSR/LOOP
targets and INIT counts are immediates, so the whole executed path, and
with it the cycle count, the instruction mix and the RAW hazard checker,
is known on the host before anything runs.  The host half of this module
(:func:`_simulate`, :class:`_PathRecorder`, the schedule helpers and
:class:`TierPolicy`) is the reference's, copied: numpy and Python ints.

The device half runs only the data path, one instruction a row with
every decoded field a Python constant (:meth:`CompiledProgram.
_apply_row`), in place on one set of static buffers per (device, batch
width) (:class:`_Plan`): the register file, shared memory with the
executor's drop slot, the predicate stacks, the predicate mask and the
TDX grid.  FP rows are one launch of the ``wavefront_alu`` step kernel
and DOT/SUM rows one of the ``dot_product`` step kernel, each reading a
constant trace row uploaded with the plan; every other opcode runs as
torch ops on views, as the executor's one-core path does.

Where the reference fuses code into one XLA computation, the port
captures it as one CUDA graph (a *unit*), and the host replays the
units in the order the static path gives:

* **blocks**: the program is cut into basic blocks (:func:`repro_torch.
  core.cfg.decompose`); each block with device work is one unit, and
  the host walks the block order (the reference's data-independent
  ``_Seq``: PC, stacks, cycles, stats) and replays one graph for each
  dispatch;
* **superblock**: the folded schedule becomes a host-side list of
  segments: straight lines (small repeats, at most ``_UNROLL_FULL``
  executed instructions, inlined) and ``(body, count)`` repeats (the
  reference's ``lax.fori_loop``), whose body is its own unit replayed
  ``count`` times; nested repeats recurse.  Every data-independent leaf
  is baked from the simulation.

The graphs are captured once per plan (:meth:`CompiledProgram.
light_compile`, or the first run at that device and width), after one
eager warm-up of each unit on a side stream.  A replay makes no ctypes
call, so each unit records the step launches it captured and every run
adds them to the kernels' counters.  On the CPU the same units run
eagerly, with the kernels' plain versions.  Results are bit-identical
to the reference's ``run_program`` on every leaf: superblock -> blocks
-> interpreter, as in the reference.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from . import cfg as cfg_mod
from . import isa, semantics
from . import machine as machine_mod
from .assembler import ProgramImage
from .config import EGPUConfig
from .executor import (EXT_OPCODES, FP_OPCODES, HostCore, _PF_OP, _PF_RA,
                       _PF_RB, _PF_RD, _TC_CLS, _TC_LAT, _TC_PER_WF0,
                       _TC_READS_RA, _TC_READS_RB, _TC_READS_RD, _TC_SCALAR,
                       _TC_WRITES_PRED, _TC_WRITES_RD, pad_image, sequence,
                       tables_np)
from .isa import Op, Typ
from .machine import MachineState, resolve_device, sync
from ..kernels import build, egpu_step, fp32
from ..kernels.dot_product import ops as dops
from ..kernels.wavefront_alu import ops as wops
from ..obs import trace as obs_trace

#: block/trace structure is shared with the static analyzer — see
#: ``repro_torch.core.cfg`` for the definitions
_SEQ_TERM = cfg_mod.SEQ_TERM
_MAX_BLOCK = cfg_mod.MAX_BLOCK
_MAX_TRACE = cfg_mod.MAX_TRACE

#: a repeat whose *executed* size is at most this unrolls fully into the
#: surrounding straight line; larger repeats capture their body once and
#: replay it ``count`` times.
_UNROLL_FULL = 256

#: host-side path-simulation bound (a program must halt within
#: ``min(cfg.max_steps, _SIM_CAP)`` to be block-compilable)
_SIM_CAP = 4_000_000


class BlockCompileError(Exception):
    """The program cannot be block-compiled (e.g. it does not halt within
    ``cfg.max_steps``, so interpreter equivalence cannot be guaranteed at
    block granularity).  Callers fall back to the interpreter."""


def _cdiv(a, b):
    return (a + b - 1) // b


def _gidx(i: int, n: int) -> int:
    """JAX dynamic-gather index semantics: negative wraps once, then
    clamps into range (mirrors ``arr[i]`` with a traced ``i``)."""
    if i < 0:
        i += n
    return min(max(i, 0), n - 1)


def _i32wrap(v: int) -> int:
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


# ---------------------------------------------------------------------------
# Static decode helpers
# ---------------------------------------------------------------------------

def _wfs_table(cfg: EGPUConfig, threads: int) -> list[int]:
    w_rt = _cdiv(threads, cfg.num_sps)
    return [1, w_rt, max(1, _cdiv(w_rt, 2)), max(1, _cdiv(w_rt, 4))]


def _tsc_static(cfg: EGPUConfig, tsc: int, threads: int):
    """(wfs, tsc_mask) for one instruction — everything Table 3 encodes,
    folded to Python/NumPy constants."""
    width_code = (tsc >> 2) & 3
    depth_code = tsc & 3
    wfs = _wfs_table(cfg, threads)[depth_code]
    lanes = isa.WIDTH_LANES[width_code]
    tid = np.arange(cfg.max_threads)
    tsc_mask = ((tid % cfg.num_sps < lanes) & (tid // cfg.num_sps < wfs)
                & (tid < threads))
    return wfs, tsc_mask


# ---------------------------------------------------------------------------
# CFG decomposition
# ---------------------------------------------------------------------------

#: shared with the static analyzer — extracted to ``repro.core.cfg``
_decompose = cfg_mod.decompose


# ---------------------------------------------------------------------------
# Superblock schedules: the compressed static path
# ---------------------------------------------------------------------------
#
# A *schedule* is a tuple of items; an item is an ``int`` pc (execute
# that instruction) or ``("rep", body, count)`` where ``body`` is itself
# a schedule executed ``count`` times.  Flattening a schedule always
# reproduces the exact executed path — folding is equality-guarded.

def _sched_insts(items) -> int:
    """Instruction slots a schedule *traces* (each repeat body once)."""
    n = 0
    for it in items:
        n += 1 if isinstance(it, (int, np.integer)) else _sched_insts(it[1])
    return n


def _sched_execd(items) -> int:
    """Instructions a schedule *executes* (repeat bodies times count)."""
    n = 0
    for it in items:
        if isinstance(it, (int, np.integer)):
            n += 1
        else:
            n += it[2] * _sched_execd(it[1])
    return n


def _trace_cost(items) -> int:
    """Instructions the superblock runner will actually capture, given
    the full-unroll policy (small repeats inline ``count`` times, large
    ones capture the body once and replay it, the reference's
    ``lax.fori_loop``)."""
    c = 0
    for it in items:
        if isinstance(it, (int, np.integer)):
            c += 1
        else:
            ex = it[2] * _sched_execd(it[1])
            c += ex if ex <= _UNROLL_FULL else _trace_cost(it[1])
    return c


class _PlanStats(NamedTuple):
    """What the superblock runner would actually do with a schedule,
    mirroring its unroll policy exactly (see ``_apply_schedule``)."""

    trace_cost: int             # instructions captured (== _trace_cost)
    fori_reps: int              # repeat nodes run as a replayed body
    unrolled_reps: int          # repeat nodes inlined into the line
    fori_trips: tuple           # trip counts of the fori repeats
    fori_execd: int             # instructions executed inside fori reps


def _plan_stats(items) -> _PlanStats:
    trace = fori = unrolled = fori_execd = 0
    trips: list[int] = []
    for it in items:
        if isinstance(it, (int, np.integer)):
            trace += 1
            continue
        _, body, count = it
        ex = count * _sched_execd(body)
        if ex <= _UNROLL_FULL:
            # the whole subtree inlines: nested repeats unroll with it
            trace += ex
            unrolled += 1 + _count_reps(body)
        else:
            sub = _plan_stats(body)
            trace += sub.trace_cost
            fori += 1 + sub.fori_reps
            unrolled += sub.unrolled_reps
            trips.append(count)
            trips.extend(sub.fori_trips)
            fori_execd += ex
    return _PlanStats(trace_cost=trace, fori_reps=fori,
                      unrolled_reps=unrolled, fori_trips=tuple(trips),
                      fori_execd=fori_execd)


def _count_reps(items) -> int:
    n = 0
    for it in items:
        if not isinstance(it, (int, np.integer)):
            n += 1 + _count_reps(it[1])
    return n


def _sched_rep_trips(items) -> int:
    """Summed trip counts over every repeat node (each node once, like
    ``_PlanStats.fori_trips``) — event-counter bookkeeping."""
    n = 0
    for it in items:
        if not isinstance(it, (int, np.integer)):
            n += it[2] + _sched_rep_trips(it[1])
    return n


def _sched_rep_execd(items) -> int:
    """Instructions executed inside any repeat node (top-level bodies
    times count, nesting included) — event-counter bookkeeping."""
    n = 0
    for it in items:
        if not isinstance(it, (int, np.integer)):
            n += it[2] * _sched_execd(it[1])
    return n


#: default :class:`TierPolicy` threshold table.  Calibrated on the CPU
#: backend by the ``auto_tier`` crossover sweep in
#: ``benchmarks/superblock.py`` (loop_saxpy back-edge counts 8 -> 2048,
#: interleaved best-of timing through the light path, which is what the
#: fleet scheduler and the throughput benchmarks actually run): the
#: basic-block driver's cost grows ~linearly with its ``lax.switch``
#: dispatch count while the superblock runner stays nearly flat, and
#: the superblock's fixed per-call cost — mostly the 18-leaf
#: ``MachineState`` assembly on the full path — shrinks enough on the
#: light path that the measured crossover sits between 16 and 32
#: back-edges.  Batched lock-step runs tilt further: the block driver's
#: per-dispatch carried-state copies scale with the batch width, and at
#: batch >= 4 the superblock tier measured faster (or equal) on every
#: swept program, so wide batches always take an eligible superblock.
_TIER_DEFAULTS: dict[str, int | None] = {
    # hard eligibility bound on the traced-instruction budget
    # (None -> the module-wide ``_MAX_TRACE``)
    "max_trace_cost": None,
    # batches at least this wide always take an eligible superblock
    "batch_superblock_min": 4,
    # single-core: a plan must save at least this many block-driver
    # switch dispatches to amortize the superblock's fixed overhead
    "min_backedge_dispatches": 24,
    # single-core: a plan tracing at least this many instructions wins
    # on cross-block fusion even with few dispatches (bitonic/FFT-like
    # straight-line-heavy programs); below it, short fully-unrolled
    # traces stay on the (cheaper-to-launch) block driver
    "min_trace_fusion": 256,
    # single-core: a plan executing at least this many instructions
    # inside fori repeats amortizes the fixed overhead through the fused
    # loop body regardless of the dispatch count
    "min_fori_execd": 8192,
}


class TierPolicy:
    """The static cost model behind ``mode="auto"`` tier selection.

    Decides basic-block driver vs superblock runner from the host-side
    path simulation alone (:class:`_SimResult`) — no measurement, no
    dynamic feedback — the way the paper fixes processor structure from
    the statically-known resource mix.  The decision procedure, first
    match wins:

    1. no folded schedule, or its trace cost over ``max_trace_cost``
       -> **blocks** (ineligible);
    2. ``batch >= batch_superblock_min`` -> **superblock** (the block
       driver's per-dispatch carried-state copies scale with the batch
       width; measured at batch 32 the superblock tier is faster on
       every swept program);
    3. ``dispatches >= min_backedge_dispatches`` -> **superblock** (the
       dispatch savings amortize the fixed overhead);
    4. ``trace_cost >= min_trace_fusion`` -> **superblock** (cross-block
       fusion of a long trace — whether straight-line or unrolled);
    5. instructions executed inside ``fori``-run repeats
       ``>= min_fori_execd`` -> **superblock**;
    6. otherwise -> **blocks** (small paths — few dispatches, short
       trace: the superblock's fixed per-call cost eats the dispatch
       win).

    Thresholds are overridable per instance (``TierPolicy(
    min_backedge_dispatches=64)``); instances are immutable, hashable
    and usable as compile-cache key components.
    """

    def __init__(self, **overrides: int | None):
        unknown = set(overrides) - set(_TIER_DEFAULTS)
        if unknown:
            raise ValueError(
                f"unknown TierPolicy thresholds {sorted(unknown)}; "
                f"known: {sorted(_TIER_DEFAULTS)}")
        table = dict(_TIER_DEFAULTS)
        table.update(overrides)
        self._table = table
        self._key = tuple(sorted(table.items()))

    @property
    def table(self) -> dict[str, int | None]:
        """A copy of the threshold table (the instance stays immutable)."""
        return dict(self._table)

    def __eq__(self, other) -> bool:
        return isinstance(other, TierPolicy) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        diff = {k: v for k, v in self._table.items()
                if v != _TIER_DEFAULTS[k]}
        return f"TierPolicy({', '.join(f'{k}={v}' for k, v in diff.items())})"

    # ------------------------------------------------------------ model
    def batch_class(self, batch: int) -> int:
        """Collapse a batch-size hint to the classes the decision can
        distinguish (keeps compile-cache keys from fragmenting across
        every batch shape)."""
        wide = self._table["batch_superblock_min"]
        return wide if batch >= wide else 1

    def features(self, sim: _SimResult,
                 cfg_facts: dict | None = None) -> dict:
        """The decision's inputs, extracted from one path simulation.

        ``cfg_facts`` merges static control-flow-graph facts
        (:func:`repro.core.cfg.summary`) into the feature dict — the
        decision rules ignore keys they don't know, so the extra
        features ride along for logging and offline cost-model
        fitting."""
        cap = self._table["max_trace_cost"]
        cap = _MAX_TRACE if cap is None else cap
        base = {"dispatches": sim.dispatches, "execd": sim.steps}
        if cfg_facts:
            base.update(cfg_facts)
        if sim.schedule is None:
            return {**base, "eligible": False, "trace_cost": None,
                    "fori_reps": 0, "unrolled_reps": 0,
                    "fori_trips": (), "fori_execd": 0}
        ps = _plan_stats(sim.schedule)
        return {**base, "eligible": ps.trace_cost <= cap,
                "trace_cost": ps.trace_cost, "fori_reps": ps.fori_reps,
                "unrolled_reps": ps.unrolled_reps,
                "fori_trips": ps.fori_trips, "fori_execd": ps.fori_execd}

    def choose(self, sim: _SimResult, batch: int = 1, *,
               features: dict | None = None) -> str:
        """``"superblock"`` or ``"blocks"`` for this path at this batch
        width — the cheaper tier under the calibrated cost model.
        ``features`` accepts a precomputed :meth:`features` result so a
        caller that already extracted them doesn't pay the schedule
        walk twice."""
        f = self.features(sim) if features is None else features
        tier, rule = self._decide(f, batch)
        tr = obs_trace.current_tracer()
        if tr is not None:
            feats = {k: list(v) if isinstance(v, tuple) else v
                     for k, v in f.items()}
            tr.event("tier_decision", tier=tier, rule=rule,
                     batch=int(batch), features=feats,
                     thresholds=dict(self._table))
        return tier

    def _decide(self, f: dict, batch: int) -> tuple[str, str]:
        """(tier, first-matching rule) — the loggable decision core."""
        if not f["eligible"]:
            return "blocks", "ineligible (no schedule or over trace cap)"
        t = self._table
        if batch >= t["batch_superblock_min"]:
            return "superblock", (f"batch {batch} >= "
                                  f"batch_superblock_min "
                                  f"{t['batch_superblock_min']}")
        if f["dispatches"] >= t["min_backedge_dispatches"]:
            return "superblock", (f"dispatches {f['dispatches']} >= "
                                  f"min_backedge_dispatches "
                                  f"{t['min_backedge_dispatches']}")
        if f["trace_cost"] >= t["min_trace_fusion"]:
            return "superblock", (f"trace_cost {f['trace_cost']} >= "
                                  f"min_trace_fusion "
                                  f"{t['min_trace_fusion']}")
        if f["fori_execd"] >= t["min_fori_execd"]:
            return "superblock", (f"fori_execd {f['fori_execd']} >= "
                                  f"min_fori_execd {t['min_fori_execd']}")
        return "blocks", "no superblock rule fired"


#: the policy ``mode="auto"`` uses unless a caller overrides it
DEFAULT_TIER_POLICY = TierPolicy()


#: Per-backend threshold tables consulted by
#: :meth:`TierPolicy.for_backend`.  ``"cpu"`` is the measured default
#: (the ``auto_tier`` sweep above).  The ``"gpu"``/``"tpu"`` seeds are
#: *priors*, not measurements: on accelerators the block driver's
#: ``lax.switch`` dispatch is relatively more expensive (each dispatch
#: is a device-side branch over all traced blocks) while the
#: superblock's fixed host-side cost is amortized by the launch, so the
#: crossover moves earlier.  ``benchmarks/calibrate.py`` replaces a
#: seed with a fitted table by running the same sweep on the actual
#: backend and calling :func:`register_backend_table`.
_TIER_TABLES: dict[str, dict[str, int | None]] = {
    "cpu": dict(_TIER_DEFAULTS),
    "gpu": {**_TIER_DEFAULTS, "min_backedge_dispatches": 12,
            "min_trace_fusion": 128, "min_fori_execd": 4096},
    "tpu": {**_TIER_DEFAULTS, "min_backedge_dispatches": 12,
            "min_trace_fusion": 128, "min_fori_execd": 4096},
}


def register_backend_table(kind: str, **thresholds: int | None) -> None:
    """Install a (typically calibration-fitted) threshold table for one
    backend kind (``"cpu"``/``"gpu"``/``"tpu"``).  Unnamed thresholds
    keep the module defaults.  Subsequent
    :meth:`TierPolicy.for_backend`/:func:`default_policy_for_device`
    calls see the new table; already-constructed policies are unchanged
    (instances are immutable)."""
    unknown = set(thresholds) - set(_TIER_DEFAULTS)
    if unknown:
        raise ValueError(
            f"unknown TierPolicy thresholds {sorted(unknown)}; "
            f"known: {sorted(_TIER_DEFAULTS)}")
    _TIER_TABLES[kind] = {**_TIER_DEFAULTS, **thresholds}


def tier_policy_for_backend(kind: str) -> TierPolicy:
    """The :class:`TierPolicy` for a backend kind, from the registered
    (seeded or calibrated) table; unknown kinds fall back to the CPU
    defaults."""
    table = _TIER_TABLES.get(kind)
    if table is None:
        return DEFAULT_TIER_POLICY
    overrides = {k: v for k, v in table.items() if v != _TIER_DEFAULTS[k]}
    return TierPolicy(**overrides) if overrides else DEFAULT_TIER_POLICY


#: ``torch.device.type`` -> the backend kind of :data:`_TIER_TABLES`
_DEVICE_KIND = {"cuda": "gpu", "cpu": "cpu"}


def default_policy_for_device(device) -> TierPolicy:
    """Policy for a torch device (``None`` -> the default policy, so
    unpinned schedulers never touch device state): a ``cuda`` device
    takes the ``"gpu"`` prior, the CPU the CPU table."""
    if device is None:
        return DEFAULT_TIER_POLICY
    kind = torch.device(device).type
    return tier_policy_for_backend(_DEVICE_KIND.get(kind, kind))


class _PathRecorder:
    """Online fold of the executed path into a superblock schedule.

    Every executed pc is appended to the open schedule; at each LOOP
    back-edge the just-completed iteration is compared against the
    previous one (or an already-open repeat node) and folded when equal.
    A first iteration entered mid-body simply fails the comparison and
    stays inline — a free peel.  All mutations preserve the invariant
    that the schedule flattens to the exact executed path, so bookkeeping
    confusion (unbalanced INIT/LOOP, JMP out of a loop) can only cost
    compression, never correctness.  Recording bails out (``schedule()``
    returns None) when the retained size exceeds the trace budget or a
    LOOP fires with no open loop instance.
    """

    def __init__(self, cap: int):
        self._cap = cap
        self._items: list = []
        self._insts = 0             # instruction slots currently retained
        self._dead = False
        self._loops: list[dict] = []   # parallels the simulator loop stack

    def _bail(self) -> None:
        self._dead = True
        self._items = []
        self._loops = []

    def step(self, pc: int) -> None:
        if self._dead:
            return
        self._items.append(pc)
        self._insts += 1
        if self._insts > 2 * self._cap:
            self._bail()

    def on_init(self) -> None:
        if self._dead:
            return
        self._loops.append({"iter_start": len(self._items), "cand": None,
                            "cand_start": 0, "rep_idx": None})

    def on_loop(self, taken: bool) -> None:
        """Called after the LOOP pc itself was recorded via ``step``."""
        if self._dead:
            return
        if not self._loops:
            self._bail()                 # unbalanced LOOP: give up folding
            return
        inst = self._loops[-1]
        cur = self._items
        seg = tuple(cur[inst["iter_start"]:])
        ri = inst["rep_idx"]
        if ri is not None and cur[ri][1] == seg:
            cur[ri] = ("rep", seg, cur[ri][2] + 1)
            del cur[inst["iter_start"]:]
            self._insts -= _sched_insts(seg)
        elif inst["cand"] == seg:
            del cur[inst["cand_start"]:]
            cur.append(("rep", seg, 2))
            self._insts -= _sched_insts(seg)
            inst["rep_idx"] = len(cur) - 1
            inst["cand"] = None
            inst["iter_start"] = len(cur)
        else:
            inst["cand"] = seg
            inst["cand_start"] = inst["iter_start"]
            inst["rep_idx"] = None
            inst["iter_start"] = len(cur)
        if not taken:
            self._loops.pop()

    def schedule(self) -> tuple | None:
        return None if self._dead else tuple(self._items)


# ---------------------------------------------------------------------------
# Static path simulation: sequencer + cycles + hazard checker, on the host
# ---------------------------------------------------------------------------

class _SimResult(NamedTuple):
    steps: int
    cycles: int
    hazard: np.ndarray          # (R+2, 4) int32 — final checker rows
    violations: int
    pc: int                     # final PC
    halted: bool
    lctr: np.ndarray            # (LD,) int32 — final loop-counter stack
    lsp: int
    cstack: np.ndarray          # (CD,) int32 — final call stack
    csp: int
    stat_cycles: np.ndarray     # (NUM_OP_CLASSES,) int32
    stat_instrs: np.ndarray
    dispatches: int             # block-driver switch dispatches on this path
    schedule: tuple | None      # folded superblock schedule (None: too big)
    # event counters (python ints — unbounded, never wrapped):
    backedges: int = 0          # taken LOOP back-edges on the path
    lane_offered: int = 0       # vector retires x runtime thread count
    lane_active: int = 0        # of which the TSC mask left on


def _simulate(cfg: EGPUConfig, packed: np.ndarray, prog_len: int,
              threads: int, validate: bool, *,
              block_starts: frozenset = frozenset(),
              n_real: int | None = None) -> _SimResult:
    """Walk the (fully static) execution path once, mirroring the
    interpreter's sequencer, cycle accounting and hazard checker
    bit-for-bit, while folding the path into a superblock schedule and
    counting the block-driver dispatches it would cost.  Raises
    :class:`BlockCompileError` if the program does not halt before
    ``cfg.max_steps`` (the interpreter would then stop mid-block, which
    neither compiled driver can reproduce)."""
    t = tables_np(cfg)
    R = cfg.regs_per_thread
    LD, CD = cfg.max_loop_depth, cfg.max_call_depth
    wfs_by_depth = _wfs_table(cfg, threads)
    hz = machine_mod.hazard_init(R).astype(np.int64)
    violations = 0
    lctr = [0] * LD
    cstack = [0] * CD
    lsp = csp = 0
    pc = cycles = steps = 0
    halted = False
    cap = min(cfg.max_steps, _SIM_CAP)
    L = packed.shape[0]
    n_real = prog_len if n_real is None else n_real
    stat_c = [0] * isa.NUM_OP_CLASSES
    stat_i = [0] * isa.NUM_OP_CLASSES
    dispatches = 0
    backedges = 0
    lane_offered = lane_active = 0
    act_lut: dict[int, int] = {}    # tsc code -> active lanes (16 codes)
    rec = _PathRecorder(_MAX_TRACE)

    while (not halted) and steps < cfg.max_steps and 0 <= pc < prog_len:
        if steps >= cap:
            raise BlockCompileError(
                f"program did not halt within {cap} steps")
        op, typ, rd, ra, rb, imm, tsc = (int(v) for v in packed[min(pc, L - 1)])
        width_code = (tsc >> 2) & 3
        depth_code = tsc & 3
        wfs = wfs_by_depth[depth_code]
        per_wf = int(t[op, _TC_PER_WF0 + width_code])
        scalar = bool(t[op, _TC_SCALAR])
        writes_rd = bool(t[op, _TC_WRITES_RD])
        issue = 1 if scalar else per_wf * wfs
        rec.step(pc)
        if pc >= n_real or pc in block_starts:
            dispatches += 1
        stat_c[int(t[op, _TC_CLS])] += issue
        stat_i[int(t[op, _TC_CLS])] += 1
        if not scalar:
            act = act_lut.get(tsc)
            if act is None:
                act = act_lut[tsc] = int(
                    _tsc_static(cfg, tsc, threads)[1].sum())
            lane_offered += threads
            lane_active += act

        if validate:
            rows = [hz[_gidx(ra, R + 2)], hz[_gidx(rb, R + 2)],
                    hz[_gidx(rd, R + 2)], hz[R], hz[R + 1]]
            flags = [bool(t[op, _TC_READS_RA]), bool(t[op, _TC_READS_RB]),
                     bool(t[op, _TC_READS_RD]), op == Op.LOD,
                     cfg.has_predicates and not scalar]
            need = -(1 << 30)
            for (p_start, p_per_wf, p_wfs, p_lat), fl in zip(rows, flags):
                if not fl:
                    continue
                k = min(int(p_wfs), wfs) - 1 if p_per_wf > per_wf else 0
                cons = int(p_start) + int(p_per_wf) * (k + 1) - 1 \
                    + int(p_lat) - per_wf * k
                need = max(need, cons)
            if ((not scalar) or op == Op.LOD) and need > cycles:
                violations += 1
            new_row = (cycles, per_wf, wfs, int(t[op, _TC_LAT]))
            if writes_rd and 0 <= rd < R + 2:
                hz[rd] = new_row
            if op == Op.STO:
                hz[R] = new_row
            if t[op, _TC_WRITES_PRED]:
                hz[R + 1] = new_row

        if op == Op.JMP:
            pc = imm
        elif op == Op.JSR:
            if 0 <= csp < CD:
                cstack[csp] = pc + 1
            csp += 1
            pc = imm
        elif op == Op.RTS:
            pc = cstack[_gidx(csp - 1, CD)]
            csp -= 1
        elif op == Op.LOOP:
            ltop = lctr[_gidx(lsp - 1, LD)]
            if 0 <= lsp - 1 < LD:
                lctr[lsp - 1] = ltop - 1
            if ltop > 0:
                pc = imm
                backedges += 1
            else:
                lsp -= 1
                pc += 1
            rec.on_loop(ltop > 0)
        elif op == Op.INIT:
            if 0 <= lsp < LD:
                lctr[lsp] = imm
            lsp += 1
            pc += 1
            rec.on_init()
        else:
            if op == Op.STOP:
                halted = True
            pc += 1
        cycles = _i32wrap(cycles + issue)
        steps += 1

    if (not halted) and steps >= cfg.max_steps and 0 <= pc < prog_len:
        raise BlockCompileError(
            f"program did not halt within max_steps={cfg.max_steps}")
    return _SimResult(
        steps=steps, cycles=cycles, hazard=hz.astype(np.int32),
        violations=violations, pc=_i32wrap(pc), halted=halted,
        lctr=np.asarray([_i32wrap(v) for v in lctr], np.int32),
        lsp=_i32wrap(lsp),
        cstack=np.asarray([_i32wrap(v) for v in cstack], np.int32),
        csp=_i32wrap(csp),
        stat_cycles=np.asarray([_i32wrap(v) for v in stat_c], np.int32),
        stat_instrs=np.asarray([_i32wrap(v) for v in stat_i], np.int32),
        dispatches=dispatches, schedule=rec.schedule(),
        backedges=backedges, lane_offered=lane_offered,
        lane_active=lane_active)


# ---------------------------------------------------------------------------
# The device half: static buffers, units and CUDA graphs
# ---------------------------------------------------------------------------

#: sequencer ops: no data semantics (their effects are walked or baked on
#: the host)
_DATA_NOOPS = frozenset(int(o) for o in (Op.JMP, Op.JSR, Op.RTS, Op.LOOP,
                                         Op.INIT, Op.STOP, Op.NOP))
#: the final state's leaves that the blocks tier takes from its host walk
_SEQ_LEAVES = ("pc", "cycles", "steps", "halted", "lctr", "lsp", "cstack",
               "csp", "stat_cycles", "stat_instrs")
_FP_OPS = frozenset(FP_OPCODES)
_EXT_OPS = frozenset(EXT_OPCODES)
#: the step kernels' wrappers, whose ``launches`` and ``by_route["step"]``
#: count the launches that runs execute
_STEP_WRAPPERS = (wops.wavefront_alu, dops.dot_product)


def _add_step_launches(counts) -> None:
    """Add step-route launches to the kernels' counters: those a graph
    replay executed (a replay makes no ctypes call), or, negative, those
    a capture recorded without running them."""
    for f, n in zip(_STEP_WRAPPERS, counts):
        f.launches += n
        f.by_route["step"] += n


def _norm_device(device) -> torch.device:
    """One key per card: ``cuda`` means the current card's index."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


#: one capture at a time in the process: a plan captures on a stream of
#: PyTorch's pool, which hands out its 32 streams a card round robin, so
#: two plans being made at once may have drawn the same stream
_CAPTURE_LOCK = threading.Lock()


class _Unit(NamedTuple):
    """A straight line of rows with device work, as the plan runs it:
    ``run()`` replays its graph (the card) or issues its rows (the CPU);
    ``launches`` are the step launches of one run, by kernel."""

    run: object
    launches: tuple


class _Plan:
    """The static state of one compiled program at one (device, batch
    width): the buffers every row writes in place, and the units of the
    program's tier in the order a run replays them.

    ``regs (B, T, R)`` int32, ``shared (B, S + 1)`` int32 (slot ``S``
    drops masked and out-of-range stores, as the executor's), ``pstack
    (B, T, D)``, ``pdepth (B, T)``, ``pred (B, T)`` (the predicate mask,
    recomputed in place after every predicate op), ``tdx (B, 1)``, the
    16 TSC masks ``(B, 16, T)`` and the kernels' trace rows ``(L, B, 7)``
    int64 (the program's rows with the register fields clamped, as the
    reference's row op reads them).  On the card each unit is captured
    as one CUDA graph over these buffers on the plan's own stream, and
    the step launches go to that stream, prepared inside its context.

    The buffers are the plan's only state, so one run at a time holds
    them (:meth:`run`): the plan's lock from the copy-in to the outputs'
    copies and, on the card, an event: a run goes to the caller's
    current stream after it waits for the plan's previous run, whatever
    stream that ran on.  Captures run one at a time (:data:`_CAPTURE_LOCK`)
    in ``thread_local`` error mode, so another thread's allocation or
    stream synchronise does not void them (a synchronise of the whole
    card would: nothing beside a capture makes one).  A caller that
    enqueues on a pool stream of its own while another thread makes a
    plan may share the capturing stream, as with ``torch.cuda.graph``.
    """

    def __init__(self, cp: "CompiledProgram", device: torch.device,
                 batch: int):
        cfg = cp.cfg
        T, R, S = cfg.max_threads, cfg.regs_per_thread, cfg.shared_words
        D = max(1, cfg.predicate_levels)
        B = batch
        self.cp, self.device, self.batch = cp, device, B

        def dev(a):   # a C-ordered copy: the step kernels take dense rows
            return torch.from_numpy(np.array(a, order="C")).to(device)

        self.regs = torch.zeros((B, T, R), dtype=torch.int32, device=device)
        self.shared = torch.zeros((B, S + 1), dtype=torch.int32,
                                  device=device)
        self.pstack = torch.zeros((B, T, D), dtype=torch.bool, device=device)
        self.pdepth = torch.zeros((B, T), dtype=torch.int32, device=device)
        self.pred = torch.ones((B, T), dtype=torch.bool, device=device)
        self.tdx = torch.ones((B, 1), dtype=torch.int32, device=device)
        self.masks = dev(np.broadcast_to(cp._masks, (B,) + cp._masks.shape))
        self.rows = dev(np.broadcast_to(cp._krows[:, None],
                                        (cp._krows.shape[0], B, 7)))
        self.tid = torch.arange(T, dtype=torch.int32, device=device)
        self.pred_arg = self.pred if cp.has_preds else None
        #: the final state's data-independent leaves, uploaded once
        self.host_leaves = {k: dev(np.broadcast_to(v, (B,) + np.shape(v)))
                            for k, v in cp._host_leaves().items()}
        self.graphs = device.type == "cuda"
        self.capture_s = 0.0
        #: step launches issued through this plan since the last reset
        #: (a capture's, counted apart from other threads' launches)
        self._issued = [0] * len(_STEP_WRAPPERS)
        self._units: dict = {}
        self.lock = threading.Lock()
        if not self.graphs:
            self.order = [self._unit(k) for k in cp._unit_order()]
            self.launches = (0,) * len(_STEP_WRAPPERS)
            return
        if any(int(o) == Op.INVSQR for o in cp.image.op):
            fp32._rsqrt_table(device)        # its upload cannot be captured
        self.stream = torch.cuda.Stream(device)     # the capture stream
        #: recorded at the end of each run, on the stream it ran on
        self.done = torch.cuda.Event()
        self.pool = torch.cuda.graph_pool_handle()
        self._row0 = self.rows.data_ptr()
        self._row_bytes = B * 7 * self.rows.element_size()
        self._pred_ptr = self.pred.data_ptr() if cp.has_preds else 0
        t0 = time.perf_counter()
        with _CAPTURE_LOCK:
            self.stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(self.stream):
                # a launcher takes the current stream when it is prepared
                self._fp = wops.fp_step_launcher(self.regs, self.masks,
                                                 FP_OPCODES)
                self._ext = dops.ext_step_launcher(self.regs, self.masks,
                                                   EXT_OPCODES)
                self.order = [self._unit(k) for k in cp._unit_order()]
            self.stream.synchronize()
        self.capture_s = time.perf_counter() - t0
        self.launches = tuple(sum(u.launches[i] for u in self.order)
                              for i in range(len(_STEP_WRAPPERS)))

    # ------------------------------------------------------ step kernels
    def fp_step(self, pc: int) -> None:
        if self.graphs:
            self._fp(self._row0 + pc * self._row_bytes, self._pred_ptr)
            self._issued[0] += 1
        else:
            wops.fp_step(self.regs, self.rows[pc], self.masks,
                         self.pred_arg, FP_OPCODES)

    def ext_step(self, pc: int) -> None:
        if self.graphs:
            self._ext(self._row0 + pc * self._row_bytes, self._pred_ptr)
            self._issued[1] += 1
        else:
            dops.ext_step(self.regs, self.rows[pc], self.masks,
                          self.pred_arg, EXT_OPCODES)

    # ------------------------------------------------------------- units
    def _unit(self, pcs: tuple) -> _Unit:
        u = self._units.get(pcs)
        if u is None:
            u = self._units[pcs] = self._make_unit(pcs)
        return u

    def _make_unit(self, pcs: tuple) -> _Unit:
        apply_row = self.cp._apply_row

        def emit():
            for pc in pcs:
                apply_row(self, pc)

        if not self.graphs:
            return _Unit(emit, (0,) * len(_STEP_WRAPPERS))
        emit()                  # warm-up: lazy module loads, before capture
        g = torch.cuda.CUDAGraph()
        self._issued = [0] * len(_STEP_WRAPPERS)
        g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        try:
            emit()
        finally:
            g.capture_end()
        launches = tuple(self._issued)
        _add_step_launches(tuple(-n for n in launches))
        return _Unit(g.replay, launches)

    # --------------------------------------------------------------- run
    def run(self, shared: torch.Tensor, tdx: torch.Tensor,
            sources) -> list:
        """One run from a fresh state, returning a fresh copy of each of
        ``sources`` (the plan's buffers, or views of them) as the run
        left it.  ``shared`` ``(B, S)`` int32 and ``tdx`` ``(B,)`` int32
        are copied into the static buffers (never consumed), then every
        unit runs in order.  The plan is held from the copy-in to the
        copies out.  On the card all of it goes to the caller's current
        stream, which first waits for the plan's previous run (an event
        recorded at its end, on whatever stream it ran), so two threads
        with different current streams never interleave on the buffers.
        (A stream of the plan's own, which the caller's stream waited on,
        replayed the graphs about a tenth slower on the H100.)"""
        with self.lock:
            if self.graphs:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(self.done)
            self._run(shared, tdx)
            outs = [t.clone() for t in sources]
            if self.graphs:
                self.done.record(stream)
        return outs

    def _run(self, shared: torch.Tensor, tdx: torch.Tensor) -> None:
        S = self.cp.cfg.shared_words
        self.regs.zero_()
        self.pstack.zero_()
        self.pdepth.zero_()
        self.pred.fill_(True)
        self.shared[:, :S].copy_(shared)
        self.tdx.copy_(tdx.reshape(self.batch, 1))
        for u in self.order:
            u.run()
        if self.graphs:
            _add_step_launches(self.launches)


# ---------------------------------------------------------------------------
# The compiler
# ---------------------------------------------------------------------------

class CompiledProgram:
    """One program, compiled for one (config, thread-count) pair.

    ``run()`` executes a single core; ``run_batch()`` executes N cores in
    lock-step over batched data (same blocks, different data).  Fresh
    states only: the static path (and the baked hazard results) assume
    execution starts at PC 0 with empty stacks and zeroed registers,
    exactly like :func:`init_state`.  The run methods take a ``device``
    (the card unless ``"cpu"``); a plan of static buffers and graphs is
    made once per (device, batch width).

    ``mode`` selects the tier: ``"auto"`` (default) asks the
    :class:`TierPolicy` cost model to pick the cheaper tier for this
    path at this batch width (``batch_hint``); ``"superblock"`` requires
    the superblock runner (raising :class:`BlockCompileError` when the
    folded path is over the trace budget); ``"blocks"`` forces the
    basic-block driver.  The tier actually chosen is exposed as
    ``self.mode`` (the policy's inputs as ``self.tier_features``), and
    ``self.switch_dispatches`` counts the block dispatches the program
    pays on this tier (0 on the superblock tier).
    """

    def __init__(self, image: ProgramImage, threads: int, *,
                 validate: bool = True, mode: str = "auto",
                 policy: TierPolicy | None = None, batch_hint: int = 1):
        cfg = image.cfg
        if mode not in ("auto", "superblock", "blocks"):
            raise ValueError(f"unknown compile mode {mode!r}")
        if threads < 1 or threads > cfg.max_threads \
                or threads % cfg.num_sps:
            raise ValueError(
                f"runtime threads {threads} invalid for max "
                f"{cfg.max_threads}")
        self.cfg = cfg
        self.image = image
        self.threads = threads
        self.validate = validate
        self.packed, self.prog_len = pad_image(image)
        self.n = image.n
        self.blocks = _decompose(self.packed, self.n)
        self.sim = _simulate(
            cfg, self.packed, self.prog_len, threads, validate,
            block_starts=frozenset(s for s, _ in self.blocks),
            n_real=self.n)
        # NOT gated on cfg.has_predicates: the interpreter emulates a
        # one-level stack even for predicate-less configs (D clamps to 1)
        self.has_preds = any(
            int(o) in isa.PRED_WRITE_OPS for o in image.op)
        # pc -> block index; the padded STOP tail shares one dynamic block
        p2b = np.full((self.prog_len,), len(self.blocks), np.int32)
        for bi, (s, e) in enumerate(self.blocks):
            p2b[s:e] = bi
        self._pc2block = p2b
        self._tables = tables_np(cfg)
        self._rows = self.packed.tolist()
        self._masks = np.stack([_tsc_static(cfg, c, threads)[1]
                                for c in range(16)])
        R = cfg.regs_per_thread
        krows = self.packed.astype(np.int64)
        for col in (_PF_RA, _PF_RB):
            krows[:, col] = [_gidx(int(v), R) for v in krows[:, col]]
        krows[:, _PF_RD] = np.clip(krows[:, _PF_RD], 0, R - 1)
        self._krows = krows
        self.schedule = self.sim.schedule
        self.policy = DEFAULT_TIER_POLICY if policy is None else policy
        self.batch_hint = batch_hint
        self.tier_features = self.policy.features(
            self.sim, cfg_facts=cfg_mod.summary(self.packed, self.n))
        eligible = self.tier_features["eligible"]
        if mode == "superblock" and not eligible:
            cap = self.policy.table["max_trace_cost"]
            cap = _MAX_TRACE if cap is None else cap
            cost = self.tier_features["trace_cost"]
            raise BlockCompileError(
                "program is not superblock-eligible ("
                + ("the path did not fold to a schedule"
                   if cost is None else
                   f"trace cost {cost} exceeds the {cap}-instruction "
                   f"budget") + ")")
        if mode == "auto":
            self.mode = self.policy.choose(
                self.sim, batch=batch_hint, features=self.tier_features)
        else:
            self.mode = mode
        if self.mode == "superblock":
            self.switch_dispatches = 0
            self._seq = self._super_seq()
        else:
            self.switch_dispatches = self.sim.dispatches
            self._block_path, self._seq = self._walk_blocks()
        self._plans: dict = {}
        self._plans_lock = threading.Lock()
        self._counters = None            # EventCounters, built lazily

    # ---------------------------------------------------- event counters
    def event_counters(self):
        """This program's per-core :class:`~repro_torch.obs.EventCounters`,
        baked from the path simulation (exact, free at runtime).  The
        per-class retire/issue counts are bit-identical to the
        interpreter's ``stat_instrs`` / ``stat_cycles``; the plan-shape
        counters (replayed vs unrolled repeats) describe the tier this
        compile actually runs."""
        if self._counters is None:
            from ..obs.counters import EventCounters
            sim = self.sim
            f = self.tier_features
            if self.mode == "superblock" and self.schedule is not None:
                rep_trips = _sched_rep_trips(self.schedule)
                rep_execd = _sched_rep_execd(self.schedule)
                fori_trips = sum(f["fori_trips"])
                plan = dict(
                    fori_reps=f["fori_reps"],
                    unrolled_reps=f["unrolled_reps"],
                    fori_trips=fori_trips,
                    unrolled_trips=rep_trips - fori_trips,
                    fori_instrs=f["fori_execd"],
                    unrolled_instrs=rep_execd - f["fori_execd"])
            else:
                plan = dict(fori_reps=0, unrolled_reps=0, fori_trips=0,
                            unrolled_trips=0, fori_instrs=0,
                            unrolled_instrs=0)
            nopc = int(isa.OpClass.NOPC)
            self._counters = EventCounters(
                instrs=int(sim.steps), cycles=int(sim.cycles),
                instrs_by_class=tuple(int(v) for v in sim.stat_instrs),
                cycles_by_class=tuple(int(v) for v in sim.stat_cycles),
                loop_backedges=int(sim.backedges),
                block_dispatches=int(self.switch_dispatches),
                hazard_nop_instrs=int(sim.stat_instrs[nopc]),
                hazard_nop_cycles=int(sim.stat_cycles[nopc]),
                hazard_violations=int(sim.violations),
                lane_steps_offered=int(sim.lane_offered),
                lane_steps_active=int(sim.lane_active), **plan)
        return self._counters

    # ----------------------------------------------------- shared data op
    def _apply_row(self, st: _Plan, pc: int) -> None:
        """One instruction's *data* semantics — registers, shared memory,
        predicate state — with every decoded field a Python constant,
        written in place on the static state ``st``.  Sequencer ops
        (JMP/JSR/RTS/LOOP/INIT/STOP/NOP) are data no-ops: their effects
        are walked (basic blocks) or baked (superblocks) on the host.
        FP and DOT/SUM rows are one step-kernel launch each; the
        predicate mask ``st.pred`` is recomputed in place after every
        predicate op.  Shared by both tiers so their semantics cannot
        drift."""
        cfg = self.cfg
        R, S = cfg.regs_per_thread, cfg.shared_words
        D = max(1, cfg.predicate_levels)
        (op, typ, rd, ra, rb, imm, tsc) = self._rows[pc]
        if op in _DATA_NOOPS:
            return
        if op in _FP_OPS:
            st.fp_step(pc)
            return
        if op in _EXT_OPS:
            st.ext_step(pc)
            return
        tsc_mask = st.masks[:, tsc]
        mask = tsc_mask & st.pred if self.has_preds else tsc_mask
        regs = st.regs
        ra_r, rb_r, rd_r = _gidx(ra, R), _gidx(rb, R), _gidx(rd, R)
        env = semantics.OpEnv(
            cfg=cfg, rav=regs[:, :, ra_r], rbv=regs[:, :, rb_r],
            rdv=regs[:, :, rd_r], signed=typ == Typ.I32, imm=imm,
            mask=mask, tid=st.tid, shared=st.shared, tdx_dim=st.tdx)
        o = Op(op)
        if o in isa.IF_OPS:
            cond = semantics.build_spec(env)[op][1]()
            ps, pd = semantics.pred_push(st.pstack, st.pdepth, cond,
                                         tsc_mask, D)
            st.pstack.copy_(ps)
            st.pdepth.copy_(pd)
        elif o == Op.ELSE:
            st.pstack.copy_(semantics.pred_else(st.pstack, st.pdepth,
                                                tsc_mask, D))
        elif o == Op.ENDIF:
            st.pdepth.copy_(semantics.pred_pop(st.pdepth, tsc_mask))
        elif o == Op.STO:
            addr = env.addr
            sto_ok = mask & (addr >= 0) & (addr < S)
            semantics.store(st.shared, torch.where(sto_ok, addr, S),
                            env.rdv)
            return
        elif self._tables[op, _TC_WRITES_RD]:
            value = semantics.build_spec(env)[op][0]()
            rd_w = min(max(rd, 0), R - 1)
            regs[:, :, rd_w] = torch.where(mask, value, regs[:, :, rd_w])
            return
        else:
            return
        st.pred.copy_(semantics.pred_ok(st.pstack, st.pdepth, D))

    def _row_work(self, pcs) -> tuple:
        """The rows of ``pcs`` that do device work, in order."""
        return tuple(pc for pc in pcs if self._rows[pc][_PF_OP]
                     not in _DATA_NOOPS)

    # ------------------------------------------------------------- blocks
    def _walk_blocks(self):
        """The blocks tier's host driver: the data-independent leaves
        (the reference's ``_Seq``: PC, cycles, steps, stacks, stats)
        walked on the host by the interpreter's sequencer, and the
        dispatch order that path gives: the block index of every
        executed block start (the padded STOP tail is ``len(blocks)``),
        as ``_simulate`` counts dispatches."""
        core = HostCore.from_leaves(
            machine_mod.init_numpy(self.cfg, threads=self.threads))
        pcs = sequence(self.packed, self.prog_len, self.cfg, core,
                       self.validate)
        starts = np.zeros((self.prog_len,), np.bool_)
        starts[[s for s, _ in self.blocks]] = True
        starts[self.n:] = True
        leaves = core.leaves()
        return (self._pc2block[pcs[starts[pcs]]].tolist(),
                {k: leaves[k] for k in _SEQ_LEAVES})

    # --------------------------------------------------------- superblock
    def _segments(self, items) -> list:
        """A schedule as the superblock runner replays it: ``("line",
        pcs)`` straight lines (small repeats, at most ``_UNROLL_FULL``
        executed instructions, inlined ``count`` times) and ``("rep",
        segments, count)`` for a larger repeat, whose body is replayed
        ``count`` times (the unroll policy ``_plan_stats`` mirrors)."""
        out, line = [], []
        for it in items:
            if isinstance(it, (int, np.integer)):
                line.append(int(it))
                continue
            _, body, count = it
            if count * _sched_execd(body) <= _UNROLL_FULL:
                line.extend(_flatten(body) * count)
                continue
            if line:
                out.append(("line", tuple(line)))
                line = []
            out.append(("rep", self._segments(body), count))
        if line:
            out.append(("line", tuple(line)))
        return out

    def _super_seq(self) -> dict:
        """The superblock tier's data-independent leaves, baked from the
        simulation as in the reference's ``_build_super_runner``."""
        sim = self.sim
        zeros = np.zeros((isa.NUM_OP_CLASSES,), np.int32)
        return dict(pc=np.int32(sim.pc), cycles=np.int32(sim.cycles),
                    steps=np.int32(sim.steps), halted=np.asarray(sim.halted),
                    lctr=sim.lctr, lsp=np.int32(sim.lsp), cstack=sim.cstack,
                    csp=np.int32(sim.csp),
                    stat_cycles=sim.stat_cycles if self.validate else zeros,
                    stat_instrs=sim.stat_instrs if self.validate else zeros)

    def _unit_order(self) -> list:
        """The units a run replays, in order: one key (the rows with
        device work) for each block dispatch or each straight line of
        the superblock's segments, repeats expanded; units with no
        device work are left out."""
        if self.mode == "superblock":
            keys = []

            def expand(segs):
                for seg in segs:
                    if seg[0] == "line":
                        keys.append(self._row_work(seg[1]))
                    else:
                        for _ in range(seg[2]):
                            expand(seg[1])

            expand(self._segments(self.schedule))
        else:
            nb = len(self.blocks)
            work = [self._row_work(range(s, e)) for s, e in self.blocks]
            keys = [work[bi] for bi in self._block_path if bi < nb]
        return [k for k in keys if k]

    # --------------------------------------------------------------- plans
    def _plan(self, device, batch: int) -> _Plan:
        """The plan at ``(device, batch)``, made under a lock: two
        threads asking at once get one plan, captured once."""
        key = (device, batch)
        plan = self._plans.get(key)
        if plan is None:
            with self._plans_lock:
                plan = self._plans.get(key)
                if plan is None:
                    with obs_trace.span("compile", kind="cuda_graphs"
                                        if device.type == "cuda"
                                        else "eager",
                                        tier=self.mode, batch=batch):
                        plan = self._plans[key] = _Plan(self, device,
                                                        batch)
        return plan

    def graph_stats(self, device="cuda", batch: int = 1) -> dict:
        """What a run at ``(device, batch)`` replays: ``replays`` (units
        a run), ``graphs`` (distinct units captured), ``capture_s`` (the
        warm-ups and captures, host seconds) and ``launches`` (step
        launches a run, by kernel); None before the plan exists."""
        plan = self._plans.get((_norm_device(device), batch))
        if plan is None:
            return None
        return {"replays": len(plan.order), "graphs": len(plan._units),
                "capture_s": plan.capture_s,
                "launches": dict(zip(("wavefront_alu", "dot_product"),
                                     plan.launches))}

    def _inputs(self, shared, tdx_dim, device):
        """``(shared (B, S) int32, tdx (B,) int32, device, batched)``:
        tensors decide the device unless ``device`` is given; anything
        else goes to ``device`` or, by default, the card."""
        S = self.cfg.shared_words
        if device is not None:
            dev = resolve_device(device)
        elif isinstance(shared, torch.Tensor):
            dev = shared.device
        else:
            dev = resolve_device("cuda")
        dev = _norm_device(dev)
        if isinstance(shared, torch.Tensor):
            if shared.dtype != torch.int32:
                raise TypeError("a shared tensor must hold int32 words")
            sh = shared
        else:
            sh = torch.from_numpy(np.ascontiguousarray(
                np.asarray(shared, np.uint32)).view(np.int32))
        batched = sh.dim() == 2
        if sh.shape[-1] != S or sh.dim() not in (1, 2):
            raise ValueError(f"shared must be (S,) or (B, S) with S = {S}")
        sh = sh.reshape(-1, S).to(dev)
        td = tdx_dim if isinstance(tdx_dim, torch.Tensor) \
            else torch.from_numpy(np.asarray(tdx_dim, np.int32))
        td = td.to(device=dev, dtype=torch.int32).reshape(-1)
        return sh, td.expand(sh.shape[0]), dev, batched

    def _host_leaves(self) -> dict:
        """The final state's data-independent leaves (one core's), from
        the host walk (blocks) or the simulation (superblock)."""
        return dict(self._seq, threads_active=np.int32(self.threads),
                    hazard=self.sim.hazard,
                    hazard_violations=np.int32(self.sim.violations))

    def _final(self, plan: _Plan, sh, td) -> MachineState:
        """Run the plan; the batched final state, every leaf a fresh
        tensor: the data leaves copied out of the static buffers, the
        data-independent ones out of the plan's uploaded copies."""
        data = dict(regs=plan.regs,
                    shared=plan.shared[:, :self.cfg.shared_words],
                    pstack=plan.pstack, pdepth=plan.pdepth,
                    **plan.host_leaves)
        out = plan.run(sh, td, list(data.values()))
        return MachineState(tdx_dim=td.clone(), **dict(zip(data, out)))

    def _pack(self, shared_inits: list) -> np.ndarray:
        S = self.cfg.shared_words
        shared = np.zeros((len(shared_inits), S), np.uint32)
        for i, s0 in enumerate(shared_inits):
            if s0 is None:
                continue
            buf = machine_mod.pack_shared_init(s0, S)
            shared[i, :buf.size] = buf
        return shared

    # ------------------------------------------------------------- public
    def run(self, *, shared_init=None, tdx_dim: int = 16,
            device="cuda") -> MachineState:
        """Execute one core; bit-identical to ``run_program``."""
        out = self.run_batch([shared_init], [tdx_dim], device=device)
        return MachineState(*(leaf[0] for leaf in out))

    def run_batch(self, shared_inits: list, tdx_dims,
                  device="cuda") -> MachineState:
        """Execute N same-program cores in lock-step over batched data;
        returns the batched final state (slice jobs out along axis 0)."""
        sh, td, dev, _ = self._inputs(self._pack(shared_inits), tdx_dims,
                                      device)
        with obs_trace.span("run_compiled", tier=self.mode,
                            batch=len(shared_inits)):
            out = self._final(self._plan(dev, sh.shape[0]), sh, td)
            sync(dev)
        return out

    # -------------------------------------------------------- light path
    def light_fn(self):
        """The light-path function ``(shared, tdx_dim) -> (shared,
        cycles, halted)`` for callers that wrap their own dispatch around
        it (the inputs decide the device)."""
        return lambda shared, tdx_dim: self.run_light_dev(shared, tdx_dim)

    def light_compile(self, shared, tdx_dim, device=None) -> float:
        """Make the plan for these inputs' batch width and device ahead
        of time: on the card, build the step kernels if this process has
        not yet, then warm up and capture every unit's graph; returns
        the host seconds that took (0.0 when the plan exists, and on the
        CPU, where the plan is eager)."""
        sh, _, dev, _ = self._inputs(shared, tdx_dim, device)
        if (dev, sh.shape[0]) in self._plans:
            return 0.0
        built = build.ensure(egpu_step.KERNELS) if dev.type == "cuda" \
            else 0.0
        return built + self._plan(dev, sh.shape[0]).capture_s

    def run_light_dev(self, shared, tdx_dim, device=None):
        """Raw light entry: ``(..., S)`` shared image (uint32 words as
        numpy, or an int32 tensor) and ``(...,)``/scalar TDX in, tensors
        ``(shared, cycles, halted)`` out on the run's device.  No host
        sync, and the inputs are copied into the plan's buffers, never
        consumed: the same input can be replayed across calls, which is
        what keeps the fleet's residency cache sound.  ``shared`` comes
        back as a fresh tensor."""
        sh, td, dev, batched = self._inputs(shared, tdx_dim, device)
        plan = self._plan(dev, sh.shape[0])
        (out,) = plan.run(sh, td, [plan.shared[:, :self.cfg.shared_words]])
        B = plan.batch
        cyc = torch.full((B,), int(self._seq["cycles"]), dtype=torch.int32,
                         device=dev)
        halted = torch.full((B,), bool(self._seq["halted"]),
                            dtype=torch.bool, device=dev)
        if batched:
            return out, cyc, halted
        return out[0], cyc[0], halted[0]

    def run_light(self, *, shared_init=None, tdx_dim: int = 16,
                  device="cuda"):
        """Execute one core, returning only ``(shared, cycles, halted)``
        — for callers that never read registers, stacks or stats.  The
        leaves are bit-identical to the same-named :meth:`run` leaves;
        the other 15 ``MachineState`` leaves are never assembled or
        transferred."""
        sh, cyc, halted = self.run_light_dev(
            self._pack([shared_init])[0], tdx_dim, resolve_device(device))
        sync(sh.device)
        return sh, int(cyc), bool(halted)

    def run_batch_light(self, shared_inits: list, tdx_dims, device="cuda"):
        """Batched light path: N same-program cores in lock-step,
        returning ``(shared (N, S), cycles (N,), halted (N,))`` only."""
        out = self.run_light_dev(self._pack(shared_inits), tdx_dims,
                                 resolve_device(device))
        sync(out[0].device)
        return out


def _flatten(items) -> list:
    """The pcs a schedule executes, in order (repeats expanded)."""
    out: list = []
    for it in items:
        if isinstance(it, (int, np.integer)):
            out.append(int(it))
        else:
            out.extend(_flatten(it[1]) * it[2])
    return out


# ---------------------------------------------------------------------------
# Compile cache + convenience drivers
# ---------------------------------------------------------------------------

_CACHE: dict = {}
_CACHE_MAX = 128
#: the compile cache is the process's: its pop, compile and reinsert
#: are one step, so two threads compile a program once
_CACHE_LOCK = threading.Lock()


def program_key(image: ProgramImage) -> bytes:
    """Content identity of a program (the bit-packed instruction words
    encode every field) — used by the compile cache and the fleet's
    same-program batch grouping."""
    return image.words.tobytes()


def normalize_threads(image: ProgramImage, threads: int | None) -> int:
    """``None`` means "the count the image was assembled for"; anything
    else must be an explicit valid count.  In particular ``threads=0``
    is rejected rather than silently mapped to the image default."""
    if threads is None:
        return image.threads_active
    threads = int(threads)
    if threads < 1:
        raise ValueError(
            f"invalid runtime thread count {threads}; pass threads=None "
            f"for the image default ({image.threads_active})")
    return threads


def compile_program(image: ProgramImage, threads: int | None = None, *,
                    validate: bool = True, mode: str = "auto",
                    policy: TierPolicy | None = None,
                    batch_hint: int = 1,
                    optimize: bool = False) -> CompiledProgram:
    """Compile ``image`` for a static runtime thread count (default: the
    count it was assembled for).  Compiles are cached on (config,
    program bytes, threads, validate, mode, policy, batch class) with
    LRU eviction — hits move to the back of the queue, so a hot program
    is never evicted to keep a cold (or negative-cached) one.
    Rejections are cached too, so a non-halting program pays its (up to
    ``max_steps``-long) host-side path walk once.  A compile is the
    host half only; each compiled program makes its device plans (and
    on the card its graphs) per (device, batch width) at first use.

    ``mode``: ``"auto"`` asks the :class:`TierPolicy` cost model
    (``policy``, default :data:`DEFAULT_TIER_POLICY`) to pick the
    cheaper tier for this path at ``batch_hint`` lock-step cores;
    ``"superblock"`` and ``"blocks"`` force a tier (the former raising
    :class:`BlockCompileError` when ineligible).

    Raises :class:`BlockCompileError` for programs whose static path does
    not halt within ``cfg.max_steps``.

    ``optimize=True`` first runs the verified pre-compile optimizer
    (:func:`repro_torch.analysis.optimizer.optimize_image`, itself
    cached): constant folding + dead-code elimination with hazard NOPs
    re-derived by the scheduler, bit-identical architectural end state
    guaranteed.  The optimized image then keys the compile cache as
    usual (distinct program bytes, distinct entry).
    """
    threads = normalize_threads(image, threads)
    if optimize:
        from ..analysis.optimizer import optimize_image_cached
        image = optimize_image_cached(image, threads).image
    pol = DEFAULT_TIER_POLICY if policy is None else policy
    hint = pol.batch_class(batch_hint) if mode == "auto" else 1
    key = (image.cfg, program_key(image), threads, validate, mode, pol,
           hint)
    with _CACHE_LOCK:
        hit = _CACHE.pop(key, None)      # pop + reinsert = move-to-end
        with obs_trace.span("compile", cache_hit=hit is not None,
                            mode=mode, threads=threads) as sp:
            if hit is None:
                while len(_CACHE) >= _CACHE_MAX:
                    _CACHE.pop(next(iter(_CACHE)))  # oldest first (LRU)
                try:
                    hit = CompiledProgram(image, threads, validate=validate,
                                          mode=mode, policy=pol,
                                          batch_hint=hint)
                except BlockCompileError as e:
                    hit = e              # negative-cache the rejection
            if sp.active:
                sp.set(program=hashlib.blake2b(
                           key[1], digest_size=4).hexdigest(),
                       tier=getattr(hit, "mode", "rejected"))
        _CACHE[key] = hit
    if isinstance(hit, BlockCompileError):
        raise hit
    return hit


def run_compiled(image: ProgramImage, *, threads: int | None = None,
                 tdx_dim: int = 16, shared_init=None, validate: bool = True,
                 fallback: bool = True, mode: str = "auto",
                 policy: TierPolicy | None = None,
                 device="cuda") -> MachineState:
    """Execute an assembled program through the block compiler.

    Drop-in for ``run_program(image, threads=..., tdx_dim=...,
    shared_init=..., device=...)`` — results are bit-identical.
    ``fallback=True`` routes programs the compiler rejects (non-halting
    static path, or over-budget traces under ``mode="superblock"``) to
    the interpreter on the same device, completing the superblock ->
    basic-block -> interpreter chain.
    """
    threads = normalize_threads(image, threads)
    try:
        cp = compile_program(image, threads, validate=validate, mode=mode,
                             policy=policy)
    except BlockCompileError:
        if not fallback:
            raise
        from .executor import run_program
        return run_program(image, validate=validate, threads=threads,
                           tdx_dim=tdx_dim, shared_init=shared_init,
                           device=device)
    return cp.run(shared_init=shared_init, tdx_dim=tdx_dim, device=device)
