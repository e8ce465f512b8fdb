"""Per-core event counters — the soft GPU's hardware-counter analogue
(a copy of the reference's framework-free ``repro.obs.counters``).

A hard GPU samples event counters at runtime; this soft GPU's executed
path is fully static, so every counter is **baked host-side** from the
block compiler's path simulation (``repro_torch.core.blockc._simulate``) and
its superblock plan — exact, not sampled, and free at runtime.  The
per-opcode-class retire/issue counts are bit-identical to the
interpreter's ``stat_instrs`` / ``stat_cycles`` machine-state leaves
(the equivalence suites pin this), so a counter reader never needs to
know which tier actually ran the job.

Counter definitions (see the README table):

=======================  ==================================================
``instrs``               instructions retired on the executed path
``cycles``               issue cycles (the paper's per-kernel cycle count)
``instrs_by_class``      retires per :class:`~repro_torch.core.isa.OpClass`
``cycles_by_class``      issue cycles per opcode class
``loop_backedges``       taken LOOP back-edges
``block_dispatches``     block-driver dispatches (one graph replay each
                         on the card) paid on the tier that ran (0 on
                         superblock)
``fori_reps``            repeat nodes run as a body replayed ``count``
                         times
``unrolled_reps``        repeat nodes inlined into the straight line
``fori_trips``           summed trip counts of the fori repeats
``unrolled_trips``       summed trip counts of the inlined repeats
``fori_instrs``          instructions executed inside fori repeats
``unrolled_instrs``      instructions executed inside inlined repeats
``hazard_nop_instrs``    scheduler NOP padding retired (hazard stalls)
``hazard_nop_cycles``    issue cycles lost to that padding
``hazard_violations``    hazard-checker violations on the path
``lane_steps_offered``   vector retires x runtime thread count
``lane_steps_active``    of which lanes the TSC mask left on
=======================  ==================================================

``lane_steps_offered - lane_steps_active`` is the predicated-off
lane-step count — the thread-space-subsetting utilization story the
paper tells, as a counter.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

from ..core.isa import NUM_OP_CLASSES, OpClass

__all__ = ["EventCounters", "aggregate"]


@dataclasses.dataclass(frozen=True)
class EventCounters:
    """One core's (or one aggregate's) event-counter block."""

    instrs: int
    cycles: int
    instrs_by_class: tuple          # (NUM_OP_CLASSES,) of int
    cycles_by_class: tuple
    loop_backedges: int
    block_dispatches: int
    fori_reps: int
    unrolled_reps: int
    fori_trips: int
    unrolled_trips: int
    fori_instrs: int
    unrolled_instrs: int
    hazard_nop_instrs: int
    hazard_nop_cycles: int
    hazard_violations: int
    lane_steps_offered: int
    lane_steps_active: int

    @property
    def lane_steps_masked(self) -> int:
        """Lane-steps predicated off by TSC masks."""
        return self.lane_steps_offered - self.lane_steps_active

    @property
    def lane_utilization(self) -> float:
        """Active fraction of offered vector lane-steps (1.0 when the
        path retired no vector instructions)."""
        if not self.lane_steps_offered:
            return 1.0
        return self.lane_steps_active / self.lane_steps_offered

    def profile(self) -> dict[str, tuple[int, int]]:
        """``{class name: (cycles, instrs)}`` — the per-class mix in the
        same shape as the reference's
        ``repro.fleet.scheduler.JobResult.profile``."""
        return {c.name: (int(self.cycles_by_class[c]),
                         int(self.instrs_by_class[c]))
                for c in OpClass}

    def flat(self) -> dict[str, int]:
        """A flat ``{name: int}`` view (classes as ``instrs.<CLS>`` /
        ``cycles.<CLS>``) — the shape trace events and the tracer's
        running totals use, mergeable by plain addition."""
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, tuple):
                stem = f.name.split("_by_class")[0]
                for c in OpClass:
                    d[f"{stem}.{c.name}"] = int(v[c])
            else:
                d[f.name] = int(v)
        return d


def aggregate(counters: Iterable[EventCounters | None]) -> EventCounters | None:
    """Sum counter blocks field-wise (``None`` entries — jobs without
    counters — are skipped; all-``None`` aggregates to ``None``)."""
    cs = [c for c in counters if c is not None]
    if not cs:
        return None
    kw = {}
    for f in dataclasses.fields(EventCounters):
        vals = [getattr(c, f.name) for c in cs]
        if isinstance(vals[0], tuple):
            kw[f.name] = tuple(int(sum(col)) for col in zip(*vals))
        else:
            kw[f.name] = int(sum(vals))
    return EventCounters(**kw)
