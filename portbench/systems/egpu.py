"""The eGPU simulator (``repro_torch``) as a system under test.

A configuration file whose ``"system"`` is ``"egpu"`` holds the eGPU
knobs and the programs frozen as words (:mod:`portbench.programs`).
:func:`load` turns it into the reference's core and programs, each with
its path; :class:`Driver` is what the drivers of this system share (the
program's config and images, the plans' ``graph_stats``); :func:`judge`
decides ``correct`` after the window.

Every job due in the window is held to its program's path (steps,
cycles and the Fig. 6 counters, which the reference's sequencer gives
for any data) and must have come back; the jobs that
:func:`portbench.traffic.sweep_sample` or
:func:`portbench.traffic.service_sample` name are held word for word on
their final shared memory, which the reference
(:mod:`portbench.reference.egpu`) computes from the same initial shared
memory.  The number compared counts the jobs wrong in any of these
ways, and its limit is 0: the simulator is exact or it is another
machine.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from portbench import programs
from portbench.check import Ledger
from portbench.reference import egpu


@dataclasses.dataclass
class System:
    core: egpu.Core
    progs: list


def load(doc: dict, mix: dict) -> System:
    """The reference's core and the mix's programs of a configuration
    (``mix["programs"]``: a subset by name, or all)."""
    return System(*programs.load(doc, mix.get("programs")))


def record(ledger: Ledger, prog: int, res) -> None:
    """A result's path fields, kept small (the arrays of one compiled
    batch are one object)."""
    ledger.records.append((prog, int(res.steps), int(res.cycles),
                           res.stat_cycles, res.stat_instrs))


def counts_wrong(progs, records) -> int:
    """Results whose steps, cycles or counters are not their path's."""
    seen: dict = {}
    bad = 0
    for prog, steps, cycles, sc, si in records:
        path = progs[prog].path
        key = (prog, id(sc), id(si))
        ok = seen.get(key)
        if ok is None:
            ok = seen[key] = (np.array_equal(sc, path.stat_cycles)
                              and np.array_equal(si, path.stat_instrs))
        bad += not (ok and steps == path.steps and cycles == path.cycles)
    return bad


def reference_shared(core, prog, inits: list, precision="f32"):
    """The reference's final shared memory of jobs of one program."""
    full = np.zeros((len(inits), core.shared_words), np.uint32)
    for i, init in enumerate(inits):
        full[i, :init.size] = init
    return egpu.run(core, prog.path, prog.threads, prog.tdx_dim, full,
                    precision)


def jobs_wrong(core, progs, samples: list) -> int:
    """Sampled jobs whose final shared memory differs from the
    reference's by any word."""
    bad = 0
    for p in progs:
        mine = [s for s in samples if s.prog == p.index]
        if not mine:
            continue
        want = reference_shared(core, p, [s.init for s in mine])
        for s, w in zip(mine, want):
            bad += not np.array_equal(s.got, w)
    return bad


def judge(system: System, ledger: Ledger) -> dict:
    """``checks``: the one number compared, ``jobs_wrong``, the jobs of
    the window that are wrong in any way (a held job's shared memory,
    any job's path fields, a job that never came back or failed), with
    its limit; ``parts``: the same count by kind."""
    parts = {"shared": jobs_wrong(system.core, system.progs,
                                  ledger.samples),
             "path": counts_wrong(system.progs, ledger.records),
             "missing": ledger.missing, "failed": ledger.failed}
    return {"checks": {"jobs_wrong": [sum(parts.values()), 0]},
            "parts": dict(parts, held=len(ledger.samples))}


class Driver:
    """What the drivers of the eGPU share.  A driver makes everything a
    run needs in ``setup()`` (the fleet or service, the inputs, every
    plan's graphs by warm-up work of the cell's own shapes), then runs
    ``window(seconds)``, which returns the end-to-end numbers; alongside
    it fills ``ledger`` and, in a traced run, ``ctx``, which the
    per-layer readers read.  ``close()`` frees the program's state."""

    def __init__(self, run):
        from portbench.profiling import Slice
        self.run = run
        self.traffic = run.traffic
        self.core, self.progs = run.system.core, run.system.progs
        self.device = run.device
        self.ledger = Ledger()
        self.tracer = None
        if run.trace:
            from repro_torch.obs.trace import Tracer
            self.tracer = Tracer("portbench")
        # the device's profile exists only on the card; a traced run on
        # the CPU (the tests) reads the spans and counters alone
        self.slice = Slice(run.trace_dir, self.tracer) \
            if run.trace and run.device.type == "cuda" else None
        self.cfg = programs.port_config(run.config)
        self.images = [programs.port_image(self.cfg, p) for p in self.progs]
        self.ctx: dict = {}

    def graph_stats(self, batch: int) -> list:
        """Each program's ``graph_stats`` at ``batch`` lanes, from the
        compile cache that the scheduler filled."""
        from repro_torch.core.blockc import BlockCompileError, \
            compile_program, default_policy_for_device
        policy = default_policy_for_device(self.device)
        out = []
        for img, p in zip(self.images, self.progs):
            try:
                cp = compile_program(img, p.threads, policy=policy,
                                     batch_hint=batch)
            except BlockCompileError:
                out.append(None)
                continue
            out.append(cp.graph_stats(self.device, batch))
        return out

    def tally(self, prog: int, res) -> None:
        """A result of the window: its record and its tier."""
        record(self.ledger, prog, res)
        tiers = self.ctx.setdefault("tiers", {})
        tiers[res.tier] = tiers.get(res.tier, 0) + 1
