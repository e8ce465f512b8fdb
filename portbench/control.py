#!/usr/bin/env python3
"""The control of ``correct``: the reference in the program's place, in
the precision below the one the configuration states.

For each seed it makes the jobs a run of the cell holds word for word,
with the same inputs and the same choice (a sweep of ``--drains``
drains; the service's schedule), computes their final shared memory
with the reference in bfloat16 (:class:`portbench.reference.egpu.Float`)
and judges that by the run's own comparison
(:func:`portbench.systems.egpu.judge`).  Every seed has to come out not
correct; each line gives the seed's numbers.

    python3 portbench/control.py --workload egpu-dp.sweep --seeds 1 2 3

The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

if __package__ in (None, ""):
    _root = pathlib.Path(__file__).resolve().parents[1]
    sys.path[:] = [str(_root), str(_root / "src")] + [
        p for p in sys.path
        if pathlib.Path(p or ".").resolve() != _root / "portbench"]
    __package__ = "portbench"

from portbench import check, programs, spec, traffic  # noqa: E402
from portbench.systems import egpu  # noqa: E402


def sampled(cell, seed: int, device, drains: int, seconds: float,
            mix: dict | None = None):
    """``(system, samples)``: the jobs a run of ``cell`` holds word for
    word (a sweep of ``drains`` drains, or the service's schedule over
    ``seconds``), each as ``Sample(prog, init, got=None)``, chosen by
    the drivers' own :func:`traffic.sweep_sample` and
    :func:`traffic.service_sample`."""
    mix = dict(cell.traffic, **(mix or {}))
    system = egpu.load(cell.config, mix)
    progs = system.progs
    inputs = programs.Inputs(device, seed, traffic.WINDOW)
    out = []
    if mix["kind"] == "egpu_sweep":
        lanes = mix["lanes"]
        want = {p.index: traffic.sweep_sample(mix, seed, p.index, p.steps,
                                              lanes, drains)
                for p in progs}
        bufs = [None] * len(progs)
        for d in range(drains):
            for p in progs:
                bufs[p.index] = inputs.draw(p, lanes, bufs[p.index])
                out += [check.Sample(p.index, bufs[p.index][x].copy(), None)
                        for x in want[p.index].get(d, ())]
    else:
        due, prog_of = traffic.open_loop_schedule(
            seed, mix["rate_per_s"], seconds, len(progs))
        keep = traffic.service_sample(mix, seed, prog_of,
                                      [p.steps for p in progs])
        for p in progs:
            idx = np.nonzero(prog_of == p.index)[0]
            if idx.size:
                rows = inputs.draw(p, idx.size)
                out += [check.Sample(p.index, r.copy(), None)
                        for i, r in zip(idx.tolist(), rows) if i in keep]
    return system, out


def readings(workload: str, seeds, device="cpu", drains: int = 4,
             seconds: float = 10.0, mix: dict | None = None,
             precision: str = "bf16") -> list:
    """Each seed's checks with the reference at ``precision`` in the
    program's place."""
    cell = spec.cell(spec.load(), workload)
    out = []
    for seed in seeds:
        system, samples = sampled(cell, seed, device, drains, seconds, mix)
        for p in system.progs:
            mine = [s for s in samples if s.prog == p.index]
            if mine:
                got = egpu.reference_shared(system.core, p,
                                            [s.init for s in mine],
                                            precision)
                for s, g in zip(mine, got):
                    s.got = g
        ledger = check.Ledger()
        ledger.samples = samples
        judged = egpu.judge(system, ledger)
        out.append({"seed": seed, "sampled": len(samples),
                    "correct": check.correct(judged["checks"]),
                    "checks": judged["checks"], "parts": judged["parts"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--drains", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--precision", default="bf16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = readings(args.workload, args.seeds, args.device, args.drains,
                    args.seconds, precision=args.precision)
    for r in rows:
        print(json.dumps(r), flush=True)
    return 0 if not any(r["correct"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
