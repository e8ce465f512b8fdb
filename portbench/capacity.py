#!/usr/bin/env python3
"""The rate sweep that fixed an open-loop cell's rate: one service, set
up once, offered each rate for ``--seconds`` in turn, on the card.

For each rate it prints the requests, the p95 of their latency (from
when each was due), how late the generator ran, the queue (jobs not yet
dispatched) as requests arrived over the first half, at its largest and
at the window's end, and whether every request resolved.  A rate is
sustained where every request resolved and the queue at the window's
end holds no more than one cohort (``batch_size`` jobs): the backlog
does not grow past what one dispatch clears.  The cell's file holds
70 % of the highest such rate.

    python3 portbench/capacity.py --workload egpu-dp.service \\
        --rates 20 40 60 80 --seconds 10
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

from portbench import check, harness, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    cell = spec.cell(spec.load(), args.workload)
    system = spec.system(cell.config["system"])
    run = harness.Run(workload=args.workload, seed=args.seed,
                      seconds=args.seconds, trace=False,
                      device=torch.device(args.device), config=cell.config,
                      traffic=cell.traffic,
                      system=system.load(cell.config, cell.traffic))
    drv = spec.driver(cell.traffic["kind"]).Driver(run)
    drv.setup()
    for rate in args.rates:
        drv.plan(rate, args.seconds)
        drv.ledger = check.Ledger()
        drv.ctx = {}
        p95 = drv.window(args.seconds)["request_p95_ms"]
        queued, end = drv.ctx["queued"]
        lat = [r for r in drv.resolved if r is not None]
        first = float(np.mean(queued[: max(1, len(queued) // 2)]))
        row = {"rate_per_s": rate, "requests": len(drv.due),
               "resolved": len(lat), "failed": drv.ledger.failed,
               "p95_ms": p95, "late_p95_ms": drv.ctx["late_p95_ms"],
               "queue_first_half": first, "queue_max": int(queued.max()),
               "queue_end": end,
               "sustained": (drv.ledger.missing == 0
                             and drv.ledger.failed == 0
                             and end <= cell.traffic["batch_size"]),
               "lane_jobs": drv.ctx["lane_jobs"]}
        print(json.dumps(row), flush=True)
    drv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
