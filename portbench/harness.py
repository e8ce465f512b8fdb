"""One run of one cell: set up, measure the window, read the per-layer
metrics of a traced run, check the results against the reference, and
print the result line.  Nothing here knows the system under test: the
cell's configuration names its system (``systems/<name>.py``: loading
and judging) and its traffic names its driver (``drivers/<kind>.py``).

    python3 portbench/run.py --workload egpu-dp.sweep --seed 7 \\
        --seconds 10 --trace 0

Standard output ends with one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, every number compared with its
limit; standard error ends with the same checks, one a line.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import pathlib
import sys
import time

from . import check, spec
from .profiling import breakdown

#: top-level modules that must not be loaded in a run: the JAX package
#: and JAX itself (names compared whole: ``repro_torch`` is the program)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_DIR = spec.HERE / "traces"


@dataclasses.dataclass
class Run:
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: object
    config: dict
    traffic: dict
    system: object           # what the system's ``load`` gave
    chips: int = 1
    trace_dir: pathlib.Path = TRACE_DIR


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", bench: dict | None = None,
             traffic: dict | None = None, t_start: float | None = None
             ) -> dict:
    """Run one cell and return its result object.  ``traffic`` replaces
    entries of the cell's mix (the tests run small cells on the CPU);
    ``t_start`` is when the process started, where set-up begins."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.cell(bench or spec.load(), workload)
    mix = dict(cell.traffic, **(traffic or {}))
    system = spec.system(cell.config["system"])
    dev = torch.device(device)
    run = Run(workload=workload, seed=seed, seconds=seconds, trace=trace,
              device=dev, config=cell.config, traffic=mix,
              system=system.load(cell.config, mix), chips=cell.chips)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    drv = spec.driver(mix["kind"]).Driver(run)
    drv.setup()
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    # what set-up made stays: the window's collections skip it
    gc.collect()
    gc.freeze()
    e2e = drv.window(seconds)
    if cuda:
        torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda
                   else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    metrics = {}
    extra = {}
    if trace:
        ctx = dict(drv.ctx, system=run.system, traffic=mix,
                   workload=workload,
                   spans=drv.tracer.events if drv.tracer else [])
        for m in cell.per_layer:
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        prof = drv.ctx.get("profile")
        if prof is not None:
            device_info.update(busy_s=prof["busy_s"],
                               window_s=prof["window_s"])
            extra["breakdown"] = breakdown(prof)
    else:
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}
    ledger = drv.ledger
    drv.close()
    del drv
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    judged = system.judge(run.system, ledger)
    checks = judged["checks"]
    out = {"correct": check.correct(checks), "attempted": ledger.attempted,
           "failed": ledger.missing + ledger.failed, "metrics": metrics,
           "device": device_info}
    out.update(extra)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    out["check_parts"] = judged["parts"]
    return out


def main(argv=None, t_start: float | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace), bench=bench, t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; the benchmark "
              f"measures the PyTorch port alone", file=sys.stderr)
        return 4
    parts = out.pop("check_parts")
    print("the check's parts: " + ", ".join(
        f"{k} {v}" for k, v in parts.items()), file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
