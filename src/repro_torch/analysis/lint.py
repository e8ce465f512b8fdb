"""Admission lint CLI: ``python -m repro_torch.analysis.lint``
(a copy of the reference's framework-free ``repro.analysis.lint``).

Runs every static pass over the in-repo benchmark suite (or a selected
subset) and renders the structured diagnostics.  Exit status is the
admission contract, so CI can gate on it:

* ``2`` — at least one ERROR-level finding (fleet admission would
  reject the program),
* ``1`` — WARN-level findings only,
* ``0`` — clean at the requested threshold.

``--optimize`` additionally runs the verified optimizer over each
program and reports the transform counts (fold/DCE/NOP deltas); the
differential verifier runs too, so a miscompile fails loudly.
"""
from __future__ import annotations

import argparse
import json
import sys

from ..core.config import EGPUConfig
from ..programs import (build_bitonic, build_fft, build_matmul,
                        build_reduction, build_transpose)
from .diagnostics import Severity
from .passes import analyze


def _default_config() -> EGPUConfig:
    """The benchmark instance: full ALU, predicates, both extension
    units — every suite program assembles on it."""
    return EGPUConfig(max_threads=32, regs_per_thread=32, shared_kb=4,
                      alu_bits=32, shift_bits=32, predicate_levels=4,
                      has_dot=True, has_invsqr=True)


def suite(cfg: EGPUConfig | None = None):
    """The paper-suite benches the lint (and CI) walk, name -> Bench."""
    cfg = cfg or _default_config()
    return [build_reduction(cfg, 32),
            build_reduction(cfg, 32, use_dot=True),
            build_reduction(cfg, 32, no_dynamic=True),
            build_transpose(cfg, 16), build_matmul(cfg, 8),
            build_bitonic(cfg, 16), build_bitonic(cfg, 32),
            build_fft(cfg, 16), build_fft(cfg, 32)]


_SEV = {"info": Severity.INFO, "warn": Severity.WARN,
        "error": Severity.ERROR}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="statically verify the in-repo benchmark suite")
    ap.add_argument("--bench", action="append", default=None,
                    help="lint only benches whose name contains this "
                         "substring (repeatable)")
    ap.add_argument("--min-severity", choices=_SEV, default="info",
                    help="hide findings below this level (default info)")
    ap.add_argument("--fail-on", choices=("error", "warn"), default="warn",
                    help="exit non-zero at this level (default warn)")
    ap.add_argument("--optimize", action="store_true",
                    help="also run the verified optimizer on each bench")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--tdx-dim", type=int, default=None,
                    help="override the TDX grid width (default: each "
                         "bench's own)")
    args = ap.parse_args(argv)

    benches = suite()
    if args.bench:
        benches = [b for b in benches
                   if any(s in b.name for s in args.bench)]
        if not benches:
            print(f"no bench matches {args.bench}", file=sys.stderr)
            return 2

    worst = None
    out = []
    for b in benches:
        tdx = args.tdx_dim if args.tdx_dim is not None else b.tdx_dim
        report = analyze(b.image, tdx_dim=tdx)
        sev = report.max_severity
        if sev is not None and (worst is None or sev > worst):
            worst = sev
        entry = {
            "bench": b.name,
            "instructions": int(b.image.n),
            "counts": report.counts(),
            "static_steps": report.facts.get("static_steps"),
            "proved_accesses": list(report.facts.get("proved_accesses",
                                                     ())),
            "diagnostics": [
                {"severity": d.severity.name, "code": d.code,
                 "pc": d.pc, "message": d.message,
                 "path": list(d.path)}
                for d in report.diagnostics
                if d.severity >= _SEV[args.min_severity]],
        }
        if args.optimize:
            from .optimizer import optimize_image
            r = optimize_image(b.image, tdx_dim=tdx)
            entry["optimizer"] = {
                "changed": r.changed, "rounds": r.rounds,
                "folds": r.folds, "dce_removed": r.dce_removed,
                "instrs": [r.instrs_before, r.instrs_after],
                "nops": [r.nops_before, r.nops_after],
                "reason": r.reason,
            }
        out.append(entry)
        if not args.as_json:
            c = entry["counts"]
            line = (f"== {b.name}: {entry['instructions']} instr, "
                    f"{c['errors']}E/{c['warnings']}W/{c['infos']}I")
            if entry["static_steps"] is not None:
                line += f", static_steps={entry['static_steps']}"
            print(line)
            rendered = report.render(min_severity=_SEV[args.min_severity])
            for ln in rendered.splitlines()[:-1]:
                print("   " + ln)
            if args.optimize:
                o = entry["optimizer"]
                print(f"   optimizer: changed={o['changed']} "
                      f"folds={o['folds']} dce={o['dce_removed']} "
                      f"instrs {o['instrs'][0]}->{o['instrs'][1]} "
                      f"nops {o['nops'][0]}->{o['nops'][1]}"
                      + (f" ({o['reason']})" if o["reason"] else ""))

    if args.as_json:
        print(json.dumps(out, indent=2))
    if worst == Severity.ERROR:
        return 2
    if worst == Severity.WARN and args.fail_on == "warn":
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
