"""Whole-program static analysis over the eGPU ISA control-flow graph
(a copy of the reference's framework-free ``repro.analysis``).

The ISA has no data-dependent branches — every JMP/JSR/LOOP target and
every INIT trip count is an immediate — so a program's control behaviour
is fully decidable at submit time.  This package exploits that:

* :func:`analyze` — CFG dataflow passes (reaching definitions per
  thread-space personality, stack balance for the predicate/loop/call
  stacks, interval-based shared-memory bounds, static trip-count and
  trace-budget prediction, dead/unreachable code), producing structured
  :class:`Diagnostic` objects with severities and path witnesses.
* :func:`optimize_image` — a verified pre-compile optimizer (constant
  folding + dead-code elimination over the CFG, hazard NOPs re-derived
  by the assembler's scheduler).
* ``python -m repro_torch.analysis.lint`` — renders diagnostics for one
  program or the whole in-repo suite.

Invariants the rest of the stack builds on (see
``docs/architecture.md``):

* **ERROR rejects pre-compile** — ``Fleet.submit`` /
  ``FleetService.submit`` run :func:`analyze_cached` and raise
  (:class:`ProgramVerificationError` / ``JobError(kind="rejected")``)
  before any compile, queue slot or device work is spent; WARN/INFO
  admit;
* **soundness over completeness** — the analyzer never calls a
  faulting program safe (swept against the NumPy reference executor
  in ``tests/test_analysis_soundness.py``); unprovable cases degrade
  to WARN/INFO, never to silence;
* **optimizer changes nothing observable** — every
  :func:`optimize_image` transform is differentially verified
  bit-identical in architectural end state across all three execution
  tiers, and bails (input returned unchanged) on programs that carry
  ERROR findings.
"""
from .diagnostics import (AnalysisReport, Diagnostic,  # noqa: F401
                          ProgramVerificationError, Severity)
from .passes import analyze, analyze_cached            # noqa: F401
from .optimizer import OptResult, optimize_image       # noqa: F401
from .concrete import ConcreteResult, concrete_run     # noqa: F401
