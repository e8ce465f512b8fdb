"""Structured diagnostics produced by the static analyzer
(a copy of the reference's framework-free ``repro.analysis.diagnostics``).

Severity semantics (the admission contract):

* ``ERROR`` — the program is structurally broken: out-of-image branch
  target, undefined TSC width coding, stack underflow/overflow against
  the configured limits, a shared-memory access *proven* out of bounds
  on an unpredicated path, or a program that can never halt / must
  exceed ``max_steps``.  Fleet admission rejects these before compile.
* ``WARN`` — almost certainly a bug but with defined behaviour in this
  implementation: reads of registers never (or only partially) written
  — the register file is zero-initialised here but undefined in
  hardware — unreachable code, predicate ops on a predicate-less
  config, or a proven-OOB access that is predicate-gated.
* ``INFO`` — facts, not defects: bounds the interval analysis could not
  prove either way, dead register writes, unknown trip counts, and
  tier predictions (e.g. the trace budget says the superblock runner
  will fall back).

Every diagnostic carries the pc it anchors to and, where the dataflow
derived it, a *path witness*: the basic-block entry pcs of one CFG path
that reaches the offending instruction.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class Severity(enum.IntEnum):
    INFO = 0
    WARN = 1
    ERROR = 2


@dataclass(frozen=True)
class Diagnostic:
    """One analyzer finding, anchored to a pc."""

    severity: Severity
    code: str                 # stable kebab-case id, e.g. "oob-access"
    pc: int                   # -1 for whole-program findings
    message: str
    #: basic-block start pcs of one path from entry to ``pc`` (may be
    #: elided in the middle for very deep paths); () when structural
    path: tuple[int, ...] = ()

    def render(self) -> str:
        loc = f"pc {self.pc:4d}" if self.pc >= 0 else "program"
        s = f"{self.severity.name:5s} {loc} [{self.code}] {self.message}"
        if self.path:
            s += f"  (path: {' -> '.join(str(p) for p in self.path)})"
        return s


@dataclass
class AnalysisReport:
    """All diagnostics plus the facts the passes proved along the way."""

    diagnostics: list[Diagnostic] = field(default_factory=list)
    #: machine-readable facts: static_steps, loop_trips, proved/unproven
    #: access counts, distinct_reachable_instrs, max stack depths, ...
    facts: dict = field(default_factory=dict)

    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == Severity.ERROR]

    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == Severity.WARN]

    @property
    def ok(self) -> bool:
        """No ERROR-level findings (the admission gate)."""
        return not self.errors()

    @property
    def max_severity(self) -> Severity | None:
        return max((d.severity for d in self.diagnostics), default=None)

    def by_code(self, code: str) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def counts(self) -> dict[str, int]:
        return {"errors": len(self.errors()),
                "warnings": len(self.warnings()),
                "infos": len([d for d in self.diagnostics
                              if d.severity == Severity.INFO])}

    def render(self, *, min_severity: Severity = Severity.INFO) -> str:
        lines = [d.render() for d in
                 sorted(self.diagnostics,
                        key=lambda d: (-int(d.severity), d.pc))
                 if d.severity >= min_severity]
        c = self.counts()
        lines.append(f"{c['errors']} error(s), {c['warnings']} warning(s), "
                     f"{c['infos']} info(s)")
        return "\n".join(lines)


class ProgramVerificationError(ValueError):
    """Raised at admission for programs with ERROR-level diagnostics.

    Subclasses ``ValueError`` so existing fail-fast submit paths (which
    surface ``ValueError`` synchronously) keep working unchanged; the
    structured findings ride along as ``.diagnostics``.
    """

    def __init__(self, report: AnalysisReport):
        self.report = report
        self.diagnostics = report.errors()
        head = "; ".join(d.render() for d in self.diagnostics[:3])
        more = len(self.diagnostics) - 3
        if more > 0:
            head += f"; (+{more} more)"
        super().__init__(f"program rejected by static verifier: {head}")
