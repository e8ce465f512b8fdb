"""What every cell's ``correct`` shares: the ledger a driver fills in the
window, and the verdict over the numbers a system's ``judge`` compares.

A system's ``judge(system, ledger)`` (``systems/<name>.py``) runs after
the window has closed and returns ``{"checks": {name: [value, limit]},
"parts": {...}}``; a run is correct where every value is within its
limit.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Sample:
    """One job held word for word: its program, its input and what it
    came back with."""

    prog: int
    init: np.ndarray
    got: np.ndarray


class Ledger:
    """The counts of a window: each result's record (what the system's
    judge holds every job to), jobs that never came back, jobs that
    failed, and the sampled jobs."""

    def __init__(self):
        self.records: list = []
        self.missing = 0
        self.failed = 0
        self.samples: list[Sample] = []

    @property
    def attempted(self) -> int:
        return len(self.records) + self.missing + self.failed


def correct(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())
