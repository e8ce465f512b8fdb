"""The one traffic generator: it reads a mix's parameters
(``traffic/<name>.json``) and makes, from the run's seed, what a driver
sends: which job goes when, and which results the check holds word for
word.  The drivers and the control (``control.py``) both take the jobs
held from :func:`sweep_sample` and :func:`service_sample`, so the
control reads the jobs a run compares.

Two kinds of mix exist (``drivers/<kind>.py`` drives each):

* ``egpu_sweep``: a closed loop.  One client submits every program of the
  configuration over ``lanes`` fresh inputs each, drains, and repeats
  until the window ends.
* ``egpu_open_loop``: independent users.  Requests arrive as a Poisson
  process at ``rate_per_s`` through the window, each one job of a
  program drawn uniformly from the configuration's.  Every seed sends
  the same set of gaps and the same count of each program, in its own
  order, so the seed changes the order of the work and not its size.
"""
from __future__ import annotations

import numpy as np

from .programs import stream_seed

#: the streams of a run's seed, one for each thing drawn from it
WARMUP, WINDOW, SAMPLE, ORDER = 1, 2, 3, 4


def rng(seed: int, stream: int, *more: int) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream, *more))


def open_loop_schedule(seed: int, rate: float, seconds: float,
                       n_programs: int) -> tuple[np.ndarray, np.ndarray]:
    """``(due_s, program)`` of every request due in ``[0, seconds)``:
    ``round(rate * seconds)`` requests whose gaps are the exponential
    distribution's quantiles at ``(k + 1/2) / n``, shuffled; programs
    dealt in equal counts (the remainder by the seed), shuffled."""
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    r = rng(seed, ORDER)
    gaps = r.permutation(gaps)
    due = np.cumsum(gaps) - gaps[0]
    due *= seconds / (due[-1] + gaps.mean())     # the last falls inside
    progs = np.arange(n) % n_programs
    extra = r.permutation(n_programs)[: n % n_programs]
    progs[n - n % n_programs:] = extra
    return due, r.permutation(progs)


def pick(seed: int, keys: list, k: int, must=(), *stream: int) -> list:
    """``k`` of ``keys`` drawn from the seed, always with ``must``."""
    must = [x for x in must if x in keys]
    rest = [x for x in keys if x not in must]
    order = rng(seed, SAMPLE, len(keys), *stream).permutation(len(rest))
    return must + [rest[i] for i in order[: max(0, k - len(must))]]


def whole(mix: dict, steps: int) -> bool:
    """Whether every job of a program is held (where it is cheap for the
    reference: at most ``whole_max_steps`` steps) rather than a sample."""
    return steps <= mix["whole_max_steps"]


def drain_lanes(mix: dict, seed: int, drain: int, prog: int, lanes: int
                ) -> list[int]:
    """The lanes of one drain of a sweep that the check may hold: the
    first and the last lane of the batch and ``lanes_per_drain - 2``
    more drawn from the seed."""
    drawn = rng(seed, SAMPLE, drain, prog).choice(
        np.arange(1, lanes - 1), min(lanes - 2, mix["lanes_per_drain"] - 2),
        replace=False) if lanes > 2 else []
    return sorted({0, lanes - 1, *map(int, drawn)})


def sweep_sample(mix: dict, seed: int, prog: int, steps: int, lanes: int,
                 drains: int) -> dict[int, list[int]]:
    """``{drain: lanes}`` of one program that the check holds after a
    sweep of ``drains`` drains: every lane of the last drain where the
    program is cheap (:func:`whole`), and the :func:`drain_lanes` of
    ``drains_per_program`` drains drawn from the seed, the last among
    them."""
    last = drains - 1
    keep = pick(seed, list(range(drains)), mix["drains_per_program"],
                [last], prog)
    out = {d: drain_lanes(mix, seed, d, prog, lanes) for d in keep}
    if whole(mix, steps):
        out[last] = list(range(lanes))
    return out


def service_sample(mix: dict, seed: int, prog_of: np.ndarray,
                   steps: list[int]) -> set[int]:
    """The requests whose results the check holds: every request of a
    cheap program (:func:`whole`), and of each other program
    ``sample_per_program`` drawn from the seed, its last among them."""
    keep: set[int] = set()
    for p, n in enumerate(steps):
        idx = np.nonzero(prog_of == p)[0].tolist()
        keep |= set(idx if whole(mix, n) else
                    pick(seed, idx, mix["sample_per_program"], idx[-1:], p))
    return keep
