"""Shared benchmark plumbing (the port of ``repro.programs.common``)."""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from ..core import machine as machine_mod
from ..core.assembler import ProgramImage
from ..core.executor import run_program


@dataclasses.dataclass
class Bench:
    name: str
    image: ProgramImage
    shared_init: np.ndarray           # initial shared memory (uint32 view ok)
    oracle: Callable[[np.ndarray], np.ndarray]   # f(shared_init_f32/i32) -> expected
    result_view: Callable[[machine_mod.MachineState], np.ndarray]
    tdx_dim: int = 16
    atol: float = 1e-4
    rtol: float = 1e-4
    data_words: int = 0               # words moved over the bus (load+unload)


@dataclasses.dataclass
class BenchResult:
    name: str
    cycles: int
    time_us: float
    correct: bool
    hazard_violations: int
    steps: int
    profile: dict
    bus_cycles: int
    max_abs_err: float = 0.0


def check(b: Bench, st: machine_mod.MachineState) -> tuple[bool, float]:
    """``(correct, max_abs_err)`` of a final state against the bench's
    numpy oracle (float results within the bench's tolerance, integer
    results exactly)."""
    got = np.asarray(b.result_view(st))
    exp = np.asarray(b.oracle(b.shared_init))
    if got.dtype.kind == "f":
        correct = bool(np.allclose(got, exp, atol=b.atol, rtol=b.rtol))
        err = float(np.max(np.abs(got - exp))) if got.size else 0.0
    else:
        correct = bool(np.array_equal(got, exp))
        err = float(np.max(np.abs(got.astype(np.int64) - exp.astype(np.int64)))) if got.size else 0.0
    return correct, err


def run_bench(b: Bench, device="cuda") -> BenchResult:
    st = run_program(b.image, shared_init=b.shared_init,
                     tdx_dim=b.tdx_dim, device=device)
    correct, err = check(b, st)
    cfg = b.image.cfg
    cycles = int(st.cycles)
    return BenchResult(
        name=b.name, cycles=cycles, time_us=cfg.cycles_to_us(cycles),
        correct=correct, hazard_violations=int(st.hazard_violations),
        steps=int(st.steps), profile=machine_mod.profile(st),
        bus_cycles=b.data_words, max_abs_err=err)


def log2i(n: int) -> int:
    l = n.bit_length() - 1
    if 1 << l != n:
        raise ValueError(f"{n} is not a power of two")
    return l
