"""The reference and its control at a size a test run holds: the
reference's paths are the frozen suite's, the reference in float32 in
the program's place is correct, and in bfloat16 (the control) it is
not, on every seed."""
import json

import numpy as np
import pytest

from portbench import control, programs, spec
from portbench.reference import egpu

SMALL = {"lanes": 4, "lanes_per_drain": 2, "drains_per_program": 1,
         "sample_per_program": 2,
         "programs": ["reduction_32_dp", "transpose_32_dp", "fft_32_dp",
                      "matmul_32_dp"]}
DOT = {"lanes": 4, "lanes_per_drain": 2, "drains_per_program": 1,
       "programs": ["reduction_dot_32_dp", "matmul_dot_32_dp"]}


@pytest.mark.parametrize("name", ["egpu-dp", "egpu-dot"])
def test_paths_are_the_suites(name):
    doc = json.loads(spec.config_path(name).read_text())
    core, progs = programs.load(doc)     # raises on another step count
    for p, d in zip(progs, doc["programs"]):
        assert p.path.cycles == d["cycles"]
        assert p.path.stat_instrs.sum() == p.path.steps


@pytest.mark.parametrize("workload,mix", [("egpu-dp.sweep", SMALL),
                                          ("egpu-dot.sweep", DOT),
                                          ("egpu-dp.service", SMALL)])
def test_control_fails_and_reference_passes(workload, mix):
    seeds = [3, 2 ** 31 + 5]
    low = control.readings(workload, seeds, "cpu", drains=2, seconds=2.0,
                           mix=mix)
    assert not any(r["correct"] for r in low)
    assert all(r["checks"]["jobs_wrong"][0] > 0 for r in low)
    same = control.readings(workload, seeds[:1], "cpu", drains=2,
                            seconds=2.0, mix=mix, precision="f32")
    assert same[0]["correct"]


def test_bf16_rounding():
    x = np.array([0x3F800000, 0x3F808000, 0x3F818000, 0x7FC00001],
                 np.uint32)
    got = egpu._bf16(x)
    # ties go to even; a NaN stays a NaN
    assert got[:3].tolist() == [0x3F800000, 0x3F800000, 0x3F820000]
    assert (got[3] & 0x7F800000) == 0x7F800000 and got[3] & 0x7FFFFF
