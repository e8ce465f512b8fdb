"""A run loads neither JAX nor the JAX package: a small cell is run on
the CPU in a fresh process and its modules' top-level names, compared
whole, are checked (``repro_torch`` starts with ``repro``)."""
import json
import subprocess
import sys

from portbench import harness, spec

SCRIPT = r"""
import json, sys
from portbench import harness
small = {"lanes": 2, "batch_size": 2, "lanes_per_drain": 2,
         "drains_per_program": 1,
         "programs": ["reduction_32_dp", "fft_32_dp"]}
out = harness.run_cell("egpu-dp.sweep", 11, 0.2, True, device="cpu",
                       traffic=small)
print(json.dumps({"correct": out["correct"],
                  "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_a_run_loads_no_jax():
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH":
           f"{spec.ROOT}:{spec.ROOT / 'src'}", "JAX_PLATFORMS": "cpu"}
    got = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=spec.ROOT)
    assert got.returncode == 0, got.stderr[-3000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert "repro_torch" in out["top"] and "portbench" in out["top"]
    assert not set(out["top"]) & set(harness.FORBIDDEN)


def test_the_cli_refuses_a_machine_without_enough_cards():
    got = subprocess.run(
        [sys.executable, str(spec.HERE / "run.py"), "--workload",
         "egpu-dp.sweep", "--seed", "1", "--seconds", "1", "--trace", "0"],
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=300, cwd=spec.ROOT)
    assert got.returncode != 0
    assert got.stdout.strip() == ""
    assert "CUDA" in got.stderr


def test_the_benchmark_alone_does_not_run(tmp_path):
    import shutil
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache",
                                                  "traces"))
    got = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "egpu-dp.sweep",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        env={"PATH": "/usr/bin:/bin"}, capture_output=True, text=True,
        timeout=300, cwd=tmp_path)
    assert got.returncode != 0 and got.stdout.strip() == ""
