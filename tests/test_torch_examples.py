"""The port's examples run on the CPU at their smallest size
(``--device cpu``): ``examples/quickstart_torch.py`` (an eGPU program
held against numpy, then one LM training step),
``examples/train_lm_torch.py`` (a few steps with checkpoints),
``examples/serve_lm_torch.py`` (qwen3-moe's smoke serve),
``examples/egpu_benchmarks_torch.py`` (the paper's five benchmarks and
the dynamic-scaling ablation, each against its numpy oracle) and
``examples/fleet_throughput_torch.py`` (16 jobs through a ``Fleet``,
spot-checked against ``run_program``)."""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_torch_on_cpu(capsys):
    st = _load("quickstart_torch").main(["--device", "cpu"])
    assert int(st.hazard_violations) == 0
    out = capsys.readouterr().out
    assert "correct." in out and "LM step" in out


def test_train_lm_torch_on_cpu():
    losses = _load("train_lm_torch").main(["--steps", "3", "--device", "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_serve_lm_torch_on_cpu(capsys):
    toks = _load("serve_lm_torch").main(["--device", "cpu"])
    assert toks.shape == (8, 25) and ((toks >= 0) & (toks < 256)).all()
    out = capsys.readouterr().out
    assert "prefill: 8 x 16" in out and "useful tokens/s" in out


def test_egpu_benchmarks_torch_on_cpu(capsys):
    out = _load("egpu_benchmarks_torch").main(["--device", "cpu"])
    assert all(r.correct and r.hazard_violations == 0 for r in out.values())
    assert out["dynamic"].cycles < out["predicated"].cycles
    assert "x win (cpu)" in capsys.readouterr().out


def test_fleet_throughput_torch_on_cpu(capsys):
    results = _load("fleet_throughput_torch").main(["--device", "cpu",
                                                    "--jobs", "16"])
    assert len(results) == 16
    assert all(r.hazard_violations == 0 for r in results.values())
    out = capsys.readouterr().out
    assert "16 jobs over 8 distinct programs" in out and "speedup" in out


def test_examples_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in ("quickstart_torch", "train_lm_torch", "serve_lm_torch",
                 "egpu_benchmarks_torch", "fleet_throughput_torch"):
        with pytest.raises(RuntimeError, match="--device cpu"):
            _load(name).main([])
