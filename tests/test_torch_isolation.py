"""The port stands alone: importing ``repro_torch`` and every submodule
loads neither ``jax`` nor anything of the JAX package ``repro`` and
starts no process group, and no source of the port (nor
``chip_smoke.py``, nor the port's examples ``examples/*_torch.py``)
imports them."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules():
    out = []
    for f in sorted(PORT.rglob("*.py")):
        rel = f.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_import_loads_no_jax_and_no_reference():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "print(len(sys.modules)); assert not bad, bad\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized(), 'a process group at import'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)|"
                        r"from\s+(jax|repro)(\.|\s)(?!_torch))", re.M)


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        list(PORT.rglob("*.py"))
                                        + [ROOT / "chip_smoke.py"]
                                        + list((ROOT / "examples")
                                               .glob("*_torch.py"))))
def test_source_has_no_forbidden_import(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(text), path


def test_chip_smoke_fails_without_a_card():
    """Without a CUDA device the smoke script exits non-zero and prints
    no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
