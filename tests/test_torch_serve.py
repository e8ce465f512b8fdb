"""The port's serving entry point against the JAX reference's, on the CPU.

``repro_torch.launch.serve.main`` runs granite-moe-3b-a800m's smoke
config with the serve's default flags (8 requests, prompt 16, 16 decode
steps, ``max_len`` 128) beside ``repro.launch.serve.main``.  Both take the
numpy weights of ``repro_torch.models.convert.numpy_params`` (the
reference's ``init_params`` is patched to return them as JAX arrays; the
port is given ``--init numpy``) and the same numpy prompt.  In float32
the greedy tokens must be identical.  In bfloat16 the port is fed the
reference's tokens and each step's logits are held to
``serve.TOLERANCE`` (99 % within ``atol 3e-2 + rtol 1/64``, all within
0.25; see ``tests/test_torch_models.py`` for why), with the greedy
tokens equal wherever the reference's top-2 margin exceeds ``3e-2``.

``src/repro_torch/models/reference_serve.json`` holds the reference's
tokens and every step's logits for both types; ``chip_smoke.py`` holds
the port's CUDA run against it on the card, where there is no JAX.
Regenerate it with ``PYTHONPATH=src python tests/test_torch_serve.py
--write``.
"""
import json
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.launch import serve as rserve  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.training.steps import make_serve_decode_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import convert  # noqa: E402

ARCH = "granite-moe-3b-a800m"
SEED = 0
FLAGS = dict(requests=8, prompt_len=16, max_new=16, max_len=128)
ARGV = ["--arch", ARCH, "--smoke", "--seed", str(SEED)]


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny tensors: one intra-op thread (restored after the test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(dtype):
    return rconfigs.get_smoke(ARCH).replace(dtype=getattr(jnp, dtype))


def _numpy_tree(dtype):
    tcfg = tconfigs.get_smoke(ARCH).replace(dtype=getattr(torch, dtype))
    return convert.numpy_params(tcfg, SEED)


def _reference_main(monkeypatch, dtype):
    """``repro.launch.serve.main`` on the numpy weights, in ``dtype``."""
    tree = jax.tree.map(jnp.asarray, _numpy_tree(dtype))
    cfg = _cfg(dtype)
    monkeypatch.setattr(rserve.api, "init_params", lambda key, c: tree)
    monkeypatch.setattr(rserve.configs, "get_smoke", lambda a: cfg)
    return np.asarray(rserve.main(ARGV))


def reference_run(dtype):
    """The reference serve's loop (``repro/launch/serve.py:43-70``) on the
    numpy weights, keeping every step's logits."""
    cfg = _cfg(dtype)
    params = jax.tree.map(jnp.asarray, _numpy_tree(dtype))
    rng = np.random.default_rng(SEED)
    b = FLAGS["requests"]
    prompt = jnp.asarray(rng.integers(0, cfg.vocab, (b, FLAGS["prompt_len"])))
    logits, cache, lengths = rapi.prefill(cfg, params, {"tokens": prompt},
                                          FLAGS["max_len"])
    decode = jax.jit(make_serve_decode_step(cfg), donate_argnums=(1,))
    stop_after = jnp.asarray(np.minimum(4 + np.arange(b), FLAGS["max_new"]),
                             jnp.int32)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    toks, lgs = [np.asarray(tok)], [np.asarray(logits, np.float32)]
    active = jnp.ones((b,), jnp.int32)
    for step in range(FLAGS["max_new"]):
        logits, cache, lengths = decode(params, cache, tok, lengths, active)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        lgs.append(np.asarray(logits, np.float32))
        active = (jnp.asarray(step + 1, jnp.int32) < stop_after).astype(
            jnp.int32)
    return np.stack(toks, 1), np.stack(lgs, 1)


def test_serve_main_equals_reference_float32(monkeypatch, capsys):
    exp = _reference_main(monkeypatch, "float32")
    got = tserve.main(ARGV + ["--device", "cpu", "--init", "numpy",
                              "--dtype", "float32"])
    assert np.array_equal(got, exp)
    out = capsys.readouterr().out
    assert "ms/step" in out and "useful tokens/s" in out


def test_serve_main_bf16_holds_against_reference(monkeypatch):
    exp_tokens = _reference_main(monkeypatch, "bfloat16")
    got = tserve.main(ARGV + ["--device", "cpu", "--init", "numpy"])
    assert got.shape == exp_tokens.shape
    tokens, logits = reference_run("bfloat16")
    assert np.array_equal(tokens, exp_tokens)
    cfg = tconfigs.get_smoke(ARCH)
    model = tserve.build_model(cfg, SEED, torch.device("cpu"), "numpy")
    prompt = torch.from_numpy(tserve.make_prompt(cfg, SEED, FLAGS["requests"],
                                                 FLAGS["prompt_len"]))
    r = tserve.generate(cfg, model, prompt, FLAGS["max_new"],
                        FLAGS["max_len"], force=tokens, keep_logits=True)
    assert tserve.tolerance_error(r["logits"], logits, "bfloat16") is None
    assert tserve.greedy_mismatches(r["logits"], logits, "bfloat16")[0] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_serve_file_is_current(dtype):
    """The committed file is the reference's run (tokens exact, logits to
    float32 rounding noise of a rerun)."""
    ref = json.loads(tserve.REFERENCE.read_text())
    assert ref["arch"] == ARCH and ref["seed"] == SEED
    assert {k: ref[k] for k in FLAGS} == FLAGS
    tokens, logits = reference_run(dtype)
    run = ref["runs"][dtype]
    assert np.array_equal(np.asarray(run["tokens"]), tokens), \
        "regenerate with --write"
    np.testing.assert_allclose(tserve.decode_array(run["logits"]), logits,
                               atol=1e-6)


def test_port_cpu_run_holds_against_reference_file():
    """The check ``chip_smoke.py`` makes on the card, here on the CPU."""
    out = tserve.hold_against_reference(torch.device("cpu"))
    assert set(out) == {"float32", "bfloat16"}
    assert out["float32"]["tokens_checked"] == out["float32"]["tokens"]


def test_serve_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tserve.main(ARGV)


def _write():
    runs = {}
    for dtype in ("float32", "bfloat16"):
        tokens, logits = reference_run(dtype)
        runs[dtype] = {"tokens": tokens.tolist(),
                       "logits": tserve.encode(logits)}
    doc = {"arch": ARCH, "seed": SEED, **FLAGS,
           "made_by": "tests/test_torch_serve.py --write (JAX reference, "
                      "repro.launch.serve's loop, numpy_params weights)",
           "runs": runs}
    tserve.REFERENCE.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {tserve.REFERENCE}")


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_serve.py "
                 "--write")
    _write()
