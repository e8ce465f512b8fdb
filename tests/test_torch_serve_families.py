"""The port's serve of zamba2, xlstm, seamless-m4t and internvl2 against
the JAX reference's serve loop, on the CPU.

For each architecture's smoke config, ``reference_run`` is the loop of
``repro/launch/serve.py`` (prefill, then greedy decode through the
jitted ``make_serve_decode_step`` with the ragged ``stop_after`` mask)
on the numpy weights of ``repro_torch.models.convert.numpy_params``,
with the prompt, then the frames (seamless) or the patches (internvl2)
drawn from one numpy generator in the reference's order.  Its tokens
and every step's logits, float32 and bfloat16, are committed in
``src/repro_torch/models/reference_serve_families.json``, which
``chip_smoke.py`` holds the port's CUDA run against on the card, where
there is no JAX.  Here: the file is the reference's run, the port's CPU
run holds against it (float32 logits within 2e-5 and every greedy token
equal; bfloat16 within ``serve.TOLERANCE``), and ``serve.main`` takes
each family.  4 requests (the ragged mask stops them after 4 to 7
tokens), prompt 16, 16 decode steps: each family's part of the file is
about the size of ``reference_serve.json``.  Regenerate it with
``PYTHONPATH=src python tests/test_torch_serve_families.py --write``.
"""
import json
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.training.steps import make_serve_decode_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import convert  # noqa: E402

ARCHS = ["zamba2-1p2b", "xlstm-350m", "seamless-m4t-large-v2",
         "internvl2-2b"]
DTYPES = ["float32", "bfloat16"]
SEED = 0
FLAGS = dict(requests=4, prompt_len=16, max_new=16, max_len=128)


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny tensors: one intra-op thread (restored after the test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_run(arch, dtype):
    """The reference serve's loop (``repro/launch/serve.py:38-70``) on the
    numpy weights, keeping every step's logits."""
    cfg = rconfigs.get_smoke(arch).replace(dtype=getattr(jnp, dtype))
    tcfg = tconfigs.get_smoke(arch).replace(dtype=getattr(torch, dtype))
    params = jax.tree.map(jnp.asarray, convert.numpy_params(tcfg, SEED))
    rng = np.random.default_rng(SEED)
    b, s = FLAGS["requests"], FLAGS["prompt_len"]
    batch = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab, (b, s)))}
    if cfg.family == "encdec":
        batch["frames"] = jnp.asarray(rng.standard_normal((b, s, cfg.d_model)),
                                      jnp.float32)
    if cfg.family == "vlm":
        batch["patches"] = jnp.asarray(
            rng.standard_normal((b, cfg.num_patches, 1024)), jnp.float32)
    logits, cache, lengths = rapi.prefill(cfg, params, batch,
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_reference_serve_families_file_is_current(arch, dtype):
    """The committed file is the reference's run (tokens exact, logits to
    float32 rounding noise of a rerun)."""
    ref = json.loads(tserve.REFERENCE_FAMILIES.read_text())
    assert ref["seed"] == SEED and {k: ref[k] for k in FLAGS} == FLAGS
    assert sorted(ref["archs"]) == sorted(ARCHS)
    tokens, logits = reference_run(arch, dtype)
    run = ref["archs"][arch][dtype]
    assert np.array_equal(np.asarray(run["tokens"]), tokens), \
        "regenerate with --write"
    np.testing.assert_allclose(tserve.decode_array(run["logits"]), logits,
                               atol=1e-6)


def test_port_cpu_run_holds_against_reference_families_file():
    """The check ``chip_smoke.py`` makes on the card, here on the CPU:
    float32 within 2e-5 with every greedy token checked and equal,
    bfloat16 within ``serve.TOLERANCE``."""
    out = tserve.hold_against_reference(torch.device("cpu"),
                                        tserve.REFERENCE_FAMILIES)
    assert sorted(out) == sorted(ARCHS)
    for arch, runs in out.items():
        assert set(runs) == set(DTYPES), arch
        f32 = runs["float32"]
        assert f32["max_abs_err"] <= 2e-5, arch
        # seamless's prefill logits are zeros (its decoder never reads
        # the prompt): a tie in every row, so those tokens are not
        # checked; every other token is
        exempt = FLAGS["requests"] if arch == "seamless-m4t-large-v2" else 0
        assert f32["tokens_checked"] == f32["tokens"] - exempt, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_each_family(arch, capsys):
    """``serve.main`` on the CPU with the family's inputs: greedy tokens
    in the vocabulary, and the timing lines."""
    got = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "2", "--prompt-len", "8",
                       "--max-new", "3", "--max-len", "32"])
    cfg = tconfigs.get_smoke(arch)
    assert got.shape == (2, 4) and ((got >= 0) & (got < cfg.vocab)).all()
    out = capsys.readouterr().out
    assert "ms/step" in out and "useful tokens/s" in out


def test_make_batch_draws_in_the_reference_order():
    """Tokens first, then frames or patches, from one generator, as
    ``repro/launch/serve.py:44-52`` draws them."""
    for arch, key, shape in (("seamless-m4t-large-v2", "frames", (3, 5, 64)),
                             ("internvl2-2b", "patches", (3, 8, 1024))):
        cfg = tconfigs.get_smoke(arch)
        got = tserve.make_batch(cfg, 7, 3, 5)
        rng = np.random.default_rng(7)
        assert np.array_equal(got["tokens"],
                              rng.integers(0, cfg.vocab, (3, 5)))
        assert np.array_equal(got[key],
                              rng.standard_normal(shape).astype(np.float32))
        assert np.array_equal(tserve.make_prompt(cfg, 7, 3, 5),
                              got["tokens"])


def _write():
    archs = {}
    for arch in ARCHS:
        archs[arch] = {}
        for dtype in DTYPES:
            tokens, logits = reference_run(arch, dtype)
            archs[arch][dtype] = {"tokens": tokens.tolist(),
                                  "logits": tserve.encode(logits)}
    doc = {"seed": SEED, **FLAGS,
           "made_by": "tests/test_torch_serve_families.py --write (JAX "
                      "reference, repro.launch.serve's loop, numpy_params "
                      "weights)",
           "archs": archs}
    tserve.REFERENCE_FAMILIES.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {tserve.REFERENCE_FAMILIES}")


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: PYTHONPATH=src python "
                 "tests/test_torch_serve_families.py --write")
    _write()
