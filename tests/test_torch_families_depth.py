"""The SSD's and the xLSTM's float32 drift at their published depth
(ROADMAP.md queue 3 item 9), on the CPU.

zamba2 at its 38 Mamba2 layers and xlstm at its 24, each at its smoke
config's narrow width, serve 4 requests (prompt 16, the reference
serve's ragged stop times) for 32 greedy decode steps in float32: the
reference's loop (``repro/launch/serve.py``, on
``convert.numpy_params``), and the port's ``serve.generate`` fed the
reference's tokens.  The port's logits are held against the reference's
own float32 sensitivity: the same reference loop on the same tokens with
every weight scaled by ``1 + 3e-7`` (about 2.5 float32 ulps).  Measured:
zamba2 port 1.71e-4 against the reference's own 1.77e-4, xlstm 1.66e-3
against 2.62e-3; both are past ``serve.TOLERANCE``'s 2e-5, which holds at
the smoke configs' depth, and neither is past the reference's own
spread, so no operation of the port orders its sums otherwise than
float32 itself allows.  The bound is twice that spread.
"""
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

#: the published depths
DEPTH = {"zamba2-1p2b": 38, "xlstm-350m": 24}
REQUESTS, PROMPT, STEPS = 4, 16, 32
#: the weights' scale of the reference's second run
NUDGE = 3e-7


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(cfg, params, prompt, decode, force=None):
    """The reference serve's loop: each step's logits (B, STEPS + 1, V)
    and its greedy tokens (or ``force``'s)."""
    logits, cache, lengths = rapi.prefill(cfg, params,
                                          {"tokens": jnp.asarray(prompt)},
                                          PROMPT + STEPS + 1)
    stop_after = jnp.asarray(np.minimum(4 + np.arange(REQUESTS), STEPS),
                             jnp.int32)
    active = jnp.ones((REQUESTS,), jnp.int32)
    toks, lgs = [], [np.asarray(logits, np.float32)]
    for step in range(STEPS + 1):
        tok = jnp.argmax(logits, -1).astype(jnp.int32) if force is None \
            else jnp.asarray(force[:, step], jnp.int32)
        toks.append(np.asarray(tok))
        if step == STEPS:
            break
        logits, cache, lengths = decode(params, cache, tok, lengths, active)
        lgs.append(np.asarray(logits, np.float32))
        active = (jnp.asarray(step + 1, jnp.int32) < stop_after).astype(
            jnp.int32)
    return np.stack(toks, 1), np.stack(lgs, 1)


@pytest.mark.parametrize("arch", sorted(DEPTH))
def test_float32_drift_within_the_reference_own_spread(arch):
    kw = dict(n_layers=DEPTH[arch])
    rcfg = rconfigs.get_smoke(arch).replace(dtype=jnp.float32, **kw)
    tcfg = tconfigs.get_smoke(arch).replace(dtype=torch.float32, **kw)
    weights = convert.numpy_params(tcfg, 0)
    prompt = np.random.default_rng(0).integers(0, rcfg.vocab,
                                               (REQUESTS, PROMPT))
    decode = jax.jit(make_serve_decode_step(rcfg))
    tokens, exp = _reference(rcfg, jax.tree.map(jnp.asarray, weights),
                             prompt, decode)
    _, nudged = _reference(rcfg, jax.tree.map(
        lambda a: jnp.asarray(a * (1 + NUDGE)), weights), prompt, decode,
        force=tokens)
    model = convert.from_reference(tcfg, weights, keep_master=False)
    got = tserve.generate(tcfg, model, torch.from_numpy(prompt), STEPS,
                          PROMPT + STEPS + 1, force=tokens,
                          keep_logits=True)["logits"]
    spread = float(np.abs(nudged - exp).max())
    err = float(np.abs(got - exp).max())
    assert np.isfinite(got).all() and 0 < spread
    assert err <= 2 * spread, (err, spread)
