"""The port's zamba2, xlstm, seamless-m4t and internvl2 modules against
the JAX package, on the CPU.

Module by module (``attend`` with ``causal=False``, ``kv_x`` and ragged
``kv_lengths``; the Mamba2 SSD scan and its decode; the mLSTM and sLSTM
in both forms; the encoder-decoder's encoder, decoder, cross K/V and
decode step; the VLM's connector and forward), then each family whole
through ``api.prefill`` + 4 x ``api.decode`` and ``api.loss``, and
``make_serve_decode_step`` with and without ``mask_cache``.  Both
packages take one set of numpy weights (``convert.numpy_params``) and
the same numpy inputs from a seed.  Configs: each architecture's smoke
config, zamba2 at ``n_layers=5`` with period 2 (groups of 2, 2 and 1,
so the last group is short) and xlstm at ``n_layers=8`` (layer 7 is an
sLSTM; the smoke config's 3 layers hold none).

Tolerances are ``tests/test_torch_models.py``'s: float32 ``atol 2e-5``
with greedy tokens equal; bfloat16 modules ``atol 3e-2 + rtol 1/64``,
bfloat16 serves ``serve.TOLERANCE``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import api as rapi, attention as rattn  # noqa: E402
from repro.models import encdec as renc, mamba2 as rmamba  # noqa: E402
from repro.models import vlm as rvlm, xlstm as rxl  # noqa: E402
from repro.training import steps as rsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import api as tapi, attention as tattn  # noqa: E402
from repro_torch.models import convert, encdec as tenc  # noqa: E402
from repro_torch.models import mamba2 as tmamba, vlm as tvlm  # noqa: E402
from repro_torch.models import xlstm as txl  # noqa: E402
from repro_torch.models.transformer import tree_map  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402

DTYPES = ["float32", "bfloat16"]
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
#: float32 (atol, rtol) where ``tests/test_torch_models.py``'s 2e-5 is
#: loosened, each for its reason.  The SSD (zamba2): its three-operand
#: einsums sum over a chunk in another order and ``exp(segsum)`` takes
#: differences of cumulative sums, so outputs and states of magnitude
#: 10-30 differ by a few 1e-6 relative (2.1e-5 at 10 measured).  xlstm
#: (8 layers): each cell's stabiliser ``m`` is a running sum of its gate
#: pre-activations (the sLSTM's unbounded) inside ``exp(f + m - m_new)``,
#: and each mLSTM divides by ``max(|n.q|, exp(-m))``; a one-ulp
#: difference of summation order in one layer grows several-fold a layer
#: and a step (after 14 steps: 2.9e-5 on logits of magnitude 0.5, 2.8e-4
#: on an sLSTM normaliser of 3.6, 8.5e-5 on an mLSTM memory cell of 0.63).
F32_LOOSE = {"zamba2-1p2b": (2e-5, 1e-5), "xlstm-350m": (1e-4, 1e-4)}
#: xlstm (8 layers) in bfloat16: the same growth from bf16 roundings; the
#: reference's own bf16 serve holds 77 % of its logits within
#: ``serve.TOLERANCE`` of its float32 serve, the port's bf16 serve 92-99 %
#: of them within it of the reference's bf16 serve, all within 0.1.  So
#: the share asked of it is 0.85, the bound 0.25 as the serve's.
XLSTM_BF16_SHARE = 0.85
#: the architectures of this slice, and the overrides of their smoke
#: configs that the whole-family tests use
FAMILIES = {"zamba2-1p2b": dict(n_layers=5, shared_attn_period=2),
            "xlstm-350m": dict(n_layers=8),
            "seamless-m4t-large-v2": {},
            "internvl2-2b": {}}


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny tensors: one intra-op thread (restored after the test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, dtype, seed=0, **kw):
    rcfg = rconfigs.get_smoke(arch).replace(dtype=getattr(jnp, dtype), **kw)
    tcfg = tconfigs.get_smoke(arch).replace(dtype=getattr(torch, dtype), **kw)
    tree = convert.numpy_params(tcfg, seed)
    return rcfg, tcfg, tree, jax.tree.map(jnp.asarray, tree)


def _pair(sub):
    """A numpy sub-tree as (torch, JAX) trees."""
    return (jax.tree.map(lambda a: torch.from_numpy(np.ascontiguousarray(a)),
                         sub),
            jax.tree.map(jnp.asarray, sub))


def _layer(tree, key, i=0):
    return _pair(jax.tree.map(lambda a: a[i], tree[key]))


def _x(rng, dtype, *shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, exp, dtype, what, atol=None, rtol=None):
    """``|got - exp| <= atol + rtol * |exp|``; bfloat16 with a relative
    term of 1/64 (two bf16 ulps at the bottom of a binade)."""
    atol = ATOL[dtype] if atol is None else atol
    if rtol is None:
        rtol = 1 / 64 if dtype == "bfloat16" else 0.0
    g, e = _f32(got), _f32(exp)
    assert g.shape == e.shape, f"{what}: shape {g.shape} != {e.shape}"
    excess = np.abs(g - e) - (atol + rtol * np.abs(e))
    assert excess.max() <= 0, (f"{what}: max abs err {np.abs(g - e).max()}"
                               f" beyond atol {atol} + rtol {rtol}")


# --- attention: non-causal, cross, ragged ------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["noncausal", "cross"])
def test_attend_kv_lengths_equal_reference_mask(kind, dtype):
    """``kv_lengths`` (B,) stands for the reference's ``kv_valid =
    arange(T) < kv_lengths``; a row with no live key (length 0) gives 0."""
    rcfg, tcfg, tree, _ = _setup("seamless-m4t-large-v2", dtype)
    tp, jp = _layer(tree["dec"], "cross_attn")
    rng = np.random.default_rng(1)
    b, s, t = 3, 12, 20 if kind == "cross" else 12
    jx, tx = _x(rng, dtype, b, s, tcfg.d_model)
    lens = np.array([0, 7, t], np.int32)
    valid = np.arange(t)[None, :] < lens[:, None]
    pos = np.broadcast_to(np.arange(s), (b, s))
    kw, tkw = {}, {}
    if kind == "cross":
        jkv, tkv = _x(rng, dtype, b, t, tcfg.d_model)
        kw["kv_x"], tkw["kv_x"] = jkv, tkv
    exp = rattn.attend(rcfg, jp, jx, jnp.asarray(pos), causal=False,
                       kv_valid=jnp.asarray(valid), **kw)
    got = tattn.attend(tcfg, tp, tx, torch.from_numpy(pos.copy()),
                       causal=False, kv_lengths=torch.from_numpy(lens), **tkw)
    assert got.dtype == tx.dtype
    _close(got, exp, dtype, f"attend {kind}")
    # the row with no live key: the output projection of a zero row
    assert np.abs(_f32(got)[0]).max() == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_attend_cross_ignores_causal_and_rotary(dtype):
    """With ``kv_x`` the reference applies no rotary and no causal mask,
    whatever ``causal`` says; so does the port."""
    rcfg, tcfg, tree, _ = _setup("seamless-m4t-large-v2", dtype)
    tp, jp = _layer(tree["dec"], "cross_attn", 1)
    rng = np.random.default_rng(2)
    jx, tx = _x(rng, dtype, 2, 9, tcfg.d_model)
    jkv, tkv = _x(rng, dtype, 2, 9, tcfg.d_model)
    pos = np.broadcast_to(np.arange(9) + 3, (2, 9))
    exp = rattn.attend(rcfg, jp, jx, jnp.asarray(pos), causal=True,
                       kv_x=jkv)
    got = tattn.attend(tcfg, tp, tx, torch.from_numpy(pos.copy()),
                       causal=True, kv_x=tkv)
    _close(got, exp, dtype, "cross attend")


# --- Mamba2 SSD ----------------------------------------------------------------

def _zamba(dtype):
    return _setup("zamba2-1p2b", dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunks", ["one", "several"])
def test_ssd_apply_and_final_state_equal_reference(chunks, dtype,
                                                   monkeypatch):
    """One chunk (S = 24, which CHUNK = 256 does not divide) and several
    (CHUNK set to 16 in both packages, S = 64: four chunks and the
    inter-chunk scan)."""
    rcfg, tcfg, tree, _ = _zamba(dtype)
    tp, jp = _layer(tree, "mamba", 1)
    s = 24
    if chunks == "several":
        monkeypatch.setattr(rmamba, "CHUNK", 16)
        monkeypatch.setattr(tmamba, "CHUNK", 16)
        s = 64
    rng = np.random.default_rng(3)
    ju, tu = _x(rng, dtype, 2, s, tcfg.d_model)
    exp, est = rmamba.ssd_apply(rcfg, jp, ju, return_state=True)
    got, gst = tmamba.ssd_apply(tcfg, tp, tu, return_state=True)
    assert got.dtype == tu.dtype and gst.dtype == torch.float32
    tol = F32_LOOSE["zamba2-1p2b"] if dtype == "float32" else (None, None)
    _close(got, exp, dtype, "ssd_apply", *tol)
    _close(gst, est, dtype, "final state", *tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_decode_equals_reference(dtype):
    rcfg, tcfg, tree, _ = _zamba(dtype)
    tp, jp = _layer(tree, "mamba", 2)
    rng = np.random.default_rng(4)
    b, h, n, pd = 3, tcfg.ssm_heads, tcfg.ssm_state, tcfg.ssm_head_dim
    st = (rng.standard_normal((b, h, n, pd)) * 0.5).astype(np.float32)
    jst, tst = jnp.asarray(st), torch.from_numpy(st)
    for step in range(3):
        ju, tu = _x(rng, dtype, b, tcfg.d_model)
        ey, jst = rmamba.ssd_decode(rcfg, jp, ju, jst)
        gy, tst = tmamba.ssd_decode(tcfg, tp, tu, tst)
        tol = F32_LOOSE["zamba2-1p2b"] if dtype == "float32" \
            else (None, None)
        _close(gy, ey, dtype, f"ssd_decode y, step {step}", *tol)
        _close(tst, jst, dtype, f"ssd_decode state, step {step}", *tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_scan_state_continues_as_decode(dtype):
    """The port's own contract: decoding token S from the scan's final
    state gives what the scan over S + 1 tokens gives at that token."""
    _, tcfg, tree, _ = _zamba(dtype)
    tp, _ = _layer(tree, "mamba", 0)
    rng = np.random.default_rng(5)
    _, tu = _x(rng, "float32", 2, 17, tcfg.d_model)
    tu = tu.to(tcfg.dtype)
    whole = tmamba.ssd_apply(tcfg, tp, tu)
    _, st = tmamba.ssd_apply(tcfg, tp, tu[:, :16], return_state=True)
    last, _ = tmamba.ssd_decode(tcfg, tp, tu[:, 16], st)
    _close(last, whole[:, 16], dtype, "decode after the scan")


# --- xLSTM ----------------------------------------------------------------------

def _xlstm(dtype):
    return _setup("xlstm-350m", dtype, n_layers=8)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_xlstm_apply_equals_reference(cell, dtype):
    rcfg, tcfg, tree, _ = _xlstm(dtype)
    tp, jp = _pair(tree["blocks"][7 if cell == "slstm" else 2])
    rng = np.random.default_rng(6)
    jx, tx = _x(rng, dtype, 2, 14, tcfg.d_model)
    exp = getattr(rxl, f"{cell}_apply")(rcfg, jp, jx)
    got = getattr(txl, f"{cell}_apply")(tcfg, tp, tx)
    assert got.dtype == tx.dtype
    _close(got, exp, dtype, f"{cell}_apply")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_xlstm_decode_equals_reference(cell, dtype):
    """Four steps from the initial state (``m = -1e30``; sLSTM ``n =
    1e-6``), each step's output and state against the reference's."""
    rcfg, tcfg, tree, _ = _xlstm(dtype)
    tp, jp = _pair(tree["blocks"][7 if cell == "slstm" else 0])
    rng = np.random.default_rng(7)
    jst = getattr(rxl, f"{cell}_state")(rcfg, 3)
    tst = getattr(txl, f"{cell}_state")(tcfg, 3)
    assert sorted(tst) == sorted(jst)
    for step in range(4):
        jx, tx = _x(rng, dtype, 3, tcfg.d_model)
        ey, jst = getattr(rxl, f"{cell}_decode")(rcfg, jp, jx, jst)
        gy, tst = getattr(txl, f"{cell}_decode")(tcfg, tp, tx, tst)
        _close(gy, ey, dtype, f"{cell}_decode, step {step}")
        for k in jst:
            _close(tst[k], jst[k], "float32", f"{cell} state {k}, step {step}",
                   atol=ATOL[dtype])


def test_xlstm_layer_kinds_and_slstm_init():
    """Layers 7, 15, 23 are the sLSTMs at full depth; the recurrent
    weights are drawn at a tenth of the input weights' scale."""
    cfg = tconfigs.get("xlstm-350m")
    assert [i for i in range(cfg.n_layers) if txl._is_slstm(cfg, i)] == \
        [7, 15, 23]
    small = tconfigs.get_smoke("xlstm-350m").replace(n_layers=8, d_model=256)
    p = txl.slstm_params(torch.Generator().manual_seed(0), small)
    ratio = float(p["r_i"].std() / p["w_i"].std())
    assert 0.08 < ratio < 0.12
    tree = convert.numpy_params(small, 0)["blocks"][7]
    assert 0.08 < float(tree["r_f"].std() / tree["w_f"].std()) < 0.12


# --- the encoder-decoder ------------------------------------------------------------

def _seamless(dtype):
    return _setup("seamless-m4t-large-v2", dtype)


def _enc_inputs(dtype, tcfg, b=3, t=10, seed=8):
    rng = np.random.default_rng(seed)
    jf, tf = _x(rng, dtype, b, t, tcfg.d_model)
    lens = np.array([t, 4, 7], np.int32)[:b]
    return rng, jf, tf, lens, np.arange(t)[None, :] < lens[:, None]


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_equals_reference(dtype):
    rcfg, tcfg, _, jtree = _seamless(dtype)
    model = convert.from_reference(tcfg, convert.numpy_params(tcfg, 0))
    _, jf, tf, lens, valid = _enc_inputs(dtype, tcfg)
    for ev, tl in ((None, None), (jnp.asarray(valid), torch.from_numpy(lens))):
        exp = renc.encode(rcfg, jtree, jf, ev)
        got = tenc.encode(tcfg, model.serving_params(), tf, tl)
        assert got.dtype == tcfg.dtype
        _close(got, exp, dtype, f"encode (lengths {tl is not None})")


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_train_equals_reference(dtype):
    rcfg, tcfg, tree, jtree = _seamless(dtype)
    params = convert.from_reference(tcfg, tree).serving_params()
    rng, jf, tf, lens, valid = _enc_inputs(dtype, tcfg)
    toks = rng.integers(0, tcfg.vocab, (3, 8))
    enc_j = renc.encode(rcfg, jtree, jf, jnp.asarray(valid))
    enc_t = tenc.encode(tcfg, params, tf, torch.from_numpy(lens))
    exp = renc.decode_train(rcfg, jtree, jnp.asarray(toks), enc_j,
                            jnp.asarray(valid))
    got = tenc.decode_train(tcfg, params, torch.from_numpy(toks), enc_t,
                            torch.from_numpy(lens))
    assert tserve.tolerance_error(_f32(got), _f32(exp), dtype) is None


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_cross_and_decode_step_equal_reference(dtype):
    """The cross K/V as (L, B, KV, T, hd), contiguous, and three decode
    steps over them with ragged encoder lengths."""
    rcfg, tcfg, tree, jtree = _seamless(dtype)
    params = convert.from_reference(tcfg, tree).serving_params()
    rng, jf, tf, lens, valid = _enc_inputs(dtype, tcfg)
    enc_j = renc.encode(rcfg, jtree, jf)
    enc_t = tenc.encode(tcfg, params, tf)
    ek, ev, _ = renc.prefill_cross(rcfg, jtree, enc_j, jnp.asarray(lens))
    gk, gv, gl = tenc.prefill_cross(tcfg, params, enc_t,
                                    torch.from_numpy(lens))
    assert gk.is_contiguous() and gk[1].is_contiguous()
    _close(gk, ek, dtype, "cross k")
    _close(gv, ev, dtype, "cross v")
    jc = dict(renc.init_cache(rcfg, 3, 16, 10), cross_k=ek, cross_v=ev,
              enc_len=jnp.asarray(lens))
    tc = dict(tenc.init_cache(tcfg, 3, 16, 10), cross_k=gk, cross_v=gv,
              enc_len=gl)
    jlen, tlen = jnp.zeros((3,), jnp.int32), torch.zeros((3,), dtype=torch.int32)
    for step in range(3):
        tok = rng.integers(0, tcfg.vocab, (3,)).astype(np.int32)
        el, jc, jlen = renc.decode_step(rcfg, jtree, jc, jnp.asarray(tok),
                                        jlen)
        gl_, tc, tlen = tenc.decode_step(tcfg, params, tc,
                                         torch.from_numpy(tok), tlen)
        assert np.array_equal(tlen.numpy(), np.asarray(jlen))
        assert tserve.tolerance_error(_f32(gl_), _f32(el), dtype) is None, \
            f"step {step}"
        _close(tc["self"].k, jc["self"].k, dtype, f"self k, step {step}")


# --- the VLM --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_vlm_project_and_forward_equal_reference(dtype):
    rcfg, tcfg, tree, jtree = _setup("internvl2-2b", dtype)
    params = convert.from_reference(tcfg, tree).serving_params()
    rng = np.random.default_rng(9)
    jp, tp = _x(rng, dtype, 2, tcfg.num_patches, tvlm.D_VIT)
    _close(tvlm._project(tcfg, params, tp), rvlm._project(rcfg, jtree, jp),
           dtype, "_project")
    toks = rng.integers(0, tcfg.vocab, (2, 10))
    exp = rvlm.forward(rcfg, jtree, jp, jnp.asarray(toks))
    got = tvlm.forward(tcfg, params, tp, torch.from_numpy(toks))
    assert got.shape == exp.shape == (2, 10, tcfg.vocab)
    assert tserve.tolerance_error(_f32(got), _f32(exp), dtype) is None


# --- each family whole ------------------------------------------------------------------

def _batch(tcfg, b, s, seed):
    """The serve's inputs (``serve.make_batch``) as numpy and JAX."""
    nb = tserve.make_batch(tcfg, seed, b, s)
    return nb, {k: jnp.asarray(v) for k, v in nb.items()}


def _both_serve(arch, dtype, b=3, s=12, steps=4, max_len=24, step_fn=None,
                active=None):
    """Prefill then ``steps`` greedy decode steps in both packages (the
    port fed the reference's tokens); with ``step_fn``, through
    ``make_serve_decode_step(cfg, mask_cache=step_fn)``'s step and the
    ``active`` mask.  Returns [(reference logits, port logits)] and the
    last caches."""
    rcfg, tcfg, tree, jtree = _setup(arch, dtype, **FAMILIES[arch])
    model = convert.from_reference(tcfg, tree)
    nb, jb = _batch(tcfg, b, s, 10)
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    rl, rc, rlen = rapi.prefill(rcfg, jtree, jb, max_len)
    tl, tc, tlen = tapi.prefill(tcfg, model, tb, max_len)
    assert np.array_equal(tlen.numpy(), np.asarray(rlen))
    out = [(rl, tl)]
    if step_fn is not None:
        rstep = rsteps.make_serve_decode_step(rcfg, step_fn == "mask")
        tstep = tsteps.make_serve_decode_step(tcfg, step_fn == "mask")
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
        if step_fn is None:
            rl, rc, rlen = rapi.decode(rcfg, jtree, rc, jnp.asarray(tok),
                                       rlen)
            tl, tc, tlen = tapi.decode(tcfg, model, tc, torch.from_numpy(tok),
                                       tlen)
        else:
            rl, rc, rlen = rstep(jtree, rc, jnp.asarray(tok), rlen,
                                 jnp.asarray(active))
            tl, tc, tlen = tstep(model, tc, torch.from_numpy(tok), tlen,
                                 torch.from_numpy(active))
        assert np.array_equal(tlen.numpy(), np.asarray(rlen))
        out.append((rl, tl))
    return out, (rc, tc)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_api_prefill_and_decode_equal_reference(arch, dtype):
    steps, _ = _both_serve(arch, dtype)
    exp = np.stack([_f32(r) for r, _ in steps])
    got = np.stack([_f32(t) for _, t in steps])
    assert all(t.dtype == getattr(torch, dtype) for _, t in steps)
    if arch == "xlstm-350m" and dtype == "float32":
        _close(got, exp, dtype, "xlstm logits", *F32_LOOSE[arch])
    elif arch == "xlstm-350m":
        err = np.abs(got - exp)
        t = tserve.TOLERANCE[dtype]
        share = np.mean(err <= t["atol"] + t["rtol"] * np.abs(exp))
        assert share >= XLSTM_BF16_SHARE and err.max() <= t["bound"], \
            (share, err.max())
    else:
        off = tserve.tolerance_error(got, exp, dtype)
        assert off is None, off
    bad, checked = tserve.greedy_mismatches(got, exp, dtype)
    assert bad == 0
    if dtype == "float32" and arch != "seamless-m4t-large-v2":
        assert checked == exp.shape[0] * exp.shape[1], "a near tie"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_api_loss_equals_reference(arch, dtype):
    rcfg, tcfg, tree, jtree = _setup(arch, dtype, **FAMILIES[arch])
    model = convert.from_reference(tcfg, tree)
    nb, jb = _batch(tcfg, 2, 10, 11)
    mask = (np.random.default_rng(12).random((2, 10)) < 0.8).astype(
        np.float32)
    nb["mask"], jb["mask"] = mask, jnp.asarray(mask)
    exp = float(rapi.loss(rcfg, jtree, jb))
    got = tapi.loss(tcfg, model, {k: torch.from_numpy(v)
                                  for k, v in nb.items()})
    assert got.dtype == torch.float32 and got.dim() == 0
    tol = 2e-5 if dtype == "float32" else 3e-2 + abs(exp) / 64
    assert abs(float(got) - exp) <= tol, (float(got), exp)


@pytest.mark.parametrize("mask_cache", [False, True])
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_serve_decode_step_masks_as_reference(arch, mask_cache):
    """Inactive slots keep their lengths and, with ``mask_cache``, every
    cache leaf the reference's merge masks (a recurrent state too);
    without it an inactive slot's state advances, as the reference's."""
    active = np.array([1, 0, 1], np.int32)
    steps, (rc, tc) = _both_serve(arch, "float32", steps=2,
                                  step_fn="mask" if mask_cache else "plain",
                                  active=active)
    tol = F32_LOOSE.get(arch, (None, None))
    for i, (r, t) in enumerate(steps):
        _close(t, r, "float32", f"logits, step {i}", *tol)
    got = jax.tree.leaves(tree_map(lambda t: t.numpy(), tc))
    exp = jax.tree.leaves(rc)
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        _close(g, e, "float32", "cache leaf", *tol)


def test_family_tree_round_trips_through_the_reference_layout():
    """``to_reference(from_reference(tree))`` is the tree, leaf for leaf,
    for each family's layout (stacks, xlstm's list, one shared block)."""
    for arch, kw in FAMILIES.items():
        cfg = tconfigs.get_smoke(arch).replace(**kw)
        tree = convert.numpy_params(cfg, 1)
        back = convert.to_reference(convert.from_reference(cfg, tree))
        assert jax.tree.structure(back) == jax.tree.structure(tree), arch
        for g, e in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            assert np.array_equal(g, e), arch


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_port_init_matches_reference_layout_and_scale(arch):
    """``api.init_params`` on a torch.Generator gives the reference's
    tree (in the port's per-layer layout), shapes and initialiser
    scales."""
    kw = FAMILIES[arch]
    tcfg = tconfigs.get_smoke(arch).replace(**kw)
    rcfg = rconfigs.get_smoke(arch).replace(**kw)
    mine = convert.to_reference(tapi.init_params(
        torch.Generator().manual_seed(0), tcfg))
    ref = rapi.init_params(jax.random.PRNGKey(0), rcfg)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, mine)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, ref))
    for got, exp in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
        exp = np.asarray(exp)
        assert got.shape == exp.shape and got.dtype == exp.dtype
        # both are samples of one law: five standard errors of the
        # difference of two sample stds (means) of n values
        n, sd = exp.size, float(exp.std())
        assert abs(got.std() - sd) <= 5 * sd / np.sqrt(n) + 1e-6
        assert abs(got.mean() - exp.mean()) <= 5 * sd * np.sqrt(2 / n) + 1e-6
