"""The port's LM modules against the JAX package, on the CPU.

``attend``, ``attend_decode``, ``moe_apply`` (both routing modes) and the
transformer's ``prefill`` and ``decode_step`` take one set of numpy
weights (``repro_torch.models.convert.numpy_params``, handed to both
packages) and the same numpy inputs.  Configs: granite-moe-3b-a800m's
smoke config (MoE, GQA 4/2, head_dim 12) and yi-9b's (dense, head_dim
16), each in float32 and in the default bfloat16.

Tolerances: float32 ``atol 2e-5`` on activations, logits and the cache,
where greedy tokens and the expert choices ``topi`` must be identical.
bfloat16 modules, given the same inputs: ``atol 3e-2`` plus ``rtol 1/64``
(two bf16 ulps at the bottom of a binade).  bfloat16 prefill and decode:
``serve.TOLERANCE``, 99 % of the entries within that and all within
0.25, with greedy tokens equal wherever the reference's top-2 margin
exceeds ``3e-2``.  bf16 rounds at other places in the two packages (the
reference rounds the softmax weights to bf16 before ``@ v``, the kernel
keeps them in float32), so the residual stream drifts by an ulp or two
a layer, and expert-choice routing then now and then moves a token
across an expert's capacity boundary: the granite case below does, at
layer 0 (gates 0.17645 against 0.17641), and its logits move by 0.049
(0.09 in the serve's run).  The dense model stays within 0.01.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import api as rapi, attention as rattn, moe as rmoe  # noqa: E402
from repro.training import steps as rsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import api as tapi, attention as tattn  # noqa: E402
from repro_torch.models import convert, moe as tmoe  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402

ARCHS = ["granite-moe-3b-a800m", "yi-9b"]
DTYPES = ["float32", "bfloat16"]
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny tensors: one intra-op thread (restored after the test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype):
    return (rconfigs.get_smoke(arch).replace(dtype=getattr(jnp, dtype)),
            tconfigs.get_smoke(arch).replace(dtype=getattr(torch, dtype)))


def _setup(arch, dtype, seed=0):
    rcfg, tcfg = _cfgs(arch, dtype)
    tree = convert.numpy_params(tcfg, seed)
    return rcfg, tcfg, tree, jax.tree.map(jnp.asarray, tree)


def _layer(tree, name, i=0):
    """Layer ``i``'s ``name`` sub-tree: numpy (for the port) and JAX."""
    sub = jax.tree.map(lambda a: a[i], tree["blocks"][name])
    return (jax.tree.map(lambda a: torch.from_numpy(np.ascontiguousarray(a)),
                         sub),
            jax.tree.map(jnp.asarray, sub))


def _x(rng, dtype, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, exp, dtype, what, atol=None, rtol=None):
    """``|got - exp| <= atol + rtol * |exp|``; bfloat16 defaults to a
    relative term of 1/64 (two bf16 ulps at the bottom of a binade)."""
    atol = ATOL[dtype] if atol is None else atol
    rtol = (1 / 64 if dtype == "bfloat16" else 0.0) if rtol is None else rtol
    g, e = _f32(got), _f32(exp)
    excess = np.abs(g - e) - (atol + rtol * np.abs(e))
    assert excess.max() <= 0, (f"{what}: max abs err {np.abs(g - e).max()}"
                               f" beyond atol {atol} + rtol {rtol}")


# --- attention --------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_attend_equals_reference(arch, dtype):
    rcfg, tcfg, tree, _ = _setup(arch, dtype)
    tp, jp = _layer(tree, "attn")
    rng = np.random.default_rng(1)
    jx, tx = _x(rng, dtype, 2, 24, tcfg.d_model)
    pos = np.broadcast_to(np.arange(24), (2, 24))
    exp, (ek, ev) = rattn.attend(rcfg, jp, jx, jnp.asarray(pos),
                                 return_kv=True)
    got, (gk, gv) = tattn.attend(tcfg, tp, tx, torch.from_numpy(pos.copy()),
                                 return_kv=True)
    assert got.dtype == tx.dtype and tuple(got.shape) == exp.shape
    for g, e, what in ((got, exp, "out"), (gk, ek, "k"), (gv, ev, "v")):
        _close(g, e, dtype, what)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_attend_decode_equals_reference(arch, dtype):
    rcfg, tcfg, tree, _ = _setup(arch, dtype)
    tp, jp = _layer(tree, "attn")
    rng = np.random.default_rng(2)
    b, t = 3, 20
    shape = (b, tcfg.kv_heads, t, tcfg.hd)
    (jk, tk), (jv, tv) = _x(rng, dtype, *shape), _x(rng, dtype, *shape)
    jx, tx = _x(rng, dtype, b, tcfg.d_model)
    lengths = np.array([0, 7, 19], np.int32)
    exp, ecache = rattn.attend_decode(rcfg, jp, jx, rattn.KVCache(jk, jv),
                                      jnp.asarray(lengths))
    got, gcache = tattn.attend_decode(tcfg, tp, tx, tattn.KVCache(tk, tv),
                                      torch.from_numpy(lengths))
    _close(got, exp, dtype, "out")
    _close(gcache.k, ecache.k, dtype, "cache k")
    _close(gcache.v, ecache.v, dtype, "cache v")


# --- MoE ----------------------------------------------------------------------

def _ref_route(cfg, p, flat, mode):
    """The reference's routing choice, by its own lines (moe.py:59-73)."""
    gl = jnp.einsum("nd,de->ne", flat, p["router"].astype(flat.dtype))
    gates = jax.nn.softmax(gl.astype(jnp.float32), axis=-1)
    if mode == "token_dense":
        return jax.lax.top_k(gates, cfg.top_k)
    n = flat.shape[0]
    cap = max(1, int(round(n * cfg.top_k / cfg.num_experts)))
    return jax.lax.top_k(gates.T, cap)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", tmoe.MODES)
def test_moe_apply_equals_reference(mode, dtype):
    arch = "granite-moe-3b-a800m"
    rcfg, tcfg, tree, _ = _setup(arch, dtype)
    tp, jp = _layer(tree, "moe", 1)
    rng = np.random.default_rng(3)
    jx, tx = _x(rng, dtype, 2, 16, tcfg.d_model)
    exp = rmoe.moe_apply(rcfg, jp, jx, mode=mode)
    got = tmoe.moe_apply(tcfg, tp, tx, mode=mode)
    assert got.dtype == tx.dtype
    _close(got, exp, dtype, f"moe_apply {mode}")
    if dtype == "float32":
        _, ei = _ref_route(rcfg, jp, jx.reshape(-1, tcfg.d_model), mode)
        _, gi = tmoe.route(tcfg, tp, tx.reshape(-1, tcfg.d_model), mode=mode)
        assert np.array_equal(gi.numpy(), np.asarray(ei))


@pytest.mark.parametrize("mode", tmoe.MODES)
def test_moe_tied_gates_choose_as_reference(mode):
    """Equal gates: tokens with equal rows tie for an expert, and experts
    with equal router columns tie for a token.  The port, like
    ``jax.lax.top_k``, takes the lowest index first, so its expert choice
    is the reference's, index for index."""
    dtype = "bfloat16"
    rcfg, tcfg, tree, _ = _setup("granite-moe-3b-a800m", dtype)
    router = tree["blocks"]["moe"]["router"]
    router[0, :, 3] = router[0, :, 1]
    router[0, :, 4] = router[0, :, 1]
    tp, jp = _layer(tree, "moe")
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((3, tcfg.d_model)).astype(np.float32)
    x = rows[rng.integers(0, 3, 2 * 12)].reshape(2, 12, tcfg.d_model)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    ev, ei = _ref_route(rcfg, jp, jx.reshape(-1, tcfg.d_model), mode)
    gv, gi = tmoe.route(tcfg, tp, tx.reshape(-1, tcfg.d_model), mode=mode)
    ev = np.asarray(ev)
    assert (np.diff(ev, axis=-1) == 0).any(), "the case must hold ties"
    np.testing.assert_allclose(gv.numpy(), ev, atol=1e-6)
    assert np.array_equal(gi.numpy(), np.asarray(ei))
    _close(tmoe.moe_apply(tcfg, tp, tx, mode=mode),
           rmoe.moe_apply(rcfg, jp, jx, mode=mode), dtype, "moe_apply")


def test_top_k_ties_lowest_index_first():
    x = np.array([[.5, 1, 1, .2, 1, 1]], np.float32)
    v, i = tmoe.top_k(torch.from_numpy(x), 3)
    ev, ei = jax.lax.top_k(jnp.asarray(x), 3)
    assert i.tolist() == np.asarray(ei).tolist() == [[1, 2, 4]]
    assert np.array_equal(v.numpy(), np.asarray(ev))


# --- the transformer: prefill and decode -------------------------------------

def _serve_both(arch, dtype, b=4, s=16, steps=4, max_len=32):
    """Prefill then greedy decode in both packages; the port is fed the
    reference's tokens, so each step compares like with like."""
    rcfg, tcfg, tree, jtree = _setup(arch, dtype)
    model = convert.from_reference(tcfg, tree)
    toks = np.random.default_rng(5).integers(0, tcfg.vocab, (b, s))
    rl, rcache, rlen = rapi.prefill(rcfg, jtree, {"tokens": jnp.asarray(toks)},
                                    max_len)
    tl, tcache, tlen = tapi.prefill(tcfg, model,
                                    {"tokens": torch.from_numpy(toks)},
                                    max_len)
    out = [(rl, tl)]
    # the port writes its cache in place: keep the prefill's as it was
    caches = [(rcache, tattn.KVCache(tcache.k.clone(), tcache.v.clone()))]
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
        rl, rcache, rlen = rapi.decode(rcfg, jtree, rcache, jnp.asarray(tok),
                                       rlen)
        tl, tcache, tlen = tapi.decode(tcfg, model, tcache,
                                       torch.from_numpy(tok), tlen)
        assert np.array_equal(tlen.numpy(), np.asarray(rlen))
        out.append((rl, tl))
    caches.append((rcache, tcache))
    return out, caches


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_reference(arch, dtype):
    steps, caches = _serve_both(arch, dtype)
    exp = np.stack([_f32(r) for r, _ in steps])
    got = np.stack([_f32(t) for _, t in steps])
    assert all(t.dtype == getattr(torch, dtype) for _, t in steps)
    assert tserve.tolerance_error(got, exp, dtype) is None
    bad, checked = tserve.greedy_mismatches(got, exp, dtype)
    assert bad == 0
    if dtype == "float32":
        assert checked == exp.shape[0] * exp.shape[1], "a near tie"
    for rc, tc in caches:
        for g, e in ((tc.k, rc.k), (tc.v, rc.v)):
            assert tserve.tolerance_error(_f32(g), _f32(e), dtype) is None


@pytest.mark.parametrize("mask_cache", [False, True])
def test_serve_decode_step_masks_as_reference(mask_cache):
    """``make_serve_decode_step``: inactive slots keep their lengths and,
    with ``mask_cache``, their cache rows."""
    dtype = "float32"
    rcfg, tcfg, tree, jtree = _setup("granite-moe-3b-a800m", dtype)
    model = convert.from_reference(tcfg, tree)
    toks = np.random.default_rng(6).integers(0, tcfg.vocab, (3, 8))
    rl, rcache, rlen = rsteps.make_prefill_step(rcfg, 16)(
        jtree, {"tokens": jnp.asarray(toks)})
    tl, tcache, tlen = tsteps.make_prefill_step(tcfg, 16)(
        model, {"tokens": torch.from_numpy(toks)})
    rstep = rsteps.make_serve_decode_step(rcfg, mask_cache)
    tstep = tsteps.make_serve_decode_step(tcfg, mask_cache)
    tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
    active = np.array([1, 0, 1], np.int32)
    for _ in range(2):
        rl, rcache, rlen = rstep(jtree, rcache, jnp.asarray(tok), rlen,
                                 jnp.asarray(active))
        tl, tcache, tlen = tstep(model, tcache, torch.from_numpy(tok), tlen,
                                 torch.from_numpy(active))
        assert np.array_equal(tlen.numpy(), np.asarray(rlen))
        _close(tl, rl, dtype, "logits")
        _close(tcache.k, rcache.k, dtype, "cache k")
        _close(tcache.v, rcache.v, dtype, "cache v")
        tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)


def test_port_init_matches_reference_layout_and_scale():
    """``init_params`` on a torch.Generator gives the reference's leaves,
    per-layer shapes and initialiser scales."""
    from repro.models import transformer as rtrans
    _, tcfg = _cfgs("granite-moe-3b-a800m", "float32")
    rcfg = rconfigs.get_smoke("granite-moe-3b-a800m")
    mine = tapi.init_params(torch.Generator().manual_seed(0), tcfg).params()
    ref = rtrans.init_params(jax.random.PRNGKey(0), rcfg)
    ref_blocks = ref.pop("blocks")
    pairs = [(mine[k], ref[k]) for k in ref]
    assert sorted(mine) == sorted(list(ref) + ["blocks"])
    for i, blk in enumerate(mine["blocks"]):
        layer = jax.tree.map(lambda a: a[i], ref_blocks)
        assert jax.tree.structure(jax.tree.map(lambda t: 0, blk)) == \
            jax.tree.structure(jax.tree.map(lambda a: 0, layer))
        pairs += zip(jax.tree.leaves(blk), jax.tree.leaves(layer))
    for got, exp in pairs:
        got, exp = got.numpy(), np.asarray(exp)
        assert got.shape == exp.shape and got.dtype == exp.dtype
        assert abs(got.std() - exp.std()) <= 0.15 * exp.std() + 1e-6


@pytest.mark.parametrize("init", ["torch", "numpy"])
def test_serve_only_model_holds_the_serving_copy_alone(init):
    """``keep_master=False`` holds only the bf16 serving copy: the same
    bits as the cast of the float32 master, and no second copy."""
    cfg = tconfigs.get_smoke("granite-moe-3b-a800m")
    if init == "torch":
        build = lambda keep: tapi.init_params(torch.Generator().manual_seed(0),
                                              cfg, keep_master=keep)
    else:
        tree = convert.numpy_params(cfg, 0)
        build = lambda keep: convert.from_reference(cfg, tree,
                                                    keep_master=keep)
    master, lean = build(True), build(False)
    assert {p.dtype for p in master.parameters()} == {cfg.param_dtype}
    assert {p.dtype for p in lean.parameters()} == {cfg.dtype}
    exp = jax.tree.leaves(master.serving_params())
    got = jax.tree.leaves(lean.serving_params())
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g.dtype == cfg.dtype and torch.equal(g, e)
    ptrs = {p.data_ptr() for p in lean.parameters()}
    assert all(g.data_ptr() in ptrs for g in got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_reference(arch, dtype):
    from repro.models import transformer as rtrans
    from repro_torch.models import transformer as ttrans
    rcfg, tcfg, tree, jtree = _setup(arch, dtype)
    model = convert.from_reference(tcfg, tree)
    toks = np.random.default_rng(7).integers(0, tcfg.vocab, (2, 12))
    exp = rtrans.forward(rcfg, jtree, jnp.asarray(toks))
    with torch.no_grad():
        got = ttrans.forward(tcfg, model.serving_params(),
                             torch.from_numpy(toks))
    assert got.shape == exp.shape
    assert tserve.tolerance_error(_f32(got), _f32(exp), dtype) is None


def test_unported_family_raises():
    """Every family of the assigned architectures is ported; a family
    that none of them has still raises."""
    assert set(tapi.FAMILIES) == {tconfigs.get(a).family
                                  for a in tconfigs.ARCHS}
    cfg = tconfigs.get_smoke("zamba2-1p2b").replace(family="rnn")
    with pytest.raises(NotImplementedError, match="families"):
        tapi.init_params(torch.Generator(), cfg)
