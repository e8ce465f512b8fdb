"""The port's LM gradients against the JAX reference's, on the CPU.

``repro_torch.models.api.loss`` and ``jax.grad`` of ``repro.models.api.
loss`` take one set of numpy weights (``convert.numpy_params``) and one
``SyntheticLM`` batch; every parameter leaf's gradient (the port's laid
out as the reference's by ``convert.to_reference``) is held to rtol 1e-4
with an atol of 1e-5 of the leaf's largest gradient (float32, the same
function summed in other orders).  Configs: granite-moe-3b-a800m's smoke
config (MoE, expert choice) and yi-9b's (dense), float32.

The backward kernels' plain versions (``mha_ref_bwd``,
``wavefront_matmul_ref_bwd``) are held against ``torch.autograd.grad``
of the plain forwards in float64, and the attention gradient against
``jax.vjp`` of the reference's ``_gqa_scores`` attention; ``remat``
gradients equal plain ones bit for bit; a bfloat16 model trained one
step serves its updated weights.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import api as rapi, attention as rattn, moe as rmoe  # noqa: E402
from repro.models import common as rcommon  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops, ref as fref  # noqa: E402
from repro_torch.kernels.wavefront_matmul import ops as mops, ref as mref  # noqa: E402
from repro_torch.models import api as tapi, common as tcommon, convert  # noqa: E402
from repro_torch.models import moe as tmoe, transformer  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.steps import make_train_step  # noqa: E402

ARCHS = ["granite-moe-3b-a800m", "yi-9b"]


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny tensors: one intra-op thread (restored after the test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, dtype="float32", **kw):
    rcfg = rconfigs.get_smoke(arch).replace(dtype=getattr(jnp, dtype), **kw)
    tcfg = tconfigs.get_smoke(arch).replace(dtype=getattr(torch, dtype), **kw)
    tree = convert.numpy_params(tcfg, 0)
    batch = tdata.SyntheticLM(tcfg, 4, 24, seed=3).next_batch(0)
    return rcfg, tcfg, tree, batch


def _port_grads(tcfg, tree, batch):
    model = convert.from_reference(tcfg, tree).requires_grad_()
    loss = tapi.loss(tcfg, model, {"tokens": torch.from_numpy(
        batch["tokens"])})
    loss.backward()
    grads = transformer.tree_map(lambda p: p.grad, model.params())
    return float(loss.detach()), convert.to_reference(grads)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_equal_reference(arch):
    rcfg, tcfg, tree, batch = _setup(arch)
    loss, got = _port_grads(tcfg, tree, batch)
    rl, rg = jax.value_and_grad(lambda p: rapi.loss(rcfg, p, {
        "tokens": jnp.asarray(batch["tokens"])}))(
        jax.tree.map(jnp.asarray, tree))
    np.testing.assert_allclose(loss, float(rl), rtol=1e-6)
    got, exp = _flat(got), _flat(jax.tree.map(np.asarray, rg))
    assert got.keys() == exp.keys()
    for k in exp:
        assert got[k].shape == exp[k].shape, k
        atol = 1e-5 * float(np.abs(exp[k]).max())
        np.testing.assert_allclose(got[k], exp[k], rtol=1e-4, atol=atol,
                                   err_msg=k)


def test_masked_loss_equals_reference():
    rcfg, tcfg, tree, batch = _setup("yi-9b")
    mask = np.random.default_rng(1).random(batch["tokens"].shape) < 0.7
    model = convert.from_reference(tcfg, tree)
    got = tapi.loss(tcfg, model, {"tokens": torch.from_numpy(
        batch["tokens"]), "mask": torch.from_numpy(mask)})
    exp = rapi.loss(rcfg, jax.tree.map(jnp.asarray, tree),
                    {"tokens": jnp.asarray(batch["tokens"]),
                     "mask": jnp.asarray(mask)})
    np.testing.assert_allclose(float(got), float(exp), rtol=1e-6)


def test_softmax_cross_entropy_and_aux_loss_equal_reference():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, (3, 7))
    mask = rng.random((3, 7)) < 0.5
    for m in (None, mask):
        got = tcommon.softmax_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(targets),
            None if m is None else torch.from_numpy(m))
        exp = rcommon.softmax_cross_entropy(
            jnp.asarray(logits), jnp.asarray(targets),
            None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(exp), rtol=1e-6)
    gl = rng.standard_normal((50, 5)).astype(np.float32)
    np.testing.assert_allclose(
        float(tmoe.aux_load_balance_loss(torch.from_numpy(gl), 2)),
        float(rmoe.aux_load_balance_loss(jnp.asarray(gl), 2)), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_equal_plain_bit_for_bit(arch):
    """``remat`` rebuilds each block in the backward: the same experts are
    chosen again (a stable sort of the same gates) and every gradient is
    the same bit pattern."""
    out = {}
    for remat in (False, True):
        _, tcfg, tree, batch = _setup(arch, remat=remat)
        model = convert.from_reference(tcfg, tree).requires_grad_()
        loss = tapi.loss(tcfg, model, {"tokens": torch.from_numpy(
            batch["tokens"])})
        loss.backward()
        out[remat] = (loss.detach(), [p.grad for p in model.parameters()])
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)


def test_to_reference_inverts_from_reference():
    _, tcfg, tree, _ = _setup("granite-moe-3b-a800m")
    back = convert.to_reference(convert.from_reference(tcfg, tree))
    got, exp = _flat(back), _flat(tree)
    assert got.keys() == exp.keys()
    for k in exp:
        assert np.array_equal(got[k], exp[k]), k


# --- the backward kernels' plain versions -----------------------------------

#: the last two: seamless-m4t's encoder (non-causal, Sq == Sk) and its
#: cross-attention (511 decoder rows over 512 frames), scaled down
ATTN = [(2, 6, 2, 37, 37, 12, True), (2, 4, 4, 16, 48, 16, False),
        (2, 3, 1, 20, 30, 8, True), (1, 4, 1, 9, 9, 8, False),
        (2, 4, 4, 32, 32, 16, False), (2, 4, 4, 31, 32, 16, False)]


@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal", ATTN)
def test_mha_ref_bwd_equals_autograd_float64(b, h, kv, sq, sk, d, causal):
    rng = np.random.default_rng(sq + sk)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((b, h, sq, d), (b, kv, sk, d), (b, kv, sk, d)))
    lens = torch.from_numpy(rng.integers(0, sk + 1, b))
    lens[0] = sk
    o = fref.mha_ref(q, k, v, lens, causal)
    do = torch.from_numpy(rng.standard_normal(o.shape))
    exp = torch.autograd.grad(o, (q, k, v), do)
    got = fref.mha_ref_bwd(q.detach(), k.detach(), v.detach(), o.detach(),
                           do, lens, causal)
    for x, y in zip(got, exp):
        assert x.dtype == torch.float64
        torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-12)
    # a row with no live key (lengths 0) gets zero gradients
    if int(lens.min()) == 0:
        i = int(lens.argmin())
        assert not torch.count_nonzero(got[0][i])


@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal", ATTN)
def test_attention_gradient_equals_reference(b, h, kv, sq, sk, d, causal):
    """``mha_ref_bwd`` against ``jax.vjp`` of the reference's attention
    weights (``_gqa_scores``) times v, float32."""
    rng = np.random.default_rng(sq * 7 + d)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, kv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, kv, sk, d)).astype(np.float32)
    do = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    lens = rng.integers(1, sk + 1, b)
    g = h // kv
    qpos = jnp.broadcast_to(jnp.arange(sq) + (sk - sq), (b, sq))
    valid = jnp.arange(sk)[None, :] < jnp.asarray(lens)[:, None]

    def f(q_, k_, v_):
        w = rattn._gqa_scores(q_.reshape(b, kv, g, sq, d), k_, causal, qpos,
                              valid)
        return jnp.einsum("bkgst,bkth->bkgsh", w, v_).reshape(b, h, sq, d)

    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    exp = vjp(jnp.asarray(do))
    got = fref.mha_ref_bwd(*(torch.from_numpy(x) for x in (q, k, v)),
                           torch.from_numpy(np.array(o)),
                           torch.from_numpy(do), torch.from_numpy(lens),
                           causal)
    for x, y in zip(got, exp):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("e,m,k,n", [(3, 200, 48, 20), (1, 130, 16, 8),
                                     (2, 9, 12, 5)])
def test_matmul_ref_bwd_equals_autograd_float64(e, m, k, n):
    rng = np.random.default_rng(m)
    a = torch.from_numpy(rng.standard_normal((e, m, k))).requires_grad_()
    b = torch.from_numpy(rng.standard_normal((e, k, n))).requires_grad_()
    act = torch.from_numpy(rng.integers(0, 2, (e, -(-m // 128))))
    act[0, 0] = 1
    c = mref.wavefront_matmul_ref(a, b, act)
    dc = torch.from_numpy(rng.standard_normal(c.shape))
    exp = torch.autograd.grad(c, (a, b), dc)
    got = mref.wavefront_matmul_ref_bwd(a.detach(), b.detach(), act, dc)
    for x, y in zip(got, exp):
        torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-12)
    off = ~mref.tile_mask(act, m)
    assert not torch.count_nonzero(got[0][off])


def test_wrappers_differentiate_only_when_asked():
    """Under ``no_grad``, or with no operand requiring a gradient, the
    wrappers take no ``autograd.Function`` (the serve's path); with one,
    the CPU backward is the plain version's, exactly."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 4, 10, 8), (1, 2, 10, 8), (1, 2, 10, 8)))
    a = torch.from_numpy(rng.standard_normal((2, 10, 6)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 6, 3)).astype(np.float32))
    act = torch.ones((2, 1), dtype=torch.int32)
    for t in (q, k, v, a, b):
        t.requires_grad_()
    with torch.no_grad():
        assert fops.flash_attention(q, k, v).grad_fn is None
        assert mops.wavefront_matmul(a, b, act).grad_fn is None
    o = fops.flash_attention(q, k, v)
    do = torch.ones_like(o)
    got = torch.autograd.grad(o, (q, k, v), do)
    exp = fref.mha_ref_bwd(q.detach(), k.detach(), v.detach(), o.detach(),
                           do)
    assert all(torch.equal(x, y) for x, y in zip(got, exp))
    c = mops.wavefront_matmul(a, b, act)
    got = torch.autograd.grad(c, (a, b), torch.ones_like(c))
    exp = mref.wavefront_matmul_ref_bwd(a.detach(), b.detach(), act,
                                        torch.ones_like(c))
    assert all(torch.equal(x, y) for x, y in zip(got, exp))


def test_moe_gather_and_combine_gradients_float64():
    """The expert-ordered gather and combine against autograd of the plain
    indexing, one token chosen by several experts."""
    rng = np.random.default_rng(4)
    flat = torch.from_numpy(rng.standard_normal((12, 5))).requires_grad_()
    topi = torch.from_numpy(np.stack([rng.permutation(12)[:4]
                                      for _ in range(3)]))
    xe = tmoe._Gather.apply(flat, topi)
    g = torch.from_numpy(rng.standard_normal(xe.shape))
    got, = torch.autograd.grad(xe, flat, g)
    ref = flat[topi.reshape(-1)].reshape(3, 4, 5)
    exp, = torch.autograd.grad(ref, flat, g)
    torch.testing.assert_close(got, exp, rtol=1e-12, atol=1e-12)
    ye = torch.from_numpy(rng.standard_normal((3, 4, 5))).requires_grad_()
    out = tmoe._Combine.apply(ye, topi, 12)
    plain = torch.zeros((12, 5), dtype=ye.dtype).index_add(
        0, topi.reshape(-1), ye.reshape(-1, 5))
    torch.testing.assert_close(out, plain, rtol=1e-12, atol=1e-12)
    go = torch.from_numpy(rng.standard_normal((12, 5)))
    got, = torch.autograd.grad(out, ye, go)
    exp, = torch.autograd.grad(plain, ye, go)
    torch.testing.assert_close(got, exp, rtol=1e-12, atol=1e-12)


# --- the serving copy after a training step ----------------------------------

def test_trained_bf16_model_serves_its_updated_weights():
    """A bfloat16 model trained one step: ``prefill`` logits equal those
    of a fresh model built from the updated parameters (the serving copy
    is cast again after the update, not kept from before it)."""
    cfg = tconfigs.get_smoke("granite-moe-3b-a800m")      # bfloat16
    model = convert.from_reference(cfg, convert.numpy_params(cfg, 0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)))
    before, _, _ = model.prefill(tokens)
    ocfg = topt.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, ocfg)
    batch = {"tokens": torch.from_numpy(
        tdata.SyntheticLM(cfg, 4, 16).next_batch(0)["tokens"])}
    model, _, _, m = step(model, topt.init(dict(model.named_parameters()),
                                           ocfg), batch, None)
    assert float(m["finite"]) == 1.0
    after, _, _ = model.prefill(tokens)
    fresh = convert.from_reference(cfg, convert.to_reference(model))
    exp, _, _ = fresh.prefill(tokens)
    assert not torch.equal(after, before)
    assert torch.equal(after, exp)
