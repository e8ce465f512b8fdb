"""The gradients of zamba2, xlstm, seamless-m4t and internvl2 against the
JAX reference's, on the CPU.

``repro_torch.models.api.loss`` and ``jax.value_and_grad`` of
``repro.models.api.loss`` take one set of numpy weights
(``convert.numpy_params``) and one ``SyntheticLM`` batch (tokens, and
frames or patches); every parameter leaf's gradient, the port's laid out
as the reference's by ``convert.to_reference`` (zamba2's shared block
once, xlstm's ``blocks`` a list of two kinds of layer), is held to the
reference's.  Configs: the four smoke configs, and xlstm at 8 layers
(its layer 7 is an sLSTM; the smoke config's 3 layers hold none).

Bounds, float32: ``tests/test_torch_lm_grad.py``'s rtol 1e-4 with an atol
of 1e-5 of the leaf's largest gradient, but where the forward's float32
bound is loosened (``tests/test_torch_families.py``), for the same
reason: zamba2's SSD sums over a chunk in another order and takes
``exp`` of differences of cumulative sums, an atol of 5e-5 of the leaf's
largest gradient (measured: 2.1e-5, the embedding's, whose rows sum
over the tokens); xlstm at 8 layers, whose stabilisers are running sums
inside ``exp``, 1e-4 of it (measured: 6.2e-5).  bfloat16: two runs that
round at other places; the port's leaf (relative L2 distance) is held
within sqrt(2) times the reference's own bfloat16 leaf's distance from
the reference's float32 leaf (two independent roundings of that size
differ by about sqrt(2) times it; measured: 1.13 times at most).

Also: ``attend`` with ``causal=False``, ``kv_x`` and ragged
``kv_lengths`` against the reference's ``attend`` (the plain attention
backward alone at these shapes is ``tests/test_torch_lm_grad.py``'s);
the SSD's chunked scan (one chunk and several), the mLSTM's parallel
form and the sLSTM's loop against ``jax.vjp`` of the reference's;
``remat`` gradients equal plain ones bit for bit in each family.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import api as rapi, attention as rattn  # noqa: E402
from repro.models import mamba2 as rmamba, xlstm as rxl  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import api as tapi, attention as tattn  # noqa: E402
from repro_torch.models import convert, mamba2 as tmamba  # noqa: E402
from repro_torch.models import transformer, xlstm as txl  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402

#: case -> (architecture, overrides of its smoke config)
CASES = {"zamba2-1p2b": ("zamba2-1p2b", {}),
         "xlstm-350m": ("xlstm-350m", {}),
         "xlstm-350m-8-layers": ("xlstm-350m", {"n_layers": 8}),
         "seamless-m4t-large-v2": ("seamless-m4t-large-v2", {}),
         "internvl2-2b": ("internvl2-2b", {})}
ARCHS = ["zamba2-1p2b", "xlstm-350m", "seamless-m4t-large-v2",
         "internvl2-2b"]
#: float32 atol, as a share of the leaf's largest gradient, where the
#: forward's bound is loosened (see the module docstring)
F32_ATOL = {"zamba2-1p2b": 5e-5, "xlstm-350m-8-layers": 1e-4}
#: bfloat16: the port's distance from the reference's bfloat16 gradient
#: over the reference's own bfloat16 distance from its float32 gradient
BF16_RATIO = 2 ** 0.5


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny tensors: one intra-op thread (restored after the test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32", **kw):
    return (rconfigs.get_smoke(arch).replace(dtype=getattr(jnp, dtype), **kw),
            tconfigs.get_smoke(arch).replace(dtype=getattr(torch, dtype),
                                             **kw))


def _flat(tree, prefix=""):
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _batch(tcfg):
    return tdata.SyntheticLM(tcfg, 4, 24, seed=3).next_batch(0)


@functools.lru_cache(maxsize=None)
def _grads(case, dtype, side):
    """(loss, {leaf path: gradient}) of ``side`` ("port" or "ref")."""
    arch, kw = CASES[case]
    rcfg, tcfg = _cfgs(arch, dtype, **kw)
    tree = convert.numpy_params(tcfg, 0)
    batch = _batch(tcfg)
    if side == "ref":
        loss, g = jax.jit(jax.value_and_grad(lambda p, bt: rapi.loss(
            rcfg, p, bt)))(jax.tree.map(jnp.asarray, tree),
                           {k: jnp.asarray(v) for k, v in batch.items()})
        return float(loss), _flat(jax.tree.map(np.asarray, g))
    model = convert.from_reference(tcfg, tree).requires_grad_()
    loss = tapi.loss(tcfg, model, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    loss.backward()
    g = transformer.tree_map(lambda p: p.grad, model.params())
    return float(loss.detach()), _flat(convert.to_reference(g, tcfg))


@pytest.mark.parametrize("case", CASES)
def test_loss_gradients_equal_reference_float32(case):
    loss, got = _grads(case, "float32", "port")
    rloss, exp = _grads(case, "float32", "ref")
    np.testing.assert_allclose(loss, rloss, rtol=1e-6)
    assert got.keys() == exp.keys()
    share = F32_ATOL.get(case, 1e-5)
    for k in exp:
        assert got[k].shape == exp[k].shape, k
        atol = share * float(np.abs(exp[k]).max())
        np.testing.assert_allclose(got[k], exp[k], rtol=1e-4, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_loss_gradients_bf16_within_reference_rounding(case):
    """bfloat16: the loss within ``train.TOLERANCE``'s 2e-3; each leaf no
    further from the reference's bfloat16 gradient than sqrt(2) times the
    reference's own bfloat16 leaf is from its float32 leaf."""
    loss, got = _grads(case, "bfloat16", "port")
    rloss, exp = _grads(case, "bfloat16", "ref")
    _, exact = _grads(case, "float32", "ref")
    np.testing.assert_allclose(loss, rloss, rtol=2e-3)
    assert got.keys() == exp.keys()
    for k in exp:
        assert got[k].shape == exp[k].shape, k
        ours = np.linalg.norm(got[k] - exp[k])
        theirs = np.linalg.norm(exp[k] - exact[k])
        assert ours <= BF16_RATIO * theirs, (
            f"{k}: {ours:.3g} from the reference's bfloat16 gradient, whose "
            f"own distance from its float32 gradient is {theirs:.3g}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_equal_plain_bit_for_bit(arch, dtype):
    """``remat`` (``torch.utils.checkpoint`` of each Mamba2 layer, xLSTM
    block, encoder and decoder layer, VLM block) rebuilds the same
    activations in the backward: the loss and every gradient are the same
    bit pattern."""
    out = {}
    for remat in (False, True):
        _, tcfg = _cfgs(arch, dtype, remat=remat)
        model = convert.from_reference(
            tcfg, convert.numpy_params(tcfg, 0)).requires_grad_()
        loss = tapi.loss(tcfg, model, {k: torch.from_numpy(v) for k, v in
                                       _batch(tcfg).items()})
        loss.backward()
        out[remat] = (loss.detach(), [p.grad for p in model.parameters()])
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS + ["xlstm-8"])
def test_to_reference_inverts_from_reference(arch):
    kw = {"n_layers": 8} if arch == "xlstm-8" else {}
    _, tcfg = _cfgs("xlstm-350m" if arch == "xlstm-8" else arch, **kw)
    tree = convert.numpy_params(tcfg, 0)
    back = convert.to_reference(convert.from_reference(tcfg, tree))
    got, exp = _flat(back), _flat(tree)
    assert got.keys() == exp.keys()
    for k in exp:
        assert np.array_equal(got[k], exp[k]), k


# --- the attention backward at the families' shapes --------------------------

def _vjp_check(rfn, tfn, args, seed, atol_share=1e-5):
    """``jax.vjp`` of ``rfn`` against autograd of ``tfn`` on the same
    numpy ``args`` (arrays or trees of them) and a random cotangent,
    float32: every gradient within rtol 1e-4 and an atol of
    ``atol_share`` of its largest value."""
    out, vjp = jax.vjp(jax.jit(rfn), *jax.tree.map(jnp.asarray, args))
    ct = np.random.default_rng(seed).standard_normal(out.shape).astype(
        np.float32)
    exp = _flat(list(jax.tree.map(np.asarray, vjp(jnp.asarray(ct)))))
    targs = jax.tree.map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).requires_grad_(),
        args)
    tout = tfn(*targs)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out),
                               rtol=1e-4, atol=1e-4)
    leaves = jax.tree.leaves(targs)
    grads = torch.autograd.grad(tout, leaves, torch.from_numpy(ct),
                                allow_unused=True)
    grads = [torch.zeros_like(t) if gr is None else gr
             for t, gr in zip(leaves, grads)]
    got = _flat(list(jax.tree.map(lambda t: t.numpy(), jax.tree.unflatten(
        jax.tree.structure(targs), grads))))
    assert got.keys() == exp.keys()
    for k in exp:
        atol = atol_share * float(np.abs(exp[k]).max())
        np.testing.assert_allclose(got[k], exp[k], rtol=1e-4, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("kind", ["self non-causal", "cross"])
def test_attend_vjp_equals_reference(kind):
    """``attention.attend`` (through ``flash_attention``'s autograd and
    ``mha_ref_bwd`` on the CPU) against the reference's ``attend``: the
    encoder's non-causal self-attention over a ragged batch, and the
    decoder's cross-attention of 15 rows over 16 frames; gradients of the
    input(s) and of every weight."""
    rcfg, tcfg = _cfgs("seamless-m4t-large-v2")
    tree = convert.numpy_params(tcfg, 0)
    p = jax.tree.map(lambda a: a[0], tree["dec"]["cross_attn"] if
                     kind == "cross" else tree["enc"]["attn"])
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 15 if kind == "cross" else 16,
                             tcfg.d_model)).astype(np.float32)
    kv_x = rng.standard_normal((2, 16, tcfg.d_model)).astype(np.float32)
    lens = np.array([16, 11])
    b, s = x.shape[:2]
    rpos = jnp.broadcast_to(jnp.arange(s), (b, s))
    tpos = torch.arange(s).expand(b, s)
    valid = jnp.arange(16)[None, :] < jnp.asarray(lens)[:, None]
    tl = torch.from_numpy(lens).to(torch.int32)
    if kind == "cross":
        _vjp_check(lambda p_, x_, kx: rattn.attend(
                       rcfg, p_, x_, rpos, causal=False, kv_x=kx,
                       kv_valid=valid),
                   lambda p_, x_, kx: tattn.attend(
                       tcfg, p_, x_, tpos, causal=False, kv_x=kx,
                       kv_lengths=tl), (p, x, kv_x), 1)
    else:
        _vjp_check(lambda p_, x_: rattn.attend(rcfg, p_, x_, rpos,
                                               causal=False, kv_valid=valid),
                   lambda p_, x_: tattn.attend(tcfg, p_, x_, tpos,
                                               causal=False, kv_lengths=tl),
                   (p, x), 2)


# --- the recurrent blocks' backward ------------------------------------------

@pytest.mark.parametrize("chunks", [1, 4])
def test_ssd_vjp_equals_reference(chunks, monkeypatch):
    """The chunked SSD scan (``_segsum``, ``exp(segsum)``, the chunk
    states and their scan): one chunk (S = 24) and four (CHUNK set to 16
    in both packages, S = 64); the atol of zamba2's loosened bound."""
    if chunks > 1:
        monkeypatch.setattr(rmamba, "CHUNK", 16)
        monkeypatch.setattr(tmamba, "CHUNK", 16)
    rcfg, tcfg = _cfgs("zamba2-1p2b")
    tree = convert.numpy_params(tcfg, 0)
    p = jax.tree.map(lambda a: a[0], tree["mamba"])
    rng = np.random.default_rng(chunks)
    # gates away from zero, so that the decays differ by position
    p = dict(p, a_log=rng.standard_normal(p["a_log"].shape).astype(
        np.float32) * 0.5, dt_bias=rng.standard_normal(
        p["dt_bias"].shape).astype(np.float32) * 0.5)
    u = rng.standard_normal((2, 24 if chunks == 1 else 64,
                             tcfg.d_model)).astype(np.float32)
    _vjp_check(lambda p_, u_: rmamba.ssd_apply(rcfg, p_, u_),
               lambda p_, u_: tmamba.ssd_apply(tcfg, p_, u_), (p, u), 3,
               F32_ATOL["zamba2-1p2b"])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_block_vjp_equals_reference(kind):
    """The mLSTM's parallel form (``cumsum``, ``cummax`` and the gate-decay
    matrix) and the sLSTM's loop over time, each block's input and weight
    gradients."""
    rcfg, tcfg = _cfgs("xlstm-350m", n_layers=8)
    tree = convert.numpy_params(tcfg, 0)
    p = tree["blocks"][7 if kind == "slstm" else 0]
    x = np.random.default_rng(4).standard_normal(
        (2, 12, tcfg.d_model)).astype(np.float32)
    rfn, tfn = ((rxl.slstm_apply, txl.slstm_apply) if kind == "slstm"
                else (rxl.mlstm_apply, txl.mlstm_apply))
    _vjp_check(lambda p_, x_: rfn(rcfg, p_, x_),
               lambda p_, x_: tfn(tcfg, p_, x_), (p, x), 5)
