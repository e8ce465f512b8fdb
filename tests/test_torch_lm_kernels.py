"""The LM kernels' plain PyTorch versions against the JAX package.

``repro_torch.kernels.wavefront_matmul`` and ``.flash_attention`` hold
their plain versions against the reference's ``ref.py`` and against the
Pallas kernels run with ``interpret=True`` (as ``tests/test_kernels.py``
runs them), on the CPU, where the wrappers take the plain versions.
Inputs come from a numpy seed.  Tolerances: float32 ``atol 2e-5``,
bfloat16 ``atol 3e-2`` (the reference tests' own).  The CUDA kernels
themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import kernel as fak, ref as far  # noqa: E402
from repro.kernels.wavefront_matmul import kernel as wmk, ref as wmr  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops, ref as fref  # noqa: E402
from repro_torch.kernels.wavefront_matmul import ops as wops, ref as wref  # noqa: E402

ATOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny tensors: one intra-op thread (restored after the test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(x, dtype):
    """One numpy array as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# --- wavefront_matmul -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 128, 256),
                                   (384, 256, 128)])
def test_wavefront_matmul_plain_equals_reference(m, k, n, dtype):
    rng = np.random.default_rng(m + k + n)
    a = _np(rng, m, k, scale=k ** -0.5)
    b = _np(rng, k, n, scale=k ** -0.5)
    act = rng.integers(0, 2, m // 128).astype(np.int32)
    ja, ta = _both(a, dtype)
    jb, tb = _both(b, dtype)
    got = wops.wavefront_matmul(ta, tb, torch.from_numpy(act))
    assert got.dtype == ta.dtype and got.shape == (m, n)
    exp_ref = wmr.wavefront_matmul_ref(ja, jb, jnp.asarray(act))
    exp_pallas = wmk.wavefront_matmul(ja, jb, jnp.asarray(act),
                                      interpret=True)
    for exp in (exp_ref, exp_pallas):
        np.testing.assert_allclose(_f32(got), _f32(exp), atol=ATOL[dtype])


def test_wavefront_matmul_batched_ragged_equals_reference_per_expert():
    """The port's batch axis (one matrix per expert) and ragged M, N, K:
    each expert's slice equals the reference on that expert, with the
    ragged last row tile counted as a tile."""
    rng = np.random.default_rng(7)
    e, m, k, n = 3, 200, 48, 64
    a, b = _np(rng, e, m, k), _np(rng, e, k, n, scale=k ** -0.5)
    act = np.array([[1, 0], [0, 1], [1, 1]], np.int32)
    got = wops.wavefront_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                torch.from_numpy(act)).numpy()
    for i in range(e):
        pad = np.zeros((256, k), np.float32)
        pad[:m] = a[i]
        exp = wmr.wavefront_matmul_ref(jnp.asarray(pad), jnp.asarray(b[i]),
                                       jnp.asarray(act[i]))
        np.testing.assert_allclose(got[i], np.asarray(exp)[:m], atol=2e-5)


def test_wavefront_matmul_all_inactive_is_zero():
    rng = np.random.default_rng(1)
    a, b = torch.from_numpy(_np(rng, 256, 128)), torch.from_numpy(
        _np(rng, 128, 128))
    got = wops.wavefront_matmul(a, b, torch.zeros(2, dtype=torch.int32))
    assert torch.count_nonzero(got) == 0


def test_wavefront_matmul_rejects_bad_operands():
    a = torch.zeros(4, 8)
    with pytest.raises(TypeError):
        wops.wavefront_matmul(a, torch.zeros(8, 2, dtype=torch.bfloat16),
                              torch.ones(1))
    with pytest.raises(ValueError):
        wops.wavefront_matmul(a, torch.zeros(7, 2), torch.ones(1))
    with pytest.raises(ValueError):
        wops.wavefront_matmul(a, torch.zeros(8, 2), torch.ones(2))


# --- flash_attention --------------------------------------------------------

@pytest.mark.parametrize("sq,sk", [(128, 128), (128, 256), (256, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_equals_reference(sq, sk, causal):
    rng = np.random.default_rng(sq + sk + causal)
    b, h, d = 2, 2, 64
    q, k, v = _np(rng, b, h, sq, d), _np(rng, b, h, sk, d), _np(rng, b, h,
                                                                sk, d)
    lens = np.array([sk, max(1, sk - 100)], np.int32)
    got = fops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(lens),
                               causal)
    jq, jk, jv, jl = (jnp.asarray(x) for x in (q, k, v, lens))
    exp = far.mha_ref(jq, jk, jv, jl, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=2e-5)
    if sq == 128:
        pal = fak.flash_attention(jq, jk, jv, jl, causal, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pal), atol=2e-5)


def test_flash_attention_plain_bf16():
    rng = np.random.default_rng(11)
    b, h, sq, sk, d = 1, 2, 128, 256, 64
    (jq, tq), (jk, tk), (jv, tv) = (_both(_np(rng, b, h, s, d), "bfloat16")
                                    for s in (sq, sk, sk))
    got = fops.flash_attention(tq, tk, tv, None, True)
    assert got.dtype == torch.bfloat16
    exp = far.mha_ref(jq, jk, jv, None, True)
    pal = fak.flash_attention(jq, jk, jv, None, True, interpret=True)
    for e in (exp, pal):
        np.testing.assert_allclose(_f32(got), _f32(e), atol=3e-2)


@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gqa_equals_reference_on_expanded_heads(g, causal):
    """Grouped-query heads: query head h reads KV head h // G, the same as
    the reference on k and v repeated G times; ragged Sq, Sk and D."""
    rng = np.random.default_rng(g)
    b, kv, sq, sk, d = 2, 2, 5, 37, 12
    q, k, v = (_np(rng, b, kv * g, sq, d), _np(rng, b, kv, sk, d),
               _np(rng, b, kv, sk, d))
    lens = np.array([sk, 19], np.int32)
    got = fops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               torch.from_numpy(lens), causal)
    exp = far.mha_ref(jnp.asarray(q), jnp.asarray(np.repeat(k, g, 1)),
                      jnp.asarray(np.repeat(v, g, 1)), jnp.asarray(lens),
                      causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=2e-5)


@pytest.mark.parametrize("nblocks", [1, 3])
def test_flash_attention_poisoned_tail_changes_nothing(nblocks):
    """Keys beyond a request's length never reach its output."""
    rng = np.random.default_rng(nblocks)
    b, h, d = 2, 1, 64
    sk = 128 * nblocks
    q, k, v = (torch.from_numpy(_np(rng, b, h, s, d)) for s in (128, sk, sk))
    ln = torch.tensor([sk // 2, sk], dtype=torch.int32)
    got1 = fops.flash_attention(q, k, v, ln, False)
    k2, v2 = k.clone(), v.clone()
    k2[0, :, sk // 2:] = 1e4
    v2[0, :, sk // 2:] = -1e4
    got2 = fops.flash_attention(q, k2, v2, ln, False)
    np.testing.assert_allclose(got1[0].numpy(), got2[0].numpy(), atol=1e-5)


def test_flash_attention_decode_row():
    """Decode: one query row over a cache, keys ``< lengths`` only, not
    causal; equals the reference's full-width function on that row."""
    rng = np.random.default_rng(5)
    b, h, sk, d = 3, 4, 40, 16
    q, k, v = _np(rng, b, h, 1, d), _np(rng, b, h, sk, d), _np(rng, b, h,
                                                               sk, d)
    lens = np.array([1, 17, 40], np.int32)
    got = fops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               torch.from_numpy(lens), False)
    exp = far.mha_ref(*(jnp.asarray(x) for x in (q, k, v, lens)), False)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=2e-5)


def test_flash_attention_plain_is_fref():
    """The wrapper's CPU path is the plain version (no launch counted)."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(_np(rng, 1, 2, 8, 16))
    before = fops.flash_attention.launches
    got = fops.flash_attention(q, q, q)
    assert torch.equal(got, fref.mha_ref(q, q, q, torch.tensor([8])))
    assert fops.flash_attention.launches == before
    before = wops.wavefront_matmul.launches
    wops.wavefront_matmul(q[0, 0], q[0, 0].T, torch.ones(1))
    assert wops.wavefront_matmul.launches == before
    assert wref.TILE_M == wmk.TILE_M
