"""The port's kernels' plain versions against the JAX package's kernels.

On the CPU the port's wrappers run their plain PyTorch versions; these
are held against the JAX ``ref.py`` oracles and the Pallas kernels in
interpret mode, on the same inputs from a numpy seed:

* ``wavefront_alu``: bit for bit, at the reference tests' shapes and on
  tensors of special values (NaN payloads, +-inf, +-0, subnormals);
* ``dot_product``: at the reference tests' tolerances (rtol 1e-4 f32,
  2e-2 bf16: the sums run in another order) against ``jnp.sum``-based
  oracles, and bit for bit against the reference's ``det_sum`` at 16
  lanes.

The CUDA kernels themselves run only on the card (``test_torch_cuda.py``
and ``chip_smoke.py``).
"""
import numpy as np
import pytest
from _hyp import given, settings, st

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import semantics as rsem  # noqa: E402
from repro.kernels.dot_product import kernel as dpk, ref as dpr  # noqa: E402
from repro.kernels.wavefront_alu import kernel as wak, ref as war  # noqa: E402
from repro_torch.kernels import fp32  # noqa: E402
from repro_torch.kernels.dot_product import ops as tdo  # noqa: E402
from repro_torch.kernels.wavefront_alu import ops as two  # noqa: E402

RNG = np.random.default_rng(11)
SPECIAL = np.array([
    0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
    0x7FA00000, 0xFFB00000, 0x7F800001, 0x00400000, 0x80400000, 1,
    0x807FFFFF, 0x00800000, 0x80800000, 0x3F800000, 0xBF800000,
    0x7F7FFFFF, 0xFF7FFFFF, 0x1F800000], np.uint32)


def _normal(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _special(*shape):
    n = int(np.prod(shape))
    bits = RNG.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    pick = RNG.random(n) < 0.6
    bits[pick] = SPECIAL[RNG.integers(0, len(SPECIAL), pick.sum())]
    return bits.view(np.float32).reshape(shape)


def _bits(x):
    return np.asarray(x).view(np.uint32)


# --- wavefront_alu ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["normal", "special"])
@pytest.mark.parametrize("t,lanes", [(8, 128), (32, 128), (64, 256)])
@pytest.mark.parametrize("op", war.OPS)
def test_wavefront_alu_bit_identical(kind, t, lanes, op):
    mk = _special if kind == "special" else _normal
    a, b, init = mk(t, lanes), mk(t, lanes), mk(t, lanes)
    act = RNG.integers(0, 2, t // 8).astype(np.int32)
    ja = [jnp.asarray(x) for x in (a, b, init, act)]
    ref = war.wavefront_alu_ref(*ja, op)
    got = two.wavefront_alu(*(torch.from_numpy(x) for x in (a, b, init, act)),
                            op)
    assert np.array_equal(_bits(got.numpy()), _bits(ref))
    if kind == "normal" and t == 32:    # the interpret-mode Pallas kernel
        pallas = wak.wavefront_alu(*ja, op, interpret=True)
        assert np.array_equal(_bits(got.numpy()), _bits(pallas))


@pytest.mark.parametrize("rows", [1, 2, 12])
def test_wavefront_alu_ragged_tiles(rows):
    """The port masks a ragged last tile (the TPU kernel asserts T % 8):
    a 32-thread core is 2 rows of 16 lanes."""
    a, b, init = _special(rows, 16), _special(rows, 16), _normal(rows, 16)
    act = RNG.integers(0, 2, -(-rows // 8)).astype(np.int32)
    ref = war.wavefront_alu_ref(*(jnp.asarray(x) for x in (a, b, init, act)),
                                "mul")
    got = two.wavefront_alu(*(torch.from_numpy(x) for x in (a, b, init, act)),
                            "mul")
    assert np.array_equal(_bits(got.numpy()), _bits(ref))


@given(st.lists(st.integers(0, 1), min_size=4, max_size=4))
@settings(max_examples=8, deadline=None)
def test_wavefront_alu_inactive_tiles_keep_init(mask):
    a, b, init = _normal(32, 16), _normal(32, 16), _special(32, 16)
    got = two.wavefront_alu(torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(init),
                            torch.tensor(mask, dtype=torch.int32), "add")
    for i, m in enumerate(mask):
        blk = _bits(got.numpy()[i * 8:(i + 1) * 8])
        exp = _bits((a + b) if m else init)[i * 8:(i + 1) * 8]
        assert np.array_equal(blk, exp)


def test_wavefront_alu_cpu_path_counts_no_launch():
    before = two.wavefront_alu.launches
    x = torch.zeros((8, 16))
    two.wavefront_alu(x, x, x, torch.ones(1, dtype=torch.int32), "max")
    assert two.wavefront_alu.launches == before


def test_wavefront_alu_rejects_bad_input():
    x = torch.zeros((8, 16))
    with pytest.raises(ValueError):
        two.wavefront_alu(x, x, x, torch.ones(1, dtype=torch.int32), "div")
    with pytest.raises(ValueError):
        two.wavefront_alu(x, x, x, torch.ones(2, dtype=torch.int32), "add")
    with pytest.raises(TypeError):
        two.wavefront_alu(x.double(), x, x, torch.ones(1), "add")


# --- dot_product ------------------------------------------------------------

@pytest.mark.parametrize("t,l", [(8, 128), (64, 128), (32, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_product_sweep(t, l, dtype):
    a, b = _normal(t, l), _normal(t, l)
    act = RNG.integers(0, 2, t // 8).astype(np.int32)
    act[0] = 1
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ja, jb = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    ref = dpr.dot_product_ref(ja, jb, jnp.asarray(act))
    pallas = dpk.dot_product(ja, jb, jnp.asarray(act), interpret=True)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if dtype == "bfloat16":
        # the same bf16 rounding as JAX's cast (round to nearest even)
        ta = torch.from_numpy(np.array(ja.astype(jnp.float32))).bfloat16()
        tb = torch.from_numpy(np.array(jb.astype(jnp.float32))).bfloat16()
    got = float(tdo.dot_product(ta, tb, torch.from_numpy(act)))
    rtol = 2e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(got, float(ref), rtol=rtol)
    np.testing.assert_allclose(got, float(pallas), rtol=rtol)


@pytest.mark.parametrize("kind", ["normal", "special"])
@pytest.mark.parametrize("cores,threads", [(1, 32), (1, 512), (5, 64)])
def test_dot_product_matches_det_sum(kind, cores, threads):
    """At 16 lanes, every tile active, the port's dot is the reference's
    DOT: x86-rounded products summed in det_sum order, bit for bit."""
    mk = _special if kind == "special" else _normal
    a, b = mk(cores, threads), mk(cores, threads)
    prod = np.asarray(jnp.asarray(a) * jnp.asarray(b))
    ref = _bits(rsem.det_sum(jnp.asarray(prod)))
    act = torch.ones((cores, -(-threads // 16 // 8)), dtype=torch.int32)
    got = tdo.dot_product(torch.from_numpy(a).view(cores, -1, 16),
                          torch.from_numpy(b).view(cores, -1, 16), act)
    assert np.array_equal(_bits(got.numpy()), ref)


def test_dot_product_skips_inactive_tiles():
    a, b = _normal(2, 32, 16), _normal(2, 32, 16)
    act = torch.tensor([[1, 0, 1, 0], [0, 0, 0, 0]], dtype=torch.int32)
    got = tdo.dot_product(torch.from_numpy(a), torch.from_numpy(b), act)
    keep = np.repeat(act.numpy().astype(bool), 8, axis=1)[..., None]
    exp = np.where(keep, a.astype(np.float64) * b, 0).sum(axis=(1, 2))
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5)
    assert _bits(got.numpy())[1] == 0          # no active tile: +0


def test_fp32_rules_against_xla():
    """The shared float32 rules (DAZ/FTZ, x86 NaN selection, LLVM's
    maximum/minimum) equal XLA:CPU's on special values."""
    a, b = _special(4096), _special(4096)
    ta, tb = (torch.from_numpy(x.view(np.int32)) for x in (a, b))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for f, g in ((fp32.add, jnp.add), (fp32.sub, jnp.subtract),
                 (fp32.mul, jnp.multiply), (fp32.maximum, jnp.maximum),
                 (fp32.minimum, jnp.minimum)):
        ref = _bits(jax.jit(g)(ja, jb))
        assert np.array_equal(f(ta, tb).numpy().view(np.uint32), ref), g
