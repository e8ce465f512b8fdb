"""Per-opcode differential test: the port's value and condition functions
against the JAX reference's ``build_spec``, bit for bit.

Every opcode x {signed, unsigned} x ``alu_bits`` {16, 32}, over operands
from a numpy seed that include +-0, NaN payloads, +-inf, subnormals and
integer extremes; once with one core's Python-constant fields and once
in the fleet's batched form (fields as ``(B, 1)`` tensors).  Tolerance:
none (bit identity), INVSQR included: the port reproduces XLA:CPU's
``rsqrt`` (the ``vrsqrtps`` estimate from a table made on the test
host's CPU, then two Newton steps).
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import semantics as rsem  # noqa: E402
from repro.core.config import EGPUConfig as RConfig  # noqa: E402
from repro_torch.core import semantics as tsem  # noqa: E402
from repro_torch.core.config import EGPUConfig  # noqa: E402
from repro_torch.core.isa import Op  # noqa: E402

T = 64          # four wavefronts
S = 256         # shared words of the probe config
SPECIAL = np.array([
    0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
    0x7FA00000, 0xFFB00000, 0x7F800001, 0x00400000, 0x80400000, 1,
    0x807FFFFF, 0x00800000, 0x3F800000, 0xBF800000, 0x7F7FFFFF,
    0x7FFFFFFF, 0xFFFFFFFF, 0x00007FFF, 0x00008000, 0x0000FFFF,
    0x00FFFFFF, 0x00800000, 0xFF800001, 30, 31, 32, 16, 0x1F800000],
    np.uint32)

VALUE_OPS = [o for o in Op if o < Op.JMP and o != Op.STO]   # 33 values
COND_OPS = [o for o in Op if o.name.startswith("IF_")]    # 18 conditions


def _cfg(alu_bits):
    kw = dict(max_threads=T, regs_per_thread=16, shared_kb=1,
              alu_bits=alu_bits, shift_bits=alu_bits, predicate_levels=2,
              has_dot=True, has_invsqr=True)
    return RConfig(**kw), EGPUConfig(**kw)


@functools.lru_cache(maxsize=None)
def _operands(seed=0):
    rng = np.random.default_rng(seed)

    def col():
        x = rng.integers(0, 2**32, T, dtype=np.uint64).astype(np.uint32)
        pick = rng.random(T) < 0.5
        x[pick] = SPECIAL[rng.integers(0, len(SPECIAL), pick.sum())]
        return x

    ra, rb = col(), col()
    ra[:8] = rng.integers(-40, S + 40, 8).astype(np.int32).view(np.uint32)
    mask = rng.random(T) < 0.7
    shared = rng.integers(0, 2**32, S, dtype=np.uint64).astype(np.uint32)
    return ra, rb, col(), mask, shared


@functools.lru_cache(maxsize=None)
def _reference(alu_bits, signed):
    """All value/condition results of the JAX reference, jitted once."""
    rcfg, _ = _cfg(alu_bits)
    ra, rb, rd, mask, shared = _operands()

    @jax.jit
    def run(ra, rb, rd, mask, shared, signed, imm, tdx):
        env = rsem.OpEnv(cfg=rcfg, rav=ra, rbv=rb, rdv=rd, signed=signed,
                         imm=imm, mask=mask, tid=jnp.arange(T, dtype=jnp.int32),
                         shared=shared, tdx_dim=tdx)
        spec = rsem.build_spec(env)
        vals = [spec[o][0]().astype(jnp.uint32) for o in VALUE_OPS]
        conds = [spec[o][1]() for o in COND_OPS]
        return vals, conds

    vals, conds = run(jnp.asarray(ra), jnp.asarray(rb), jnp.asarray(rd),
                      jnp.asarray(mask), jnp.asarray(shared),
                      jnp.bool_(signed), jnp.int32(-5), jnp.int32(12))
    return ([np.asarray(v) for v in vals], [np.asarray(c) for c in conds])


def _port(alu_bits, signed, batched):
    _, cfg = _cfg(alu_bits)
    ra, rb, rd, mask, shared = _operands()
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x).view(np.int32)
                                   if x.dtype == np.uint32 else x.copy())
    lead = lambda x: x[None]                  # one core, (1, T)
    sh = torch.cat([t(shared), torch.zeros(1, dtype=torch.int32)])[None]
    env = tsem.OpEnv(
        cfg=cfg, rav=lead(t(ra)), rbv=lead(t(rb)), rdv=lead(t(rd)),
        signed=torch.tensor([[signed]]) if batched else signed,
        imm=torch.tensor([[-5]], dtype=torch.int32) if batched else -5,
        mask=lead(t(mask)), tid=torch.arange(T, dtype=torch.int32),
        shared=sh,
        tdx_dim=torch.tensor([[12]], dtype=torch.int32) if batched else 12)
    return tsem.build_spec(env)


def _case_params(ops):
    out = []
    for o in ops:
        for bits in (16, 32):
            for signed in (False, True):
                out.append(pytest.param(o, bits, signed,
                                        id=f"{o.name}-alu{bits}-"
                                        f"{'s' if signed else 'u'}"))
    return out


@pytest.mark.parametrize("op,alu_bits,signed", _case_params(VALUE_OPS))
def test_value_bit_identical(op, alu_bits, signed):
    ref = _reference(alu_bits, signed)[0][VALUE_OPS.index(op)]
    for batched in (False, True):
        got = _port(alu_bits, signed, batched)[op][0]()
        got = got.reshape(-1).numpy().view(np.uint32)
        bad = np.nonzero(got != ref)[0]
        assert bad.size == 0, (
            f"{op.name} batched={batched}: {bad.size} lanes differ, first "
            f"{hex(int(got[bad[0]]))} vs {hex(int(ref[bad[0]]))}")


@pytest.mark.parametrize("op,alu_bits,signed", _case_params(COND_OPS))
def test_condition_identical(op, alu_bits, signed):
    ref = _reference(alu_bits, signed)[1][COND_OPS.index(op)]
    for batched in (False, True):
        got = _port(alu_bits, signed, batched)[op][1]().reshape(-1).numpy()
        assert np.array_equal(got, ref), f"{op.name} batched={batched}"


def test_invsqr_within_one_ulp():
    """INVSQR is XLA:CPU's rsqrt bit for bit (0 ulps) on 200,000 inputs:
    100,000 uniform in [1e-30, 1e30], 100,000 random bit patterns (every
    class: negatives, subnormals, NaN payloads), plus the special
    values."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2**32, 100000, dtype=np.uint64).astype(np.uint32)
    x = np.concatenate([rng.uniform(1e-30, 1e30, 100000).astype(np.float32),
                        bits.view(np.float32), SPECIAL.view(np.float32)])
    ref = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(x)))
    got = tsem.fp32.rsqrt(torch.from_numpy(x.view(np.int32))).numpy()
    bad = np.nonzero(got != ref.view(np.int32))[0]
    assert bad.size == 0, (f"{bad.size} differ, first x={x[bad[0]]!r}: "
                           f"{hex(got[bad[0]])} vs {ref[bad[0]]!r}")


def test_det_sum_matches_reference():
    rng = np.random.default_rng(5)
    v = rng.standard_normal((3, T)).astype(np.float32)
    v[0, 5] = np.float32(-0.0)
    v[1, :] = -0.0
    ref = np.asarray(rsem.det_sum(jnp.asarray(v))).view(np.uint32)
    got = tsem.det_sum(torch.from_numpy(v.view(np.int32))).numpy()
    assert np.array_equal(got.view(np.uint32), ref)


@pytest.mark.parametrize("n", [4, 8])
def test_stack_gather_rules(n):
    """call_top/loop_step index like JAX's gather: a negative index wraps
    once, then clamps."""
    stack = np.arange(100, 100 + n, dtype=np.int32)
    for sp in range(-2 * n - 2, 2 * n + 3):
        ref = int(rsem.call_top(jnp.asarray(stack), jnp.int32(sp)))
        assert tsem.call_top(stack.tolist(), sp) == ref, sp
        lctr, ltaken, lsp = rsem.loop_step(jnp.asarray(stack), jnp.int32(sp))
        mine = stack.tolist()
        taken, new_sp = tsem.loop_step(mine, sp)
        assert mine == np.asarray(lctr).tolist() and taken == bool(ltaken)
        assert new_sp == (sp if taken else int(lsp))


def test_store_highest_tid_wins_and_drops():
    sh = torch.zeros((2, S + 1), dtype=torch.int32)
    sidx = torch.tensor([[3, 3, 3, S, 7], [3, S, 9, 9, 9]], dtype=torch.int32)
    val = torch.arange(10, dtype=torch.int32).reshape(2, 5)
    tsem.store(sh, sidx, val)
    assert sh[0, 3] == 2 and sh[0, 7] == 4
    assert sh[1, 3] == 5 and sh[1, 9] == 9
    assert int(sh[:, :S].count_nonzero()) == 4
