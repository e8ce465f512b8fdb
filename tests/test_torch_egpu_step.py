"""The step forms of the eGPU kernels on the main path, against the JAX
reference.

The port runs each FP step (FADD/FSUB/FMUL/FMAX/FMIN) as one launch of
the ``wavefront_alu`` kernel's ``step`` route and each DOT/SUM step as
one of ``dot_product``'s, in place on the register file; on the CPU the
same call runs their plain versions (``fp_step_ref``, ``ext_step_ref``).
Held here, on the CPU, against the reference (tolerance: none, bit for
bit):

* every ``MachineState`` leaf of ``run_program`` against the
  reference's, for a program that runs every FP opcode, DOT and SUM with
  ``rd == ra``, ``rd == rb``, narrow TSC codes and nested active
  predicates, over special values (+-0, NaN payloads, subnormals,
  +-inf), on 512-thread configurations (``dp``, ``alu16``, ``pred2``) at
  16, 48, 112 and 512 runtime threads (ragged last 128-thread tiles; the
  runtime thread count is whole 16-lane wavefronts, and the reference
  rejects any other) and on thread 0 alone (the ``mcu`` TSC code);
* each step form alone against the reference's value function and
  register write-back rule (``executor.py``: thread 0 for DOT/SUM, the
  write mask for the rest), a core that runs another opcode untouched;
* a ``fleet_run`` batch whose cores mix FP, DOT, SUM, integer, LOD, STO,
  IF and NOP in the same steps (the torch ops' write-back and the step
  kernels share a step), every core's leaves against the reference's
  ``run_program`` of its job.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _torch_port as tp  # noqa: E402
from repro.core import Asm as RAsm, EGPUConfig as RCfg  # noqa: E402
from repro.core import run_program as ref_run  # noqa: E402
from repro.core import semantics as rsem  # noqa: E402
from repro_torch.core import Asm, EGPUConfig, Op, executor, run_program  # noqa: E402
from repro_torch.core.machine import state_to_numpy  # noqa: E402
from repro_torch.fleet import fleet_run, unstack_state  # noqa: E402
from repro_torch.kernels import egpu_step  # noqa: E402
from repro_torch.kernels.dot_product import ops as dops  # noqa: E402
from repro_torch.kernels.wavefront_alu import ops as wops  # noqa: E402

T = 512
BASE = dict(tp.CFG_KW, max_threads=T, shared_kb=8)
CONFIGS = {"dp": {}, "alu16": {"alu_bits": 16, "shift_bits": 16},
           "pred2": {"predicate_levels": 2}}
THREADS = (16, 48, 112, 512)
SPECIAL = np.array([
    0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
    0x7FA00000, 0xFFB00000, 0x7F800001, 0x00400000, 0x80400000, 1,
    0x807FFFFF, 0x00800000, 0x80800000, 0x3F800000, 0xBF800000,
    0x7F7FFFFF, 0xFF7FFFFF, 0x1F800000, 0x20000000], np.uint32)
STEP_OPS = ("FADD", "FSUB", "FMUL", "FMAX", "FMIN", "DOT", "SUM")


def _bits(rng, n):
    """float32 bit patterns: special values, normals and random bits."""
    x = rng.standard_normal(n).astype(np.float32).view(np.uint32)
    pick = rng.random(n)
    x[pick < 0.5] = SPECIAL[rng.integers(0, len(SPECIAL), (pick < 0.5).sum())]
    wild = pick > 0.9
    x[wild] = rng.integers(0, 2**32, wild.sum(), dtype=np.uint64)
    return x


def _configs(name):
    kw = {**BASE, **CONFIGS[name]}
    return RCfg(**kw), EGPUConfig(**kw)


def _shared(seed):
    return _bits(np.random.default_rng(seed), 3 * T)


def _program(a):
    """Every FP opcode, DOT and SUM; rd == ra and rd == rb; narrow TSC
    codes; two levels of active predicates."""
    a.tdx(1)
    a.lod(2, 1, 0)
    a.lod(3, 1, T)
    a.lod(15, 1, 2 * T)
    a.fadd(4, 2, 3)
    a.fsub(5, 2, 3)
    a.fmul(6, 2, 3)
    a.fmax(7, 2, 3)
    a.fmin(8, 2, 3)
    a.dot(9, 2, 3)
    a.sum_(10, 3)
    a.fadd(2, 2, 15)                     # rd == ra
    a.fmul(3, 15, 3)                     # rd == rb
    a.fmin(15, 15, 15)                   # rd == ra == rb
    a.fmax(11, 2, 3, tsc="wf0")
    a.fsub(12, 3, 2, tsc="cpu")
    a.dot(13, 3, 4, tsc="quarter")
    a.sum_(14, 5, tsc="half_depth")
    a.fadd(23, 2, 3, tsc="mcu")          # thread 0 alone
    a.dot(24, 3, 2, tsc="mcu")
    a.dot(2, 2, 3)                       # DOT, rd == ra
    a.sum_(3, 3)                         # SUM, rd == ra
    a.if_("flt", 4, 5)
    a.fadd(16, 4, 5)
    a.dot(17, 4, 5)
    a.sum_(18, 6)
    a.fmul(19, 4, 4)
    a.else_()
    a.fsub(16, 5, 4)
    a.sum_(17, 4)
    a.if_("fge", 6, 7)
    a.fmax(20, 6, 7)
    a.fmin(21, 6, 7)
    a.dot(22, 6, 7)
    a.endif()
    a.endif()
    a.stop()
    return a


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_program_step_forms_leaves_equal(name, threads):
    rcfg, pcfg = _configs(name)
    shared = _shared(threads)
    ri = _program(RAsm(rcfg)).assemble(threads_active=threads)
    pi = _program(Asm(pcfg)).assemble(threads_active=threads)
    ref = ref_run(ri, shared_init=shared, tdx_dim=16)
    got = run_program(pi, shared_init=shared, tdx_dim=16, device="cpu")
    tp.assert_leaves_equal(tp.reference_leaves(ref), state_to_numpy(got),
                           f"{name}/{threads}")


# --- each step form alone ----------------------------------------------------

def _step_case(op_name, with_pred, seed):
    """A (B=3, T=64, R=8) register file of special values; core 0 runs
    ``op_name``, core 1 runs it with rd == ra, core 2 runs ADD."""
    rng = np.random.default_rng(seed)
    B, TT, R = 3, 64, 8
    regs = _bits(rng, B * TT * R).view(np.int32).reshape(B, TT, R)
    masks = rng.random((B, 16, TT)) < 0.7
    pred = (rng.random((B, TT)) < 0.6) if with_pred else None
    op = int(Op[op_name])
    rows = np.zeros((B, 7), np.int64)
    rows[:, 0] = (op, op, int(Op.ADD))
    rows[:, 2:5] = ((5, 1, 2), (3, 3, 4), (6, 1, 2))     # rd, ra, rb
    rows[:, 6] = rng.integers(0, 16, B)
    return regs, rows, masks, pred


def _reference_step(op_name, regs, rows, masks, pred):
    """The reference's value function and register write-back rule, one
    core at a time, in JAX."""
    out = regs.copy()
    TT = regs.shape[1]
    cfg = RCfg(**{**tp.CFG_KW, "max_threads": TT})
    for b in range(2):                   # the cores that run the op
        _, _typ, rd, ra, rb, imm, tsc = (int(v) for v in rows[b])
        m = masks[b, tsc] & (True if pred is None else pred[b])
        col = lambda r: jnp.asarray(regs[b, :, r].view(np.uint32))
        env = rsem.OpEnv(cfg=cfg, rav=col(ra), rbv=col(rb), rdv=col(rd),
                         signed=jnp.bool_(False), imm=jnp.int32(imm),
                         mask=jnp.asarray(m),
                         tid=jnp.arange(TT, dtype=jnp.int32),
                         shared=jnp.zeros(16, jnp.uint32),
                         tdx_dim=jnp.int32(16))
        value = np.asarray(rsem.build_spec(env)[Op[op_name]][0]())
        wmask = (np.arange(TT) == 0) if op_name in ("DOT", "SUM") else m
        out[b, :, rd] = np.where(wmask, value.astype(np.uint32).view(np.int32),
                                 regs[b, :, rd])
    return out


@pytest.mark.parametrize("with_pred", [False, True], ids=["nopred", "pred"])
@pytest.mark.parametrize("op_name", STEP_OPS)
def test_step_form_equals_reference_step(op_name, with_pred):
    regs, rows, masks, pred = _step_case(op_name, with_pred,
                                         STEP_OPS.index(op_name))
    exp = _reference_step(op_name, regs, rows, masks, pred)
    got = torch.from_numpy(regs.copy())
    t = lambda x: None if x is None else torch.from_numpy(x)
    if op_name in ("DOT", "SUM"):
        dops.ext_step(got, t(rows), t(masks), t(pred), executor.EXT_OPCODES)
    else:
        wops.fp_step(got, t(rows), t(masks), t(pred), executor.FP_OPCODES)
    assert np.array_equal(got.numpy(), exp)


def test_step_forms_count_no_launch_on_cpu_and_check_their_arguments():
    regs, rows, masks, pred = _step_case("FADD", True, 0)
    before = (wops.wavefront_alu.launches, dict(wops.wavefront_alu.by_route),
              dops.dot_product.launches, dict(dops.dot_product.by_route))
    r, tr, m, p = (torch.from_numpy(x) for x in (regs, rows, masks, pred))
    wops.fp_step(r, tr, m, p, executor.FP_OPCODES)
    dops.ext_step(r, tr, m, None, executor.EXT_OPCODES)
    assert before == (wops.wavefront_alu.launches,
                      wops.wavefront_alu.by_route, dops.dot_product.launches,
                      dops.dot_product.by_route)
    with pytest.raises(TypeError):
        wops.fp_step(r.float(), tr, m, p, executor.FP_OPCODES)
    with pytest.raises(ValueError):
        dops.ext_step(r, tr.int(), m, p, executor.EXT_OPCODES)
    with pytest.raises(ValueError):
        wops.fp_step(r, tr, m[:, :8], p, executor.FP_OPCODES)
    with pytest.raises(ValueError):
        dops.ext_step(r[:, :40], tr, m[..., :40], None, executor.EXT_OPCODES)
    with pytest.raises(RuntimeError):
        wops.fp_step_launcher(r, m, executor.FP_OPCODES)     # not on a card
    assert egpu_step.pack_opcodes(executor.FP_OPCODES) == sum(
        o << (8 * k) for k, o in enumerate(executor.FP_OPCODES))
    assert [Op(o).name for o in executor.FP_OPCODES] == list(STEP_OPS[:5])
    assert [Op(o).name for o in executor.EXT_OPCODES] == ["DOT", "SUM"]


# --- a fleet step that mixes every kind of op ---------------------------------

#: one instruction each; core k runs them rotated by k, so every step of
#: the batch mixes FP, DOT, SUM, integer, LOD, STO and NOP
SLOTS = (lambda a: a.fadd(4, 2, 3), lambda a: a.fsub(5, 3, 2),
         lambda a: a.fmul(2, 2, 3), lambda a: a.fmax(6, 3, 2),
         lambda a: a.fmin(3, 2, 3), lambda a: a.dot(7, 2, 3),
         lambda a: a.sum_(8, 3), lambda a: a.add(4, 1, 1),
         lambda a: a.lod(5, 1, 2 * T), lambda a: a.sto(4, 1, 2 * T + 64),
         lambda a: a.nop(), lambda a: a.dot(2, 2, 5),
         lambda a: a.fadd(9, 7, 8))


def _fleet_program(a, k, stop_after=None):
    a.tdx(1)
    a.lod(2, 1, 0)
    a.lod(3, 1, T)
    a.if_("flt" if k % 2 else "z", 2 if k % 2 else 0, 3)
    for j in range(len(SLOTS)):
        if j == stop_after:
            a.stop()
        SLOTS[(j + k) % len(SLOTS)](a)
    a.endif()
    a.stop()
    return a


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fleet_step_mixing_every_kind_of_op(name):
    rcfg, pcfg = _configs(name)
    n = len(SLOTS)
    jobs = [(k, THREADS[k % len(THREADS)], None) for k in range(n)]
    jobs.append((3, 112, 4))             # halts early: NOP rows after
    shared = [_shared(100 + i) for i in range(len(jobs))]
    asm = lambda A, cfg, k, th, stop: _fleet_program(A(cfg), k, stop) \
        .assemble(threads_active=th, schedule_nops=False)
    out = fleet_run([asm(Asm, pcfg, *j) for j in jobs],
                    init_kw=[dict(shared_init=s, tdx_dim=16) for s in shared],
                    device="cpu")
    for i, (j, s) in enumerate(zip(jobs, shared)):
        ref = ref_run(asm(RAsm, rcfg, *j), shared_init=s, tdx_dim=16)
        tp.assert_leaves_equal(tp.reference_leaves(ref),
                               state_to_numpy(unstack_state(out, i)),
                               f"{name}/core {i}")
