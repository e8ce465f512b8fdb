"""The port's interpreter (``repro_torch.core.run_program``) against the
JAX reference's ``run_program``: every ``MachineState`` leaf equal, bit
for bit (tolerance: none), for the ``test_blockc.py`` suite x CONFIGS,
on the CPU; plus the control-flow, divergence and memory corners, and
the device rule of the entry points.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_port as tp  # noqa: E402
from repro import programs as rprog  # noqa: E402
from repro.core import Asm as RAsm, EGPUConfig as RCfg  # noqa: E402
from repro.core import Typ as RTyp  # noqa: E402
from repro.core import run_program as ref_run  # noqa: E402
from repro.core.executor import pad_image as ref_pad  # noqa: E402
from repro_torch import programs as tprog  # noqa: E402
from repro_torch.core import Asm, EGPUConfig, Typ, run_program  # noqa: E402
from repro_torch.core.executor import pad_image  # noqa: E402
from repro_torch.core.machine import (init_state, state_from_numpy,  # noqa: E402
                                      state_to_numpy)


def _pair(name, i):
    rb = tp.suite(rprog, tp.config(RCfg, name))
    pb = tp.suite(tprog, tp.config(EGPUConfig, name))
    return rb[i], pb[i]


@pytest.mark.parametrize("name,i", tp.suite_ids(),
                         ids=[f"{n}-{i}" for n, i in tp.suite_ids()])
def test_run_program_leaves_equal(name, i):
    rb, pb = _pair(name, i)
    assert rb.name == pb.name
    assert np.array_equal(ref_pad(rb.image)[0], pad_image(pb.image)[0])
    ref = ref_run(rb.image, shared_init=rb.shared_init, tdx_dim=rb.tdx_dim)
    got = run_program(pb.image, shared_init=pb.shared_init,
                      tdx_dim=pb.tdx_dim, device="cpu")
    tp.assert_leaves_equal(tp.reference_leaves(ref), state_to_numpy(got),
                           f"{name}/{pb.name}")


def test_validate_false_leaves_equal():
    rb, pb = _pair("dp", 0)
    ref = ref_run(rb.image, validate=False, shared_init=rb.shared_init,
                  tdx_dim=rb.tdx_dim)
    got = run_program(pb.image, validate=False, shared_init=pb.shared_init,
                      tdx_dim=pb.tdx_dim, device="cpu")
    tp.assert_leaves_equal(tp.reference_leaves(ref), state_to_numpy(got),
                           "validate=False")


def _both(build, threads=32, tdx=32, shared=None, **cfg_kw):
    """Assemble one program with both packages and run both."""
    rcfg = tp.config(RCfg, "dp").replace(**cfg_kw)
    pcfg = tp.config(EGPUConfig, "dp").replace(**cfg_kw)
    ri = build(RAsm(rcfg), RTyp).assemble(threads_active=threads)
    pi = build(Asm(pcfg), Typ).assemble(threads_active=threads)
    ref = ref_run(ri, tdx_dim=tdx, shared_init=shared)
    got = run_program(pi, tdx_dim=tdx, shared_init=shared, device="cpu")
    return tp.reference_leaves(ref), state_to_numpy(got)


def test_control_flow_corners():
    """JSR/RTS, nested predicates with ELSE, a LOOP chain (the program of
    test_blockc.py's test_control_flow_corners)."""
    def build(a, T):
        a.tdx(1)
        a.lodi(2, 8)
        a.lodi(5, 1)
        a.lodi(6, 0)
        a.if_("lt", 1, 2, typ=T.U32)
        with a.loop(3):
            a.jsr("incr")
        a.else_()
        a.lodi(6, 99)
        a.endif()
        a.sto(6, 1, 0)
        a.stop()
        a.label("incr")
        a.add(6, 6, 5)
        a.rts()
        return a
    ref, got = _both(build)
    tp.assert_leaves_equal(ref, got, "control-flow")
    assert np.array_equal(got["shared"][:32],
                          np.where(np.arange(32) < 8, 3, 99))


def test_unbalanced_stacks_follow_gather_rules():
    """RTS with an empty call stack and LOOP with no INIT read the slot
    JAX's gather picks (negative index wraps once, then clamps)."""
    def build(a, T):
        a.lodi(1, 3)
        a.rts()
        a.stop()
        return a
    # the RTS jumps back to 0 forever: the run ends at max_steps
    ref, got = _both(build, max_steps=101)
    tp.assert_leaves_equal(ref, got, "rts-underflow")
    assert got["steps"] == 101 and not got["halted"]

    def build2(a, T):
        a.label("top")
        a.lodi(1, 3)
        a.loop_("top")
        a.init(2)
        a.init(1)
        a.stop()
        return a
    ref, got = _both(build2)
    tp.assert_leaves_equal(ref, got, "loop-underflow")


def test_duplicate_sto_highest_tid_wins_and_out_of_range_dropped():
    def build(a, T):
        a.tdx(1)
        a.lodi(2, 5)
        a.sto(1, 2, 0)               # every thread stores its tid to [5]
        a.lodi(3, 1024)
        a.sto(1, 3, 100)             # out of range: dropped
        a.lodi(3, -7)
        a.sto(1, 3, 0)               # negative: dropped
        a.lod(4, 3, 0)               # clamped load of shared[0]
        a.sto(4, 1, 40)
        a.stop()
        return a
    ref, got = _both(build, shared=np.arange(1, 65, dtype=np.uint32))
    tp.assert_leaves_equal(ref, got, "sto")
    assert got["shared"][5] == 31


def test_fp_specials_through_the_executor():
    """NaN payloads, signed zeros and subnormals through FADD/FMUL/FMAX/
    FMIN/DOT/SUM and the predicate stacks, end to end."""
    bits = np.array([0x7FA00000, 0xFFB00000, 0x80000000, 0, 0x00400000,
                     0x7F800000, 0xFF800000, 0x3F800000] * 8, np.uint32)

    def build(a, T):
        a.tdx(1)
        a.lod(2, 1, 0)
        a.lod(3, 1, 7)
        for i, f in enumerate((a.fadd, a.fsub, a.fmul, a.fmax, a.fmin)):
            f(4 + i, 2, 3)
            a.sto(4 + i, 1, 64 + 32 * i)
        a.dot(10, 2, 3)
        a.sum_(11, 3)
        a.if_("flt", 2, 3)
        a.fadd(12, 3, 3)
        a.endif()
        a.sto(10, 1, 300, tsc="mcu")
        a.sto(11, 1, 301, tsc="mcu")
        a.sto(12, 1, 310)
        a.stop()
        return a
    ref, got = _both(build, shared=bits)
    tp.assert_leaves_equal(ref, got, "fp-specials")


def test_run_from_given_state():
    """A run that starts from a state carried across with
    state_from_numpy (mid-run leaves) ends where the reference does."""
    rb, pb = _pair("dp", 4)
    ref0 = ref_run(rb.image, shared_init=rb.shared_init, tdx_dim=rb.tdx_dim)
    leaves = tp.reference_leaves(ref0)
    leaves["halted"] = np.bool_(False)
    leaves["pc"] = np.int32(0)
    ref = ref_run(rb.image, state=jax.tree_util.tree_map(
        jax.numpy.asarray, type(ref0)(**leaves)))
    got = run_program(pb.image, state=state_from_numpy(leaves, device="cpu"))
    tp.assert_leaves_equal(tp.reference_leaves(ref), state_to_numpy(got),
                           "from-state")


def test_cuda_is_the_default_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pb = _pair("dp", 0)[1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_program(pb.image, shared_init=pb.shared_init)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(pb.image.cfg)
