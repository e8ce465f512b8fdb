"""The port's superblock tier against the JAX reference, on the CPU: the
folded schedule flattens to the simulated path, small repeats inline and
large ones become a body replayed ``count`` times (recursively), and the
corners of ``tests/test_superblock.py`` (calls in a loop in a predicate,
a peeled first iteration, an unbalanced IF, predicates in a replayed
loop, the trace budget, a lock-step batch) give every leaf of the
reference's ``run_program`` (tolerance: none).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_port as tp  # noqa: E402
from repro.core import Asm as RAsm, EGPUConfig as RCfg  # noqa: E402
from repro.core import Op as ROp, Typ as RTyp  # noqa: E402
from repro.core import run_program as ref_run  # noqa: E402
from repro.core import blockc as rblockc  # noqa: E402
from repro_torch import programs as tprog  # noqa: E402
from repro_torch.core import (Asm, BlockCompileError, CompiledProgram,  # noqa: E402
                              EGPUConfig, Op, Typ, compile_program,
                              run_compiled)
from repro_torch.core import blockc  # noqa: E402
from repro_torch.core.blockc import (_UNROLL_FULL, _plan_stats,  # noqa: E402
                                     _sched_execd, _sched_insts, _trace_cost)
from repro_torch.core.machine import state_to_numpy  # noqa: E402


def _both(build, tdx=32, shared=None, schedule_nops=True):
    """``(reference image, port image)`` of one program."""
    ri = build(RAsm(tp.config(RCfg, "dp")), RTyp, ROp).assemble(
        threads_active=32, schedule_nops=schedule_nops)
    pi = build(Asm(tp.config(EGPUConfig, "dp")), Typ, Op).assemble(
        threads_active=32, schedule_nops=schedule_nops)
    return ri, pi


def _check(build, label, tdx=32, shared=None, schedule_nops=True,
           mode="superblock"):
    """Run both, compare every leaf; returns the port's compiled program
    and its final state."""
    ri, pi = _both(build, schedule_nops=schedule_nops)
    ref = tp.reference_leaves(ref_run(ri, tdx_dim=tdx, shared_init=shared))
    cp = compile_program(pi, mode=mode)
    got = cp.run(tdx_dim=tdx, shared_init=shared, device="cpu")
    tp.assert_leaves_equal(ref, state_to_numpy(got), label)
    rcp = rblockc.compile_program(ri, mode=mode)
    assert rcp.schedule == cp.schedule and rcp.mode == cp.mode, label
    return cp, state_to_numpy(got)


def _counted_loop(*counts):
    """``r2 += 1`` under nested LOOPs of the given trip counts."""
    def build(a, T, O):
        a.tdx(1)
        a.lodi(2, 0)
        a.lodi(5, 1)

        def nest(cs):
            if not cs:
                a.add(2, 2, 5)
                return
            with a.loop(cs[0]):
                nest(cs[1:])

        nest(list(counts))
        a.sto(2, 1, 0)
        a.stop()
        return a
    return build


def _reps(segs) -> int:
    return sum(1 + _reps(s[1]) for s in segs if s[0] == "rep")


def test_schedule_flattens_to_the_simulated_path():
    """For every suite program the schedule executes exactly
    ``sim.steps`` instructions, the segments flatten to the same path,
    and the units replayed cover every row with device work on it."""
    for name in tp.CONFIGS:
        for b in tp.suite(tprog, tp.config(EGPUConfig, name)).values():
            cp = compile_program(b.image, mode="superblock")
            assert _sched_execd(cp.schedule) == cp.sim.steps, b.name
            assert _sched_insts(cp.schedule) <= cp.sim.steps, b.name
            flat = blockc._flatten(cp.schedule)
            assert len(flat) == cp.sim.steps
            assert [pc for k in cp._unit_order() for pc in k] \
                == list(cp._row_work(flat)), b.name
    mm = compile_program(tprog.build_matmul(tp.config(EGPUConfig, "dp"), 8)
                         .image)
    assert _sched_insts(mm.schedule) < mm.sim.steps // 4


def test_loop_unroll_small_counts():
    """A small LOOP inlines fully: one straight line, one replay."""
    cp, got = _check(_counted_loop(7), "unroll")
    assert got["shared"][0] == 7
    segs = cp._segments(cp.schedule)
    assert [s[0] for s in segs] == ["line"]
    assert len(cp._unit_order()) == 1
    assert _plan_stats(cp.schedule).unrolled_reps == 1


def test_loop_large_counts_replay_the_body():
    """A large LOOP becomes its body's own unit replayed ``count``
    times (the reference's ``fori_loop``): the schedule stays tiny."""
    cp, got = _check(_counted_loop(5000), "replayed body")
    assert cp.sim.steps > 10_000
    assert _trace_cost(cp.schedule) < 64
    assert got["shared"][0] == 5000
    segs = cp._segments(cp.schedule)
    rep = [s for s in segs if s[0] == "rep"]
    assert len(rep) == 1 and rep[0][2] == 5000
    body = cp._row_work(rep[0][1][0][1])
    assert cp._unit_order().count(body) == 5000
    assert _reps(segs) == _plan_stats(cp.schedule).fori_reps == 1


def test_nested_loops_fold_recursively():
    """Nested repeats: a small inner loop inlines into the outer body;
    two large ones give a replayed body inside a replayed body."""
    cp, got = _check(_counted_loop(40, 25), "nested")
    assert _sched_execd(cp.schedule) == cp.sim.steps
    assert got["shared"][0] == 1000
    cp, got = _check(_counted_loop(3, 300), "nested large")
    assert got["shared"][0] == 900
    segs = cp._segments(cp.schedule)
    assert _reps(segs) == _plan_stats(cp.schedule).fori_reps == 2
    outer = next(s for s in segs if s[0] == "rep")
    assert outer[2] == 3 and any(s[0] == "rep" for s in outer[1])
    for it in cp.schedule:
        if not isinstance(it, int):
            assert it[2] * _sched_execd(it[1]) > _UNROLL_FULL


def test_jsr_inside_loop_inside_predicate():
    def build(a, T, O):
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

    _, got = _check(build, "jsr-in-loop")
    assert np.array_equal(got["shared"][:32],
                          np.where(np.arange(32) < 8, 3, 99))


def test_first_iteration_peels_on_mid_body_entry():
    """A JMP into the middle of a loop body: the partial first
    iteration stays inline and the full ones still fold."""
    def build(a, T, O):
        a.tdx(1)
        a.lodi(2, 0)
        a.lodi(5, 1)
        a.lodi(6, 2)
        a.init(4)
        a.jmp("mid")
        a.label("head")
        a.add(2, 2, 6)
        a.label("mid")
        a.add(2, 2, 5)
        a.loop_("head")
        a.sto(2, 1, 0)
        a.stop()
        return a

    _, got = _check(build, "peel", schedule_nops=False)
    assert got["shared"][0] == 13


def test_unbalanced_if_inside_loop_body():
    """pdepth grows across iterations: it lives in the plan's buffer,
    so the fold stays exact."""
    def build(a, T, O):
        a.tdx(1)
        a.lodi(2, 8)
        with a.loop(3):
            a.emit(O.IF_LT, ra=1, rb=2, typ=T.U32)
            a.lodi(3, 7)
        a.sto(3, 1, 0)
        a.stop()
        return a

    _check(build, "unbalanced-if")


def test_predicates_inside_replayed_loop():
    """Balanced IF/ENDIF in a loop large enough to replay its body: the
    predicate mask is recomputed in place in the static buffer."""
    def build(a, T, O):
        a.tdx(1)
        a.lodi(2, 8)
        a.lodi(4, 0)
        a.lodi(5, 1)
        with a.loop(300):
            a.if_("lt", 1, 2, typ=T.U32)
            a.add(4, 4, 5)
            a.endif()
        a.sto(4, 1, 0)
        a.stop()
        return a

    cp, got = _check(build, "pred-replayed")
    assert _trace_cost(cp.schedule) < cp.sim.steps // 10
    assert np.array_equal(got["shared"][:32],
                          np.where(np.arange(32) < 8, 300, 0))


def test_trace_budget_falls_back_to_blocks():
    """Over the trace budget ``auto`` takes the blocks tier and a forced
    superblock raises: superblock -> blocks -> interpreter."""
    ri, pi = _both(_counted_loop(200))
    old = blockc._MAX_TRACE
    blockc._MAX_TRACE = 4
    try:
        cp = CompiledProgram(pi, 32)
        assert cp.mode == "blocks"
        assert cp.switch_dispatches == cp.sim.dispatches > 0
        with pytest.raises(BlockCompileError):
            CompiledProgram(pi, 32, mode="superblock")
    finally:
        blockc._MAX_TRACE = old
    ref = tp.reference_leaves(ref_run(ri, tdx_dim=32))
    tp.assert_leaves_equal(ref, state_to_numpy(cp.run(tdx_dim=32,
                                                       device="cpu")),
                           "budget-fallback")


def test_validate_false_matches_the_reference():
    ri, pi = _both(_counted_loop(100))
    ref = tp.reference_leaves(ref_run(ri, validate=False, tdx_dim=32))
    got = run_compiled(pi, validate=False, tdx_dim=32, fallback=False,
                       mode="superblock", device="cpu")
    tp.assert_leaves_equal(ref, state_to_numpy(got), "validate=False")


def test_superblock_batched_lock_step():
    """run_batch on the superblock tier: each core equals its own
    reference run (different data, one schedule, one plan)."""
    def build(a, T, O):
        a.tdx(1)
        a.lod(2, 1, 0)
        a.lodi(5, 0)
        a.lodi(6, 1)
        with a.loop(50):
            a.add(5, 5, 6)
            a.fadd(2, 2, 2)
        a.sto(2, 1, 0)
        a.sto(5, 1, 32)
        a.stop()
        return a

    ri, pi = _both(build)
    cp = compile_program(pi, mode="superblock")
    rng = np.random.default_rng(11)
    datas = [rng.standard_normal(32).astype(np.float32) for _ in range(4)]
    out = state_to_numpy(cp.run_batch(datas, [32] * 4, device="cpu"))
    for i, d in enumerate(datas):
        ref = tp.reference_leaves(ref_run(ri, shared_init=d, tdx_dim=32))
        for leaf, r in ref.items():
            assert np.array_equal(r, out[leaf][i]), (i, leaf)
