"""The port's blocks and superblock tiers (``repro_torch.core.blockc``)
against the JAX reference, on the CPU: every ``MachineState`` leaf of
``run_compiled`` equal to the reference's ``run_program`` (tolerance:
none) for the ``test_blockc.py`` suite x CONFIGS under ``blocks``,
``superblock`` and ``auto``; the host half (path simulation, blocks,
schedule, tier features and choice, dispatches, event counters, CFG
summary) equal to the reference's ``CompiledProgram``; and the
control-flow, hazard, fallback and cache corners of ``test_blockc.py``.
"""
import dataclasses

import numpy as np
import pytest
from _hyp import given, settings, st

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_port as tp  # noqa: E402
from repro import programs as rprog  # noqa: E402
from repro.core import Asm as RAsm, EGPUConfig as RCfg  # noqa: E402
from repro.core import Op as ROp, Typ as RTyp  # noqa: E402
from repro.core import run_program as ref_run  # noqa: E402
from repro.core import blockc as rblockc, cfg as rcfg  # noqa: E402
from repro_torch import programs as tprog  # noqa: E402
from repro_torch.core import (Asm, BlockCompileError, CompiledProgram,  # noqa: E402
                              EGPUConfig, Op, Typ, compile_program,
                              run_compiled)
from repro_torch.core import blockc, cfg as pcfg  # noqa: E402
from repro_torch.core.machine import state_to_numpy  # noqa: E402

MODES = ("blocks", "superblock", "auto")


def _pair(name, i):
    rb = tp.suite(rprog, tp.config(RCfg, name))
    pb = tp.suite(tprog, tp.config(EGPUConfig, name))
    return rb[i], pb[i]


def _both(build, threads=32, tdx=32, shared=None, schedule_nops=True,
          **cfg_kw):
    """Assemble one program with both packages: ``(reference leaves,
    port image)``."""
    rcfg_ = tp.config(RCfg, "dp").replace(**cfg_kw)
    pcfg_ = tp.config(EGPUConfig, "dp").replace(**cfg_kw)
    ri = build(RAsm(rcfg_), RTyp, ROp).assemble(
        threads_active=threads, schedule_nops=schedule_nops)
    pi = build(Asm(pcfg_), Typ, Op).assemble(
        threads_active=threads, schedule_nops=schedule_nops)
    ref = ref_run(ri, tdx_dim=tdx, shared_init=shared)
    return tp.reference_leaves(ref), pi


def _tiers_equal(ref, img, label, tdx=32, shared=None, modes=MODES):
    for mode in modes:
        got = run_compiled(img, tdx_dim=tdx, shared_init=shared,
                           fallback=False, mode=mode, device="cpu")
        tp.assert_leaves_equal(ref, state_to_numpy(got), f"{label}/{mode}")


@pytest.mark.parametrize("name,i", tp.suite_ids(),
                         ids=[f"{n}-{i}" for n, i in tp.suite_ids()])
def test_compiled_tiers_leaves_equal(name, i):
    """Acceptance: every tier == the reference's interpreter, bit for
    bit, every leaf; the superblock tier pays no block dispatch."""
    rb, pb = _pair(name, i)
    ref = tp.reference_leaves(ref_run(rb.image, shared_init=rb.shared_init,
                                      tdx_dim=rb.tdx_dim))
    for mode in MODES:
        cp = compile_program(pb.image, mode=mode)
        if mode == "superblock":
            assert cp.mode == "superblock" and cp.switch_dispatches == 0
        got = run_compiled(pb.image, shared_init=pb.shared_init,
                           tdx_dim=pb.tdx_dim, fallback=False, mode=mode,
                           device="cpu")
        tp.assert_leaves_equal(ref, state_to_numpy(got),
                               f"{name}/{pb.name}/{mode}")


def _assert_sim_equal(r, p, label):
    for f in r._fields:
        a, b = getattr(r, f), getattr(p, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), (label, f)
        else:
            assert a == b, (label, f)


@pytest.mark.parametrize("name,i", tp.suite_ids(),
                         ids=[f"{n}-{i}" for n, i in tp.suite_ids()])
def test_host_half_equals_reference(name, i):
    """The port's path simulation, blocks, schedule, tier features,
    chosen tier, dispatches, event counters and CFG facts are the
    reference's, under the default table and under the ``"gpu"`` prior
    (what ``default_policy_for_device`` gives a ``cuda`` device)."""
    rb, pb = _pair(name, i)
    pols = ((None, None),
            (rblockc.tier_policy_for_backend("gpu"),
             blockc.default_policy_for_device(torch.device("cuda"))))
    for rpol, ppol in pols:
        for mode in MODES:
            for batch in (1, 4):
                r = rblockc.CompiledProgram(rb.image, rb.image.threads_active,
                                            mode=mode, policy=rpol,
                                            batch_hint=batch)
                p = CompiledProgram(pb.image, pb.image.threads_active,
                                    mode=mode, policy=ppol, batch_hint=batch)
                label = f"{name}/{pb.name}/{mode}/{batch}/{rpol}"
                _assert_sim_equal(r.sim, p.sim, label)
                assert r.blocks == p.blocks, label
                assert r.schedule == p.schedule, label
                assert r.tier_features == p.tier_features, label
                assert r.mode == p.mode, label
                assert r.switch_dispatches == p.switch_dispatches, label
                assert r.policy.table == p.policy.table, label
                assert dataclasses.asdict(r.event_counters()) \
                    == dataclasses.asdict(p.event_counters()), label
    packed = blockc.pad_image(pb.image)[0]
    assert pcfg.summary(packed, pb.image.n) \
        == rcfg.summary(packed, rb.image.n)
    rg, pg = rcfg.build_cfg(packed, rb.image.n), pcfg.build_cfg(
        packed, pb.image.n)
    assert (rg.blocks, rg.succs, rg.preds, rg.return_sites,
            rg.bad_targets) == (pg.blocks, pg.succs, pg.preds,
                                pg.return_sites, pg.bad_targets)


def test_block_walk_is_the_simulated_path():
    """The blocks tier's host walk dispatches exactly ``sim.dispatches``
    blocks and replays one unit for each dispatch that has device work;
    its data-independent leaves equal the simulation's."""
    for name in tp.CONFIGS:
        for b in tp.suite(tprog, tp.config(EGPUConfig, name)).values():
            cp = compile_program(b.image, mode="blocks")
            assert len(cp._block_path) == cp.sim.dispatches \
                == cp.switch_dispatches, b.name
            assert len(cp._unit_order()) <= cp.sim.dispatches, b.name
            sim = cp.sim
            for leaf in ("pc", "cycles", "steps", "lsp", "csp"):
                assert int(cp._seq[leaf]) == int(getattr(sim, leaf)), leaf
            assert bool(cp._seq["halted"]) == sim.halted
            for leaf in ("lctr", "cstack", "stat_cycles", "stat_instrs"):
                assert np.array_equal(cp._seq[leaf], getattr(sim, leaf))


def test_equivalence_validate_false():
    rb, pb = _pair("dp", 0)
    ref = tp.reference_leaves(ref_run(rb.image, validate=False,
                                      shared_init=rb.shared_init,
                                      tdx_dim=rb.tdx_dim))
    for mode in MODES:
        got = run_compiled(pb.image, validate=False,
                           shared_init=pb.shared_init, tdx_dim=pb.tdx_dim,
                           fallback=False, mode=mode, device="cpu")
        tp.assert_leaves_equal(ref, state_to_numpy(got),
                               f"validate=False/{mode}")


def test_control_flow_corners():
    """JSR/RTS nesting, nested predicates with ELSE and a LOOP chain:
    the block boundaries the compiler cuts at."""
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

    ref, img = _both(build)
    _tiers_equal(ref, img, "control-flow")
    got = run_compiled(img, tdx_dim=32, fallback=False, device="cpu")
    out = state_to_numpy(got)["shared"][:32]
    assert np.array_equal(out, np.where(np.arange(32) < 8, 3, 99))


def test_hazard_violations_baked_statically():
    """An unscheduled RAW program: the statically computed violation
    count and hazard rows equal the reference interpreter's."""
    def build(a, T, O):
        a.lodi(1, 7, tsc="mcu")
        a.add(2, 1, 1, tsc="mcu")
        a.stop()
        return a

    ref, img = _both(build, schedule_nops=False)
    assert int(ref["hazard_violations"]) > 0
    _tiers_equal(ref, img, "hazard")


def test_non_halting_program_falls_back():
    """A program that never halts within max_steps is rejected (and the
    rejection negative-cached); ``run_compiled`` sends it to the port's
    interpreter on the same device, and ``fallback=False`` raises."""
    def build(a, T, O):
        a.label("spin")
        a.add(1, 1, 1)
        a.jmp("spin")
        return a

    ref, img = _both(build, max_steps=64)
    with pytest.raises(BlockCompileError):
        compile_program(img)
    key = next(k for k, v in blockc._CACHE.items()
               if isinstance(v, BlockCompileError)
               and k[1] == blockc.program_key(img))
    first = blockc._CACHE[key]
    with pytest.raises(BlockCompileError) as e:
        compile_program(img)
    assert e.value is first                 # served from the cache
    with pytest.raises(BlockCompileError):
        run_compiled(img, tdx_dim=32, fallback=False, device="cpu")
    got = run_compiled(img, tdx_dim=32, device="cpu")
    tp.assert_leaves_equal(ref, state_to_numpy(got), "fallback")
    assert int(got.steps) == 64


def test_predicate_ops_in_predicate_less_config():
    """The interpreter emulates a one-level predicate stack when
    predicate_levels == 0 (D clamps to 1); the tiers must too."""
    def build(a, T, O):
        a.tdx(1)
        a.lodi(2, 8)
        a.emit(O.IF_LT, ra=1, rb=2, typ=T.U32)
        a.lodi(3, 1)
        a.emit(O.ELSE)
        a.lodi(3, 2)
        a.emit(O.ENDIF)
        a.sto(3, 1, 0)
        a.stop()
        return a

    ref, img = _both(build, regs_per_thread=16, shared_kb=2,
                     predicate_levels=0)
    _tiers_equal(ref, img, "nopred-if")


def test_jmp_into_stop_padding():
    """A JMP past the last instruction lands in the padded STOP tail."""
    def build(a, T, O):
        a.lodi(1, 5)
        a.jmp(40)
        a.stop()
        return a

    ref, img = _both(build, schedule_nops=False)
    _tiers_equal(ref, img, "pad-jmp")
    assert bool(run_compiled(img, tdx_dim=32, mode="blocks",
                             device="cpu").halted)


def _tiny_prog(value: int):
    a = Asm(tp.config(EGPUConfig, "dp"))
    a.lodi(1, value)
    a.sto(1, 0, 0)
    a.stop()
    return a.assemble(threads_active=32)


def test_compile_cache_is_lru_not_fifo():
    """A hit moves the entry to the back of the eviction queue."""
    imgs = [_tiny_prog(v) for v in (101, 102, 103)]
    old_max, old_cache = blockc._CACHE_MAX, dict(blockc._CACHE)
    blockc._CACHE.clear()
    blockc._CACHE_MAX = 2
    try:
        cp_a = compile_program(imgs[0])
        cp_b = compile_program(imgs[1])
        assert compile_program(imgs[0]) is cp_a
        cp_c = compile_program(imgs[2])            # evicts B, not A
        assert compile_program(imgs[0]) is cp_a
        assert compile_program(imgs[2]) is cp_c
        assert compile_program(imgs[1]) is not cp_b
    finally:
        blockc._CACHE_MAX = old_max
        blockc._CACHE.clear()
        blockc._CACHE.update(old_cache)


def test_explicit_zero_threads_rejected():
    img = _tiny_prog(7)
    with pytest.raises(ValueError, match="thread count"):
        compile_program(img, 0)
    with pytest.raises(ValueError, match="thread count"):
        run_compiled(img, threads=0, device="cpu")
    with pytest.raises(ValueError, match="thread count"):
        run_compiled(img, threads=-16, device="cpu")
    assert compile_program(img, None).threads == img.threads_active


def test_entry_points_default_to_the_card_and_optimize_waits():
    """``run_compiled`` and the run methods run on the card unless the
    caller asks for the CPU (no silent fallback without one);
    ``optimize=True`` compiles the verified optimizer's image (the
    reference's ``optimize_image_cached(...).image``)."""
    from repro_torch.analysis.optimizer import optimize_image
    img = _tiny_prog(9)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_compiled(img)
        with pytest.raises(RuntimeError, match="CUDA"):
            compile_program(img).run_light()
    cp = compile_program(img, optimize=True)
    want = optimize_image(img, img.threads_active).image
    assert cp.image.words.tobytes() == want.words.tobytes()


def test_compiled_batch_tdx_dims_vary():
    """The TDX grid is per-core data on the compiled tiers: one plan,
    replayed with other grids, never keeps an old one."""
    def build(a, T, O):
        a.tdx(1)
        a.tdy(2)
        a.sto(2, 1, 0)
        a.stop()
        return a

    _, img = _both(build)
    rimg = build(RAsm(tp.config(RCfg, "dp")), RTyp, ROp).assemble(
        threads_active=32)
    dims = (4, 8, 16, 32)
    for mode in ("blocks", "superblock"):
        cp = compile_program(img, mode=mode)
        for order in (dims, dims[::-1]):
            out = cp.run_batch([None] * 4, list(order), device="cpu")
            for k, d in enumerate(order):
                ref = tp.reference_leaves(ref_run(rimg, tdx_dim=d))
                got = state_to_numpy(out)
                assert np.array_equal(ref["shared"], got["shared"][k]), d
                assert int(got["tdx_dim"][k]) == d
        # the card's step launches take the plan's buffers by pointer
        plan = cp._plans[torch.device("cpu"), 4]
        for t in (plan.regs, plan.shared, plan.pred, plan.masks, plan.rows):
            assert t.is_contiguous()
        assert all(x.is_contiguous() for x in out)


_ALU = [Op.ADD, Op.SUB, Op.NEG, Op.ABS, Op.MUL16LO, Op.MUL16HI,
        Op.MUL24LO, Op.MUL24HI, Op.AND, Op.OR, Op.XOR, Op.NOT, Op.CNOT,
        Op.BVS, Op.SHL, Op.SHR, Op.POP, Op.MAX, Op.MIN, Op.FADD, Op.FSUB,
        Op.FNEG, Op.FABS, Op.FMUL, Op.FMAX, Op.FMIN, Op.LOD, Op.STO,
        Op.LODI, Op.TDX, Op.TDY]

instr_st = st.tuples(st.sampled_from([int(o) for o in _ALU]),
                     st.sampled_from([int(Typ.U32), int(Typ.I32)]),
                     st.integers(0, 31), st.integers(0, 31),
                     st.integers(0, 31), st.integers(-64, 64))


@given(st.lists(instr_st, min_size=1, max_size=40),
       st.lists(st.integers(0, 0xFFFFFFFF), min_size=32, max_size=32))
@settings(max_examples=10, deadline=None)
def test_random_straight_line_programs_match(instrs, seed_words):
    """Arbitrary straight-line op soup (aliasing reads and writes,
    out-of-range addresses) through both tiers equals the reference."""
    def build(a, T, O):
        for (op, typ, rd, ra, rb, imm) in instrs:
            a.emit(O(op), typ=T(typ), rd=rd, ra=ra, rb=rb,
                   imm=imm if O(op) in (O.LOD, O.STO, O.LODI) else 0)
        a.stop()
        return a

    buf = np.array(seed_words, np.uint32)
    ref, img = _both(build, tdx=16, shared=buf)
    _tiers_equal(ref, img, "random", tdx=16, shared=buf,
                 modes=("blocks", "superblock"))
