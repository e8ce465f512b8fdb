"""The port's tier policy and light path against the JAX reference, on
the CPU: ``mode="auto"`` decisions and the features behind them equal
the reference's under the default table and under the ``"gpu"`` prior
(what ``default_policy_for_device`` gives a ``cuda`` device), every
threshold overrides, ``run_light``/``run_batch_light`` equal ``run``/
``run_batch``, ``run_light_dev`` never consumes its input, and the
fleet's ``ResidencyCache`` hits, misses, evicts and invalidates with
the compiled program (the port of ``tests/test_tier_policy.py``).
"""
import gc

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_port as tp  # noqa: E402
from repro.core import Asm as RAsm, EGPUConfig as RCfg  # noqa: E402
from repro.core import run_program as ref_run  # noqa: E402
from repro.core import blockc as rblockc  # noqa: E402
from repro_torch.core import (DEFAULT_TIER_POLICY, Asm,  # noqa: E402
                              BlockCompileError, CompiledProgram,
                              EGPUConfig, TierPolicy, compile_program)
from repro_torch.core import blockc  # noqa: E402
from repro_torch.core.machine import state_to_numpy  # noqa: E402
from repro_torch.fleet import ResidencyCache  # noqa: E402

GPU = blockc.default_policy_for_device(torch.device("cuda"))


def _saxpy(asm_cls, cfg, iters):
    a = asm_cls(cfg)
    a.tdx(1)
    a.lod(2, 1, 0)
    a.lod(3, 1, 32)
    with a.loop(iters):
        a.fmul(3, 3, 4)
        a.fadd(3, 3, 2)
    a.sto(3, 1, 32)
    a.stop()
    return a.assemble(threads_active=32)


def _straightline(asm_cls, cfg, n_instr):
    a = asm_cls(cfg)
    a.tdx(1)
    a.lodi(2, 1)
    for _ in range(n_instr):
        a.add(2, 2, 1)
    a.sto(2, 1, 0)
    a.stop()
    return a.assemble(threads_active=32, schedule_nops=False)


def _data(iters):
    return np.random.default_rng(iters).standard_normal(64).astype(
        np.float32)


def _pair(kind, n):
    build = {"saxpy": _saxpy, "straight": _straightline}[kind]
    return (build(RAsm, tp.config(RCfg, "dp"), n),
            build(Asm, tp.config(EGPUConfig, "dp"), n))


CASES = [("saxpy", n) for n in (8, 16, 24, 32, 64, 400, 512)] \
    + [("straight", n) for n in (32, 112, 128, 272)]


@pytest.mark.parametrize("kind,n", CASES, ids=[f"{k}{n}" for k, n in CASES])
def test_decisions_and_features_equal_the_reference(kind, n):
    """Under the default table and the ``"gpu"`` prior, at batch hints
    1 and 4, the port decides what the reference decides, from the same
    features."""
    ri, pi = _pair(kind, n)
    for rpol, ppol in ((rblockc.DEFAULT_TIER_POLICY, DEFAULT_TIER_POLICY),
                       (rblockc.tier_policy_for_backend("gpu"), GPU)):
        assert rpol.table == ppol.table
        for batch in (1, 4, 32):
            r = rblockc.CompiledProgram(ri, 32, policy=rpol,
                                        batch_hint=batch)
            p = CompiledProgram(pi, 32, policy=ppol, batch_hint=batch)
            assert (r.mode, r.tier_features) == (p.mode, p.tier_features)
            assert rpol._decide(r.tier_features, batch) \
                == ppol._decide(p.tier_features, batch)


def test_policy_for_device():
    """A ``cuda`` device takes the reference's ``"gpu"`` prior, the CPU
    the CPU table, ``None`` the default; a registered table is seen by
    later lookups and leaves built policies alone."""
    assert GPU.table == rblockc.tier_policy_for_backend("gpu").table
    assert GPU.table["min_backedge_dispatches"] == 12
    assert blockc.default_policy_for_device(torch.device("cpu")) \
        == DEFAULT_TIER_POLICY
    assert blockc.default_policy_for_device(None) is DEFAULT_TIER_POLICY
    assert blockc.default_policy_for_device("cuda:0") == GPU
    saved = dict(blockc._TIER_TABLES)
    try:
        blockc.register_backend_table("gpu", min_backedge_dispatches=3)
        assert blockc.default_policy_for_device("cuda").table[
            "min_backedge_dispatches"] == 3
        assert GPU.table["min_backedge_dispatches"] == 12
        with pytest.raises(ValueError):
            blockc.register_backend_table("gpu", no_such_threshold=1)
    finally:
        blockc._TIER_TABLES.clear()
        blockc._TIER_TABLES.update(saved)


def test_crossover_and_wide_batches():
    below = _pair("saxpy", 8)[1]
    above = _pair("saxpy", 512)[1]
    assert compile_program(below).mode == "blocks"
    assert compile_program(above).mode == "superblock"
    wide = DEFAULT_TIER_POLICY.table["batch_superblock_min"]
    assert compile_program(below, batch_hint=wide).mode == "superblock"
    assert compile_program(below, batch_hint=wide) \
        is compile_program(below, batch_hint=4 * wide)
    thr = DEFAULT_TIER_POLICY.table["min_trace_fusion"]
    assert compile_program(_pair("straight", thr + 16)[1]).mode \
        == "superblock"
    assert compile_program(_pair("straight", 32)[1]).mode == "blocks"


def test_mode_overrides_always_force_their_tier():
    """Explicit modes beat the cost model on both sides of the
    crossover, and every leaf equals the reference's interpreter."""
    for iters in (8, 512):
        ri, pi = _pair("saxpy", iters)
        ref = tp.reference_leaves(ref_run(ri, shared_init=_data(iters),
                                          tdx_dim=32))
        cb = compile_program(pi, mode="blocks")
        cs = compile_program(pi, mode="superblock")
        assert cb.mode == "blocks" and cb.switch_dispatches > 0
        assert cs.mode == "superblock" and cs.switch_dispatches == 0
        for cp in (cb, cs):
            got = cp.run(shared_init=_data(iters), tdx_dim=32, device="cpu")
            tp.assert_leaves_equal(ref, state_to_numpy(got),
                                   f"{iters}/{cp.mode}")


def test_policy_threshold_table_overrides():
    eager = TierPolicy(min_backedge_dispatches=2)
    never = TierPolicy(min_backedge_dispatches=10**9,
                       min_trace_fusion=10**9, min_fori_execd=10**9)
    img = _pair("saxpy", 16)[1]
    assert compile_program(img).mode == "blocks"
    assert compile_program(img, policy=eager).mode == "superblock"
    assert compile_program(img, policy=never).mode == "blocks"
    assert TierPolicy(min_backedge_dispatches=2) == eager
    assert hash(TierPolicy(min_backedge_dispatches=2)) == hash(eager)
    assert eager != never and eager != DEFAULT_TIER_POLICY
    assert TierPolicy() == DEFAULT_TIER_POLICY
    with pytest.raises(ValueError):
        TierPolicy(min_backedge_dispatch=1)
    t = eager.table
    t["min_backedge_dispatches"] = 999
    assert eager.table["min_backedge_dispatches"] == 2


def test_features_expose_the_simulation_inputs():
    cp = compile_program(_pair("saxpy", 400)[1], mode="superblock")
    f = DEFAULT_TIER_POLICY.features(cp.sim)
    assert f["eligible"] and f["dispatches"] == cp.sim.dispatches > 400
    assert f["execd"] == cp.sim.steps
    assert f["fori_reps"] == 1 and f["fori_trips"] == (400,)
    assert f["trace_cost"] == blockc._trace_cost(cp.schedule)
    fs = DEFAULT_TIER_POLICY.features(
        compile_program(_pair("saxpy", 8)[1]).sim)
    assert fs["fori_reps"] == 0 and fs["unrolled_reps"] == 1
    assert fs["fori_trips"] == ()


def test_ineligible_schedule_stays_on_blocks_for_auto():
    img = _pair("saxpy", 200)[1]
    old = blockc._MAX_TRACE
    blockc._MAX_TRACE = 4
    try:
        cp = CompiledProgram(img, 32,
                             policy=TierPolicy(min_backedge_dispatches=1))
        assert cp.mode == "blocks" and not cp.tier_features["eligible"]
        with pytest.raises(BlockCompileError):
            CompiledProgram(img, 32, mode="superblock")
    finally:
        blockc._MAX_TRACE = old


@pytest.mark.parametrize("mode", ["blocks", "superblock"])
def test_run_light_bit_identical_to_run(mode):
    img = _pair("saxpy", 64)[1]
    data = _data(64)
    cp = compile_program(img, mode=mode)
    ref = cp.run(shared_init=data, tdx_dim=32, device="cpu")
    sh, cyc, halted = cp.run_light(shared_init=data, tdx_dim=32,
                                   device="cpu")
    assert torch.equal(ref.shared, sh)
    assert int(ref.cycles) == cyc and bool(ref.halted) == halted
    datas = [data, data * 2, data + 3, None]
    refb = cp.run_batch(datas, [32, 32, 16, 8], device="cpu")
    shb, cycb, hb = cp.run_batch_light(datas, [32, 32, 16, 8], device="cpu")
    assert torch.equal(refb.shared, shb)
    assert torch.equal(refb.cycles, cycb) and torch.equal(refb.halted, hb)
    assert cp.light_compile(np.zeros((4, cp.cfg.shared_words), np.uint32),
                            [32] * 4, "cpu") == 0.0


def test_run_light_dev_does_not_consume_its_input():
    """The light path copies its input into the plan's buffers: the
    same tensor replays to the same result, is left as it was, and the
    result is a fresh tensor, not the buffer the next run overwrites."""
    img = _pair("saxpy", 32)[1]
    cp = compile_program(img, mode="superblock")
    S = cp.cfg.shared_words
    data = _data(32)
    shared = np.zeros((2, S), np.uint32)
    shared[0, :64] = data.view(np.uint32)
    shared[1, :64] = (data * 2).view(np.uint32)
    dev = torch.from_numpy(shared.view(np.int32).copy())
    keep = dev.clone()
    tdx = torch.tensor([32, 32], dtype=torch.int32)
    first = cp.run_light_dev(dev, tdx)[0]
    assert torch.equal(dev, keep)
    second = cp.run_light_dev(dev, tdx)[0]
    assert torch.equal(first, second)
    assert first.data_ptr() != second.data_ptr()
    plan = cp._plans[torch.device("cpu"), 2]
    assert first.data_ptr() != plan.shared.data_ptr()
    one, cyc, halted = cp.run_light_dev(dev[1], 32)
    assert torch.equal(one, first[1]) and cyc.dim() == 0


def test_residency_cache_hit_miss_lru_and_invalidation():
    img = _pair("saxpy", 32)[1]
    cp = compile_program(img, mode="superblock")
    built = []

    def build(tag):
        def f():
            built.append(tag)
            return (torch.full((2, 4), tag, dtype=torch.int32),)
        return f

    cache = ResidencyCache(max_entries=2)
    with pytest.raises(ValueError):
        ResidencyCache(0)
    a, hit = cache.lookup("a", cp, build(1))
    assert not hit and cache.misses == 1
    a2, hit = cache.lookup("a", cp, build(9))
    assert hit and a2 is a and cache.hits == 1 and built == [1]
    cache.lookup("b", cp, build(2))
    cache.lookup("a", cp, build(9))                 # a moves to the back
    cache.lookup("c", cp, build(3))                 # evicts b, not a
    assert len(cache) == 2
    _, hit = cache.lookup("a", cp, build(9))
    assert hit
    _, hit = cache.lookup("b", cp, build(4))
    assert not hit and built == [1, 2, 3, 4]
    # another compiled program under the same key: rebuilt, not replayed
    other = CompiledProgram(img, 32, mode="superblock")
    _, hit = cache.lookup("a", other, build(5))
    assert not hit and built[-1] == 5
    # the compiled program the entry was built on is gone (evicted from
    # the compile cache and collected): the weak token no longer matches
    tmp = CompiledProgram(img, 32, mode="blocks")
    cache.lookup("t", tmp, build(6))
    del tmp
    gc.collect()
    fresh = CompiledProgram(img, 32, mode="blocks")
    _, hit = cache.lookup("t", fresh, build(7))
    assert not hit and built[-1] == 7
    cache.clear()
    assert len(cache) == 0
    # the cached inputs replay through the light path unchanged
    S = cp.cfg.shared_words
    (sh,), _ = cache.lookup("run", cp, lambda: (
        torch.zeros((1, S), dtype=torch.int32),))
    out1 = cp.run_light_dev(sh, [32])[0]
    (sh2,), hit = cache.lookup("run", cp, build(8))
    assert hit and sh2 is sh
    assert torch.equal(cp.run_light_dev(sh2, [32])[0], out1)
