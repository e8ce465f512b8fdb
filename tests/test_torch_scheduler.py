"""The port's scheduler and ``Fleet`` facade (``repro_torch.fleet.
scheduler``, ``repro_torch.fleet.api``) against the JAX package's, on
the CPU: the port of ``test_fleet.py``.

The same submissions to both packages' ``Fleet`` must give bit-identical
``JobResult``s (shared words as uint32, cycles, steps, time, hazard
violations, the Fig. 6 counters, the tier, the event counters;
tolerance: none) and equal ``FleetStats`` counts (jobs, batches, pad
slots, cycles, steps, tier splits, residency hits and misses, salvage,
degradation, bisection; device labels aside) — on the suite of
``tests/_torch_port.py`` plus generator singletons, in each of the four
CONFIGS, on the compiled tiers and on the interpreter, and under a
seeded ``FaultPlan``.  The rest are the reference's scheduler contracts
held on the port, with the port's ``run_program`` as the oracle:
packing and padding, pow2 buckets, requeue after a raising batch,
checksummed salvage, residency hits, invalidation and LRU bound,
submit-time validation, the alu16 masks.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_port as tp  # noqa: E402
from repro import fleet as rfleet  # noqa: E402
from repro import programs as rprog  # noqa: E402
from repro.analysis import analyze as ref_analyze  # noqa: E402
from repro.core import EGPUConfig as RCfg  # noqa: E402
from repro.programs.generator import generate_program as ref_gen  # noqa: E402
from repro_torch import programs as tprog  # noqa: E402
from repro_torch.core import Asm, EGPUConfig, Typ, run_program  # noqa: E402
from repro_torch.core import blockc, machine as machine_mod  # noqa: E402
from repro_torch.core.blockc import CompiledProgram  # noqa: E402
from repro_torch.fleet import (FaultPlan, Fleet, FleetScheduler,  # noqa: E402
                               fleet_run, run_jobs, serve_jobs,
                               unstack_state)
from repro_torch.fleet import scheduler as sched_mod  # noqa: E402
from repro_torch.fleet.scheduler import DrainCancelled  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.programs.generator import generate_program  # noqa: E402

CFG = tp.config(EGPUConfig, "dp")

#: the FleetStats fields a drain must count as the reference does
STATS = ("jobs", "batches", "pad_slots", "total_cycles", "total_steps",
         "compiled_jobs", "compiled_batches", "superblock_jobs",
         "superblock_batches", "residency_hits", "residency_misses",
         "salvaged_jobs", "degraded_units", "bisections", "salvage_dropped")


def _jobs(name):
    """``[(reference job, port job)]`` as ``Fleet.submit`` keywords:
    every suite program twice (its own data, then a seeded permutation
    of it: a same-program group) and four generator programs the lint
    admits (singletons: the mixed interpreter remainder)."""
    rcfg, pcfg = tp.config(RCfg, name), tp.config(EGPUConfig, name)
    rb, pb = tp.suite(rprog, rcfg), tp.suite(tprog, pcfg)
    rng = np.random.default_rng(7)
    out = []
    for i in sorted(pb):
        for data in (pb[i].shared_init, rng.permutation(pb[i].shared_init)):
            out.append((dict(image=rb[i].image, shared_init=data,
                             tdx_dim=rb[i].tdx_dim, tag=pb[i].name),
                        dict(image=pb[i].image, shared_init=data,
                             tdx_dim=pb[i].tdx_dim, tag=pb[i].name)))
    seed = 0
    while sum(j[1]["tag"] == "gen" for j in out) < 4:
        rimg = ref_gen(rcfg, seed)
        if ref_analyze(rimg, rimg.threads_active).ok:
            data = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(
                np.uint32)
            tdx = (8, 16, 32)[seed % 3]
            out.append((dict(image=rimg, shared_init=data, tdx_dim=tdx,
                             tag="gen"),
                        dict(image=generate_program(pcfg, seed),
                             shared_init=data, tdx_dim=tdx, tag="gen")))
        seed += 1
    return out


def _submit(fleet, jobs):
    return [fleet.submit(j.pop("image"), j.pop("shared_init"), **j)
            for j in (dict(j) for j in jobs)]


def assert_results_equal(ref, got, label):
    for f in ("handle", "tag", "cycles", "steps", "time_us",
              "hazard_violations", "tier"):
        assert getattr(got, f) == getattr(ref, f), f"{label}: {f}"
    for f in ("shared", "stat_cycles", "stat_instrs"):
        r, g = getattr(ref, f), np.asarray(getattr(got, f))
        assert r.dtype == g.dtype and r.shape == g.shape, f"{label}: {f}"
        assert np.array_equal(r, g), f"{label}: {f}"
    assert np.array_equal(got.shared_f32().view(np.uint32),
                          ref.shared_u32()), label
    assert (got.counters is None) == (ref.counters is None), label
    if ref.counters is not None:
        assert got.counters.flat() == ref.counters.flat(), label


def assert_stats_equal(ref, got, label):
    for f in STATS:
        assert getattr(got, f) == getattr(ref, f), f"{label}: {f}"
    jobs = lambda s: sum(v["jobs"] for v in s.per_device().values())
    assert jobs(got) == jobs(ref), label


def _drain_both(rf, pf, jobs, label):
    hr = _submit(rf, [r for r, _ in jobs])
    hp = _submit(pf, [p for _, p in jobs])
    assert hr == hp
    rres, pres = rf.drain(), pf.drain()
    assert sorted(pres) == sorted(rres) == sorted(hp)
    for h in hp:
        assert_results_equal(rres[h], pres[h], f"{label}/{h}")
    assert_stats_equal(rf.stats, pf.stats, label)
    return pres


#: the CONFIGS this file drains; ``test_torch_scheduler_configs.py``
#: drains the other two (each file stays near a minute on the CPU)
DRAIN_CONFIGS = ("dp", "qp")


def check_drain(name):
    """Compiled same-program groups, the mixed interpreter remainder,
    and a repeat drain replayed from resident inputs."""
    jobs = _jobs(name)
    rf = rfleet.Fleet(tp.config(RCfg, name), batch_size=4)
    pf = Fleet(tp.config(EGPUConfig, name), batch_size=4, device="cpu")
    first = _drain_both(rf, pf, jobs, name)
    assert pf.stats.compiled_batches > 0 and pf.stats.residency_hits == 0
    again = _drain_both(rf, pf, jobs, f"{name}/repeat")
    assert pf.stats.residency_hits == pf.stats.compiled_batches // 2
    for h, r in first.items():
        assert np.array_equal(again[h + len(jobs)].shared, r.shared)


@pytest.mark.parametrize("name", DRAIN_CONFIGS)
def test_drain_matches_reference(name):
    check_drain(name)


def test_interpreter_drain_matches_reference():
    jobs = _jobs("dp")
    rf = rfleet.Fleet(tp.config(RCfg, "dp"), batch_size=32,
                      use_compiler=False)
    pf = Fleet(CFG, batch_size=32, use_compiler=False, device="cpu")
    _drain_both(rf, pf, jobs, "interp")
    assert pf.stats.batches == 1 and pf.stats.compiled_jobs == 0
    assert pf.stats.pad_slots == 32 - len(jobs)


# ---------------------------------------------------------------------------
# the reference's scheduler contracts, held on the port
# ---------------------------------------------------------------------------

def _suite():
    """test_fleet.py's suite at this configuration's 32 threads."""
    return [tprog.build_reduction(CFG, 32),
            tprog.build_reduction(CFG, 32, use_dot=True),
            tprog.build_reduction(CFG, 32, no_dynamic=True),
            tprog.build_transpose(CFG, 16), tprog.build_matmul(CFG, 8),
            tprog.build_bitonic(CFG, 32), tprog.build_fft(CFG, 32)]


def _ref(b_or_img, shared_init=None, tdx_dim=16, **kw):
    if hasattr(b_or_img, "image"):
        return run_program(b_or_img.image, shared_init=b_or_img.shared_init,
                           tdx_dim=b_or_img.tdx_dim, device="cpu")
    return run_program(b_or_img, shared_init=shared_init, tdx_dim=tdx_dim,
                       device="cpu", **kw)


def _same(st_, r, label=""):
    assert np.array_equal(machine_mod.shared_as_u32(st_), r.shared_u32()), \
        label
    assert int(st_.cycles) == r.cycles and int(st_.steps) == r.steps, label
    assert r.hazard_violations == 0, label


def test_32_core_fleet_bit_identical_to_sequential():
    benches = _suite()
    jobs = [benches[i % len(benches)] for i in range(32)]
    fleet = Fleet(CFG, batch_size=32, use_compiler=False, device="cpu")
    hs = [fleet.submit(b.image, b.shared_init, tdx_dim=b.tdx_dim, tag=b.name)
          for b in jobs]
    results = fleet.drain()
    assert fleet.stats.batches == 1 and fleet.stats.jobs == 32
    assert fleet.stats.compiled_jobs == 0
    for b, h in zip(jobs, hs):
        st_ = _ref(b)
        _same(st_, results[h], b.name)
        assert results[h].profile() == machine_mod.profile(st_), b.name


def test_fleet_oracles_still_hold():
    benches = _suite()
    results = run_jobs(CFG, [dict(image=b.image, shared_init=b.shared_init,
                                  tdx_dim=b.tdx_dim) for b in benches],
                       device="cpu")
    class _View:                # what a bench's result view reads
        def __init__(self, r):
            self.shared = torch.from_numpy(r.shared_i32())

    for b, r in zip(benches, results):
        exp = np.asarray(b.oracle(b.shared_init))
        got = np.asarray(b.result_view(_View(r)))
        if exp.dtype.kind == "f":
            assert np.allclose(got, exp, atol=b.atol, rtol=b.rtol), b.name
        else:
            assert np.array_equal(got, exp), b.name


def test_mixed_thread_counts_and_personalities():
    def prog(tsc, value):
        a = Asm(CFG)
        a.tdx(1)
        a.lodi(2, value, tsc=tsc)
        a.sto(2, 1, 0, tsc=tsc)
        a.stop()
        return a

    cases = [("full", 11, 32), ("full", 12, 16), ("wf0", 13, 32),
             ("cpu", 14, 32), ("mcu", 15, 16), ("quarter", 16, 32)]
    fleet = Fleet(CFG, batch_size=8, device="cpu")
    imgs, hs = [], []
    for tsc, value, threads in cases:
        img = prog(tsc, value).assemble(threads_active=threads)
        imgs.append(img)
        hs.append(fleet.submit(img, threads=threads, tdx_dim=threads,
                               tag=tsc))
    results = fleet.drain()
    for (tsc, _v, threads), img, h in zip(cases, imgs, hs):
        _same(_ref(img, tdx_dim=threads), results[h], tsc)


def test_scheduler_packs_partial_batches():
    b = tprog.build_reduction(CFG, 32)
    sched = FleetScheduler(CFG, batch_size=4, use_compiler=False,
                           device="cpu")
    hs = [sched.submit(b.image, b.shared_init, tdx_dim=b.tdx_dim)
          for _ in range(5)]
    assert sched.pending == 5
    results = sched.drain()
    assert sched.pending == 0
    assert sched.stats.batches == 2 and sched.stats.pad_slots == 3
    assert sorted(results) == sorted(hs)
    for h in hs:
        _same(_ref(b), results[h])
    assert sched.stats.jobs == 5 and sched.stats.jobs_per_sec > 0


def test_fleet_run_host_leaves_and_timings():
    """``fleet_run`` takes the batch's leaves as host arrays (the
    scheduler's way in), reports ``timings``, and unstacks per core."""
    b1, b2 = tprog.build_reduction(CFG, 32), tprog.build_transpose(CFG, 16)
    kw = [dict(shared_init=b.shared_init, tdx_dim=b.tdx_dim)
          for b in (b1, b2)]
    timings = {}
    final = fleet_run([b1.image, b2.image], init_kw=kw, device="cpu")
    leaves = [machine_mod.init_numpy(CFG, threads=b.image.threads_active,
                                     **k) for b, k in zip((b1, b2), kw)]
    host = fleet_run([b1.image, b2.image], leaves, timings=timings,
                     device="cpu")
    assert timings == {"compile_s": 0.0}
    batched = fleet_run([b1.image, b2.image], final, device="cpu")
    for i, b in enumerate((b1, b2)):
        st_ = _ref(b)
        for out in (final, host):
            core = unstack_state(out, i)
            assert np.array_equal(machine_mod.shared_as_u32(core),
                                  machine_mod.shared_as_u32(st_))
            assert int(core.cycles) == int(st_.cycles)
        # a batched state in: each core resumes from its halted state
        assert int(unstack_state(batched, i).cycles) == int(st_.cycles)


def test_drain_requeues_jobs_when_compiled_batch_raises(monkeypatch):
    b = tprog.build_reduction(CFG, 32)
    rng = np.random.default_rng(5)
    datas = [rng.standard_normal(32).astype(np.float32) for _ in range(6)]
    fleet = Fleet(CFG, batch_size=2, device="cpu")
    hs = [fleet.submit(b.image, d, tdx_dim=b.tdx_dim) for d in datas]
    calls = {"n": 0}
    real = CompiledProgram.run_light_dev

    def failing(self, shared, tdx_dims, device=None):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected batch failure")
        return real(self, shared, tdx_dims, device)

    monkeypatch.setattr(CompiledProgram, "run_light_dev", failing)
    with pytest.raises(RuntimeError, match="injected"):
        fleet.drain()
    assert fleet.pending == 4
    monkeypatch.setattr(CompiledProgram, "run_light_dev", real)
    results = fleet.drain()
    assert sorted(results) == sorted(hs)
    for d, h in zip(datas, hs):
        _same(_ref(b.image, d, b.tdx_dim), results[h])


def test_drain_requeues_jobs_when_interpreter_batch_raises(monkeypatch):
    b1, b2 = tprog.build_reduction(CFG, 32), tprog.build_transpose(CFG, 16)
    fleet = Fleet(CFG, batch_size=4, device="cpu")
    h1 = fleet.submit(b1.image, b1.shared_init, tdx_dim=b1.tdx_dim)
    h2 = fleet.submit(b2.image, b2.shared_init, tdx_dim=b2.tdx_dim)

    def boom(*a, **k):
        raise RuntimeError("interpreter tier down")

    monkeypatch.setattr(sched_mod, "fleet_run", boom)
    with pytest.raises(RuntimeError, match="tier down"):
        fleet.drain()
    assert fleet.pending == 2
    monkeypatch.undo()
    results = fleet.drain()
    assert sorted(results) == sorted([h1, h2])
    for b, h in ((b1, h1), (b2, h2)):
        _same(_ref(b), results[h], b.name)


def test_compiled_tier_pow2_bucketing_and_padding():
    b = tprog.build_reduction(CFG, 32)
    rng = np.random.default_rng(9)
    datas = [rng.standard_normal(32).astype(np.float32) for _ in range(11)]
    sched = FleetScheduler(CFG, batch_size=4, device="cpu")
    hs = [sched.submit(b.image, d, tdx_dim=b.tdx_dim) for d in datas]
    results = sched.drain()
    s = sched.stats
    assert (s.compiled_jobs, s.compiled_batches, s.pad_slots, s.jobs) == \
        (11, 3, 1, 11)
    assert sorted(results) == sorted(hs) and -1 not in results
    for d, h in zip(datas, hs):
        _same(_ref(b.image, d, b.tdx_dim), results[h])
    sched2 = FleetScheduler(CFG, batch_size=8, device="cpu")
    hs2 = [sched2.submit(b.image, d, tdx_dim=b.tdx_dim) for d in datas[:3]]
    assert sorted(sched2.drain()) == sorted(hs2)
    assert sched2.stats.compiled_batches == 1
    assert sched2.stats.pad_slots == 1          # 3 -> pow2 bucket 4


def test_submit_validation_fail_fast():
    other = EGPUConfig(max_threads=32, regs_per_thread=16, shared_kb=2)
    a = Asm(other)
    a.stop()
    with pytest.raises(ValueError):
        Fleet(CFG, device="cpu").submit(a.assemble())
    a = Asm(CFG)
    a.stop()
    img = a.assemble()
    fleet = Fleet(CFG, batch_size=4, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        fleet.submit(img, np.zeros(CFG.shared_words + 1, np.float32))
    with pytest.raises(ValueError, match="dtype"):
        fleet.submit(img, np.zeros(8, np.complex64))
    with pytest.raises(ValueError, match="thread count"):
        fleet.submit(img, threads=CFG.num_sps + 1)
    assert fleet.pending == 0
    h = fleet.submit(img, np.zeros(8, np.float32))
    assert fleet.pending == 1 and h in fleet.drain()


def _loop_prog(iters=64):
    a = Asm(CFG)
    a.tdx(1)
    a.lod(2, 1, 0)
    with a.loop(iters):
        a.fadd(2, 2, 2)
    a.sto(2, 1, 0)
    a.stop()
    return a.assemble(threads_active=32)


def _datas(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(32).astype(np.float32) for _ in range(n)]


def test_residency_cache_hits_on_repeat_drains():
    img = _loop_prog()
    datas = _datas(4, 21)
    fleet = Fleet(CFG, batch_size=4, device="cpu")

    def drain_and_check(batch):
        hs = [fleet.submit(img, d, tdx_dim=32) for d in batch]
        results = fleet.drain()
        for d, h in zip(batch, hs):
            st_ = _ref(img, d, 32)
            _same(st_, results[h])
            assert results[h].profile() == machine_mod.profile(st_)

    drain_and_check(datas)
    assert (fleet.stats.residency_hits, fleet.stats.residency_misses) == \
        (0, 1)
    drain_and_check(datas)
    drain_and_check(datas)
    assert (fleet.stats.residency_hits, fleet.stats.residency_misses) == \
        (2, 1)
    drain_and_check([d + 1 for d in datas])
    assert (fleet.stats.residency_hits, fleet.stats.residency_misses) == \
        (2, 2)


def test_residency_cache_invalidated_with_compile_cache():
    img = _loop_prog()
    datas = _datas(4, 22)
    fleet = Fleet(CFG, batch_size=4, device="cpu")
    for _ in range(2):
        for d in datas:
            fleet.submit(img, d, tdx_dim=32)
        fleet.drain()
    assert fleet.stats.residency_hits == 1
    blockc._CACHE.clear()                     # force a recompile
    hs = [fleet.submit(img, d, tdx_dim=32) for d in datas]
    results = fleet.drain()
    assert fleet.stats.residency_hits == 1    # no stale replay
    assert fleet.stats.residency_misses == 2
    _same(_ref(img, datas[0], 32), results[hs[0]])


def test_residency_cache_lru_bound():
    img = _loop_prog()
    rng = np.random.default_rng(23)
    fleet = Fleet(CFG, batch_size=2, residency_max=2, device="cpu")
    batches = [[rng.standard_normal(32).astype(np.float32)
                for _ in range(2)] for _ in range(4)]
    for batch in batches:
        for d in batch:
            fleet.submit(img, d, tdx_dim=32)
        fleet.drain()
    assert len(fleet._sched._residency) <= 2
    assert fleet.stats.residency_misses == 4
    for batch in batches[-2:]:
        for d in batch:
            fleet.submit(img, d, tdx_dim=32)
        fleet.drain()
    assert fleet.stats.residency_hits == 2


def test_stats_consistent_after_failed_then_salvaged_drain(monkeypatch):
    img = _loop_prog()
    datas = _datas(6, 31)
    fleet = Fleet(CFG, batch_size=2, device="cpu")
    hs = [fleet.submit(img, d, tdx_dim=32) for d in datas]
    calls = {"n": 0}
    real = CompiledProgram.run_light_dev

    def failing(self, shared, tdx, device=None):
        calls["n"] += 1
        if calls["n"] in (2, 4):
            raise RuntimeError("injected")
        return real(self, shared, tdx, device)

    monkeypatch.setattr(CompiledProgram, "run_light_dev", failing)
    s = fleet.stats
    with pytest.raises(RuntimeError):
        fleet.drain()
    assert s.jobs == s.compiled_jobs == s.superblock_jobs == 2
    assert s.batches == s.compiled_batches == 1 and s.salvaged_jobs == 0
    assert s.wall_s > 0
    assert [j.handle for j in fleet._sched._queue] == hs[2:]
    with pytest.raises(RuntimeError):
        fleet.drain()
    assert s.jobs == s.compiled_jobs == s.superblock_jobs == 4
    assert s.batches == s.compiled_batches == 2 and s.salvaged_jobs == 0
    assert [j.handle for j in fleet._sched._queue] == hs[4:]
    monkeypatch.setattr(CompiledProgram, "run_light_dev", real)
    results = fleet.drain()
    assert sorted(results) == sorted(hs)
    assert s.jobs == s.compiled_jobs == s.superblock_jobs == 6
    assert s.batches == s.compiled_batches == 3 and s.salvaged_jobs == 4
    assert s.jobs_per_sec == pytest.approx(s.jobs / s.wall_s)
    for d, h in zip(datas, hs):
        _same(_ref(img, d, 32), results[h])


def test_corrupted_salvage_is_dropped_and_rerun(monkeypatch):
    """A stashed result whose bits flip before delivery fails its
    BLAKE2 checksum: it is dropped and its job re-executed, never
    served."""
    img = _loop_prog()
    datas = _datas(4, 41)
    fleet = Fleet(CFG, batch_size=2, device="cpu")
    hs = [fleet.submit(img, d, tdx_dim=32) for d in datas]
    calls = {"n": 0}
    real = CompiledProgram.run_light_dev

    def failing(self, shared, tdx, device=None):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected")
        return real(self, shared, tdx, device)

    monkeypatch.setattr(CompiledProgram, "run_light_dev", failing)
    with FaultPlan(seed=1, salvage_corrupt={"count": 1}):
        with pytest.raises(RuntimeError):
            fleet.drain()
    monkeypatch.setattr(CompiledProgram, "run_light_dev", real)
    results = fleet.drain()
    assert fleet.stats.salvage_dropped == 1
    assert fleet.stats.salvaged_jobs == 1     # the other stashed result
    assert sorted(results) == sorted(hs)
    for d, h in zip(datas, hs):
        _same(_ref(img, d, 32), results[h])


def test_cancel_stops_at_the_next_unit_and_requeues():
    img = _loop_prog()
    datas = _datas(4, 51)
    sched = FleetScheduler(CFG, batch_size=2, device="cpu")
    hs = [sched.submit(img, d, tdx_dim=32) for d in datas]
    sched.cancel()
    with pytest.raises(DrainCancelled):
        sched.drain()
    assert [j.handle for j in sched._queue] == hs
    sched._cancelled = False
    assert sorted(sched.drain()) == sorted(hs)


def test_traced_drain_is_bit_identical_and_records_spans():
    benches = _suite()
    plain = run_jobs(CFG, [dict(image=b.image, shared_init=b.shared_init,
                                tdx_dim=b.tdx_dim) for b in benches] * 2,
                     device="cpu")
    fleet = Fleet(CFG, trace=True, device="cpu")
    hs = [fleet.submit(b.image, b.shared_init, tdx_dim=b.tdx_dim)
          for b in benches * 2]
    results = fleet.drain()
    for r, h in zip(plain, hs):
        assert np.array_equal(r.shared, results[h].shared)
        assert results[h].counters is not None
    names = {e["name"] for e in fleet.tracer.events}
    assert {"drain", "partition", "batch", "dispatch", "collect",
            "drain_counters"} <= names
    assert isinstance(fleet.tracer, Tracer)


def test_alu16_masks_lodi_tdx_tdy():
    cfg16 = EGPUConfig(max_threads=32, regs_per_thread=16, shared_kb=2,
                       alu_bits=16, shift_bits=16)
    a = Asm(cfg16)
    a.lodi(1, -1)          # sign-extends to 0xFFFFFFFF on a 32-bit ALU
    a.tdx(2)
    a.sto(1, 2, 0)
    a.stop()
    img1 = a.assemble(threads_active=32)
    a = Asm(cfg16)
    a.lodi(1, -1)
    a.lodi(2, 1)
    a.add(3, 1, 2, typ=Typ.U32)
    a.tdx(4)
    a.sto(3, 4, 0)
    a.stop()
    img2 = a.assemble(threads_active=32)
    for use_compiler in (True, False):
        fleet = Fleet(cfg16, use_compiler=use_compiler, device="cpu")
        h1 = [fleet.submit(img1, tdx_dim=32) for _ in range(2)]
        h2 = [fleet.submit(img2, tdx_dim=32) for _ in range(2)]
        res = fleet.drain()
        for h in h1:
            assert (res[h].shared_u32()[:32] == 0xFFFF).all()
        for h in h2:
            assert res[h].shared_u32()[0] == 0     # 0xFFFF + 1 == 0


def test_entry_points_default_to_the_card():
    """``Fleet``, ``FleetScheduler`` and ``fleet_run`` run on the card
    unless asked for the CPU and raise without one; the sharded fleet
    and the serving loop name the queue items that port them."""
    img = _loop_prog()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Fleet(CFG)
        with pytest.raises(RuntimeError, match="CUDA"):
            FleetScheduler(CFG)
        with pytest.raises(RuntimeError, match="CUDA"):
            fleet_run([img])
    with pytest.raises(NotImplementedError, match="item 9"):
        Fleet(CFG, devices="all", device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        serve_jobs(CFG, [dict(image=img)])
