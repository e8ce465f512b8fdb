#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --suite-ab PARENT

Phases, in order; any failure exits non-zero and prints no result:

1. build the hand-written CUDA kernels from ``src/repro_torch/kernels/
   csrc`` with nvcc for sm_90a;
2. hold each kernel against its plain PyTorch version on CUDA tensors,
   bit for bit (bfloat16 dot at the reference tests' rtol 2e-2): the
   eGPU kernels' ``tile`` routes at the shapes of the reference's
   ``tests/test_kernels.py`` and of one register column, their ``step``
   routes on (B, 512, 32) register files at the main path's B = 1, 4
   and 18 with mixed opcodes and predicates, all on tensors of special
   values (NaN payloads, +-inf, +-0, subnormals);
3. drive the main path: every paper-size suite job through
   ``run_program``, then all of them as lock-step ``fleet_run`` batches
   (one per configuration), each result held against its numpy oracle
   and every leaf against the committed digests of the JAX reference
   (``src/repro_torch/programs/reference_digests.json``); each job is
   also run on the CPU and its leaves compared with the CUDA run's.
   The kernels' launch counters (in all and by route) are zeroed just
   before and read just after the CUDA runs; each must be > 0, every
   eGPU launch on the ``step`` route.  Then FP and DOT/SUM steps under
   ``torch.profiler``: kernels and torch ops a step and host µs a step,
   the main path's (one kernel, no torch op, or it fails) beside the
   previous composition's;
   3b. the compiled tiers (``core/blockc.py``): every suite job through
   ``run_compiled`` under ``blocks``, ``superblock`` and ``auto`` (the
   card's tier policy), each block or superblock segment replayed as a
   CUDA graph captured beforehand (``light_compile``), every leaf held
   against the digests and each job's ``step``-route launches against
   its ``run_program``'s in this call (the counters zeroed just before
   and read just after; none on ``tile``); ``run_light`` against
   ``run``; one lock-step ``run_batch`` of ``matmul_64_dp`` over four
   shared images and four TDX grids against ``run_program`` on the card
   (row 0 against the digests) and ``run_batch_light``; prints µs a
   simulated step by tier and job class (medians of runs, and the
   device time summed over the graphs a run replays) beside
   ``run_program``'s timed the same way, graph replays a run and
   capture seconds;
   3c. the fleet scheduler (``fleet/scheduler.py``, ``fleet/api.py``):
   the 22 jobs, each submitted three times with its own inputs, through
   ``Fleet`` on the card (one fleet for each of the suite's
   configurations), every ``JobResult`` held against the digests: drain
   A on the compiled tiers (no degraded unit), drain B the same
   submissions replayed from resident inputs (a residency hit a
   compiled batch, results equal to A's), drain C on the interpreter
   (``use_compiler=False``, ``fleet_run`` batches of 32), drain D
   ``drain_isolated`` under a seeded ``FaultPlan`` (one ``compile``
   and one ``dispatch`` fault); every launch on the ``step`` route;
   then every job through ``compile_program(optimize=True)`` under
   ``blocks`` and ``superblock`` against
   ``programs/reference_digests_optimized.json``; prints each drain's
   wall, jobs/s, batches by tier, compile seconds, residency hits and
   µs a job step beside phase 3b's tiers;
4. time each eGPU kernel four ways, device time (a CUDA graph of
   launches) and eager: the ``step`` route as ``run_program`` issues
   it, the ``tile`` route, the previous composition and one PyTorch
   library call for the same function; the plain version eagerly;
5. the LM serving path (``repro_torch.launch.serve``): the LM kernels
   (``wavefront_matmul``, ``flash_attention``), every route of each
   (``ops.route``: ``wgmma``, ``small_m``, ``split``, ``simt``), against
   their plain
   versions within their stated tolerances, inactive tiles zero and
   poisoned tails changing no bit; the smoke serve against the JAX
   reference's committed run
   (``src/repro_torch/models/reference_serve.json``), float32 and
   bfloat16; then granite-moe-3b-a800m at full width and depth in
   bfloat16 (8 requests x prompt 512, 32 decode steps, ``max_len``
   1024), its kernel counters (in all and by route) zeroed just before
   and read just after, every prefill GEMM and attention on ``wgmma``,
   every decode GEMM on ``small_m`` and every decode attention on
   ``split``, its logits checked finite; then
   each LM kernel held against its plain version and timed at the
   serve's six exact shapes: the routed kernel, the previous design (the
   ``simt`` kernel on the same bf16 inputs), the plain version and a
   library call, with the bound; kernels and library calls by device
   time (launches captured in a CUDA graph), the plain version eagerly.

The last two lines of standard output are the kernels' JSON and the
device JSON ``{"ok": true, "device": {...}}``.  It imports nothing of
JAX or of the JAX package ``repro``.

``--suite-ab PARENT`` times the main path alone (the suite through
``run_program`` and both ``fleet_run`` batches, leaves held against the
digests) on the port of an older checkout (``PARENT``, its root) and on
this one, each in its own process, in turns (parent, this, this,
parent), and prints each run and the medians.
"""
from __future__ import annotations

import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and
#: float32 (non-tensor-core) FLOP/s, at the 700 W limit
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

SPECIAL_BITS = np.array([
    0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
    0x7FA00000, 0xFFB00000, 0x7F800001, 0x00400000, 0x80400000, 0x00000001,
    0x807FFFFF, 0x00800000, 0x80800000, 0x3F800000, 0xBF800000, 0x7F7FFFFF,
    0xFF7FFFFF, 0x1F800000, 0x1F000000, 0x20000000, 0x3FB33068,
    0x005B6F21], np.uint32)


def log(*a):
    print(*a, flush=True)


def special(rng, shape):
    """float32 bits: special values mixed with random patterns."""
    n = int(np.prod(shape))
    bits = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    pick = rng.random(n) < 0.6
    bits[pick] = SPECIAL_BITS[rng.integers(0, len(SPECIAL_BITS), pick.sum())]
    return bits.view(np.float32).reshape(shape)


def bits_equal(x, y) -> bool:
    import torch
    return bool(torch.equal(x.contiguous().view(torch.int32),
                            y.contiguous().view(torch.int32)))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def fleet_batches() -> dict:
    """The main path's ``fleet_run`` batches, as indices into the suite:
    one batch per configuration.  The has_dot flag changes no leaf, so
    every job but bitonic shares the "dot" configuration's batch."""
    from repro_torch.programs import suite
    return {"dot": [i for i, s in enumerate(suite.SUITE) if s[3] != "pred2"],
            "pred2": [i for i, s in enumerate(suite.SUITE)
                      if s[3] == "pred2"]}


def main_path_rows() -> tuple:
    """``(rows, cores)``: a core's register column as the ``tile`` routes
    take it, ``(T / 16, 16)``, and the batch sizes of the main path's
    step launches (``run_program`` is one core, each ``fleet_run`` batch
    its cores)."""
    from repro_torch.core import benchmark_config
    cfg = benchmark_config()
    rows = cfg.max_threads // cfg.num_sps
    return rows, sorted({1} | {len(idx) for idx in fleet_batches().values()})


def check_kernels(dev) -> dict:
    import torch
    from repro_torch.kernels.dot_product import ops as dops, ref as dref
    from repro_torch.kernels.wavefront_alu import ops as wops, ref as wref

    rng = np.random.default_rng(42)
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    worst = {"wavefront_alu": 0.0, "dot_product": 0.0}
    rows, cores = main_path_rows()

    alu_cases = [("normal", t, l) for t, l in ((8, 128), (32, 128), (64, 256))]
    alu_cases += [("special", 32, 128), ("special", 2, 16)]
    alu_cases += [(kind, c * rows, 16) for c in cores
                  for kind in ("normal", "special")]
    n_alu = 0
    for kind, t, l in alu_cases:
        for op in wref.OPS:
            mk = (lambda s: special(rng, s)) if kind == "special" else \
                (lambda s: rng.standard_normal(s).astype(np.float32))
            a, b, init = to(mk((t, l))), to(mk((t, l))), to(mk((t, l)))
            act = to(rng.integers(0, 2, -(-t // 8)).astype(np.int32))
            got = wops.wavefront_alu(a, b, init, act, op)
            exp = wref.wavefront_alu_ref(a, b, init, act, op)
            torch.cuda.synchronize()
            if not bits_equal(got, exp):
                raise AssertionError(f"wavefront_alu {op} {kind} ({t},{l}) "
                                     "differs from its plain version")
            n_alu += 1
    log(f"[kernels] wavefront_alu: {n_alu} cases bit-identical "
        "(incl. NaN payloads, +-inf, +-0, subnormals, ragged tiles)")

    dot_cases = [(None, t, l, dt) for t, l in ((8, 128), (64, 128), (32, 512))
                 for dt in ("f32", "bf16")]
    dot_cases += [(c, rows, 16, kind) for c in cores
                  for kind in ("f32", "special")]
    dot_cases += [(None, 64, 128, "special")]
    n_dot = 0
    for batch, t, l, dt in dot_cases:
        lead = () if batch is None else (batch,)
        shp = lead + (t, l)
        if dt == "special":
            a, b = to(special(rng, shp)), to(special(rng, shp))
        else:
            a = to(rng.standard_normal(shp).astype(np.float32))
            b = to(rng.standard_normal(shp).astype(np.float32))
            if dt == "bf16":
                a, b = a.bfloat16(), b.bfloat16()
        act = to(rng.integers(0, 2, lead + (-(-t // 8),)).astype(np.int32))
        got = dops.dot_product(a, b, act)
        exp = dref.dot_product_ref(a, b, act)
        torch.cuda.synchronize()
        if dt == "bf16":
            err = float((got - exp).abs().max())
            worst["dot_product"] = max(worst["dot_product"], err)
            if not torch.allclose(got, exp, rtol=2e-2):
                raise AssertionError(f"dot_product bf16 ({t},{l}) off "
                                     f"by {err}")
        elif not bits_equal(got, exp):
            raise AssertionError(f"dot_product {dt} {shp} differs from its "
                                 "plain version")
        n_dot += 1
    # det_sum order: a 16-lane dot is bit-identical to the plain det_sum
    from repro_torch.core import semantics
    from repro_torch.kernels import fp32
    a, b = to(special(rng, (8, 512))), to(special(rng, (8, 512)))
    ones = torch.ones((8, 4), dtype=torch.int32, device=dev)
    got = dops.dot_product(a.view(8, 32, 16), b.view(8, 32, 16), ones)
    prod = fp32.mul(a.view(torch.int32), b.view(torch.int32))
    exp = fp32.as_f32(semantics.det_sum(prod).contiguous())
    torch.cuda.synchronize()
    if not bits_equal(got, exp):
        raise AssertionError("dot_product differs from det_sum at L=16")
    log(f"[kernels] dot_product: {n_dot + 1} cases bit-identical (bf16 "
        f"within rtol 2e-2, max abs err {worst['dot_product']}), det_sum "
        "order at 16 lanes")
    return worst


#: the eGPU register file of the paper's benchmark configuration
EGPU_T, EGPU_R = 512, 32


def step_case(dev, rng, batch, with_pred, kinds=None):
    """Step-kernel inputs at the main path's shapes: a ``(batch, 512, 32)``
    register file of special values, one trace row a core (opcodes drawn
    from ``kinds``, default a mix of FP, DOT, SUM and others; rd/ra/rb
    often equal), random TSC masks and, if asked, a predicate mask."""
    import torch
    from repro_torch.core import Op, executor
    pool = kinds or ([int(o) for o in executor.FP_OPCODES
                      + executor.EXT_OPCODES]
                     + [int(Op.ADD), int(Op.LOD), int(Op.NOP)])
    regs = torch.from_numpy(special(rng, (batch, EGPU_T, EGPU_R))
                            .view(np.int32)).to(dev)
    rows = np.zeros((batch, 7), np.int64)
    rows[:, 0] = rng.choice(pool, batch)
    rows[:, 2:5] = rng.integers(0, 4, (batch, 3))
    rows[:, 6] = rng.integers(0, 16, batch)
    masks = torch.from_numpy(rng.random((batch, 16, EGPU_T)) < 0.7).to(dev)
    pred = torch.from_numpy(rng.random((batch, EGPU_T)) < 0.6).to(dev) \
        if with_pred else None
    return regs, torch.from_numpy(rows).to(dev), masks, pred


def check_step_kernels(dev) -> None:
    """Both step kernels against their plain versions, bit for bit, at the
    main path's batch sizes (1 core, the 4- and 18-core fleet batches),
    512 threads and 32 registers, with and without a predicate mask."""
    import torch
    from repro_torch.core import executor
    from repro_torch.kernels.dot_product import ops as dops, ref as dref
    from repro_torch.kernels.wavefront_alu import ops as wops, ref as wref
    rng = np.random.default_rng(17)
    forms = (("wavefront_alu", wops.fp_step, wref.fp_step_ref,
              executor.FP_OPCODES),
             ("dot_product", dops.ext_step, dref.ext_step_ref,
              executor.EXT_OPCODES))
    n = 0
    for batch in sorted({1} | set(main_path_rows()[1])):
        for with_pred in (False, True):
            for kinds in (None, list(executor.FP_OPCODES),
                          list(executor.EXT_OPCODES)):
                regs, rows, masks, pred = step_case(dev, rng, batch,
                                                    with_pred, kinds)
                for name, run, plain, opcodes in forms:
                    got, exp = regs.clone(), regs.clone()
                    run(got, rows, masks, pred, opcodes)
                    plain(exp, rows, masks, pred, opcodes)
                    torch.cuda.synchronize()
                    if not torch.equal(got, exp):
                        raise AssertionError(
                            f"{name} step, {batch} cores, pred {with_pred}: "
                            "differs from its plain version")
                    n += 1
    log(f"[kernels] step routes (wavefront_alu fp_step, dot_product "
        f"ext_step): {n} cases bit-identical at (B, {EGPU_T}, {EGPU_R}), "
        "B = 1, 4, 18, mixed opcodes, with and without predicates, "
        "special values")


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def run_suite(dev) -> dict:
    import torch
    from repro_torch import programs
    from repro_torch.core import benchmark_config, run_program
    from repro_torch.core.machine import state_to_numpy
    from repro_torch.fleet import fleet_run, unstack_state
    from repro_torch.kernels.dot_product.ops import dot_product
    from repro_torch.kernels.wavefront_alu.ops import wavefront_alu
    from repro_torch.programs import suite

    digests = suite.load_digests()
    jobs = suite.build_suite(programs, benchmark_config)

    def held(b, st, where):
        ok, err = programs.check(b, st)
        if not ok:
            raise AssertionError(f"{where} {b.name}: oracle mismatch "
                                 f"(max abs err {err})")
        leaves = state_to_numpy(st)
        got = suite.leaf_digests(leaves)
        bad = [k for k, v in digests[b.name]["leaves"].items() if got[k] != v]
        if bad:
            raise AssertionError(f"{where} {b.name}: leaves {bad} differ "
                                 "from the JAX reference's digests")
        return leaves, err

    fleet_jobs = {c: suite.build_suite(
        programs, benchmark_config, [suite.SUITE[i] for i in idx], config=c)
        for c, idx in fleet_batches().items()}

    for f in (wavefront_alu, dot_product):
        f.launches = 0
        f.by_route = dict.fromkeys(f.by_route, 0)
    cuda_leaves, rows, job_launches = {}, [], {}
    t_main = time.perf_counter()
    for b in jobs:
        c0 = step_launches()
        t0 = time.perf_counter()
        st = run_program(b.image, shared_init=b.shared_init,
                         tdx_dim=b.tdx_dim, device=dev)
        wall = time.perf_counter() - t0
        job_launches[b.name] = minus(step_launches(), c0)
        leaves, err = held(b, st, "run_program")
        cuda_leaves[b.name] = leaves
        rows.append((b.name, int(st.steps), int(st.cycles), wall, err))
        log(f"[suite] run_program {b.name}: steps {int(st.steps)} cycles "
            f"{int(st.cycles)} wall {wall:.3f}s oracle ok (max abs err "
            f"{err:.3g}) digests ok")
    rp_steps, rp_wall = sum(r[1] for r in rows), sum(r[3] for r in rows)
    log(f"[suite] run_program: {rp_steps} steps in {rp_wall:.3f}s summed, "
        f"{1e6 * rp_wall / rp_steps:.1f} us/step")
    for c, bj in fleet_jobs.items():
        t0 = time.perf_counter()
        out = fleet_run([b.image for b in bj],
                        init_kw=[dict(shared_init=b.shared_init,
                                      tdx_dim=b.tdx_dim) for b in bj],
                        device=dev)
        wall = time.perf_counter() - t0
        steps = 0
        for i, b in enumerate(bj):
            st = unstack_state(out, i)
            held(b, st, f"fleet_run[{c}]")
            steps += int(st.steps)
        log(f"[suite] fleet_run batch '{c}': {len(bj)} cores, {steps} core "
            f"steps, wall {wall:.3f}s, every core's oracle and digests ok")
    torch.cuda.synchronize()
    main_wall = time.perf_counter() - t_main
    launches = {"wavefront_alu": wavefront_alu.launches,
                "dot_product": dot_product.launches}
    routes = {"wavefront_alu": dict(wavefront_alu.by_route),
              "dot_product": dict(dot_product.by_route)}
    log(f"[suite] main path wall {main_wall:.3f}s, kernel launches "
        f"{launches}, by route {routes}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"{k} was never launched on the main path")
    for k, v in routes.items():
        # every FP and DOT/SUM step is one launch of the step route
        if v["step"] != launches[k] or v["tile"]:
            raise AssertionError(f"{k}: the main path's launches by route "
                                 f"{v}, expected all on 'step'")

    t0 = time.perf_counter()
    for b in jobs:
        cpu = run_program(b.image, shared_init=b.shared_init,
                          tdx_dim=b.tdx_dim, device="cpu")
        got = state_to_numpy(cpu)
        bad = [k for k, v in cuda_leaves[b.name].items()
               if not np.array_equal(v, got[k])]
        if bad:
            raise AssertionError(f"{b.name}: CUDA and CPU leaves {bad} differ")
    log(f"[suite] every job's CUDA leaves equal its CPU run's "
        f"({time.perf_counter() - t0:.1f}s on the CPU)")
    return {"launches": launches, "routes": routes, "jobs": rows,
            "job_launches": job_launches,
            "steps": sum(r[1] for r in rows), "wall_s": main_wall}


def step_launches() -> dict:
    """The eGPU kernels' ``step``-route launch counts, by kernel."""
    return {k: f.by_route["step"] for k, f in egpu_counters().items()}


def minus(a: dict, b: dict) -> dict:
    return {k: a[k] - b[k] for k in a}


# ---------------------------------------------------------------------------
# phase 3b: the compiled tiers (core/blockc.py), units replayed as CUDA graphs
# ---------------------------------------------------------------------------

#: job classes of the compiled-tier report, by program name prefix
TIER_CLASSES = {"matmul": ("matmul",), "bitonic/fft": ("bitonic", "fft"),
                "reductions/transposes": ("reduction", "transpose")}


def job_class(name: str) -> str:
    return next(c for c, pre in TIER_CLASSES.items()
                if name.startswith(pre))


TIER_REPS = 5


def median_s(fn, reps=TIER_REPS) -> float:
    """Host seconds of ``fn()`` (which ends in a synchronise), the median
    of ``reps`` calls."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def unit_device_ms(cp, dev, reps=20) -> float:
    """Device ms of one run of a compiled program's plan at batch 1: each
    distinct unit's graph replayed ``reps`` times back to back between
    CUDA events, summed over the run's replay order (so the host's issue
    between replays is left out wherever the card is the slower)."""
    import torch
    plan = cp._plans[dev, 1]
    per = {}
    for u in plan._units.values():
        u.run()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            u.run()
        e1.record()
        e1.synchronize()
        per[id(u)] = e0.elapsed_time(e1) / reps
    return sum(per[id(u)] for u in plan.order)


def run_tiers(dev, interp: dict) -> dict:
    """The 22 suite jobs through ``run_compiled`` under ``blocks``,
    ``superblock`` and ``auto`` (``auto`` under the card's tier policy,
    ``default_policy_for_device``), every leaf held against the
    reference's digests; each job's ``step``-route launches equal to its
    ``run_program``'s in this call (``interp``), none on ``tile``.  The
    graphs are captured first (``light_compile``; the capture is not
    the run); the eGPU kernels' counters are zeroed just before the runs
    and read just after.  Then the light path against the full path, and
    one lock-step ``run_batch`` of a matmul job over four shared images
    with four TDX grids against ``run_program`` on the card.  Prints µs
    per simulated step by tier and job class (``run`` and ``run_light``,
    each the median of :data:`TIER_REPS` runs, and the device time,
    :func:`unit_device_ms`) beside ``run_program``'s (the median of 3
    runs, timed in the same place), graph replays a run and capture
    seconds."""
    import torch
    from repro_torch import programs
    from repro_torch.core import (benchmark_config, compile_program,
                                  run_compiled, run_program)
    from repro_torch.core.blockc import default_policy_for_device
    from repro_torch.core.machine import state_to_numpy
    from repro_torch.fleet import unstack_state
    from repro_torch.programs import suite

    digests = suite.load_digests()
    jobs = suite.build_suite(programs, benchmark_config)
    policy = default_policy_for_device(dev)
    modes = {"blocks": None, "superblock": None, "auto": policy}
    kw = lambda b: dict(shared_init=b.shared_init, tdx_dim=b.tdx_dim)

    def held(b, st, where):
        got = suite.leaf_digests(state_to_numpy(st))
        bad = [k for k, v in digests[b.name]["leaves"].items() if got[k] != v]
        if bad:
            raise AssertionError(f"{where} {b.name}: leaves {bad} differ "
                                 "from the JAX reference's digests")

    cps, capture = {}, {}
    for mode, pol in modes.items():
        for b in jobs:
            cp = compile_program(b.image, mode=mode, policy=pol)
            cps[mode, b.name] = cp
            capture[mode, b.name] = cp.light_compile(
                np.zeros(cp.cfg.shared_words, np.uint32), b.tdx_dim, dev)
    counters = egpu_counters()
    for f in counters.values():
        f.launches = 0
        f.by_route = dict.fromkeys(f.by_route, 0)
    rows, runs = [], {}
    for mode, pol in modes.items():
        for b in jobs:
            c0 = step_launches()
            st = run_compiled(b.image, fallback=False, mode=mode, policy=pol,
                              device=dev, **kw(b))
            got = minus(step_launches(), c0)
            held(b, st, f"run_compiled[{mode}]")
            if got != interp["job_launches"][b.name]:
                raise AssertionError(
                    f"{mode} {b.name}: step launches {got}, run_program's "
                    f"{interp['job_launches'][b.name]}")
            cp = cps[mode, b.name]
            gs = cp.graph_stats(dev)
            runs[mode, b.name] = st
            rows.append({"mode": mode, "tier": cp.mode, "job": b.name,
                         "steps": int(st.steps), "replays": gs["replays"],
                         "graphs": gs["graphs"],
                         "capture_s": capture[mode, b.name]})
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    routes = {k: dict(f.by_route) for k, f in counters.items()}
    log(f"[tiers] {len(rows)} runs ({len(jobs)} jobs x blocks, superblock, "
        "auto) "
        f"match the digests; kernel launches {launches}, by route {routes}; "
        "each job's step launches equal its run_program's")
    for k, v in routes.items():
        if v["step"] <= 0 or v["tile"] or v["step"] != launches[k]:
            raise AssertionError(f"{k}: the compiled tiers' launches by "
                                 f"route {v}, expected all on 'step'")

    for (mode, name), st in runs.items():
        b = next(j for j in jobs if j.name == name)
        sh, cyc, halted = cps[mode, name].run_light(device=dev, **kw(b))
        if not (torch.equal(sh, st.shared) and cyc == int(st.cycles)
                and halted == bool(st.halted)):
            raise AssertionError(f"{mode} {name}: run_light differs from run")
    log(f"[tiers] run_light's (shared, cycles, halted) equal run's for all "
        f"{len(runs)} runs")

    # timing, after the checked runs: the median of TIER_REPS runs each
    # (one run of a short job is 1-2 ms, where the host's jitter shows)
    rp = {b.name: median_s(lambda b=b: run_program(b.image, device=dev,
                                                    **kw(b)), 3)
          for b in jobs}
    for r in rows:
        b = next(j for j in jobs if j.name == r["job"])
        cp, pol = cps[r["mode"], r["job"]], modes[r["mode"]]
        r["wall_s"] = median_s(lambda: run_compiled(
            b.image, fallback=False, mode=r["mode"], policy=pol, device=dev,
            **kw(b)))
        r["light_s"] = median_s(lambda: cp.run_light(device=dev, **kw(b)))
        r["device_ms"] = unit_device_ms(cp, dev)

    b = next(j for j in jobs if j.name == "matmul_64_dp")
    rng = np.random.default_rng(15)
    n = np.asarray(b.shared_init).size
    inits = [b.shared_init] + [rng.standard_normal(n).astype(np.float32)
                               for _ in range(3)]
    tdx = [b.tdx_dim, 8, 16, 32]
    cp = compile_program(b.image, policy=policy, batch_hint=len(inits))
    out = cp.run_batch(inits, tdx, device=dev)
    for i, (s0, d) in enumerate(zip(inits, tdx)):
        ref = state_to_numpy(run_program(b.image, shared_init=s0, tdx_dim=d,
                                         device=dev))
        got = state_to_numpy(unstack_state(out, i))
        bad = [k for k in ref if not np.array_equal(ref[k], got[k])]
        if bad:
            raise AssertionError(f"run_batch row {i}: leaves {bad} differ "
                                 "from run_program's")
    held(b, unstack_state(out, 0), "run_batch row 0")
    lsh, lcyc, lhalt = cp.run_batch_light(inits, tdx, device=dev)
    if not (torch.equal(lsh, out.shared) and torch.equal(lcyc, out.cycles)
            and torch.equal(lhalt, out.halted)):
        raise AssertionError("run_batch_light differs from run_batch")
    log(f"[tiers] run_batch {b.name} on the {cp.mode} tier, 4 cores, tdx "
        f"{tdx}: every core's leaves equal run_program's on the card, row 0 "
        "the digests; run_batch_light equal")

    summary = {}
    for mode in modes:
        for cls in TIER_CLASSES:
            rs = [r for r in rows if r["mode"] == mode
                  and job_class(r["job"]) == cls]
            steps = sum(r["steps"] for r in rs)
            rp_wall = sum(rp[r["job"]] for r in rs)
            summary[mode, cls] = {
                "us_per_step": 1e6 * sum(r["wall_s"] for r in rs) / steps,
                "light_us_per_step": 1e6 * sum(r["light_s"] for r in rs)
                / steps,
                "device_us_per_step": 1e3 * sum(r["device_ms"] for r in rs)
                / steps,
                "run_program_us_per_step": 1e6 * rp_wall / steps,
                "replays": sum(r["replays"] for r in rs),
                "graphs": sum(r["graphs"] for r in rs),
                "capture_s": sum(r["capture_s"] for r in rs),
                "steps": steps, "tiers": sorted({r["tier"] for r in rs})}
            v = summary[mode, cls]
            log(f"[tiers] {mode:10s} {cls:22s} {v['us_per_step']:8.2f} us a "
                f"step (run_light {v['light_us_per_step']:.2f}, device "
                f"{v['device_us_per_step']:.2f}; run_program "
                f"{v['run_program_us_per_step']:.2f}); "
                f"{v['replays']} graph replays a run over {v['steps']} "
                f"steps, {v['graphs']} graphs captured in "
                f"{v['capture_s']:.3f}s; tiers {v['tiers']}")
    for mode in modes:
        rs = [r for r in rows if r["mode"] == mode]
        steps = sum(r["steps"] for r in rs)
        us = 1e6 * sum(r["wall_s"] for r in rs) / steps
        light = 1e6 * sum(r["light_s"] for r in rs) / steps
        dev_us = 1e3 * sum(r["device_ms"] for r in rs) / steps
        rp_us = 1e6 * sum(rp[r["job"]] for r in rs) / steps
        summary[mode, "suite"] = {"us_per_step": us,
                                  "light_us_per_step": light,
                                  "device_us_per_step": dev_us,
                                  "run_program_us_per_step": rp_us}
        log(f"[tiers] {mode}: {us:.2f} us a step over the suite (run_light "
            f"{light:.2f}, device {dev_us:.2f}; run_program {rp_us:.2f}); "
            f"{sum(r['replays'] for r in rs)} replays, capture "
            f"{sum(r['capture_s'] for r in rs):.3f}s")
    for r in rows:
        log(f"[tiers-job] {r['mode']} {r['job']} ({r['tier']}): "
            f"{r['steps']} steps, {r['replays']} replays, {r['graphs']} "
            f"graphs, capture {r['capture_s']:.4f}s, run "
            f"{1e6 * r['wall_s'] / r['steps']:.2f} us a step (run_light "
            f"{1e6 * r['light_s'] / r['steps']:.2f}, device "
            f"{1e3 * r['device_ms'] / r['steps']:.2f}; run_program "
            f"{1e6 * rp[r['job']] / r['steps']:.2f})")
    return {"launches": launches, "routes": routes,
            "summary": {f"{m}/{c}": v for (m, c), v in summary.items()}}


# ---------------------------------------------------------------------------
# phase 3c: the fleet scheduler (fleet/scheduler.py, fleet/api.py)
# ---------------------------------------------------------------------------

#: each suite job is submitted this many times a drain, with its own inputs
FLEET_COPIES = 3


def result_held(table: dict, name: str, r, where: str) -> None:
    """A ``JobResult`` against a digest file's entry: the shared words,
    the Fig. 6 counters and the hazard violations by digest (the
    reference's dtypes), cycles and steps by value."""
    from repro_torch.programs import suite
    want = table[name]
    got = suite.leaf_digests({
        "shared": r.shared, "stat_cycles": r.stat_cycles,
        "stat_instrs": r.stat_instrs,
        "hazard_violations": np.int32(r.hazard_violations)})
    bad = [k for k, v in got.items() if v != want["leaves"][k]]
    bad += [k for k in ("cycles", "steps") if getattr(r, k) != want[k]]
    if r.shared.dtype != np.uint32:
        bad.append("shared dtype")
    if bad:
        raise AssertionError(f"{where} {name}: {bad} differ from the JAX "
                             "reference's digests")


def fleet_stats(stats) -> dict:
    reg = stats.registry
    tiers = {t: int(reg.total("fleet_batches_total", tier=t))
             for t in ("superblock", "blocks", "interp")}
    return {"jobs": stats.jobs, "batches": stats.batches,
            "batches_by_tier": tiers, "pad_slots": stats.pad_slots,
            "compile_s": stats.compile_s, "wall_s": stats.wall_s,
            "residency_hits": stats.residency_hits,
            "residency_misses": stats.residency_misses,
            "degraded_units": stats.degraded_units,
            "bisections": stats.bisections,
            "salvaged_jobs": stats.salvaged_jobs}


def stats_minus(a: dict, b: dict) -> dict:
    out = {}
    for k, v in a.items():
        out[k] = stats_minus(v, b[k]) if isinstance(v, dict) else v - b[k]
    return out


def graphs_on_card() -> int:
    """CUDA graphs held by the compile cache's programs, on the card."""
    from repro_torch.core import blockc
    return sum(len(plan._units) for cp in blockc._CACHE.values()
               if isinstance(cp, blockc.CompiledProgram)
               for (d, _), plan in cp._plans.items() if d.type == "cuda")


def run_fleet(dev, tiers: dict) -> dict:
    """Phase 3c: the 22 suite jobs, each submitted :data:`FLEET_COPIES`
    times with its own inputs, through ``Fleet`` on the card, one fleet a
    configuration of the suite (:func:`fleet_batches`: a fleet shares one
    ``EGPUConfig``), every ``JobResult`` held against the reference's
    digests.  Drain A: same-program groups on the compiled tiers (no
    degraded unit); drain B: the same submissions again, replayed from
    resident inputs (a residency hit a compiled batch), results equal to
    A's; drain C: ``use_compiler=False``, mixed interpreter ``fleet_run``
    batches of 32; drain D: ``FleetScheduler.drain_isolated`` under a
    seeded ``FaultPlan`` that fires ``compile`` once and ``dispatch``
    once.  The eGPU kernels' counters are zeroed just before the drains
    and read just after: every launch on ``step``.  Then every suite job
    through ``compile_program(optimize=True)`` under ``blocks`` and
    ``superblock``, each leaf held against
    ``programs/reference_digests_optimized.json``.  Prints each drain's
    wall, jobs/s, batches by tier, compile seconds, residency hits and
    µs a job step beside phase 3b's tiers."""
    import torch
    from repro_torch import programs
    from repro_torch.core import benchmark_config, compile_program
    from repro_torch.core.machine import state_to_numpy
    from repro_torch.fleet import FaultPlan, Fleet, FleetScheduler
    from repro_torch.programs import suite

    digests = suite.load_digests()
    groups = {c: suite.build_suite(programs, benchmark_config,
                                   [suite.SUITE[i] for i in idx], config=c)
              for c, idx in fleet_batches().items()}
    cfgs = {c: benchmark_config(**suite.CONFIGS[c]) for c in groups}

    def drain(fleets: dict, label: str, isolated: bool = False):
        """Submit every job FLEET_COPIES times to its configuration's
        fleet and drain them all; returns ``({(job, copy): JobResult},
        wall seconds, stats delta summed over the fleets)``."""
        before = {c: fleet_stats(f.stats) for c, f in fleets.items()}
        graphs0 = graphs_on_card()
        out, wall = {}, 0.0
        for c, f in fleets.items():
            hs = {}
            for k in range(FLEET_COPIES):
                for b in groups[c]:
                    h = f.submit(b.image, b.shared_init, tdx_dim=b.tdx_dim,
                                 tag=b.name)
                    hs[h] = (b.name, k)
            t0 = time.perf_counter()
            res = f.drain_isolated() if isolated else f.drain()
            wall += time.perf_counter() - t0
            if isolated:
                res, failures = res
                if failures:
                    raise AssertionError(f"drain {label}: failures "
                                         f"{sorted(failures)}")
            if sorted(res) != sorted(hs):
                raise AssertionError(f"drain {label}: delivered handles "
                                     "differ from the submitted ones")
            for h, key in hs.items():
                result_held(digests, key[0], res[h], f"drain {label}")
                out[key] = res[h]
        deltas = [stats_minus(fleet_stats(f.stats), before[c])
                  for c, f in fleets.items()]
        total = deltas[0]
        for d in deltas[1:]:
            total = {k: ({t: v[t] + d[k][t] for t in v}
                         if isinstance(v, dict) else v + d[k])
                     for k, v in total.items()}
        steps = sum(r.steps for r in out.values())
        total["graphs_captured"] = graphs_on_card() - graphs0
        log(f"[fleet] drain {label}: {len(out)} jobs in {wall:.3f}s wall "
            f"({len(out) / wall:.1f} jobs/s; execution "
            f"{total['wall_s']:.3f}s, {len(out) / total['wall_s']:.1f} "
            f"jobs/s), {1e6 * wall / steps:.2f} us a job step over "
            f"{steps} job steps ({1e6 * total['wall_s'] / steps:.2f} "
            f"executing); batches {total['batches']} by tier "
            f"{total['batches_by_tier']}, pad slots {total['pad_slots']}, "
            f"compile_s {total['compile_s']:.3f} ("
            f"{total['graphs_captured']} graphs captured), residency hits "
            f"{total['residency_hits']} misses {total['residency_misses']}, "
            f"degraded units {total['degraded_units']}, bisections "
            f"{total['bisections']}, salvaged jobs "
            f"{total['salvaged_jobs']}; every result holds against the "
            "digests")
        total.update(jobs_delivered=len(out), drain_wall_s=wall,
                     job_steps=steps, us_per_job_step=1e6 * wall / steps)
        return out, total

    def same(a: dict, b: dict, label: str) -> None:
        for key, r in a.items():
            g = b[key]
            if not (np.array_equal(r.shared, g.shared)
                    and (r.cycles, r.steps, r.hazard_violations)
                    == (g.cycles, g.steps, g.hazard_violations)
                    and np.array_equal(r.stat_cycles, g.stat_cycles)
                    and np.array_equal(r.stat_instrs, g.stat_instrs)):
                raise AssertionError(f"drain {label} {key}: differs from "
                                     "drain A")

    counters = egpu_counters()
    for f in counters.values():
        f.launches = 0
        f.by_route = dict.fromkeys(f.by_route, 0)
    fleets = {c: Fleet(cfg, batch_size=32, device=dev)
              for c, cfg in cfgs.items()}
    a, sa = drain(fleets, "A")
    if sa["degraded_units"]:
        raise AssertionError(f"drain A degraded {sa['degraded_units']} "
                             "units")
    rejected = sorted({k[0] for k, r in a.items() if r.tier == "interp"})
    if rejected:
        log(f"[fleet] drain A: the compiler rejected {rejected}; they ran "
            "on the interpreter")
    b_, sb = drain(fleets, "B")
    compiled_b = sb["batches_by_tier"]["superblock"] \
        + sb["batches_by_tier"]["blocks"]
    if sb["residency_hits"] != compiled_b or sb["degraded_units"]:
        raise AssertionError(f"drain B: residency hits "
                             f"{sb['residency_hits']}, compiled batches "
                             f"{compiled_b}, degraded {sb['degraded_units']}")
    same(a, b_, "B")
    c_, sc = drain({c: Fleet(cfg, batch_size=32, use_compiler=False,
                             device=dev) for c, cfg in cfgs.items()}, "C")
    same(a, c_, "C")
    if sc["batches_by_tier"]["interp"] != sc["batches"]:
        raise AssertionError("drain C ran off the interpreter")
    plan = FaultPlan(seed=16, compile={"count": 1}, dispatch={"count": 1})
    with plan:
        d_, sd = drain({c: FleetScheduler(cfg, batch_size=32, device=dev)
                        for c, cfg in cfgs.items()}, "D", isolated=True)
    if plan.injected != {"compile": 1, "dispatch": 1}:
        raise AssertionError(f"drain D: faults injected {plan.injected}")
    same(a, d_, "D")
    log(f"[fleet] drain D under FaultPlan(seed=16, compile once, dispatch "
        f"once): injected {plan.log}; degraded units "
        f"{sd['degraded_units']}, bisections {sd['bisections']}, salvaged "
        f"jobs {sd['salvaged_jobs']}")
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    routes = {k: dict(f.by_route) for k, f in counters.items()}
    log(f"[fleet] drains A-D: kernel launches {launches}, by route {routes}")
    for k, v in routes.items():
        if v["step"] <= 0 or v["tile"] or v["step"] != launches[k]:
            raise AssertionError(f"{k}: the fleet's launches by route {v}, "
                                 "expected all on 'step'")
    for label, st in (("A", sa), ("B", sb), ("C", sc), ("D", sd)):
        log(f"[fleet] drain {label}: {st['us_per_job_step']:.2f} us a job "
            f"step against phase 3b's single-job runs: "
            + ", ".join(f"{m} {tiers['summary'][m + '/suite']['us_per_step']:.2f}"
                        for m in ("blocks", "superblock", "auto"))
            + f", run_program "
            f"{tiers['summary']['auto/suite']['run_program_us_per_step']:.2f}")

    # the verified optimizer through both compiled tiers
    opt = suite.load_digests(suite.OPTIMIZED_DIGESTS_PATH)
    for f in counters.values():
        f.launches = 0
        f.by_route = dict.fromkeys(f.by_route, 0)
    n = 0
    for b in suite.build_suite(programs, benchmark_config):
        for mode in ("blocks", "superblock"):
            cp = compile_program(b.image, mode=mode, optimize=True)
            st = cp.run(shared_init=b.shared_init, tdx_dim=b.tdx_dim,
                        device=dev)
            got = suite.leaf_digests(state_to_numpy(st))
            bad = [k for k, v in opt[b.name]["leaves"].items()
                   if got[k] != v]
            if bad:
                raise AssertionError(f"optimize {mode} {b.name}: leaves "
                                     f"{bad} differ from the reference's "
                                     "optimized digests")
            n += 1
    torch.cuda.synchronize()
    opt_launches = {k: f.launches for k, f in counters.items()}
    opt_routes = {k: dict(f.by_route) for k, f in counters.items()}
    for k, v in opt_routes.items():
        if v["step"] <= 0 or v["tile"] or v["step"] != opt_launches[k]:
            raise AssertionError(f"{k}: the optimized runs' launches by "
                                 f"route {v}, expected all on 'step'")
    log(f"[fleet] compile_program(optimize=True): {n} runs (22 jobs x "
        "blocks, superblock) match the reference's optimized digests; "
        f"kernel launches {opt_launches}, by route {opt_routes}")
    return {"launches": launches, "routes": routes,
            "opt_launches": opt_launches, "opt_routes": opt_routes,
            "drains": {"A": sa, "B": sb, "C": sc, "D": sd}}


# ---------------------------------------------------------------------------
# phase 4: timing
# ---------------------------------------------------------------------------

def time_ms(fn, reps=200, rounds=5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after a warm-up."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) / reps)
    return statistics.median(out)


def graph_ms(fn, reps=40, rounds=5) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    the replay timed by CUDA events, the median over ``rounds``.  The
    host's issue of each launch (the wrapper's Python) is not in it, so
    it is the time the card spends, which eager timing of a short kernel
    does not show."""
    import torch
    for _ in range(3):
        fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) / reps)
    del graph
    return statistics.median(out)


def previous_composition(cfg, regs, masks):
    """One core's FP or DOT/SUM step as the main path ran it before the
    step kernels (the single-core path of ``make_step`` then): views
    of the register columns, the value function of ``build_spec`` (for
    FP ``fp_alu``, for DOT/SUM ``ext_dot``: the ``tile`` kernels and the
    tile bitmap, contiguous copies and casts around them), then
    ``torch.where`` with the write mask and the column write.  Returns
    ``step(pred, row)`` for a trace row of Python ints."""
    import dataclasses
    import torch
    from repro_torch.core import Op, semantics
    tid = torch.arange(regs.shape[1], dtype=torch.int32, device=regs.device)
    is_t0 = tid == 0
    ext = (int(Op.DOT), int(Op.SUM))

    def step(pred, row):
        op, _typ, rd, ra, rb, imm, tsc = row
        rdv, rav, rbv = (regs[:, :, r] for r in (rd, ra, rb))
        mask = masks[:, tsc] if pred is None else masks[:, tsc] & pred
        env = semantics.OpEnv(cfg=cfg, rav=rav, rbv=rbv, rdv=rdv,
                              signed=False, imm=imm, mask=mask, tid=tid,
                              shared=None, tdx_dim=16)
        wm = is_t0.expand_as(mask) if op in ext else mask
        val = semantics.build_spec(dataclasses.replace(env, wmask=wm))[op][0]()
        regs[:, :, rd] = torch.where(wm, val, rdv)

    return step


def egpu_counters():
    from repro_torch.kernels.dot_product.ops import dot_product
    from repro_torch.kernels.wavefront_alu.ops import wavefront_alu
    return {"wavefront_alu": wavefront_alu, "dot_product": dot_product}


def step_programs(cfg, n=64) -> dict:
    """Programs of ``n`` FP steps (the five opcodes in turn) and of ``n``
    DOT/SUM steps, nothing else but STOP; rd is never ra or rb."""
    from repro_torch.core import Asm
    out = {}
    for kind in ("FP", "DOT/SUM"):
        a = Asm(cfg)
        for j in range(n):
            if kind == "FP":
                (a.fadd, a.fsub, a.fmul, a.fmax, a.fmin)[j % 5](
                    4 + j % 8, 1, 2)
            elif j % 2:
                a.sum_(12 + j % 4, 1)
            else:
                a.dot(12 + j % 4, 1, 2)
        a.stop()
        out[kind] = a.assemble(schedule_nops=False)
    return out


def window(fn, steps: int) -> dict:
    """Device kernels and torch ops a step over one call of ``fn`` (which
    runs ``steps`` steps), by ``torch.profiler``; and host µs a step of
    another, unprofiled call (ended by a synchronise)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_us = 1e6 * (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    ev = prof.key_averages()
    kern = {}
    for e in ev:
        if dev_us(e) > 0 and str(getattr(e, "device_type", "")
                                 ).endswith("CUDA"):
            k = re.match(r"(?:void )?([\w:]+)", e.key.replace(
                "(anonymous namespace)::", "")).group(1).split("::")[-1]
            kern[k] = kern.get(k, 0) + e.count
    aten = {e.key: e.count for e in ev if e.key.startswith("aten::")}
    return {"kernels": sum(kern.values()) / steps if kern else None,
            "kernel_names": kern, "torch_ops": sum(aten.values()) / steps,
            "torch_op_names": aten, "host_us": host_us}


def profile_steps(dev) -> dict:
    """Where an eGPU FP or DOT/SUM step's time goes: the main path's step
    (``executor.run_steps`` over a program of nothing but such steps, one
    core; and an 18-core fleet whose every step mixes the five FP
    opcodes) against the previous composition on the same trace rows.
    Raises if a step of the main path issues more than its one kernel or
    any torch op around it."""
    import torch
    from repro_torch.core import (Asm, benchmark_config, executor,
                                  init_state, run_program)
    from repro_torch.core.executor import pad_image
    from repro_torch.fleet import fleet_run
    cfg = benchmark_config(has_dot=True)
    rng = np.random.default_rng(23)
    inner = executor.run_steps
    out = {}
    for kind, image in step_programs(cfg).items():
        st = init_state(cfg, threads=EGPU_T, device=dev)
        st.regs.copy_(torch.from_numpy(special(rng, (EGPU_T, EGPU_R))
                                       .view(np.int32)).to(dev))
        got = {}

        def grab(step, step_ops, host_rows):
            got["now"] = window(lambda: inner(step, step_ops, host_rows),
                                image.n - 1)
            inner(step, step_ops, host_rows)

        executor.run_steps = grab
        try:
            run_program(image, state=st)
        finally:
            executor.run_steps = inner
        masks = torch.from_numpy(executor.tsc_masks(cfg, EGPU_T)[None]).to(dev)
        prev = previous_composition(cfg, st.regs.clone()[None], masks)
        rows = pad_image(image)[0][:image.n - 1].tolist()
        got["previous"] = window(lambda: [prev(None, r) for r in rows],
                                 len(rows))
        out[kind] = got
    # the fleet: 18 cores, core k runs the five FP opcodes rotated by k
    images = []
    for k in range(18):
        a = Asm(cfg)
        for j in range(64):
            (a.fadd, a.fsub, a.fmul, a.fmax, a.fmin)[(j + k) % 5](
                4 + j % 8, 1, 2)
        a.stop()
        images.append(a.assemble(schedule_nops=False))
    got = {}

    def grab_fleet(step, step_ops, host_rows):
        got["now"] = window(lambda: inner(step, step_ops, host_rows), 64)
        inner(step, step_ops, host_rows)

    executor.run_steps = grab_fleet
    try:
        fleet_run(images, device=dev)
    finally:
        executor.run_steps = inner
    out["FP, 18-core fleet"] = got
    for kind, got in out.items():
        for design, w in got.items():
            k = "not measured" if w["kernels"] is None else \
                f"{w['kernels']:.2f}"
            log(f"[profile-egpu] {kind} steps, {design}: {k} kernels a step "
                f"{w['kernel_names']}, {w['torch_ops']:.2f} torch ops a step "
                f"{w['torch_op_names']}, host {w['host_us']:.1f} us a step "
                "(unprofiled)")
        now = got["now"]
        if now["torch_ops"] or now["kernels"] not in (None, 1.0):
            raise AssertionError(f"{kind}: the main path's step issues "
                                 f"{now['kernels']} kernels and "
                                 f"{now['torch_op_names']}, expected one "
                                 "kernel and no torch op")
    return out


def time_kernels(dev, worst: dict, launches: dict, routes: dict) -> list:
    """Each eGPU kernel timed four ways at the main path's shapes, device
    time (a CUDA graph of launches) and eager (the host's issue pace):
    the ``step`` route as ``run_program`` issues it (one core, 512
    threads, 32 registers, every thread active), the ``tile`` route (the
    TPU kernel's function on one register column, (32, 16)), the previous
    composition (:func:`previous_composition`) and one library call;
    the step route's plain version eagerly; the step route again over
    the 18-core fleet batch."""
    import torch
    from repro_torch.core import Op, benchmark_config, executor, isa
    from repro_torch.kernels.dot_product import ops as dops, ref as dref
    from repro_torch.kernels.wavefront_alu import ops as wops, ref as wref

    rng = np.random.default_rng(7)
    cfg = benchmark_config(has_dot=True)
    counters = egpu_counters()
    saved = {k: (f.launches, dict(f.by_route)) for k, f in counters.items()}
    rows, lanes = main_path_rows()[0], 16
    regs = torch.from_numpy(rng.standard_normal((1, EGPU_T, EGPU_R))
                            .astype(np.float32).view(np.int32)).to(dev)
    masks = torch.from_numpy(executor.tsc_masks(cfg, EGPU_T)[None]).to(dev)
    full = isa.TSC_FULL
    fleet = main_path_rows()[1][-1]
    fregs = regs.expand(fleet, EGPU_T, EGPU_R).contiguous()
    fmasks = masks.expand(fleet, 16, EGPU_T).contiguous()
    n = EGPU_T
    a, b = (regs[0, :, r].contiguous().view(torch.float32).view(rows, lanes)
            for r in (1, 2))
    init = regs[0, :, 5].contiguous().view(torch.float32).view(rows, lanes)
    act = torch.ones((-(-rows // 8),), dtype=torch.int32, device=dev)
    mask = masks[0, full].view(rows, lanes)
    da, db = a.view(1, rows, lanes), b.view(1, rows, lanes)
    dact = torch.ones((1, -(-rows // 8)), dtype=torch.int32, device=dev)
    specs = {
        "wavefront_alu": dict(
            op=Op.FADD, rd=5, run=wops.fp_step, launcher=wops.fp_step_launcher,
            plain=wref.fp_step_ref, opcodes=executor.FP_OPCODES,
            fleet_ops=executor.FP_OPCODES,
            tile=lambda: wops.wavefront_alu(a, b, init, act, "add"),
            library=lambda: torch.where(mask, torch.add(a, b), init),
            library_name="torch.where(mask, torch.add(a, b), init)",
            # Ra, Rb read and Rd written a thread, its mask byte, the row
            step_bytes=12 * n + n + 56, step_ops=n,
            # an active tile reads a and b, every tile writes out and
            # reads its flag (all tiles active here)
            tile_bytes=4 * 3 * n + 4 * act.numel(), tile_ops=n,
            source="src/repro_torch/kernels/csrc/wavefront_alu.cu",
            replaces="src/repro/kernels/wavefront_alu/kernel.py:50"),
        "dot_product": dict(
            op=Op.DOT, rd=6, run=dops.ext_step, launcher=dops.ext_step_launcher,
            plain=dref.ext_step_ref, opcodes=executor.EXT_OPCODES,
            fleet_ops=executor.EXT_OPCODES,
            tile=lambda: dops.dot_product(da, db, dact),
            library=lambda: (da * db).sum(),
            library_name="(a * b).sum()",
            # Ra and Rb read a thread, its mask byte, the row; one word out
            step_bytes=8 * n + n + 56 + 4, step_ops=2 * n,
            tile_bytes=4 * 2 * n + 4 * dact.numel() + 4, tile_ops=2 * n,
            source="src/repro_torch/kernels/csrc/dot_product.cu",
            replaces="src/repro/kernels/dot_product/kernel.py:41"),
    }
    bound = lambda nbytes, ops: (max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_S)
                                 * 1e3, "bytes" if nbytes / PEAK_BYTES_S
                                 >= ops / PEAK_F32_S else "operations")
    out = []
    for name, sp in specs.items():
        row = [int(sp["op"]), 0, sp["rd"], 1, 2, 0, full]
        tr = torch.tensor([row], dtype=torch.int64, device=dev)
        prev = previous_composition(cfg, regs, masks)
        # the previous composition and the step route agree on these inputs
        x, y = regs.clone(), regs.clone()
        sp["run"](x, tr, masks, None, sp["opcodes"])
        previous_composition(cfg, y, masks)(None, row)
        torch.cuda.synchronize()
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: step route and previous "
                                 "composition differ")
        launch = sp["launcher"](regs, masks, sp["opcodes"])
        ftr = torch.tensor([[sp["fleet_ops"][k % len(sp["fleet_ops"])], 0,
                             sp["rd"], 1, 2, 0, full] for k in range(fleet)],
                           dtype=torch.int64, device=dev)
        fns = {"step": lambda: sp["run"](regs, tr, masks, None, sp["opcodes"]),
               "tile": sp["tile"], "previous": lambda: prev(None, row),
               "library": sp["library"]}
        eager = {"step": lambda: launch(tr.data_ptr(), 0), **{
            k: v for k, v in fns.items() if k != "step"}}
        # in turns, each form twice, the median of the two
        dev_ms, eager_ms = {k: [] for k in fns}, {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                dev_ms[k].append(graph_ms(fns[k]))
                eager_ms[k].append(time_ms(eager[k]))
        med = lambda d: {k: statistics.median(v) for k, v in d.items()}
        dev_ms, eager_ms = med(dev_ms), med(eager_ms)
        fleet_ms = graph_ms(lambda: sp["run"](fregs, ftr, fmasks, None,
                                              sp["opcodes"]))
        flaunch = sp["launcher"](fregs, fmasks, sp["opcodes"])
        fleet_eager = time_ms(lambda: flaunch(ftr.data_ptr(), 0))
        pregs = regs.clone()                # the plain version is in place
        plain_ms = time_ms(lambda: sp["plain"](pregs, tr, masks, None,
                                               sp["opcodes"]), reps=20)
        step_bound, step_by = bound(sp["step_bytes"], sp["step_ops"])
        tile_bound, tile_by = bound(sp["tile_bytes"], sp["tile_ops"])
        fleet_bound, _ = bound(fleet * sp["step_bytes"],
                               fleet * sp["step_ops"])
        out.append({
            "name": name, "route": "cuda", "source": sp["source"],
            "replaces": sp["replaces"], "launches": launches[name],
            "routes": routes[name], "kernel_route": "step",
            "max_abs_err": worst[name], "ms": dev_ms["step"],
            "eager_ms": eager_ms["step"], "plain_ms": plain_ms,
            "bound_ms": step_bound, "bound_by": step_by,
            "library_ms": dev_ms["library"],
            "library_eager_ms": eager_ms["library"],
            "library_call": sp["library_name"],
            "prev_ms": dev_ms["previous"], "prev_eager_ms": eager_ms["previous"],
            "tile": {"ms": dev_ms["tile"], "eager_ms": eager_ms["tile"],
                     "bound_ms": tile_bound, "bound_by": tile_by,
                     "shape": [rows, lanes]},
            "shape": [1, EGPU_T, EGPU_R], "op": sp["op"].name,
            "cases": [{"cores": fleet, "ms": fleet_ms, "eager_ms": fleet_eager,
                       "bound_ms": fleet_bound}]})
    for k, f in counters.items():                   # timing is not the run
        f.launches, f.by_route = saved[k]
    for k in out:
        log(f"[timing] {k['name']} {k['op']} step {k['shape']}: device "
            f"{k['ms']:.5f} ms (eager {k['eager_ms']:.5f}); tile {k['tile']['shape']} "
            f"{k['tile']['ms']:.5f} (eager {k['tile']['eager_ms']:.5f}); "
            f"previous composition {k['prev_ms']:.5f} (eager "
            f"{k['prev_eager_ms']:.5f}); library {k['library_call']} "
            f"{k['library_ms']:.5f} (eager {k['library_eager_ms']:.5f}); "
            f"plain {k['plain_ms']:.5f}; bound {k['bound_ms']:.7f} "
            f"({k['bound_by']}); {k['cases'][0]['cores']} cores: device "
            f"{k['cases'][0]['ms']:.5f} (eager {k['cases'][0]['eager_ms']:.5f}),"
            f" bound {k['cases'][0]['bound_ms']:.7f}")
    return out


# ---------------------------------------------------------------------------
# phase 5: the LM serving path (granite-moe-3b-a800m, full width)
# ---------------------------------------------------------------------------

#: the full-width serve: 8 requests x prompt 512, 32 greedy decode steps
SERVE = dict(arch="granite-moe-3b-a800m", requests=8, prompt_len=512,
             max_new=32, max_len=1024, seed=0)
#: H100 SXM bf16 dense tensor-core peak (NVIDIA data sheet, 700 W)
PEAK_BF16_S = 989e12


def lm_counters():
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.wavefront_matmul.ops import wavefront_matmul
    return {"wavefront_matmul": wavefront_matmul,
            "flash_attention": flash_attention}


def within(got, exp, tol) -> float:
    """Max abs error; raises if beyond ``atol + rtol * |exp|``."""
    atol, rtol = tol
    g, e = got.float(), exp.float()
    err = (g - e).abs()
    if not bool((err <= atol + rtol * e.abs()).all()):
        raise AssertionError(f"max abs err {float(err.max())} beyond atol "
                             f"{atol} + rtol {rtol}")
    return float(err.max())


def route_counts() -> dict:
    """Each LM kernel's launches by route, as a copy."""
    return {k: dict(f.by_route) for k, f in lm_counters().items()}


def check_lm_kernels(dev) -> None:
    """Both LM kernels, every route of each, against their plain versions
    at the reference tests' shapes plus the ragged, grouped, small-M and
    decode cases; the previous design (``simt``) on bf16 too."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref
    from repro_torch.kernels.wavefront_matmul import ops as mops, ref as mref
    g = torch.Generator(device=dev).manual_seed(3)
    before = route_counts()
    n = 0
    for dt in (torch.float32, torch.bfloat16):
        # routes, bf16: wgmma except the small-M cases (small_m) and K =
        # 100 (rows of 200 bytes, which TMA cannot read: simt); float32:
        # small_m at M <= 16, simt above
        for e, m, k, nn in ((1, 128, 128, 128), (1, 256, 128, 256),
                            (1, 384, 256, 128), (5, 200, 48, 64),
                            (3, 819, 160, 96), (40, 2, 96, 32),
                            (40, 16, 96, 32), (7, 1, 64, 24),
                            (5, 200, 100, 64)):
            a = torch.randn((e, m, k), generator=g, device=dev).to(dt)
            b = (torch.randn((e, k, nn), generator=g, device=dev)
                 / k ** 0.5).to(dt)
            act = torch.randint(0, 2, (e, -(-m // 128)), generator=g,
                                device=dev, dtype=torch.int32)
            act[0, 0] = 1
            exp = mref.wavefront_matmul_ref(a, b, act)
            off = ~mref.tile_mask(act, m)
            routes = [mops.route(a, b)] + (["simt"] if dt == torch.bfloat16
                                           else [])
            for r in routes:
                got = mops.run_route(r, a, b, act)
                try:
                    within(got, exp, mops.TOLERANCE[dt])
                    if torch.count_nonzero(got[off]):
                        raise AssertionError("inactive tiles not zero")
                except AssertionError as err:
                    raise AssertionError(f"wavefront_matmul {r} {dt} {e}x{m}"
                                         f"x{k}x{nn}: {err}") from None
                n += 1
        for b_, h, kv, sq, sk, d, causal in (
                (2, 2, 2, 128, 128, 64, True), (2, 2, 2, 128, 512, 64, False),
                (2, 6, 2, 37, 37, 12, True), (2, 4, 2, 100, 300, 128, True),
                (2, 6, 2, 200, 200, 64, True), (3, 24, 8, 1, 1024, 64, False)):
            q = torch.randn((b_, h, sq, d), generator=g, device=dev).to(dt)
            kk = torch.randn((b_, kv, sk, d), generator=g, device=dev).to(dt)
            vv = torch.randn((b_, kv, sk, d), generator=g, device=dev).to(dt)
            lens = torch.randint(1, sk + 1, (b_,), generator=g, device=dev,
                                 dtype=torch.int32)
            exp = fref.mha_ref(q, kk, vv, lens, causal).to(dt)
            k2, v2 = kk.clone(), vv.clone()       # poisoned past each length
            for i, ln in enumerate(lens.tolist()):
                k2[i, :, ln:] = 1e4
                v2[i, :, ln:] = -1e4
            r = fops.route(q, kk, vv)
            for rr in [r] + (["simt"] if r != "simt" else []):
                got = fops.run_route(rr, q, kk, vv, lens, causal)
                try:
                    within(got, exp, fops.TOLERANCE[dt])
                    if not torch.equal(
                            fops.run_route(rr, q, k2, v2, lens, causal), got):
                        raise AssertionError("poisoned keys changed a bit")
                except AssertionError as err:
                    raise AssertionError(f"flash_attention {rr} {dt} "
                                         f"{q.shape} {kk.shape}: {err}"
                                         ) from None
                n += 1
    torch.cuda.synchronize()
    moved = {k: {r: c - before[k][r] for r, c in v.items()}
             for k, v in route_counts().items()}
    for k, v in moved.items():
        for r, c in v.items():
            if c <= 0:
                raise AssertionError(f"{k} route {r} was never checked")
    log(f"[lm-kernels] wavefront_matmul and flash_attention: {n} cases "
        "within tolerance of their plain versions (ragged, batched, GQA, "
        "small-M and decode rows; float32 and bfloat16; inactive tiles "
        f"zero; poisoned tails change no bit); launches by route {moved}")


def serve_reference(dev) -> dict:
    """The smoke serve on the card against the JAX reference's file."""
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    out = serve.hold_against_reference(dev)
    for name, r in out.items():
        log(f"[serve-ref] {name}: logits within {serve.TOLERANCE[name]} of "
            f"the reference (max abs err {r['max_abs_err']:.3g}); "
            f"{r['tokens_checked']} of {r['tokens']} greedy tokens checked, "
            f"all equal")
    log(f"[serve-ref] {time.perf_counter() - t0:.1f}s")
    return out


def serve_full(dev, gpu: str) -> dict:
    """Phase 5's main path: ``repro_torch.launch.serve`` at the config's
    full width and depth, bf16, weights drawn on the card from a seed."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import serve
    cfg = configs.get(SERVE["arch"])
    t0 = time.perf_counter()
    model = serve.build_model(cfg, SERVE["seed"], dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    prompt = torch.from_numpy(serve.make_prompt(
        cfg, SERVE["seed"], SERVE["requests"], SERVE["prompt_len"])).to(dev)
    serve.generate(cfg, model, prompt, 2, SERVE["max_len"])   # warm-up
    log(f"[serve] {cfg.name}: {n_params / 1e9:.3f} B parameters, held at "
        f"{cfg.dtype} only (drawn at {cfg.param_dtype}), built and warmed "
        f"in {time.perf_counter() - t0:.1f}s")
    counters = lm_counters()
    for f in counters.values():
        f.launches = 0
        f.by_route = dict.fromkeys(f.by_route, 0)
    torch.cuda.reset_peak_memory_stats(dev)
    r = serve.generate(cfg, model, prompt, SERVE["max_new"],
                       SERVE["max_len"])
    launches = {k: f.launches for k, f in counters.items()}
    routes = route_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if r["tokens"].shape != (SERVE["requests"], SERVE["max_new"] + 1) \
            or r["vocab"] != cfg.vocab:
        raise AssertionError(f"serve output has shape {r['tokens'].shape}")
    if not r["finite"]:
        raise AssertionError("serve logits are not all finite")
    if not ((r["tokens"] >= 0) & (r["tokens"] < cfg.vocab)).all():
        raise AssertionError("serve tokens out of the vocabulary")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"{k} was never launched on the serve path")
    # prefill: 3 expert GEMMs and 1 attention a layer, all on the tensor
    # cores; each decode step: the same on small_m and split
    layers, steps = cfg.n_layers, SERVE["max_new"]
    want = {"wavefront_matmul": {"wgmma": 3 * layers,
                                 "small_m": 3 * layers * steps, "simt": 0},
            "flash_attention": {"wgmma": layers, "split": layers * steps,
                                "simt": 0}}
    if routes != want:
        raise AssertionError(f"the serve's launches by route {routes}, "
                             f"expected {want}")
    ms_step = 1e3 * r["decode_s"] / SERVE["max_new"]
    tps = r["useful"] / r["decode_s"]
    log(f"[serve] prefill {SERVE['requests']} x {SERVE['prompt_len']}: "
        f"{r['prefill_s']:.4f}s; decode {SERVE['max_new']} steps: "
        f"{ms_step:.3f} ms/step, {r['useful']} useful tokens, "
        f"{tps:.1f} useful tokens/s; peak memory {peak / 2**30:.2f} GiB; "
        f"logits finite; launches {launches}, by route {routes} ({gpu})")
    log(f"[serve] sample continuation: {r['tokens'][0, :8].tolist()}")
    profile_decode(cfg, model, prompt, ms_step)
    return {"cfg": cfg, "launches": launches, "routes": routes,
            "ms_step": ms_step,
            "tokens_s": tps, "prefill_s": r["prefill_s"],
            "last_lengths": r["last_lengths"]}


def profile_decode(cfg, model, prompt, ms_step: float, steps: int = 2):
    """Device time and the top kernels by device time over a few decode
    steps of the full-width serve, by ``torch.profiler``; the busy share
    is given against the profiled wall time and against the unprofiled
    step time ``ms_step``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import api
    _, cache, lengths = api.prefill(cfg, model, {"tokens": prompt},
                                    SERVE["max_len"])
    tok = torch.zeros((prompt.shape[0],), dtype=torch.int32,
                      device=prompt.device)
    api.decode(cfg, model, cache, tok, lengths)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            _, cache, lengths = api.decode(cfg, model, cache, tok, lengths)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    # device-side events only: a CPU op also reports its kernels' time
    kern = [e for e in prof.key_averages() if dev_us(e) > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not kern:
        log("[profile] the profiler showed no device time: not measured")
        return
    busy = sum(dev_us(e) for e in kern) / 1e6
    launches = sum(e.count for e in kern)
    per_step = 1e3 * busy / steps
    log(f"[profile] {steps} decode steps: {launches} kernels, device busy "
        f"{per_step:.3f} ms a step; profiled wall {1e3 * wall / steps:.3f} "
        f"ms a step ({100 * busy / wall:.1f} % busy); against the "
        f"unprofiled {ms_step:.3f} ms a step, {100 * per_step / ms_step:.1f}"
        f" % busy, {100 - 100 * per_step / ms_step:.1f} % idle")
    for e in sorted(kern, key=dev_us, reverse=True)[:8]:
        log(f"[profile]   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6} "
            f"{e.key[:90]}")


def lm_cases(dev, cfg, last_lengths) -> dict:
    """Each LM kernel's inputs at the serve's exact shapes and types, by
    ``(kernel, phase, call)``: the expert GEMMs' up-projections (``w_in``
    and ``w_gate``, d -> f) and down-projection (``w_out``, f -> d), and
    attention, in prefill and decode.  Values are random at the model's
    scales; the decode lengths are the ones the run's last step read."""
    import torch
    g = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16
    b, s, t = SERVE["requests"], SERVE["prompt_len"], SERVE["max_len"]
    h, kv, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.num_experts
    rn = lambda *shape, scale=1.0: (torch.randn(shape, generator=g,
                                                device=dev) * scale).to(bf)
    out = {}
    for phase, n in (("prefill", b * s), ("decode", b)):
        cap = max(1, int(round(n * cfg.top_k / e)))
        act = torch.ones((e, -(-cap // 128)), dtype=torch.int32, device=dev)
        out[("wavefront_matmul", phase, "up")] = (
            rn(e, cap, d), rn(e, d, f, scale=d ** -0.5), act)
        out[("wavefront_matmul", phase, "down")] = (
            rn(e, cap, f), rn(e, f, d, scale=f ** -0.5), act)
    out[("flash_attention", "prefill", "attention")] = (
        rn(b, h, s, hd), rn(b, kv, s, hd), rn(b, kv, s, hd),
        torch.full((b,), s, dtype=torch.int32, device=dev), True)
    out[("flash_attention", "decode", "attention")] = (
        rn(b, h, 1, hd), rn(b, kv, t, hd), rn(b, kv, t, hd),
        torch.from_numpy(last_lengths + 1).to(dev, torch.int32), False)
    return out


def lm_work(name, args) -> tuple:
    """(bytes, FLOPs) the call must move and do: each input read once,
    the output written once; the products of active rows, or of the
    (query, key) pairs that the mask keeps."""
    if name == "wavefront_matmul":
        a, b, act = args
        e, m, k = a.shape
        n = b.shape[-1]
        rows = sum(min(128, m - 128 * i) for ex in act.tolist()
                   for i, on in enumerate(ex) if on)
        experts = sum(any(ex) for ex in act.tolist())
        nbytes = 2 * (rows * k + experts * k * n + e * m * n) \
            + 4 * act.numel()
        return nbytes, 2 * rows * k * n
    q, k, v, lens, causal = args
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    pairs = keys = 0
    for ln in lens.tolist():
        lim = [min(ln, i + (sk - sq) + 1) if causal else ln
               for i in range(sq)]
        pairs += sum(max(0, min(x, sk)) for x in lim)
        keys += max(0, min(max(lim), sk))         # keys read at all
    nbytes = 2 * (2 * q.numel() + 2 * kv * keys * d) + 4 * lens.numel()
    return nbytes, 4 * h * d * pairs


def lm_library(name, args):
    """One PyTorch call that computes the same function (the yardstick;
    the port never calls it)."""
    import torch
    import torch.nn.functional as F
    if name == "wavefront_matmul":
        a, b, _ = args
        return lambda: torch.bmm(a, b)
    q, k, v, lens, causal = args
    if causal:
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)
    mask = (torch.arange(k.shape[2], device=k.device)[None, :]
            < lens[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def lm_kernels_at_serve(dev, full: dict) -> list:
    """Hold each LM kernel against its plain version at the serve's
    shapes, then time there, in turns: the routed kernel, the previous
    design (the ``simt`` kernel on the same inputs), the plain version
    and a library call."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref
    from repro_torch.kernels.wavefront_matmul import ops as mops, ref as mref
    fns = {"wavefront_matmul": (mops.wavefront_matmul,
                                mref.wavefront_matmul_ref, mops.TOLERANCE,
                                lambda *a: mops.run_route("simt", *a),
                                lambda a, b, _: mops.route(a, b)),
           "flash_attention": (fops.flash_attention,
                               lambda *a: fref.mha_ref(*a).to(a[0].dtype),
                               fops.TOLERANCE,
                               lambda *a: fops.run_route("simt", *a),
                               lambda q, k, v, *_: fops.route(q, k, v))}
    cases = lm_cases(dev, full["cfg"], full["last_lengths"])
    rows = {}
    for (name, phase, call), args in cases.items():
        kern, plain, tol, prev, route = fns[name]
        counter = lm_counters()[name]
        before = (counter.launches, dict(counter.by_route))
        got = kern(*args)
        old = prev(*args)
        exp = plain(*args)
        torch.cuda.synchronize()
        try:
            err = within(got, exp, tol[got.dtype])
            prev_err = within(old, exp, tol[got.dtype])
        except AssertionError as e:
            raise AssertionError(f"{name} {phase} {call}: {e}") from None
        nbytes, flops = lm_work(name, args)
        t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_BF16_S
        heavy = phase == "prefill"
        # in turns: routed kernel, previous design, library, plain, then
        # the routed kernel and the previous design again (the median of
        # both rounds); device time by CUDA graph, the plain version eager
        lib = lm_library(name, args)
        ms, prev_ms = [graph_ms(lambda: kern(*args))], \
            [graph_ms(lambda: prev(*args), reps=10 if heavy else 40)]
        library_ms = graph_ms(lib)
        plain_ms = time_ms(lambda: plain(*args), reps=5 if heavy else 20,
                           rounds=3)
        prev_ms.append(graph_ms(lambda: prev(*args),
                                reps=10 if heavy else 40))
        ms.append(graph_ms(lambda: kern(*args)))
        row = {"phase": phase, "call": call, "route": route(*args),
               "shape": [list(a.shape) for a in args
                         if isinstance(a, torch.Tensor)],
               "max_abs_err": err, "prev_max_abs_err": prev_err,
               "ms": statistics.median(ms),
               "prev_ms": statistics.median(prev_ms),
               "plain_ms": plain_ms, "library_ms": library_ms,
               "eager_ms": time_ms(lambda: kern(*args),
                                   reps=40 if heavy else 200, rounds=5),
               "bound_ms": max(t_b, t_f) * 1e3,
               "bound_by": "bytes" if t_b >= t_f else "operations"}
        # timing launches are not the run's
        counter.launches, counter.by_route = before
        rows.setdefault(name, []).append(row)
        log(f"[lm-timing] {name} {phase} {call} {row['shape']}: {row['route']}"
            f" {row['ms']:.5f} ms (issued eagerly {row['eager_ms']:.5f} ms), "
            f"previous design (simt) {row['prev_ms']:.5f}"
            f" ms, plain {row['plain_ms']:.5f} ms, library "
            f"{row['library_ms']:.5f} ms, bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}); within {tol[got.dtype]} of the plain "
            f"version (max abs err {err:.3g}; simt {prev_err:.3g})")
    src = {"wavefront_matmul": "src/repro/kernels/wavefront_matmul/"
                               "kernel.py:52",
           "flash_attention": "src/repro/kernels/flash_attention/kernel.py:87"}
    out = []
    for name in ("wavefront_matmul", "flash_attention"):
        # the headline numbers are the first prefill call's; every call
        # the serve makes is in "cases"
        first = rows[name][0]
        out.append({"name": name, "route": "cuda",
                    "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                    "replaces": src[name],
                    "launches": full["launches"][name],
                    "routes": full["routes"][name],
                    "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
                    **{k: first[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms",
                                             "prev_ms", "shape", "phase",
                                             "call")},
                    "kernel_route": first["route"],
                    "cases": rows[name]})
    return out


def ptxas_report(logs: dict) -> list:
    """``(kernel, function, registers, spills, static shared bytes)`` for
    each function nvcc's ``-Xptxas -v`` reported."""
    out = []
    for kernel, text in sorted(logs.items()):
        fn = spill = None
        for line in text.splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"\d+([A-Za-z_]+_kernel)(I\w*?E)?E?", line)
                fn = (m.group(1) + (m.group(2) or "")) if m else line.strip()
            elif "spill stores" in line:
                spill = line.strip()
            elif "Used" in line and "registers" in line and fn:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                smem = re.search(r"(\d+) bytes smem", line)
                out.append((kernel, fn, int(regs), spill,
                            int(smem.group(1)) if smem else 0))
                fn = None
    return out


def suite_time(dev) -> dict:
    """The main path's pace alone: the 22-job suite through
    ``run_program`` (after one warm-up job) and both ``fleet_run``
    batches, each result's leaves held against the reference's digests
    after its run.  Uses only entry points that every slice of the port
    has, so ``--suite-ab`` can run it on an older tree."""
    import torch
    from repro_torch import programs
    from repro_torch.core import benchmark_config, run_program
    from repro_torch.core.machine import state_to_numpy
    from repro_torch.fleet import fleet_run, unstack_state
    from repro_torch.programs import suite
    digests = suite.load_digests()

    def held(b, st):
        got = suite.leaf_digests(state_to_numpy(st))
        if got != digests[b.name]["leaves"]:
            raise AssertionError(f"{b.name}: leaves differ from the digests")

    jobs = suite.build_suite(programs, benchmark_config)
    kw = lambda b: dict(shared_init=b.shared_init, tdx_dim=b.tdx_dim)
    run_program(jobs[0].image, device=dev, **kw(jobs[0]))       # warm-up
    steps, wall = 0, 0.0
    for b in jobs:
        t0 = time.perf_counter()
        st = run_program(b.image, device=dev, **kw(b))
        wall += time.perf_counter() - t0
        steps += int(st.steps)
        held(b, st)
    fleet = {}
    for c, idx in fleet_batches().items():
        bj = suite.build_suite(programs, benchmark_config,
                               [suite.SUITE[i] for i in idx], config=c)
        t0 = time.perf_counter()
        out = fleet_run([b.image for b in bj], init_kw=[kw(b) for b in bj],
                        device=dev)
        torch.cuda.synchronize()
        fleet[c] = time.perf_counter() - t0
        for i, b in enumerate(bj):
            held(b, unstack_state(out, i))
    return {"run_program_steps": steps, "run_program_s": wall,
            "us_per_step": 1e6 * wall / steps, "fleet_s": fleet}


def suite_ab(parent: str) -> int:
    """``--suite-ab PARENT``: the suite's pace on an older tree of the
    port (``PARENT``, a checkout's root) and on this one, in turns
    (parent, this, this, parent), each in its own process on the same
    card; prints each run and the medians."""
    runs = []
    for label, root in (("parent", parent), ("this", str(ROOT)),
                        ("this", str(ROOT)), ("parent", parent)):
        p = subprocess.run([sys.executable, str(pathlib.Path(__file__)
                                                .resolve()),
                            "--suite-time", str(pathlib.Path(root) / "src")],
                           capture_output=True, text=True, timeout=900)
        line = [x for x in p.stdout.splitlines() if x.startswith("{")]
        if p.returncode != 0 or not line:
            print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
            return p.returncode or 1
        r = json.loads(line[-1])
        runs.append((label, r))
        log(f"[suite-ab] {label} ({root}): run_program {r['us_per_step']:.2f}"
            f" us a step ({r['run_program_steps']} steps, "
            f"{r['run_program_s']:.3f}s); fleet walls {r['fleet_s']}")
    med = {}
    for label in ("parent", "this"):
        rs = [r for lab, r in runs if lab == label]
        med[label] = {"us_per_step": statistics.median(
            r["us_per_step"] for r in rs), "fleet_s": {
            c: statistics.median(r["fleet_s"][c] for r in rs)
            for c in rs[0]["fleet_s"]}}
    log(f"[suite-ab] medians: {json.dumps(med)}; run_program us a step "
        f"{100 * (med['this']['us_per_step'] / med['parent']['us_per_step'] - 1):+.1f} %"
        + "".join(f"; fleet '{c}' {100 * (v / med['parent']['fleet_s'][c] - 1):+.1f} %"
                  for c, v in med["this"]["fleet_s"].items()))
    print(gpu_line(), flush=True)
    print(json.dumps({"suite_ab": med, "runs": runs}), flush=True)
    return 0


def gpu_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def main(argv) -> int:
    if argv[:1] == ["--suite-time"]:
        sys.path.insert(0, argv[1])
        import torch
        print(json.dumps(suite_time(torch.device("cuda", 0))), flush=True)
        return 0
    if argv[:1] == ["--suite-ab"]:
        return suite_ab(argv[1])
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    from repro_torch.launch import serve
    serve.float32_matmuls()
    dev = torch.device("cuda", 0)
    device_name = torch.cuda.get_device_name(0)
    log(f"[device] {device_name}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, count {torch.cuda.device_count()}")

    gpu = gpu_line()
    t0 = time.perf_counter()
    build.build_all()
    log(f"[build] nvcc sm_90a, {len(build.LOGS) or 'all'} kernels built "
        f"(one nvcc each, in parallel) and loaded in "
        f"{time.perf_counter() - t0:.1f}s ({build.BUILD_DIR})")
    for kernel, fn, regs, spill, smem in ptxas_report(build.LOGS):
        log(f"[ptxas] {kernel}: {fn}: {regs} registers, {spill}, static "
            f"shared memory {smem} bytes")

    worst = check_kernels(dev)
    check_step_kernels(dev)
    res = run_suite(dev)
    tiers = run_tiers(dev, res)
    fleet = run_fleet(dev, tiers)
    profile_steps(dev)
    # the main path's launches: the interpreter and fleet_run phase's, the
    # compiled tiers', the scheduler's drains' and the optimized runs'
    # (each counted from 0 just before its own runs)
    paths = {"run_program+fleet_run": (res["launches"], res["routes"]),
             "compiled_tiers": (tiers["launches"], tiers["routes"]),
             "fleet_scheduler": (fleet["launches"], fleet["routes"]),
             "optimized_tiers": (fleet["opt_launches"], fleet["opt_routes"])}
    launches = {k: sum(p[0][k] for p in paths.values())
                for k in res["launches"]}
    routes = {k: {r: sum(p[1][k][r] for p in paths.values()) for r in v}
              for k, v in res["routes"].items()}
    kernels = time_kernels(dev, worst, launches, routes)
    for k in kernels:
        k["paths"] = {name: p[0][k["name"]] for name, p in paths.items()}

    check_lm_kernels(dev)
    serve_reference(dev)
    full = serve_full(dev, gpu)
    kernels += lm_kernels_at_serve(dev, full)

    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
