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
   3d. the serving loop and the multi-device fleet (``fleet/service.py``,
   ``fleet/sharded.py``): the same 66 submissions through
   ``FleetService(batch_size=32)`` (one a configuration, both at once;
   cold, then warm), a seeded chaos soak through ``serve_jobs``, the
   watchdog (one ``device_sync`` hang: 1 reset, the cohort as
   timeouts), ``Fleet(devices="all")`` (a megabatch slab of one
   program and the mixed suite, bit-identical to a plain ``Fleet``)
   and ``FleetService(devices="all")`` with ``device_fail`` on its only
   card (never killed); every result held against the digests, every
   launch on ``step``; prints submit-to-resolve p50/p99 from the
   service's histogram, jobs/s and µs a job step beside drain B,
   megabatch slabs, lane batches and scheduler resets;
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
   time (launches captured in a CUDA graph), the plain version eagerly;
6. LM training (``repro_torch.launch.train``), after the serve's model is
   freed: the backward kernels against their plain versions (the
   attention backward ``dq`` + ``dkdv``, each route that takes the case,
   ``wgmma`` and ``simt``, against ``mha_ref_bwd`` over ragged S, GQA
   G = 1, 3, 4, lengths below S, causal and not, float32 and bfloat16,
   twice bit for bit, poisoned tails, rows with no live key; the
   ``wavefront_matmul`` gradient products against
   ``wavefront_matmul_ref_bwd`` with inactive tiles and a padded
   contraction); the smoke trainer (granite and yi, float32 and
   bfloat16, ``--init numpy``, 5 steps) against the JAX reference's
   committed run (``src/repro_torch/training/reference_train.json``),
   each step's loss, gradient norm and lr within
   ``train.TOLERANCE``, and a checkpointed smoke run that restores after
   an injected NaN; then granite-moe-3b-a800m at full width and
   depth (bf16 compute, f32 master and AdamW state, 8 x 512 tokens, 6
   steps, through ``train.main``), its counters (forward and backward,
   by route) zeroed just before and read just after: every attention
   forward (and remat recompute) on ``wgmma``, every attention backward
   on ``dq`` + ``dkdv`` of the ``wgmma`` route, every expert GEMM and
   both of its gradient products on ``wgmma``; losses finite and the
   mean of the last 3 below the first; seconds a step, tokens/s, peak memory, ``train_mfu`` and
   one more step under ``torch.profiler`` (each kernel's share of device
   time); then the backward kernels timed at the training shapes: the
   attention backward's two routes and ``torch.autograd.grad`` of
   ``scaled_dot_product_attention`` the same way (by CUDA graph where
   the library's autograd captures, else all three eagerly), the
   gradient products against ``torch.bmm``, with the bound;
7. the other families' serve, after the trainer is freed: the smoke
   serves of zamba2, xlstm, seamless-m4t and internvl2 against the JAX
   reference's committed runs
   (``src/repro_torch/models/reference_serve_families.json``), float32
   and bfloat16; then each family's full published config in bf16
   (weights drawn on the card from seed 0; 8 requests x prompt 512, 32
   decode steps; seamless with 512 frames, internvl2 with 1,024 patches
   and ``max_len`` 2,048), its counters zeroed just before and read
   after the prefill and after the decode: every prefill attention on
   ``wgmma``, every decode attention on ``split``, none on ``simt``, no
   expert GEMM; prefill seconds, decode ms a step, useful tokens a
   second, peak memory, finite logits; each model freed before the
   next; then ``flash_attention`` held against its plain version and
   timed at each family's prefill and decode shapes;
8. the other families' training, after the serves: the smoke trainers
   of zamba2, xlstm, seamless-m4t and internvl2 (float32 and bfloat16,
   ``--init numpy``, 5 steps) against the JAX reference's runs in
   ``training/reference_train.json`` (``train.held``), each run's
   attention launches by kernel and route read around it (bfloat16 on
   ``wgmma``, float32 on ``simt``, xlstm none); then each family at its
   published widths and depth through ``train.main`` (bf16 compute, f32
   master and AdamW state, remat, 8 x 512 tokens, seamless with 512
   frames, internvl2 with 1,024 patches, 4 steps from seed 0), its
   counters zeroed just before and read just after: every attention
   forward and recompute on ``wgmma``, every backward on ``dq`` +
   ``dkdv`` of the ``wgmma`` route, no expert GEMM; losses and gradient
   norms finite, no step skipped; seconds a step, tokens/s,
   ``train_mfu`` with its FLOP count, peak memory, one more step under
   ``torch.profiler``; each model freed before the next; then the
   attention backward held against ``mha_ref_bwd`` and timed at each new
   shape (zamba2's shared block, seamless's encoder, decoder and
   cross-attention, internvl2's 1,535 rows at head_dim 128) as in phase 6;
9. the mesh on the card (``sharding/``, ``launch/mesh``, ``launch/specs``,
   ``launch/dryrun``), after the families' training: the dry run (``python
   -m repro_torch.launch.dryrun``, granite-moe-3b-a800m's ``train_4k`` and
   ``decode_32k`` on both production meshes, each in its own process on
   the host's CPU, started first) exits 0 and its records' bytes a device
   and FLOPs are printed; ``launch.mesh.make_debug_mesh()`` is a (1, 1)
   ``("data", "model")`` mesh over a one-rank ``nccl`` group, and
   ``make_debug_mesh(data=2)`` is refused with its recipe; granite's
   train cell at phase 6's shape (``launch.specs.build_cell``): its
   parameters drawn on the card from seed 0, they, the AdamW state and
   the batch placed as ``DTensor``s by the cell's placements, the bytes
   the placement took equal to the dry run's ``argument_bytes`` within
   512 bytes a leaf; one step of the
   port's train step on the placed state (in place), its counters
   zeroed just before and read just after: every attention forward and
   recompute and every expert GEMM on ``wgmma``, ``dq`` + ``dkdv`` and
   both gradient products on ``wgmma``, the loss finite; the dry run's
   FLOPs for the cell beside phase 6's 6 x N_active x tokens, not
   below it; granite's decode cache at phase 5's size placed by
   ``cache_specs``, its bytes held the same way; xlstm-350m's parameters
   and AdamW state saved from the mesh and restored with ``shardings``
   onto it, every leaf bit for bit, seconds and bytes printed; then
   ``examples/egpu_benchmarks_torch.py`` and
   ``examples/fleet_throughput_torch.py`` on the card, each exiting 0.
   The placements' bytes are the growth of the caching allocator's
   requested bytes (``memory_stats()["requested_bytes.all.current"]``);
   the growth of ``memory_allocated``, printed beside, also counts the
   whole of a cached block that an earlier phase freed and that a
   request takes without a split (up to 1 MiB more a leaf).  The train
   step's launches are one more path (``train-mesh``) of the LM kernels'
   rows in the kernels line.

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

import gc
import json
import os
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
    zero_egpu_counters()
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
    launches, routes = read_egpu_counters("the compiled tiers")
    log(f"[tiers] {len(rows)} runs ({len(jobs)} jobs x blocks, superblock, "
        "auto) "
        f"match the digests; kernel launches {launches}, by route {routes}; "
        "each job's step launches equal its run_program's")

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

    zero_egpu_counters()
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
    launches, routes = read_egpu_counters("the fleet")
    log(f"[fleet] drains A-D: kernel launches {launches}, by route {routes}")
    for label, st in (("A", sa), ("B", sb), ("C", sc), ("D", sd)):
        log(f"[fleet] drain {label}: {st['us_per_job_step']:.2f} us a job "
            f"step against phase 3b's single-job runs: "
            + ", ".join(f"{m} {tiers['summary'][m + '/suite']['us_per_step']:.2f}"
                        for m in ("blocks", "superblock", "auto"))
            + f", run_program "
            f"{tiers['summary']['auto/suite']['run_program_us_per_step']:.2f}")

    # the verified optimizer through both compiled tiers
    opt = suite.load_digests(suite.OPTIMIZED_DIGESTS_PATH)
    zero_egpu_counters()
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
    opt_launches, opt_routes = read_egpu_counters("the optimized runs")
    log(f"[fleet] compile_program(optimize=True): {n} runs (22 jobs x "
        "blocks, superblock) match the reference's optimized digests; "
        f"kernel launches {opt_launches}, by route {opt_routes}")
    return {"launches": launches, "routes": routes,
            "opt_launches": opt_launches, "opt_routes": opt_routes,
            "drains": {"A": sa, "B": sb, "C": sc, "D": sd}}


# ---------------------------------------------------------------------------
# phase 3d: the serving loop and the multi-device fleet (fleet/service.py,
# fleet/sharded.py, fleet/devices.py)
# ---------------------------------------------------------------------------

def run_serving(dev, fleet: dict) -> dict:
    """Phase 3d: the serving loop and the multi-device fleet, on the 22
    paper-size suite jobs (each submitted :data:`FLEET_COPIES` times),
    one service or fleet a suite configuration, every result held
    against the reference's digests.  (a) ``FleetService(batch_size=32)``
    for each configuration at once, cold (graph captures at width 32)
    then warm (a fresh service), with the submit-to-resolve latency of
    its own histogram; (b) ``serve_jobs`` under a seeded ``FaultPlan``
    (``compile``, ``dispatch``, ``residency_evict``,
    ``salvage_corrupt``): every future resolves, at least 3 faults;
    (c) the watchdog: a warm cohort, one ``device_sync`` hang longer
    than ``dispatch_timeout_s`` (ten times a warm drain): 1 scheduler
    reset, the cohort counted as timeouts, the retried results held;
    (d) ``Fleet(devices="all")``: one megabatch slab of ``matmul_64_dp``
    and the mixed suite through the balanced lanes, bit-identical to a
    plain ``Fleet`` of the same submissions; (e) ``FleetService(devices=
    "all")`` under ``device_fail`` on every device: the last healthy
    device is never killed.  The eGPU kernels' counters are zeroed just
    before and read just after (a)-(c), (d) and (e): every launch on
    ``step``."""
    from repro_torch import programs
    from repro_torch.core import benchmark_config
    from repro_torch.fleet import (FaultPlan, Fleet, FleetScheduler,
                                   FleetService, serve_jobs)
    from repro_torch.programs import suite

    digests = suite.load_digests()
    groups = {c: suite.build_suite(programs, benchmark_config,
                                   [suite.SUITE[i] for i in idx], config=c)
              for c, idx in fleet_batches().items()}
    cfgs = {c: benchmark_config(**suite.CONFIGS[c]) for c in groups}
    steps = {k: v["steps"] for k, v in digests.items()}
    job_steps = FLEET_COPIES * sum(steps[b.name] for g in groups.values()
                                   for b in g)
    drain_b = fleet["drains"]["B"]["us_per_job_step"]
    out: dict = {}

    def copies(c):
        return [b for _ in range(FLEET_COPIES) for b in groups[c]]

    def outcome_held(b, r, where):
        if isinstance(r, Exception):
            raise AssertionError(f"{where} {b.name}: {r!r}")
        result_held(digests, b.name, r, where)

    def serve(label, **kw):
        """Every configuration's copies through its own FleetService, all
        services at once; returns (wall s, compile s, services)."""
        svcs = {c: FleetService(cfg, batch_size=32, device=dev, **kw)
                for c, cfg in cfgs.items()}
        try:
            t0 = time.perf_counter()
            futs = {c: [(b, svcs[c].submit(b.image, b.shared_init,
                                           tdx_dim=b.tdx_dim, tag=b.name))
                        for b in copies(c)] for c in cfgs}
            for c, fs in futs.items():
                for b, f in fs:
                    outcome_held(b, f.result(timeout=600), f"serve {label}")
            wall = time.perf_counter() - t0
        finally:
            for s in svcs.values():
                s.close()
        compile_s = sum(s.metrics.total("fleet_compile_seconds_total")
                        for s in svcs.values())
        return wall, compile_s, svcs

    # (a) the service, cold then warm
    zero_egpu_counters()
    for label in ("cold", "warm"):
        wall, compile_s, svcs = serve(label)
        slo = {c: s.stats.final_snapshot.meta["slo"] for c, s in svcs.items()}
        st = {c: s.stats for c, s in svcs.items()}
        n = sum(x.completed for x in st.values())
        if n != sum(len(copies(c)) for c in cfgs):
            raise AssertionError(f"serve {label}: {n} completed")
        row = {"wall_s": wall, "compile_s": compile_s, "jobs": n,
               "jobs_per_s": n / wall, "us_per_job_step":
               1e6 * wall / job_steps,
               "us_per_job_step_exec": 1e6 * (wall - compile_s) / job_steps,
               "dispatches": sum(x.dispatches for x in st.values()),
               "p50_s": {c: v["request_p50_s"] for c, v in slo.items()},
               "p99_s": {c: v["request_p99_s"] for c, v in slo.items()}}
        out[f"serve_{label}"] = row
        log(f"[serve] (a) FleetService(batch_size=32) {label}, one a "
            f"configuration, at once: {n} jobs in {wall:.3f}s "
            f"({row['jobs_per_s']:.1f} jobs/s), compile_s {compile_s:.3f}, "
            f"{row['us_per_job_step']:.2f} us a job step "
            f"({row['us_per_job_step_exec']:.2f} less compile) over "
            f"{job_steps} job steps, against phase 3c's drain B "
            f"{drain_b:.2f}; cohorts {row['dispatches']}; submit-to-resolve "
            "latency (the service's histogram) p50 "
            + ", ".join(f"{c} {v * 1e3:.1f} ms" for c, v in row["p50_s"].items())
            + ", p99 "
            + ", ".join(f"{c} {v * 1e3:.1f} ms" for c, v in row["p99_s"].items())
            + "; every result holds against the digests")

    # (b) the chaos soak
    plan = FaultPlan(seed=17, compile={"p": 1.0, "count": 2},
                     dispatch={"p": 1.0, "count": 2, "after": 1},
                     residency_evict=0.2, salvage_corrupt=0.5)
    jobs = copies("dot")
    t0 = time.perf_counter()
    res = serve_jobs(cfgs["dot"], [dict(image=b.image, tdx_dim=b.tdx_dim,
                                        shared_init=b.shared_init,
                                        tag=b.name) for b in jobs],
                     batch_size=32, device=dev, faults=plan, max_retries=3,
                     backoff_s=0.001)
    wall = time.perf_counter() - t0
    for b, r in zip(jobs, res):
        outcome_held(b, r, "chaos soak")
    if plan.total_injected() < 3:
        raise AssertionError(f"chaos soak: injected {plan.injected}")
    out["chaos"] = {"jobs": len(res), "injected": dict(plan.injected),
                    "wall_s": wall}
    log(f"[serve] (b) chaos soak under FaultPlan(seed=17): {len(res)} "
        f"futures resolved in {wall:.3f}s, injected {plan.injected}, every "
        "result holds against the digests")

    # (c) the watchdog: warm cohort, one device_sync hang
    wd = groups["pred2"]
    sched = FleetScheduler(cfgs["pred2"], batch_size=32, compile_min=1,
                           fixed_bucket=True, device=dev)
    walls = []
    for _ in range(2):
        for b in wd:
            sched.submit(b.image, b.shared_init, tdx_dim=b.tdx_dim)
        t0 = time.perf_counter()
        sched.drain_isolated()
        walls.append(time.perf_counter() - t0)
    timeout = max(0.5, 10 * min(walls))
    plan = FaultPlan(seed=5, device_sync={"p": 1.0, "count": 1,
                                          "hang_s": 2 * timeout})
    svc = FleetService(cfgs["pred2"], batch_size=32, device=dev,
                       faults=plan, dispatch_timeout_s=timeout,
                       max_retries=2, max_delay_s=0.1)
    try:
        futs = [(b, svc.submit(b.image, b.shared_init, tdx_dim=b.tdx_dim,
                               tag=b.name)) for b in wd]
        for b, f in futs:
            outcome_held(b, f.result(timeout=600), "watchdog")
    finally:
        svc.close()
    st = svc.stats
    if st.scheduler_resets != 1 or st.timeouts != len(wd) \
            or plan.injected.get("device_sync") != 1:
        raise AssertionError(f"watchdog: resets {st.scheduler_resets}, "
                             f"timeouts {st.timeouts}, injected "
                             f"{plan.injected}")
    out["watchdog"] = {"timeout_s": timeout, "warm_drain_s": min(walls),
                       "resets": st.scheduler_resets,
                       "timeouts": st.timeouts}
    log(f"[serve] (c) watchdog: warm drain {min(walls):.3f}s, "
        f"dispatch_timeout_s {timeout:.3f}, one device_sync hang of "
        f"{2 * timeout:.3f}s: {st.scheduler_resets} scheduler reset, "
        f"{st.timeouts} timeouts, retried results hold against the digests")
    service_a = read_egpu_counters("the service")

    # (d) the sharded fleet, against a plain Fleet of the same submissions
    mega = next(b for b in groups["dot"] if b.name == "matmul_64_dp")
    sharded = {c: Fleet(cfg, batch_size=32, devices="all")
               for c, cfg in cfgs.items()}
    n_dev = sharded["dot"]._sched.n_devices
    sets = {"megabatch": {"dot": [mega] * (n_dev * 32 + 3)},
            "mixed": {c: copies(c) for c in cfgs}}

    def drain_all(fleets, subs):
        t0 = time.perf_counter()
        got = {}
        for c, bs in subs.items():
            hs = [fleets[c].submit(b.image, b.shared_init, tdx_dim=b.tdx_dim,
                                   tag=b.name) for b in bs]
            res = fleets[c].drain()
            got[c] = [res[h] for h in hs]
        return got, time.perf_counter() - t0

    plain = {c: Fleet(cfg, batch_size=32, device=dev)
             for c, cfg in cfgs.items()}
    expect = {k: drain_all(plain, subs)[0] for k, subs in sets.items()}
    zero_egpu_counters()
    for k, subs in sets.items():
        before = {c: f.stats.per_device() for c, f in sharded.items()}
        got, wall = drain_all(sharded, subs)
        for c, bs in subs.items():
            for b, g, e in zip(bs, got[c], expect[k][c]):
                result_held(digests, b.name, g, f"sharded {k}")
                if not (np.array_equal(g.shared, e.shared)
                        and (g.cycles, g.steps, g.tier)
                        == (e.cycles, e.steps, e.tier)):
                    raise AssertionError(f"sharded {k} {b.name}: differs "
                                         "from the plain Fleet's result")
        per = {}
        for c, f in sharded.items():
            for lbl, v in f.stats.per_device().items():
                b0 = before[c].get(lbl, {"jobs": 0, "batches": 0})
                p = per.setdefault(lbl, {"jobs": 0, "batches": 0})
                p["jobs"] += v["jobs"] - b0["jobs"]
                p["batches"] += v["batches"] - b0["batches"]
        n = sum(len(bs) for bs in subs.values())
        st_steps = sum(steps[b.name] for bs in subs.values() for b in bs)
        row = {"jobs": n, "wall_s": wall, "jobs_per_s": n / wall,
               "us_per_job_step": 1e6 * wall / st_steps,
               "job_steps": st_steps, "by_device": per}
        out[f"sharded_{k}"] = row
        mesh = per.get("mesh", {"jobs": 0, "batches": 0})
        if k == "megabatch" and mesh["batches"] != 1:
            raise AssertionError(f"sharded megabatch: {per}")
        log(f"[sharded] (d) Fleet(devices='all'), {n_dev} device(s), {k}: "
            f"{n} jobs in {wall:.3f}s ({row['jobs_per_s']:.1f} jobs/s), "
            f"{row['us_per_job_step']:.2f} us a job step over {st_steps} "
            f"job steps (phase 3c drain B {drain_b:.2f}); megabatch slabs "
            f"{mesh['batches']} ({mesh['jobs']} jobs), lane batches "
            + ", ".join(f"{lbl} {v['batches']} ({v['jobs']} jobs)"
                        for lbl, v in per.items() if lbl != "mesh")
            + "; bit-identical to the plain Fleet, every result against "
            "the digests")
    sharded_l = read_egpu_counters("the sharded fleet")

    # (e) the per-device service: device_fail on its only device
    zero_egpu_counters()
    plan = FaultPlan(seed=9, device_fail=1.0)
    svc = FleetService(cfgs["dot"], batch_size=32, devices="all",
                       faults=plan)
    try:
        futs = [(b, svc.submit(b.image, b.shared_init, tdx_dim=b.tdx_dim,
                               tag=b.name)) for b in groups["dot"]]
        for b, f in futs:
            outcome_held(b, f.result(timeout=600), "per-device service")
    finally:
        svc.close()
    healthy = svc.healthy_devices
    if svc.stats.failed or len(healthy) != 1 \
            or not plan.injected.get("device_fail"):
        raise AssertionError(f"per-device service: failed "
                             f"{svc.stats.failed}, healthy {healthy}, "
                             f"injected {plan.injected}")
    out["per_device"] = {"healthy": list(healthy),
                         "device_fail_injected": plan.injected["device_fail"]}
    log(f"[serve] (e) FleetService(devices='all') under device_fail on "
        f"every device: {plan.injected['device_fail']} device_fail faults, "
        f"the last healthy device {healthy} kept serving, 0 failed")
    service_e = read_egpu_counters("the per-device service")
    launches = {k: service_a[0][k] + service_e[0][k] for k in service_a[0]}
    routes = {k: {r: service_a[1][k][r] + service_e[1][k][r]
                  for r in service_a[1][k]} for k in service_a[1]}
    log(f"[serve] kernel launches: the service {launches}, by route "
        f"{routes}; the sharded fleet {sharded_l[0]}, by route "
        f"{sharded_l[1]}")
    out.update(launches=launches, routes=routes,
               sharded_launches=sharded_l[0], sharded_routes=sharded_l[1])
    return out


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


def zero_egpu_counters() -> dict:
    counters = egpu_counters()
    for f in counters.values():
        f.launches = 0
        f.by_route = dict.fromkeys(f.by_route, 0)
    return counters


def read_egpu_counters(label: str) -> tuple:
    """``(launches, by route)`` of the eGPU kernels since they were
    zeroed; fails unless each kernel launched and every launch was on
    the ``step`` route."""
    import torch
    torch.cuda.synchronize()
    counters = egpu_counters()
    launches = {k: f.launches for k, f in counters.items()}
    routes = {k: dict(f.by_route) for k, f in counters.items()}
    for k, v in routes.items():
        if v["step"] <= 0 or v["tile"] or v["step"] != launches[k]:
            raise AssertionError(f"{k}: {label}'s launches by route {v}, "
                                 "expected all on 'step'")
    return launches, routes


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


#: profiles of one window at most, and the pause (s) that opens and closes
#: the profiled call inside the tracer's window (:func:`window`)
TRACE_TRIES, TRACE_PAUSE_S = 3, 0.05


def window(fn, steps: int) -> dict:
    """Device kernels and torch ops a step over one call of ``fn`` (which
    runs ``steps`` steps), by ``torch.profiler`` after one warm-up cycle
    of it, with the eGPU kernels' ``step``-route launches a step counted
    by their wrappers over the same call; and host µs a step of another,
    unprofiled call (ended by a synchronise).  The tracer can drop kernel
    records at the edges of its window (seen on the card: 48 of 64), so
    the call starts and ends a pause inside it, and the window is
    profiled again, up to ``TRACE_TRIES`` times, while it traced fewer
    kernels than the wrappers launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_us = 1e6 * (time.perf_counter() - t0) / steps
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    for attempt in range(1, TRACE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(TRACE_PAUSE_S)
            c0 = step_launches()
            fn()
            torch.cuda.synchronize()
            launched = sum(minus(step_launches(), c0).values())
            time.sleep(TRACE_PAUSE_S)
        ev = prof.key_averages()
        kern = {}
        for e in ev:
            if e.key.startswith("ProfilerStep"):     # the schedule's own span
                continue
            if dev_us(e) > 0 and str(getattr(e, "device_type", "")
                                     ).endswith("CUDA"):
                k = re.match(r"(?:void )?([\w:]+)", e.key.replace(
                    "(anonymous namespace)::", "")).group(1).split("::")[-1]
                kern[k] = kern.get(k, 0) + e.count
        if not kern or sum(kern.values()) >= launched:
            break
        log(f"[profile-egpu] the tracer kept {sum(kern.values())} of the "
            f"{launched} kernels launched (try {attempt} of {TRACE_TRIES})")
    aten = {e.key: e.count for e in ev if e.key.startswith("aten::")}
    return {"kernels": sum(kern.values()) / steps if kern else None,
            "kernel_names": kern, "torch_ops": sum(aten.values()) / steps,
            "torch_op_names": aten, "host_us": host_us,
            "launched": launched / steps, "tries": attempt}


def profile_steps(dev) -> dict:
    """Where an eGPU FP or DOT/SUM step's time goes: the main path's step
    (``executor.run_steps`` over a program of nothing but such steps, one
    core; and an 18-core fleet whose every step mixes the five FP
    opcodes) against the previous composition on the same trace rows.
    Raises unless a step of the main path launches its one kernel (by
    the wrappers' counts and by the trace) and no torch op around it."""
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
                f"{w['kernel_names']} (step route launched "
                f"{w['launched']:.2f}, traced in try {w['tries']}), "
                f"{w['torch_ops']:.2f} torch ops a step "
                f"{w['torch_op_names']}, host {w['host_us']:.1f} us a step "
                "(unprofiled)")
        now = got["now"]
        if (now["torch_ops"] or now["launched"] != 1.0
                or now["kernels"] not in (None, 1.0)):
            raise AssertionError(f"{kind}: the main path's step launches "
                                 f"{now['launched']} kernels by its "
                                 f"wrappers' counts, {now['kernels']} by the "
                                 f"trace ({now['kernel_names']}, "
                                 f"{now['tries']} tries) and "
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


# ---------------------------------------------------------------------------
# phase 6: LM training (granite-moe-3b-a800m, full width)
# ---------------------------------------------------------------------------

#: the backward kernels' cases: (B, H, KV, Sq, Sk, D, causal) for
#: attention, the training call first (S = 511: ``loss_fn`` drops the
#: last of 512 tokens); (E, M, K, N) for the expert GEMM's gradient, the
#: training up and down projections first (capacity 818 rows, whose
#: ``A^T`` rows need the padded contraction)
BWD_ATTN_CASES = ((8, 24, 8, 511, 511, 64, True),
                  (2, 2, 2, 128, 128, 64, True), (2, 6, 2, 37, 37, 12, True),
                  (2, 4, 1, 100, 300, 128, True),
                  (2, 8, 2, 200, 200, 64, False),
                  (3, 24, 8, 1, 1024, 64, False),
                  (2, 4, 4, 16, 48, 16, False),
                  # rows with no live key: a batch entry of length 0, and
                  # causal with Sq > Sk (the first Sq - Sk rows see no key)
                  (3, 6, 2, 70, 70, 64, True, (70, 0, 33)),
                  (3, 8, 2, 130, 100, 32, False, (0, 100, 41)),
                  (2, 4, 1, 150, 90, 64, True, (90, 57)),
                  (2, 6, 3, 100, 37, 12, True, (37, 0)))
BWD_MM_CASES = ((40, 818, 1536, 512), (40, 818, 512, 1536), (5, 200, 48, 64),
                (3, 300, 160, 96), (7, 9, 64, 24))


def bwd_attn_routes(dtype, d) -> tuple:
    """The attention backward's routes that take a case of fresh
    (TMA-legal) tensors: ``simt`` all, ``wgmma`` bfloat16 with head_dim a
    multiple of 16 up to ``BWD_WGMMA_HEAD_DIM``."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    return tuple(r for r in fops.BWD_ROUTES if r == "simt" or (
        dtype == torch.bfloat16 and d % 16 == 0
        and d <= fops.BWD_WGMMA_HEAD_DIM))


def check_lm_backward(dev) -> dict:
    """The backward kernels against their plain versions: the attention
    backward (``dq`` and ``dkdv``), each route that takes the case, against
    ``mha_ref_bwd`` over ragged S, GQA G = 1, 3, 4, lengths below S, causal
    and not, float32 and bfloat16, twice (bit-identical), and with poisoned
    keys past each length (no bit of dq moves; those keys' dk, dv zero);
    rows with no live key (a length of 0, causal Sq > Sk) get a zero
    output and dq; the ``wavefront_matmul`` gradient against
    ``wavefront_matmul_ref_bwd`` with inactive tiles and a padded
    contraction.  Returns the worst error by kernel (the attention's by
    route) and the backward's routes."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref
    from repro_torch.kernels.wavefront_matmul import ops as mops, ref as mref
    g = torch.Generator(device=dev).manual_seed(5)
    worst = {"flash_attention_bwd": dict.fromkeys(fops.BWD_ROUTES, 0.0),
             "wavefront_matmul_bwd": 0.0}
    attn_cases = dict.fromkeys(fops.BWD_ROUTES, 0)
    mm_routes = {}
    n = 0
    for dt in (torch.float32, torch.bfloat16):
        tol = fops.BWD_TOLERANCE[dt]
        for case in BWD_ATTN_CASES:
            b_, h, kv, sq, sk, d, causal = case[:7]
            rn = lambda *sh: torch.randn(sh, generator=g, device=dev).to(dt)
            q, kk, vv = rn(b_, h, sq, d), rn(b_, kv, sk, d), rn(b_, kv, sk, d)
            do = rn(b_, h, sq, d)
            lens = torch.randint(1, sk + 1, (b_,), generator=g, device=dev,
                                 dtype=torch.int32)
            lens[0] = sk
            if len(case) > 7:
                lens = torch.tensor(case[7], dtype=torch.int32, device=dev)
            o = fops.flash_attention(q, kk, vv, lens, causal)
            exp = fref.mha_ref_bwd(q, kk, vv, o, do, lens, causal)
            k2, v2 = kk.clone(), vv.clone()
            for i, ln in enumerate(lens.tolist()):
                k2[i, :, ln:] = 1e4
                v2[i, :, ln:] = -1e4
            for route in bwd_attn_routes(dt, d):
                run = lambda k_, v_: fops.run_bwd_route(
                    route, q, k_, v_, o, do, lens, causal)
                got, again, poisoned = run(kk, vv), run(kk, vv), run(k2, v2)
                torch.cuda.synchronize()
                where = f"flash_attention backward ({route}) {dt} " \
                        f"{tuple(q.shape)} {tuple(kk.shape)} causal={causal}"
                try:
                    for x, y in zip(got, exp):
                        worst["flash_attention_bwd"][route] = max(
                            worst["flash_attention_bwd"][route],
                            within(x, y, tol))
                    if not all(torch.equal(x, y) for x, y in zip(got, again)):
                        raise AssertionError("two runs differ")
                    if not torch.equal(poisoned[0], got[0]):
                        raise AssertionError("poisoned keys changed a bit of "
                                             "dq")
                    for i, ln in enumerate(lens.tolist()):
                        if torch.count_nonzero(poisoned[1][i, :, ln:]) \
                                or torch.count_nonzero(poisoned[2][i, :, ln:]):
                            raise AssertionError("dk or dv not zero past a "
                                                 "length")
                        # rows with no live key: zero output, zero dq
                        dead = sq if ln == 0 else (max(0, sq - sk) if causal
                                                   else 0)
                        if torch.count_nonzero(o[i, :, :dead]) \
                                or torch.count_nonzero(got[0][i, :, :dead]):
                            raise AssertionError("a row with no live key has "
                                                 "a non-zero output or dq")
                except AssertionError as err:
                    raise AssertionError(f"{where}: {err}") from None
                attn_cases[route] += 1
                n += 1
        tol = mops.TOLERANCE[dt]
        for e, m, k, nn in BWD_MM_CASES:
            a = torch.randn((e, m, k), generator=g, device=dev).to(dt)
            b = (torch.randn((e, k, nn), generator=g, device=dev)
                 / k ** 0.5).to(dt)
            dc = torch.randn((e, m, nn), generator=g, device=dev).to(dt)
            act = torch.randint(0, 2, (e, -(-m // 128)), generator=g,
                                device=dev, dtype=torch.int32)
            act[0] = 1
            before = {p: dict(r) for p, r in
                      mops.wavefront_matmul.backward_by_route.items()}
            da, db = mops.matmul_bwd(a, b, act, dc)
            eda, edb = mref.wavefront_matmul_ref_bwd(a, b, act, dc)
            torch.cuda.synchronize()
            # dB sums M products where the forward summed K: its rounding
            # is held at the same relative tolerance, over its own scale
            try:
                worst["wavefront_matmul_bwd"] = max(
                    worst["wavefront_matmul_bwd"], within(da, eda, tol),
                    within(db, edb, (tol[0] * m ** 0.5, tol[1])))
                off = ~mref.tile_mask(act, m)
                if torch.count_nonzero(da[off]):
                    raise AssertionError("inactive tiles' dA not zero")
            except AssertionError as err:
                raise AssertionError(f"wavefront_matmul backward {dt} "
                                     f"{e}x{m}x{k}x{nn}: {err}") from None
            took = {p: [r for r, c in v.items() if c > before[p][r]] for p, v
                    in mops.wavefront_matmul.backward_by_route.items()}
            mm_routes[f"{dt} {e}x{m}x{k}x{nn}"] = took
            n += 1
    if not all(attn_cases.values()):
        raise AssertionError(f"a backward route was never checked: "
                             f"{attn_cases}")
    log(f"[lm-backward] flash_attention backward (dq, dkdv; cases by route "
        f"{attn_cases}) and the wavefront_matmul gradient: {n} cases within "
        f"tolerance of mha_ref_bwd and wavefront_matmul_ref_bwd (ragged S, "
        f"GQA 1/3/4, lengths < S, causal and not, float32 and bfloat16; two "
        f"runs bit-identical; poisoned tails change no bit; rows with no "
        f"live key (a length of 0, causal Sq > Sk) zero); worst {worst}; "
        f"gradient products' routes {mm_routes}")
    return {"worst": worst, "routes": mm_routes}


#: the full-width training run: granite-moe-3b-a800m, bf16 compute, f32
#: master parameters and optimizer state, 8 x 512 tokens, 6 steps
TRAIN = dict(arch="granite-moe-3b-a800m", batch=8, seq=512, steps=6, seed=0)


def train_reference(dev) -> dict:
    """The smoke trainer on the card against the JAX reference's file;
    yi-9b's bf16 run (head_dim 16) takes the ``wgmma`` attention
    backward, the rest ``simt`` (float32, granite's head_dim 12)."""
    from repro_torch.launch import train
    t0 = time.perf_counter()
    before = bwd_counts()["flash_attention"]
    out = train.hold_against_reference(dev, archs={"granite-moe-3b-a800m",
                                                   "yi-9b"})
    moved = {k: {r: c - before[k][r] for r, c in v.items()}
             for k, v in bwd_counts()["flash_attention"].items()}
    if not all(v["wgmma"] and v["simt"] for v in moved.values()):
        raise AssertionError(f"smoke trainers' attention backward by route "
                             f"{moved}: expected both routes")
    for name, errs in out.items():
        dt = name.split()[-1]
        log(f"[train-ref] {name}: every step's loss, grad_norm and lr within "
            f"{train.TOLERANCE[dt]} (relative) of the reference's; largest "
            f"relative errors {errs}")
    log(f"[train-ref] attention backward launches by kernel and route "
        f"{moved} (yi-9b bfloat16 on wgmma)")
    log(f"[train-ref] {time.perf_counter() - t0:.1f}s")
    return out


def train_checkpoint(dev) -> None:
    """The smoke trainer on the card with checkpoints (async saves every 5
    steps from card tensors) and a NaN injected at step 8: the run
    restores the step-5 checkpoint onto the card and completes.  Only at
    smoke size: a full-width checkpoint would be about 40 GB of files."""
    import tempfile
    from repro_torch.launch import train
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ck:
        losses = train.main(["--arch", "yi-9b", "--smoke", "--steps", "16",
                             "--batch", "4", "--seq", "16", "--ckpt-dir", ck,
                             "--ckpt-every", "5", "--inject-nan-at", "8",
                             "--log-every", "100", "--device", str(dev)])
    if len(losses) < 14 or not np.isfinite(losses).all():
        raise AssertionError(f"checkpointed smoke run: losses {losses}")
    log(f"[train-ckpt] yi-9b smoke on the card, NaN injected at step 8, "
        f"restored from the step-5 checkpoint: {len(losses)} finite losses")


def active_params(cfg) -> tuple:
    """(active parameters a token uses, the formula): every parameter but
    the embedding table, with the experts' weights counted for the
    ``top_k`` of ``num_experts`` a token is routed to (expert choice's
    capacity gives each token ``top_k`` expert slots on average)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd
    attn = d * h * hd * 2 + d * kv * hd * 2
    experts = cfg.top_k * 3 * d * cfg.expert_d_ff
    layer = attn + d * cfg.num_experts + experts + 2 * d
    n = cfg.n_layers * layer + d + d * cfg.vocab
    return n, (f"{cfg.n_layers} layers x (attention {attn} + router "
               f"{d * cfg.num_experts} + top-{cfg.top_k} experts {experts} + "
               f"norms {2 * d}) + ln_f {d} + unembed {d * cfg.vocab}")


def bwd_counts() -> dict:
    """The backward launches by kernel and route, as a copy."""
    c = lm_counters()
    return {k: {p: dict(r) for p, r in c[k].backward_by_route.items()}
            for k in ("flash_attention", "wavefront_matmul")}


def zero_lm_counters() -> None:
    for f in lm_counters().values():
        f.launches = 0
        f.by_route = dict.fromkeys(f.by_route, 0)
        f.backward_launches = 0
        f.backward_by_route = {k: (dict.fromkeys(v, 0) if isinstance(v, dict)
                                   else 0)
                               for k, v in f.backward_by_route.items()}


def train_full(dev, gpu: str) -> dict:
    """Phase 6's main path: ``repro_torch.launch.train.main`` at
    granite-moe-3b-a800m's full width and depth, its kernel counters
    zeroed just before and read just after."""
    import torch
    from repro_torch.launch import train
    t = TRAIN
    argv = ["--arch", t["arch"], "--batch", str(t["batch"]), "--seq",
            str(t["seq"]), "--steps", str(t["steps"]), "--seed",
            str(t["seed"]), "--log-every", "1", "--device", str(dev)]
    torch.cuda.reset_peak_memory_stats(dev)
    zero_lm_counters()
    rec = {}
    t0 = time.perf_counter()
    losses = train.main(argv, record=rec)
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in lm_counters().items()}
    routes, bwd = route_counts(), bwd_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    cfg = rec["cfg"]
    steps = rec["steps"]
    if len(losses) != t["steps"] or not np.isfinite(losses).all():
        raise AssertionError(f"training losses {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    # remat: each step runs every block forward twice (the forward and the
    # backward's recompute) and backward once; a block has one attention
    # and three expert GEMMs, each GEMM two gradient products
    blocks = cfg.n_layers * t["steps"]
    want = {"flash_attention": {"wgmma": 2 * blocks, "split": 0, "simt": 0},
            "wavefront_matmul": {"wgmma": 6 * blocks, "small_m": 0,
                                 "simt": 0}}
    want_bwd = {"flash_attention": {k: {"wgmma": blocks, "simt": 0}
                                    for k in ("dq", "dkdv")},
                "wavefront_matmul": {p: {"wgmma": 3 * blocks, "small_m": 0,
                                         "simt": 0} for p in ("da", "db")}}
    if routes != want or bwd != want_bwd:
        raise AssertionError(f"training launches by route {routes}, "
                             f"backward {bwd}; expected {want}, {want_bwd}")
    step_s = statistics.median(r["seconds"] for r in steps[1:])
    tokens = rec["tokens_per_step"]
    n_active, formula = active_params(cfg)
    mfu = 6 * n_active * tokens / step_s / PEAK_BF16_S
    for r in steps:
        log(f"[train] step {r['step']}: loss {r['loss']:.4f} grad_norm "
            f"{r['grad_norm']:.4f} lr {r['lr']:.3e} {r['seconds']:.3f}s")
    log(f"[train] {cfg.name} full width and depth, bf16 compute, f32 master "
        f"and AdamW state, {t['batch']} x {t['seq']} tokens, {t['steps']} "
        f"steps in {wall:.1f}s (build and init included): losses finite, "
        f"mean of the last 3 {np.mean(losses[-3:]):.4f} below the first "
        f"{losses[0]:.4f} ({gpu})")
    log(f"[train] seconds a step (median of steps 2-{t['steps']}) "
        f"{step_s:.4f}; {tokens / step_s:.1f} tokens/s ({tokens} tokens a "
        f"step); peak memory {peak / 2**30:.2f} GiB "
        f"(max_memory_allocated) ({gpu})")
    log(f"[train] train_mfu {100 * mfu:.2f} % = 6 x {n_active} active "
        f"parameters x {tokens} tokens / {step_s:.4f} s / 989e12 FLOP/s; "
        f"active parameters = {formula} ({gpu})")
    log(f"[train] launches: forward {launches} by route {routes}; backward "
        f"{bwd}")
    model, opt_state, step_fn, ds = rec.pop("state")
    shares = profile_train_step(model, opt_state, step_fn, ds, dev, gpu)
    del model, opt_state, step_fn, rec
    return {"cfg": cfg, "launches": launches, "routes": routes, "bwd": bwd,
            "step_s": step_s, "tokens_s": tokens / step_s, "mfu": mfu,
            "peak": peak, "shares": shares, "losses": losses}


#: kernel names by the family the profile sums them into
KERNEL_FAMILIES = (("flash_attention backward", ("fa_bwd_",)),
                   ("flash_attention", ("fa_wgmma_kernel",
                                        "flash_attention_kernel")),
                   ("wavefront_matmul", ("wgmma_matmul_kernel",
                                         "small_m_matmul_kernel",
                                         "wavefront_matmul_kernel")))


def profile_train_step(model, opt_state, step_fn, ds, dev, gpu,
                       step=TRAIN["steps"], tag="[train-profile]") -> dict:
    """One more full-width step (``step``, after the counted run) under
    ``torch.profiler``: each kernel's share of the step's device time,
    and the hand-written kernels' by family; log lines begin with
    ``tag``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             ds.next_batch(step).items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, _, m = step_fn(model, opt_state, batch, None)
        float(m["loss"])
        wall = time.perf_counter() - t0
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    kern = [e for e in prof.key_averages() if dev_us(e) > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not kern:
        log(f"{tag} the profiler showed no device time: not "
            "measured")
        return {}
    busy = sum(dev_us(e) for e in kern)
    fam = {}
    for e in kern:
        name = next((f for f, keys in KERNEL_FAMILIES
                     if any(k in e.key for k in keys)), "other")
        fam[name] = fam.get(name, 0) + dev_us(e)
    shares = {k: v / busy for k, v in fam.items()}
    log(f"{tag} one step: device busy {busy / 1e6:.4f}s of "
        f"{wall:.4f}s profiled wall ({100 * busy / 1e6 / wall:.1f} % busy); "
        f"share of device time by family: "
        + ", ".join(f"{k} {100 * v:.1f} %" for k, v in
                    sorted(shares.items(), key=lambda x: -x[1]))
        + f" ({gpu})")
    for e in sorted(kern, key=dev_us, reverse=True)[:12]:
        log(f"{tag}   {100 * dev_us(e) / busy:5.1f} %  "
            f"{dev_us(e) / 1e3:9.3f} ms  x{e.count:<6} {e.key[:80]}")
    # the attention backward by kernel: its dq and dkdv apart
    for e in kern:
        if "fa_bwd_" in e.key:
            log(f"{tag}   attention backward {e.key[:60]}: "
                f"{dev_us(e) / 1e3:.4f} ms in {e.count} launches, "
                f"{dev_us(e) / 1e3 / max(1, e.count):.5f} ms each")
    return {"busy_s": busy / 1e6, "wall_s": wall, "families": shares}


def attn_bwd_work(q, k, lens, causal) -> tuple:
    """(bytes, FLOPs) of the attention backward: q, k, v, o, do read once,
    dq, dk, dv written once (four tensors of q's size, four of the live
    keys'); 10 FLOPs a (query head, key, dim) triple the mask keeps (S
    recomputed, dP, dV, dQ, dK: two each)."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    pairs = keys = 0
    for ln in lens.tolist():
        lim = [min(ln, i + (sk - sq) + 1) if causal else ln
               for i in range(sq)]
        pairs += sum(max(0, min(x, sk)) for x in lim)
        keys += max(0, min(max(lim), sk))
    el = q.element_size()
    nbytes = el * (4 * q.numel() + 4 * kv * keys * d) + 4 * lens.numel()
    return nbytes, 10 * h * d * pairs


def attn_bwd_row(q, k, v, do, lens, causal) -> dict:
    """The attention backward (``dq`` + ``dkdv``) at one call's bf16
    inputs: held against ``mha_ref_bwd`` (``BWD_TOLERANCE``), then its
    ``wgmma`` route, its ``simt`` route (the previous design) and
    ``torch.autograd.grad`` of ``scaled_dot_product_attention`` timed the
    same way (by CUDA graph where the library's autograd captures, else
    all three eagerly by CUDA events; ``wgmma`` before and after the
    others), each route by CUDA graph too, the plain version eagerly, with
    the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref
    o = fops.flash_attention(q, k, v, lens, causal)
    routed = fops.route_bwd(q, k, v, o, do)
    if routed != "wgmma":
        raise AssertionError(f"the attention backward at {tuple(q.shape)} "
                             f"{tuple(k.shape)} routes to {routed}")
    got = fops.attention_bwd(q, k, v, o, do, lens, causal)
    exp = fref.mha_ref_bwd(q, k, v, o, do, lens, causal)
    torch.cuda.synchronize()
    err = max(within(x, y, fops.BWD_TOLERANCE[q.dtype])
              for x, y in zip(got, exp))
    del got, exp
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    lib_o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                           enable_gqa=True)
    lib = lambda: torch.autograd.grad(lib_o, (qg, kg, vg), do,
                                      retain_graph=True)
    kern = {r: (lambda r=r: fops.run_bwd_route(r, q, k, v, o, do, lens,
                                               causal))
            for r in fops.BWD_ROUTES}
    graph = lambda fn: graph_ms(fn, reps=5, rounds=3)
    try:
        library_ms = graph(lib)
        timer, timing = graph, "CUDA graph"
    except RuntimeError as refused:
        torch.cuda.synchronize()
        timer = lambda fn: time_ms(fn, reps=10, rounds=3)
        timing = (f"eager, CUDA events (the autograd of "
                  f"scaled_dot_product_attention does not capture: "
                  f"{str(refused).splitlines()[0][:80]})")
        library_ms = timer(lib)
    ms = [timer(kern["wgmma"])]
    simt_ms = timer(kern["simt"])
    plain_ms = time_ms(lambda: fref.mha_ref_bwd(q, k, v, o, do, lens,
                                                causal), reps=2, rounds=3)
    ms.append(timer(kern["wgmma"]))
    graph_by_route = {r: graph(kern[r]) for r in fops.BWD_ROUTES}
    nbytes, flops = attn_bwd_work(q, k, lens, causal)
    t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_BF16_S
    return {"max_abs_err": err, "ms": statistics.median(ms),
            "kernel_route": "wgmma", "simt_ms": simt_ms, "timing": timing,
            "graph_ms": graph_by_route, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_b, t_f) * 1e3,
            "bound_by": "bytes" if t_b >= t_f else "operations",
            "causal": causal, "shape": [list(q.shape), list(k.shape)]}


def attn_bwd_line(row: dict) -> str:
    from repro_torch.kernels.flash_attention import ops as fops
    import torch
    return (f"flash_attention backward {row['call']} {row['shape']} causal="
            f"{row['causal']} (dq + dkdv), {row['timing']}: wgmma "
            f"{row['ms']:.5f} ms, simt (the previous design) "
            f"{row['simt_ms']:.5f} ms, library {row['library_ms']:.5f} ms "
            f"(autograd of SDPA); by CUDA graph wgmma "
            f"{row['graph_ms']['wgmma']:.5f} ms, simt "
            f"{row['graph_ms']['simt']:.5f} ms; plain {row['plain_ms']:.4f} "
            f"ms, bound {row['bound_ms']:.6f} ms ({row['bound_by']}); wgmma "
            f"within {fops.BWD_TOLERANCE[torch.bfloat16]} of mha_ref_bwd "
            f"(max abs err {row['max_abs_err']:.3g})")


def train_kernels(dev, full: dict) -> list:
    """The backward kernels at the training shapes, held against their
    plain versions and timed in turns: the attention backward (``dq`` +
    ``dkdv``), its ``wgmma`` route, its ``simt`` route (the previous
    design) and ``torch.autograd.grad`` of
    ``scaled_dot_product_attention``, all three the same way; each
    expert-GEMM gradient product (``dA``, ``dB``, up and down) against
    ``torch.bmm``; with the bound."""
    import torch
    from repro_torch.kernels.wavefront_matmul import ops as mops, ref as mref
    cfg = full["cfg"]
    g = torch.Generator(device=dev).manual_seed(13)
    bf = torch.bfloat16
    b, s = TRAIN["batch"], TRAIN["seq"] - 1
    h, kv, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.num_experts
    rn = lambda *shape, scale=1.0: (torch.randn(shape, generator=g,
                                                device=dev) * scale).to(bf)
    rows = []
    # attention backward at the training call
    q, k, v, do = rn(b, h, s, hd), rn(b, kv, s, hd), rn(b, kv, s, hd), \
        rn(b, h, s, hd)
    lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    timed = attn_bwd_row(q, k, v, do, lens, True)
    row = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:87",
           "gradient_of": "flash_attention (the TPU kernel has no backward; "
                          "XLA differentiated src/repro/models/"
                          "attention.py:38)",
           "launches": sum(sum(r.values()) for r in
                           full["bwd"]["flash_attention"].values()),
           "routes": full["bwd"]["flash_attention"], **timed,
           "library": "torch.autograd.grad of scaled_dot_product_attention",
           "phase": "train", "call": f"{cfg.name} attention"}
    rows.append(row)
    log(f"[train-timing] {attn_bwd_line(row)}")
    # the expert GEMMs' gradient products, as matmul_bwd launches them
    cap = max(1, int(round(b * s * cfg.top_k / e)))
    mp = -(-cap // mops.PAD_K) * mops.PAD_K
    cases = []
    for call, kk, nn in (("up", d, f), ("down", f, d)):
        a, w = rn(e, cap, kk), rn(e, kk, nn, scale=kk ** -0.5)
        dc = rn(e, cap, nn)
        act = torch.ones((e, -(-cap // 128)), dtype=torch.int32, device=dev)
        at = a.new_zeros((e, kk, mp))
        at[..., :cap] = a.transpose(-1, -2)
        dcm = a.new_zeros((e, mp, nn))
        dcm[:, :cap] = dc
        every = torch.ones((e, -(-kk // 128)), dtype=torch.int32, device=dev)
        bt = w.transpose(-1, -2).contiguous()
        eda, edb = mref.wavefront_matmul_ref_bwd(a, w, act, dc)
        # the bound counts the function's work: dB contracts the cap
        # rows, not the zero rows that pad them
        cases.append((call, "da", (dc, bt, act), eda,
                      lambda a=a, w=w, act=act, dc=dc:
                      mref.wavefront_matmul_ref_bwd(a, w, act, dc),
                      (dc, bt, act)))
        cases.append((call, "db", (at, dcm, every), edb, None,
                      (a.transpose(-1, -2), dc, every)))
    prod_rows = []
    for call, prod, args, exp, plain, work in cases:
        got = mops.wavefront_matmul(*args)
        torch.cuda.synchronize()
        tol = mops.TOLERANCE[bf]
        if prod == "db":
            tol = (tol[0] * cap ** 0.5, tol[1])
        err = within(got, exp, tol)
        kern = lambda args=args: mops.wavefront_matmul(*args)
        lib = lambda args=args: torch.bmm(args[0], args[1])
        ms = [graph_ms(kern)]
        library_ms = graph_ms(lib)
        plain_ms = (time_ms(plain, reps=3, rounds=3) if plain is not None
                    else None)
        ms.append(graph_ms(kern))
        nbytes, flops = lm_work("wavefront_matmul", work)
        t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_BF16_S
        r = {"call": call, "product": prod,
             "route": mops.route(args[0], args[1]),
             "shape": [list(x.shape) for x in args[:2]],
             "max_abs_err": err, "ms": statistics.median(ms),
             "library_ms": library_ms, "plain_ms": plain_ms,
             "bound_ms": max(t_b, t_f) * 1e3,
             "bound_by": "bytes" if t_b >= t_f else "operations"}
        prod_rows.append(r)
        log(f"[train-timing] wavefront_matmul {call} {prod} {r['shape']}: "
            f"{r['route']} {r['ms']:.5f} ms, torch.bmm {library_ms:.5f} ms, "
            + (f"plain (both products) {plain_ms:.4f} ms, " if plain_ms
               else "")
            + f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}); max abs err "
            f"{err:.3g}")
    # the rows' launches are the main path's (``full``): the launches made
    # here to compare and time are not counted there
    first = prod_rows[0]
    rows.append({"name": "wavefront_matmul_bwd", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/wavefront_matmul.cu",
                 "replaces": "src/repro/kernels/wavefront_matmul/kernel.py:52",
                 "gradient_of": "wavefront_matmul (dA = dC B^T and dB = A^T "
                                "dC on the same kernel; XLA differentiated "
                                "the reference's expert einsums)",
                 "launches": sum(sum(v.values()) for v in
                                 full["bwd"]["wavefront_matmul"].values()),
                 "routes": full["bwd"]["wavefront_matmul"],
                 "max_abs_err": max(r["max_abs_err"] for r in prod_rows),
                 **{k: first[k] for k in ("ms", "library_ms", "bound_ms",
                                          "bound_by", "shape")},
                 "plain_ms": first["plain_ms"],
                 "phase": "train", "call": "up da", "cases": prod_rows})
    return rows


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
    zero_lm_counters()
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


def profile_decode(cfg, model, prompt, ms_step: float, steps: int = 2, *,
                   inputs=None, max_len=None):
    """Device time and the top kernels by device time over a few decode
    steps of a full-width serve (after a prefill of ``prompt`` and
    ``inputs``), by ``torch.profiler``; the busy share is given against
    the profiled wall time and against the unprofiled step time
    ``ms_step``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import api
    _, cache, lengths = api.prefill(cfg, model,
                                    {"tokens": prompt, **(inputs or {})},
                                    max_len or SERVE["max_len"])
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
    log(f"[profile] {cfg.name}, {steps} decode steps: {launches} kernels, "
        f"device busy "
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


def lm_fns() -> dict:
    """Each LM kernel's (wrapper, plain version, tolerance, previous
    design, route rule)."""
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref
    from repro_torch.kernels.wavefront_matmul import ops as mops, ref as mref
    return {"wavefront_matmul": (mops.wavefront_matmul,
                                 mref.wavefront_matmul_ref, mops.TOLERANCE,
                                 lambda *a: mops.run_route("simt", *a),
                                 lambda a, b, _: mops.route(a, b)),
            "flash_attention": (fops.flash_attention,
                                lambda *a: fref.mha_ref(*a).to(a[0].dtype),
                                fops.TOLERANCE,
                                lambda *a: fops.run_route("simt", *a),
                                lambda q, k, v, *_: fops.route(q, k, v))}


def lm_row(name: str, phase: str, call: str, args) -> dict:
    """One LM kernel call held against its plain version, then timed in
    turns: the routed kernel, the previous design (the ``simt`` kernel on
    the same inputs), the plain version and a library call, with the
    bound.  The launches made here are taken back off the counters."""
    import torch
    kern, plain, tol, prev, route = lm_fns()[name]
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
    # in turns: routed kernel, previous design, library, plain, then the
    # routed kernel and the previous design again (the median of both
    # rounds); device time by CUDA graph, the plain version eager
    lib = lm_library(name, args)
    ms, prev_ms = [graph_ms(lambda: kern(*args))], \
        [graph_ms(lambda: prev(*args), reps=10 if heavy else 40)]
    library_ms = graph_ms(lib)
    plain_ms = time_ms(lambda: plain(*args), reps=5 if heavy else 20,
                       rounds=3)
    prev_ms.append(graph_ms(lambda: prev(*args), reps=10 if heavy else 40))
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
    log(f"[lm-timing] {name} {phase} {call} {row['shape']}: {row['route']}"
        f" {row['ms']:.5f} ms (issued eagerly {row['eager_ms']:.5f} ms), "
        f"previous design (simt) {row['prev_ms']:.5f}"
        f" ms, plain {row['plain_ms']:.5f} ms, library "
        f"{row['library_ms']:.5f} ms, bound {row['bound_ms']:.6f} ms "
        f"({row['bound_by']}); within {tol[got.dtype]} of the plain "
        f"version (max abs err {err:.3g}; simt {prev_err:.3g})")
    return row


def lm_kernels_at_serve(dev, full: dict) -> list:
    """Hold each LM kernel against its plain version at the serve's
    shapes, then time there (:func:`lm_row`)."""
    cases = lm_cases(dev, full["cfg"], full["last_lengths"])
    rows = {}
    for (name, phase, call), args in cases.items():
        rows.setdefault(name, []).append(lm_row(name, phase, call, args))
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


# ---------------------------------------------------------------------------
# phase 7: the other families' serve (zamba2, xlstm, seamless-m4t, internvl2)
# ---------------------------------------------------------------------------

#: each family's full published config: 8 requests x prompt 512 (seamless
#: also 512 frames of width 1,024; internvl2 1,024 patches of width
#: 1,024 before the prompt), 32 greedy decode steps
FAMILY_SERVES = {"zamba2-1p2b": 1024, "xlstm-350m": 1024,
                 "seamless-m4t-large-v2": 1024, "internvl2-2b": 2048}


def family_attention(cfg) -> tuple:
    """``flash_attention`` launches the family's serve must make: (on
    ``wgmma`` in prefill, on ``split`` a decode step)."""
    if cfg.family == "mamba_hybrid":
        from repro_torch.models import zamba2
        sites = len(zamba2._groups(cfg))
        return sites, sites
    if cfg.family == "encdec":             # the encoder; self + cross
        return cfg.enc_layers, 2 * cfg.dec_layers
    if cfg.family == "xlstm":
        return 0, 0
    return cfg.n_layers, cfg.n_layers


def family_cases(dev, cfg, max_len: int, last_lengths) -> dict:
    """``flash_attention``'s inputs at the family's serve shapes (bf16),
    by call: the prefill's and each decode call's, the decode lengths
    those that the run's last step read."""
    import torch
    g = torch.Generator(device=dev).manual_seed(13)
    b, s = SERVE["requests"], SERVE["prompt_len"]
    h, kv, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    rn = lambda *shape: torch.randn(shape, generator=g,
                                    device=dev).to(torch.bfloat16)
    full = lambda n: torch.full((b,), n, dtype=torch.int32, device=dev)
    dec = torch.from_numpy(last_lengths + 1).to(dev, torch.int32)
    out = {}
    if cfg.family == "encdec":
        out[("prefill", "encoder (non-causal)")] = (
            rn(b, h, s, hd), rn(b, kv, s, hd), rn(b, kv, s, hd), full(s),
            False)
        out[("decode", "cross")] = (rn(b, h, 1, hd), rn(b, kv, s, hd),
                                    rn(b, kv, s, hd), full(s), False)
    else:
        p = s + (cfg.num_patches if cfg.family == "vlm" else 0)
        out[("prefill", "self")] = (rn(b, h, p, hd), rn(b, kv, p, hd),
                                    rn(b, kv, p, hd), full(p), True)
    out[("decode", "self")] = (rn(b, h, 1, hd), rn(b, kv, max_len, hd),
                               rn(b, kv, max_len, hd), dec, False)
    return out


def serve_families(dev, gpu: str) -> dict:
    """Phase 7: the four families' smoke serves against the JAX
    reference's file, then each full published config through
    ``serve.generate`` (bf16, weights drawn on the card from seed 0), its
    counters zeroed just before and read after the prefill and after the
    decode; every prefill attention on ``wgmma``, every decode attention
    on ``split``; each model freed before the next.  Then
    ``flash_attention`` held and timed at each family's shapes."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import api
    t0 = time.perf_counter()
    for arch, runs in serve.hold_against_reference(
            dev, serve.REFERENCE_FAMILIES).items():
        for name, r in runs.items():
            log(f"[families-ref] {arch} {name}: logits within "
                f"{serve.TOLERANCE[name]} of the reference (max abs err "
                f"{r['max_abs_err']:.3g}); {r['tokens_checked']} of "
                f"{r['tokens']} greedy tokens checked, all equal")
    log(f"[families-ref] {time.perf_counter() - t0:.1f}s")
    out, cases = {}, []
    b, s, steps = SERVE["requests"], SERVE["prompt_len"], SERVE["max_new"]
    for arch, max_len in FAMILY_SERVES.items():
        cfg = configs.get(arch)
        t0 = time.perf_counter()
        model = serve.build_model(cfg, SERVE["seed"], dev)
        n_params = sum(p.numel() for p in model.parameters())
        prompt, inputs = serve.make_inputs(cfg, SERVE["seed"], b, s, dev)
        # warm-up (xlstm's prefill is a decode step a token: 16 of them)
        warm = prompt[:, :16] if cfg.family == "xlstm" else prompt
        serve.generate(cfg, model, warm, 2, max_len, inputs=inputs)
        torch.cuda.synchronize()
        log(f"[families] {cfg.name}: {n_params / 1e9:.3f} B parameters at "
            f"{cfg.dtype}, built and warmed in "
            f"{time.perf_counter() - t0:.1f}s")
        zero_lm_counters()
        torch.cuda.reset_peak_memory_stats(dev)
        after_prefill = []
        real = api.prefill

        def prefill(*a, **k):
            res = real(*a, **k)
            after_prefill.append(route_counts())
            return res
        api.prefill = prefill
        try:
            r = serve.generate(cfg, model, prompt, steps, max_len,
                               inputs=inputs)
        finally:
            api.prefill = real
        total = route_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        pre = after_prefill[0]["flash_attention"]
        dec = {k: v - pre[k] for k, v in total["flash_attention"].items()}
        if total["wavefront_matmul"] != dict.fromkeys(
                total["wavefront_matmul"], 0):
            raise AssertionError(f"{arch}: wavefront_matmul launched "
                                 f"{total['wavefront_matmul']}")
        n_pre, n_dec = family_attention(cfg)
        want_pre = {"wgmma": n_pre, "split": 0, "simt": 0}
        want_dec = {"wgmma": 0, "split": n_dec * steps, "simt": 0}
        if pre != want_pre or dec != want_dec:
            raise AssertionError(f"{arch}: flash_attention launches by route"
                                 f" prefill {pre}, decode {dec}; expected "
                                 f"{want_pre}, {want_dec}")
        if r["tokens"].shape != (b, steps + 1) or r["vocab"] != cfg.vocab:
            raise AssertionError(f"{arch}: serve output has shape "
                                 f"{r['tokens'].shape}")
        if not r["finite"]:
            raise AssertionError(f"{arch}: serve logits are not all finite")
        ms_step = 1e3 * r["decode_s"] / steps
        tps = r["useful"] / r["decode_s"]
        out[cfg.name] = {"prefill_s": r["prefill_s"], "ms_step": ms_step,
                         "tokens_s": tps, "peak_bytes": peak,
                         "prefill_routes": pre, "decode_routes": dec,
                         "launches": sum(total["flash_attention"].values()),
                         "params": n_params}
        log(f"[families] {cfg.name} prefill {b} x {s}"
            + (f" (+ {s} frames)" if cfg.family == "encdec" else "")
            + (f" (+ {cfg.num_patches} patches)" if cfg.family == "vlm"
               else "")
            + f": {r['prefill_s']:.4f}s; decode {steps} steps: "
            f"{ms_step:.3f} ms/step, {r['useful']} useful tokens, "
            f"{tps:.1f} useful tokens/s; peak memory {peak / 2**30:.2f} GiB;"
            f" logits finite; flash_attention prefill {pre}, decode {dec} "
            f"({gpu})")
        # xlstm's prefill is the decode step a token: its state after 16
        # tokens costs a decode step what it costs after 512
        profile_decode(cfg, model, warm, ms_step, inputs=inputs,
                       max_len=max_len)
        if n_pre:
            cases += [(cfg.name, phase, call, args) for (phase, call), args
                      in family_cases(dev, cfg, max_len,
                                      r["last_lengths"]).items()]
        del model, r, prompt, inputs, warm
        gc.collect()
        torch.cuda.empty_cache()
    rows = [dict(lm_row("flash_attention", phase, f"{name} {call}", args),
                 model=name) for name, phase, call, args in cases]
    return {"serves": out, "rows": rows}


# ---------------------------------------------------------------------------
# phase 8: the other families' training (zamba2, xlstm, seamless-m4t,
# internvl2)
# ---------------------------------------------------------------------------

#: each family at its published widths and depth: bf16 compute, f32
#: master parameters and AdamW state, remat, 8 x 512 tokens (seamless
#: also 512 frames, internvl2 1,024 patches), 4 steps from seed 0
FAMILY_TRAIN = dict(archs=("zamba2-1p2b", "xlstm-350m",
                           "seamless-m4t-large-v2", "internvl2-2b"),
                    batch=8, seq=512, steps=4, seed=0)


def train_families_reference(dev, gpu: str) -> dict:
    """The four smoke trainers, float32 and bfloat16, on the card against
    the JAX reference's runs in ``training/reference_train.json``
    (``train.held``), each run's attention launches by route read around
    it: bfloat16 forward on ``wgmma`` and backward on ``dq`` + ``dkdv`` of
    the ``wgmma`` route, float32 on ``simt``; xlstm none."""
    from repro_torch.launch import train
    t0 = time.perf_counter()
    out = {}
    for arch in FAMILY_TRAIN["archs"]:
        for dt in ("float32", "bfloat16"):
            f0, b0 = route_counts()["flash_attention"], \
                bwd_counts()["flash_attention"]
            res = train.hold_against_reference(dev, archs={arch},
                                               dtypes={dt})
            fwd = {r: n - f0[r] for r, n in
                   route_counts()["flash_attention"].items()}
            bwd = {k: {r: n - b0[k][r] for r, n in v.items()} for k, v in
                   bwd_counts()["flash_attention"].items()}
            route = "wgmma" if dt == "bfloat16" else "simt"
            none = arch.startswith("xlstm")
            ok = all((n > 0) == (r == route and not none)
                     for r, n in fwd.items()) and \
                all((n > 0) == (r == route and not none)
                    for v in bwd.values() for r, n in v.items())
            if not ok:
                raise AssertionError(f"{arch} {dt} smoke trainer: attention "
                                     f"launches forward {fwd}, backward "
                                     f"{bwd}; expected all on {route}"
                                     + (" (none: no attention)" if none
                                        else ""))
            name = f"{arch} {dt}"
            out[name] = dict(res[name], forward=fwd, backward=bwd)
            run = next(r for r in json.loads(train.REFERENCE.read_text())
                       ["runs"] if r["arch"] == arch and r["dtype"] == dt)
            fmt = lambda v: f"{v:.3g}" if isinstance(v, float) else \
                "[" + ", ".join(f"{x:.3g}" for x in v) + "]"
            log(f"[families-train-ref] {name}: every step's loss, grad_norm "
                f"and lr held against the reference's (train.held: within "
                f"{train.TOLERANCE[dt]} relative"
                + (f", from step 1 within {run['rtol']}" if "rtol" in run
                   else "")
                + (f"; grad_norm on the trajectory at step 0 only, and at "
                   f"every step on the reference's own weights "
                   f"({run['weights']})" if "weights" in run else "")
                + (f"; {run['why']}" if "why" in run else "")
                + "); largest relative errors "
                + ", ".join(f"{k} {fmt(v)}" for k, v in res[name].items()
                            if k not in ("gap", "on_weights", "trajectory"))
                + ("; on the reference's own weights "
                   + ", ".join(f"{k} {fmt(v)}" for k, v in
                               res[name]["on_weights"].items())
                   + "; the trajectory's grad_norm, not held from step 1: "
                   + fmt(res[name]["trajectory"])
                   if "on_weights" in res[name] else "")
                + ("; the reference's own bfloat16-float32 gap by step "
                   + ", ".join(f"{k} {fmt(v)}" for k, v in
                               res[name]["gap"].items())
                   if "gap" in res[name] else "")
                + f"; attention launches forward {fwd}, backward {bwd} "
                f"({gpu})")
    log(f"[families-train-ref] {time.perf_counter() - t0:.1f}s")
    return out


def family_train_launches(cfg, steps: int) -> tuple:
    """(forward, backward) ``flash_attention`` launches a family's
    training run must make: each attention forward once, and again in the
    backward where ``remat`` rebuilds its layer (zamba2's shared block is
    outside its checkpoints), and one ``dq`` + ``dkdv`` each."""
    if cfg.family == "xlstm":
        return 0, 0
    if cfg.family == "mamba_hybrid":
        from repro_torch.models import zamba2
        sites = len(zamba2._groups(cfg))
        return sites * steps, sites * steps
    n = cfg.enc_layers + 2 * cfg.dec_layers if cfg.family == "encdec" \
        else cfg.n_layers
    return (2 if cfg.remat else 1) * n * steps, n * steps


def family_train_flops(cfg, model, batch: int, seq: int) -> tuple:
    """(FLOPs of one training step, the formula): 6 x each weight x the
    rows it multiplies (forward 2, backward 4; remat's recompute, the
    embedding lookup and attention's and the scans' sequence-quadratic
    terms not counted).  Rows: the decoder's tokens ``batch x (seq - 1)``;
    seamless's encoder and its cross K/V projections the ``batch x seq``
    frames; internvl2's connector ``batch x patches``, its blocks ``batch
    x (patches + seq - 1)``; zamba2's shared block once a site."""
    p = model.params()
    tok = batch * (seq - 1)
    head = _numel(p["unembed"]) + _numel(p.get("ln_f", p.get("ln_dec")))
    if cfg.family == "mamba_hybrid":
        from repro_torch.models import zamba2
        sites = len(zamba2._groups(cfg))
        parts = [("mamba", _numel(p["mamba"]), tok),
                 (f"shared block ({sites} sites)",
                  sites * _numel(p["shared_attn"]), tok)]
    elif cfg.family == "xlstm":
        parts = [("blocks", _numel(p["blocks"]), tok)]
    elif cfg.family == "encdec":
        cross_kv = sum(_numel(lp["cross_attn"][w]) for lp in p["dec"]
                       for w in ("wk", "wv"))
        frames = batch * seq
        parts = [("encoder", _numel(p["enc"]) + _numel(p["ln_enc"]),
                  frames), ("cross K/V", cross_kv, frames),
                 ("decoder", _numel(p["dec"]) - cross_kv, tok)]
    elif cfg.family == "vlm":
        pre = batch * cfg.num_patches
        parts = [("connector", _numel(p["connector"]), pre),
                 ("blocks", _numel(p["blocks"]), pre + tok)]
    else:
        parts = [("blocks", _numel(p["blocks"]), tok)]
    parts.append(("head", head, tok))
    flops = sum(6 * w * r for _, w, r in parts)
    return flops, " + ".join(f"6 x {w} {name} weights x {r} rows"
                             for name, w, r in parts)


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def train_family_full(dev, gpu: str, arch: str) -> dict:
    """Phase 8's main path for one family: ``launch.train.main`` at its
    published widths and depth, its kernel counters zeroed just before
    and read just after; then one more step profiled."""
    import torch
    from repro_torch.launch import train
    t = FAMILY_TRAIN
    argv = ["--arch", arch, "--batch", str(t["batch"]), "--seq",
            str(t["seq"]), "--steps", str(t["steps"]), "--seed",
            str(t["seed"]), "--log-every", "1", "--device", str(dev)]
    torch.cuda.reset_peak_memory_stats(dev)
    zero_lm_counters()
    rec = {}
    t0 = time.perf_counter()
    losses = train.main(argv, record=rec)
    wall = time.perf_counter() - t0
    routes, bwd = route_counts(), bwd_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    cfg, steps = rec["cfg"], rec["steps"]
    model, opt_state, step_fn, ds = rec.pop("state")
    if len(losses) != t["steps"] or not np.isfinite(losses).all() or \
            not all(r["finite"] and np.isfinite(r["grad_norm"])
                    for r in steps):
        raise AssertionError(f"{arch} training: steps {steps}")
    n_fwd, n_bwd = family_train_launches(cfg, t["steps"])
    want = {"flash_attention": {"wgmma": n_fwd, "split": 0, "simt": 0},
            "wavefront_matmul": {"wgmma": 0, "small_m": 0, "simt": 0}}
    want_bwd = {"flash_attention": {k: {"wgmma": n_bwd, "simt": 0}
                                    for k in ("dq", "dkdv")},
                "wavefront_matmul": {p: {"wgmma": 0, "small_m": 0,
                                         "simt": 0} for p in ("da", "db")}}
    if routes != want or bwd != want_bwd:
        raise AssertionError(f"{arch} training launches by route {routes}, "
                             f"backward {bwd}; expected {want}, {want_bwd}")
    step_s = statistics.median(r["seconds"] for r in steps[1:])
    tokens = rec["tokens_per_step"]
    flops, formula = family_train_flops(cfg, model, t["batch"], t["seq"])
    mfu = flops / step_s / PEAK_BF16_S
    n_params = sum(p.numel() for p in model.parameters())
    extra = {"encdec": f" + {t['seq']} frames", "vlm":
             f" + {cfg.num_patches} patches"}.get(cfg.family, "")
    for r in steps:
        log(f"[families-train] {cfg.name} step {r['step']}: loss "
            f"{r['loss']:.4f} grad_norm {r['grad_norm']:.4f} lr "
            f"{r['lr']:.3e} {r['seconds']:.3f}s ({gpu})")
    log(f"[families-train] {cfg.name} ({n_params / 1e9:.3f} B parameters) "
        f"full width and depth, bf16 compute, f32 master and AdamW state, "
        f"remat {cfg.remat}, {t['batch']} x {t['seq']} tokens{extra}, "
        f"{t['steps']} steps in {wall:.1f}s (init included): losses and "
        f"gradient norms finite, no step skipped; seconds a step (median "
        f"of steps 2-{t['steps']}) {step_s:.4f}; {tokens / step_s:.1f} "
        f"tokens/s ({tokens} tokens a step); peak memory "
        f"{peak / 2**30:.2f} GiB (max_memory_allocated) ({gpu})")
    log(f"[families-train] {cfg.name} train_mfu {100 * mfu:.3f} % = "
        f"{flops} FLOPs / {step_s:.4f} s / 989e12 FLOP/s; FLOPs = "
        f"{formula} ({gpu})")
    log(f"[families-train] {cfg.name} launches by route: forward {routes}; "
        f"backward {bwd}")
    shares = profile_train_step(model, opt_state, step_fn, ds, dev, gpu,
                                step=t["steps"],
                                tag=f"[families-profile] {cfg.name}")
    del model, opt_state, step_fn, ds, rec
    return {"cfg": cfg, "routes": routes, "bwd": bwd, "step_s": step_s,
            "tokens_s": tokens / step_s, "mfu": mfu, "flops": flops,
            "peak": peak, "shares": shares, "losses": losses,
            "params": n_params}


def family_bwd_cases(dev) -> list:
    """The attention backward's inputs (bf16) at the new training shapes:
    zamba2's shared block, seamless's encoder (non-causal), decoder
    self-attention and cross-attention (511 rows over 512 frames),
    internvl2's 1,024 patches + 511 tokens at head_dim 128, G = 2."""
    import torch
    from repro_torch import configs
    g = torch.Generator(device=dev).manual_seed(17)
    b, s = FAMILY_TRAIN["batch"], FAMILY_TRAIN["seq"]
    out = []
    for arch in FAMILY_TRAIN["archs"]:
        cfg = configs.get(arch)
        h, kv, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
        if cfg.family == "mamba_hybrid":
            calls = [("shared block", s - 1, s - 1, True)]
        elif cfg.family == "encdec":
            calls = [("encoder", s, s, False), ("decoder self", s - 1, s - 1,
                                               True),
                     ("cross", s - 1, s, False)]
        elif cfg.family == "vlm":
            n = cfg.num_patches + s - 1
            calls = [("blocks", n, n, True)]
        else:
            continue
        for call, sq, sk, causal in calls:
            rn = lambda *shape: torch.randn(shape, generator=g,
                                            device=dev).to(torch.bfloat16)
            out.append((f"{cfg.name} {call}", rn(b, h, sq, hd),
                        rn(b, kv, sk, hd), rn(b, kv, sk, hd),
                        rn(b, h, sq, hd),
                        torch.full((b,), sk, dtype=torch.int32, device=dev),
                        causal))
    return out


def train_families(dev, gpu: str) -> dict:
    """Phase 8: the smoke trainers against the reference's file, each
    family at full width (its own main path), then the attention backward
    held and timed at the new shapes."""
    import torch
    ref = train_families_reference(dev, gpu)
    runs = {}
    for arch in FAMILY_TRAIN["archs"]:
        runs[arch] = train_family_full(dev, gpu, arch)
        gc.collect()
        torch.cuda.empty_cache()
    rows = []
    for call, q, k, v, do, lens, causal in family_bwd_cases(dev):
        row = dict(attn_bwd_row(q, k, v, do, lens, causal), call=call,
                   phase="train")
        log(f"[families-timing] {attn_bwd_line(row)} ({gpu})")
        rows.append(row)
        del q, k, v, do
        torch.cuda.empty_cache()
    return {"ref": ref, "runs": runs, "rows": rows}


# ---------------------------------------------------------------------------
# phase 9: the mesh on the card (sharding/, launch/mesh, specs, dryrun)
# ---------------------------------------------------------------------------

#: the slack a placed leaf may take beyond its bytes: the caching
#: allocator's rounding of a block
ALLOC_ROUND = 512
#: the elastic round trip's model: its float32 parameters and AdamW state
#: (granite's would be about 40 GB of files)
ELASTIC_ARCH = "xlstm-350m"
#: the dry run's cells, each in a process of its own on both meshes
DRYRUN_CELLS = (("granite-moe-3b-a800m", "train_4k"),
                ("granite-moe-3b-a800m", "decode_32k"))
#: the examples run on the card at their default sizes
EXAMPLES = ("egpu_benchmarks_torch", "fleet_throughput_torch")


def _env(**kw) -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), **kw)


def start_dryruns(out: pathlib.Path) -> list:
    """``python -m repro_torch.launch.dryrun`` for each of
    :data:`DRYRUN_CELLS` with ``--both-meshes``, each in its own process
    (its placeholder group is process-wide; no CUDA device is visible to
    it), started now and read by :func:`finish_dryruns`."""
    procs = []
    for arch, shape in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--both-meshes", "--out", str(out)]
        procs.append((arch, shape, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=ROOT, env=_env(CUDA_VISIBLE_DEVICES=""))))
    return procs


def finish_dryruns(procs: list, out: pathlib.Path, gpu: str) -> dict:
    """Each dry run's exit (0, or the phase fails) and its records."""
    recs = {}
    for arch, shape, p in procs:
        text, _ = p.communicate(timeout=600)
        if p.returncode != 0:
            raise AssertionError(f"dryrun {arch} {shape} exited "
                                 f"{p.returncode}: {text[-3000:]}")
        for mesh in ("16x16", "2x16x16"):
            rec = json.loads((out / f"{arch}__{shape}__{mesh}.json")
                             .read_text())
            mem, cost = rec["memory"], rec["cost"]
            log(f"[mesh-dryrun] {arch} {shape} on {mesh} ({rec['chips']} "
                f"placeholder ranks, the CPU of the card's host): "
                f"argument_bytes {mem['argument_bytes']:,} a device, "
                f"output_bytes {mem['output_bytes']:,}, flops "
                f"{cost['flops']:.6e} (the whole step), traced in "
                f"{rec['lower_s']} s; collectives "
                f"{rec['collectives']} ({gpu})")
            recs[(shape, mesh)] = rec
    return recs


def _alloc(dev) -> tuple:
    """(bytes requested of the caching allocator, bytes it allocated: each
    request rounded up to a block), now."""
    import torch
    torch.cuda.synchronize(dev)
    return (torch.cuda.memory_stats(dev)["requested_bytes.all.current"],
            torch.cuda.memory_allocated(dev))


def _held_bytes(label: str, dev, before: tuple, want: int, leaves: int,
                gpu: str) -> None:
    """The bytes a placement took since ``before`` (:func:`_alloc`)
    against the dry run's, within 512 bytes a leaf."""
    req, alloc = (a - b for a, b in zip(_alloc(dev), before))
    if not 0 <= req - want <= ALLOC_ROUND * leaves:
        raise AssertionError(f"{label}: placement requested {req} bytes, "
                             f"the dry run counts {want} ({leaves} leaves)")
    log(f"[mesh] {label}: the placement requested {req:,} bytes of the "
        f"caching allocator; the dry run's bytes {want:,}; {req - want} "
        f"over, at most {ALLOC_ROUND} a leaf x {leaves} leaves; "
        f"memory_allocated grew {alloc:,} ({alloc - want:,} over: blocks "
        f"rounded to 512 bytes, and cached blocks taken whole) ({gpu})")


def _place(pairs) -> list:
    """Each (tensor, NamedSharding) placed as a ``DTensor`` over the tensor
    itself (on a one-rank mesh the shard is the whole tensor: no copy)."""
    from repro_torch.sharding import partition
    out = []
    for t, sh in pairs:
        d = partition.place(t, sh)
        if d.to_local().data_ptr() != t.data_ptr():
            raise AssertionError("a one-rank placement copied its tensor")
        out.append(d)
    return out


def mesh_train(dev, gpu: str, mesh) -> dict:
    """granite's train cell at phase 6's shape on the one-rank mesh: the
    state drawn on the card and placed by the cell's placements, its
    bytes against the dry run's, one step of the port's step on it (the
    counters zeroed just before and read just after), the dry run's
    FLOPs beside phase 6's 6 x N_active x tokens."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import dryrun, specs, train
    from repro_torch.training import data, optimizer as opt_mod
    t = TRAIN
    cell = specs.build_cell(t["arch"], "train", mesh,
                            shape=configs.ShapeSpec("phase6", t["seq"],
                                                    t["batch"], "train"))
    cfg = cell.cfg
    dry = dryrun.measure(cell)
    want = dry["memory"]["argument_bytes"]
    leaves = specs.placed_leaves(cell.args, cell.in_shardings)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[mesh] before the placement: memory_allocated "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB, "
        f"memory_reserved {torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB "
        f"(phases 1 to 8's leftovers) ({gpu})")
    before = _alloc(dev)
    model = train.build_model(cfg, t["seed"], dev)
    opt_state = opt_mod.init(dict(model.named_parameters()),
                             opt_mod.OptConfig(state_dtype=cfg.param_dtype))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             data.SyntheticLM(cfg, t["batch"], t["seq"], seed=t["seed"])
             .next_batch(0).items()}
    args = (model, opt_state, batch, None)
    placed = _place(specs.placed_leaves(args, cell.in_shardings))
    _held_bytes(f"{cfg.name} train cell ({t['batch']} x {t['seq']}: f32 "
                "parameters, AdamW m and v, count, tokens)", dev, before,
                want, len(leaves), gpu)
    zero_lm_counters()
    t0 = time.perf_counter()
    model, opt_state, _, metrics = cell.step_fn(*args)
    loss = float(metrics["loss"])
    step_s = time.perf_counter() - t0
    routes, bwd = route_counts(), bwd_counts()
    if not (np.isfinite(loss) and float(metrics["finite"]) == 1.0):
        raise AssertionError(f"the placed train step's loss is {loss}")
    # the step updated the placed state in place
    for d, (x, _) in zip(placed, specs.placed_leaves(
            (model, opt_state, batch, None), cell.in_shardings)):
        if d.to_local().data_ptr() != x.data_ptr():
            raise AssertionError("the step left the placed state")
    if int(opt_state["count"]) != 1:
        raise AssertionError("the placed step count is not 1")
    blocks = cfg.n_layers
    want_routes = {"flash_attention": {"wgmma": 2 * blocks, "split": 0,
                                       "simt": 0},
                   "wavefront_matmul": {"wgmma": 6 * blocks, "small_m": 0,
                                        "simt": 0}}
    want_bwd = {"flash_attention": {k: {"wgmma": blocks, "simt": 0}
                                    for k in ("dq", "dkdv")},
                "wavefront_matmul": {p: {"wgmma": 3 * blocks, "small_m": 0,
                                         "simt": 0} for p in ("da", "db")}}
    if routes != want_routes or bwd != want_bwd:
        raise AssertionError(f"placed step launches by route {routes}, "
                             f"backward {bwd}; expected {want_routes}, "
                             f"{want_bwd}")
    tokens = t["batch"] * (t["seq"] - 1)
    n_active, _ = active_params(cfg)
    six = 6 * n_active * tokens
    flops = dry["cost"]["flops"]
    if flops < six:
        raise AssertionError(f"the dry run counts {flops} FLOPs, below 6 x "
                             f"N_active x tokens = {six}")
    log(f"[mesh] {cfg.name} train step on the placed state: loss "
        f"{loss:.4f}, finite, {step_s:.3f} s (the first step: remat, "
        f"allocator warm-up); launches forward {routes}, backward {bwd} "
        f"({gpu})")
    log(f"[mesh] FLOPs a step: dry run (FlopCounterMode on meta, the plain "
        f"versions' products: dense attention, every expert slot) "
        f"{flops:.6e}; phase 6's 6 x N_active x tokens = 6 x {n_active} x "
        f"{tokens} = {six:.6e}; ratio {flops / six:.4f}; traced in "
        f"{dry['lower_s']:.2f} s")
    del model, opt_state, batch, args, placed, metrics
    return {"routes": routes, "bwd": bwd, "argument_bytes": want,
            "flops": flops, "six": six, "loss": loss}


def mesh_decode_cache(dev, gpu: str, mesh) -> int:
    """granite's decode cache at phase 5's size placed by ``cache_specs``,
    its bytes against the dry run's cache argument."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import specs
    from repro_torch.models import api
    s = SERVE
    cell = specs.build_cell(s["arch"], "decode", mesh,
                            shape=configs.ShapeSpec("phase5", s["max_len"],
                                                    s["requests"], "decode"))
    want = specs.argument_bytes(cell, 1)
    gc.collect()
    torch.cuda.empty_cache()
    before = _alloc(dev)
    cache = api.init_cache(cell.cfg, s["requests"], s["max_len"], device=dev)
    pairs = specs.placed_leaves((cache,), (cell.in_shardings[1],))
    placed = _place(pairs)
    _held_bytes(f"{cell.cfg.name} decode cache ({s['requests']} requests x "
                f"max_len {s['max_len']}, bf16 K and V)", dev, before, want,
                len(pairs), gpu)
    del cache, placed
    return want


def mesh_elastic(dev, gpu: str, mesh, tmp: pathlib.Path) -> dict:
    """xlstm-350m's parameters and AdamW state saved from the card's mesh
    and restored with ``shardings`` onto it, every leaf bit for bit."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.models import api
    from repro_torch.models.transformer import tree_map
    from repro_torch.sharding import partition
    from repro_torch.training import checkpoint, optimizer as opt_mod
    cfg = configs.get(ELASTIC_ARCH)
    model = train.build_model(cfg, 0, dev)
    params = dict(model.named_parameters())
    opt_state = opt_mod.init(params, opt_mod.OptConfig(
        state_dtype=cfg.param_dtype))
    for m in opt_state["m"].values():     # moments not all zero
        m.normal_()
    rules = partition.make_rules(cfg, mesh)
    specs = api.param_specs(cfg)
    tree = {"params": model.params(), "opt": opt_state}
    shardings = {"params": partition.tree_shardings(specs, rules, mesh),
                 "opt": partition.tree_shardings(
                     opt_mod.state_specs(specs), rules, mesh)}
    placed = tree_map(partition.place, tree, shardings)
    nbytes = sum(x.numel() * x.element_size()
                 for x in partition.leaves(tree))
    path = tmp / "elastic"
    t0 = time.perf_counter()
    checkpoint.save(str(path), 3, placed)
    save_s = time.perf_counter() - t0
    files = sum(f.stat().st_size for f in path.rglob("*.npy"))
    like = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), tree)
    t0 = time.perf_counter()
    restored, step, _ = checkpoint.restore(str(path), like,
                                           shardings=shardings)
    torch.cuda.synchronize(dev)
    restore_s = time.perf_counter() - t0
    got, exp = partition.leaves(restored), partition.leaves(placed)
    if step != 3 or len(got) != len(exp):
        raise AssertionError("the elastic restore lost leaves or its step")
    for g, e in zip(got, exp):
        g, e = g.to_local(), e.to_local()
        if g.dtype != e.dtype or g.device != e.device or not bits_equal(
                g.contiguous(), e.contiguous()):
            raise AssertionError("an elastic leaf differs after restore")
    log(f"[mesh] elastic round trip: {cfg.name} parameters and AdamW state "
        f"({len(got)} leaves, {nbytes:,} bytes on the card, {files:,} bytes "
        f"of .npy) saved from the (1, 1) mesh in {save_s:.2f} s, restored "
        f"with shardings onto it in {restore_s:.2f} s; every leaf bit for "
        f"bit ({gpu})")
    return {"bytes": nbytes, "files": files, "save_s": save_s,
            "restore_s": restore_s}


def run_examples(gpu: str) -> dict:
    """Each new example on the card at its default size, in a process of
    its own; each must exit 0."""
    out = {}
    for name in EXAMPLES:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, str(ROOT / "examples" /
                                                f"{name}.py")],
                           capture_output=True, text=True, timeout=600,
                           cwd=ROOT, env=_env())
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"{name} exited {r.returncode}: "
                                 f"{r.stdout[-2000:]}{r.stderr[-3000:]}")
        for line in r.stdout.strip().splitlines():
            log(f"[mesh-examples] {name}: {line}")
        log(f"[mesh-examples] {name} exited 0 in {wall:.1f} s ({gpu})")
        out[name] = wall
    return out


def mesh_phase(dev, gpu: str) -> dict:
    """Phase 9: the one-card mesh, granite's train cell placed and
    stepped, its decode cache placed, xlstm's elastic round trip, the
    dry run (started first, in other processes, on the host's CPU) and
    the two new examples."""
    import shutil
    import tempfile
    import torch
    from repro_torch.launch import mesh as mesh_mod
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    procs = []
    try:
        procs = start_dryruns(tmp / "dryrun")
        mesh = mesh_mod.make_debug_mesh()
        if mesh.shape != (1, 1) or mesh.mesh_dim_names != ("data", "model") \
                or mesh.device_type != "cuda":
            raise AssertionError(f"make_debug_mesh() gave {mesh}")
        try:
            mesh_mod.make_debug_mesh(data=2)
            raise AssertionError("make_debug_mesh(data=2) on one card")
        except ValueError as e:
            if "torchrun --nproc-per-node 2" not in str(e):
                raise
            log(f"[mesh] make_debug_mesh(): {mesh}; make_debug_mesh(data=2) "
                f"refused: {e}")
        trained = mesh_train(dev, gpu, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        cache_bytes = mesh_decode_cache(dev, gpu, mesh)
        elastic = mesh_elastic(dev, gpu, mesh, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        examples = run_examples(gpu)
        recs = finish_dryruns(procs, tmp / "dryrun", gpu)
        procs = []
    finally:
        for _, _, p in procs:
            p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return {**trained, "cache_bytes": cache_bytes, "elastic": elastic,
            "examples": examples, "dryrun": recs}


def add_path(row: dict, path: str, routes: dict) -> None:
    """One more path's launches (by route, or by kernel and route) into a
    kernels-line row: under ``paths``, in ``launches`` and ``routes``."""
    n = sum(sum(v.values()) if isinstance(v, dict) else v
            for v in routes.values())
    row["paths"][path] = n
    row["launches"] += n
    for k, v in routes.items():
        if isinstance(v, dict):
            for r, m in v.items():
                row["routes"][k][r] += m
        else:
            row["routes"][k] += v


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
        # the attention backward's wgmma kernels are sized not to spill
        if fn.startswith("fa_bwd_") and "wgmma" in fn and spill and \
                re.search(r"[1-9]\d* bytes spill", spill):
            raise AssertionError(f"{fn} spills: {spill}")

    worst = check_kernels(dev)
    check_step_kernels(dev)
    res = run_suite(dev)
    tiers = run_tiers(dev, res)
    fleet = run_fleet(dev, tiers)
    serving = run_serving(dev, fleet)
    profile_steps(dev)
    # the main path's launches: the interpreter and fleet_run phase's, the
    # compiled tiers', the scheduler's drains' and the optimized runs'
    # (each counted from 0 just before its own runs)
    paths = {"run_program+fleet_run": (res["launches"], res["routes"]),
             "compiled_tiers": (tiers["launches"], tiers["routes"]),
             "fleet_scheduler": (fleet["launches"], fleet["routes"]),
             "optimized_tiers": (fleet["opt_launches"], fleet["opt_routes"]),
             "fleet_service": (serving["launches"], serving["routes"]),
             "sharded_fleet": (serving["sharded_launches"],
                               serving["sharded_routes"])}
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
    del full                         # the serve's model is gone before phase 6
    gc.collect()
    torch.cuda.empty_cache()

    check_lm_backward(dev)
    train_reference(dev)
    train_checkpoint(dev)
    trained = train_full(dev, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    kernels += train_kernels(dev, trained)
    granite_train = trained["routes"]["flash_attention"]
    del trained
    gc.collect()
    torch.cuda.empty_cache()

    fam = serve_families(dev, gpu)
    fam_train = train_families(dev, gpu)
    # the attention's launches by path: each serve's and each trainer's
    # (each counted from 0 around its own run)
    attn = next(k for k in kernels if k["name"] == "flash_attention")
    trains = {TRAIN["arch"]: granite_train,
              **{a: r["routes"]["flash_attention"]
                 for a, r in fam_train["runs"].items()}}
    attn["paths"] = {"serve granite-moe-3b-a800m": attn["launches"],
                     **{f"serve {n}": r["launches"]
                        for n, r in fam["serves"].items()},
                     **{f"train {a}": sum(r.values())
                        for a, r in trains.items()}}
    attn["launches"] = sum(attn["paths"].values())
    for r in fam["serves"].values():
        for part in ("prefill_routes", "decode_routes"):
            for route, n in r[part].items():
                attn["routes"][route] += n
    for r in trains.values():
        for route, n in r.items():
            attn["routes"][route] += n
    attn["cases"] += fam["rows"]
    attn["max_abs_err"] = max(c["max_abs_err"] for c in attn["cases"])
    bwd = next(k for k in kernels if k["name"] == "flash_attention_bwd")
    bwd["paths"] = {f"train {TRAIN['arch']}": bwd["launches"]}
    for a, r in fam_train["runs"].items():
        fb = r["bwd"]["flash_attention"]
        bwd["paths"][f"train {a}"] = sum(sum(v.values())
                                         for v in fb.values())
        for kern, by in fb.items():
            for route, n in by.items():
                bwd["routes"][kern][route] += n
    bwd["launches"] = sum(bwd["paths"].values())
    bwd["cases"] = fam_train["rows"]
    bwd["max_abs_err"] = max([bwd["max_abs_err"]]
                             + [c["max_abs_err"] for c in bwd["cases"]])
    del fam, fam_train
    gc.collect()
    torch.cuda.empty_cache()

    meshed = mesh_phase(dev, gpu)
    # phase 9's train step is one more path of the LM kernels (its
    # counters zeroed just before it and read just after)
    path = f"train-mesh {TRAIN['arch']}"
    rows = {k["name"]: k for k in kernels}
    mm, mm_bwd = rows["wavefront_matmul"], rows["wavefront_matmul_bwd"]
    mm["paths"] = {f"serve {SERVE['arch']}": mm["launches"]}
    mm_bwd["paths"] = {f"train {TRAIN['arch']}": mm_bwd["launches"]}
    add_path(mm, path, meshed["routes"]["wavefront_matmul"])
    add_path(mm_bwd, path, meshed["bwd"]["wavefront_matmul"])
    add_path(attn, path, meshed["routes"]["flash_attention"])
    add_path(bwd, path, meshed["bwd"]["flash_attention"])

    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
