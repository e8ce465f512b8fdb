#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. build the hand-written CUDA kernels from ``src/repro_torch/kernels/
   csrc`` with nvcc for sm_90a;
2. hold each kernel against its plain PyTorch version on CUDA tensors,
   bit for bit (bfloat16 dot at the reference tests' rtol 2e-2): the
   shapes of the reference's ``tests/test_kernels.py``, the main path's
   shapes, and tensors of special values (NaN payloads, +-inf, +-0,
   subnormals);
3. drive the main path: every paper-size suite job through
   ``run_program``, then all of them as lock-step ``fleet_run`` batches
   (one per configuration), each result held against its numpy oracle
   and every leaf against the committed digests of the JAX reference
   (``src/repro_torch/programs/reference_digests.json``); each job is
   also run on the CPU and its leaves compared with the CUDA run's.
   The kernels' launch counters are zeroed just before and read just
   after the CUDA runs, and each must be > 0;
4. time each kernel, its plain version and one PyTorch library call
   for the same function, at the main path's shapes (CUDA events,
   warm-up, median).

The last two lines of standard output are the kernels' JSON and the
device JSON ``{"ok": true, "device": {...}}``.  It imports nothing of
JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import pathlib
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
    """``(rows, cores)`` of every kernel call shape the main path makes:
    a core's register column is ``(T / 16, 16)``; ``run_program`` is one
    core and a fleet batch stacks its cores' rows."""
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

    wavefront_alu.launches = 0
    dot_product.launches = 0
    cuda_leaves, rows = {}, []
    t_main = time.perf_counter()
    for b in jobs:
        t0 = time.perf_counter()
        st = run_program(b.image, shared_init=b.shared_init,
                         tdx_dim=b.tdx_dim, device=dev)
        wall = time.perf_counter() - t0
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
    log(f"[suite] main path wall {main_wall:.3f}s, kernel launches {launches}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"{k} was never launched on the main path")

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
    return {"launches": launches, "jobs": rows,
            "steps": sum(r[1] for r in rows), "wall_s": main_wall}


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


def time_kernels(dev, worst: dict, launches: dict) -> list:
    import torch
    from repro_torch.kernels.dot_product import ops as dops, ref as dref
    from repro_torch.kernels.wavefront_alu import ops as wops, ref as wref

    rng = np.random.default_rng(7)
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    out = []
    # one eGPU core's register column: 512 threads as (32 wavefronts, 16 SPs)
    rows, _ = main_path_rows()
    lanes = 16
    a, b, init = (to(rng.standard_normal((rows, lanes)).astype(np.float32))
                  for _ in range(3))
    act = torch.ones((-(-rows // 8),), dtype=torch.int32, device=dev)
    mask = torch.ones((rows, lanes), dtype=torch.bool, device=dev)
    n = rows * lanes
    # an active tile reads a and b, an inactive one reads init; every
    # tile writes out and reads its flag
    on_elems = min(n, int(act.sum()) * 8 * lanes)
    nbytes = 4 * (2 * on_elems + (n - on_elems) + n) + 4 * act.numel()
    by_bytes = nbytes / PEAK_BYTES_S >= on_elems / PEAK_F32_S
    bound = max(nbytes / PEAK_BYTES_S, on_elems / PEAK_F32_S) * 1e3
    out.append({
        "name": "wavefront_alu", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wavefront_alu.cu",
        "replaces": "src/repro/kernels/wavefront_alu/kernel.py:50",
        "launches": launches["wavefront_alu"],
        "max_abs_err": worst["wavefront_alu"],
        "ms": time_ms(lambda: wops.wavefront_alu(a, b, init, act, "add")),
        "plain_ms": time_ms(lambda: wref.wavefront_alu_ref(a, b, init, act,
                                                           "add")),
        "bound_ms": bound,
        "bound_by": "bytes" if by_bytes else "operations",
        "library_ms": time_ms(lambda: torch.where(mask, torch.add(a, b),
                                                  init)),
        "shape": [rows, lanes], "op": "add"})

    # DOT over one core's thread space: (1, 32, 16)
    da = to(rng.standard_normal((1, rows, lanes)).astype(np.float32))
    db = to(rng.standard_normal((1, rows, lanes)).astype(np.float32))
    dact = torch.ones((1, rows // 8), dtype=torch.int32, device=dev)
    nbytes = 4 * 2 * n + 4 * dact.numel() + 4
    ops_ = 2 * n
    out.append({
        "name": "dot_product", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dot_product.cu",
        "replaces": "src/repro/kernels/dot_product/kernel.py:41",
        "launches": launches["dot_product"],
        "max_abs_err": worst["dot_product"],
        "ms": time_ms(lambda: dops.dot_product(da, db, dact)),
        "plain_ms": time_ms(lambda: dref.dot_product_ref(da, db, dact),
                            reps=20),
        "bound_ms": max(nbytes / PEAK_BYTES_S, ops_ / PEAK_F32_S) * 1e3,
        "bound_by": "bytes" if nbytes / PEAK_BYTES_S >= ops_ / PEAK_F32_S
        else "operations",
        "library_ms": time_ms(lambda: (da * db).sum()),
        "shape": [1, rows, lanes]})
    for k in out:
        log(f"[timing] {k['name']} {k['shape']}: kernel {k['ms']:.5f} ms, "
            f"plain {k['plain_ms']:.5f} ms, library {k['library_ms']:.5f} ms,"
            f" bound {k['bound_ms']:.6f} ms ({k['bound_by']})")
    return out


def main() -> int:
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
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    build.build_all()
    log(f"[build] nvcc sm_90a, both kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f}s ({build.BUILD_DIR})")

    worst = check_kernels(dev)
    res = run_suite(dev)
    kernels = time_kernels(dev, worst, res["launches"])

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
