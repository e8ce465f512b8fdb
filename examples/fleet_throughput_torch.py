"""Fleet throughput demo on the PyTorch/CUDA port: serve a queue of eGPU
jobs on batched cores.  The port's counterpart of
``examples/fleet_throughput.py``, on the card unless ``--device cpu``.

Submits a heterogeneous stream of assembled programs (different kernels,
sizes, shared-memory images, runtime thread counts) to a 32-core fleet,
drains it in batches, and compares against the one-core ``run_program``
loop.

  PYTHONPATH=src python examples/fleet_throughput_torch.py
  PYTHONPATH=src python examples/fleet_throughput_torch.py --device cpu --jobs 8
"""
import argparse
import time

import numpy as np

from repro_torch.core import EGPUConfig, machine, run_program
from repro_torch.fleet import Fleet
from repro_torch.launch.serve import resolve_device
from repro_torch.programs import (build_bitonic, build_fft, build_matmul,
                                  build_reduction, build_transpose)


def fleet_config() -> EGPUConfig:
    """A small instance: big enough for the full suite at these sizes (the
    fleet benchmark's, ``benchmarks/fleet.py``)."""
    return EGPUConfig(max_threads=32, regs_per_thread=32, shared_kb=4,
                      alu_bits=32, shift_bits=32, predicate_levels=4,
                      has_dot=True, has_invsqr=True)


def build_jobs(cfg: EGPUConfig, n_jobs: int) -> list:
    """The fleet benchmark's ``suite`` mix: all five paper kernels at small
    sizes, step counts kept comparable so lock-step cores finish
    together, rotating over ``n_jobs``."""
    base = [
        build_bitonic(cfg, 16),
        build_fft(cfg, 16),
        build_bitonic(cfg, 32),
        build_fft(cfg, 32),
        build_matmul(cfg, 8),
        build_reduction(cfg, 32),
        build_reduction(cfg, 32, use_dot=True),
        build_transpose(cfg, 16),
    ]
    return [base[i % len(base)] for i in range(n_jobs)]


def main(argv=None) -> dict:
    """Returns the timed drain's results by handle; raises if a spot-checked
    job differs from ``run_program`` or a hazard was violated."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jobs", type=int, default=96)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = fleet_config()
    jobs = build_jobs(cfg, args.jobs)
    print(f"{len(jobs)} jobs over {len({b.name for b in jobs})} distinct "
          f"programs; eGPU config: {cfg.max_threads} threads, "
          f"{cfg.shared_kb}KB shared, {cfg.memory_mode.upper()} memory "
          f"({dev})\n")

    def submit_all(fleet):
        return [fleet.submit(b.image, b.shared_init, tdx_dim=b.tdx_dim,
                             tag=b.name,
                             weight=b.image.static_cycle_estimate())
                for b in jobs]

    # the first drain compiles (and on the card captures) the batches'
    # programs; time the steady state
    warm = Fleet(cfg, batch_size=32, device=dev)
    submit_all(warm)
    t0 = time.perf_counter()
    warm.drain()
    compile_s = time.perf_counter() - t0

    fleet = Fleet(cfg, batch_size=32, device=dev)
    handles = submit_all(fleet)
    t0 = time.perf_counter()
    results = fleet.drain()
    fleet_s = time.perf_counter() - t0

    # correctness spot-check + simulated-time accounting
    sim_us = 0.0
    for b, h in zip(jobs[:8], handles[:8]):
        st = run_program(b.image, shared_init=b.shared_init,
                         tdx_dim=b.tdx_dim, device=dev)
        if not np.array_equal(machine.shared_as_u32(st),
                              results[h].shared_u32()):
            raise AssertionError(f"{b.name}: the fleet's shared memory "
                                 "differs from run_program's")
    for h in handles:
        if results[h].hazard_violations:
            raise AssertionError(f"{results[h].tag}: hazard violations")
        sim_us += results[h].time_us

    t0 = time.perf_counter()
    for b in jobs:
        run_program(b.image, shared_init=b.shared_init, tdx_dim=b.tdx_dim,
                    device=dev)
    serial_s = time.perf_counter() - t0

    s = fleet.stats
    print(f"fleet : {len(jobs)} jobs in {fleet_s * 1e3:7.1f} ms "
          f"({len(jobs) / fleet_s:7.1f} jobs/s) across {s.batches} "
          f"dispatches ({s.compiled_jobs} jobs on the block-compiled "
          f"tier, {s.pad_slots} filler slots; first-run compile "
          f"took {compile_s:.1f} s)")
    print(f"serial: {len(jobs)} jobs in {serial_s * 1e3:7.1f} ms "
          f"({len(jobs) / serial_s:7.1f} jobs/s)")
    print(f"speedup {serial_s / fleet_s:.2f}x | simulated eGPU time "
          f"{sim_us / 1e3:.2f} ms @ {cfg.fmax_mhz:.0f} MHz")

    h = handles[0]
    print(f"\nper-job result (handle {h}, {results[h].tag}): "
          f"{results[h].cycles} cycles, {results[h].steps} instructions")
    mix = {k: v for k, v in results[h].profile().items() if v[1]}
    print(f"instruction mix: {mix}")
    return results


if __name__ == "__main__":
    main()
