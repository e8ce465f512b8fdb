"""The paper's five benchmarks (Tables 7 and 8) and the dynamic-scaling
ablation end to end on the PyTorch/CUDA port, printing the comparison
against the paper.  The port's counterpart of
``examples/egpu_benchmarks.py``, on the card unless ``--device cpu``.

  PYTHONPATH=src python examples/egpu_benchmarks_torch.py
  PYTHONPATH=src python examples/egpu_benchmarks_torch.py --device cpu
"""
import argparse

from repro_torch.core import benchmark_config
from repro_torch.launch.serve import resolve_device
from repro_torch.programs import (build_bitonic, build_fft, build_matmul,
                                  build_reduction, build_transpose, run_bench)

PAPER = {"reduction": 202, "transpose": 5529, "matmul": 26278,
         "bitonic": 3728, "fft": 1695}


def main(argv=None) -> dict:
    """Runs each benchmark once; returns ``{name: BenchResult}``, the
    ablation's pair under ``"dynamic"`` and ``"predicated"``; raises if a
    result is off its numpy oracle or a hazard was violated."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    out = {}
    print(f"{'benchmark':<14} {'cycles':>8} {'paper':>8} {'us':>8} "
          f"{'ok':>4} {'NOPs%':>6}")
    for name, builder, n, kw in [
            ("reduction", build_reduction, 64, {}),
            ("transpose", build_transpose, 64, {}),
            ("matmul", build_matmul, 32, {}),
            ("bitonic", build_bitonic, 64, {"pred": 2}),
            ("fft", build_fft, 64, {})]:
        cfg = benchmark_config("dp", predicate_levels=kw.pop("pred", 0))
        r = out[name] = run_bench(builder(cfg, n, **kw), device=dev)
        total = sum(c for c, _ in r.profile.values())
        nops = 100 * r.profile["NOPC"][0] / max(1, total)
        print(f"{name:<14} {r.cycles:>8} {PAPER[name]:>8} {r.time_us:>8.2f} "
              f"{'yes' if r.correct else 'NO':>4} {nops:>5.1f}%")

    print("\ndynamic scalability (reduction-64): ", end="")
    dyn = out["dynamic"] = run_bench(
        build_reduction(benchmark_config("dp"), 64), device=dev)
    nod = out["predicated"] = run_bench(build_reduction(
        benchmark_config("dp", predicate_levels=4), 64, no_dynamic=True),
        device=dev)
    print(f"TSC {dyn.cycles} cycles vs predicated {nod.cycles} "
          f"-> {nod.cycles / dyn.cycles:.1f}x win ({dev})")
    bad = [k for k, r in out.items() if not r.correct or r.hazard_violations]
    if bad:
        raise AssertionError(f"results off their numpy oracles: {bad}")
    return out


if __name__ == "__main__":
    main()
