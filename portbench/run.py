#!/usr/bin/env python3
"""Run one cell of the port's benchmark once (see ``harness.py``).

    python3 portbench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Every cache a run writes stays at a fixed path inside the checkout.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"


def main() -> int:
    # the program builds its kernels into <checkout>/build/kernels; the
    # toolchains' own caches go here, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    # the script's own directory would put this package's modules at the
    # top level, where they could shadow others
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if pathlib.Path(p or ".").resolve() != HERE]
    try:
        import repro_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"portbench: the program is not here ({e}); run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    from portbench import harness
    return harness.main(t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
