"""The paper's benchmark programs (the port of ``repro.programs``), hand-written in eGPU assembly (§7).

Each builder returns a :class:`Bench` with the assembled image, the
shared-memory initial contents, and a NumPy oracle.  The five benchmarks
match the paper's: vector reduction, matrix transpose, matrix-matrix
multiply, bitonic sort, FFT — plus dot-product and dynamic-scaling
variants.
"""
from .common import Bench, check, run_bench
from .reduction import build_reduction
from .transpose import build_transpose
from .matmul import build_matmul
from .bitonic import build_bitonic
from .fft import build_fft

__all__ = ["Bench", "check", "run_bench", "build_reduction", "build_transpose",
           "build_matmul", "build_bitonic", "build_fft"]
