"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process into
``build/kernels/lib<name>.so`` under the checkout, all of them started
together, at first use (never at import: the CPU tests import every
module, and this package's CPU path needs no compiler).  The libraries
have a plain C interface: pointers and the stream go in as
``c_void_p``, and each entry point returns ``cudaGetLastError()``.

Flags: ``sm_90a`` (Hopper), ``-ftz=true`` to flush subnormals as
XLA:CPU does, ``-fmad=false`` so that no multiply-add is contracted.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-ftz=true", "-fmad=false", "-shared",
              "-Xcompiler", "-fPIC")

#: kernel name -> (C entry point, its ctypes argtypes)
_SIGNATURES = {
    "wavefront_alu": ("egpu_wavefront_alu",
                      [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
                      + [ctypes.c_int, ctypes.c_void_p]),
    "dot_product": ("egpu_dot_product",
                    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
                    + [ctypes.c_int, ctypes.c_void_p]),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest(name: str) -> str:
    h = hashlib.blake2b(digest_size=8)
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _target(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all(names=tuple(_SIGNATURES)) -> dict[str, ctypes.CDLL]:
    """Compile (in parallel) and load every kernel library not loaded
    yet; returns ``{name: CDLL}``.  Raises with nvcc's output on a
    failed build."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return dict(_libs)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n in todo:
            out = _target(n)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT), tmp, out)
        errors = []
        for n, (p, tmp, out) in procs.items():
            log, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"nvcc failed for {n}.cu:\n{log.decode()}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in todo:
            lib = ctypes.CDLL(str(_target(n)))
            sym, argtypes = _SIGNATURES[n]
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[n] = lib
        return dict(_libs)


def entry(name: str):
    """The C entry point of kernel ``name``, building it if needed."""
    lib = _libs.get(name) or build_all((name,))[name]
    return getattr(lib, _SIGNATURES[name][0])


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
