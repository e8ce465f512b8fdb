"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process into
``build/kernels/lib<name>.so`` under the checkout, all of them started
together, at first use (never at import: the CPU tests import every
module, and this package's CPU path needs no compiler).  The libraries
have a plain C interface: pointers and the stream go in as
``c_void_p``, and each entry point returns ``cudaGetLastError()``.  A
library may hold several entry points: the LM kernels have one for each
route (``ops.route``).

Flags: ``sm_90a`` (Hopper) for every kernel.  The eGPU data-path
kernels, which are bit-exact, add ``-ftz=true`` to flush subnormals as
XLA:CPU does and ``-fmad=false`` so that no multiply-add is contracted;
the LM kernels, held to a tolerance, keep nvcc's defaults
(:data:`TMA_FLAGS`, empty): their TMA tensor maps are encoded by
``cuTensorMapEncodeTiled``, which ``csrc/hopper.cuh`` takes from the
driver through ``cudaGetDriverEntryPoint``, so nothing links ``-lcuda``
and the libraries load where the CUDA runtime does.  nvcc's report
(``-Xptxas -v``: registers, shared memory, spills) is kept in
:data:`LOGS`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
EXACT_FLAGS = ("-ftz=true", "-fmad=false")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F, _ULL = ctypes.c_float, ctypes.c_ulonglong
#: the eGPU step entries: regs, trace row, masks, pred, packed opcodes,
#: B, T, R, stream
_STEP = [_P] * 4 + [_ULL] + [_LL] * 3 + [_P]
#: the LM kernels' flags: none beyond NVCC_FLAGS; TMA's encoder comes from
#: cudaGetDriverEntryPoint at run time, not from linking -lcuda
TMA_FLAGS = ()
_GEMM = [_P] * 4 + [_LL] * 4
_ATTN = [_P] * 5 + [_LL] * 6
#: the attention backward: 9 pointers, B, H, KV, Sq, Sk, D, causal,
#: scale, then bf16 (``simt`` only) and the stream
_ATTN_BWD = [_P] * 9 + [_LL] * 6 + [_I, _F]
#: kernel name -> ({C entry point: its ctypes argtypes}, extra nvcc flags)
_SIGNATURES = {
    "wavefront_alu": ({"egpu_wavefront_alu": [_P] * 5 + [_LL] * 2 + [_I, _P],
                       "egpu_fp_step": _STEP},
                      EXACT_FLAGS),
    "dot_product": ({"egpu_dot_product": [_P] * 4 + [_LL] * 3 + [_I, _P],
                     "egpu_ext_step": _STEP},
                    EXACT_FLAGS),
    "wavefront_matmul": ({"lm_wavefront_matmul": _GEMM + [_I, _P],
                          "lm_wavefront_matmul_small_m": _GEMM + [_I, _P],
                          "lm_wavefront_matmul_wgmma": _GEMM + [_P],
                          "lm_wavefront_matmul_grad_wgmma":
                              [_P] * 6 + [_LL] * 4 + [_I, _P]},
                         TMA_FLAGS),
    "flash_attention": ({"lm_flash_attention":
                             [_P] * 6 + [_LL] * 6
                             + [_I, _F, _I, _I, _P, _P, _P],
                         "lm_flash_attention_wgmma": _ATTN + [_I, _F, _P]},
                        TMA_FLAGS),
    "flash_attention_bwd": ({"lm_flash_attention_bwd_dq":
                                 _ATTN_BWD + [_I, _P],
                             "lm_flash_attention_bwd_dkdv":
                                 _ATTN_BWD + [_I, _P],
                             "lm_flash_attention_bwd_dq_wgmma":
                                 _ATTN_BWD + [_P],
                             "lm_flash_attention_bwd_dkdv_wgmma":
                                 _ATTN_BWD + [_P]},
                            TMA_FLAGS),
}


#: devices whose tensors a kernel wrapper hands to its plain version: the
#: CPU computes it; ``meta`` computes nothing (shapes only, as the dry run
#: traces a step), so no kernel is hidden by it
PLAIN_DEVICES = ("cpu", "meta")


def plain(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` runs its plain version."""
    return t.device.type in PLAIN_DEVICES


def tma_legal(*ts) -> bool:
    """Whether TMA can read each tensor as it is: contiguous, its base on
    16 bytes and its rows a multiple of 16 bytes (the LM kernels' routing
    rules use it)."""
    return all(t.is_contiguous() and t.data_ptr() % 16 == 0
               and t.shape[-1] * t.element_size() % 16 == 0 for t in ts)


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: kernel name -> nvcc's output for the build made in this process
LOGS: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + _SIGNATURES[name][1]


def _digest(name: str) -> str:
    h = hashlib.blake2b(digest_size=8)
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(_flags(name)).encode())
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
            cmd = [_nvcc(), *_flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT), tmp, out)
        errors = []
        for n, (p, tmp, out) in procs.items():
            log, _ = p.communicate()
            LOGS[n] = log.decode()
            if p.returncode != 0:
                errors.append(f"nvcc failed for {n}.cu:\n{log.decode()}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in todo:
            lib = ctypes.CDLL(str(_target(n)))
            for sym, argtypes in _SIGNATURES[n][0].items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[n] = lib
        return dict(_libs)


def ensure(names) -> float:
    """Build and load the libraries of ``names`` not loaded yet; returns
    the seconds that took (0.0 when every one was loaded already), so a
    caller timing its run can report the one-time build apart."""
    if all(n in _libs for n in names):
        return 0.0
    t0 = time.perf_counter()
    build_all(tuple(names))
    return time.perf_counter() - t0


_entries: dict = {}


def entry(name: str, sym: str | None = None):
    """The C entry point ``sym`` of kernel ``name`` (default: its first),
    building the library if needed; looked up once."""
    fn = _entries.get((name, sym))
    if fn is None:
        lib = _libs.get(name) or build_all((name,))[name]
        fn = _entries[name, sym] = getattr(
            lib, sym or next(iter(_SIGNATURES[name][0])))
    return fn


def stream(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``
    (a CUDA graph's capture stream while one is captured), by one call."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
