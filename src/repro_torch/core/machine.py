"""eGPU architectural state as a NamedTuple of tensors, plus host helpers.

The same 18 leaves as the reference's ``repro.core.machine.MachineState``
in the same order.  The register file and shared memory hold raw 32-bit
patterns in **int32** (PyTorch has no uint32 arithmetic); the reference
holds them in uint32, and :func:`state_to_numpy` gives them back in that
dtype, so the two packages' leaves compare with ``np.array_equal``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import isa
from .config import EGPUConfig


class MachineState(NamedTuple):
    """Every architectural structure of the eGPU, as tensors."""

    regs: torch.Tensor          # (T, R) int32 bit patterns
    shared: torch.Tensor        # (S,)  int32 bit patterns
    pstack: torch.Tensor        # (T, D) bool — per-thread predicate stacks
    pdepth: torch.Tensor        # (T,)  int32 — predicate nesting depth
    lctr: torch.Tensor          # (LD,) int32 — loop-counter stack
    lsp: torch.Tensor           # ()    int32
    cstack: torch.Tensor        # (CD,) int32 — subroutine return stack
    csp: torch.Tensor           # ()    int32
    pc: torch.Tensor            # ()    int32
    cycles: torch.Tensor        # ()    int32 — the benchmark metric
    steps: torch.Tensor         # ()    int32 — instructions executed
    halted: torch.Tensor        # ()    bool
    threads_active: torch.Tensor  # () int32 — runtime thread count
    tdx_dim: torch.Tensor       # ()    int32 — TDX/TDY grid x-dimension
    stat_cycles: torch.Tensor   # (NUM_OP_CLASSES,) int32 — Fig. 6 profile
    stat_instrs: torch.Tensor   # (NUM_OP_CLASSES,) int32
    hazard: torch.Tensor        # (R+2, 4) int32 — RAW checker rows
    hazard_violations: torch.Tensor  # () int32


#: leaves the reference holds as uint32 (the port holds their bits in int32)
U32_LEAVES = ("regs", "shared")


def resolve_device(device) -> torch.device:
    """The entry points' device rule: CUDA unless the caller asks for the
    CPU, and no silent fallback when there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    return dev


def sync(dev) -> None:
    """Wait for the work this thread enqueued on ``dev``: its current
    stream, never the whole card.  A device-wide synchronise is invalid
    while another thread captures a CUDA graph (the compiled tiers'
    plans), so nothing that can run beside a capture makes one."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def pack_shared_init(shared_init, shared_words: int) -> np.ndarray:
    """Coerce a shared-memory image to uint32 words (FP32 views FP bits)."""
    buf = np.asarray(shared_init)
    if buf.dtype.kind == "f":
        buf = buf.astype(np.float32).view(np.uint32)
    buf = buf.astype(np.uint32).ravel()
    if buf.size > shared_words:
        raise ValueError(
            f"shared_init ({buf.size} words) exceeds {shared_words}")
    return buf


def hazard_init(regs_per_thread: int) -> np.ndarray:
    """Initial hazard-checker rows: every slot "written long ago"."""
    hz = np.zeros((regs_per_thread + 2, 4), np.int32)
    hz[:, 0] = -(1 << 30)
    hz[:, 1] = 1
    hz[:, 2] = 1
    return hz


def init_numpy(cfg: EGPUConfig, *, threads: int | None = None,
               tdx_dim: int = 16,
               shared_init: np.ndarray | None = None) -> dict:
    """The initial leaves as numpy arrays in the reference's dtypes."""
    threads = threads or cfg.max_threads
    if threads > cfg.max_threads or threads % cfg.num_sps:
        raise ValueError(
            f"runtime threads {threads} invalid for max {cfg.max_threads}")
    T, R, S = cfg.max_threads, cfg.regs_per_thread, cfg.shared_words
    D = max(1, cfg.predicate_levels)
    shared = np.zeros((S,), np.uint32)
    if shared_init is not None:
        buf = pack_shared_init(shared_init, S)
        shared[: buf.size] = buf
    return dict(
        regs=np.zeros((T, R), np.uint32),
        shared=shared,
        pstack=np.zeros((T, D), np.bool_),
        pdepth=np.zeros((T,), np.int32),
        lctr=np.zeros((cfg.max_loop_depth,), np.int32),
        lsp=np.int32(0),
        cstack=np.zeros((cfg.max_call_depth,), np.int32),
        csp=np.int32(0),
        pc=np.int32(0),
        cycles=np.int32(0),
        steps=np.int32(0),
        halted=np.bool_(False),
        threads_active=np.int32(threads),
        tdx_dim=np.int32(tdx_dim),
        stat_cycles=np.zeros((isa.NUM_OP_CLASSES,), np.int32),
        stat_instrs=np.zeros((isa.NUM_OP_CLASSES,), np.int32),
        hazard=hazard_init(R),
        hazard_violations=np.int32(0),
    )


def init_state(cfg: EGPUConfig, *, threads: int | None = None,
               tdx_dim: int = 16, shared_init: np.ndarray | None = None,
               device="cuda") -> MachineState:
    return state_from_numpy(init_numpy(cfg, threads=threads, tdx_dim=tdx_dim,
                                       shared_init=shared_init),
                            device=device)


# --- crossing between the two packages ---------------------------------------

def state_from_numpy(leaves, device="cuda") -> MachineState:
    """Build the port's state from the reference's leaves as numpy arrays
    (a dict, or any object with the 18 leaf attributes, e.g. the
    reference's ``MachineState`` after ``np.asarray``).  uint32 leaves
    keep their bits in int32."""
    dev = resolve_device(device)
    out = {}
    for name in MachineState._fields:
        v = leaves[name] if isinstance(leaves, dict) else getattr(leaves, name)
        arr = np.array(v, copy=True, order="C")
        if arr.dtype == np.uint32:
            arr = arr.view(np.int32)
        out[name] = torch.from_numpy(arr).to(dev)
    return MachineState(**out)


def state_to_numpy(state: MachineState) -> dict:
    """The port's leaves as numpy arrays in the reference's dtypes
    (``regs``/``shared`` back to uint32)."""
    out = {}
    for name in MachineState._fields:
        arr = getattr(state, name).detach().cpu().numpy()
        if name in U32_LEAVES:
            arr = arr.view(np.uint32)
        out[name] = arr
    return out


# --- host-side views -------------------------------------------------------

def shared_as_u32(state: MachineState) -> np.ndarray:
    return state.shared.cpu().numpy().view(np.uint32)


def shared_as_f32(state: MachineState) -> np.ndarray:
    return state.shared.cpu().numpy().view(np.float32)


def shared_as_i32(state: MachineState) -> np.ndarray:
    return state.shared.cpu().numpy()


def regs_as_f32(state: MachineState) -> np.ndarray:
    return state.regs.cpu().numpy().view(np.float32)


def profile(state: MachineState) -> dict[str, tuple[int, int]]:
    """Instruction-mix profile (cycles, instructions) per class — Fig. 6."""
    sc = state.stat_cycles.cpu().tolist()
    si = state.stat_instrs.cpu().tolist()
    return {c.name: (int(sc[c]), int(si[c])) for c in isa.OpClass}
