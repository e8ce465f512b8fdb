"""Production and debug meshes: the port of ``repro/launch/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the process group, one rank a device.  Functions, not module
constants, so that importing this module starts no process group and
touches no device: the dry run starts its placeholder group of 512 ranks
first (``launch.dryrun.placeholder_group``), a multi-card run is
launched by ``torchrun``, and :func:`make_debug_mesh` on one card sets
up a one-rank group itself.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

#: NVIDIA H100 SXM hardware constants (per GPU, NVIDIA's data sheet, at the
#: 700 W power limit), used by the roofline analysis: bf16 dense
#: tensor-core FLOP/s, HBM3 bytes/s, and NVLink 4's bytes/s (18 links, both
#: directions together)
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 900e9


def _require_devices(shape: tuple[int, ...], axes: tuple[str, ...],
                     device: str) -> None:
    """Fail a mesh request that needs more ranks than there are with an
    actionable message: the ranks of the process group or, with no group,
    this process alone (one rank, if it sees a device of the mesh's
    type)."""
    need = math.prod(shape)
    if dist.is_initialized():
        have = dist.get_world_size()
        what = "ranks in the process group"
    else:
        have = min(1, torch.cuda.device_count()) if device == "cuda" else 1
        what = f"without a process group (this process, on {device})"
    if need > have:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} needs {need} ranks but only "
            f"{have} {what}; launch one process a device under "
            f"torchrun --nproc-per-node {need}, or for a dry run start the "
            f"placeholder group first (repro_torch.launch.dryrun."
            f"placeholder_group({need})), or shrink the mesh")


def _one_rank_group(device: str) -> None:
    """A process group of this process alone (``nccl`` on the current
    card, ``gloo`` on the CPU) from an in-process store: no network."""
    if device == "cuda":
        torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device: str):
    from torch.distributed.device_mesh import DeviceMesh
    _require_devices(shape, axes, device)
    if not dist.is_initialized():
        _one_rank_group(device)
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(device, ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_debug_mesh(data: int = 1, model: int = 1, device: str = "cuda"):
    """A small ``("data", "model")`` mesh over the group's first ranks (one
    card: a (1, 1) mesh, setting up a one-rank group if none exists)."""
    return _mesh((data, model), ("data", "model"), device)


def mesh_chips(mesh) -> int:
    return int(mesh.size())
