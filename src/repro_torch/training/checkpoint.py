"""Atomic, self-describing checkpoints.

The port of ``repro/training/checkpoint.py``, in the reference's format:
a directory ``<path>/step_<step:08d>`` holding ``manifest.json`` (step,
``extra``, and for each leaf its file, shape and dtype) and one ``.npy``
file a leaf, written to ``<path>.tmp.<step>`` and renamed into place, and
``<path>/LATEST`` naming the newest.  A leaf is a tensor (or numpy
array) of a tree of dicts, lists and tuples, in the port's own leaf
order: dicts by sorted key, as ``jax.tree`` orders them.  A bfloat16
leaf is stored as its float32 values (numpy has no bfloat16), its
manifest dtype says ``bfloat16``, and :func:`restore` casts it back.
``save_async`` copies to host memory at once and writes on a thread.

Elastic, as the reference's: a ``DTensor`` leaf is stored as its whole
logical array, so a run saved on one mesh restores onto any other
(:func:`restore`'s ``shardings``), each rank slicing its own shard from
the array it reads, with no collective.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from ..sharding import partition


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)


def _full(leaf):
    """A ``DTensor``'s whole logical array (a collective: every rank of
    its mesh takes part), any other leaf itself."""
    full = getattr(leaf, "full_tensor", None)
    return leaf if full is None else full()


def _host(leaf):
    """(a host copy of ``leaf`` as stored, its manifest dtype); a copy, so
    that training may go on updating the leaf in place."""
    if isinstance(leaf, torch.Tensor):
        t = _full(leaf.detach())
        if t.dtype == torch.bfloat16:
            return t.float().cpu().numpy(), "bfloat16"
        arr = t.to("cpu", copy=True).numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def save(path: str, step: int, tree, extra: dict | None = None) -> str:
    """Blocking save.  Returns the final checkpoint directory.  A tree
    with ``DTensor`` leaves is saved by every rank of their mesh together
    (each leaf is gathered whole): rank 0 writes, and every rank returns
    once the files are in place."""
    leaves = partition.leaves(tree)
    sharded = any(hasattr(leaf, "full_tensor") for leaf in leaves)
    if sharded and torch.distributed.get_rank() != 0:
        for leaf in leaves:
            _full(leaf.detach())
        final = f"{path}/step_{step:08d}"
    else:
        final = _save_host(path, step, [_host(leaf) for leaf in leaves],
                           extra)
    if sharded:
        torch.distributed.barrier()
    return final


def save_async(path: str, step: int, tree, extra: dict | None = None
               ) -> threading.Thread:
    """Device->host snapshot now; file I/O on a background thread."""
    host = [_host(leaf) for leaf in partition.leaves(tree)]
    t = threading.Thread(target=_save_host, args=(path, step, host, extra),
                         daemon=True)
    t.start()
    return t


def _save_host(path, step, host, extra) -> str:
    tmp = f"{path}.tmp.{step}"
    final = f"{path}/step_{step:08d}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (arr, dtype) in enumerate(host):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"file": fname, "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.makedirs(path, exist_ok=True)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _write_latest(path, final)
    return final


def _write_latest(path, final):
    tmp = os.path.join(path, "LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(os.path.basename(final))
    os.replace(tmp, os.path.join(path, "LATEST"))


def latest_step(path: str) -> int | None:
    latest = os.path.join(path, "LATEST")
    if not os.path.exists(latest):
        return None
    name = open(latest).read().strip()
    return int(name.split("_")[-1])


def restore(path: str, like_tree, step: int | None = None, shardings=None):
    """The checkpoint at ``step`` (default: the latest) as a tree like
    ``like_tree``: each tensor leaf at its like's dtype and device, each
    other leaf a numpy array.  Returns ``(tree, step, extra)``.

    ``shardings`` (optional; a tree of :class:`~repro_torch.sharding.
    partition.NamedSharding` of ``like_tree``'s structure, ``None`` for a
    leaf left unplaced) re-places leaves, the elastic path: each becomes
    a ``DTensor`` on its sharding's mesh, this rank's shard sliced from
    the whole array, at the file's dtype (the manifest's, bfloat16
    included), where an unplaced leaf takes its like's dtype, as the
    reference's ``restore`` places the stored array as it is and casts
    only the other."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = partition.leaves(like_tree)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError("checkpoint/model structure mismatch")
    shard_leaves = ([None] * len(leaves) if shardings is None else
                    partition.leaves(shardings, lambda x: isinstance(
                        x, partition.NamedSharding)))
    if len(shard_leaves) != len(leaves):
        raise ValueError("shardings/model structure mismatch")
    out = []
    for i, (like, meta, sh) in enumerate(zip(leaves, manifest["leaves"],
                                             shard_leaves)):
        # a placed leaf reads only this rank's shard of the file
        arr = np.load(os.path.join(d, meta["file"]),
                      mmap_mode=None if sh is None else "r")
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(
                f"leaf {i}: checkpoint shape {arr.shape} != {like.shape}")
        if sh is not None:
            local = np.array(arr[partition.local_slices(arr.shape, sh)])
            dev = torch.device(sh.mesh.device_type)
            if dev.type == "cuda":
                dev = torch.device("cuda", torch.cuda.current_device())
            out.append(partition.from_local(
                torch.from_numpy(local).to(device=dev,
                                           dtype=getattr(torch, meta["dtype"])),
                sh, arr.shape))
        elif isinstance(like, torch.Tensor):
            out.append(torch.from_numpy(arr).to(device=like.device,
                                                dtype=like.dtype))
        else:
            out.append(arr.astype(np.asarray(like).dtype))
    return _unflatten(like_tree, out), manifest["step"], manifest["extra"]
