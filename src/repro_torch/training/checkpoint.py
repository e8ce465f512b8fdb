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
The reference's ``shardings`` waits for the mesh (``sharding/``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch


def _flatten(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)


def _host(leaf):
    """(a host copy of ``leaf`` as stored, its manifest dtype); a copy, so
    that training may go on updating the leaf in place."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.float().cpu().numpy(), "bfloat16"
        arr = t.to("cpu", copy=True).numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def save(path: str, step: int, tree, extra: dict | None = None) -> str:
    """Blocking save.  Returns the final checkpoint directory."""
    return _save_host(path, step, [_host(leaf) for leaf in _flatten(tree)],
                      extra)


def save_async(path: str, step: int, tree, extra: dict | None = None
               ) -> threading.Thread:
    """Device->host snapshot now; file I/O on a background thread."""
    host = [_host(leaf) for leaf in _flatten(tree)]
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


def restore(path: str, like_tree, step: int | None = None):
    """The checkpoint at ``step`` (default: the latest) as a tree like
    ``like_tree``: each tensor leaf at its like's dtype and device, each
    other leaf a numpy array.  Returns ``(tree, step, extra)``."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = _flatten(like_tree)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError("checkpoint/model structure mismatch")
    out = []
    for i, (like, meta) in enumerate(zip(leaves, manifest["leaves"])):
        arr = np.load(os.path.join(d, meta["file"]))
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(
                f"leaf {i}: checkpoint shape {arr.shape} != {like.shape}")
        if isinstance(like, torch.Tensor):
            out.append(torch.from_numpy(arr).to(device=like.device,
                                                dtype=like.dtype))
        else:
            out.append(arr.astype(np.asarray(like).dtype))
    return _unflatten(like_tree, out), manifest["step"], manifest["extra"]
