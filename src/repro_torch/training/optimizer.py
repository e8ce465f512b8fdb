"""AdamW with gradient clipping and a warmup-cosine schedule.

The port of ``repro/training/optimizer.py``, with the same arithmetic in
the same order (``optimizer.py:64-73``), on named leaves (``{name:
tensor}``, as ``model.named_parameters()`` gives them) and updated in
place, one leaf at a time: a full-width model's master parameters,
gradients and two moments already fill most of the card, so a functional
update that builds the new tree beside the old one does not fit.  Each
leaf's gradient is dropped as soon as it has been applied.

The reference decays every leaf of two or more dimensions.  Its stacks
of like layers (the transformer's ``blocks``, zamba2's ``mamba``,
seamless-m4t's ``enc`` and ``dec``) hold each leaf on a leading layer
axis, so each of them is at least two-dimensional and decays, the norm
scales included; the port keeps one tensor a layer, so a leaf under a
stacked part decays whatever its dimensions (:func:`decays`), and one
under a list of layers (xlstm's ``blocks``) only as a matrix.
:func:`state_specs` gives the state's logical sharding specs, leaf by
named leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: Any = torch.float32


def init(params: dict, cfg: OptConfig) -> dict:
    """Zero moments for each named leaf, and the step count (0-d int32 on
    the leaves' device)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype,
                                  device=p.device)
    device = next(iter(params.values())).device
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _named(tree, prefix: str = ""):
    """(dotted name, leaf) of a tree of dicts and lists, named as
    ``nn.Module.named_parameters`` names a model's parameters."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def state_specs(param_specs) -> dict:
    """Optimizer-state logical specs mirror the parameter specs: ``m`` and
    ``v`` hold each parameter's spec under its name in :func:`init`'s
    state, and ``count`` is replicated."""
    named = dict(_named(param_specs))
    return {"m": named, "v": dict(named), "count": ()}


def schedule(cfg: OptConfig, count: torch.Tensor) -> torch.Tensor:
    """The learning rate at step ``count`` (0-d, float32)."""
    warm = torch.clamp((count + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((count - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(leaves) -> torch.Tensor:
    """The float32 L2 norm over every leaf, summed leaf by leaf."""
    total = None
    for g in leaves:
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def decays(name: str, p: torch.Tensor, stacked: tuple) -> bool:
    """Whether leaf ``name`` takes decoupled weight decay: a matrix, or a
    leaf under one of the ``stacked`` top-level parts (the reference's
    are layer-stacked, so two-dimensional; ``convert.stacked_parts``
    names a config's)."""
    return p.ndim >= 2 or name.split(".", 1)[0] in stacked


@torch.no_grad()
def apply(params: dict, grads: dict, state: dict, cfg: OptConfig, *,
          stacked: tuple, loss: torch.Tensor | None = None):
    """One AdamW step on ``params`` and ``state`` in place; returns
    ``(params, state, info)`` with the gradient norm, the learning rate
    and ``finite``.  ``grads`` is consumed: each entry is dropped once
    its leaf is updated.

    ``loss`` (the training step's non-finite sentinel): unless it and the
    gradient norm are finite, every leaf and the count keep their values
    (a ``torch.where`` on the device, leaf by leaf).  Without it the
    update is unconditional, as the reference's ``apply``.  ``stacked``:
    the top-level parts whose leaves decay whatever their dimensions
    (:func:`decays`)."""
    count = state["count"]
    gnorm = global_norm(grads.values())
    finite = torch.isfinite(gnorm)
    if loss is not None:
        finite = finite & torch.isfinite(loss)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, count)
    t = (count + 1).float()
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t
    for name, p in params.items():
        g, m, v = grads.pop(name), state["m"][name], state["v"][name]
        g = g.float() * scale
        m32 = m.float() * cfg.b1 + (1 - cfg.b1) * g
        v32 = v.float() * cfg.b2 + (1 - cfg.b2) * g * g
        del g
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if decays(name, p, stacked):
            step = step + cfg.weight_decay * p.float()
        newp = p.float() - lr * step
        del step
        if loss is None:
            p.copy_(newp)
            m.copy_(m32)
            v.copy_(v32)
        else:
            p.copy_(torch.where(finite, newp.to(p.dtype), p))
            m.copy_(torch.where(finite, m32.to(m.dtype), m))
            v.copy_(torch.where(finite, v32.to(v.dtype), v))
    new_count = count + 1
    count.copy_(new_count if loss is None
                else torch.where(finite, new_count, count))
    return params, state, {"grad_norm": gnorm, "lr": lr,
                           "finite": finite}
