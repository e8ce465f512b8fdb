"""Device labels and cost balancing for the fleet (the port of the
single-device half of ``repro.fleet.devices``).

* ``device_label(dev)`` names a ``torch.device`` for metrics and
  traces: ``"cuda:0"``, ``"cpu:0"``; ``None`` is ``"default"``;
* ``balance_units(units, n, cost)`` greedily assigns routing units
  (same-program job groups) to the least-loaded of ``n`` lanes by the
  cost model's per-job estimates, keeping each group on one lane.

The multi-device half (``fleet_devices``, the job mesh) belongs with
the sharded fleet and is not ported yet (ROADMAP.md, queue 1, item 9).
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch


def device_label(dev) -> str:
    """Stable metrics/trace label for a device: ``"cpu:0"``,
    ``"cuda:1"``.  ``None`` maps to ``"default"``; a card named
    without an index is the current one."""
    if dev is None:
        return "default"
    dev = torch.device(dev)
    index = dev.index
    if index is None:
        index = torch.cuda.current_device() if dev.type == "cuda" else 0
    return f"{dev.type}:{index}"


def balance_units(
    units: Sequence[Any],
    n_devices: int,
    cost: Callable[[Any], float],
) -> list[list[Any]]:
    """Greedy least-loaded assignment of routing units to devices.

    Units are sorted by descending cost (LPT scheduling) and each is
    placed on the currently least-loaded device, so a heterogeneous mix
    spreads by the cost model's estimates rather than round-robin.
    Returns ``n_devices`` lists (some possibly empty).  Ties break on
    device index so the assignment is deterministic.
    """
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    lanes: list[list[Any]] = [[] for _ in range(n_devices)]
    if n_devices == 1:
        lanes[0].extend(units)
        return lanes
    load = [0.0] * n_devices
    order = sorted(range(len(units)), key=lambda i: -float(cost(units[i])))
    for i in order:
        k = min(range(n_devices), key=lambda d: (load[d], d))
        lanes[k].append(units[i])
        load[k] += float(cost(units[i]))
    # preserve submission order within each lane (drain order stability)
    index = {id(u): i for i, u in enumerate(units)}
    for lane in lanes:
        lane.sort(key=lambda u: index[id(u)])
    return lanes
