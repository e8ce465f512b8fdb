"""Device topology and cost balancing for the multi-device fleet (the
port of ``repro.fleet.devices``).

* **resolution** — ``fleet_devices(spec)`` turns a user-facing device
  spec (``None``/``"all"``/count/device/list) into a concrete tuple of
  ``torch.device``s: the cards unless the caller names the CPU, with an
  actionable error when fewer cards exist than asked for.  A list of
  distinct ``torch.device("cpu", i)`` gives CPU lanes ``cpu:0``,
  ``cpu:1``, ... (the port's counterpart of XLA's
  ``--xla_force_host_platform_device_count``); a tensor put on
  ``cpu:1`` lands on ``cpu``, so lanes key their plans and labels on
  the lane's device, never a tensor's;
* **the job mesh** — ``make_job_mesh(devices)`` is the ordered device
  tuple with its one ``"jobs"`` axis: a same-program megabatch gives
  device ``k`` rows ``k * batch_size`` to ``(k + 1) * batch_size``
  (every row is an independent core, so the split is bit-identical to
  one device running them all);
* **balancing** — ``balance_units(units, n, cost)`` greedily assigns
  routing units (same-program job groups) to the least-loaded device by
  the cost model's per-job estimates, keeping each group on one device
  so its residency entries and plans stay warm;
* ``device_label(dev)`` names a device for metrics and traces:
  ``"cuda:0"``, ``"cpu:1"``; ``None`` is ``"default"``.

Everything here is topology only: no dispatch, no state.  The sharded
scheduler (``fleet/sharded.py``) and the serving layer
(``fleet/service.py``) compose these with per-device
``FleetScheduler`` instances.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple, Sequence

import torch

from ..core.machine import resolve_device

DeviceSpec = Any  # None | int | "all" | torch.device | str | Sequence


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


def _oversubscribed(requested: int, available: int, what: str) -> ValueError:
    return ValueError(
        f"{what} needs {requested} devices but only {available} "
        f"{'is' if available == 1 else 'are'} visible to torch "
        "(torch.cuda.device_count()). To run that many lanes on the CPU, "
        "name them: devices=[torch.device('cpu', i) for i in "
        f"range({requested})].")


def _device(d) -> torch.device:
    """One named device, concrete: a card without an index is the
    current one; a card asked for without one present raises."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def fleet_devices(spec: DeviceSpec = "all") -> tuple:
    """Resolve a device spec to a concrete tuple of ``torch.device``s.

    * ``"all"`` / ``None`` — every card, ``cuda:0`` to
      ``cuda:{device_count() - 1}`` (raising without one: the CPU is
      reached only when named);
    * an ``int`` N — the first N cards (raising, with the CPU-lane
      recipe, when fewer exist);
    * a single device (``torch.device`` or string) or a sequence of
      them — used as given.
    """
    if spec is None or (isinstance(spec, str) and spec == "all"):
        resolve_device("cuda")
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    if isinstance(spec, int) and not isinstance(spec, bool):
        if spec < 1:
            raise ValueError(f"device count must be >= 1, got {spec}")
        resolve_device("cuda")
        n = torch.cuda.device_count()
        if spec > n:
            raise _oversubscribed(spec, n, f"devices={spec}")
        return tuple(torch.device("cuda", i) for i in range(spec))
    if isinstance(spec, (str, torch.device)):
        return (_device(spec),)
    devs = tuple(_device(d) for d in spec)
    if not devs:
        raise ValueError("devices= must name at least one device")
    return devs


def on_device(dev):
    """A context that makes ``dev`` the current card for the work inside
    it (a lane's, a dispatcher's or a drain's thread starts on card 0);
    the CPU needs none."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class JobMesh(NamedTuple):
    """The devices a megabatch spreads its rows over, in order, and the
    one axis they form."""

    devices: tuple
    axis_names: tuple = ("jobs",)


def make_job_mesh(devices: Sequence[Any]) -> JobMesh:
    """The 1-D ``("jobs",)`` mesh over ``devices``: a same-program
    megabatch gives each device one ``batch_size``-row shard of its
    slab, in this order."""
    return JobMesh(tuple(_device(d) for d in devices))


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
