"""Deterministic fault injection for the fleet serving stack
(a copy of the reference's framework-free ``repro.fleet.faults``).

A :class:`FaultPlan` is a seeded schedule of failures threaded through
the scheduler/engine hook points (``with plan: ...`` installs it into a
contextvar, exactly like :class:`repro_torch.obs.Tracer`).  Each hook names a
**site**; the plan decides — reproducibly, from its seed and the
encounter order — whether that visit faults:

=================== =====================================================
site                effect at the hook point
=================== =====================================================
``compile``         :class:`InjectedFault` raised after a tier compile
                    (the scheduler degrades the unit down the tier
                    chain: superblock -> blocks -> interpreter)
``dispatch``        :class:`InjectedFault` raised in place of a batch
                    dispatch (the isolated drain bisects the batch;
                    the service retries with backoff)
``device_sync``     the device sync stalls for ``hang_s`` seconds
                    (exercises the service's dispatch watchdog/timeout)
``residency_evict`` the device-resident input cache is dropped (must be
                    a harmless miss, never an error)
``salvage_corrupt`` one stashed salvaged result has a bit flipped while
                    it waits for the next drain (proves the salvage
                    path's delivery checksums catch corruption)
``device_fail``     a whole device is declared dead at the top of a
                    per-device dispatch: the multi-device service marks
                    it unhealthy, its dispatcher exits, and the cohort
                    re-enters the shared queue for the surviving
                    devices (proves capacity — not availability — is
                    what a dead device costs).  Pair with
                    ``where={"device": "cpu:2"}`` to kill one device.
=================== =====================================================

Sites the plan does not mention never fault, and with no plan installed
every hook is a no-op (one contextvar read), so production paths pay
nothing.  Every injection is logged on the plan (``plan.injected``,
``plan.log``) and emitted as a ``fault_injected`` trace event, so a
chaos run's outcome is auditable in the Perfetto trace.

    plan = FaultPlan(seed=7, dispatch=0.05,
                     compile={"p": 1.0, "count": 2, "where": {"tier": "superblock"}},
                     device_sync={"p": 0.01, "hang_s": 0.5})
    with plan:
        service.submit(...); ...
    plan.injected            # {"dispatch": 3, "compile": 2, ...}
"""
from __future__ import annotations

import contextvars
import dataclasses
import hashlib
import threading
from typing import Any, Mapping

import numpy as np

from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..obs import trace as obs_trace

__all__ = [
    "FAULT_SITES", "FaultPlan", "FaultSpec", "InjectedFault",
    "current_plan", "fire", "maybe_raise", "hang_seconds",
]

#: every hook point the fleet stack exposes (a plan naming anything
#: else is a typo and is rejected at construction)
FAULT_SITES = ("compile", "dispatch", "device_sync", "residency_evict",
               "salvage_corrupt", "device_fail")


class InjectedFault(RuntimeError):
    """A failure injected by the active :class:`FaultPlan`.

    Deliberately a plain ``RuntimeError`` subclass: the recovery paths
    under test (tier degradation, bisection, retries) must treat it
    like any unexpected production failure, not special-case it.
    """

    def __init__(self, site: str, info: dict | None = None):
        self.site = site
        self.info = dict(info or {})
        extra = "".join(f" {k}={v}" for k, v in self.info.items())
        super().__init__(f"injected fault at {site}{extra}")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """How one site faults.

    ``p`` is the per-encounter injection probability; ``count`` caps the
    total injections at the site (``None`` = unlimited); ``after`` skips
    the first N matching encounters (deterministic "fail the Kth
    dispatch" plans); ``where`` filters on the hook's keyword info (e.g.
    ``{"tier": "superblock"}`` faults only superblock compiles);
    ``hang_s`` is the stall length for ``device_sync``.
    """

    p: float = 1.0
    count: int | None = None
    after: int = 0
    hang_s: float = 0.0
    where: Mapping[str, Any] | None = None


class FaultPlan:
    """A seeded, deterministic fault schedule (contextvar-installed).

    Construct with ``site=<p>`` shorthand or ``site={...}`` /
    ``site=FaultSpec(...)`` for the full knobs.  Two runs with the same
    seed, plan, and encounter order inject identical faults — the rng
    streams are derived per-site from the seed, so sites never perturb
    each other.  ``fire``/``maybe_raise``/``hang_seconds`` are the hook
    entry points (normally called via the module-level helpers).
    """

    def __init__(self, seed: int = 0, **sites: float | dict | FaultSpec):
        self.seed = int(seed)
        self.specs: dict[str, FaultSpec] = {}
        for site, spec in sites.items():
            if site not in FAULT_SITES:
                raise ValueError(
                    f"unknown fault site {site!r}; one of {FAULT_SITES}")
            if isinstance(spec, FaultSpec):
                pass
            elif isinstance(spec, Mapping):
                spec = FaultSpec(**spec)
            else:
                spec = FaultSpec(p=float(spec))
            self.specs[site] = spec
        # independent, order-insensitive streams: seed ^ blake2(site)
        self._rngs = {
            site: np.random.default_rng(self.seed ^ int.from_bytes(
                hashlib.blake2b(site.encode(), digest_size=8).digest(),
                "little"))
            for site in self.specs}
        #: per-site counts of hook visits / actual injections
        self.encounters: dict[str, int] = {s: 0 for s in self.specs}
        self.injected: dict[str, int] = {s: 0 for s in self.specs}
        #: every injection, in order, with the hook's info kwargs
        self.log: list[dict] = []
        self._lock = threading.Lock()
        # per-thread token stacks: contextvar reset tokens are only
        # valid in the context that set them, and one plan may be
        # entered concurrently from many dispatcher threads
        self._tokens = threading.local()

    # ------------------------------------------------------ activation
    def __enter__(self) -> "FaultPlan":
        stack = getattr(self._tokens, "stack", None)
        if stack is None:
            stack = self._tokens.stack = []
        stack.append(_PLAN.set(self))
        return self

    def __exit__(self, *exc) -> bool:
        _PLAN.reset(self._tokens.stack.pop())
        return False

    # ----------------------------------------------------------- hooks
    def fire(self, site: str, **info) -> FaultSpec | None:
        """Roll the site's dice for this encounter; returns the spec
        when a fault should be injected now, else ``None``."""
        spec = self.specs.get(site)
        if spec is None:
            return None
        if spec.where is not None and any(
                info.get(k) != v for k, v in spec.where.items()):
            return None
        with self._lock:
            self.encounters[site] += 1
            if self.encounters[site] <= spec.after:
                return None
            if spec.count is not None and self.injected[site] >= spec.count:
                return None
            if spec.p < 1.0 and self._rngs[site].random() >= spec.p:
                return None
            self.injected[site] += 1
            self.log.append({"site": site, "n": self.injected[site], **info})
        # the trace event also lands in the ambient flight recorder;
        # the counter and the blackbox dump make every injection
        # observable in always-on production telemetry too
        obs_trace.event("fault_injected", cat="fault", site=site, **info)
        obs_metrics.inc("serve_faults_injected_total", fault_site=site)
        obs_recorder.trigger(f"fault_{site}", fault_site=site, **info)
        return spec

    def total_injected(self) -> int:
        return sum(self.injected.values())


_PLAN: contextvars.ContextVar["FaultPlan | None"] = \
    contextvars.ContextVar("repro_torch_fleet_fault_plan", default=None)


def current_plan() -> FaultPlan | None:
    """The fault plan installed in the current context, or ``None``."""
    return _PLAN.get()


def fire(site: str, **info) -> FaultSpec | None:
    """Hook: does the ambient plan (if any) fault this visit?"""
    plan = _PLAN.get()
    return plan.fire(site, **info) if plan is not None else None


def maybe_raise(site: str, **info) -> None:
    """Hook: raise :class:`InjectedFault` when the ambient plan says so."""
    if fire(site, **info) is not None:
        raise InjectedFault(site, info)


def hang_seconds(site: str, **info) -> float:
    """Hook: how long this visit should stall (0.0 = no fault)."""
    spec = fire(site, **info)
    return spec.hang_s if spec is not None else 0.0
