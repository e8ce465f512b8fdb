"""User-facing fleet API (the port of ``repro.fleet.api``).

    fleet = Fleet(cfg, batch_size=32)
    h0 = fleet.submit(image_a, shared_init=data_a, threads=512)
    h1 = fleet.submit(image_b, shared_init=data_b, threads=64)
    results = fleet.drain()          # lock-step batches on the card
    results[h0].shared_f32(), results[h1].cycles

``Fleet`` is a thin facade over :class:`FleetScheduler`; ``run_jobs`` is
the one-shot convenience for a fixed job list.  The multi-device fleet
(``devices=``) and the serving loop (``serve_jobs``) are not ported yet
and raise ``NotImplementedError`` (ROADMAP.md, queue 1, items 9 and 8).
"""
from __future__ import annotations

from typing import Any

from ..core.assembler import ProgramImage
from ..core.blockc import TierPolicy
from ..core.config import EGPUConfig
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .scheduler import FleetScheduler, FleetStats, JobResult


class Fleet:
    """A homogeneous array of eGPU cores behind a job queue.

    Same-program jobs are automatically grouped onto the compiled
    lock-step tiers (same blocks, different data; CUDA graphs of the
    eGPU step kernels on the card), with the
    :class:`~repro_torch.core.blockc.TierPolicy` cost model choosing
    between the basic-block driver and the superblock runner per
    (program, batch width); mixed batches run as lock-step
    ``fleet_run`` batches of the interpreter.  ``use_compiler=False``
    forces the interpreter for everything (results are bit-identical
    either way), and ``tier_policy`` overrides the cost model's
    threshold table.  Compiled-tier batch inputs stay device-resident
    across drains — repeat drains of the same program over the same
    inputs pay zero host->device transfer (``stats.residency_hits``).

    ``trace=True`` records every drain (spans, per-job latency, event
    counters, tier decisions) into ``fleet.tracer``; a path string
    additionally writes the cumulative Chrome/Perfetto trace JSON there
    after each drain (``python -m repro_torch.obs.report <path>``
    summarizes it).  Tracing never changes results.

    ``device`` is the card unless ``"cpu"`` is asked for; without a
    card the constructor raises.  ``devices=`` (the sharded
    multi-device fleet) is not ported yet.
    """

    def __init__(self, cfg: EGPUConfig, batch_size: int = 32, *,
                 pack_by_cost: bool = True, validate: bool = True,
                 use_compiler: bool = True, compile_min: int = 2,
                 tier_policy: TierPolicy | None = None,
                 residency_max: int = 32,
                 trace: bool | str | obs_trace.Tracer | None = None,
                 metrics: obs_metrics.MetricsRegistry | None = None,
                 devices: Any = None, device="cuda"):
        if devices is not None:
            raise NotImplementedError(
                "devices= (the sharded multi-device fleet) is not ported "
                "yet (ROADMAP.md, queue 1, item 9)")
        self._sched = FleetScheduler(
            cfg, batch_size, pack_by_cost=pack_by_cost, validate=validate,
            use_compiler=use_compiler, compile_min=compile_min,
            tier_policy=tier_policy, residency_max=residency_max,
            trace=trace, metrics=metrics, device=device)

    @property
    def cfg(self) -> EGPUConfig:
        return self._sched.cfg

    @property
    def batch_size(self) -> int:
        return self._sched.batch_size

    @property
    def pending(self) -> int:
        return self._sched.pending

    @property
    def stats(self) -> FleetStats:
        return self._sched.stats

    @property
    def tracer(self) -> obs_trace.Tracer | None:
        """The fleet's own tracer (``trace=`` knob), or ``None``."""
        return self._sched.tracer

    @property
    def metrics(self) -> obs_metrics.MetricsRegistry:
        """The fleet's metrics registry (``stats`` is a view over it);
        ``metrics.to_prometheus()`` exports it."""
        return self._sched.stats.registry

    def save_trace(self, path: str) -> None:
        """Write the fleet tracer's Chrome/Perfetto trace JSON."""
        if self._sched.tracer is None:
            raise ValueError("fleet was created without trace=")
        self._sched.tracer.save(path)

    def submit(self, image: ProgramImage, shared_init=None, *,
               threads: int | None = None, tdx_dim: int = 16,
               tag: Any = None, weight: float | None = None) -> int:
        """Queue one program execution; returns a result handle.

        ``weight`` is an optional relative cost hint used to pack
        similar-cost jobs into the same lock-step batch.
        """
        return self._sched.submit(image, shared_init, threads=threads,
                                  tdx_dim=tdx_dim, tag=tag, weight=weight)

    def drain(self) -> dict[int, JobResult]:
        """Run all queued jobs in fixed-shape lock-step batches."""
        return self._sched.drain()


def run_jobs(cfg: EGPUConfig, jobs: list[dict], *,
             batch_size: int = 32, device="cuda") -> list[JobResult]:
    """One-shot: run a list of job dicts, results in submission order.

    Each job dict holds ``image`` plus optional ``shared_init``,
    ``threads``, ``tdx_dim``, ``tag`` (the :meth:`Fleet.submit` keywords).
    """
    fleet = Fleet(cfg, batch_size, device=device)
    handles = [fleet.submit(j["image"], j.get("shared_init"),
                            threads=j.get("threads"),
                            tdx_dim=j.get("tdx_dim", 16),
                            tag=j.get("tag")) for j in jobs]
    results = fleet.drain()
    return [results[h] for h in handles]


def serve_jobs(cfg: EGPUConfig, jobs: list[dict], *,
               batch_size: int = 32, **service_kw):
    """The one-shot through the always-on serving loop: not ported yet."""
    raise NotImplementedError(
        "serve_jobs needs fleet/service.py, not ported yet (ROADMAP.md, "
        "queue 1, item 8)")
