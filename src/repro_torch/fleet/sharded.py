"""Multi-device fleet: shard the job stream across every local device
(the port of ``repro.fleet.sharded``).

:class:`ShardedFleetScheduler` extends :class:`~repro_torch.fleet.
scheduler.FleetScheduler` — same ``submit``/``drain``/``drain_isolated``
API, same crash-safety and salvage invariants — but executes across a
set of torch devices instead of one:

* **same-program megabatches** — a group big enough to fill every
  device (``>= n_devices * batch_size`` jobs of one program at one
  thread count) is packed into exact slabs of ``n_devices *
  batch_size`` rows.  Device ``k`` runs rows ``k * batch_size`` to
  ``(k + 1) * batch_size`` of a slab through the program's plan on that
  device (``light_compile``, then ``run_light_dev``); every device's
  shard is issued before any is synchronised, and the slab's results
  are collected together.  Every row is an independent core, so the
  split is bit-identical to one device running the slab.  Slab inputs
  keep their own :class:`~repro_torch.fleet.engine.ResidencyCache`
  entry (one tensor a device), and the plans themselves are what the
  reference's AOT cache of ``shard_map`` executables was;
* **heterogeneous mixes** — everything else routes through per-device
  queues: jobs group by program (so one device keeps a program's
  residency entries and plans warm), groups are assigned to the
  least-loaded device by the cost model's per-job estimates
  (:func:`~repro_torch.fleet.devices.balance_units`), and each device's
  private pinned :class:`FleetScheduler` drains its lane on its own
  thread, under that device and a copy of the caller's context (the
  fault plan, the tracer and the metrics registry follow it);
* **shared accounting** — every sub-scheduler reports into this
  scheduler's :class:`~repro_torch.obs.metrics.MetricsRegistry` under
  its own ``device`` label (megabatches report as ``device="mesh"``:
  one slab spans every device), so ``stats`` aggregates fleet-wide and
  ``stats.per_device()`` splits it back out.

Crash-safety composes: a failing device lane re-queues its unprocessed
jobs and stashes its computed results inside its sub-scheduler; this
scheduler *adopts* that state (checksum-verified) before re-raising, so
the caller sees exactly the single-scheduler contract — a failed drain
loses no work, computed or queued, whichever device failed.

With one device the behavior (and every architectural result) is
bit-identical to a plain ``FleetScheduler`` — multi-device is purely a
throughput layer.
"""
from __future__ import annotations

import concurrent.futures
import contextvars
import time
from typing import Any

from ..core import machine as machine_mod
from ..core.blockc import program_key
from ..core.config import EGPUConfig
from ..obs import trace as obs_trace
from . import faults
from .devices import (balance_units, device_label, fleet_devices,
                      make_job_mesh, on_device)
from .engine import ResidencyCache
from .scheduler import (DrainCancelled, FleetJob, FleetScheduler,
                        JobResult, _prog_digest, _result_checksum,
                        _roll_up_counters)

__all__ = ["ShardedFleetScheduler"]


class ShardedFleetScheduler(FleetScheduler):
    """A :class:`FleetScheduler` sharded over local torch devices.

    ``devices`` accepts everything :func:`~repro_torch.fleet.devices.
    fleet_devices` does: ``"all"`` (default — every card), an int N
    (the first N cards), or an explicit device sequence (which is how
    CPU lanes are named).  All other knobs match
    :class:`FleetScheduler` and apply to every per-device lane.
    """

    def __init__(self, cfg: EGPUConfig, batch_size: int = 32, *,
                 devices: Any = "all", **kw):
        self.devices = fleet_devices(devices)
        # the megabatch compiles take the first device's tier table
        super().__init__(cfg, batch_size, device=self.devices[0], **kw)
        self.n_devices = len(self.devices)
        self.device_labels = tuple(device_label(d) for d in self.devices)
        #: megabatch dispatches span the whole mesh, so their metrics
        #: land under this label instead of any one device
        self._dev = "mesh"
        self._mesh = make_job_mesh(self.devices)
        #: one pinned scheduler per device, all reporting into OUR
        #: registry (lifetime totals aggregate fleet-wide); jobs are
        #: injected into the lanes' queues with *our* handles, so their
        #: results/failures/salvage need no remapping
        self._scheds = tuple(
            FleetScheduler(cfg, batch_size,
                           pack_by_cost=self.pack_by_cost,
                           validate=self.validate,
                           use_compiler=self.use_compiler,
                           compile_min=self.compile_min,
                           tier_policy=kw.get("tier_policy"),
                           residency_max=kw.get("residency_max", 32),
                           fixed_bucket=self.fixed_bucket,
                           trace=self.tracer, metrics=self._m,
                           device=d)
            for d in self.devices)
        #: per-device megabatch inputs (separate from the base cache:
        #: a slab's shards and one device's batch are different
        #: placements and must never alias)
        self._mega_residency = ResidencyCache(kw.get("residency_max", 32))

    def cancel(self) -> None:
        super().cancel()
        for s in self._scheds:
            s.cancel()

    # -------------------------------------------------------- megabatch
    @property
    def _slab(self) -> int:
        """Megabatch slab: one full batch per device.  Exact slabs only
        — one plan shape per program, like serving's
        ``fixed_bucket``."""
        return self.n_devices * self.batch_size

    def _mega_plans(self, cp, shared, tdx) -> float:
        """Make ``cp``'s plan at ``batch_size`` on every device of the
        mesh (on the card: warm-ups and graph captures), counted as one
        compile-cache hit or miss for the slab; returns the seconds
        that took (0.0 when every plan existed)."""
        compile_s = 0.0
        for d, sh, td in zip(self._mesh.devices, shared, tdx):
            with on_device(d):
                compile_s += cp.light_compile(sh, td, d)
        self._m.inc("fleet_compile_cache_total",
                    result="miss" if compile_s else "hit")
        return compile_s

    def _run_megabatch(self, cp, chunk: list[FleetJob],
                       results: dict[int, JobResult]) -> None:
        """One exact slab — ``n_devices * batch_size`` same-program
        jobs — as one shard a device, every shard issued before any is
        synchronised."""
        real = len(chunk)
        with obs_trace.span("batch", tier=cp.mode, jobs=real,
                            device="mesh", devices=self.n_devices):
            t0 = time.perf_counter()
            with obs_trace.span("residency") as rsp:
                (shared_dev, tdx_dev), res_hit = self._resident_inputs(
                    cp, chunk, real, self._mesh.devices,
                    self._mega_residency)
            if rsp.active:
                rsp.set(hit=res_hit)
            compile_s = self._mega_plans(cp, shared_dev, tdx_dev)
            self._m.inc("fleet_compile_seconds_total", compile_s)
            t_disp = time.perf_counter()
            with obs_trace.span("dispatch", cores=real, device="mesh"):
                faults.maybe_raise("dispatch", tier=cp.mode, cores=real,
                                   device="mesh")
                outs = []
                for d, sh, td in zip(self._mesh.devices, shared_dev,
                                     tdx_dev):
                    with on_device(d):
                        outs.append(cp.run_light_dev(sh, td, d)[0])
            t_sync = time.perf_counter()
            with obs_trace.span("device_sync"):
                hang = faults.hang_seconds("device_sync", tier=cp.mode,
                                           device="mesh")
                if hang:
                    time.sleep(hang)
                for d in self._mesh.devices:
                    machine_mod.sync(d)
            t_done = time.perf_counter()
            self._m.observe("fleet_dispatch_seconds", t_sync - t_disp,
                            tier=cp.mode, device="mesh")
            self._m.observe("fleet_device_sync_seconds", t_done - t_sync,
                            tier=cp.mode, device="mesh")
            wall = time.perf_counter() - t0 - compile_s
            with obs_trace.span("collect"):
                self._collect_light(cp, outs, chunk, real, wall, results)

    def _take_megabatches(self, jobs: list[FleetJob]):
        """Split out exact same-program slabs for the megabatch path;
        returns ``(slabs, rest)`` where each slab is
        ``(CompiledProgram, jobs)`` and ``rest`` keeps submission
        order."""
        slab = self._slab
        groups: dict[tuple, list[FleetJob]] = {}
        order: list[FleetJob] = []
        for j in jobs:
            groups.setdefault((program_key(j.image), j.threads),
                              []).append(j)
        slabs: list[tuple[Any, list[FleetJob]]] = []
        rest_set: set[int] = set()
        for group in groups.values():
            n_slabs = len(group) // slab
            if n_slabs == 0:
                rest_set.update(id(j) for j in group)
                continue
            cp = self._compile_unit(group[0], self.batch_size,
                                    jobs=len(group))
            if cp is None:               # interpreter tier: per-device
                rest_set.update(id(j) for j in group)
                continue
            self._event("megabatch", program=_prog_digest(cp.image),
                        jobs=n_slabs * slab, slabs=n_slabs,
                        devices=self.n_devices, tier=cp.mode)
            for i in range(n_slabs):
                slabs.append((cp, group[i * slab:(i + 1) * slab]))
            rest_set.update(id(j) for j in group[n_slabs * slab:])
        for j in jobs:
            if id(j) in rest_set:
                order.append(j)
        return slabs, order

    # ------------------------------------------------- per-device lanes
    def _adopt_sub_state(self, sub: FleetScheduler,
                         results: dict[int, JobResult]) -> None:
        """Absorb a failed lane's crash-safety state: its computed
        (stashed) results join ours after checksum verification —
        corruption is dropped and re-executed, exactly the base
        salvage contract — and its re-queued jobs are released (our
        own requeue path re-queues every uncollected handle)."""
        for h, r in sub._salvaged.items():
            if _result_checksum(r) != sub._salvage_sums.get(h):
                self._m.inc("fleet_salvage_dropped_total")
                self._event("salvage_corrupt", cat="serve", handle=h)
                continue
            results[h] = r
        sub._salvaged, sub._salvage_sums, sub._salvage_jobs = {}, {}, {}
        sub._queue = []

    def _run_balanced(self, jobs: list[FleetJob],
                      results: dict[int, JobResult],
                      failures: dict[int, Exception],
                      isolate: bool) -> None:
        """Route a heterogeneous mix through the per-device lanes:
        same-program groups stay whole (cache locality), lanes fill
        least-loaded-first by summed job cost, and every device drains
        its lane concurrently on its own thread."""
        if not jobs:
            return
        groups: dict[tuple, list[FleetJob]] = {}
        for j in jobs:
            groups.setdefault((program_key(j.image), j.threads),
                              []).append(j)
        units = list(groups.values())
        lanes = balance_units(units, self.n_devices,
                              cost=lambda u: sum(j.cost for j in u))

        def lane_drain(d: int):
            sub = self._scheds[d]
            for unit in lanes[d]:
                sub._queue.extend(unit)
            with on_device(self.devices[d]), \
                    obs_trace.span("device_lane",
                                   device=self.device_labels[d],
                                   jobs=sub.pending):
                return (sub.drain_isolated() if isolate
                        else (sub.drain(), {}))

        active = [d for d in range(self.n_devices) if lanes[d]]
        outcomes: list[tuple[int, Any, BaseException | None]] = []
        if len(active) <= 1:
            for d in active:
                try:
                    outcomes.append((d, lane_drain(d), None))
                except BaseException as e:
                    outcomes.append((d, None, e))
        else:
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=len(active),
                    thread_name_prefix="fleet-dev") as ex:
                futs = [(d, ex.submit(contextvars.copy_context().run,
                                      lane_drain, d))
                        for d in active]
                for d, f in futs:
                    try:
                        outcomes.append((d, f.result(), None))
                    except BaseException as e:
                        outcomes.append((d, None, e))
        first_err: BaseException | None = None
        for d, out, err in outcomes:
            if err is None:
                res, fails = out
                results.update(res)
                failures.update(fails)
            else:
                self._adopt_sub_state(self._scheds[d], results)
                self._event("device_lane_failed", cat="serve",
                            device=self.device_labels[d],
                            error=type(err).__name__)
                if first_err is None or isinstance(err, DrainCancelled):
                    first_err = err
        if first_err is not None:
            raise first_err

    # ------------------------------------------------------------ drain
    def _drain(self, isolate: bool = False):
        results, delivered_jobs = self._take_salvaged()
        n_salvaged = len(results)
        failures: dict[int, Exception] = {}
        all_jobs = self._queue
        self._queue = []
        if not self._cancelled:          # a fresh drain clears old flags
            for s in self._scheds:
                s._cancelled = False

        with obs_trace.span("drain", jobs=len(all_jobs),
                            devices=self.n_devices) as dsp:
            try:
                pending = all_jobs
                slabs: list = []
                if self.use_compiler:
                    with obs_trace.span("partition", jobs=len(pending)):
                        slabs, pending = self._take_megabatches(pending)
                for cp, chunk in slabs:
                    if self._cancelled:
                        raise DrainCancelled("drain cancelled")
                    if isolate:
                        try:
                            self._run_megabatch(cp, chunk, results)
                        except DrainCancelled:
                            raise
                        except Exception as e:
                            # contain: the per-device isolated lanes
                            # (bisection, tier degradation) absorb it
                            self._event("megabatch_failed", cat="serve",
                                        jobs=len(chunk), tier=cp.mode,
                                        error=type(e).__name__)
                            pending = pending + chunk
                    else:
                        self._run_megabatch(cp, chunk, results)
                if self._cancelled:
                    raise DrainCancelled("drain cancelled")
                self._run_balanced(pending, results, failures, isolate)
            except BaseException:
                unprocessed = [j for j in all_jobs
                               if j.handle not in results
                               and j.handle not in failures]
                unprocessed.sort(key=lambda j: j.handle)
                self._queue = unprocessed + self._queue
                self._stash_salvage(results, delivered_jobs, all_jobs)
                raise

            tr = obs_trace.current_tracer()
            if tr is not None:
                _roll_up_counters(tr, results)
                if dsp.active:
                    dsp.set(delivered=len(results),
                            failed=len(failures),
                            devices=self.n_devices)
        if n_salvaged:
            self._m.inc("fleet_salvaged_jobs_total", n_salvaged)
        return results, failures
