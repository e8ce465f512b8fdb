"""Always-on serving loop over the fleet: continuous batching with
deadlines, priorities, retries, backpressure, and fault isolation (the
port of ``repro.fleet.service``).

:class:`FleetService` turns the batch-mode ``submit()``/``drain()``
scheduler into a stream-serving front-end:

* **per-job futures** — :meth:`FleetService.submit` returns a
  :class:`concurrent.futures.Future` that resolves to a
  :class:`~repro_torch.fleet.scheduler.JobResult` or raises a structured
  :class:`JobError` (kind, attempts, cause).  Every submitted future
  resolves, always — that is the serving contract.  Wrap with
  ``asyncio.wrap_future`` to await from an event loop;
* **deadline-or-size batching** — a background dispatcher forms a
  lock-step cohort the moment ``batch_size`` jobs are ready *or* the
  oldest ready job has waited ``max_delay_s``, whichever fires first;
* **priority lanes** — lower ``priority`` dispatches first within a
  trigger (ties broken by submission order);
* **per-job deadlines** — a job past its deadline is *masked out of its
  batch slot* and failed fast with ``JobError(kind="deadline")``: the
  paper's per-instruction thread-space subsetting (TSC) applied at
  request granularity, exactly like the slot-masked decode loop in
  :mod:`repro_torch.launch.serve`;
* **bounded admission** — once queued+in-flight cost (the cost model's
  per-job estimates) exceeds ``cost_budget`` (or ``max_pending`` jobs),
  ``submit`` blocks (``admission="block"``) or raises
  :class:`AdmissionError` (``admission="reject"``): overload degrades
  into latency or fast rejections, never an unbounded queue;
* **per-job retries with exponential backoff** — a failed dispatch is
  bisected by :meth:`FleetScheduler.drain_isolated` so one poison job
  cannot starve its cohort; jobs that still fail are retried up to
  ``max_retries`` times (backoff ``backoff_s * backoff_factor**k``),
  then fail their future with a structured :class:`JobError` instead of
  poisoning the drain;
* **dispatch watchdog** — with ``dispatch_timeout_s`` set, a hung
  dispatch (e.g. a device sync that never returns — the
  ``device_sync`` fault site) is abandoned: the scheduler is replaced
  wholesale and the cohort is retried/failed as timeouts;
* **per-device dispatchers** — with ``devices=`` set, every device gets
  its own dispatcher thread and pinned scheduler, all fed from the ONE
  shared admission queue (work-stealing: whichever device is free takes
  the next ready cohort).  Watchdogs and scheduler resets are
  per-device, so a hung device costs capacity, not availability; a
  device that keeps failing (``device_unhealthy_after`` consecutive
  cohorts, or the ``device_fail`` fault site) is marked unhealthy and
  its dispatcher retires — its queued work migrates to the survivors.
  ``devices=None`` (default) is the single dispatcher, pinned to
  ``device`` (the card unless ``"cpu"`` is asked for).

On the card the service builds the eGPU step kernels when it starts, so
a first dispatch's watchdog never races a cold nvcc build; a plan's
graph capture stays inside the dispatch that first needs it, as XLA's
compile does in the reference.  A drain the watchdog abandons shares no
buffer with the drains after it: each compiled program's plan is held
by one run at a time (``repro_torch.core.blockc._Plan.run``).

Invariants (see ``docs/architecture.md``):

* **every future resolves** — with a :class:`~repro_torch.fleet.scheduler.
  JobResult` or a :class:`JobError`; never dropped, whatever faults,
  hangs, resets or device deaths occur;
* **one delivery per job** — a ticket resolves exactly once; retries
  re-enqueue the same ticket, never clone it;
* **ERROR rejects pre-compile** — the static verifier runs at
  ``submit`` and broken programs fail there (``kind="rejected"``),
  before any compile or device work;
* **overload degrades, never grows** — admission is bounded by cost
  budget / queue depth; shedding is explicit (block or reject).

Failure injection for all of the above is
:class:`repro_torch.fleet.faults.FaultPlan` — pass one as ``faults=`` (or
install it ambiently) and the chaos run stays deterministic.

    svc = FleetService(cfg, batch_size=32, max_delay_s=0.002)   # the card
    fut = svc.submit(image, data, deadline_s=0.5, priority=0)
    res = fut.result()               # JobResult, or raises JobError
    svc.close()
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any

from ..core.assembler import ProgramImage
from ..core.blockc import TierPolicy
from ..core.config import EGPUConfig
from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..kernels import build, egpu_step
from ..obs import trace as obs_trace
from . import faults as faults_mod
from .devices import device_label, fleet_devices, on_device
from .scheduler import FleetScheduler, JobResult, check_job

__all__ = ["FleetService", "ServiceStats", "JobError", "AdmissionError",
           "register_serve_metrics"]


class JobError(Exception):
    """Structured per-job failure: resolves the job's future.

    ``kind`` is one of ``"deadline"`` (missed its deadline before
    dispatch), ``"timeout"`` (dispatch watchdog fired and retries ran
    out), ``"error"`` (failed on every tier and every retry),
    ``"shutdown"`` (service closed without draining), ``"rejected"``
    (the static verifier found ERROR-level defects at submit; ``cause``
    is the :class:`~repro_torch.analysis.ProgramVerificationError` and
    carries the full diagnostic report).  ``attempts`` is
    how many dispatches the job consumed; ``cause`` the last underlying
    exception (``None`` for deadline/shutdown).  ``recent_events`` is
    the flight recorder's tail for this ticket's cohort (the ticket's
    own records plus id-less context: dispatches, resets, faults) so a
    chaos failure is self-explaining without a full trace."""

    def __init__(self, kind: str, *, ticket: int = -1, attempts: int = 0,
                 detail: str = "", cause: Exception | None = None,
                 recent_events: list | None = None):
        self.kind = kind
        self.ticket = ticket
        self.attempts = attempts
        self.detail = detail
        self.cause = cause
        self.recent_events = list(recent_events or [])
        msg = f"job {ticket} failed ({kind}) after {attempts} attempt(s)"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class AdmissionError(RuntimeError):
    """``submit()`` rejected: the service is over its admission budget
    (``admission="reject"``) — shed load upstream or retry later."""


@dataclasses.dataclass
class _Ticket:
    """One in-flight service job (internal)."""

    tid: int
    image: ProgramImage
    shared_init: Any
    threads: int
    tdx_dim: int
    tag: Any
    weight: float | None
    priority: int
    cost: float
    submit_t: float                  # monotonic, for latency accounting
    enqueue_t: float                 # reset on retry: batching trigger
    deadline: float | None           # absolute monotonic, or None
    future: Future
    attempts: int = 0
    not_before: float = 0.0          # backoff gate
    dispatch_t: float = 0.0          # last dispatch, for job latency
    phase: str = ""                  # traced: the open "queued" or "run"


def register_serve_metrics(reg: obs_metrics.MetricsRegistry,
                           window_s: float = 60.0) -> None:
    """Declare the serving-layer metric families (idempotent).
    ``window_s`` sets the rolling-SLO window on the latency
    histograms; the first registration of a family wins."""
    reg.counter("serve_submitted_total", "jobs admitted", ("priority",))
    reg.counter("serve_completed_total",
                "futures resolved with a JobResult", ("tier",))
    reg.counter("serve_failed_total",
                "futures resolved with a JobError", ("kind",))
    reg.counter("serve_rejected_total",
                "AdmissionError raised at submit")
    reg.counter("serve_lint_rejected_total",
                "programs the static verifier rejected at submit")
    reg.counter("serve_retries_total",
                "re-queues after a failed attempt", ("kind",))
    reg.counter("serve_dispatches_total",
                "cohorts handed to a scheduler, by device", ("device",))
    reg.counter("serve_dispatched_jobs_total",
                "jobs across all dispatched cohorts")
    reg.counter("serve_scheduler_resets_total",
                "schedulers abandoned (hang/crash)",
                ("reason", "device"))
    reg.counter("serve_watchdog_jobs_total",
                "jobs in cohorts abandoned by the dispatch watchdog")
    reg.gauge("serve_device_unhealthy",
              "1 when the device's dispatcher has retired", ("device",))
    reg.counter("serve_faults_injected_total",
                "FaultPlan injections observed", ("fault_site",))
    reg.gauge("serve_queue_depth", "jobs queued, not yet dispatched")
    reg.gauge("serve_pending_cost", "summed cost of queued jobs")
    reg.gauge("serve_inflight_cost", "summed cost of dispatched jobs")
    reg.histogram("serve_request_latency_seconds",
                  "submit -> future-resolution latency", ("outcome",),
                  window_s=window_s)
    reg.histogram("serve_job_latency_seconds",
                  "dispatch -> future-resolution latency",
                  window_s=window_s)
    reg.histogram("serve_cohort_size", "jobs per dispatched cohort",
                  buckets=obs_metrics.SIZE_BUCKETS)


class ServiceStats:
    """Aggregate serving counters (monotonic across the service life).

    Views over the service's
    :class:`~repro_torch.obs.metrics.MetricsRegistry` — the registry is the
    single source of truth (it also feeds the Prometheus exporter and
    :class:`~repro_torch.obs.metrics.MetricsSnapshot`), so these fields, the
    exported counters, and per-drain scheduler stats can never drift
    apart.  Field names and semantics are unchanged from the dataclass
    this replaces.
    """

    def __init__(self, registry: obs_metrics.MetricsRegistry | None
                 = None):
        self.registry = (registry if registry is not None
                         else obs_metrics.MetricsRegistry())
        register_serve_metrics(self.registry)
        #: set by :meth:`FleetService.close`: the final
        #: :class:`~repro_torch.obs.metrics.MetricsSnapshot` of the service
        self.final_snapshot: obs_metrics.MetricsSnapshot | None = None
        #: ... and the most recent flight-recorder blackbox dump path
        #: (``None`` when the service never dumped)
        self.blackbox_path: str | None = None

    def _t(self, name, **labels):
        return int(round(self.registry.total(name, **labels)))

    @property
    def submitted(self) -> int:
        return self._t("serve_submitted_total")

    @property
    def completed(self) -> int:
        return self._t("serve_completed_total")

    @property
    def failed(self) -> int:
        """Futures resolved with JobError."""
        return self._t("serve_failed_total")

    @property
    def rejected(self) -> int:
        """AdmissionError raised at submit."""
        return self._t("serve_rejected_total")

    @property
    def lint_rejected(self) -> int:
        """Programs the static verifier rejected at submit."""
        return self._t("serve_lint_rejected_total")

    @property
    def deadline_misses(self) -> int:
        """Failed with kind="deadline"."""
        return self._t("serve_failed_total", kind="deadline")

    @property
    def timeouts(self) -> int:
        """Dispatch watchdog firings (jobs)."""
        return self._t("serve_watchdog_jobs_total")

    @property
    def retries(self) -> int:
        """Re-queues after a failed attempt."""
        return self._t("serve_retries_total")

    @property
    def dispatches(self) -> int:
        """Cohorts handed to the scheduler."""
        return self._t("serve_dispatches_total")

    @property
    def dispatched_jobs(self) -> int:
        return self._t("serve_dispatched_jobs_total")

    @property
    def scheduler_resets(self) -> int:
        """Schedulers abandoned (hang/crash)."""
        return self._t("serve_scheduler_resets_total")

    @property
    def resolved(self) -> int:
        return self.completed + self.failed

    def __repr__(self) -> str:
        return (f"ServiceStats(submitted={self.submitted}, "
                f"completed={self.completed}, failed={self.failed}, "
                f"rejected={self.rejected}, retries={self.retries}, "
                f"scheduler_resets={self.scheduler_resets})")


class FleetService:
    """An always-on serving front-end over :class:`FleetScheduler`.

    One background dispatcher thread owns the scheduler; ``submit`` is
    thread-safe and never touches the device.  ``trace=`` accepts the
    same knob as :class:`~repro_torch.fleet.api.Fleet` (``True`` / path /
    :class:`~repro_torch.obs.Tracer`); serving events (``job_retry``,
    ``job_failed``, ``dispatch_timeout``, ``admission_reject``,
    ``tier_degrade``, ``fault_injected``) land in the same Perfetto
    trace as the drain spans, with per-request ``request`` async pairs
    measuring true submit->resolve latency (queue wait included).  Each
    pair holds, per attempt, a ``queued`` phase (submit or retry ->
    the dispatch of the cohort that carries it) and a ``run`` phase
    (that dispatch -> resolution or retry), on the tracer's clock.
    ``faults=`` installs a :class:`~repro_torch.fleet.faults.FaultPlan`
    for everything the dispatcher runs.  ``device`` is the card unless
    ``"cpu"`` is asked for (raising without a card, as ``Fleet`` does);
    ``devices=`` gives one pinned dispatcher a device instead.
    """

    def __init__(self, cfg: EGPUConfig, batch_size: int = 32, *,
                 max_delay_s: float = 0.005,
                 max_retries: int = 2, backoff_s: float = 0.002,
                 backoff_factor: float = 2.0,
                 dispatch_timeout_s: float | None = None,
                 default_deadline_s: float | None = None,
                 cost_budget: float | None = None,
                 max_pending: int | None = None,
                 admission: str = "block",
                 faults: faults_mod.FaultPlan | None = None,
                 trace: bool | str | obs_trace.Tracer | None = None,
                 pack_by_cost: bool = True, validate: bool = True,
                 use_compiler: bool = True, compile_min: int = 1,
                 tier_policy: TierPolicy | None = None,
                 residency_max: int = 32, fixed_bucket: bool = True,
                 telemetry: bool = True,
                 metrics: obs_metrics.MetricsRegistry | None = None,
                 recorder: obs_recorder.FlightRecorder | None = None,
                 recorder_capacity: int = 4096,
                 blackbox_dir: str | None = None,
                 slo_latency_s: float | None = None,
                 slo_target: float = 0.99,
                 slo_window_s: float = 60.0,
                 devices: Any = None,
                 device_unhealthy_after: int = 3,
                 device="cuda"):
        if admission not in ("block", "reject"):
            raise ValueError("admission must be 'block' or 'reject'")
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if device_unhealthy_after < 1:
            raise ValueError("device_unhealthy_after must be >= 1")
        self.cfg = cfg
        self.batch_size = batch_size
        self.max_delay_s = max_delay_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_factor = backoff_factor
        self.dispatch_timeout_s = dispatch_timeout_s
        self.default_deadline_s = default_deadline_s
        self.cost_budget = cost_budget
        self.max_pending = max_pending
        self.admission = admission
        self.faults = faults
        #: ``telemetry=False`` strips the optional instrumentation
        #: (latency histograms, gauges, flight recorder) — the baseline
        #: side of the CI overhead gate.  The registry itself stays:
        #: its counters ARE the stats store.
        self._tm = bool(telemetry)
        self.slo_latency_s = slo_latency_s
        self.slo_target = slo_target
        self.slo_window_s = slo_window_s
        #: one registry for the service's whole life — every watchdog
        #: replacement scheduler writes into it, so lifetime totals and
        #: per-drain counts cannot drift
        self.metrics = (metrics if metrics is not None
                        else obs_metrics.MetricsRegistry())
        register_serve_metrics(self.metrics, window_s=slo_window_s)
        #: always-on bounded ring of recent events, dumped as a
        #: Perfetto blackbox on watchdog reset / retry exhaustion /
        #: injected fault
        self.recorder: obs_recorder.FlightRecorder | None = None
        if self._tm:
            self.recorder = (recorder if recorder is not None
                             else obs_recorder.FlightRecorder(
                                 recorder_capacity,
                                 blackbox_dir=blackbox_dir))
        self.stats = ServiceStats(self.metrics)

        self.tracer: obs_trace.Tracer | None = None
        self._trace_path: str | None = None
        if isinstance(trace, obs_trace.Tracer):
            self.tracer = trace
        elif isinstance(trace, str):
            self.tracer = obs_trace.Tracer("service")
            self._trace_path = trace
        elif trace:
            self.tracer = obs_trace.Tracer("service")

        # all schedulers (incl. watchdog replacements) share one tracer
        # and one residency/compile-cache regime.  Serving defaults
        # differ from batch drains: ``compile_min=1`` (programs repeat
        # forever, so even a singleton group should ride the cached
        # compiled tier, not the interpreter) and ``fixed_bucket=True``
        # (one plan shape per program — ragged cohort sizes must not
        # spray pow2 bucket shapes, each a plan of graph captures,
        # across the steady-state latency profile)
        self._sched_kw = dict(pack_by_cost=pack_by_cost,
                              validate=validate,
                              use_compiler=use_compiler,
                              compile_min=compile_min,
                              tier_policy=tier_policy,
                              residency_max=residency_max,
                              fixed_bucket=fixed_bucket,
                              metrics=self.metrics)
        #: ``devices=None`` keeps the single dispatcher, pinned to
        #: ``device``; anything else resolves via
        #: :func:`~repro_torch.fleet.devices.fleet_devices` to one pinned
        #: dispatcher + scheduler per device, all fed from the shared
        #: admission queue
        self._devices: tuple = fleet_devices(
            device if devices is None else devices)
        # the step kernels' libraries, built now: a first dispatch's
        # watchdog must never read a cold nvcc build as a hang
        if any(d.type == "cuda" for d in self._devices):
            build.ensure(egpu_step.KERNELS)
        self._dev_labels = tuple(device_label(d) for d in self._devices)
        self.device_unhealthy_after = device_unhealthy_after
        self._scheds = [self._make_sched(i)
                        for i in range(len(self._devices))]
        self._fail_streak = [0] * len(self._devices)
        self._dead: set[int] = set()

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queue: list[_Ticket] = []
        self._pending_cost = 0.0         # queued, not yet dispatched
        self._inflight_cost = 0.0        # dispatched, not yet resolved
        self._next_tid = 0
        self._closed = False
        self._abandoned: list[threading.Thread] = []
        if self._tm:
            for lbl in self._dev_labels:
                self.metrics.set_gauge("serve_device_unhealthy", 0,
                                       device=lbl)
        self._threads = [
            threading.Thread(target=self._loop, args=(i,),
                             name=f"fleet-service-dispatch-{lbl}",
                             daemon=True)
            for i, lbl in enumerate(self._dev_labels)]
        for th in self._threads:
            th.start()

    def _make_sched(self, idx: int = 0) -> FleetScheduler:
        return FleetScheduler(self.cfg, self.batch_size,
                              trace=self.tracer,
                              device=self._devices[idx],
                              **self._sched_kw)

    @property
    def _sched(self) -> FleetScheduler:
        """The first dispatcher's scheduler (single-device compat)."""
        return self._scheds[0]

    @property
    def n_devices(self) -> int:
        return len(self._devices)

    @property
    def healthy_devices(self) -> tuple[str, ...]:
        """Labels of devices whose dispatchers are still serving."""
        with self._lock:
            return tuple(lbl for i, lbl in enumerate(self._dev_labels)
                         if i not in self._dead)

    def _event(self, name: str, cat: str = "serve", **args) -> None:
        """A serving event: into the flight recorder (always on) and
        the tracer (when installed)."""
        if self.recorder is not None:
            self.recorder.record(name, cat=cat, **args)
        if self.tracer is not None:
            self.tracer.event(name, cat=cat, **args)

    def _update_gauges(self) -> None:
        """Queue-shape gauges; caller holds the lock."""
        if not self._tm:
            return
        m = self.metrics
        m.set_gauge("serve_queue_depth", len(self._queue))
        m.set_gauge("serve_pending_cost", self._pending_cost)
        m.set_gauge("serve_inflight_cost", self._inflight_cost)

    # ----------------------------------------------------------- intake
    @property
    def pending(self) -> int:
        """Jobs queued but not yet dispatched (in-flight excluded)."""
        with self._lock:
            return len(self._queue)

    def _load_cost(self) -> float:
        return self._pending_cost + self._inflight_cost

    def _over_budget(self, cost: float) -> bool:
        if self.max_pending is not None \
                and len(self._queue) >= self.max_pending:
            return True
        return self.cost_budget is not None \
            and self._load_cost() + cost > self.cost_budget

    def submit(self, image: ProgramImage, shared_init=None, *,
               threads: int | None = None, tdx_dim: int = 16,
               tag: Any = None, weight: float | None = None,
               priority: int = 1,
               deadline_s: float | None = None) -> Future:
        """Queue one job; returns its future (``result()`` ->
        :class:`~repro_torch.fleet.scheduler.JobResult`, or raises
        :class:`JobError`).  Malformed inputs fail here, synchronously,
        with ``ValueError`` — never mid-drain.  ``deadline_s`` is
        relative to now (``default_deadline_s`` when ``None``); a job
        that cannot dispatch before its deadline is masked out of its
        batch and failed fast.  Over budget, ``submit`` blocks or
        raises :class:`AdmissionError` per the ``admission`` mode.
        Programs the static verifier proves broken raise
        :class:`JobError` (``kind="rejected"``) here, before any
        compile; the verifier's report rides on ``.cause.report``."""
        try:
            shared_init, threads = check_job(self.cfg, image, shared_init,
                                             threads, tdx_dim=tdx_dim)
        except Exception as e:
            diags = getattr(e, "diagnostics", None)
            if diags is None:
                raise
            self.metrics.inc("serve_lint_rejected_total")
            self._event("admission_lint_reject", prog_len=image.n,
                        errors=len(diags),
                        codes=",".join(sorted({d.code for d in diags})))
            raise JobError("rejected", detail=str(e), cause=e) from e
        cost = float(weight) if weight is not None \
            else float(image.static_cycle_estimate())
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        now = time.monotonic()
        with self._work:
            if self._closed:
                raise RuntimeError("service is closed")
            while self._over_budget(cost):
                if self.admission == "reject":
                    self.metrics.inc("serve_rejected_total")
                    self._event("admission_reject", cost=cost,
                                load=self._load_cost())
                    raise AdmissionError(
                        f"admission budget exceeded (load "
                        f"{self._load_cost():.0f} + job {cost:.0f} > "
                        f"budget {self.cost_budget}, pending "
                        f"{len(self._queue)})")
                self._work.wait(0.05)
                if self._closed:
                    raise RuntimeError("service is closed")
            tid = self._next_tid
            self._next_tid += 1
            now = time.monotonic()
            t = _Ticket(tid=tid, image=image, shared_init=shared_init,
                        threads=threads, tdx_dim=tdx_dim, tag=tag,
                        weight=weight, priority=priority, cost=cost,
                        submit_t=now, enqueue_t=now,
                        deadline=None if deadline_s is None
                        else now + deadline_s,
                        future=Future())
            self.metrics.inc("serve_submitted_total",
                             priority=priority)
            tr = self.tracer
            if tr is not None:
                # opened before the ticket is queued, so no dispatcher
                # can close its queue wait first
                ts = tr.now_us()
                tr.async_begin("request", id=tid, ts=ts,
                               priority=priority, cost=cost)
                tr.async_begin("queued", id=tid, ts=ts)
                t.phase = "queued"
            self._pending_cost += cost
            self._queue.append(t)
            self._update_gauges()
            self._work.notify_all()
        return t.future

    # ------------------------------------------------------- dispatcher
    def _loop(self, idx: int) -> None:
        with contextlib.ExitStack() as stack:
            # a fresh thread has a fresh context: install the service's
            # tracer, fault plan, flight recorder and metrics registry
            # for everything the dispatcher runs (drain threads inherit
            # via contextvars.copy_context)
            if self.tracer is not None:
                stack.enter_context(self.tracer)
            if self.faults is not None:
                stack.enter_context(self.faults)
            if self.recorder is not None:
                stack.enter_context(self.recorder.installed())
            stack.enter_context(self.metrics.installed())
            stack.enter_context(on_device(self._devices[idx]))
            while True:
                expired, cohort = [], []
                with self._work:
                    if idx in self._dead:
                        break            # retired: survivors take over
                    if self._closed and not self._queue:
                        break
                    now = time.monotonic()
                    expired = [t for t in self._queue
                               if t.deadline is not None
                               and now >= t.deadline]
                    if expired:
                        gone = {t.tid for t in expired}
                        self._queue = [t for t in self._queue
                                       if t.tid not in gone]
                        for t in expired:
                            self._pending_cost -= t.cost
                            self._inflight_cost += t.cost  # _fail releases
                        self._work.notify_all()
                    else:
                        ready = [t for t in self._queue
                                 if t.not_before <= now]
                        oldest = min((t.enqueue_t for t in ready),
                                     default=None)
                        full = len(ready) >= self.batch_size
                        due = oldest is not None \
                            and now - oldest >= self.max_delay_s
                        if ready and (full or due or self._closed):
                            ready.sort(key=lambda t: (t.priority, t.tid))
                            cohort = ready[:self.batch_size]
                            gone = {t.tid for t in cohort}
                            self._queue = [t for t in self._queue
                                           if t.tid not in gone]
                            for t in cohort:
                                self._pending_cost -= t.cost
                                self._inflight_cost += t.cost
                            self._update_gauges()
                        else:
                            self._work.wait(self._next_wake(now))
                            continue
                # futures resolve outside the lock (their callbacks may
                # re-enter submit)
                for t in expired:
                    self._fail(t, "deadline",
                               detail="deadline passed before dispatch")
                if cohort:
                    self._dispatch(cohort, idx)

    def _next_wake(self, now: float) -> float | None:
        """Seconds until the next scheduled trigger (batch-delay expiry,
        backoff release, or deadline), or ``None`` to wait for work."""
        nxt = None
        for t in self._queue:
            cands = [max(t.not_before, t.enqueue_t + self.max_delay_s)]
            if t.deadline is not None:
                cands.append(t.deadline)
            c = min(cands)
            nxt = c if nxt is None else min(nxt, c)
        if nxt is None:
            return None
        return max(1e-4, nxt - now)

    def _dispatch(self, cohort: list[_Ticket], idx: int = 0) -> None:
        m = self.metrics
        label = self._dev_labels[idx]
        if idx in self._dead:
            # killed between cohort formation and dispatch: hand the
            # cohort back untouched for a surviving device
            self._requeue_cohort(cohort)
            return
        if faults_mod.fire("device_fail", device=label) is not None:
            # whole-device death: the dispatcher retires and the cohort
            # re-enters the shared queue *without consuming an attempt*
            # — a dead device is capacity lost, not jobs failed
            if self._kill_device(idx, "device_fail"):
                self._requeue_cohort(cohort)
                return
            # refused: last healthy device keeps serving
        m.inc("serve_dispatches_total", device=label)
        m.inc("serve_dispatched_jobs_total", len(cohort))
        now = time.monotonic()
        if self._tm:
            m.observe("serve_cohort_size", len(cohort))
            self._event("dispatch", jobs=len(cohort),
                        queued=self.pending, device=label)
        for t in cohort:
            t.dispatch_t = now
        tr = self.tracer
        if tr is not None:
            ts = tr.now_us()
            for t in cohort:
                self._phase(t, "run", ts)
        sched = self._scheds[idx]
        try:
            handle2t = {
                sched.submit(t.image, t.shared_init, threads=t.threads,
                             tdx_dim=t.tdx_dim, tag=t.tag,
                             weight=t.weight): t
                for t in cohort}
            out = self._drain(sched)
        except Exception as e:
            # the scheduler itself misbehaved (not a contained per-unit
            # failure): abandon it — its internal queue may still hold
            # re-queued jobs — and retry the cohort on a fresh one
            self._reset_sched(idx, "drain_error", e)
            self._note_device_failure(idx)
            for t in cohort:
                self._retry_or_fail(t, "error", e)
            return
        if out is None:                  # watchdog fired: hung dispatch
            self._reset_sched(idx, "dispatch_timeout", None,
                              jobs=len(cohort))
            self.metrics.inc("serve_watchdog_jobs_total", len(cohort))
            self._note_device_failure(idx)
            for t in cohort:
                self._retry_or_fail(t, "timeout", None)
            return
        self._fail_streak[idx] = 0
        results, failures = out
        for h, t in handle2t.items():
            if h in results:
                self._complete(t, results[h])
            else:
                self._retry_or_fail(t, "error", failures.get(h))

    def _requeue_cohort(self, cohort: list[_Ticket]) -> None:
        """Return an undispatched cohort to the shared queue untouched:
        a device death is not the jobs' fault, so no attempt is consumed
        and no backoff applies (the jobs' deadlines still do)."""
        now = time.monotonic()
        with self._work:
            for t in cohort:
                self._inflight_cost -= t.cost
                self._pending_cost += t.cost
                t.enqueue_t = now
                self._queue.append(t)
            self._update_gauges()
            self._work.notify_all()

    def _note_device_failure(self, idx: int) -> None:
        """One more consecutive cohort failure on this device; at
        ``device_unhealthy_after`` in a row the device is retired (its
        jobs were already re-queued/retried by the caller)."""
        self._fail_streak[idx] += 1
        if self._fail_streak[idx] >= self.device_unhealthy_after:
            self._kill_device(idx, "unhealthy")

    def _kill_device(self, idx: int, why: str) -> bool:
        """Mark device ``idx`` unhealthy and retire its dispatcher.
        Refuses (returns False) when it is the last healthy device —
        degraded capacity must never become zero availability."""
        with self._work:
            if idx in self._dead:
                return True
            if all(i in self._dead or i == idx
                   for i in range(len(self._devices))):
                return False
            self._dead.add(idx)
            self._work.notify_all()
        label = self._dev_labels[idx]
        if self._tm:
            self.metrics.set_gauge("serve_device_unhealthy", 1,
                                   device=label)
        self._event("device_unhealthy", device=label, reason=why)
        if self.recorder is not None:
            path = self.recorder.dump(f"device_{why}", device=label)
            if path is not None:
                self.stats.blackbox_path = path
        return True

    def _drain(self, sched: FleetScheduler):
        """``drain_isolated`` with the watchdog: returns ``(results,
        failures)``, or ``None`` when the dispatch exceeded
        ``dispatch_timeout_s`` (the drain thread is abandoned; its late
        results are discarded along with its scheduler)."""
        if self.dispatch_timeout_s is None:
            return sched.drain_isolated()
        box: dict[str, Any] = {}
        ctx = contextvars.copy_context()   # carry tracer + fault plan

        def run():
            try:
                with on_device(sched.device):
                    box["out"] = ctx.run(sched.drain_isolated)
            except BaseException as e:     # noqa: BLE001 — relayed below
                box["err"] = e

        th = threading.Thread(target=run, daemon=True,
                              name="fleet-service-drain")
        th.start()
        th.join(self.dispatch_timeout_s)
        if th.is_alive():
            sched.cancel()   # orphan stops at its next unit boundary
            self._abandoned.append(th)
            return None
        if "err" in box:
            raise box["err"]
        return box["out"]

    def _reset_sched(self, idx: int, why: str, err: Exception | None,
                     **info) -> None:
        label = self._dev_labels[idx]
        self.metrics.inc("serve_scheduler_resets_total", reason=why,
                         device=label)
        self._event(why, error=type(err).__name__ if err else "",
                    device=label, **info)
        # the blackbox: the ring's last ~N events are exactly the
        # context a post-mortem of a hung/crashed scheduler needs
        if self.recorder is not None:
            path = self.recorder.dump(
                why, error=type(err).__name__ if err else "", **info)
            if path is not None:
                self.stats.blackbox_path = path
        self._scheds[idx] = self._make_sched(idx)

    # ------------------------------------------------------- resolution
    def _phase(self, t: _Ticket, phase: str, ts: float,
               **args) -> None:
        """Traced: close the request's open phase and open ``phase``
        (``""``: none, the ``request`` pair ends, with ``args``) at the
        one stamp ``ts``, so a request's phases tile its pair."""
        tr = self.tracer
        if t.phase:
            tr.async_end(t.phase, id=t.tid, ts=ts)
        t.phase = phase
        if phase:
            tr.async_begin(phase, id=t.tid, ts=ts)
        else:
            tr.async_end("request", id=t.tid, ts=ts, **args)

    def _release(self, t: _Ticket) -> None:
        with self._work:
            self._inflight_cost -= t.cost
            self._update_gauges()
            self._work.notify_all()

    def _observe_latency(self, t: _Ticket, outcome: str) -> None:
        if not self._tm:
            return
        now = time.monotonic()
        self.metrics.observe("serve_request_latency_seconds",
                             now - t.submit_t, outcome=outcome)
        if t.dispatch_t:
            self.metrics.observe("serve_job_latency_seconds",
                                 now - t.dispatch_t)

    def _complete(self, t: _Ticket, res: JobResult) -> None:
        t.attempts += 1
        self._release(t)
        self.metrics.inc("serve_completed_total", tier=res.tier)
        self._observe_latency(t, "ok")
        if self.tracer is not None:
            self._phase(t, "", self.tracer.now_us(), tier=res.tier,
                        attempts=t.attempts)
        t.future.set_result(res)

    def _retry_or_fail(self, t: _Ticket, kind: str,
                       cause: Exception | None) -> None:
        t.attempts += 1
        now = time.monotonic()
        missed = t.deadline is not None and now >= t.deadline
        if missed or t.attempts > self.max_retries:
            self._fail(t, "deadline" if missed else kind,
                       cause=cause,
                       detail="" if missed else
                       f"retries exhausted ({t.attempts} attempts)")
            return
        delay = self.backoff_s * self.backoff_factor ** (t.attempts - 1)
        t.not_before = now + delay
        if self.tracer is not None:      # the next attempt's queue wait
            self._phase(t, "queued", self.tracer.now_us())
        self.metrics.inc("serve_retries_total", kind=kind)
        self._event("job_retry", id=t.tid, attempts=t.attempts,
                    kind=kind, backoff_s=round(delay, 6))
        with self._work:
            self._inflight_cost -= t.cost
            self._pending_cost += t.cost
            t.enqueue_t = now
            self._queue.append(t)
            self._update_gauges()
            self._work.notify_all()

    def _fail(self, t: _Ticket, kind: str, *,
              cause: Exception | None = None, detail: str = "") -> None:
        self._release(t)
        self.metrics.inc("serve_failed_total", kind=kind)
        self._observe_latency(t, "error")
        self._event("job_failed", id=t.tid, kind=kind,
                    attempts=t.attempts)
        if self.tracer is not None:
            self._phase(t, "", self.tracer.now_us(), error=kind)
        recent: list = []
        if self.recorder is not None:
            # retry exhaustion is a production failure worth a blackbox
            # (deadline misses and shutdown drops are normal shedding)
            if kind in ("error", "timeout"):
                path = self.recorder.dump("retry_exhausted",
                                          ticket=t.tid, kind=kind)
                if path is not None:
                    self.stats.blackbox_path = path
            recent = self.recorder.recent_for(t.tid)
        t.future.set_exception(JobError(
            kind, ticket=t.tid, attempts=t.attempts, detail=detail,
            cause=cause, recent_events=recent))

    # --------------------------------------------------------- shutdown
    def close(self, wait: bool = True,
              timeout: float | None = None) -> None:
        """Stop the service.  ``wait=True`` (default) drains everything
        still queued (deadlines and retries still apply) before the
        dispatcher exits; ``wait=False`` fails queued jobs fast with
        ``JobError(kind="shutdown")``.  Idempotent."""
        with self._work:
            self._closed = True
            dropped = []
            if not wait:
                dropped, self._queue = self._queue, []
                for t in dropped:
                    self._pending_cost -= t.cost
                    self._inflight_cost += t.cost  # _fail releases it
            self._work.notify_all()
        for t in dropped:
            self._fail(t, "shutdown", detail="service closed")
        for th in self._threads:
            th.join(timeout)
        # give watchdog-abandoned drains a bounded chance to finish so
        # the interpreter doesn't tear down under a live dispatch (a
        # truly wedged one stays a daemon and is dropped with the
        # process)
        for th in self._abandoned:
            th.join(2.0)
        self._abandoned = [th for th in self._abandoned if th.is_alive()]
        if self._trace_path is not None and self.tracer is not None:
            self.tracer.save(self._trace_path)
        # flush the service's final telemetry into the stats object so
        # a closed service remains fully inspectable (and the blackbox
        # path survives the recorder)
        snap = self.metrics.snapshot()
        snap.meta["slo"] = self.slo_status(snap)
        if self.recorder is not None and self.recorder.dumps:
            self.stats.blackbox_path = self.recorder.dumps[-1]
            snap.meta["blackbox_path"] = self.stats.blackbox_path
        self.stats.final_snapshot = snap

    def slo_status(self, snapshot: obs_metrics.MetricsSnapshot | None
                   = None) -> dict:
        """Rolling-window latency percentiles and error-budget burn.

        ``burn`` (present when ``slo_latency_s`` is set) counts a
        request as *bad* when it resolved with an error — however fast
        — or completed slower than ``slo_latency_s``; the rate is the
        bad fraction over the window divided by the budget
        ``1 - slo_target`` (1.0 = burning exactly at budget).
        """
        snap = snapshot if snapshot is not None \
            else self.metrics.snapshot()
        name = "serve_request_latency_seconds"
        out = {
            "window_s": self.slo_window_s,
            "request_p50_s": snap.percentile(name, 0.50, window=True),
            "request_p99_s": snap.percentile(name, 0.99, window=True),
            "job_p50_s": snap.percentile(
                "serve_job_latency_seconds", 0.50, window=True),
            "job_p99_s": snap.percentile(
                "serve_job_latency_seconds", 0.99, window=True),
            "lifetime_request_p99_s": snap.percentile(name, 0.99),
        }
        if self.slo_latency_s is not None:
            total = snap.hist_count(name, window=True)
            good = snap.count_le(name, self.slo_latency_s,
                                 window=True, outcome="ok")
            bad_frac = (1.0 - good / total) if total else 0.0
            out.update(
                slo_latency_s=self.slo_latency_s,
                slo_target=self.slo_target,
                window_requests=total,
                window_good=good,
                burn=bad_frac / max(1e-9, 1.0 - self.slo_target))
        return out

    def save_trace(self, path: str) -> None:
        """Write the service tracer's Chrome/Perfetto trace JSON."""
        if self.tracer is None:
            raise ValueError("service was created without trace=")
        self.tracer.save(path)

    def __enter__(self) -> "FleetService":
        return self

    def __exit__(self, *exc) -> bool:
        self.close(wait=exc == (None, None, None))
        return False
