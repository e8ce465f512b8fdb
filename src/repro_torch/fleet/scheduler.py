"""Work-queue scheduler: pack heterogeneous jobs into fleet batches (the
port of ``repro.fleet.scheduler``).

``submit()`` enqueues jobs — each with its own program, shared-memory
image, runtime thread count and TDX grid — and ``drain()`` packs them
into fixed-shape batches of ``batch_size`` cores, runs each batch as one
lock-step fleet (:func:`repro_torch.fleet.engine.fleet_run`, or a
compiled tier's CUDA graphs for a same-program group) and scatters
per-job results back by handle.

Invariants the layers above build on (see ``docs/architecture.md``):

* **one delivery per job** — every submitted handle appears in exactly
  one drain's results (or, under ``drain_isolated``, in exactly one of
  results/failures), even across drain crashes: unprocessed jobs
  re-queue, computed results stash and deliver next drain;
* **checksummed salvage** — a result stashed across a failed drain is
  content-checksummed when stashed and re-verified at delivery; a
  corrupted result is dropped and its job re-executed, never served;
* **bit-identical tiers** — a job's architectural outputs (shared
  image, cycles, steps) are identical whichever tier runs it, so tier
  choice, degradation and bisection are pure performance decisions;
* **admission lint precedes compile** — ``submit`` rejects
  statically-broken programs (``ProgramVerificationError``) before any
  compile or dispatch sees them;
* **the card unless told otherwise** — a scheduler runs every batch
  on ``device`` (the card by default, raising without one; tests pass
  ``"cpu"``): inputs, graphs and metrics labels are its device's.

Packing rules:

* programs are padded to the shared ``_PAD`` grid (the batch's trace
  is as long as its longest program's padded length);
* jobs are packed heaviest-first by a cost ``weight`` (caller-supplied
  hint, defaulting to padded program length) so jobs of similar cost
  share a batch — lock-step cores finish together instead of idling
  behind one straggler;
* a trailing partial batch is padded with trivial STOP jobs, keeping the
  batch shape fixed.

The batch's initial leaves are built host-side in one NumPy pass and
handed to the sequencer as host arrays (the interpreter tier reads them
there; nothing crosses to the card and back), and results come back one
device transfer per leaf — per-job Python overhead is what a throughput
engine lives or dies by.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any

import numpy as np
import torch

from ..analysis import ProgramVerificationError, analyze_cached
from ..core import isa
from ..core import machine as machine_mod
from ..core.assembler import Asm, ProgramImage
from ..core.blockc import (BlockCompileError, TierPolicy, compile_program,
                           default_policy_for_device, normalize_threads,
                           program_key)
from ..core.config import EGPUConfig
from ..core.executor import padded_length
from ..core.machine import MachineState, resolve_device
from ..obs import counters as obs_counters
from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..obs import trace as obs_trace
from ..obs.counters import EventCounters
from . import faults
from .devices import device_label
from .engine import ResidencyCache, fleet_run


def check_job(cfg: EGPUConfig, image: ProgramImage, shared_init,
              threads: int | None, *, tdx_dim: int = 16,
              lint: bool = True) -> tuple[np.ndarray | None, int]:
    """Validate one job's inputs against ``cfg`` **at submission time**,
    so a malformed job fails fast with a clear ``ValueError`` instead of
    a deep torch/NumPy shape or cast error mid-drain (where it would
    take its whole batch down with it).  Returns the coerced
    ``(shared_init, threads)`` pair.  Used by :meth:`FleetScheduler.submit`
    (and by the reference's serving front-end, not ported yet).

    With ``lint=True`` (the default) the whole-program static verifier
    (:func:`repro_torch.analysis.analyze`) also runs — cached per
    (config, program, threads) — and ERROR-level findings (out-of-image
    branch targets, undefined TSC width codings, stack
    underflow/overflow, proven out-of-bounds accesses, programs that
    cannot halt) raise
    :class:`repro_torch.analysis.ProgramVerificationError`, a ``ValueError``
    subclass carrying the structured diagnostics, *before* any compile
    or dispatch touches the job."""
    # Per-image memo: the steady-state submit path costs one attribute
    # probe, not a bytes-keyed cache hash (ProgramImage is a plain
    # dataclass, so the instance dict is writable).  A hit also proves
    # the (cfg, threads) pair already passed the config/thread checks
    # below — same cfg object, same arguments — so the warm path skips
    # re-validating them.
    if lint:
        try:
            memo = image._lint_memo
        except AttributeError:
            memo = None
        if memo is not None and memo[0] is cfg and memo[1] == threads \
                and memo[2] == tdx_dim:
            if not memo[4]:
                raise ProgramVerificationError(memo[5])
            threads = memo[3]
            if shared_init is None:
                return None, threads
            arr = np.asarray(shared_init)
            if arr.dtype.kind not in "fiub":
                raise ValueError(
                    f"shared_init dtype {arr.dtype} is not packable into "
                    f"32-bit shared-memory words; pass float/int/uint data")
            if arr.size > cfg.shared_words:
                raise ValueError(
                    f"shared_init ({arr.size} words) exceeds "
                    f"{cfg.shared_words}")
            return arr, threads
    if image.cfg != cfg:
        raise ValueError("job config does not match the fleet config")
    raw_threads = threads
    threads = normalize_threads(image, threads)
    if threads > cfg.max_threads or threads % cfg.num_sps:
        raise ValueError(f"bad runtime thread count {threads}")
    if lint:
        report = analyze_cached(image, threads, tdx_dim=tdx_dim)
        image._lint_memo = (cfg, raw_threads, tdx_dim, threads,
                           report.ok, report)
        if not report.ok:
            raise ProgramVerificationError(report)
    if shared_init is None:
        return None, threads
    arr = np.asarray(shared_init)
    if arr.dtype.kind not in "fiub":
        raise ValueError(
            f"shared_init dtype {arr.dtype} is not packable into 32-bit "
            f"shared-memory words; pass float/int/uint data")
    if arr.size > cfg.shared_words:
        raise ValueError(
            f"shared_init ({arr.size} words) exceeds "
            f"{cfg.shared_words}")
    return arr, threads


class DrainCancelled(RuntimeError):
    """Raised inside a drain whose scheduler was :meth:`cancelled
    <FleetScheduler.cancel>` — a serving watchdog abandons a hung drain
    this way so the orphaned thread stops at the next unit boundary
    instead of grinding through (and capturing graphs for) the rest of
    the queue nobody will read."""


def _prog_digest(image: ProgramImage) -> str:
    """Short content digest of a program — the ``program`` metric
    label (bounded cardinality: one value per distinct program)."""
    return hashlib.blake2b(program_key(image),
                           digest_size=4).hexdigest()


def _result_checksum(res: "JobResult") -> bytes:
    """Content digest of a result's architectural outputs — computed
    when a salvaged result is stashed across drains and re-verified at
    delivery, so silent corruption while stashed is detected (and the
    job re-executed) instead of served."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(res.shared).tobytes())
    h.update(int(res.cycles).to_bytes(8, "little", signed=True))
    h.update(int(res.steps).to_bytes(8, "little", signed=True))
    return h.digest()


@dataclasses.dataclass
class FleetJob:
    """One queued unit of work."""

    handle: int
    image: ProgramImage
    shared_init: np.ndarray | None
    threads: int
    tdx_dim: int
    tag: Any = None
    weight: float | None = None      # cost hint for batch packing

    @property
    def padded_len(self) -> int:
        return padded_length(self.image.n)

    @property
    def cost(self) -> float:
        return self.weight if self.weight is not None else self.padded_len


@dataclasses.dataclass
class JobResult:
    """Per-job outcome, sliced out of the batched fleet state."""

    handle: int
    tag: Any
    cycles: int
    steps: int
    time_us: float
    hazard_violations: int
    shared: np.ndarray               # (S,) uint32
    stat_cycles: np.ndarray          # (NUM_OP_CLASSES,) int32
    stat_instrs: np.ndarray
    #: execution tier that ran the job ("interp"/"blocks"/"superblock")
    tier: str = "interp"
    #: baked per-core event counters (compiled tiers always; interpreter
    #: tier only under tracing — they cost a host-side path walk there)
    counters: EventCounters | None = None

    def shared_u32(self) -> np.ndarray:
        return self.shared

    def shared_f32(self) -> np.ndarray:
        return self.shared.view(np.float32)

    def shared_i32(self) -> np.ndarray:
        return self.shared.view(np.int32)

    def profile(self) -> dict[str, tuple[int, int]]:
        return {c.name: (int(self.stat_cycles[c]), int(self.stat_instrs[c]))
                for c in isa.OpClass}


def _int_view(doc):
    """A FleetStats/ServiceStats int field backed by registry counters."""
    def deco(fn):
        def get(self):
            return int(round(fn(self)))
        get.__doc__ = doc
        return property(get)
    return deco


class FleetStats:
    """Aggregate counters across every drain of a scheduler.

    These are **views over a**
    :class:`~repro_torch.obs.metrics.MetricsRegistry` — the registry is
    the single source of truth (one store feeds the Prometheus
    exporter, the snapshot API, and these fields), and a registry
    shared by several schedulers (``metrics=``) keeps lifetime totals
    that cannot drift from per-drain counts.
    """

    def __init__(self, registry: obs_metrics.MetricsRegistry | None
                 = None):
        self.registry = (registry if registry is not None
                         else obs_metrics.MetricsRegistry())
        register_fleet_metrics(self.registry)

    def _t(self, name, **labels):
        return self.registry.total(name, **labels)

    @_int_view("jobs executed (each counted once, when its batch runs)")
    def jobs(self):
        return self._t("fleet_jobs_total")

    @_int_view("batches dispatched, all tiers")
    def batches(self):
        return self._t("fleet_batches_total")

    @_int_view("filler lanes across all batches")
    def pad_slots(self):
        return self._t("fleet_pad_slots_total")

    @_int_view("architectural cycles across all jobs")
    def total_cycles(self):
        return self._t("fleet_cycles_total")

    @_int_view("instructions executed across all jobs")
    def total_steps(self):
        return self._t("fleet_steps_total")

    @property
    def wall_s(self) -> float:
        """Wall time of batch *execution* (input build + dispatch +
        sync + collect); one-time compile cost is split into
        ``compile_s``."""
        return self._t("fleet_wall_seconds_total")

    @property
    def compile_s(self) -> float:
        """Compile seconds (block compiles, the compiled tiers' graph
        warm-ups and captures, and any first-use build of the step
        kernels' CUDA libraries) — kept out of ``wall_s`` so
        warm-vs-cold throughput comparisons measure execution, not
        compilation."""
        return self._t("fleet_compile_seconds_total")

    @_int_view("jobs run on either compiled tier")
    def compiled_jobs(self):
        return (self._t("fleet_jobs_total", tier="blocks")
                + self._t("fleet_jobs_total", tier="superblock"))

    @_int_view("batches run on either compiled tier")
    def compiled_batches(self):
        return (self._t("fleet_batches_total", tier="blocks")
                + self._t("fleet_batches_total", tier="superblock"))

    @_int_view("jobs run on the superblock tier")
    def superblock_jobs(self):
        return self._t("fleet_jobs_total", tier="superblock")

    @_int_view("batches run on the superblock tier")
    def superblock_batches(self):
        return self._t("fleet_batches_total", tier="superblock")

    @_int_view("compiled-tier batches replayed from device-resident "
               "inputs (zero host->device transfer)")
    def residency_hits(self):
        return self._t("fleet_residency_lookups_total", result="hit")

    @_int_view("compiled-tier batches rebuilt and transferred")
    def residency_misses(self):
        return self._t("fleet_residency_lookups_total", result="miss")

    @_int_view("results computed by a failed drain and delivered by a "
               "later one — already counted in jobs/wall_s when "
               "computed, so a per-drain consumer can subtract them "
               "instead of double-dipping")
    def salvaged_jobs(self):
        return self._t("fleet_salvaged_jobs_total")

    @_int_view("units that fell down the tier chain (superblock -> "
               "blocks -> interpreter) after a compile or dispatch "
               "failure, instead of failing the drain")
    def degraded_units(self):
        return self._t("fleet_degraded_units_total")

    @_int_view("failing batches split in half by the isolated drain "
               "so one poison job cannot starve its cohort")
    def bisections(self):
        return self._t("fleet_bisections_total")

    @_int_view("stashed salvaged results that failed their delivery "
               "checksum — dropped and re-executed, never served")
    def salvage_dropped(self):
        return self._t("fleet_salvage_dropped_total")

    @property
    def jobs_per_sec(self) -> float:
        """Aggregate throughput over every batch actually *run*: each
        job is counted exactly once, when its batch executes — delivery
        of salvaged results adds neither jobs nor wall time."""
        wall = self.wall_s
        return self.jobs / wall if wall else 0.0

    def per_device(self) -> dict[str, dict[str, int]]:
        """``{device_label: {"jobs": ..., "batches": ...}}`` across
        every device this registry has seen, by
        :func:`~repro_torch.fleet.devices.device_label`."""
        snap = self.registry.snapshot()
        out: dict[str, dict[str, int]] = {}
        for name, field in (("fleet_jobs_total", "jobs"),
                            ("fleet_batches_total", "batches")):
            m = snap._metric(name)
            if m is None:
                continue
            for s in m["samples"]:
                dev = s["labels"].get("device", "default")
                out.setdefault(dev, {"jobs": 0, "batches": 0})
                out[dev][field] += int(round(s["value"]))
        return out

    def __repr__(self) -> str:
        return (f"FleetStats(jobs={self.jobs}, batches={self.batches}, "
                f"wall_s={self.wall_s:.4f}, "
                f"compile_s={self.compile_s:.4f}, "
                f"compiled_jobs={self.compiled_jobs}, "
                f"superblock_jobs={self.superblock_jobs})")


def register_fleet_metrics(reg: obs_metrics.MetricsRegistry) -> None:
    """Declare the fleet-layer metric families (idempotent) so help
    text and label sets exist even before the first increment."""
    reg.counter("fleet_jobs_total",
                "jobs executed, by tier, program digest and device",
                ("tier", "program", "device"))
    reg.counter("fleet_batches_total",
                "batches dispatched, by tier, program digest and device",
                ("tier", "program", "device"))
    reg.counter("fleet_pad_slots_total", "filler lanes padded in")
    reg.counter("fleet_cycles_total", "architectural cycles retired")
    reg.counter("fleet_steps_total", "instructions executed")
    reg.counter("fleet_wall_seconds_total",
                "batch execution wall time (compile excluded)")
    reg.counter("fleet_compile_seconds_total",
                "host compile + graph capture + kernel build seconds")
    reg.counter("fleet_residency_lookups_total",
                "device-resident input lookups", ("result",))
    reg.counter("fleet_compile_cache_total",
                "light-path graph plan lookups", ("result",))
    reg.counter("fleet_salvaged_jobs_total",
                "salvaged results delivered by a later drain")
    reg.counter("fleet_salvage_dropped_total",
                "salvaged results dropped on checksum mismatch")
    reg.counter("fleet_degraded_units_total",
                "units degraded down the tier chain",
                ("from_tier", "to_tier"))
    reg.counter("fleet_bisections_total",
                "failing batches bisected by the isolated drain")
    reg.histogram("fleet_dispatch_seconds",
                  "dispatch wall per batch", ("tier", "device"))
    reg.histogram("fleet_device_sync_seconds",
                  "device sync wall per batch", ("tier", "device"))


def _batch_init_state(cfg: EGPUConfig, jobs: list[FleetJob]) -> list[dict]:
    """The batch's initial leaves, built in one NumPy pass: one dict of
    numpy arrays a core, in the reference's dtypes, as views of the
    batched arrays (leaf-for-leaf identical to ``init_numpy`` a job,
    sharing its shared-image packing and hazard-row constants)."""
    n = len(jobs)
    T, R, S = cfg.max_threads, cfg.regs_per_thread, cfg.shared_words
    D = max(1, cfg.predicate_levels)
    shared = np.zeros((n, S), np.uint32)
    for i, job in enumerate(jobs):
        if job.shared_init is None:
            continue
        buf = machine_mod.pack_shared_init(job.shared_init, S)
        shared[i, :buf.size] = buf
    i32 = lambda shape: np.zeros((n,) + shape, np.int32)
    batched = dict(
        regs=np.zeros((n, T, R), np.uint32),
        shared=shared,
        pstack=np.zeros((n, T, D), np.bool_),
        pdepth=i32((T,)),
        lctr=i32((cfg.max_loop_depth,)),
        lsp=i32(()),
        cstack=i32((cfg.max_call_depth,)),
        csp=i32(()),
        pc=i32(()),
        cycles=i32(()),
        steps=i32(()),
        halted=np.zeros((n,), np.bool_),
        threads_active=np.asarray([j.threads for j in jobs], np.int32),
        tdx_dim=np.asarray([j.tdx_dim for j in jobs], np.int32),
        stat_cycles=i32((isa.NUM_OP_CLASSES,)),
        stat_instrs=i32((isa.NUM_OP_CLASSES,)),
        hazard=np.broadcast_to(machine_mod.hazard_init(R), (n, R + 2, 4)),
        hazard_violations=i32(()),
    )
    return [{k: v[i] for k, v in batched.items()} for i in range(n)]


class FleetScheduler:
    """FIFO-with-packing job queue over a homogeneous fleet.

    Jobs are executed on one of three tiers:

    * **superblock** — same-program jobs (identical instruction words,
      identical runtime thread count) are grouped into lock-step batches
      that run the compiler's batched **light path**
      (:meth:`repro_torch.core.blockc.CompiledProgram.run_light_dev` —
      only the shared image comes back; cycles/stats/hazards are baked
      from the static path simulation); the
      :class:`~repro_torch.core.blockc.TierPolicy` cost model picks the
      superblock runner whenever the batch width or the dispatch savings
      amortize its fixed cost — one CUDA graph a straight line of the
      folded schedule, a loop body's graph replayed ``count`` times;
    * **block-compiled** — same-program groups the cost model routes to
      the basic-block driver instead (one graph a block dispatch; over
      the trace budget, or too small to amortize;
      ``stats.superblock_batches`` vs ``stats.compiled_batches`` shows
      the split);
    * **interpreter** — everything else (mixed leftovers, groups smaller
      than ``compile_min``, programs the compiler rejects) is packed into
      heterogeneous lock-step ``fleet_run`` batches.

    Both compiled tiers keep their batch inputs **device-resident**
    across drains (:class:`~repro_torch.fleet.engine.ResidencyCache`): a
    repeat drain of the same program over the same inputs replays the
    already-transferred device tensors — zero host->device transfer —
    and reports the replays in ``stats.residency_hits``.

    Results are bit-identical on every tier, and to the reference's.
    """

    def __init__(self, cfg: EGPUConfig, batch_size: int = 32, *,
                 pack_by_cost: bool = True, validate: bool = True,
                 use_compiler: bool = True, compile_min: int = 2,
                 tier_policy: TierPolicy | None = None,
                 residency_max: int = 32, fixed_bucket: bool = False,
                 trace: bool | str | obs_trace.Tracer | None = None,
                 metrics: obs_metrics.MetricsRegistry | None = None,
                 device="cuda"):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        #: ``trace=True`` records every drain into ``self.tracer``;
        #: a path string additionally writes the cumulative trace JSON
        #: after each successful drain; a :class:`~repro_torch.obs.Tracer`
        #: instance records into that tracer.  An ambient tracer
        #: (``with Tracer():`` around ``drain()``) works regardless.
        self.tracer: obs_trace.Tracer | None = None
        self._trace_path: str | None = None
        if isinstance(trace, obs_trace.Tracer):
            self.tracer = trace
        elif isinstance(trace, str):
            self.tracer = obs_trace.Tracer("fleet")
            self._trace_path = trace
        elif trace:
            self.tracer = obs_trace.Tracer("fleet")
        self.cfg = cfg
        self.batch_size = batch_size
        self.pack_by_cost = pack_by_cost
        self.validate = validate
        self.use_compiler = use_compiler
        self.compile_min = compile_min
        #: ``device=`` runs every batch (interpreter and compiled tier)
        #: on one torch device: the card unless ``"cpu"`` is asked for
        #: (raising without a card, never falling back).  Inputs and
        #: graphs live there, and metrics/fault-site info carry its
        #: label.  With no explicit ``tier_policy`` the scheduler takes
        #: the table registered for its device's kind (the ``"gpu"``
        #: prior on the card; see
        #: :func:`repro_torch.core.blockc.default_policy_for_device`).
        self.device = resolve_device(device)
        self._dev = device_label(self.device)
        if tier_policy is None:
            tier_policy = default_policy_for_device(self.device)
        self.tier_policy = tier_policy
        #: pad every compiled-tier unit to the full ``batch_size`` lanes
        #: instead of the next power of two.  Pow2 bucketing minimizes
        #: wasted lanes for one-shot batch drains, but every distinct
        #: (program, bucket) shape is a separate plan of static buffers
        #: and graph captures — under continuous batching, where cohort
        #: sizes vary with arrival timing, that open-ended shape set
        #: turns into recurring capture storms.  A fixed bucket caps it
        #: at ONE shape per program: the reference's serving default.
        self.fixed_bucket = fixed_bucket
        #: ``metrics=`` shares one registry across schedulers (so a
        #: replacement scheduler's lifetime totals never reset)
        self.stats = FleetStats(metrics)
        self._m = self.stats.registry
        self._queue: list[FleetJob] = []
        self._next_handle = 0
        self._filler_image: ProgramImage | None = None
        #: device-resident compiled-tier inputs, replayed across drains
        self._residency = ResidencyCache(residency_max)
        #: results computed by a drain that later failed — delivered by
        #: the next drain so completed work is never lost.  Each stashed
        #: result carries a content checksum (verified at delivery: a
        #: corrupted result is dropped and its job re-executed) and the
        #: FleetJob that produced it (so a drop can re-queue it).
        self._salvaged: dict[int, JobResult] = {}
        self._salvage_sums: dict[int, bytes] = {}
        self._salvage_jobs: dict[int, FleetJob] = {}
        self._cancelled = False

    def cancel(self) -> None:
        """Ask an in-flight ``drain`` (possibly on another thread) to
        abort at the next unit boundary (:class:`DrainCancelled`; the
        crash-safe re-queue/salvage path runs as for any failure).  The
        unit already executing cannot be interrupted — a batch's issue
        and a graph capture run to their end — but nothing further
        starts."""
        self._cancelled = True

    # ------------------------------------------------------------- queue
    def submit(self, image: ProgramImage, shared_init=None, *,
               threads: int | None = None, tdx_dim: int = 16,
               tag: Any = None, weight: float | None = None) -> int:
        """Enqueue a job; returns its handle (stable across drains).

        Inputs are validated here (:func:`check_job`), so a malformed
        ``shared_init`` (wrong dtype, over-length) or thread count is a
        clear ``ValueError`` at submission, never a mid-drain batch
        failure; statically broken programs raise
        :class:`~repro_torch.analysis.ProgramVerificationError` (also a
        ``ValueError``) with the verifier's diagnostics attached."""
        try:
            shared_init, threads = check_job(self.cfg, image, shared_init,
                                             threads, tdx_dim=tdx_dim)
        except Exception as e:
            diags = getattr(e, "diagnostics", None)
            if diags is not None:
                self._event("admission_lint_reject", prog_len=image.n,
                            errors=len(diags),
                            codes=",".join(sorted({d.code for d in diags})))
            raise
        handle = self._next_handle
        self._next_handle += 1
        self._queue.append(FleetJob(
            handle=handle, image=image, shared_init=shared_init,
            threads=threads, tdx_dim=tdx_dim, tag=tag, weight=weight))
        tr = self._trace()
        if tr is not None:              # open the submit->deliver pair
            tr.async_begin("job", id=handle, prog_len=image.n,
                           threads=threads)
        return handle

    def _trace(self) -> obs_trace.Tracer | None:
        """The ambient tracer if one is installed, else the fleet's own
        (``trace=`` knob) — ``None`` disables all per-job recording."""
        tr = obs_trace.current_tracer()
        return tr if tr is not None else self.tracer

    def _event(self, name: str, cat: str = "event", **args) -> None:
        """An anomaly/decision event: always into the ambient flight
        recorder (bounded ring, so failures ship with context), and
        into the tracer when one is installed."""
        obs_recorder.record(name, cat=cat, **args)
        tr = self._trace()
        if tr is not None:
            tr.event(name, cat=cat, **args)

    @property
    def pending(self) -> int:
        return len(self._queue)

    # ------------------------------------------------------------- drain
    def _filler(self) -> FleetJob:
        """A do-nothing job used to pad partial batches to fixed shape."""
        if self._filler_image is None:
            a = Asm(self.cfg)
            a.stop()
            self._filler_image = a.assemble(threads_active=self.cfg.num_sps)
        return FleetJob(handle=-1, image=self._filler_image,
                        shared_init=None, threads=self.cfg.num_sps,
                        tdx_dim=16)

    def _batches(self, jobs: list[FleetJob]) -> list[list[FleetJob]]:
        if self.pack_by_cost:
            jobs = sorted(jobs, key=lambda j: -j.cost)
        return [jobs[i:i + self.batch_size]
                for i in range(0, len(jobs), self.batch_size)]

    def _split_compilable(self, jobs: list[FleetJob]):
        """Partition the queue into same-program groups big enough for
        the compiled tier, and the mixed remainder."""
        groups: dict[tuple, list[FleetJob]] = {}
        for j in jobs:
            groups.setdefault((program_key(j.image), j.threads),
                              []).append(j)
        compiled: list[tuple[Any, list[FleetJob]]] = []
        rest: list[FleetJob] = []
        for group in groups.values():
            if len(group) < self.compile_min:
                rest.extend(group)
                continue
            # the tier policy sees the width the group will actually
            # run at (its dominant pow2-bucketed chunk size): wide
            # lock-step batches amortize driver overhead differently
            # than single cores, and the cost model knows it
            hint = self.batch_size if self.fixed_bucket else \
                self._bucket(min(len(group), self.batch_size),
                             self.batch_size)
            cp = self._compile_unit(group[0], hint, jobs=len(group))
            if cp is None:
                rest.extend(group)
                continue
            self._event("tier_group", program=_prog_digest(cp.image),
                        jobs=len(group), threads=cp.threads,
                        batch_hint=hint, tier=cp.mode)
            compiled.append((cp, group))
        return compiled, rest

    def _compile_unit(self, job: FleetJob, hint: int, *,
                      jobs: int = 1):
        """Compile one same-program group for the compiled tier, with
        **per-unit graceful degradation**: a compile failure at the
        chosen tier (injected via the ``compile`` fault site, or a real
        unexpected exception) falls down the tier chain — superblock ->
        blocks -> interpreter — instead of failing the whole drain.
        Returns ``None`` for the interpreter tier.  Programs the
        compiler legitimately rejects (:class:`BlockCompileError`) go
        straight to the interpreter, as before."""
        tried = "auto"
        for mode in ("auto", "blocks"):
            t0 = time.perf_counter()
            try:
                cp = compile_program(job.image, job.threads,
                                     validate=self.validate,
                                     policy=self.tier_policy,
                                     batch_hint=hint, mode=mode)
                self._m.inc("fleet_compile_seconds_total",
                            time.perf_counter() - t0)
                tried = cp.mode
                faults.maybe_raise("compile", tier=cp.mode)
                return cp
            except BlockCompileError:
                self._m.inc("fleet_compile_seconds_total",
                            time.perf_counter() - t0)
                return None           # uncompilable: interpreter tier
            except Exception as e:
                self._m.inc("fleet_compile_seconds_total",
                            time.perf_counter() - t0)
                # "blocks" already failed (either auto picked it, or
                # this was the forced-blocks retry): end of the chain
                if mode == "blocks" or tried == "blocks":
                    self._degrade(tried, "interp", jobs, e)
                    return None
                self._degrade(tried, "blocks", jobs, e)
        return None

    def _degrade(self, from_tier: str, to_tier: str, jobs: int,
                 err: Exception | None) -> None:
        self._m.inc("fleet_degraded_units_total",
                    from_tier=from_tier, to_tier=to_tier)
        self._event("tier_degrade", cat="serve", from_tier=from_tier,
                    to_tier=to_tier, jobs=jobs,
                    error=type(err).__name__ if err else "")

    def _collect(self, final: MachineState, batch: list[FleetJob],
                 real: int, wall: float,
                 results: dict[int, JobResult]) -> None:
        """Slice per-job results out of a batched final state (one host
        transfer per leaf, then pure-NumPy scatter to jobs).  ``shared``
        comes back as uint32 words, the reference's dtype."""
        host = lambda t: t.cpu().numpy()
        shared = host(final.shared).view(np.uint32)
        cycles = host(final.cycles)
        steps = host(final.steps)
        hv = host(final.hazard_violations)
        stat_c = host(final.stat_cycles)
        stat_i = host(final.stat_instrs)
        tr = self._trace()
        sum_cycles = sum_steps = 0
        for i, job in enumerate(batch[:real]):
            res = JobResult(
                handle=job.handle, tag=job.tag, cycles=int(cycles[i]),
                steps=int(steps[i]),
                time_us=self.cfg.cycles_to_us(int(cycles[i])),
                hazard_violations=int(hv[i]), shared=shared[i],
                stat_cycles=stat_c[i], stat_instrs=stat_i[i],
                tier="interp")
            if tr is not None:
                res.counters = self._job_counters(job)
                tr.async_end("job", id=job.handle, cycles=res.cycles,
                             tier="interp")
            results[job.handle] = res
            sum_cycles += res.cycles
            sum_steps += res.steps
        # one registry pass per batch, not per job (hot path)
        m = self._m
        m.inc("fleet_batches_total", tier="interp", program="mixed",
              device=self._dev)
        m.inc("fleet_jobs_total", real, tier="interp", program="mixed",
              device=self._dev)
        m.inc("fleet_pad_slots_total", len(batch) - real)
        m.inc("fleet_wall_seconds_total", wall)
        m.inc("fleet_cycles_total", sum_cycles)
        m.inc("fleet_steps_total", sum_steps)

    def _job_counters(self, job: FleetJob) -> EventCounters | None:
        """Event counters for an interpreter-tier job (tracing only):
        the path simulation is tier-independent, so compile the program
        (block-compile cache, no device work) purely for its counters —
        ``None`` when the compiler rejects it."""
        try:
            cp = compile_program(job.image, job.threads,
                                 validate=self.validate,
                                 policy=self.tier_policy)
        except BlockCompileError:
            return None
        return cp.event_counters()

    @staticmethod
    def _bucket(n: int, cap: int) -> int:
        """Pad a compiled batch to the next power of two (capped at the
        fleet batch size) so the plans (one a batch width) stay
        bounded."""
        b = 1
        while b < n:
            b *= 2
        return min(b, cap)

    def _resident_inputs(self, cp, chunk: list[FleetJob]):
        """The batch's device inputs — replayed from the residency cache
        when this exact (program, padded batch content) was transferred
        by an earlier drain, else packed host-side and transferred: an
        int32 ``(B, S)`` tensor holding the uint32 words' bits and the
        ``(B,)`` int32 TDX grids, on the scheduler's device."""
        S = self.cfg.shared_words
        # every variable-length field is length-prefixed (and None gets
        # its own tag byte) so job boundaries cannot alias: without the
        # prefixes, two different batches whose concatenated bytes
        # happen to match would digest identically and silently replay
        # the wrong resident inputs
        h = hashlib.blake2b(digest_size=16)
        for j in chunk:
            if j.shared_init is None:
                h.update(b"\x00")
            else:
                h.update(b"\x01")
                dt = str(j.shared_init.dtype).encode()
                h.update(len(dt).to_bytes(4, "little"))
                h.update(dt)
                payload = j.shared_init.tobytes()
                h.update(len(payload).to_bytes(8, "little"))
                h.update(payload)
            h.update(int(j.tdx_dim).to_bytes(4, "little", signed=True))
        # the digest is part of the key: distinct batches of one program
        # (different data, or several chunks per drain) coexist in the
        # cache instead of thrashing a single per-program slot
        key = (program_key(cp.image), cp.threads, self.validate,
               len(chunk), h.digest())

        def build():
            shared = np.zeros((len(chunk), S), np.uint32)
            for i, j in enumerate(chunk):
                if j.shared_init is None:
                    continue
                buf = machine_mod.pack_shared_init(j.shared_init, S)
                shared[i, :buf.size] = buf
            tdx = np.asarray([j.tdx_dim for j in chunk], np.int32)
            return (torch.from_numpy(shared.view(np.int32)).to(self.device),
                    torch.from_numpy(tdx).to(self.device))

        if faults.fire("residency_evict") is not None:
            self._residency.clear()      # must be a miss, never an error
        arrays, hit = self._residency.lookup(key, cp, build)
        self._m.inc("fleet_residency_lookups_total",
                    result="hit" if hit else "miss")
        return arrays, hit

    def _collect_light(self, cp, shared_dev, batch: list[FleetJob],
                       real: int, wall: float,
                       results: dict[int, JobResult]) -> None:
        """Light-path result collection: the shared image is the only
        device->host transfer; cycles/steps/stats/hazards come baked
        from the compile-time path simulation — identical for every
        lock-step core running the program, and bit-identical to what
        ``run()`` returns (the equivalence suites pin this).  ``shared``
        comes back as uint32 words, the reference's dtype."""
        shared = shared_dev.cpu().numpy().view(np.uint32)
        sim = cp.sim
        zeros = np.zeros((isa.NUM_OP_CLASSES,), np.int32)
        stat_c = np.asarray(sim.stat_cycles) if self.validate else zeros
        stat_i = np.asarray(sim.stat_instrs) if self.validate else zeros
        cycles = int(sim.cycles)
        steps = int(sim.steps)
        hv = int(sim.violations)         # already 0 under validate=False
        time_us = self.cfg.cycles_to_us(cycles)
        counters = cp.event_counters()   # baked once, shared per program
        tr = self._trace()
        for i, job in enumerate(batch[:real]):
            results[job.handle] = JobResult(
                handle=job.handle, tag=job.tag, cycles=cycles,
                steps=steps, time_us=time_us, hazard_violations=hv,
                shared=shared[i], stat_cycles=stat_c, stat_instrs=stat_i,
                tier=cp.mode, counters=counters)
            if tr is not None:
                tr.async_end("job", id=job.handle, cycles=cycles,
                             tier=cp.mode)
        # one registry pass per batch, not per job (hot path)
        prog = _prog_digest(cp.image)
        m = self._m
        m.inc("fleet_batches_total", tier=cp.mode, program=prog,
              device=self._dev)
        m.inc("fleet_jobs_total", real, tier=cp.mode, program=prog,
              device=self._dev)
        m.inc("fleet_pad_slots_total", len(batch) - real)
        m.inc("fleet_wall_seconds_total", wall)
        m.inc("fleet_cycles_total", cycles * real)
        m.inc("fleet_steps_total", steps * real)

    def _run_compiled_unit(self, cp, chunk: list[FleetJob],
                           results: dict[int, JobResult]) -> None:
        """One compiled-tier batch: pow2-bucketed, same-program padded,
        run through the light path over device-resident inputs."""
        real = len(chunk)
        with obs_trace.span("batch", tier=cp.mode, jobs=real):
            with obs_trace.span("bucket"):
                size = self.batch_size if self.fixed_bucket else \
                    self._bucket(real, self.batch_size)
                pad = size - real
                chunk = chunk + chunk[:1] * pad   # same-program filler
            t0 = time.perf_counter()
            with obs_trace.span("residency") as rsp:
                (shared_dev, tdx_dev), res_hit = \
                    self._resident_inputs(cp, chunk)
            if rsp.active:
                rsp.set(hit=res_hit)
            # split the one-time graph captures (and a first use's
            # kernel build) out of the timed dispatch
            compile_s = cp.light_compile(shared_dev, tdx_dev, self.device)
            self._m.inc("fleet_compile_seconds_total", compile_s)
            self._m.inc("fleet_compile_cache_total",
                        result="miss" if compile_s else "hit")
            t_disp = time.perf_counter()
            with obs_trace.span("dispatch", cores=size,
                                device=self._dev):
                faults.maybe_raise("dispatch", tier=cp.mode, cores=size,
                                   device=self._dev)
                shared_out, _, _ = cp.run_light_dev(shared_dev, tdx_dev,
                                                    self.device)
            t_sync = time.perf_counter()
            with obs_trace.span("device_sync"):
                hang = faults.hang_seconds("device_sync", tier=cp.mode,
                                           device=self._dev)
                if hang:
                    time.sleep(hang)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            t_done = time.perf_counter()
            self._m.observe("fleet_dispatch_seconds",
                            t_sync - t_disp, tier=cp.mode,
                            device=self._dev)
            self._m.observe("fleet_device_sync_seconds",
                            t_done - t_sync, tier=cp.mode,
                            device=self._dev)
            wall = time.perf_counter() - t0 - compile_s
            with obs_trace.span("collect"):
                self._collect_light(cp, shared_out, chunk, real, wall,
                                    results)

    def _run_interp_unit(self, batch: list[FleetJob],
                         results: dict[int, JobResult]) -> None:
        """One interpreter-tier batch: padded with STOP filler jobs."""
        real = len(batch)
        with obs_trace.span("batch", tier="interp", jobs=real):
            pad = self.batch_size - real
            batch = batch + [self._filler()] * pad
            t0 = time.perf_counter()
            with obs_trace.span("pack"):
                states = _batch_init_state(self.cfg, batch)
            timings: dict = {}
            final = fleet_run([j.image for j in batch], states,
                              validate=self.validate, timings=timings,
                              device=self.device)
            # one-time kernel build, split out of execution wall
            self._m.inc("fleet_compile_seconds_total",
                        timings["compile_s"])
            wall = time.perf_counter() - t0 - timings["compile_s"]
            with obs_trace.span("collect"):
                self._collect(final, batch, real, wall, results)

    def drain(self) -> dict[int, JobResult]:
        """Run every queued job; returns ``{handle: JobResult}``.

        Crash-safe: if a batch raises, every job whose result has not
        been collected yet (including the failing batch's) is re-queued
        in submission order before the exception propagates, and results
        already computed by the failed drain are stashed — with content
        checksums, re-verified at delivery — and delivered by the next
        ``drain()``.  A failed drain loses no work, computed or queued,
        and a result corrupted while stashed is re-executed, never
        served.
        """
        return self._drain_traced(isolate=False)[0]

    def drain_isolated(self) -> tuple[dict[int, JobResult],
                                      dict[int, Exception]]:
        """Run every queued job, **containing** failures instead of
        aborting the drain: a failing multi-job unit is bisected (one
        poison job cannot starve its cohort), a single failing compiled
        job is retried down the tier chain (superblock -> blocks ->
        interpreter), and a job that fails on every tier lands in the
        returned failures dict.  Returns ``(results, failures)`` —
        every drained handle appears in exactly one of the two.  This
        is the reference's serving front-end's drain."""
        return self._drain_traced(isolate=True)

    def _drain_traced(self, isolate: bool):
        # the registry rides the ambient contextvar through the drain
        # so leaf code (engine dispatch walls, runner-cache lookups,
        # fault sites) reports without signature plumbing
        with self._m.installed():
            if self.tracer is None:
                return self._drain(isolate)
            with self.tracer:            # install for nested spans
                out = self._drain(isolate)
        if self._trace_path is not None:
            self.tracer.save(self._trace_path)
        return out

    def _take_salvaged(self) -> tuple[dict[int, JobResult],
                                      dict[int, FleetJob]]:
        """Deliverable stashed results from a previously failed drain,
        after re-verifying each against the checksum recorded when it
        was stashed: a corrupted result is dropped (``stats.
        salvage_dropped``) and its job re-queued — re-executed by this
        very drain — so corruption costs a re-run, never a wrong
        answer."""
        results: dict[int, JobResult] = {}
        jobs_map: dict[int, FleetJob] = {}
        dropped: list[FleetJob] = []
        for h, r in self._salvaged.items():
            job = self._salvage_jobs.get(h)
            if _result_checksum(r) != self._salvage_sums.get(h):
                self._m.inc("fleet_salvage_dropped_total")
                self._event("salvage_corrupt", cat="serve", handle=h)
                if job is not None:
                    dropped.append(job)
                continue
            results[h] = r
            if job is not None:
                jobs_map[h] = job
        self._salvaged, self._salvage_sums, self._salvage_jobs = {}, {}, {}
        if dropped:                      # oldest first, ahead of the queue
            dropped.sort(key=lambda j: j.handle)
            self._queue = dropped + self._queue
        return results, jobs_map

    def _stash_salvage(self, results: dict[int, JobResult],
                       delivered_jobs: dict[int, FleetJob],
                       all_jobs: list[FleetJob]) -> None:
        """Stash computed results for the next drain, checksummed so
        delivery can detect corruption while stashed (the
        ``salvage_corrupt`` fault site flips a bit here — *after* the
        checksum — to prove exactly that)."""
        jobs_map = {h: j for h, j in delivered_jobs.items()
                    if h in results}
        jobs_map.update({j.handle: j for j in all_jobs
                         if j.handle in results})
        sums = {h: _result_checksum(r) for h, r in results.items()}
        if results and faults.fire("salvage_corrupt") is not None:
            r = results[min(results)]
            r.shared = r.shared.copy()   # don't touch the batch's base
            r.shared[0] ^= 1
        self._salvaged = results
        self._salvage_sums = sums
        self._salvage_jobs = jobs_map

    def _run_unit_isolated(self, cp, jobs: list[FleetJob],
                           results: dict[int, JobResult],
                           failures: dict[int, Exception]) -> None:
        """One unit with failure isolation: a failing multi-job unit is
        bisected (same tier) so one poison job cannot starve its
        cohort; a single failing compiled job is retried down the tier
        chain before being recorded in ``failures``."""
        if self._cancelled:              # also stops bisection chains
            raise DrainCancelled("drain cancelled")
        try:
            if cp is not None:
                self._run_compiled_unit(cp, jobs, results)
            else:
                self._run_interp_unit(jobs, results)
            return
        except Exception as e:
            err = e
        tier = cp.mode if cp is not None else "interp"
        tr = self._trace()
        if len(jobs) > 1:
            self._m.inc("fleet_bisections_total")
            self._event("batch_bisect", cat="serve", jobs=len(jobs),
                        tier=tier, error=type(err).__name__)
            mid = len(jobs) // 2
            self._run_unit_isolated(cp, jobs[:mid], results, failures)
            self._run_unit_isolated(cp, jobs[mid:], results, failures)
            return
        ncp, next_tier, degradable = self._next_tier(cp)
        if degradable:
            self._degrade(tier, next_tier, 1, err)
            self._run_unit_isolated(ncp, jobs, results, failures)
            return
        job = jobs[0]
        failures[job.handle] = err
        self._event("job_failed", cat="serve", handle=job.handle,
                    tier=tier, error=type(err).__name__)
        if tr is not None:
            tr.async_end("job", id=job.handle,
                         error=type(err).__name__)

    def _next_tier(self, cp):
        """The tier below ``cp`` for a single-job degraded retry:
        superblock -> blocks -> interpreter -> (exhausted).  Returns
        ``(compiled_or_None, tier_name, degradable)``."""
        if cp is None:
            return None, "", False       # interpreter already: exhausted
        if cp.mode == "superblock":
            try:
                ncp = compile_program(cp.image, cp.threads,
                                      validate=self.validate,
                                      policy=self.tier_policy,
                                      mode="blocks")
                return ncp, "blocks", True
            except Exception:            # blocks compile also failing
                return None, "interp", True
        return None, "interp", True

    def _drain(self, isolate: bool = False):
        results, delivered_jobs = self._take_salvaged()
        n_salvaged = len(results)        # counted only on delivery
        failures: dict[int, Exception] = {}
        all_jobs = self._queue
        self._queue = []
        units: list[tuple] | None = None
        idx = 0

        with obs_trace.span("drain", jobs=len(all_jobs)) as dsp:
            try:
                jobs = all_jobs
                compiled_groups: list = []
                if self.use_compiler:
                    with obs_trace.span("partition", jobs=len(all_jobs)):
                        compiled_groups, jobs = \
                            self._split_compilable(jobs)

                # units hold *real* jobs only (padding happens at run
                # time), so the units not yet collected are exactly what
                # a failure must put back on the queue.
                with obs_trace.span("bucket"):
                    units = []
                    for cp, group in compiled_groups:
                        for i in range(0, len(group), self.batch_size):
                            units.append(
                                (cp, group[i:i + self.batch_size]))
                    units.extend((None, batch)
                                 for batch in self._batches(jobs))

                for idx, (cp, unit_jobs) in enumerate(units):
                    if self._cancelled:
                        raise DrainCancelled("drain cancelled")
                    if isolate:
                        self._run_unit_isolated(cp, unit_jobs, results,
                                                failures)
                    elif cp is not None:
                        self._run_compiled_unit(cp, unit_jobs, results)
                    else:
                        self._run_interp_unit(unit_jobs, results)
            except BaseException:
                if units is None:            # failed while partitioning
                    unprocessed = list(all_jobs)
                else:
                    unprocessed = [j for _, us in units[idx:] for j in us
                                   if j.handle not in results
                                   and j.handle not in failures]
                unprocessed.sort(key=lambda j: j.handle)
                self._queue = unprocessed + self._queue
                self._stash_salvage(results, delivered_jobs, all_jobs)
                raise

            tr = obs_trace.current_tracer()
            if tr is not None:           # per-drain counter rollup
                agg = obs_counters.aggregate(
                    r.counters for r in results.values())
                if agg is not None:
                    flat = agg.flat()
                    tr.event("drain_counters", **flat)
                    tr.add_counters(flat)
                if dsp.active:
                    dsp.set(delivered=len(results),
                            failed=len(failures),
                            batches=len(units))
        # salvaged results were computed (and counted into jobs/wall_s/
        # tier splits) by the drain that ran them; delivery only marks
        # them so per-drain consumers don't double-dip the timing
        if n_salvaged:
            self._m.inc("fleet_salvaged_jobs_total", n_salvaged)
        return results, failures
