"""The batched fleet on PyTorch: the port of ``repro.fleet`` (the
lock-step engine ``fleet_run``, the compiled tier's ``ResidencyCache``,
the job scheduler and the ``Fleet`` facade, the sharded multi-device
fleet, the serving loop, fault injection).

    from repro_torch.fleet import Fleet
    fleet = Fleet(cfg, batch_size=32)          # the card; device="cpu"
    h = fleet.submit(image, shared_init=data, threads=256)
    results = fleet.drain()
    results[h].shared_f32()

For always-on serving (per-job futures, deadlines, priorities, retries
with backoff, bounded admission, deterministic fault injection):

    from repro_torch.fleet import FleetService, FaultPlan
    with FleetService(cfg, batch_size=32, max_delay_s=0.002) as svc:
        fut = svc.submit(image, data, deadline_s=0.5)
        fut.result()                     # JobResult, or raises JobError
"""
from .api import Fleet, run_jobs, serve_jobs
from .devices import balance_units, device_label, fleet_devices, make_job_mesh
from .engine import ResidencyCache, fleet_run, stack_states, unstack_state
from .faults import FAULT_SITES, FaultPlan, FaultSpec, InjectedFault
from .scheduler import (FleetJob, FleetScheduler, FleetStats, JobResult,
                        check_job)
from .service import (AdmissionError, FleetService, JobError, ServiceStats,
                      register_serve_metrics)
from .sharded import ShardedFleetScheduler

__all__ = [
    "Fleet", "run_jobs", "serve_jobs", "fleet_run", "stack_states",
    "unstack_state", "FleetJob", "FleetScheduler", "FleetStats",
    "JobResult", "ResidencyCache", "check_job",
    "ShardedFleetScheduler", "fleet_devices", "device_label",
    "make_job_mesh", "balance_units",
    "FleetService", "ServiceStats", "JobError", "AdmissionError",
    "register_serve_metrics",
    "FaultPlan", "FaultSpec", "InjectedFault", "FAULT_SITES",
]
