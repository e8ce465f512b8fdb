"""The batched fleet on PyTorch: the port of ``repro.fleet`` (the
lock-step engine ``fleet_run``, the compiled tier's ``ResidencyCache``,
the job scheduler and the ``Fleet`` facade, fault injection).

    from repro_torch.fleet import Fleet
    fleet = Fleet(cfg, batch_size=32)          # the card; device="cpu"
    h = fleet.submit(image, shared_init=data, threads=256)
    results = fleet.drain()
    results[h].shared_f32()

The serving loop (``FleetService``) and the sharded multi-device fleet
are not ported yet (ROADMAP.md, queue 1, items 8 and 9).
"""
from .api import Fleet, run_jobs, serve_jobs
from .devices import balance_units, device_label
from .engine import ResidencyCache, fleet_run, stack_states, unstack_state
from .faults import FAULT_SITES, FaultPlan, FaultSpec, InjectedFault
from .scheduler import (FleetJob, FleetScheduler, FleetStats, JobResult,
                        check_job)

__all__ = [
    "Fleet", "run_jobs", "serve_jobs", "fleet_run", "stack_states",
    "unstack_state", "FleetJob", "FleetScheduler", "FleetStats",
    "JobResult", "ResidencyCache", "check_job",
    "device_label", "balance_units",
    "FaultPlan", "FaultSpec", "InjectedFault", "FAULT_SITES",
]
