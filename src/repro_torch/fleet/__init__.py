"""The batched fleet on PyTorch: the port of ``repro.fleet.engine``
(``fleet_run`` and the compiled tier's ``ResidencyCache``)."""
from .engine import ResidencyCache, fleet_run, stack_states, unstack_state

__all__ = ["ResidencyCache", "fleet_run", "stack_states", "unstack_state"]
