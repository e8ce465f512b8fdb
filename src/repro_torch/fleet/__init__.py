"""The batched fleet on PyTorch: the port of ``repro.fleet.engine``."""
from .engine import fleet_run, stack_states, unstack_state

__all__ = ["fleet_run", "stack_states", "unstack_state"]
