"""The batched fleet: N cores in lock step, one data-path step per
instruction for the whole batch.

The port of ``repro.fleet.engine.fleet_run``: an explicit leading batch
axis takes the place of ``vmap``.  Each core carries its own program
image, runtime thread count, TDX grid and shared memory; all cores share
one configuration and one padded program length.  A core whose program
has ended executes NOPs from then on, so its state freezes leaf for
leaf and each core's result is bit-identical to what ``run_program``
gives for that job alone.  The STOs of one step are applied as one
flattened scatter (:func:`repro_torch.core.semantics.store`); the FP
and the DOT/SUM ops of a step are one launch each of their step kernel,
whatever opcodes the cores mix.
"""
from __future__ import annotations

import torch

from ..core.assembler import ProgramImage
from ..core.executor import pad_image, padded_length, run_batch
from ..core.machine import (MachineState, init_numpy, resolve_device,
                            state_to_numpy)
from ..obs import trace as obs_trace


def stack_states(states: list[MachineState]) -> MachineState:
    """Stack per-core states along a new leading fleet axis."""
    return MachineState(*(torch.stack(xs) for xs in zip(*states)))


def unstack_state(batched: MachineState, i: int) -> MachineState:
    """Extract core ``i``'s state from a batched fleet state."""
    return MachineState(*(x[i] for x in batched))


def fleet_run(images: list[ProgramImage],
              states: list[MachineState] | MachineState | None = None, *,
              prog_len: int | None = None,
              init_kw: list[dict] | None = None,
              validate: bool = True,
              device="cuda") -> MachineState:
    """Execute one program per core, all cores in lock step.

    ``images`` must share a configuration.  ``states`` (a list of
    per-core states or a batched one) or per-job ``init_kw`` dicts for
    ``init_state`` supply each core's shared memory, thread count and
    TDX grid.  Returns the batched final :class:`MachineState`; slice
    per-core results out with :func:`unstack_state`.  Runs on the card
    unless ``device="cpu"`` (given states decide the device).
    """
    if not images:
        raise ValueError("empty fleet")
    cfg = images[0].cfg
    for im in images[1:]:
        if im.cfg != cfg:
            raise ValueError("fleet cores must share one EGPUConfig")
    if states is None:
        dev = resolve_device(device)
        init_kw = init_kw or [{}] * len(images)
        leaves = [init_numpy(cfg, threads=im.threads_active, **kw)
                  for im, kw in zip(images, init_kw)]
    else:
        if isinstance(states, MachineState):
            states = [unstack_state(states, i)
                      for i in range(states.regs.shape[0])]
        if len(states) != len(images):
            raise ValueError("one state per core required")
        dev = states[0].regs.device
        leaves = [state_to_numpy(s) for s in states]
    if prog_len is None:
        prog_len = max(padded_length(im.n) for im in images)
    packed = [pad_image(im, prog_len)[0] for im in images]
    with obs_trace.span("dispatch", cores=len(images), prog_len=prog_len,
                        device=str(dev)):
        out = run_batch(cfg, packed, leaves, prog_len, validate, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return out
