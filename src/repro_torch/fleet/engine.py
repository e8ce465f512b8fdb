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

:class:`ResidencyCache` keeps the compiled tier's batch inputs resident
on the card across drains (the port of ``repro.fleet.engine.
ResidencyCache``).
"""
from __future__ import annotations

import time
import weakref
from collections import OrderedDict

import torch

from ..core.assembler import ProgramImage
from ..core.executor import pad_image, padded_length, run_batch
from ..core.machine import (MachineState, init_numpy, resolve_device,
                            state_to_numpy, sync)
from ..kernels import build, egpu_step
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from . import devices as devices_mod
from . import faults


class ResidencyCache:
    """Device-resident batch inputs for the compiled lock-step tier.

    A drain of N same-program jobs moves one ``(N, S)`` shared-memory
    image (plus the TDX grid vector) host -> device before the compiled
    light path runs.  Serving workloads drain the *same* programs over
    the same inputs repeatedly, so this cache keeps the already-moved
    device tensors resident across drains: a repeat drain whose key —
    which embeds a content digest of the batch — matches an entry
    replays the resident tensors and pays **zero host -> device
    transfer**.  That is only sound because the compiled light path
    (:meth:`repro_torch.core.blockc.CompiledProgram.run_light_dev`)
    copies its inputs into its own buffers and never consumes them.

    Entries are LRU-bounded and **invalidated with the compile cache**:
    each entry holds a weak reference to the :class:`CompiledProgram` it
    was built against, and a lookup whose compiled program is no longer
    that exact object (evicted and recompiled, or garbage-collected)
    rebuilds rather than replays — the compiled program's identity is
    the invalidation token, so the two caches cannot drift apart.
    """

    def __init__(self, max_entries: int = 32):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self._max = max_entries
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        """Drop every resident entry (a later lookup just rebuilds and
        re-transfers — an eviction is always a miss, never an error)."""
        self._entries.clear()

    def lookup(self, key, cp, build):
        """Return ``(tensors, hit)``: the device-resident input tensors
        for ``key`` (whose content identity the caller encodes in the
        key itself) if the entry was built against this exact ``cp``;
        otherwise call ``build()`` (which must return the device
        tensors), cache, and return them."""
        e = self._entries.get(key)
        if e is not None and e["cp"]() is cp:
            self._entries.move_to_end(key)
            self.hits += 1
            return e["arrays"], True
        arrays = build()
        self._entries[key] = {"cp": weakref.ref(cp), "arrays": arrays}
        self._entries.move_to_end(key)
        while len(self._entries) > self._max:
            self._entries.popitem(last=False)      # LRU eviction
        self.misses += 1
        return arrays, False


def stack_states(states: list[MachineState]) -> MachineState:
    """Stack per-core states along a new leading fleet axis."""
    return MachineState(*(torch.stack(xs) for xs in zip(*states)))


def unstack_state(batched: MachineState, i: int) -> MachineState:
    """Extract core ``i``'s state from a batched fleet state."""
    return MachineState(*(x[i] for x in batched))


def fleet_run(images: list[ProgramImage],
              states: list | MachineState | None = None, *,
              prog_len: int | None = None,
              init_kw: list[dict] | None = None,
              validate: bool = True,
              timings: dict | None = None,
              device="cuda") -> MachineState:
    """Execute one program per core, all cores in lock step.

    ``images`` must share a configuration.  ``states`` supply each
    core's shared memory, thread count and TDX grid: a list of per-core
    states, a batched state, or a list of per-core leaf dicts of numpy
    arrays in the reference's dtypes (what ``init_numpy`` gives, and
    what the sequencer reads: no round trip through the card); or
    per-job ``init_kw`` dicts for ``init_state`` build them.  Returns
    the batched final :class:`MachineState`; slice per-core results out
    with :func:`unstack_state`.  Runs on the card unless
    ``device="cpu"`` (given states decide the device, leaf dicts do
    not).

    ``timings``, if given, receives ``{"compile_s": ...}``: the host
    seconds this call spent building and loading the step kernels' CUDA
    libraries (0.0 when warm, and on the CPU), so callers timing the
    dispatch can attribute that one-time cost apart.
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
    elif isinstance(states, MachineState):
        dev = states.regs.device
        batched = state_to_numpy(states)      # one copy a leaf
        leaves = [{k: v[i] for k, v in batched.items()}
                  for i in range(states.regs.shape[0])]
    elif states and isinstance(states[0], dict):
        dev = resolve_device(device)
        leaves = states
    else:
        dev = states[0].regs.device if states else resolve_device(device)
        leaves = [state_to_numpy(s) for s in states]
    if len(leaves) != len(images):
        raise ValueError("one state per core required")
    if prog_len is None:
        prog_len = max(padded_length(im.n) for im in images)
    packed = [pad_image(im, prog_len)[0] for im in images]
    label = devices_mod.device_label(dev)
    compile_s = 0.0
    if dev.type == "cuda":
        with obs_trace.span("compile", kind="nvcc", device=label):
            compile_s = build.ensure(egpu_step.KERNELS)
    if timings is not None:
        timings["compile_s"] = compile_s
    t_disp = time.perf_counter()
    with obs_trace.span("dispatch", cores=len(images), prog_len=prog_len,
                        device=label):
        faults.maybe_raise("dispatch", tier="interp", cores=len(images),
                           device=label)
        out = run_batch(cfg, packed, leaves, prog_len, validate, dev)
    t_sync = time.perf_counter()
    with obs_trace.span("device_sync"):
        hang = faults.hang_seconds("device_sync", tier="interp",
                                   device=label)
        if hang:
            time.sleep(hang)
        sync(dev)
    t_done = time.perf_counter()
    obs_metrics.observe("fleet_dispatch_seconds", t_sync - t_disp,
                        tier="interp", device=label)
    obs_metrics.observe("fleet_device_sync_seconds", t_done - t_sync,
                        tier="interp", device=label)
    return out
