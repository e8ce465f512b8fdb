"""maybe_scan: ``lax.scan``'s contract as a Python loop, whose repeated
steps a dry run's trace counts without running them.

The port of ``repro/models/scan_util.py``.  The reference chooses
between ``lax.scan`` and an unrolled Python loop by config
(``unroll_py``, from ``cfg.scan_layers``) because XLA's
``cost_analysis`` counts a loop body once whatever its trip count: its
roofline calibration compiles small configurations unrolled, where the
count is exact, and fits a polynomial in layers and sequence length.
The port has no compiler between a loop and its count.  It always loops
in Python (``common.ModelConfig.scan_layers`` is read by nothing), and
the dry run's trace (``launch.dryrun.StepTrace``) counts each operation
as it runs, so a loop of n steps counts n bodies.  It needs no switch,
and fits nothing: over short sequences DTensor chooses other
redistributions as the length grows, so a fit would not be exact.

What a long loop costs the dry run is time: each step's operations are
dispatched and partitioned one by one (xlstm's prefill, 32,768 decode
steps of 24 layers, did not trace in hours).  So a trace may install a
counter for the time it runs (:func:`counting`).  Under one, a scan
whose steps run on ``meta`` tensors and record no gradient is traced a
step at a time until two consecutive steps count the same; the steps
left are then counted as that step times their number and not run, and
the carry (and each ``ys`` entry) keeps the shapes and placements the
loop gives them.  No count comes from steps that differ: a scan whose
steps have not agreed by :data:`PROBE_STEPS` is traced to its end, as is
one that records a gradient (the backward needs each step's graph).  On
tensors with values the loop is the plain loop.

A counter has three methods:

* ``mark()``: its counts before a step;
* ``step(mark, carry, y)``: what the step since ``mark`` added, compared
  with ``==``; ``None`` where that step cannot stand for the ones after
  it (its tensors hold values, or it kept more than ``y``);
* ``repeat(step, times, first)``: count ``step`` ``times`` more, the
  first of them the scan's step ``first`` (from 1).
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._pytree import tree_leaves, tree_map

#: the steps of a scan that may be compared: if no two consecutive ones
#: among them have counted the same, the scan is traced to its end
PROBE_STEPS = 8

_counter = None


@contextlib.contextmanager
def counting(counter):
    """Count every scan started inside by ``counter`` (see the module's
    docstring); ``None`` traces every step."""
    global _counter
    outer, _counter = _counter, counter
    try:
        yield counter
    finally:
        _counter = outer


def _records_grad(tree) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in tree_leaves(tree))


def _empty_like(t):
    return torch.empty_like(t) if isinstance(t, torch.Tensor) else t


def maybe_scan(body, carry, xs, *, length: int | None = None):
    """``lax.scan(body, carry, xs, length=length)`` as a Python loop:
    ``xs`` a tree sliced along dim 0 (or ``None``, with ``length``),
    ``ys`` the bodies' second outputs stacked along dim 0 (``None`` when
    the body returns ``None``)."""
    n = length if length is not None else tree_leaves(xs)[0].shape[0]
    counter = _counter
    ys, last, i = [], None, 0
    while i < n:
        mark = None if counter is None else counter.mark()
        x = None if xs is None else tree_map(lambda a: a[i], xs)
        carry, y = body(carry, x)
        ys.append(y)
        i += 1
        if counter is None:
            continue
        step = counter.step(mark, carry, y)
        if _records_grad((carry, y)):
            counter = None                    # every step is traced
        elif step is not None and step == last and i < n:
            counter.repeat(step, n - i, i + 1)
            ys += [tree_map(_empty_like, y) for _ in range(n - i)]
            break
        elif i == PROBE_STEPS:
            counter = None
        last = step
    if not ys or ys[0] is None:
        return carry, None
    return carry, tree_map(lambda *a: torch.stack(a), *ys)
