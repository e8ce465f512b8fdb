"""Multi-pod dry run: every (arch x input-shape x mesh) cell's step run as
a partitioned ``torch.distributed.tensor`` program on rank 0's ``meta``
shards over a placeholder group of 512 ranks, and the roofline terms
counted.  The port of ``repro/launch/dryrun.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-moe-3b-a800m \
      --shape train_4k --mesh 1x1 --batch 8 --seq 512    # a cell cut to size

Where the reference lowers and compiles each cell with XLA's GSPMD on
512 placeholder host devices, the port builds a CPU ``DeviceMesh`` over
torch's ``fake`` process group (rank 0 of 512, from
``torch.testing._internal.distributed.fake_pg``, a testing module of
torch: it sends nothing), started by :func:`main` or :func:`run_cell`,
never at import.  Each cell's arguments become ``DTensor``s of their
placements over ``meta`` shards (``specs.distribute``), and its step
runs once under :class:`StepTrace` (``specs.run_step``): DTensor's sharding propagation, under the port's
rules (``partition.register_rules``: the hand-written kernels' operators,
whose fake implementations run here, and a few elementwise operators)
and the models' own placements (``models.common.batch_only``,
``gather_fsdp``), inserts the collectives; the layers whose partitioning
DTensor's rules cannot express make their own, on local shards (the MoE's
dispatch and combine, ``models.moe``; decode attention's merge over a
cache sharded on its positions, ``kernels.flash_attention.ops``).  Per cell, JSON with the
reference's keys:

* ``memory.argument_bytes``: rank 0's bytes of every argument leaf under
  the cell's placements, exact;
* ``memory.output_bytes``: rank 0's bytes of the step's outputs, each
  under its own placements (an argument updated in place keeps its own);
* ``memory.temp_bytes``: rank 0's peak of live bytes that the step's
  operations allocated, less the outputs it made (:func:`record`);
* ``cost.flops``: one rank's FLOPs: the products of its local operations
  (``torch.utils.flop_counter``'s formulas, the kernels' own among them),
  of every layer and every step of every loop.  XLA's count is one
  device's too, but it also counts elementwise operations, and it counts
  the body of each of the reference's ``lax.scan`` loops (a config's
  layers, xlstm's sLSTM and prefill) once;
* ``collectives``: ``bytes``, ``count`` and ``total_bytes`` by the
  reference's five kinds: each collective's result bytes on rank 0, as
  :func:`collective_bytes` sums HLO result shapes.  On a CPU mesh
  DTensor's redistribution moves a shard from one dim to another by an
  all-gather and a chunk (it takes no all-to-all on a CPU process group,
  though ``gloo``'s own ``all_to_all_single`` runs), so such a move
  counts as all-gather;
* ``lower_s``: the traced call's seconds (DTensor's sharding decisions,
  made once an operation and its operands' specs, included); ``compile_s``,
  ``generated_code_bytes``, ``bytes_accessed`` and ``transcendentals``:
  ``None`` (no code is generated; nothing counts the others);

and ``torch``, the version that counted it.  A scan's steps
(``models.scan_util.maybe_scan``) are all counted: those that record a
gradient each traced, and of the others, once two consecutive steps
count the same, the steps left counted as that step and not run
(:class:`StepTrace`; the tests hold it to a trace of every step), so
that xlstm's prefill of 32,768 decode steps traces in seconds.  A cell
whose step stops keeps the reference's error form, ``{"error": ...}``.
The CLI's line for a cell says which steps were counted by repetition
and names the largest buffers live at the peak.
:func:`collective_bytes`, the reference's parser of post-SPMD HLO text,
is kept as the pure function it is.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import heapq
import json
import os
import re
import time
import traceback

from .. import configs
from ..models import scan_util
from ..sharding import partition
from . import mesh as mesh_mod
from . import specs as specs_mod

#: the placeholder group's size: the multi-pod mesh's 2 x 16 x 16 ranks
PLACEHOLDER_RANKS = 512
#: the largest buffers live at a trace's peak that it names
PEAK_BUFFERS = 5

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_TUPLE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _nbytes(dtype: str, dims: str) -> int:
    n = _DTYPE_BYTES.get(dtype)
    if n is None:
        return 0
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n


def collective_bytes(hlo_text: str) -> dict:
    """Sum result bytes of every collective op in (optimized) HLO."""
    out = {c: 0 for c in _COLLECTIVES}
    count = {c: 0 for c in _COLLECTIVES}
    for line in hlo_text.splitlines():
        m = None
        for c in _COLLECTIVES:
            if f" {c}(" in line or f"{c}-start(" in line or f"{c}-done(" in line:
                m = c
                break
        if m is None:
            continue
        if f"{m}-done(" in line:
            continue  # avoid double counting start/done pairs
        shapes = _TUPLE_RE.findall(line.split(f" {m}")[0])
        total = sum(_nbytes(d, dims) for d, dims in shapes)
        out[m] += total
        count[m] += 1
    return {"bytes": out, "count": count,
            "total_bytes": sum(out.values())}


def placeholder_group(world_size: int = PLACEHOLDER_RANKS) -> None:
    """Make this process rank 0 of a ``fake`` process group of
    ``world_size`` ranks, unless a group is up already."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


#: funcol's (and DTensor's) collectives by the reference's kinds; a
#: collective of another name is recorded under ``unmapped``
_FUNCOL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
}
_COMM_NAMESPACES = ("_c10d_functional", "c10d_functional",
                    "_c10d_functional_autograd", "c10d", "_dtensor")
#: ops of those namespaces that move no data between ranks
_NOT_COMM = ("wait_tensor", "_wrap_tensor_autograd")
#: metadata queries, as ``FlopCounterMode`` passes them over
_META_OPS = ("is_contiguous", "sym_is_contiguous", "is_strides_like_format",
             "is_non_overlapping_and_dense", "size", "sym_size", "stride",
             "sym_stride", "storage_offset", "sym_storage_offset", "numel",
             "sym_numel", "dim")


def _tensors(x) -> list:
    from torch.utils._pytree import tree_leaves
    import torch
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _shard(t):
    """``t``'s local tensor, as :func:`_local`, but through no operation
    (for use outside the trace's own dispatch)."""
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _grown(now: dict, before: dict) -> frozenset:
    """The entries of ``now`` that grew since ``before``, by how much."""
    return frozenset((k, v - before.get(k, 0)) for k, v in now.items()
                     if v != before.get(k, 0))


class StepTrace:
    """One rank's view of a step run as a ``DTensor`` program: a dispatch
    mode that lets each ``DTensor`` operation go to DTensor first (as
    ``CommDebugMode`` does), so that it sees the local operations and the
    collectives DTensor runs for it, each on this rank's shards.  It
    counts:

    * ``flops``: the FLOPs of the local operations, by the formulas of
      ``torch.utils.flop_counter`` (an operation it has none for is
      decomposed first, as ``FlopCounterMode`` does), the kernels' own
      among them: this rank's products and nothing else (no elementwise
      operation, which XLA's count holds);
    * ``collectives``: each collective's result bytes, by the reference's
      kind (the module's ``_FUNCOL_KINDS``), ``largest``, one
      collective's largest result, and ``by_shape``, the bytes by (kind,
      result shape, type) (:meth:`largest_shapes`);
    * ``peak``: the most bytes of storage that the step's operations had
      allocated and not yet freed at once (tracked by each storage's
      lifetime), a kernel's own workspace (``workspace_bytes`` of its
      ``ops``) counted while it runs; the arguments' storages (``known``)
      are not counted, and a collective's result and the tensor funcol
      wraps it in (``_wrap_tensor_autograd``) are one buffer, live while
      either is (which of the two the step goes on with is funcol's
      choice, and differs between a real group and the ``fake`` one).
      On a real group the process group's own thread may hold a finished
      collective's buffer a little longer (``gloo``'s worker: when is its
      scheduler's choice), so a real rank's peak may differ from the
      ``fake`` group's by such a buffer;
    * ``at_peak``: the largest buffers live at the peak, (shape, type,
      bytes) each, a kernel's workspace among them while it runs;
    * ``repeated``: (first step, steps, of) of each scan whose steps it
      counted by repetition.

    While :meth:`mode` runs it is the scans' counter
    (``models.scan_util.counting``): a step of a scan on ``meta`` tensors
    that adds what the step before it added (FLOPs; each collective
    kind's bytes and count, and its bytes by result shape; the live
    bytes it keeps, those of its ``ys`` entry alone; its peak above the
    live bytes at its start) stands for the steps left, which are
    counted as it and not run.  Where the peak lies in such steps, the
    buffers named are those of the step they repeat.
    """

    def __init__(self, known=()):
        import threading
        import weakref
        self._weakref = weakref
        # a real group's worker thread may drop a collective's buffer last
        self._lock = threading.Lock()
        self.flops = 0
        self.bytes = {c: 0 for c in _COLLECTIVES}
        self.count = {c: 0 for c in _COLLECTIVES}
        self.unmapped: dict = {}
        self.live = 0
        self.peak = 0
        #: the largest result of one collective
        self.largest = 0
        #: (kind, result shape, type) -> result bytes in all
        self.by_shape: dict = {}
        self.at_peak: list = []
        self.repeated: list = []
        #: the most live bytes since the start of the scan step traced now
        self._high = 0
        #: storage id -> (its weak reference, its buffer: [bytes, members])
        self._storages: dict = {}
        #: counted buffers live, by bytes: bytes -> {id: (shape, type)}
        self._by_size: dict = {}
        for t in known:
            self._track(_local(t), count=False)

    def _track(self, t, count: bool = True, like=None) -> None:
        """Count ``t``'s storage from now until it is freed, unless it is
        known; ``like``: a tensor whose buffer it joins."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        buf = None
        if like is not None:
            buf = self._storages.get(id(like.untyped_storage()), (0, None))[1]
        with self._lock:
            if buf is None:
                buf = [st.nbytes() if count else 0, 0]
                self.live += buf[0]
                if buf[0]:
                    self._by_size.setdefault(buf[0], {})[id(buf)] = (
                        tuple(t.shape), str(t.dtype).split(".")[-1])
            buf[1] += 1

        def freed(_, key=key, buf=buf):
            with self._lock:
                self._storages.pop(key, None)
                buf[1] -= 1
                if not buf[1]:
                    self.live -= buf[0]
                    if buf[0]:
                        same = self._by_size[buf[0]]
                        del same[id(buf)]
                        if not same:
                            del self._by_size[buf[0]]

        self._storages[key] = (self._weakref.ref(st, freed), buf)

    def _raise_peak(self, now: int, work: int = 0, func=None) -> None:
        """Note ``now`` live bytes (``work`` of them ``func``'s
        workspace), and the largest buffers if it is a new peak."""
        self._high = max(self._high, now)
        if now <= self.peak:
            return
        self.peak = now
        top = [((), f"workspace of {func}", work)] if work else []
        with self._lock:
            for size in heapq.nlargest(PEAK_BUFFERS, self._by_size):
                top += [(*d, size) for d in self._by_size[size].values()]
                if len(top) >= PEAK_BUFFERS:
                    break
        self.at_peak = sorted(top, key=lambda x: -x[2])[:PEAK_BUFFERS]

    # -- the scans' counter (models.scan_util) ------------------------------
    def mark(self):
        """The counts before a scan's step."""
        mark = (self.flops, dict(self.bytes), dict(self.count),
                dict(self.by_shape), dict(self.unmapped), self.live,
                self._high)
        self._high = self.live
        return mark

    def step(self, mark, carry, y):
        """What the step since ``mark`` added; ``None`` where a tensor of
        ``carry`` or ``y`` holds values, or the step kept more than
        ``y``'s own buffers (each of ``y``'s tensors the whole of one)."""
        flops, nbytes, count, by_shape, unmapped, live, high = mark
        top, self._high = self._high - live, max(high, self._high)
        shards = [_shard(t) for t in _tensors((carry, y))]
        if any(t.device.type != "meta" for t in shards):
            return None
        kept = {}
        for t in _tensors(y):
            t = _shard(t)
            st = t.untyped_storage()
            entry = self._storages.get(id(st))
            if entry is None or id(st) in kept or \
                    st.nbytes() != t.numel() * t.element_size():
                return None
            kept[id(st)] = entry[1][0]
        grew = self.live - live
        if grew != sum(kept.values()):
            return None
        return (self.flops - flops,
                tuple(self.bytes[k] - nbytes[k] for k in _COLLECTIVES),
                tuple(self.count[k] - count[k] for k in _COLLECTIVES),
                _grown(self.by_shape, by_shape),
                _grown(self.unmapped, unmapped), grew, top)

    def repeat(self, step, times: int, first: int) -> None:
        """Count ``step`` (:meth:`step`) ``times`` more, the first of them
        its scan's step ``first``; the live bytes the steps keep are their
        ``ys`` entries, which the scan makes."""
        flops, nbytes, count, by_shape, unmapped, grew, top = step
        self.flops += times * flops
        for k, b, c in zip(_COLLECTIVES, nbytes, count):
            self.bytes[k] += times * b
            self.count[k] += times * c
        for k, b in by_shape:
            self.by_shape[k] += times * b
        for k, c in unmapped:
            self.unmapped[k] += times * c
        self._raise_peak(self.live + (times - 1) * grew + top)
        self.repeated.append((first, times, first - 1 + times))

    def largest_shapes(self, n: int = 5) -> list:
        """The ``n`` (kind, result shape, type, bytes) of
        :attr:`by_shape` that moved the most bytes."""
        return sorted(((*k, b) for k, b in self.by_shape.items()),
                      key=lambda x: -x[3])[:n]

    def collectives(self) -> dict:
        out = {"bytes": dict(self.bytes), "count": dict(self.count),
               "total_bytes": sum(self.bytes.values())}
        if self.unmapped:
            out["unmapped"] = dict(self.unmapped)
        return out

    @contextlib.contextmanager
    def mode(self, repeat: bool = True):
        """Trace what runs inside; with ``repeat``, count a scan's
        repeated steps by repetition (else every step runs).  Python's
        cyclic garbage collector is run first and held off until the
        end, so that tensors held in reference cycles live to the end of
        the step, whatever ran before (the peak is then an upper bound,
        the same on every run)."""
        gc.collect()
        gc.disable()
        try:
            with self._mode(), scan_util.counting(self if repeat else None):
                yield self
        finally:
            gc.enable()

    def _mode(self):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        import torch
        trace = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                # DTensor's sharding propagation runs an operation on
                # fake tensors of the global shapes, once per schema:
                # that is no work of this rank's
                if isinstance(func, torch._ops.HigherOrderOperator) or any(
                        issubclass(t, FakeTensor) for t in types):
                    return func(*args, **kwargs)
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                packet = func._overloadpacket
                name = packet.__name__
                if name in _META_OPS:
                    return func(*args, **kwargs)
                if packet not in flop_registry:
                    with self:
                        r = func.decompose(*args, **kwargs)
                    if r is not NotImplemented:
                        return r
                out = func(*args, **kwargs)
                if any(isinstance(t, FakeTensor) for t in _tensors(out)):
                    return out      # a factory of the same propagation
                ns = func.namespace
                if ns in _COMM_NAMESPACES and name not in _NOT_COMM:
                    nbytes = sum(t.numel() * t.element_size()
                                 for t in _tensors(out))
                    kind = _FUNCOL_KINDS.get(name)
                    if kind is None:
                        trace.unmapped[str(func)] = \
                            trace.unmapped.get(str(func), 0) + 1
                    else:
                        trace.bytes[kind] += nbytes
                        trace.largest = max(trace.largest, nbytes)
                        key = (kind, " ".join(str(tuple(t.shape)) for t in
                                              _tensors(out)),
                               str(_tensors(out)[0].dtype).split(".")[-1])
                        trace.by_shape[key] = trace.by_shape.get(key, 0) \
                            + nbytes
                        trace.count[kind] += 1
                if packet in flop_registry:
                    trace.flops += flop_registry[packet](*args, **kwargs,
                                                         out_val=out)
                work = _workspace(func, args)
                like = args[0] if name == "_wrap_tensor_autograd" else None
                for t in _tensors(out):
                    trace._track(t, like=like)
                trace._raise_peak(trace.live + work, work, func)
                return out

        return _Mode()


def _workspace(func, args) -> int:
    """The kernel's own workspace, for the kernels' operators."""
    if func.namespace != "repro_torch":
        return 0
    from ..kernels.flash_attention import ops as aops
    from ..kernels.wavefront_matmul import ops as mops
    ops = aops if "attention" in func.__name__ else mops
    return ops.workspace_bytes(func, args[0], args[1])


def output_bytes(out) -> int:
    """One device's bytes of the step's outputs ``out``: each output
    ``DTensor``'s shard under its own placements (an argument updated in
    place keeps the argument's), a plain tensor whole."""
    return sum(partition.placed_bytes(t)
               for t in partition.leaves(specs_mod.trees(out)))


def measure(cell: specs_mod.Cell, *, repeat_steps: bool = True) -> dict:
    """``lower_s``, the record's ``memory`` and ``cost`` and its
    ``collectives`` for one call of the cell's step as a ``DTensor``
    program on rank 0's ``meta`` shards (``specs.distribute``), and
    ``notes``: what the trace saw that the record does not hold (the
    scans counted by repetition, the buffers at the peak).
    ``temp_bytes`` is the trace's peak less the bytes of the outputs that
    the step made (those that are not arguments updated in place).  A
    cell on a mesh that is no ``DeviceMesh`` (the tests' ``FakeMesh``,
    which has no ranks) runs its step unpartitioned on its ``meta``
    arguments: then ``flops`` and ``temp_bytes`` are the whole step's,
    and no collective is counted.  ``repeat_steps=False`` runs every
    step of every scan (:meth:`StepTrace.mode`)."""
    from torch.distributed.device_mesh import DeviceMesh
    mesh = specs_mod.placed_leaves(cell.args, cell.in_shardings)[0][1].mesh
    if isinstance(mesh, DeviceMesh):
        args = specs_mod.distribute(cell)
        run = specs_mod.run_step
    else:
        args = cell.args
        run = lambda cell, args: cell.step_fn(*args)
    trace = StepTrace(known=specs_mod.arg_tensors(args))
    t0 = time.perf_counter()
    with trace.mode(repeat=repeat_steps):
        out = run(cell, args)
    lower_s = time.perf_counter() - t0
    if trace.by_shape:
        print("     largest collectives by result shape: " + "; ".join(
            f"{k} {shape} {dt} {b:.4e} B" for k, shape, dt, b in
            trace.largest_shapes()), flush=True)
    known = {id(_local(t).untyped_storage())
             for t in specs_mod.arg_tensors(args)}
    made = {}
    for t in partition.leaves(specs_mod.trees(out)):
        st = None if t is None else _local(t).untyped_storage()
        if st is not None and id(st) not in known:
            made[id(st)] = st.nbytes()
    return {"lower_s": lower_s,
            "notes": {"repeated": trace.repeated, "at_peak": trace.at_peak},
            "memory": {"argument_bytes": specs_mod.argument_bytes(cell),
                       "output_bytes": output_bytes(out),
                       "temp_bytes": trace.peak - sum(made.values()),
                       "generated_code_bytes": None},
            "cost": {"flops": trace.flops, "bytes_accessed": None,
                     "transcendentals": None},
            "collectives": trace.collectives()}


def _mesh(multi_pod: bool, debug: str | None):
    """The production mesh, or with ``debug`` (``"DxM"``) a ``("data",
    "model")`` mesh of D x M ranks; on the CPU of the placeholder group."""
    if debug is None:
        return (mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                              device="cpu"),
                "2x16x16" if multi_pod else "16x16")
    d, m = (int(x) for x in debug.split("x"))
    return mesh_mod.make_debug_mesh(d, m, device="cpu"), debug


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             fsdp: bool = True, seq_shard: bool = True,
             remat: bool | None = None, extra_tag: str = "",
             pin_out: bool = False, cache_axis: str = "seq",
             microbatches: int = 1, debug_mesh: str | None = None,
             batch: int | None = None, seq: int | None = None,
             notes: dict | None = None) -> dict:
    """One cell's record: the reference's keys, and ``torch``, the
    version that counted it.  ``debug_mesh`` (``"DxM"``) in place of the
    production mesh, ``batch`` and ``seq`` in place of the shape's global
    batch and sequence length: a cell cut to size.  A cell whose step
    stops (an operation no DTensor rule covers: the error names it)
    holds the reference's error form, ``{"error": ...}``, in ``memory``,
    ``cost`` and ``collectives``.  ``notes``, a dict, is given
    :func:`measure`'s."""
    import torch
    placeholder_group()
    mesh, mesh_name = _mesh(multi_pod, debug_mesh)
    chips = mesh_mod.mesh_chips(mesh)
    shape = configs.SHAPES[shape_name]
    shape = configs.ShapeSpec(shape.name, seq or shape.seq_len,
                              batch or shape.global_batch, shape.kind)
    cell = specs_mod.build_cell(arch, shape_name, mesh, fsdp=fsdp,
                                seq_shard=seq_shard, remat=remat,
                                pin_out=pin_out, cache_axis=cache_axis,
                                microbatches=microbatches, shape=shape)
    try:
        m = measure(cell)
    except Exception as e:
        why = f"{type(e).__name__}: {e}".splitlines()[0]
        m = {"lower_s": 0.0, "memory": {"error": why}, "cost": {"error": why},
             "collectives": {"error": why}}
    if notes is not None:
        notes.update(m.get("notes", {}))
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "chips": chips, "kind": cell.shape.kind,
        "params": cell.model_params_bytes,
        "lower_s": round(m["lower_s"], 1), "compile_s": None,
        "tag": extra_tag,
        "memory": m["memory"], "cost": m["cost"],
        "collectives": m["collectives"], "torch": torch.__version__,
    }


def _repeated(scans: list) -> str:
    """What :attr:`StepTrace.repeated` says, in words."""
    if not scans:
        return "every step traced"
    first = min(f for f, _, _ in scans)
    return (f"{sum(t for _, t, _ in scans):,} of "
            f"{sum(n for _, _, n in scans):,} steps of {len(scans)} scan(s) "
            f"counted by repetition, from step {first:,}")


def _buffers(top: list) -> str:
    """:attr:`StepTrace.at_peak` in words."""
    return ", ".join(f"{dt} {list(shape)} {b:,} B" for shape, dt, b in top)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--remat", choices=["on", "off"], default=None)
    ap.add_argument("--pin-out", action="store_true")
    ap.add_argument("--cache-axis", choices=["seq", "heads"], default="seq")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="a (data, model) debug mesh of D x M ranks in "
                         "place of the production meshes")
    ap.add_argument("--batch", type=int, default=None,
                    help="the global batch in place of the shape's")
    ap.add_argument("--seq", type=int, default=None,
                    help="the sequence length in place of the shape's")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]
    if args.mesh:
        meshes = [args.mesh]

    if args.all:
        cells = [(a, s.name) for a, s, ok, _ in configs.cells() if ok]
    else:
        cells = [(args.arch, args.shape)]

    if args.mesh:
        d, m = (int(x) for x in args.mesh.split("x"))
        placeholder_group(d * m)
    placeholder_group()
    remat = None if args.remat is None else args.remat == "on"
    n_fail = 0
    for arch, shape in cells:
        for mp in meshes:
            name = mp if isinstance(mp, str) else (
                "2x16x16" if mp else "16x16")
            tag = f"{arch}__{shape}__{name}"
            if args.tag:
                tag += f"__{args.tag}"
            fname = os.path.join(args.out, tag + ".json")
            if os.path.exists(fname):
                print(f"SKIP {tag} (cached)")
                continue
            notes = {}
            try:
                rec = run_cell(arch, shape, multi_pod=mp is True,
                               debug_mesh=mp if isinstance(mp, str) else None,
                               batch=args.batch, seq=args.seq,
                               fsdp=not args.no_fsdp,
                               seq_shard=not args.no_seq_shard,
                               remat=remat, extra_tag=args.tag,
                               pin_out=args.pin_out,
                               cache_axis=args.cache_axis,
                               microbatches=args.microbatches, notes=notes)
                with open(fname, "w") as f:
                    json.dump(rec, f, indent=1)
                c = rec["cost"]
                m = rec["memory"]
                if "error" in c:
                    print(f"ERR  {tag}: {c['error']}", flush=True)
                    continue
                k = rec["collectives"]
                print(f"OK   {tag}: flops={c['flops']:.3e} "
                      f"args={m['argument_bytes']:.3e}B/device "
                      f"out={m['output_bytes']:.3e}B/device "
                      f"temp={m['temp_bytes']:.3e}B/device "
                      f"collectives={k['total_bytes']:.3e}B "
                      f"{ {n: b for n, b in k['bytes'].items() if b} } "
                      f"({rec['lower_s']}s, torch {rec['torch']}); "
                      f"{_repeated(notes['repeated'])}; at the peak: "
                      f"{_buffers(notes['at_peak'])}", flush=True)
            except Exception as e:
                n_fail += 1
                print(f"FAIL {tag}: {type(e).__name__}: {e}")
                traceback.print_exc(limit=3)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
