"""Multi-pod dry run: trace every (arch x input-shape x mesh) cell's step
on ``meta`` tensors over a placeholder group of 512 ranks, and extract
the roofline terms.  The port of ``repro/launch/dryrun.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

Where the reference lowers and compiles each cell with XLA on 512
placeholder host devices, the port builds its mesh over torch's ``fake``
process group (rank 0 of 512, from ``torch.testing._internal.
distributed.fake_pg``, a testing module of torch: it sends nothing, and
no collective runs), started by :func:`main` or :func:`run_cell`, never
at import.  Each cell's step (``launch.specs.build_cell``) runs once on
its ``meta`` arguments, which hold shapes and no memory, the kernels
taking their plain versions.  Per cell, JSON with the reference's keys:

* ``memory.argument_bytes``: rank 0's bytes of every argument leaf under
  the cell's placements, exact;
* ``memory.output_bytes``: the same for the step's outputs: an output
  that is an argument updated in place keeps that argument's placement,
  one that ``--pin-out`` pins takes the cell's ``out_shardings``, and any
  other is counted whole (no sharding rule places it);
* ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count
  of that call: the whole step, every rank's share together (the
  reference's XLA count is one device's share of the partitioned
  program), of the plain versions' products (the kernels skip dead
  tiles; the count does not);
* ``lower_s``: the seconds of that call (nothing is compiled:
  ``compile_s`` is ``None``);
* ``collectives``: the reference's error form, ``{"error": ...}``: with
  no GSPMD, no sharding rule turns the step into collectives;
* ``temp_bytes``, ``generated_code_bytes``, ``bytes_accessed`` and
  ``transcendentals``: ``None``, as the reference records what XLA does
  not report.

:func:`collective_bytes`, the reference's parser of post-SPMD HLO text,
is kept as the pure function it is.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import time
import traceback

from .. import configs
from ..sharding import partition
from . import mesh as mesh_mod
from . import specs as specs_mod

#: the placeholder group's size: the multi-pod mesh's 2 x 16 x 16 ranks
PLACEHOLDER_RANKS = 512

NO_COLLECTIVES = ("not counted: the port has no GSPMD, and no DTensor "
                  "sharding rule turns its step into collectives on the "
                  "placeholder group")

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


def output_bytes(cell: specs_mod.Cell, out) -> int:
    """One device's bytes of the step's outputs ``out`` (the module
    docstring says how each is placed)."""
    placed = {id(t): sh for t, sh in
              specs_mod.placed_leaves(cell.args, cell.in_shardings)}
    pins = cell.out_shardings or (None,) * len(out)
    total = 0
    for o, pin in zip(out, pins):
        for t, sh in specs_mod.placed_leaves((o,), (pin,)):
            sh = sh or placed.get(id(t))
            total += (t.numel() * t.element_size() if sh is None else
                      partition.local_bytes(t, sh.spec, sh.mesh))
    return total


def measure(cell: specs_mod.Cell) -> dict:
    """``lower_s`` and the record's ``memory`` and ``cost`` for one call of
    the cell's step on its ``meta`` arguments."""
    from torch.utils.flop_counter import FlopCounterMode
    args = specs_mod.argument_bytes(cell)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        out = cell.step_fn(*cell.args)
    lower_s = time.perf_counter() - t0
    return {"lower_s": lower_s,
            "memory": {"argument_bytes": args,
                       "output_bytes": output_bytes(cell, out),
                       "temp_bytes": None, "generated_code_bytes": None},
            "cost": {"flops": fc.get_total_flops(), "bytes_accessed": None,
                     "transcendentals": None}}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             fsdp: bool = True, seq_shard: bool = True,
             remat: bool | None = None, extra_tag: str = "",
             pin_out: bool = False, cache_axis: str = "seq",
             microbatches: int = 1) -> dict:
    placeholder_group()
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod, device="cpu")
    chips = mesh_mod.mesh_chips(mesh)
    cell = specs_mod.build_cell(arch, shape_name, mesh, fsdp=fsdp,
                                seq_shard=seq_shard, remat=remat,
                                pin_out=pin_out, cache_axis=cache_axis,
                                microbatches=microbatches)
    m = measure(cell)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips, "kind": cell.shape.kind,
        "params": cell.model_params_bytes,
        "lower_s": round(m["lower_s"], 1), "compile_s": None,
        "tag": extra_tag,
        "memory": m["memory"], "cost": m["cost"],
        "collectives": {"error": NO_COLLECTIVES},
    }


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
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    if args.all:
        cells = [(a, s.name) for a, s, ok, _ in configs.cells() if ok]
    else:
        cells = [(args.arch, args.shape)]

    placeholder_group()
    remat = None if args.remat is None else args.remat == "on"
    n_fail = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
            if args.tag:
                tag += f"__{args.tag}"
            fname = os.path.join(args.out, tag + ".json")
            if os.path.exists(fname):
                print(f"SKIP {tag} (cached)")
                continue
            try:
                rec = run_cell(arch, shape, multi_pod=mp,
                               fsdp=not args.no_fsdp,
                               seq_shard=not args.no_seq_shard,
                               remat=remat, extra_tag=args.tag,
                               pin_out=args.pin_out,
                               cache_axis=args.cache_axis,
                               microbatches=args.microbatches)
                with open(fname, "w") as f:
                    json.dump(rec, f, indent=1)
                c = rec["cost"]
                m = rec["memory"]
                print(f"OK   {tag}: flops={c['flops']:.3e} "
                      f"args={m['argument_bytes']:.3e}B/device "
                      f"out={m['output_bytes']:.3e}B/device "
                      f"({rec['lower_s']}s)", flush=True)
            except Exception as e:
                n_fail += 1
                print(f"FAIL {tag}: {type(e).__name__}: {e}")
                traceback.print_exc(limit=3)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
