"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json`` and a per-layer metric ``metrics/<name>.py``
(a module with ``read(ctx)``), all under this directory.  What runs a
cell is found by name too: a configuration's ``"system"`` names
``systems/<system>.py`` (how the system under test is loaded from the
file and how its results are judged), and a mix's ``"kind"`` names
``drivers/<kind>.py`` (how the window drives it).  A new cell is new
entries and new files, and no file here changes for it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def config_path(name: str) -> pathlib.Path:
    return HERE / "configs" / f"{name}.json"


def traffic_path(name: str) -> pathlib.Path:
    return HERE / "traffic" / f"{name}.json"


def metric_path(name: str) -> pathlib.Path:
    return HERE / "metrics" / f"{name}.py"


def system(name: str):
    """The module of a system under test: ``load(config, mix)`` and
    ``judge(system, ledger)``."""
    return importlib.import_module(f"portbench.systems.{name}")


def driver(kind: str):
    """The module of a kind of traffic: its ``Driver(run)`` class, the
    ``SYSTEM`` it drives and the ``CHIPS`` counts it runs on."""
    return importlib.import_module(f"portbench.drivers.{kind}")


def reader(name: str):
    """The ``read(ctx)`` of a per-layer metric's file."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}",
        metric_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Cell:
    """One workload with what it names resolved."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list            # the entries this cell reports
    per_layer: list


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str) -> Cell:
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(HERE.parent / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(traffic_path(w["traffic"])) as f:
        mix = json.load(f)
    return Cell(name=name, chips=w["chips"], config=config, traffic=mix,
                end_to_end=[m for m in bench["end_to_end"]
                            if reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if reports(m, name)])
