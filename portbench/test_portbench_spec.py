"""``BENCHMARK.json`` against the files it names and the contract's
shape: every entry resolves (a configuration to its file and its
system's module, a traffic mix to its file and its driver's module, a
per-layer metric to its reader), every cell reports what it must, and
its chips are ones its driver runs on."""
import json
import re

import pytest

from portbench import spec

BENCH = spec.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == TOP
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_resolves(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"])
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    doc = json.loads((spec.ROOT / c["file"]).read_text())
    assert doc["name"] == c["name"] and doc["source"] == c["source"]
    assert doc["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
    # a key cut from the source is one the configuration has
    keys = set(doc) | set(doc.get("config", {}))
    assert all(NAME.match(k) and k in keys for k in c["reduced"])
    system = spec.system(doc["system"])
    assert callable(system.load) and callable(system.judge)
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_and_reports(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and w["chips"] in (1, 4)
    assert len(w["why"]) <= 200
    cell = spec.cell(BENCH, w["name"])
    assert spec.traffic_path(w["traffic"]).exists()
    # the mix's driver drives the configuration's system on these chips
    drv = spec.driver(cell.traffic["kind"])
    assert drv.SYSTEM == cell.config["system"]
    assert w["chips"] in drv.CHIPS
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        # the end-to-end metric a per-layer one moves is reported here
        assert m["moves"] in names


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert spec.metric_path(m["name"]).exists()
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"
