"""Every cell of BENCHMARK.json resolves to files that load, and names only
metrics that BENCHMARK.json defines and the harness can read."""
from __future__ import annotations

import importlib
import json
import re

import pytest

from perfbench.harness import cell as harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == KEYS
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["perfbench"]
    assert all("/" not in w or w.startswith("perfbench/")
               for w in BENCH["command"][1:])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_fields(entry):
    allowed = {"name", "unit", "better", "source", "workloads"}
    if "bound" in entry:
        allowed |= {"bound"}
        assert 0.01 <= entry["bound"] <= 0.25
        assert entry["source"] in ("host_clock", "device_trace")
    else:
        allowed |= {"layer", "moves"}
        moves = {m["name"] for m in BENCH["end_to_end"]}
        assert entry["moves"] in moves
        # the metric reports only where its end-to-end metric does
        e2e = harness.find(BENCH["end_to_end"], entry["moves"], "metric")
        for w in entry["workloads"]:
            assert harness.applies(e2e, w)
        assert callable(harness.reader(entry["name"]))
    assert set(entry) <= allowed
    assert UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    for w in entry.get("workloads", []):
        assert w in CELLS


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    c = harness.resolve(BENCH, name)
    assert c.cell["chips"] in (1, 4)
    for step in ("setup", "window", "traced_window", "release", "check"):
        assert hasattr(c.driver.Run, step)
    assert hasattr(c.driver, "CONTROL") and hasattr(c.driver, "LIMITS")
    names = [m["name"] for m in c.e2e]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    assert len(c.cell["why"]) <= 200


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    path = ROOT / conf["file"]
    assert path.is_file() and conf["file"].startswith("perfbench/")
    data = json.loads(path.read_text())
    assert data["name"] == conf["name"]
    assert conf["reduced"] == []
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_mixes_name_known_drivers(name):
    """A mix names its driver and holds parameters of the traffic only:
    nothing in it names the program's modules."""
    w = harness.find(BENCH["workloads"], name, "workload")
    path = harness.PERFBENCH / "traffic" / f"{w['traffic']}.json"
    mix = harness.load_json(path)
    importlib.import_module(f"perfbench.drivers.{mix['driver']}")
    assert "repro_torch" not in path.read_text()


def test_paths_hold_only_allowed_names():
    bad = [p for p in (ROOT / "perfbench").rglob("*")
           if "__pycache__" not in p.parts
           and not re.match(r"^[A-Za-z0-9_.\-/]+$",
                            str(p.relative_to(ROOT)))]
    assert not bad
