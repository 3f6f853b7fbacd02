"""BENCHMARK.json against the contract's shape, and every cell built from
its files by name."""

import json
import re

import pytest

from benchmark import harness

from .conftest import ROOT, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in spec()["workloads"]]


def test_top_level_keys_and_limits():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert s["paths"] == ["benchmark"] and s["command"][1] == "benchmark/run.py"
    assert isinstance(s["run_seconds"], int) and 1 <= s["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size < 64 * 1024
    names = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    names += [c["name"] for c in s["configs"]] + CELLS
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in s["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in s["end_to_end"]}
    for m in s["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert harness._applies(e2e[m["moves"]], cell), (m["name"], cell)


@pytest.mark.parametrize("name", CELLS)
def test_cell_builds_from_its_files(name):
    cell = harness.load_cell(name)
    assert cell.chips == 1
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    driver = harness.load_module("drivers", cell.traffic["driver"])
    assert callable(driver.run) and callable(driver.control_numbers)
    for m in cell.per_layer:
        assert callable(harness.load_module("metrics", m["name"]).read)
    for m in cell.end_to_end:
        if m["name"] != "setup_s":
            assert m["name"] in cell.traffic["metrics"].values()
    assert cell.limits["numbers"] and all(v > 0 for v in cell.limits["numbers"].values())


@pytest.mark.parametrize("config", spec()["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    body = json.loads((ROOT / config["file"]).read_text())
    assert body["name"] == config["name"] and body["source"] == config["source"]
    assert body["reduced"] == config["reduced"] == []


def test_result_line_keys(capsys):
    cell = harness.load_cell(CELLS[0])
    run = {"correct": True, "attempted": 3, "failed": 0,
           "checks": [{"name": "loss", "value": 0.1, "limit": 0.2, "ok": True},
                      {"name": "grad_first", "value": float("inf"), "limit": 0.3, "ok": False}]}
    harness.print_result(cell, run, {"setup_s": {"value": 1.0, "unit": "s"}},
                         {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 1})
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["checks"]["grad_first"][0] > 1e300
    assert err.strip().splitlines()[-1].startswith("check grad_first")


def test_forbidden_modules_are_seen(monkeypatch):
    import sys
    import types

    assert harness.forbidden_loaded() == [] or "jax" not in sys.modules
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("jaxlib.xla"))
    assert "jaxlib" in harness.forbidden_loaded()
