"""Every cell, configuration, driver and metric of BENCHMARK.json is a file found by name."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from benchmark import run

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[key]}) == len(BENCH[key])


def test_metrics_are_well_formed():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    spec = run.cell_spec(cell)
    assert spec.workload["config"] == spec.entry["config"] == spec.config["name"]
    assert spec.entry["chips"] == 1
    driver = importlib.import_module(f"benchmark.drivers.{spec.workload['driver']}")
    assert callable(driver.build)
    e2e = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in e2e and len(e2e) == 2  # the cell's rate and its set-up
    assert spec.per_layer, "every cell reports a per-layer metric"
    for m in spec.per_layer:
        assert m["moves"] in e2e
        assert callable(run.metric_reader(m["name"]))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(entry):
    cfg = run.load_json(run.ROOT / entry["file"])
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["model"] in ("niw", "bbv") and cfg["n"] > 0 and cfg["d"] > 0 and cfg["k_max"] > 0


def test_a_new_cell_is_one_json_file(tmp_path, monkeypatch):
    """A later cell that reuses a driver needs its workload file and its
    BENCHMARK.json entry only: cell_spec finds it by name."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "dpmm_niw_1m_d256.more", "config": "dpmm_niw_1m_d256",
                               "traffic": "more", "chips": 1, "why": "a test"})
    root = tmp_path / "root"
    (root / "benchmark" / "workloads").mkdir(parents=True)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    workload = run.load_json(run.HERE / "workloads" / "dpmm_niw_1m_d256.fused.json")
    (root / "benchmark" / "workloads" / "dpmm_niw_1m_d256.more.json").write_text(json.dumps(workload))
    (root / "benchmark" / "configs").mkdir()
    (root / "benchmark" / "configs" / "dpmm_niw_1m_d256.json").write_text(
        (run.HERE / "configs" / "dpmm_niw_1m_d256.json").read_text())
    monkeypatch.setattr(run, "ROOT", root)
    monkeypatch.setattr(run, "HERE", root / "benchmark")
    spec = run.cell_spec("dpmm_niw_1m_d256.more")
    assert spec.workload == workload and spec.config["n"] == 1_000_000
    # its rate is reported once BENCHMARK.json names the cell under the metric's `workloads`
    assert {m["name"] for m in spec.end_to_end} == {"setup_s"}
