"""The benchmark's files: every name resolves to a file, and a cell, a
configuration or a metric is added by adding files."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from portbench import run
from portbench.reduce import metric_reader

HERE = run.HERE
BENCH = os.path.join(run.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(BENCH) as f:
        return json.load(f)


def _workload_files():
    return sorted(f[:-5] for f in os.listdir(os.path.join(HERE, "workloads"))
                  if f.endswith(".json"))


@pytest.mark.parametrize("cell", _workload_files())
def test_workload_names_existing_config_and_driver(cell):
    wl, cfg = run.load_cell(cell)
    assert wl["name"] == cell
    assert cfg["name"] == wl["config"]
    assert os.path.exists(os.path.join(HERE, "drivers",
                                       f"{wl['driver']}.py"))
    driver = run.load_driver(wl["driver"])
    assert callable(driver.run) and callable(driver.controls)
    assert wl["chips"] in (1, 4)
    assert wl["limits"], "a cell compares at least one number"


def test_benchmark_entries_resolve_to_files():
    b = _bench()
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    files = {c["name"]: c["file"] for c in b["configs"]}
    for name, path in files.items():
        with open(os.path.join(run.ROOT, path)) as f:
            assert json.load(f)["name"] == name
    for w in b["workloads"]:
        wl, _ = run.load_cell(w["name"])
        assert wl["config"] == w["config"]
        assert wl["chips"] == w["chips"]
    for m in b["per_layer"]:
        assert metric_reader(m["name"]) is not None, m["name"]
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}


def test_names_units_and_bounds():
    b = _bench()
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]] + \
        [w["traffic"] for w in b["workloads"]]
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    assert 1 <= b["run_seconds"] <= 51
    n = len(b["workloads"])
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(set(names[:n])) == len(names[:n])


def test_a_cell_is_added_by_adding_files(tmp_path):
    """A copy of the harness finds a workload file that was only added."""
    base = tmp_path / "portbench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache"))
    before = {p: (base / p).read_bytes() for p in
              ("run.py", "reduce.py", "controls.py",
               "drivers/fused_chain.py")}
    src = json.loads((base / "workloads" / "cremi-fused.n5.json")
                     .read_text())
    src.update(name="cremi-fused.added", why="a cell added as a file")
    src["traffic"] = {**src["traffic"], "max_jobs": 4}
    (base / "workloads" / "cremi-fused.added.json").write_text(
        json.dumps(src))
    (base / "metrics" / "added_metric.py").write_text(
        "def read(trace):\n    return trace.window_s\n")
    wl, cfg = run.load_cell("cremi-fused.added", base=str(base))
    assert wl["traffic"]["max_jobs"] == 4
    assert cfg["name"] == "cremi-multicut"
    assert callable(run.load_driver(wl["driver"], base=str(base)).run)
    assert metric_reader("added_metric", base=str(base)) is not None
    for p, data in before.items():
        assert (base / p).read_bytes() == data
    assert "cremi-fused.added" not in _workload_files()
