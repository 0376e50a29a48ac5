"""Whole runs of each cell at test size on the CPU: the result line's
form, the import boundary, the controls and the planted faults, each of
which ``correct`` has to catch."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench import run

from .conftest import ROOT, SMALL

CELLS = ("cremi-fused.n5", "unet-train.crops")
SEED = 3000000123


def _run(capsys, cell, trace=0, seed=SEED):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "1",
                   "--trace", str(trace)], device="cpu",
                  overrides=SMALL[cell])
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_prints_the_contract_line(capsys, cell, trace):
    rc, line, err = _run(capsys, cell, trace)
    assert rc == 0
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(line)
    assert line["correct"] is True, err
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert "window_s" in line["device"] and "busy_s" in line["device"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in line["metrics"]
        assert len(line["metrics"]) == 2
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)


def test_no_jax_after_a_run():
    """In a fresh process: a CPU run loads no module of JAX or of the JAX
    package (top-level names compared whole)."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from portbench import run\n"
        "from portbench.tests.conftest import SMALL\n"
        "rc = run.main(['--workload', 'unet-train.crops', '--seed', '5', "
        "'--seconds', '1'], device='cpu', "
        "overrides=SMALL['unet-train.crops'])\n"
        "assert rc == 0, rc\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'cluster_tools_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'cluster_tools_tpu_torch' in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   capture_output=True, timeout=600)


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cluster_tools_tpu_torch_x", sys)
    assert "cluster_tools_tpu_torch_x" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in run.forbidden_modules()


def test_no_result_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", "unet-train.crops", "--seed", "1",
                   "--seconds", "1"])
    out, _ = capsys.readouterr()
    assert rc != 0 and out == ""


def test_no_result_beside_no_program(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: a non-zero exit and
    no result."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "cremi-fused.n5", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""


# --- planted faults ---------------------------------------------------------

def _alter_store_writes(monkeypatch, key):
    """Alter the first voxel of the block at the origin where the program
    writes dataset ``key``."""
    from cluster_tools_tpu_torch.core import storage

    orig = storage.Dataset.__setitem__

    def setitem(self, bb, value):
        if self.path.endswith(os.path.join("out.n5", key)) and all(
                (s.start or 0) == 0 for s in bb):
            value = np.array(value, copy=True)
            value.flat[0] = value.max() + 1
        return orig(self, bb, value)

    monkeypatch.setattr(storage.Dataset, "__setitem__", setitem)


def _half_the_blocks(monkeypatch):
    from cluster_tools_tpu_torch.workflows import fused_pipeline as fp

    orig = fp.FusedSegmentationBlocks.blocks_in_volume

    def half(self, shape, block_shape=None):
        blocks = orig(self, shape, block_shape)
        return blocks[:len(blocks) // 2]

    monkeypatch.setattr(fp.FusedSegmentationBlocks, "blocks_in_volume", half)


def _state_unchanged(monkeypatch):
    from cluster_tools_tpu_torch.models import train as T

    orig = T.make_train_step

    def make(model, lr=1e-3):
        step = orig(model, lr)

        def frozen(state, x, y):
            _, loss = step(state, x, y)
            return state, loss
        return frozen

    monkeypatch.setattr(T, "make_train_step", make)


def _half_the_batch(monkeypatch):
    from cluster_tools_tpu_torch.models import train as T

    orig = T.make_train_step

    def make(model, lr=1e-3):
        step = orig(model, lr)
        return lambda state, x, y: step(state, x[:x.shape[0] // 2],
                                        y[:y.shape[0] // 2])

    monkeypatch.setattr(T, "make_train_step", make)


def _loss_altered(monkeypatch):
    from cluster_tools_tpu_torch.models import train as T

    orig = T.make_train_step

    def make(model, lr=1e-3):
        step = orig(model, lr)

        def altered(state, x, y):
            state, loss = step(state, x, y)
            return state, loss * 1.05
        return altered

    monkeypatch.setattr(T, "make_train_step", make)


def _all_merged(monkeypatch):
    """Every fragment written into one segment."""
    from cluster_tools_tpu_torch.core import storage

    orig = storage.Dataset.__setitem__

    def setitem(self, bb, value):
        if self.path.endswith(os.path.join("out.n5", "seg")):
            value = np.ones_like(np.asarray(value))
        return orig(self, bb, value)

    monkeypatch.setattr(storage.Dataset, "__setitem__", setitem)


FAULTS = [
    ("cremi-fused.n5", "every fragment in one segment", _all_merged),
    ("cremi-fused.n5", "fragments altered",
     lambda mp: _alter_store_writes(mp, "ws")),
    ("cremi-fused.n5", "segmentation altered",
     lambda mp: _alter_store_writes(mp, "seg")),
    ("cremi-fused.n5", "half the blocks left out", _half_the_blocks),
    ("unet-train.crops", "state unchanged", _state_unchanged),
    ("unet-train.crops", "half the batch left out", _half_the_batch),
    ("unet-train.crops", "loss altered", _loss_altered),
]


@pytest.mark.parametrize("cell,name,plant", FAULTS,
                         ids=[f"{c}-{n}" for c, n, _ in FAULTS])
def test_a_planted_fault_is_not_correct(capsys, monkeypatch, cell, name,
                                        plant):
    plant(monkeypatch)
    rc, line, err = _run(capsys, cell)
    assert rc == 0
    assert line["correct"] is False, (name, line["checks"])


# --- the controls -----------------------------------------------------------

def _small(cell):
    wl, cfg = run.load_cell(cell)
    small = SMALL[cell]
    return ({**wl, "traffic": {**wl["traffic"], **small["traffic"]}},
            {**cfg, **small.get("config", {})})


@pytest.mark.parametrize("cell,seeds", [("cremi-fused.n5", [11, 12]),
                                        ("unet-train.crops", [21, 22])])
def test_controls_go_through_the_run_s_decision(tmp_path, cell, seeds):
    """The driver's control records, judged by ``run.passes`` as a run is:
    the program's correct, the control's and each planted fault's not
    (the chip reads them at full size with portbench/controls.py)."""
    from portbench import controls

    wl, cfg = _small(cell)
    recs = list(controls.records(wl, cfg, "cpu", str(tmp_path), seeds, 2))
    sides = {r["side"] for r in recs}
    assert "program" in sides and "control" in sides
    program = {r["seed"]: r for r in recs if r["side"] == "program"}
    for r in recs:
        if r["side"] == "program":
            assert r["correct"] is True, r
        elif r["side"] == "no_node_moves":
            # the node moves find nothing to move on this data (at full
            # size too, PERF.md): the same objective as with them
            assert r["seg_objective_gap"] == \
                program[r["seed"]]["seg_objective_gap"], r
        else:
            assert r["correct"] is False, r


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(card, cell):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", "4000000001", "--seconds", "2"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
