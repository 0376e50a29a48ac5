"""The ``swin-train.crops96`` cell at test size on the CPU: the result
line, the planted faults and the controls, each of which ``correct`` has
to catch; its three per-layer readers on hand-built traces; the profiler
ranges of the model dropped from the device operations; and a program
without the model failing at once."""

from __future__ import annotations

import json
import sys
from types import SimpleNamespace

import pytest

from portbench import run
from portbench.reduce import Trace, device_ops, metric_reader

CELL = "swin-train.crops96"
SEED = 3000000123
#: the cell at test size: Swin UNETR at feature size 12, heads 1-2-3-6,
#: window 3 on 32^3 crops (stages 1-3 pad and shift, stage 4 clamps its
#: window), computing in float32 so that the CPU's bfloat16 rounding stays
#: out of the comparison
SMALL = {"traffic": {"batch": 2, "crop": [32, 32, 32], "pool": 6,
                     "micro_batch": 2, "trace_steps": 2, "max_steps": 8},
         "config": {"feature_size": 12, "num_heads": [1, 2, 3, 6],
                    "window_size": 3, "compute_dtype": "float32"}}
READERS = ("swin_mfu.train", "swin_attn_share.train",
           "instnorm_roofline.train")


def _run(capsys, trace=0):
    rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "1",
                   "--trace", str(trace)], device="cpu", overrides=SMALL)
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_prints_the_contract_line(capsys, trace):
    rc, line, err = _run(capsys, trace)
    assert rc == 0
    assert line["correct"] is True, err
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                   "attn_grad_err"}
    assert line["failed"] == 0 and line["attempted"] >= 4
    if trace:
        # the CPU has no device operations: only the FLOP share reads
        assert set(line["metrics"]) == {"swin_mfu.train"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"train_mvox_per_s", "setup_s"}


def _driver():
    return run.load_driver("swin_train")


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


def _half_batch(monkeypatch):
    from cluster_tools_tpu_torch.models import train as T

    orig = T.make_train_step

    def make(model, lr=1e-3):
        step = orig(model, lr)

        def half(state, x, y):
            n = x.shape[0] // 2
            return step(state, x[:n], y[:n])
        return half

    monkeypatch.setattr(T, "make_train_step", make)


@pytest.mark.parametrize("fault", ["no_shift", "no_bias", "state_unchanged",
                                   "loss_altered", "half_batch"])
def test_a_planted_fault_is_not_correct(capsys, monkeypatch, fault):
    if fault == "state_unchanged":
        _state_unchanged(monkeypatch)
    elif fault == "loss_altered":
        _loss_altered(monkeypatch)
    elif fault == "half_batch":
        _half_batch(monkeypatch)
    if fault in ("no_shift", "no_bias"):
        with _driver().planted(fault):
            rc, line, _ = _run(capsys)
    else:
        rc, line, _ = _run(capsys)
    assert rc == 0
    assert line["correct"] is False, (fault, line["checks"])


def test_controls_go_through_the_run_s_decision(tmp_path):
    from portbench import controls

    wl, cfg = run.load_cell(CELL)
    wl = {**wl, "traffic": {**wl["traffic"], **SMALL["traffic"]}}
    cfg = {**cfg, **SMALL["config"]}
    recs = list(controls.records(wl, cfg, "cpu", str(tmp_path), [21], 1))
    sides = [r["side"] for r in recs]
    assert sides == ["program", "control", "no_shift", "no_bias",
                     "half_batch", "state_unchanged"]
    for r in recs:
        assert r["correct"] is (r["side"] == "program"), r


def test_a_program_without_the_model_fails_at_once(monkeypatch, capsys):
    """The parent of this cell has no ``models/swin_unetr.py``: the run
    raises on its import, the first thing the driver does, and prints no
    result."""
    monkeypatch.setitem(sys.modules,
                        "cluster_tools_tpu_torch.models.swin_unetr", None)
    with pytest.raises(ImportError):
        run.main(["--workload", CELL, "--seed", "1", "--seconds", "1"],
                 device="cpu", overrides=SMALL)
    assert capsys.readouterr().out == ""


# --- the readers ------------------------------------------------------------

def _trace(ops=(), window_s=2.0, **info):
    return Trace(cell={}, config={}, window_s=window_s,
                 device_ops=list(ops), info=dict(info))


def test_readers_on_a_hand_built_trace():
    from portbench.refs.cost import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

    ops = [("fmha_cutlassF_bf16_aligned_64x64_rf_sm80", 0.0, 0.2),
           ("fmha_cutlassB_bf16_aligned_64x64_k64_sm80", 0.2, 0.5),
           ("void (anonymous namespace)::groupnorm_apply_kernel<__nv_"
            "bfloat16, true, 1>(...)", 0.5, 0.6),
           ("void (anonymous namespace)::groupnorm_bwd_dx_kernel<__nv_"
            "bfloat16, true, 2>(...)", 0.6, 0.7),
           ("sm90_xmma_fprop_implicit_gemm_bf16", 0.7, 1.5)]
    tr = _trace(ops, window_s=2.0, steps=4, step_flop=1e12,
                norm_bytes=1e9)
    read = {n: metric_reader(n) for n in READERS}
    assert read["swin_mfu.train"](tr) == pytest.approx(
        100 * 4e12 / 2.0 / PEAK_BF16_FLOPS)
    # 0.5 s of attention over 1.5 s busy
    assert read["swin_attn_share.train"](tr) == pytest.approx(100 / 3)
    assert read["instnorm_roofline.train"](tr) == pytest.approx(
        100 * 4e9 / PEAK_HBM_BYTES / 0.2)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_their_inputs(name):
    """A trace without the model's kernels or counts (the CPU's, or a
    program without the model) reads nothing."""
    tr = _trace([("sm90_xmma_fprop_implicit_gemm_bf16", 0.0, 1.0),
                 ("groupnorm_gelu_apply_kernel", 1.0, 1.1)])
    assert metric_reader(name)(tr) is None


def test_model_ranges_are_not_device_operations():
    """``record_function`` ranges mirrored on the device's timeline are
    user annotations: ``device_ops`` keeps the kernels only."""
    from torch.autograd import DeviceType

    def ev(name, dev, annotation):
        return SimpleNamespace(
            name=name, device_type=dev, is_user_annotation=annotation,
            time_range=SimpleNamespace(start=10.0, end=20.0))

    names = ("swin-forward", "swin-embed", "swin-window-attn", "swin-mlp",
             "swin-merge", "swin-decoder")
    events = [ev(n, DeviceType.CUDA, True) for n in names] + \
        [ev(n, DeviceType.CPU, False) for n in names] + \
        [ev("fmha_cutlassF_bf16_aligned", DeviceType.CUDA, False)]
    prof = SimpleNamespace(events=lambda: events)
    assert [n for n, _, _ in device_ops(prof)] == \
        ["fmha_cutlassF_bf16_aligned"]


def test_instnorm_least_bytes_are_five_accesses_a_value():
    """The decoder's 26 InstanceNorms of a 96^3 crop, at 10 B a bfloat16
    value: x read and y written forward, x and dy read and dx written
    backward."""
    from portbench.refs.swin_cost import instnorm_shapes, instnorm_step_bytes

    _, cfg = run.load_cell(CELL)
    shapes = instnorm_shapes((96, 96, 96), cfg)
    assert len(shapes) == 26
    assert shapes[0] == (48, 96 ** 3)
    values = sum(c * s for c, s in shapes)
    assert instnorm_step_bytes(4, (96, 96, 96), cfg) == 10.0 * 4 * values


def test_the_epsilon_only_kernel_is_left_out_of_the_gaps():
    """A kernel with one weight per output channel (the decoder's 1x1x1
    kernel on the single input channel) reaches the loss through the
    InstanceNorm's epsilon alone: its gradient is round-off, and the gaps
    leave it out; a gap on any other leaf still reads."""
    import torch

    from portbench.refs.swin_unetr import epsilon_only, swin_compare

    gen = torch.Generator().manual_seed(0)
    shapes = {"encoders.0.conv3.weight": (48, 1, 1, 1, 1),
              "encoders.0.conv1.weight": (48, 1, 3, 3, 3),
              "out.weight": (12, 48, 1, 1, 1), "norm.weight": (48,),
              "stages.0.blocks.0.attn.qkv.weight": (144, 48)}
    assert [k for k, s in shapes.items()
            if epsilon_only(torch.zeros(s))] == ["encoders.0.conv3.weight"]
    g = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    p0 = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    p3 = {k: p0[k] - 1e-3 * g[k] for k in shapes}
    losses = [1.0, 0.9, 0.8]

    def gaps(gp, pp):
        return swin_compare(losses, gp, p0, pp, losses, g, p3)

    clean = gaps(g, p3)
    assert clean["grad_gap"] == clean["change_gap"] == 0.0
    noisy = dict(g, **{"encoders.0.conv3.weight":
                       10 * g["encoders.0.conv3.weight"]})
    moved = dict(p3, **{"encoders.0.conv3.weight": p0[
        "encoders.0.conv3.weight"]})
    assert gaps(noisy, moved)["grad_gap"] == 0.0
    assert gaps(noisy, moved)["change_gap"] == 0.0
    off = dict(g, **{"out.weight": 1.5 * g["out.weight"]})
    assert gaps(off, p3)["grad_gap"] == pytest.approx(0.5, rel=1e-6)
