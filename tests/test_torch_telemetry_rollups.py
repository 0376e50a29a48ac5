"""The span rollups, memory sampler, trace shards and rollup-diff gate of
the port's telemetry (``core/telemetry.py``) against the JAX package's, on
the CPU.

Each scenario records the same spans into both packages' recorders on the
fixed-step fake clock of ``tests/test_telemetry.py`` and holds the
rollups, histograms, merged traces and diffs equal; the memory readings
(real host RSS) are compared by their keys.  The tests of
``tests/test_telemetry.py`` for these pieces run on the port here.  A
port workflow's status JSONs carry the same keys and stage counts with
telemetry on and off."""

import json
import os
import time

import pytest

from cluster_tools_tpu.core import telemetry as jax_telemetry
from cluster_tools_tpu_torch.core import runtime, telemetry


class FakeClock:
    """tests/test_telemetry.py's deterministic fixed-step clock."""

    def __init__(self, step=0.001):
        self.t = 0.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


@pytest.fixture(autouse=True)
def _port_telemetry_reset():
    yield
    telemetry.reset()


@pytest.fixture()
def fake_clock():
    clk = FakeClock()
    telemetry.configure(enabled=True, clock=clk)
    return clk


def _on_both(fn):
    """``fn(tel)`` on the JAX package's recorder and on the port's, each
    armed with a fresh fake clock; returns both results."""
    out = []
    for tel in (jax_telemetry, telemetry):
        tel.reset()
        tel.configure(enabled=True, clock=FakeClock())
        try:
            out.append(fn(tel))
        finally:
            tel.reset()
    return out


def _record_known_intervals(tel):
    tel.record("sync-execute", 0.0, 1.0)
    tel.record("d2h-dense", 0.5, 1.5)       # overlaps the first
    tel.record("host-map", 0.0, 3.0)        # host: never busy time
    tel.record("wait-a", 0.0, 0.005, cat="queue-wait")
    tel.record("wait-b", 0.0, 0.05, cat="queue-wait")
    return tel.spans_snapshot()


# ---------------------------------------------------------------------------
# rollups
# ---------------------------------------------------------------------------

def test_rollups_exact_on_known_intervals(fake_clock):
    """tests/test_telemetry.py's interval arithmetic on the port."""
    spans = _record_known_intervals(telemetry)
    assert telemetry.device_busy_seconds(spans) == pytest.approx(2.0)
    assert telemetry.busy_timeline(spans) == [(0.0, 1.5)]
    assert telemetry.device_busy_fraction(4.0, spans) == pytest.approx(0.5)
    assert telemetry.pipeline_bubble_fraction(spans, wall=3.0) == \
        pytest.approx(0.5)
    hist = telemetry.queue_wait_histogram(bins=(0.01, 0.1), spans=spans)
    assert hist["count"] == 2
    assert hist["sum"] == pytest.approx(0.055)
    assert hist["buckets"] == {"0.01": 1, "0.1": 2, "+Inf": 2}
    summ = telemetry.summary(wall=4.0)
    assert summ["device_busy_s"] == pytest.approx(2.0)
    assert summ["device_busy_frac"] == pytest.approx(0.5)
    assert summ["by_cat"]["queue-wait"] == 2


@pytest.mark.parametrize("wall", [None, 4.0, 0.0])
def test_rollups_match_jax(wall):
    """Every rollup of the same spans equals the JAX package's."""
    def run(tel):
        spans = _record_known_intervals(tel)
        tel.record("h2d-upload", 2.0, 2.25)
        tel.record("cap-retry", 2.2, 2.4, count=3)
        with tel.span("block:0", cat="block", block=0):
            tel.record_stage("device-cc", 0.125)
        spans = tel.spans_snapshot()
        return {
            "busy_s": tel.device_busy_seconds(spans),
            "timeline": tel.busy_timeline(spans),
            "frac": tel.device_busy_fraction(wall, spans),
            "bubble": tel.pipeline_bubble_fraction(spans, wall=wall),
            "window": tel.trace_window(spans),
            "hist": tel.queue_wait_histogram(spans=spans),
            "merged": tel._merge_intervals([(3, 4), (0, 1), (0.5, 2)]),
            "rollup": tel.rollup_spans(spans, wall=wall, dropped=2),
            "summary": tel.summary(wall=wall),
        }

    jax_r, port_r = _on_both(run)
    assert port_r == jax_r


def test_rollups_of_an_empty_trace_match_jax():
    def run(tel):
        return (tel.rollup_spans([]), tel.device_busy_fraction(spans=[]),
                tel.pipeline_bubble_fraction([]), tel.trace_window([]),
                tel.summary())

    jax_r, port_r = _on_both(run)
    assert port_r == jax_r
    assert port_r[1] is None and port_r[3] == 0.0


def test_device_busy_crosschecks_accumulator(fake_clock):
    """The span view and the runtime's accumulator are fed by the same
    ``stage_add`` calls: their device-busy sums agree."""
    st0 = runtime.stages_snapshot()
    for sec in (0.25, 0.5, 0.125):
        runtime.stage_add("sync-execute", sec)
    runtime.stage_add("h2d-upload", 0.1)
    runtime.stage_add("host-map", 9.0)            # must NOT count
    acc_busy = sum(v for k, v in runtime.stages_delta(st0).items()
                   if k.startswith(telemetry.DEVICE_STAGE_PREFIXES))
    assert telemetry.device_busy_seconds() == pytest.approx(acc_busy,
                                                            rel=1e-6)


def test_register_stage_and_metric_extension():
    assert not telemetry.is_registered("ext-custom")
    assert not telemetry.is_registered_metric("ctt_ext_custom")
    try:
        assert telemetry.register_stage("ext-custom") == "ext-custom"
        assert telemetry.is_registered("ext-custom")
        assert telemetry.register_metric("ctt_ext_custom") == \
            "ctt_ext_custom"
        assert telemetry.is_registered_metric("ctt_ext_custom")
    finally:
        telemetry.STAGE_REGISTRY.discard("ext-custom")
        telemetry.METRIC_REGISTRY.discard("ctt_ext_custom")


def test_current_correlation(fake_clock):
    assert telemetry.current_correlation() is None
    with telemetry.correlation("aaaabbbbcccc"):
        assert telemetry.current_correlation() == "aaaabbbbcccc"
        with telemetry.correlation("ddddeeeeffff"):
            assert telemetry.current_correlation() == "ddddeeeeffff"
        with telemetry.span("work", cat="stage"):
            pass
    assert telemetry.current_correlation() is None
    assert telemetry.spans_snapshot()[0].attrs["corr"] == "aaaabbbbcccc"


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------

def test_host_peak_rss_helper():
    import resource

    mem = telemetry.host_memory_bytes()
    assert mem["rss"] > 0 and mem["hwm"] > 0
    gib = telemetry.host_peak_rss_gb()
    assert gib >= mem["hwm"] / 1024.0 ** 3 - 1e-9
    old_style = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    assert gib < old_style + 1e-3


def test_memory_sampler_background_thread(fake_clock):
    """The optional background probe records counter samples while
    running and stops cleanly."""
    with telemetry.MemorySampler(interval_s=0.005):
        deadline = time.time() + 2.0
        while telemetry.memory_rollup()["counters"].get(
                "host_rss_gb", {}).get("n", 0) < 2:
            assert time.time() < deadline, "sampler recorded nothing"
            time.sleep(0.005)
    n = telemetry.memory_rollup()["counters"]["host_rss_gb"]["n"]
    time.sleep(0.02)      # stopped: no further samples
    assert telemetry.memory_rollup()["counters"]["host_rss_gb"]["n"] == n


def test_memory_sampler_disabled_records_nothing():
    sampler = telemetry.MemorySampler(interval_s=0.001).start()
    time.sleep(0.01)
    sampler.stop()
    sampler.stop()        # idempotent
    assert telemetry.spans_snapshot() == []


def test_summary_memory_section_has_the_jax_keys():
    def run(tel):
        with tel.span("block:3", cat="block", block=3) as sp:
            tel.annotate_memory(sp)
        return tel.summary()

    jax_r, port_r = _on_both(run)
    assert port_r.keys() == jax_r.keys()
    assert port_r["memory"].keys() == jax_r["memory"].keys()
    assert port_r["memory"]["counters"].keys() == \
        jax_r["memory"]["counters"].keys()
    assert port_r["memory"]["peak_host_rss_gb"] > 0


# ---------------------------------------------------------------------------
# trace shards and their merge
# ---------------------------------------------------------------------------

def test_trace_shard_roundtrip(fake_clock, tmp_path):
    with telemetry.span("block:0", cat="block", block=0) as sp:
        telemetry.annotate_memory(sp)
    path = str(tmp_path / "trace_shard_p0.json")
    n = telemetry.export_trace_shard(path, process_index=0,
                                     process_count=2, wall_anchor=100.0,
                                     perf_anchor=1.0)
    sh = telemetry.load_trace_shard(path)
    assert sh["process_index"] == 0 and sh["process_count"] == 2
    assert sh["wall_anchor"] == 100.0 and sh["perf_anchor"] == 1.0
    assert len(sh["spans"]) == n >= 2          # block span + counter
    spans = [telemetry._span_from_dict(d) for d in sh["spans"]]
    assert spans == telemetry.spans_snapshot()


def test_trace_shards_match_jax(tmp_path):
    """The same spans give the same shard document (memory-free spans)."""
    def run(tel):
        _record_known_intervals(tel)
        path = str(tmp_path / f"{tel.__name__}.json")
        tel.export_trace_shard(path, process_index=1, process_count=2,
                               wall_anchor=5.0, perf_anchor=2.0)
        return tel.load_trace_shard(path)

    jax_r, port_r = _on_both(run)
    assert port_r == jax_r


def _synthetic_shard(path, pidx, wall_anchor, perf_anchor, spans):
    doc = {"process_index": pidx, "process_count": 2,
           "wall_anchor": wall_anchor, "perf_anchor": perf_anchor,
           "dropped": 0,
           "spans": [{"sid": i + 1, "parent": None, "name": n,
                      "cat": c, "t0": t0, "t1": t1, "tid": 1,
                      "tname": "MainThread", "attrs": a}
                     for i, (n, c, t0, t1, a) in enumerate(spans)]}
    with open(path, "w") as f:
        json.dump(doc, f)


def test_merge_chrome_traces_rebases_remaps_and_matches_jax(tmp_path):
    """Two shards with different clock origins merge into one trace:
    pids remapped per process, timestamps rebased through the anchors,
    the merged rollups aggregating device_busy_s across processes — and
    the JAX package's merge of the same shards gives the same events
    (its process names aside) and the same rollups."""
    p0 = str(tmp_path / "trace_shard_p0.json")
    p1 = str(tmp_path / "trace_shard_p1.json")
    _synthetic_shard(p0, 0, 100.0, 1000.0, [
        ("sync-execute", "stage", 1000.0, 1000.5,
         {"mem_dev_peak_gb": 1.0}),
        ("host-map", "stage", 1000.5, 1000.6, {})])
    _synthetic_shard(p1, 1, 100.5, 5.0, [
        ("sync-execute", "stage", 5.0, 5.25, {"mem_dev_peak_gb": 2.0})])
    out = str(tmp_path / "merged.json")
    m = telemetry.merge_chrome_traces([p1, p0], out)
    assert m["n_processes"] == 2
    assert [p["pid"] for p in m["processes"]] == [1, 2]
    assert [p["clock_offset_s"] for p in m["processes"]] == [0.0, 0.5]
    assert {p["process_index"]: p["device_busy_s"]
            for p in m["processes"]} == {0: 0.5, 1: 0.25}
    assert m["rollups"]["device_busy_s"] == pytest.approx(0.75)
    assert m["rollups"]["memory"]["peak_device_gb"] == pytest.approx(2.0)
    with open(out) as f:
        events = json.load(f)["traceEvents"]
    assert {e["pid"] for e in events} == {1, 2}
    assert all(e["ts"] >= 0 for e in events if "ts" in e)
    assert all({"ph", "pid", "name"} <= set(e) for e in events)

    jout = str(tmp_path / "merged_jax.json")
    jm = jax_telemetry.merge_chrome_traces([p0, p1], jout)
    assert m == dict(jm, n_events=m["n_events"])
    assert m["n_events"] == jm["n_events"]
    with open(jout) as f:
        jevents = json.load(f)["traceEvents"]

    def strip(evs):
        return [e for e in evs if e["name"] != "process_name"]

    assert strip(events) == strip(jevents)


def test_merge_chrome_traces_empty_raises(tmp_path):
    with pytest.raises(ValueError):
        telemetry.merge_chrome_traces([], str(tmp_path / "out.json"))


# ---------------------------------------------------------------------------
# the rollup-diff gate
# ---------------------------------------------------------------------------

_BASE = {"stage_seconds": {"sync-execute": 8.0, "h2d-upload": 0.6,
                           "host-solve": 2.0},
         "device_busy_s": 8.6, "pipeline_bubble_frac": 0.02}
_MEM = {**_BASE, "memory": {"peak_host_rss_gb": 4.0, "peak_device_gb": 2.0}}

_DIFF_CASES = {
    "pass": (_BASE, {"stage_seconds": {"sync-execute": 8.2,
                                       "h2d-upload": 0.5,
                                       "host-solve": 2.2},
                     "device_busy_s": 8.7, "pipeline_bubble_frac": 0.03},
             {}),
    "device_busy": (_BASE, {"stage_seconds": {"sync-execute": 12.0,
                                              "h2d-upload": 0.6,
                                              "host-solve": 2.0},
                            "device_busy_s": 12.6,
                            "pipeline_bubble_frac": 0.02}, {}),
    "host_warns": (_BASE, dict(_BASE, stage_seconds={
        "sync-execute": 8.0, "h2d-upload": 0.6, "host-solve": 9.0}), {}),
    "abs_floor": ({"stage_seconds": {"sync-execute": 0.001},
                   "device_busy_s": 0.001},
                  {"stage_seconds": {"sync-execute": 0.01},
                   "device_busy_s": 0.01}, {}),
    "bubble": (_BASE, dict(_BASE, pipeline_bubble_frac=0.2), {}),
    "bubble_wide": (_BASE, dict(_BASE, pipeline_bubble_frac=0.2),
                    {"bubble_abs": 0.5}),
    "new_stage": (_BASE, {**_BASE, "stage_seconds": {
        **_BASE["stage_seconds"], "sync-meta": 1.0}}, {}),
    "memory": (_MEM, {**_MEM, "memory": {"peak_host_rss_gb": 4.0,
                                         "peak_device_gb": 3.5}}, {}),
    "memory_tight": (_MEM, {**_MEM, "memory": {"peak_host_rss_gb": 4.2,
                                               "peak_device_gb": 2.0}},
                     {"mem_abs_floor_gb": 0.05, "rel_threshold": 0.01}),
    "no_memory_baseline": (_BASE, _MEM, {}),
}


@pytest.mark.parametrize("case", sorted(_DIFF_CASES))
def test_diff_rollups_matches_jax(case):
    """tests/test_telemetry.py's diff_rollups cases, each diff equal to
    the JAX package's."""
    a, b, kw = _DIFF_CASES[case]
    diff = telemetry.diff_rollups(a, b, **kw)
    assert diff == jax_telemetry.diff_rollups(a, b, **kw)
    want = {"pass": [], "device_busy": ["stage:sync-execute",
                                        "device_busy_s"],
            "host_warns": [], "abs_floor": [],
            "bubble": ["pipeline_bubble_frac"], "bubble_wide": [],
            "new_stage": ["stage:sync-meta"],
            "memory": ["memory:peak_device_gb"],
            "memory_tight": ["memory:peak_host_rss_gb"],
            "no_memory_baseline": []}[case]
    assert diff["regressions"] == want
    assert diff["regressed"] is bool(want)
    if case == "host_warns":
        assert "stage:host-solve" in diff["warnings"]
    if case == "no_memory_baseline":
        assert diff["memory"]["peak_host_rss_gb"]["skipped"] is True


def test_diff_rollups_malformed_artifacts_never_crash():
    cases = [
        {}, {"stage_seconds": None}, {"stage_seconds": "junk"},
        {"memory": "junk"}, {"memory": {"peak_host_rss_gb": "junk"}},
        {"stage_seconds": {"sync-execute": "junk"},
         "device_busy_s": None, "pipeline_bubble_frac": "junk",
         "memory": {"peak_host_rss_gb": None}},
        telemetry.rollup_spans([]),
    ]
    for a in cases:
        for b in cases:
            diff = telemetry.diff_rollups(a, b)
            assert diff["regressed"] is False, (a, b, diff)
            assert diff == jax_telemetry.diff_rollups(a, b)


# ---------------------------------------------------------------------------
# status JSONs with telemetry on and off
# ---------------------------------------------------------------------------

def test_status_jsons_do_not_depend_on_telemetry(tmp_path):
    """A port workflow (morphology, two tasks) writes status JSONs with the
    same keys and the same stage counts with telemetry on and off; the
    traced run's spans roll up into a summary."""
    import numpy as np

    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir

    seg = np.zeros((16, 16, 16), "uint64")
    seg[:, :8] = 1
    seg[4:8, 4:8, 4:8] = 2
    statuses = {}
    for on in (False, True):
        root = str(tmp_path / f"on{int(on)}")
        path = os.path.join(root, "d.n5")
        with ctp.file_reader(path) as f:
            ds = f.require_dataset("seg", shape=seg.shape, chunks=[8, 8, 8],
                                   dtype="uint64")
            ds[:] = seg
            ds.attrs["maxId"] = 2
        cfg = os.path.join(root, "cfg")
        ConfigDir(cfg).write_global_config(
            {"block_shape": [8, 8, 8], "device": "cpu",
             "telemetry_enabled": on})
        tmp = os.path.join(root, "tmp")
        wf = ctp.MorphologyWorkflow(
            input_path=path, input_key="seg", output_path=path,
            output_key="morphology", tmp_folder=tmp, config_dir=cfg,
            max_jobs=2, target="threads")
        assert ctp.build([wf], raise_on_failure=True)
        assert telemetry.enabled() is on
        statuses[on] = {}
        for name in sorted(os.listdir(tmp)):
            if name.endswith(".status"):
                with open(os.path.join(tmp, name)) as fh:
                    statuses[on][name] = json.load(fh)
        if on:
            summ = telemetry.summary()
            assert summ["by_cat"].get("job", 0) >= 2
    assert statuses[True].keys() == statuses[False].keys()
    for name in statuses[True]:
        on, off = statuses[True][name], statuses[False][name]
        assert on.keys() == off.keys(), name
        assert on.get("stage_counts") == off.get("stage_counts"), name
