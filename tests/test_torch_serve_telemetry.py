"""The serving telemetry of the port (cluster_tools_tpu_torch/core/
telemetry.py and core/runtime.py): cumulative-bucket histograms, the
Prometheus writer and its promtool-style lint, the flight recorder, the
canonical stage and metric-family registries, the native-library cache
counters and the lock-order witness — the tests of tests/test_telemetry.py
and tests/test_analysis.py for these pieces, run against the port, with
the histograms and the lint held to the JAX package's on the same
inputs."""

import ast
import json
import os
import threading
import time

import pytest

from cluster_tools_tpu.core import telemetry as jax_telemetry
from cluster_tools_tpu_torch.core import runtime, telemetry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "cluster_tools_tpu_torch")


@pytest.fixture(autouse=True)
def _port_telemetry_reset():
    yield
    telemetry.reset()


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


# ---------------------------------------------------------------------------
# registries: every stage and metric-family literal of the port is
# canonical
# ---------------------------------------------------------------------------

_STAGE_FUNCS = {"stage", "stage_add", "stage_bytes"}


def _stage_literals():
    found = {}
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", None)
            arg = node.args[0]
            if name in _STAGE_FUNCS and isinstance(arg, ast.Constant) \
                    and isinstance(arg.value, str):
                found.setdefault(arg.value, os.path.relpath(path, ROOT))
    return found


def test_stage_literals_are_registered():
    found = _stage_literals()
    bad = {k: v for k, v in found.items() if not telemetry.is_registered(k)}
    assert not bad, bad
    for name in ("sync-execute", "sync-compile", "store-write",
                 "edit:resolve", "edit:solve", "edit:patch", "edit:write"):
        assert name in found, name


def test_metric_literals_are_registered():
    found = {}
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                             str) \
                    and node.value.startswith("ctt_") \
                    and node.value.replace("_", "").isalnum() \
                    and node.value == node.value.lower():
                found.setdefault(node.value, os.path.relpath(path, ROOT))
    fams = {k: v for k, v in found.items()
            if not k.startswith("ctt_torch")}
    bad = {k: v for k, v in fams.items()
           if not telemetry.is_registered_metric(k)}
    assert not bad, bad
    for name in ("ctt_server_request_latency_seconds", "ctt_slo_burn_rate",
                 "ctt_telemetry_dropped_spans_total",
                 "ctt_edit_round_trip_seconds"):
        assert name in fams, name
    # the port's families are the JAX package's names
    assert telemetry.METRIC_REGISTRY <= jax_telemetry.METRIC_REGISTRY


def test_emitted_families_are_registered():
    """Every family the runtime, the telemetry and the SLO engine emit at
    run time is a registered name, and one the JAX package registers."""
    from cluster_tools_tpu_torch.core import runtime, slo

    eng = slo.SLOEngine()
    eng.record("edit", 0.01)
    names = [f[0] for f in runtime.metrics_families()
             + telemetry.metrics_families() + eng.metrics_families()]
    assert "ctt_exec_cache_events_total" in names
    assert "ctt_slo_burn_rate" in names
    for name in names:
        assert telemetry.is_registered_metric(name), name
        assert jax_telemetry.is_registered_metric(name), name


# ---------------------------------------------------------------------------
# histograms and the Prometheus writer, held to the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bounds,values", [
    ((0.01, 0.1, 1.0), (0.005, 0.05, 0.5, 0.5, 5.0)),
    ((1.0,), (1.0,)),                         # le is inclusive
    (jax_telemetry.DEFAULT_LATENCY_BUCKETS,
     (0.001, 0.02, 0.02, 0.3, 2.4, 7.0, 40.0)),
])
def test_histogram_matches_jax(bounds, values):
    h = telemetry.Histogram(bounds)
    hj = jax_telemetry.Histogram(bounds)
    for v in values:
        h.observe(v)
        hj.observe(v)
    assert h.cumulative() == hj.cumulative()
    assert list(h.cumulative())[-1] == "+Inf"
    assert (h.count, h.sum) == (hj.count, hj.sum)
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert h.quantile(q) == hj.quantile(q)
    assert h.to_samples({"lane": "edit"}) == hj.to_samples({"lane": "edit"})
    assert telemetry.DEFAULT_LATENCY_BUCKETS == \
        jax_telemetry.DEFAULT_LATENCY_BUCKETS


def test_histogram_merge_and_copy():
    a = telemetry.Histogram((0.1, 1.0))
    b = telemetry.Histogram((0.1, 1.0))
    a.observe(0.05)
    b.observe(0.5)
    c = a.copy()
    c.merge(b)
    assert a.count == 1
    assert c.cumulative() == {"0.1": 1, "1.0": 2, "+Inf": 2}
    with pytest.raises(ValueError):
        a.merge(telemetry.Histogram((0.5,)))
    with pytest.raises(ValueError):
        telemetry.Histogram(())


def test_prometheus_writer_matches_jax(tmp_path):
    h = telemetry.Histogram((0.1, 1.0))
    for v in (0.05, 0.5, 2.0):
        h.observe(v)
    families = [
        ("ctt_server_queue_depth", "gauge", "Requests waiting", [(None, 3)]),
        ("ctt_server_in_flight", "gauge", "Per-tenant in flight",
         [({"tenant": "alice"}, 2), ({"tenant": 'bo"b\\n'}, 1)]),
        telemetry.histogram_family("ctt_server_request_latency_seconds",
                                   "Request latency",
                                   [({"lane": "edit"}, h)]),
    ]
    ours = str(tmp_path / "port.prom")
    theirs = str(tmp_path / "jax.prom")
    telemetry.write_prometheus(ours, families)
    jax_telemetry.write_prometheus(theirs, families)
    text = open(ours).read()
    assert text == open(theirs).read()
    lines = text.splitlines()
    assert lines[:3] == ["# HELP ctt_server_queue_depth Requests waiting",
                         "# TYPE ctt_server_queue_depth gauge",
                         "ctt_server_queue_depth 3"]
    assert 'ctt_server_request_latency_seconds_bucket' \
        '{lane="edit",le="+Inf"} 3' in lines
    assert telemetry.lint_prometheus(text) == []
    assert jax_telemetry.lint_prometheus(text) == []


_MALFORMED = [
    "ctt_x 1\n",                                     # no TYPE
    "# TYPE 0bad gauge\n0bad 1\n",                   # bad name
    '# TYPE ctt_x gauge\nctt_x{l=a} 1\n',            # unquoted label
    '# TYPE ctt_x gauge\nctt_x{l="a\\q"} 1\n',       # bad escape
    "# TYPE ctt_x gauge\nctt_x abc\n",               # non-float value
    "# TYPE ctt_x gauge\nctt_x 1\nctt_x 2\n",        # duplicate series
    "# TYPE ctt_x wibble\nctt_x 1\n",                # unknown TYPE
    # histogram invariants: monotone buckets, +Inf present, +Inf ==
    # _count, _sum present
    "# TYPE ctt_h histogram\n" + 'ctt_h_bucket{le="0.1"} 5\n'
    'ctt_h_bucket{le="1.0"} 3\nctt_h_bucket{le="+Inf"} 5\n'
    "ctt_h_sum 1\nctt_h_count 5\n",
    "# TYPE ctt_h histogram\n" + 'ctt_h_bucket{le="0.1"} 1\n'
    "ctt_h_sum 1\nctt_h_count 1\n",
    "# TYPE ctt_h histogram\n" + 'ctt_h_bucket{le="+Inf"} 4\n'
    "ctt_h_sum 1\nctt_h_count 5\n",
    "# TYPE ctt_h histogram\n" + 'ctt_h_bucket{le="+Inf"} 1\n'
    "ctt_h_count 1\n",
]


@pytest.mark.parametrize("text", _MALFORMED)
def test_lint_rejects_what_the_jax_lint_rejects(text):
    errors = telemetry.lint_prometheus(text)
    assert errors
    assert errors == jax_telemetry.lint_prometheus(text)


def test_lint_accepts_a_correct_histogram():
    good = ("# TYPE ctt_h histogram\n" + 'ctt_h_bucket{le="0.1"} 1\n'
            'ctt_h_bucket{le="+Inf"} 2\nctt_h_sum 0.3\nctt_h_count 2\n')
    assert telemetry.lint_prometheus(good) == []


def test_runtime_and_telemetry_families_lint_clean(tmp_path):
    path = str(tmp_path / "m.prom")
    telemetry.write_prometheus(path, runtime.metrics_families()
                               + telemetry.metrics_families())
    text = open(path).read()
    assert telemetry.lint_prometheus(text) == []
    assert "# TYPE ctt_exec_cache_hit_ratio gauge" in text
    assert "ctt_telemetry_dropped_spans_total 0" in text


def test_ring_drops_are_counted():
    telemetry.configure(enabled=True, ring_size=4)
    for i in range(10):
        telemetry.record(f"s{i}", 0.0, 1.0)
    assert len(telemetry.spans_snapshot()) == 4
    assert telemetry.dropped_count() == 6
    fams = {f[0]: f for f in telemetry.metrics_families()}
    assert fams["ctt_telemetry_dropped_spans_total"][3] == [(None, 6)]


# ---------------------------------------------------------------------------
# the native-library cache counters (the port's executable cache)
# ---------------------------------------------------------------------------

def test_library_cache_counts_a_warm_resolution_as_a_hit():
    from cluster_tools_tpu_torch import native

    native.library()                      # built or loaded before
    before = runtime.exec_cache_snapshot()
    path = native.library()
    delta = runtime.exec_cache_delta(before)
    assert delta == {"hits": 1}
    assert os.path.isfile(path)
    assert set(before) == {"compiles", "hits", "disk_hits"}
    led = runtime.ledger_snapshot()["exec_cache"]
    assert led["entries"] >= 1 and led["bytes"] > 0


def test_library_cache_counts_a_compile_and_a_disk_hit(tmp_path,
                                                       monkeypatch):
    """A fresh source compiles once; a second process-level cache (the
    memory tier cleared) finds it in the build directory."""
    from cluster_tools_tpu_torch.core import build

    src = tmp_path / "one.cpp"
    src.write_text('extern "C" int ctt_one() { return 1; }\n')
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_built", {})
    cmd = ["g++", "-O1", "-shared", "-fPIC"]
    before = runtime.exec_cache_snapshot()
    lib = build.build_shared("ctt_one", [str(src)], cmd)
    assert runtime.exec_cache_delta(before) == {"compiles": 1}
    build._built.clear()
    before = runtime.exec_cache_snapshot()
    assert build.build_shared("ctt_one", [str(src)], cmd) == lib
    assert runtime.exec_cache_delta(before) == {"disk_hits": 1}


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def test_flight_record_dump_contents(tmp_path):
    telemetry.configure(enabled=True)
    with telemetry.correlation("req_42"):
        with telemetry.span("block:0", cat="block", block=0) as sp:
            telemetry.annotate_memory(sp)
    path = telemetry.flight_record(
        str(tmp_path), "tenant-fault:req_42",
        extra={"request": "req_42", "tenant": "alice"})
    assert os.path.basename(path).startswith("flightrec_tenant-fault")
    assert not [p for p in os.listdir(str(tmp_path)) if ".tmp" in p]
    with open(path) as f:
        doc = json.load(f)
    assert doc["reason"] == "tenant-fault:req_42"
    assert doc["extra"] == {"request": "req_42", "tenant": "alice"}
    assert doc["n_spans"] == len(doc["spans"]) >= 2
    assert any(s["attrs"].get("corr") == "req_42" for s in doc["spans"])
    assert doc["memory"]["probe"]["host"]["rss"] > 0
    assert doc["memory"]["rollup"]["peak_host_rss_gb"] > 0
    assert doc["process_count"] == 1
    assert telemetry.flight_record_count() == 1
    fams = {f[0]: f for f in telemetry.metrics_families()}
    assert fams["ctt_telemetry_flight_records_total"][3] == [(None, 1)]


def test_flight_record_works_with_telemetry_disabled(tmp_path):
    assert not telemetry.enabled()
    with open(telemetry.flight_record(str(tmp_path), "sigterm")) as f:
        doc = json.load(f)
    assert doc["n_spans"] == 0 and doc["spans"] == []
    assert doc["memory"]["probe"]["host"]["hwm"] > 0


def test_install_flight_recorder_chains_and_uninstalls(tmp_path):
    import sys as _sys

    seen = []
    prev = _sys.excepthook
    _sys.excepthook = lambda *a: seen.append(a)
    try:
        uninstall = telemetry.install_flight_recorder(
            str(tmp_path), extra_fn=lambda: {"stage": "serve"})
        try:
            err = ValueError("boom")
            _sys.excepthook(ValueError, err, None)
        finally:
            uninstall()
        assert len(seen) == 1 and seen[0][1] is err
        recs = [p for p in os.listdir(str(tmp_path))
                if p.startswith("flightrec_")]
        assert len(recs) == 1
        with open(os.path.join(str(tmp_path), recs[0])) as f:
            doc = json.load(f)
        assert doc["reason"] == "exception"
        assert doc["extra"]["exc_type"] == "ValueError"
        assert doc["extra"]["stage"] == "serve"
    finally:
        _sys.excepthook = prev


# ---------------------------------------------------------------------------
# lock-order witness
# ---------------------------------------------------------------------------

@pytest.fixture
def witness():
    runtime.lock_witness_configure(enabled=True, ring=64)
    try:
        yield
    finally:
        runtime.lock_witness_configure(enabled=False)


def test_witness_detects_seeded_inversion(witness):
    lock_a = runtime.named_lock("A")
    lock_b = runtime.named_lock("B")

    def a_then_b():
        with lock_a:
            with lock_b:
                pass

    t = threading.Thread(target=a_then_b)
    t.start()
    t.join(10)
    assert not t.is_alive()
    with lock_b:
        with lock_a:
            pass
    report = runtime.lock_witness_report()
    inversions = [v for v in report["violations"]
                  if v["kind"] == "lock-order-inversion"]
    assert inversions, report
    assert inversions[0]["edge"] == ["B", "A"]
    assert inversions[0]["cycle"][0] == inversions[0]["cycle"][-1] == "A"
    assert set(report["locks"]) == {"A", "B"}


def test_witness_blocking_under_lock_and_reentrancy(witness, tmp_path):
    lock = runtime.named_lock("L")
    rlock = runtime.named_lock("R", rlock=True)
    with runtime.witness_blocking("free-io"):
        pass
    with rlock:
        with rlock:
            pass
    with lock:
        with runtime.witness_blocking("status-write"):
            pass
    report = runtime.lock_witness_report()
    assert [(v["kind"], v["blocking"], v["held"])
            for v in report["violations"]] == \
        [("blocking-under-lock", "status-write", ["L"])]
    out = runtime.lock_witness_dump(str(tmp_path / "WITNESS.json"))
    with open(out) as f:
        assert json.load(f)["locks"] == ["L", "R"]


def test_witness_disabled_is_off_path():
    runtime.lock_witness_configure(enabled=False)
    assert not runtime.witness_enabled()
    assert isinstance(runtime.named_lock("prod"), type(threading.Lock()))
    assert runtime.witness_blocking("a") is runtime.witness_blocking("b")
    t0 = time.monotonic()
    for _ in range(100_000):
        with runtime.witness_blocking("hot"):
            pass
    assert time.monotonic() - t0 < 1.0
    report = runtime.lock_witness_report()
    assert report["violations"] == [] and report["locks"] == []


def test_served_run_is_witness_clean(witness, tmp_path):
    """A server run with a failing tenant, metrics and status writes
    under the witness: the server's lock is seen, and no status or
    metrics write ever ran under it."""
    from cluster_tools_tpu_torch.core.server import \
        ResidentSegmentationServer

    from test_torch_server import StubPipeline

    srv = ResidentSegmentationServer(str(tmp_path),
                                     StubPipeline(n_blocks=2,
                                                  fail_tag="BAD"))
    handles = [srv.submit(t, v) for t, v in
               (("alice", "A"), ("mallory", "BAD"), ("bob", "B"))]
    srv.start()
    srv.shutdown(drain=True, timeout=30)
    assert all(h.done() for h in handles)
    report = runtime.lock_witness_report()
    assert "server:segmentation_server" in report["locks"]
    assert report["violations"] == []
