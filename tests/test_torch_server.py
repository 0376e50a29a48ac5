"""The port's resident multi-tenant segmentation server
(cluster_tools_tpu_torch/core/server.py), driven with a STUB pipeline:
every scheduling, lifecycle, status, metrics and lane test of
tests/test_server.py run against the port (FIFO within a tenant,
round-robin across tenants at block granularity, graceful drain vs
cancel, per-request status JSONs, tenant fault isolation, the edit lane,
the admission hook, the SLO feed), plus the canonical-name registries and
the lock-order witness over a served run.  The real fused-ROI pipeline is
held against the JAX package's in tests/test_torch_serve_pipeline.py.
"""

import json
import threading
import time

import numpy as np
import pytest

from cluster_tools_tpu_torch.core import telemetry as port_telemetry
from cluster_tools_tpu_torch.core.server import ResidentSegmentationServer


@pytest.fixture(autouse=True)
def _port_telemetry_reset():
    """The port's telemetry state is module-global: restore it after
    every test so a test that arms the recorder leaks no spans."""
    yield
    port_telemetry.reset()


class StubPipeline:
    """Instant deterministic pipeline: records (tag, block) dispatch
    order so scheduling is assertable."""

    def __init__(self, n_blocks=3, delay=0.0, fail_tag=None):
        self.n_blocks = n_blocks
        self.delay = delay
        self.fail_tag = fail_tag
        self.order = []

    def prepare(self, volume):
        return {"tag": volume}

    def run_block(self, ctx, bid):
        if self.delay:
            time.sleep(self.delay)
        if ctx["tag"] == self.fail_tag:
            raise RuntimeError(f"injected failure for {ctx['tag']}")
        self.order.append((ctx["tag"], bid))
        return bid

    def finalize(self, ctx, block_results):
        return {"segmentation": np.asarray(block_results),
                "n_fragments": self.n_blocks,
                "n_segments": 1}


def test_fair_round_robin_across_tenants(tmp_path):
    """Two tenants' concurrent requests interleave at BLOCK granularity:
    neither tenant waits for the other's whole request."""
    pipe = StubPipeline(n_blocks=3)
    srv = ResidentSegmentationServer(str(tmp_path), pipe)
    ha = srv.submit("alice", "A")
    hb = srv.submit("bob", "B")
    srv.start()
    srv.shutdown(drain=True)
    assert pipe.order == [("A", 0), ("B", 0), ("A", 1), ("B", 1),
                          ("A", 2), ("B", 2)]
    assert ha.result(1)["n_segments"] == 1
    assert hb.result(1)["n_segments"] == 1


def test_fifo_within_tenant(tmp_path):
    """One tenant's requests run strictly in submit order (FIFO), even
    while a second tenant interleaves."""
    pipe = StubPipeline(n_blocks=2)
    srv = ResidentSegmentationServer(str(tmp_path), pipe)
    srv.submit("alice", "A1")
    srv.submit("alice", "A2")
    srv.submit("bob", "B1")
    srv.start()
    srv.shutdown(drain=True)
    a_events = [tag for tag, _ in pipe.order if tag.startswith("A")]
    assert a_events == ["A1", "A1", "A2", "A2"]
    # bob was not starved behind alice's queue
    assert pipe.order.index(("B1", 0)) < pipe.order.index(("A2", 0))


def test_status_json_and_telemetry(tmp_path):
    pipe = StubPipeline(n_blocks=4)
    srv = ResidentSegmentationServer(str(tmp_path), pipe)
    h = srv.submit("alice", "A")
    srv.start()
    srv.shutdown(drain=True)
    with open(h.status_path) as f:
        status = json.load(f)
    assert status["state"] == "done"
    assert status["tenant"] == "alice"
    assert status["n_blocks"] == 4 and status["blocks_done"] == 4
    assert status["wall_time"] >= status["queue_wait_s"] >= 0
    assert "exec_cache" in status and "stage_counts" in status
    assert status["error"] is None
    log = srv.stats()["requests"]
    assert len(log) == 1 and log[0]["state"] == "done"


def test_tenant_fault_isolation(tmp_path):
    """One tenant's failing request surfaces to THAT tenant only; the
    service and other tenants are unaffected."""
    pipe = StubPipeline(n_blocks=2, fail_tag="BAD")
    srv = ResidentSegmentationServer(str(tmp_path), pipe)
    hb = srv.submit("mallory", "BAD")
    ha = srv.submit("alice", "A")
    srv.start()
    srv.shutdown(drain=True)
    with pytest.raises(RuntimeError, match="injected failure"):
        hb.result(1)
    assert ha.result(1)["n_segments"] == 1
    with open(hb.status_path) as f:
        assert json.load(f)["state"] == "failed"


def test_tenant_fault_writes_flight_record(tmp_path):
    """An injected tenant fault leaves a flight-recorder dump in the
    server workdir carrying the failing request's correlation id, the
    error, and the queue state at fault time."""
    import glob
    import os

    pipe = StubPipeline(n_blocks=2, fail_tag="BAD")
    srv = ResidentSegmentationServer(str(tmp_path), pipe)
    hb = srv.submit("mallory", "BAD")
    ha = srv.submit("alice", "A")
    srv.start()
    srv.shutdown(drain=True)
    with pytest.raises(RuntimeError, match="injected failure"):
        hb.result(1)
    assert ha.result(1)["n_segments"] == 1
    recs = glob.glob(os.path.join(str(tmp_path), "flightrec_*.json"))
    assert len(recs) == 1, recs
    with open(recs[0]) as f:
        doc = json.load(f)
    assert doc["reason"] == f"tenant-fault:{hb.request_id}"
    assert doc["extra"]["request"] == hb.request_id
    assert doc["extra"]["tenant"] == "mallory"
    assert "injected failure" in doc["extra"]["error"]
    assert doc["extra"]["n_blocks"] == 2
    assert isinstance(doc["extra"]["pending_requests"], list)
    assert doc["memory"]["probe"]["host"]["rss"] > 0
    # healthy requests leave no dumps behind
    srv2 = ResidentSegmentationServer(str(tmp_path / "ok"), StubPipeline())
    h = srv2.submit("alice", "A")
    srv2.start()
    srv2.shutdown(drain=True)
    h.result(1)
    assert not glob.glob(os.path.join(str(tmp_path / "ok"),
                                      "flightrec_*.json"))


def test_status_json_carries_ledger(tmp_path):
    """Per-request status JSONs record the live-buffer ledger next to
    stage_counts/exec_cache."""
    from cluster_tools_tpu_torch.core import runtime as rt

    rt.ledger_clear()
    rt.ledger_add("exec_cache", 1024, 1)
    try:
        pipe = StubPipeline(n_blocks=1)
        srv = ResidentSegmentationServer(str(tmp_path), pipe)
        h = srv.submit("alice", "A")
        srv.start()
        srv.shutdown(drain=True)
        h.result(1)
        with open(h.status_path) as f:
            status = json.load(f)
        assert status["ledger"]["exec_cache"] == {"bytes": 1024,
                                                  "entries": 1}
    finally:
        rt.ledger_clear()


def test_shutdown_cancels_queue_without_drain(tmp_path):
    """shutdown(drain=False) cancels queued-but-unstarted requests and
    records them as cancelled; their callers get the error, not a hang."""
    pipe = StubPipeline(n_blocks=2)
    srv = ResidentSegmentationServer(str(tmp_path), pipe)
    h1 = srv.submit("alice", "A1")
    h2 = srv.submit("alice", "A2")
    srv.shutdown(drain=False)   # never started: everything queued
    for h in (h1, h2):
        with pytest.raises(RuntimeError, match="cancelled"):
            h.result(1)
        with open(h.status_path) as f:
            assert json.load(f)["state"] == "cancelled"
    with pytest.raises(RuntimeError, match="not accepting"):
        srv.submit("alice", "A3")


def test_shutdown_no_drain_finishes_inflight(tmp_path):
    """shutdown(drain=False) cancels only QUEUED requests; one the
    worker is mid-way through completes normally — its caller must
    never be left with an abandoned done-event."""
    started = threading.Event()

    class SlowStub(StubPipeline):
        def run_block(self, ctx, bid):
            started.set()
            time.sleep(0.02)
            return super().run_block(ctx, bid)

    pipe = SlowStub(n_blocks=5)
    srv = ResidentSegmentationServer(str(tmp_path), pipe)
    srv.start()
    h1 = srv.submit("alice", "A")
    h2 = srv.submit("alice", "B")     # FIFO: B waits behind A
    assert started.wait(5)
    srv.shutdown(drain=False)
    assert h1.result(5)["n_segments"] == 1      # in-flight completed
    with pytest.raises(RuntimeError, match="cancelled"):
        h2.result(5)
    with open(h1.status_path) as f:
        assert json.load(f)["state"] == "done"


def test_graceful_drain_finishes_queue(tmp_path):
    """shutdown(drain=True) completes every queued request before the
    worker exits."""
    pipe = StubPipeline(n_blocks=2, delay=0.002)
    srv = ResidentSegmentationServer(str(tmp_path), pipe)
    srv.start()
    handles = [srv.submit(f"t{i % 3}", f"R{i}") for i in range(9)]
    srv.shutdown(drain=True)
    assert all(h.done() for h in handles)
    assert sorted(srv.stats()["tenants_served"].items()) == \
        [("t0", 3), ("t1", 3), ("t2", 3)]


def test_drain_keeps_accepting(tmp_path):
    pipe = StubPipeline(n_blocks=1)
    srv = ResidentSegmentationServer(str(tmp_path), pipe)
    srv.start()
    h = srv.submit("alice", "A")
    assert srv.drain(timeout=5.0)
    assert h.done()
    h2 = srv.submit("alice", "A2")     # still accepting after drain()
    srv.shutdown(drain=True)
    assert h2.result(1)["n_segments"] == 1


def test_concurrent_submitters(tmp_path):
    """Thread-safe submit path: N tenant threads racing submissions all
    complete exactly once."""
    pipe = StubPipeline(n_blocks=1)
    srv = ResidentSegmentationServer(str(tmp_path), pipe)
    srv.start()
    handles = []
    lock = threading.Lock()

    def client(tenant):
        for i in range(5):
            h = srv.submit(tenant, f"{tenant}_{i}")
            with lock:
                handles.append(h)

    threads = [threading.Thread(target=client, args=(f"t{i}",))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    srv.shutdown(drain=True)
    assert len(handles) == 20 and all(h.done() for h in handles)
    assert sum(srv.stats()["tenants_served"].values()) == 20


def test_status_gauges_queue_depth_and_in_flight(tmp_path):
    """Every request status JSON carries the
    scheduler gauges — total queue_depth and per-tenant in_flight —
    snapshotted at claim time, present and non-negative."""
    pipe = StubPipeline(n_blocks=2)
    srv = ResidentSegmentationServer(str(tmp_path), pipe)
    handles = [srv.submit("alice", "A1"), srv.submit("alice", "A2"),
               srv.submit("bob", "B1")]
    srv.start()
    srv.shutdown(drain=True)
    statuses = []
    for h in handles:
        with open(h.status_path) as f:
            statuses.append(json.load(f))
    for status in statuses:
        assert isinstance(status["queue_depth"], int)
        assert status["queue_depth"] >= 1       # itself, at minimum
        assert isinstance(status["in_flight"], dict)
        assert all(isinstance(n, int) and n >= 0
                   for n in status["in_flight"].values())
        # consistency: the per-tenant gauges decompose the total
        assert sum(status["in_flight"].values()) == status["queue_depth"]
    # the first claimed request saw the whole pre-start backlog
    assert statuses[0]["queue_depth"] == 3
    assert statuses[0]["in_flight"] == {"alice": 2, "bob": 1}


def test_server_writes_metrics_prom(tmp_path):
    """The worker maintains a Prometheus text snapshot (metrics.prom):
    queue depth + per-tenant gauges + served counters + exec-cache hit
    ratio, in valid exposition format."""
    pipe = StubPipeline(n_blocks=2)
    srv = ResidentSegmentationServer(str(tmp_path), pipe)
    assert srv.metrics_path == str(tmp_path / "metrics.prom")
    srv.submit("alice", "A")
    srv.submit("bob", "B")
    srv.start()
    srv.shutdown(drain=True)
    assert srv.metrics_path is not None
    with open(srv.metrics_path) as f:
        text = f.read()
    assert "# TYPE ctt_server_queue_depth gauge" in text
    assert "# HELP ctt_server_queue_depth" in text
    assert "ctt_server_queue_depth 0" in text    # drained
    assert 'ctt_server_requests_served_total{tenant="alice"} 1' in text
    assert 'ctt_server_requests_served_total{tenant="bob"} 1' in text
    assert "# TYPE ctt_exec_cache_hit_ratio gauge" in text


def test_server_request_spans(tmp_path):
    """With telemetry armed, each request leaves a queue-wait span, one
    block span per block (tenant/request attributed), and a whole-
    request span — the queue-wait -> blocks -> tail timeline."""
    from cluster_tools_tpu_torch.core import telemetry

    telemetry.configure(enabled=True)
    pipe = StubPipeline(n_blocks=3)
    srv = ResidentSegmentationServer(str(tmp_path), pipe)
    h = srv.submit("alice", "A")
    srv.start()
    srv.shutdown(drain=True)
    assert h.done()
    spans = telemetry.spans_snapshot()
    reqs = [s for s in spans if s.cat == "request"]
    waits = [s for s in spans if s.cat == "queue-wait"]
    blocks = [s for s in spans if s.cat == "block"]
    assert len(reqs) == 1 and reqs[0].attrs["state"] == "done"
    assert reqs[0].attrs["tenant"] == "alice"
    assert len(waits) == 1
    assert len(blocks) == 3
    assert [s.attrs["block"] for s in blocks] == [0, 1, 2]
    assert all(s.attrs["request"] == h.request_id for s in blocks)
    # the request span covers its queue wait and every block
    assert reqs[0].t0 <= waits[0].t0
    assert all(reqs[0].t0 <= s.t0 and s.t1 <= reqs[0].t1
               for s in blocks)


def test_lane_in_status_log_and_spans(tmp_path):
    """Every surface that names a request also names its lane: status
    JSON, request log, queue-wait and request spans."""
    from cluster_tools_tpu_torch.core import telemetry

    telemetry.configure(enabled=True)
    pipe = StubPipeline(n_blocks=1)
    srv = ResidentSegmentationServer(str(tmp_path), pipe)
    he = srv.submit("alice", "A", lane="edit")
    hb = srv.submit("bob", "B")                      # default lane
    srv.start()
    srv.shutdown(drain=True)
    with open(he.status_path) as f:
        assert json.load(f)["lane"] == "edit"
    with open(hb.status_path) as f:
        assert json.load(f)["lane"] == "bulk"
    lanes = {r["request_id"]: r["lane"]
             for r in srv.stats()["requests"]}
    assert lanes == {he.request_id: "edit", hb.request_id: "bulk"}
    spans = telemetry.spans_snapshot()
    for cat in ("queue-wait", "request"):
        by_req = {s.attrs["request"]: s.attrs["lane"]
                  for s in spans if s.cat == cat}
        assert by_req == lanes


def test_latency_histograms_per_lane_and_tenant(tmp_path):
    pipe = StubPipeline(n_blocks=1)
    srv = ResidentSegmentationServer(str(tmp_path), pipe)
    srv.submit("alice", "A", lane="edit")
    srv.submit("alice", "B", lane="bulk")
    srv.submit("bob", "C", lane="bulk")
    srv.start()
    srv.shutdown(drain=True)
    lat, wait, tenant = srv.latency_histograms()
    assert {l: h.count for l, h in lat.items()} == {"edit": 1, "bulk": 2}
    assert {l: h.count for l, h in wait.items()} == {"edit": 1, "bulk": 2}
    assert {t: h.count for t, h in tenant.items()} == \
        {"alice": 2, "bob": 1}
    for h in lat.values():
        assert h.cumulative()["+Inf"] == h.count
        assert h.quantile(0.5) is not None


def test_occupancy_timeline_samples_all_events(tmp_path):
    """The occupancy timeline samples at enqueue, claim
    AND completion — no blind spots between claims."""
    pipe = StubPipeline(n_blocks=1)
    srv = ResidentSegmentationServer(str(tmp_path), pipe)
    srv.submit("alice", "A")
    srv.submit("bob", "B")
    srv.start()
    srv.shutdown(drain=True)
    tl = srv.occupancy_timeline()
    events = [s["event"] for s in tl]
    assert events.count("enqueue") == 2
    assert events.count("claim") == 2
    assert events.count("done") == 2
    for s in tl:
        assert set(s) == {"t", "event", "queue_depth", "tenants"}
    ts = [s["t"] for s in tl]
    assert ts == sorted(ts)
    # enqueue samples count the new request; done samples exclude the
    # finished one — the final sample shows an empty server
    assert tl[0] == {"t": tl[0]["t"], "event": "enqueue",
                     "queue_depth": 1, "tenants": 1}
    assert tl[-1]["event"] == "done"
    assert tl[-1]["queue_depth"] == 0


def test_drain_flushes_metrics_snapshot(tmp_path):
    """drain() flushes the throttled metrics.prom so the
    post-drain snapshot is never stale (interval set huge to prove the
    flush is the drain's, not the throttle's)."""
    pipe = StubPipeline(n_blocks=1)
    srv = ResidentSegmentationServer(str(tmp_path), pipe,
                                     metrics_interval_s=1e9)
    srv.start()
    srv.submit("alice", "A")
    assert srv.drain(timeout=5.0)
    text = open(srv.metrics_path).read()
    assert "ctt_server_queue_depth 0" in text
    assert 'ctt_server_requests_served_total{tenant="alice"} 1' in text
    srv.shutdown()


def test_metrics_prom_passes_lint_with_histograms_and_slo(tmp_path):
    """The full serve snapshot — gauges, counters, per-lane/per-tenant
    histograms, SLO burn rates, telemetry self-metrics — is valid
    exposition format per the promtool-style lint."""
    from cluster_tools_tpu_torch.core import slo, telemetry

    pipe = StubPipeline(n_blocks=1)
    srv = ResidentSegmentationServer(str(tmp_path), pipe,
                                     slo=slo.SLOEngine())
    srv.submit("alice", "A", lane="edit")
    srv.submit("bob", "B", lane="bulk")
    srv.start()
    srv.shutdown(drain=True)
    text = open(srv.metrics_path).read()
    assert telemetry.lint_prometheus(text) == []
    for family in ("ctt_server_request_latency_seconds_bucket",
                   "ctt_server_queue_wait_seconds_bucket",
                   "ctt_server_tenant_latency_seconds_bucket",
                   "ctt_slo_burn_rate", "ctt_slo_compliance",
                   "ctt_server_overload",
                   "ctt_server_admission_rejected_total",
                   "ctt_telemetry_dropped_spans_total"):
        assert family in text, family
    assert 'le="+Inf"' in text


def test_edit_lane_claimed_before_bulk(tmp_path):
    """Edit-lane requests are CLAIMED before bulk
    within the round-robin tenant scan — an interactive edit never waits
    behind another tenant's bulk backlog."""
    pipe = StubPipeline(n_blocks=2)
    srv = ResidentSegmentationServer(str(tmp_path), pipe, metrics_path="")
    srv.submit("alice", "BULK1")
    srv.submit("alice", "BULK2")
    srv.submit("bob", "EDIT", lane="edit")
    while srv.step_once():
        pass
    # the edit runs to completion first even though it was submitted last
    assert pipe.order == [("EDIT", 0), ("EDIT", 1),
                          ("BULK1", 0), ("BULK1", 1),
                          ("BULK2", 0), ("BULK2", 1)]


def test_edit_lane_preserves_fifo_within_tenant(tmp_path):
    """Lane priority only reorders ACROSS tenants' queue heads: a tenant's
    own edit still waits behind its earlier bulk request (FIFO within
    tenant is load-bearing for result consistency), then pre-empts other
    tenants' remaining bulk work."""
    pipe = StubPipeline(n_blocks=2)
    srv = ResidentSegmentationServer(str(tmp_path), pipe, metrics_path="")
    srv.submit("alice", "BULK")
    srv.submit("alice", "EDIT", lane="edit")
    srv.submit("bob", "B1")
    while srv.step_once():
        pass
    a_events = [tag for tag, _ in pipe.order if tag in ("BULK", "EDIT")]
    assert a_events == ["BULK", "BULK", "EDIT", "EDIT"]
    # once alice's edit reached the queue head it jumped ahead of bob
    assert pipe.order.index(("EDIT", 1)) < pipe.order.index(("B1", 1))


def test_lane_pipelines_route_requests(tmp_path):
    """lane_pipelines routes each request to its lane's pipeline
    (captured at submit time); the default pipeline keeps serving
    unrouted lanes, and block counts come from the routed pipeline."""
    bulk = StubPipeline(n_blocks=2)
    edit = StubPipeline(n_blocks=1)
    srv = ResidentSegmentationServer(str(tmp_path), bulk, metrics_path="",
                                     lane_pipelines={"edit": edit})
    hb = srv.submit("alice", "B")
    he = srv.submit("bob", "E", lane="edit")
    while srv.step_once():
        pass
    assert bulk.order == [("B", 0), ("B", 1)]
    assert edit.order == [("E", 0)]
    assert he.result(0)["n_segments"] == 1
    assert hb.result(0)["n_segments"] == 1
    with open(he.status_path) as f:
        assert json.load(f)["n_blocks"] == 1


def test_lane_pipeline_metrics_merged_into_snapshot(tmp_path):
    """A routed pipeline exposing metrics_families contributes its
    families to the server's metrics.prom snapshot."""
    from cluster_tools_tpu_torch.core import telemetry

    assert telemetry.is_registered_metric("ctt_edit_applied_total")

    class MeteredStub(StubPipeline):
        def metrics_families(self):
            return [("ctt_edit_applied_total", "counter", "edits applied",
                     [(None, len(self.order))])]

    edit = MeteredStub(n_blocks=1)
    srv = ResidentSegmentationServer(str(tmp_path), StubPipeline(),
                                     lane_pipelines={"edit": edit})
    srv.submit("alice", "E", lane="edit")
    srv.start()
    srv.shutdown(drain=True)
    text = open(srv.metrics_path).read()
    assert telemetry.lint_prometheus(text) == []
    assert "ctt_edit_applied_total 1" in text


def test_step_once_requires_stopped_worker(tmp_path):
    pipe = StubPipeline(n_blocks=1)
    srv = ResidentSegmentationServer(str(tmp_path), pipe)
    srv.start()
    with pytest.raises(RuntimeError, match="worker thread"):
        srv.step_once()
    srv.shutdown(drain=True)


def test_step_once_drives_requests_synchronously(tmp_path):
    pipe = StubPipeline(n_blocks=2)
    srv = ResidentSegmentationServer(str(tmp_path), pipe,
                                     metrics_path="")
    h = srv.submit("alice", "A")
    steps = 0
    while srv.step_once():
        steps += 1
    assert h.done() and h.result(0)["n_segments"] == 1
    assert steps == 2                # one quantum per block
    assert srv.step_once() is False  # idle


def test_admission_hook_rejects_and_counts(tmp_path):
    from cluster_tools_tpu_torch.core.server import AdmissionRejected

    seen = []

    def hook(tenant, lane, overloaded):
        seen.append((tenant, lane, overloaded))
        return tenant != "mallory"

    pipe = StubPipeline(n_blocks=1)
    srv = ResidentSegmentationServer(str(tmp_path), pipe,
                                     admission_hook=hook)
    with pytest.raises(AdmissionRejected):
        srv.submit("mallory", "M", lane="edit")
    h = srv.submit("alice", "A")
    srv.start()
    srv.shutdown(drain=True)
    assert h.done()
    assert seen == [("mallory", "edit", False), ("alice", "bulk", False)]
    text = open(srv.metrics_path).read()
    assert 'ctt_server_admission_rejected_total{lane="edit"} 1' in text


def test_request_n_blocks_hook_varies_block_count(tmp_path):
    """A pipeline exposing request_n_blocks sizes each request from its
    payload (the load harness's mixed-ROI mechanism); the class
    n_blocks is only the fallback."""

    class SizedStub(StubPipeline):
        def request_n_blocks(self, volume):
            return len(volume)

    pipe = SizedStub(n_blocks=99)
    srv = ResidentSegmentationServer(str(tmp_path), pipe)
    h1 = srv.submit("alice", "AB")       # 2 blocks
    h2 = srv.submit("bob", "XYZW")       # 4 blocks
    srv.start()
    srv.shutdown(drain=True)
    with open(h1.status_path) as f:
        assert json.load(f)["n_blocks"] == 2
    with open(h2.status_path) as f:
        assert json.load(f)["n_blocks"] == 4


def test_slo_engine_fed_by_completions(tmp_path):
    from cluster_tools_tpu_torch.core import slo

    eng = slo.SLOEngine()
    pipe = StubPipeline(n_blocks=1, fail_tag="BAD")
    srv = ResidentSegmentationServer(str(tmp_path), pipe, slo=eng,
                                     metrics_path="")
    srv.submit("alice", "A", lane="edit")
    srv.submit("mallory", "BAD", lane="edit")
    srv.start()
    srv.shutdown(drain=True)
    assert eng.total_events == 2
    avail = [o for o in eng.report()["objectives"]
             if o["name"] == "availability"][0]
    assert avail["windows"][0]["bad"] == 1       # the failed request
    assert srv.overloaded() in (False, True)     # consults the engine
