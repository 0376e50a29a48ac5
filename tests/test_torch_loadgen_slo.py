"""The port's load harness and SLO engine (cluster_tools_tpu_torch/core/
{loadgen,slo}.py): the tests of tests/test_loadgen.py (except the bench
smoke) and tests/test_slo.py run against the port, and the port held to
the JAX package on the same inputs — the same schedule, the same served
order, the same per-lane histogram bucket counts and SLO report from
``run_virtual``, and a ``metrics.prom`` both packages' lints accept with
the JAX snapshot's family names.
"""

import numpy as np
import pytest

from cluster_tools_tpu.core import loadgen as jax_loadgen
from cluster_tools_tpu.core import slo as jax_slo
from cluster_tools_tpu.core import telemetry as jax_telemetry
from cluster_tools_tpu_torch.core import loadgen, slo
from cluster_tools_tpu_torch.core import telemetry as port_telemetry
from cluster_tools_tpu_torch.core.server import AdmissionRejected


@pytest.fixture(autouse=True)
def _port_telemetry_reset():
    yield
    port_telemetry.reset()


# ---------------------------------------------------------------------------
# SLO engine
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


def _engine(objectives=None, windows=((10.0, 2.0), (100.0, 1.0))):
    clock = FakeClock()
    return slo.SLOEngine(objectives, windows=windows, clock=clock), clock


def test_burn_rate_arithmetic():
    # target 0.9 -> budget 0.1; 3 bad out of 10 -> err 0.3, burn 3.0
    eng, clock = _engine([slo.Objective("avail", target=0.9)])
    for i in range(10):
        eng.record("bulk", 0.01, ok=(i >= 3))
    rep = eng.report()
    w = rep["objectives"][0]["windows"][0]
    assert w["events"] == 10 and w["bad"] == 3
    assert w["error_rate"] == pytest.approx(0.3)
    assert w["burn_rate"] == pytest.approx(3.0)


def test_latency_objective_counts_slow_requests_as_bad():
    eng, clock = _engine(
        [slo.Objective("lat", lane="edit", latency_s=0.25, target=0.5)])
    eng.record("edit", 0.1)          # good
    eng.record("edit", 0.5)          # bad: slow
    eng.record("edit", 0.1, ok=False)  # bad: failed
    w = eng.report()["objectives"][0]["windows"][0]
    assert (w["events"], w["bad"]) == (3, 2)


def test_lane_filtering_and_wildcard():
    eng, clock = _engine([
        slo.Objective("edit-only", lane="edit", latency_s=0.1,
                      target=0.5),
        slo.Objective("all", lane="*", target=0.5),
    ])
    eng.record("edit", 1.0)          # bad for edit-only, good for all
    eng.record("bulk", 1.0)          # invisible to edit-only
    rep = eng.report()
    edit_w = rep["objectives"][0]["windows"][0]
    all_w = rep["objectives"][1]["windows"][0]
    assert (edit_w["events"], edit_w["bad"]) == (1, 1)
    assert (all_w["events"], all_w["bad"]) == (2, 0)


def test_multiwindow_and_rule_rejects_blips():
    """A short error burst trips the fast window but not the slow one —
    no breach.  Sustained errors trip both — breach + overload."""
    eng, clock = _engine(
        [slo.Objective("avail", target=0.9)],
        windows=((10.0, 2.0), (100.0, 1.0)))
    # 100 old GOOD events spread over the long window
    for _ in range(100):
        eng.record("bulk", 0.01)
        clock.advance(0.5)           # clock at 50s
    # burst: 10 bad events just now -> short-window burn huge, long
    # window diluted by the 100 good events
    for _ in range(10):
        eng.record("bulk", 0.01, ok=False)
    rep = eng.report()
    short, long_ = rep["objectives"][0]["windows"]
    assert short["breach"]
    assert not long_["breach"]
    assert not rep["objectives"][0]["breach"]
    assert not rep["overload"]
    # sustain the failures: everything in BOTH windows is bad
    clock.advance(200.0)             # age out the good events
    for _ in range(20):
        eng.record("bulk", 0.01, ok=False)
    assert eng.overload()


def test_events_age_out_of_windows():
    eng, clock = _engine([slo.Objective("avail", target=0.9)])
    eng.record("bulk", 0.01, ok=False)
    assert eng.report()["objectives"][0]["windows"][0]["bad"] == 1
    clock.advance(1000.0)
    rep = eng.report()
    assert rep["objectives"][0]["windows"][1]["events"] == 0
    assert not rep["overload"]


def test_compliance_is_longest_window():
    eng, clock = _engine([slo.Objective("avail", target=0.9)])
    for i in range(10):
        eng.record("bulk", 0.01, ok=(i != 0))
    assert eng.report()["objectives"][0]["compliance"] == \
        pytest.approx(0.9)


def test_objectives_from_config():
    objs = slo.objectives_from_config([
        {"name": "x", "lane": "edit", "latency_s": 0.1, "target": 0.95},
        {"name": "y"},
    ])
    assert objs[0] == slo.Objective("x", "edit", 0.1, 0.95)
    assert objs[1] == slo.Objective("y", "*", None, 0.99)
    assert slo.objectives_from_config(None) is None
    assert slo.objectives_from_config([]) is None


def test_invalid_target_rejected():
    with pytest.raises(ValueError):
        slo.SLOEngine([slo.Objective("bad", target=1.0)])
    with pytest.raises(ValueError):
        slo.SLOEngine([slo.Objective("bad", target=0.0)])
    with pytest.raises(ValueError):
        slo.SLOEngine(windows=())


def test_metrics_families_shape():
    from cluster_tools_tpu_torch.core import telemetry

    eng, clock = _engine()
    eng.record("edit", 0.01)
    fams = eng.metrics_families()
    names = [f[0] for f in fams]
    assert names == ["ctt_slo_burn_rate", "ctt_slo_compliance"]
    for name in names:
        assert telemetry.is_registered_metric(name)
    burn = fams[0][3]
    # one sample per objective x window (3 defaults x 2 windows)
    assert len(burn) == len(eng.objectives) * len(eng.windows)


# ---------------------------------------------------------------------------
# load harness
# ---------------------------------------------------------------------------

SPEC = loadgen.LoadSpec(seed=11, rate_hz=150.0, n_requests=200,
                        n_tenants=120)


# ---------------------------------------------------------------------------
# schedule generation
# ---------------------------------------------------------------------------

def test_schedule_deterministic_per_seed():
    a = loadgen.generate_schedule(SPEC)
    b = loadgen.generate_schedule(SPEC)
    assert a == b
    c = loadgen.generate_schedule(SPEC._replace(seed=12))
    assert a != c


def test_schedule_open_loop_properties():
    sched = loadgen.generate_schedule(SPEC)
    assert len(sched) == SPEC.n_requests
    # arrivals are sorted (open loop: the schedule is fixed up front)
    ts = [a.t for a in sched]
    assert ts == sorted(ts)
    # mean inter-arrival ~ 1/rate (Poisson, loose 3x bound)
    mean_gap = ts[-1] / len(ts)
    assert 1 / (3 * SPEC.rate_hz) < mean_gap < 3 / SPEC.rate_hz
    # the mix shows up: both lanes, all ROI classes, many tenants
    assert {a.lane for a in sched} == {"edit", "bulk"}
    assert {a.roi for a in sched} == {"small", "medium", "large"}
    assert len({a.tenant for a in sched}) > 50


def test_roi_class_maps_to_block_count():
    sched = loadgen.generate_schedule(SPEC)
    by_roi = {a.roi: a.n_blocks for a in sched}
    assert by_roi == {"small": 1, "medium": 4, "large": 16}
    pipe = loadgen.SyntheticPipeline(clock=loadgen.VirtualClock())
    for a in sched[:10]:
        assert pipe.request_n_blocks(loadgen.synthetic_volume(a)) \
            == a.n_blocks


# ---------------------------------------------------------------------------
# virtual-time mode (deterministic replay)
# ---------------------------------------------------------------------------

def _virtual(tmpdir, spec=SPEC, **kw):
    return loadgen.run_virtual(spec, str(tmpdir),
                               slo_engine=slo.SLOEngine(), **kw)


def test_virtual_mode_identical_bucket_counts(tmp_path):
    """Same seed -> identical request schedule AND identical histogram
    bucket counts on the stub pipeline."""
    rows = []
    buckets = []
    for d in ("a", "b"):
        r = _virtual(tmp_path / d)
        lat, wait, tenant = r["server"].latency_histograms()
        rows.append(r)
        buckets.append({
            "lat": {k: h.cumulative() for k, h in lat.items()},
            "wait": {k: h.cumulative() for k, h in wait.items()},
            "tenant": {k: h.cumulative() for k, h in tenant.items()},
        })
    assert [tuple(a) for a in rows[0]["schedule"]] == \
        [tuple(a) for a in rows[1]["schedule"]]
    assert buckets[0] == buckets[1]
    assert rows[0]["lanes"] == rows[1]["lanes"]
    assert rows[0]["served"] == SPEC.n_requests


def test_virtual_mode_latency_charged_from_scheduled_arrival(tmp_path):
    """Open-loop semantics: under overload, latency includes the time a
    request spent waiting BEHIND the schedule, so the tail compounds."""
    hot = SPEC._replace(rate_hz=2000.0, n_requests=300)
    r = _virtual(tmp_path, spec=hot)
    # offered 2000 req/s vs ~60 req/s capacity: p99 must dwarf the
    # isolated service time (worst class: 2+16*4+1 = 67 ms)
    worst = max(v["p99_s"] for v in r["lanes"].values())
    assert worst > 0.5
    # and the SLO engine must call it overloaded
    assert r["slo"]["overload"] is True


def test_virtual_mode_unsaturated_has_no_overload(tmp_path):
    light = SPEC._replace(rate_hz=20.0, n_requests=60)
    r = _virtual(tmp_path, spec=light)
    assert r["slo"]["overload"] is False
    assert r["served"] == 60
    assert r["failed"] == 0


def test_fault_injection_feeds_availability(tmp_path):
    clock = loadgen.VirtualClock()
    pipe = loadgen.SyntheticPipeline(clock=clock, fail_every=5)
    r = loadgen.run_virtual(SPEC._replace(n_requests=50), str(tmp_path),
                            pipeline=pipe, slo_engine=slo.SLOEngine())
    assert r["failed"] == 10
    avail = [o for o in r["slo"]["objectives"]
             if o["name"] == "availability"][0]
    assert avail["windows"][-1]["bad"] >= 10


def test_admission_hook_rejections_counted(tmp_path):
    calls = []

    def hook(tenant, lane, overloaded):
        calls.append((tenant, lane, overloaded))
        return lane != "bulk"        # shed the bulk lane entirely

    r = _virtual(tmp_path, admission_hook=hook)
    assert r["rejected"] > 0
    assert "bulk" not in r["lanes"]
    assert r["served"] + r["rejected"] == SPEC.n_requests
    assert {l for _, l, _ in calls} == {"edit", "bulk"}


def test_virtual_requires_clock_driven_pipeline(tmp_path):
    with pytest.raises(ValueError):
        loadgen.run_virtual(SPEC, str(tmp_path),
                            pipeline=loadgen.SyntheticPipeline())


# ---------------------------------------------------------------------------
# threaded mode (real worker thread, real sleeps — kept tiny)
# ---------------------------------------------------------------------------

def test_threaded_open_loop_smoke(tmp_path):
    spec = loadgen.LoadSpec(seed=3, rate_hz=200.0, n_requests=40,
                            n_tenants=10)
    pipe = loadgen.SyntheticPipeline(prepare_s=1e-4, block_s=2e-4,
                                     finalize_s=1e-4)
    eng = slo.SLOEngine()
    r = loadgen.run_threaded(spec, str(tmp_path), pipeline=pipe,
                             slo_engine=eng, metrics_path=None)
    assert r["drained"] is True
    assert r["served"] == 40
    assert r["mode"] == "threaded"
    assert set(r["lanes"]) <= {"edit", "bulk"}
    assert r["slo"]["objectives"]
    for lane_row in r["lanes"].values():
        assert 0.0 <= lane_row["p50_s"] <= lane_row["p99_s"]


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

def _replay(pkg_loadgen, pkg_slo, spec, workdir, fail_every=0):
    clock = pkg_loadgen.VirtualClock()
    pipe = pkg_loadgen.SyntheticPipeline(clock=clock, fail_every=fail_every)
    r = pkg_loadgen.run_virtual(spec, str(workdir), pipeline=pipe,
                                slo_engine=pkg_slo.SLOEngine())
    lat, wait, tenant = r["server"].latency_histograms()
    served = [(q["request_id"], q["tenant"], q["lane"], q["state"],
               q["latency_s"], q["queue_wait_s"])
              for q in r["server"].stats()["requests"]]
    row = {k: v for k, v in r.items() if k not in ("server", "schedule")}
    return {
        "schedule": [tuple(a) for a in r["schedule"]],
        "served": served,
        "buckets": {
            "lat": {k: h.cumulative() for k, h in lat.items()},
            "wait": {k: h.cumulative() for k, h in wait.items()},
            "tenant": {k: h.cumulative() for k, h in tenant.items()},
        },
        "row": row,
    }


@pytest.mark.parametrize("spec,fail_every", [
    (SPEC, 0),
    (SPEC._replace(rate_hz=2000.0, n_requests=300), 0),   # overloaded
    (SPEC._replace(seed=5, n_requests=80), 7),             # faults
])
def test_run_virtual_matches_jax(tmp_path, spec, fail_every):
    """Same LoadSpec in both packages: the same schedule, the same served
    order and latencies, the same histogram bucket counts per lane and
    per tenant, and the same summary row with its SLO report."""
    ours = _replay(loadgen, slo, spec, tmp_path / "port", fail_every)
    theirs = _replay(jax_loadgen, jax_slo, spec, tmp_path / "jax",
                     fail_every)
    assert ours["schedule"] == theirs["schedule"]
    assert ours["served"] == theirs["served"]
    assert len(ours["served"]) == spec.n_requests
    assert ours["buckets"] == theirs["buckets"]
    assert ours["row"] == theirs["row"]
    assert ours["row"]["failed"] == (spec.n_requests // fail_every
                                     if fail_every else 0)


def _serve_stub(server_mod, slo_mod, workdir):
    """A stub-pipeline run with both lanes, a failing tenant, the SLO
    engine and an edit-lane pipeline exporting its own family."""

    class Stub:
        n_blocks = 2

        def prepare(self, volume):
            if volume == "BAD":
                raise RuntimeError("injected failure")
            return {}

        def run_block(self, ctx, bid):
            return bid

        def finalize(self, ctx, block_results):
            return {"n_fragments": 2, "n_segments": 1}

    class Edit(Stub):
        n_blocks = 1

        def metrics_families(self):
            return [("ctt_edit_applied_total", "counter", "edits applied",
                     [(None, 1)])]

    srv = server_mod.ResidentSegmentationServer(
        str(workdir), Stub(), slo=slo_mod.SLOEngine(),
        lane_pipelines={"edit": Edit()})
    srv.submit("alice", "A", lane="edit")
    srv.submit("bob", "B")
    srv.submit("mallory", "BAD")
    srv.start()
    srv.shutdown(drain=True)
    with open(srv.metrics_path) as f:
        return f.read()


def _families(text):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def test_metrics_prom_lints_clean_in_both_packages(tmp_path):
    from cluster_tools_tpu.core import server as jax_server
    from cluster_tools_tpu_torch.core import server as port_server

    ours = _serve_stub(port_server, slo, tmp_path / "port")
    theirs = _serve_stub(jax_server, jax_slo, tmp_path / "jax")
    assert port_telemetry.lint_prometheus(ours) == []
    assert jax_telemetry.lint_prometheus(ours) == []
    # the JAX snapshot's families, less the device-memory gauge the card
    # adds once torch has initialised it
    assert _families(ours) - {"ctt_memory_device_gb"} == \
        _families(theirs) - {"ctt_memory_device_gb"}
    for line in ('ctt_server_requests_served_total{tenant="mallory"} 1',
                 "ctt_edit_applied_total 1", "ctt_server_queue_depth 0"):
        assert line in ours, line
