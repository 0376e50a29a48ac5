"""The port's stages that name where the fused chain's host time goes, and
its telemetry on the profiler's clock, on the CPU.

* the storage layer times each chunk where the work happens:
  ``store-encode`` / ``store-io`` on a write (bytes in, bytes written),
  ``store-io-read`` / ``store-decode`` on a read, ``store-lock-wait`` on a
  partial chunk's lock, all inside the caller's ``store-write``;
* ``BoundedPool`` times a submitting thread blocked on an unfinished task
  as ``pool-wait``, and nothing else;
* the fused chain's host graph tasks, its staged ``.npz`` tables and its
  pool tails each open a stage, and its status JSONs keep their keys with
  telemetry on and off;
* ``export_chrome_trace(..., profiler_trace=...)`` places the spans on a
  ``torch.profiler`` trace's timeline; without it the file is the same,
  byte for byte, as before the option existed.
"""

import json
import os
import threading
import time
from concurrent import futures

import numpy as np
import pytest
import torch

from cluster_tools_tpu_torch.core import runtime, storage, telemetry

torch.set_num_threads(2)

SHAPE = (64, 128, 128)
CHUNKS = (32, 64, 64)
STORE_STAGES = ("store-encode", "store-io", "store-lock-wait",
                "store-decode", "store-io-read")


@pytest.fixture(autouse=True)
def _telemetry_reset():
    telemetry.reset()
    yield
    telemetry.reset()


def _labels(shape, seed=0):
    """Piecewise-constant uint64 labels: what the chain writes."""
    rng = np.random.RandomState(seed)
    z, y, x = np.indices(shape)
    base = (z // 5) * 10_000 + (y // 9) * 100 + x // 11
    return (base + rng.randint(0, 3, size=shape) * 1_000_000).astype(
        "uint64")


def _chunk_files(path):
    return [os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs
            if f != "attributes.json"]


def _since(before):
    now = runtime.stages_snapshot()
    return {k: v - before.get(k, 0.0) for k, v in now.items()}


def test_store_stages_split_a_gzip_n5_write_and_read(tmp_path):
    arr = _labels(SHAPE)
    path = str(tmp_path / "d.n5")
    with storage.file_reader(path) as f:
        ds = f.require_dataset("seg", shape=SHAPE, chunks=CHUNKS,
                               dtype="uint64", compression="gzip")

    # a whole, chunk-aligned write: every chunk encoded once
    st0, by0 = runtime.stages_snapshot(), runtime.bytes_snapshot()
    with runtime.stage("store-write"):
        ds[:] = arr
    secs, moved = _since(st0), runtime.bytes_delta(by0)
    assert moved["store-encode"] == arr.nbytes
    files = _chunk_files(os.path.join(path, "seg"))
    assert len(files) == 8
    assert moved["store-io"] == sum(os.path.getsize(p) for p in files)
    assert moved["store-io"] < arr.nbytes / 4        # gzip did compress
    assert 0 < secs["store-encode"] + secs["store-io"] <= \
        secs["store-write"]

    # a write across the chunk grid: read-modify-write of partial chunks,
    # the lock of the first of which another thread holds for 100 ms
    lock = storage._chunk_lock(f"{ds._kv.path}/{ds._chunk_key((0, 0, 0))}")
    lock.acquire()
    threading.Timer(0.1, lock.release).start()
    st0 = runtime.stages_snapshot()
    with runtime.stage("store-write"):
        ds[10:40, 60:70, :] = arr[:30, :10, :] + np.uint64(7)
    secs = _since(st0)
    assert secs["store-lock-wait"] >= 0.05
    assert secs["store-lock-wait"] + secs["store-encode"] + \
        secs["store-io"] + secs["store-io-read"] + \
        secs["store-decode"] <= secs["store-write"]

    # a whole read: every chunk file read and decoded once
    by0 = runtime.bytes_snapshot()
    got = ds[...]
    moved = runtime.bytes_delta(by0)
    want = arr.copy()
    want[10:40, 60:70, :] = arr[:30, :10, :] + np.uint64(7)
    np.testing.assert_array_equal(got, want)
    assert moved["store-io-read"] == sum(os.path.getsize(p) for p in files)
    assert moved["store-decode"] == arr.nbytes

    # all five, over the writes and the read
    delta = runtime.stages_delta({})
    for name in STORE_STAGES:
        assert name in delta, name
        assert telemetry.is_registered(name)


def test_store_stages_nest_inside_store_write_spans(tmp_path):
    telemetry.configure(enabled=True)
    path = str(tmp_path / "d.n5")
    with storage.file_reader(path) as f:
        ds = f.require_dataset("seg", shape=SHAPE, chunks=CHUNKS,
                               dtype="uint64", compression="gzip")
    with runtime.stage("store-write"):
        ds[:] = _labels(SHAPE)
    spans = [s for s in telemetry.spans_snapshot() if s.cat == "stage"]
    outer = [s for s in spans if s.name == "store-write"]
    assert len(outer) == 1
    inner = [s for s in spans if s.name in ("store-encode", "store-io")]
    assert len(inner) == 16
    assert all(outer[0].t0 <= s.t0 <= s.t1 <= outer[0].t1 for s in inner)


def _slow():
    time.sleep(0.05)


def test_pool_wait_counts_only_waits_on_unfinished_tasks():
    st0, n0 = runtime.stages_snapshot(), runtime.counts_snapshot()
    with runtime.BoundedPool(1, max_inflight=1) as pool:
        for _ in range(3):
            pool.submit(_slow)
    secs, counts = _since(st0), runtime.counts_delta(n0)
    # the second and third submits and the drain each waited on a task
    # still sleeping
    assert counts["pool-wait"] == 3
    assert secs["pool-wait"] >= 0.1

    n0 = runtime.counts_snapshot()
    with runtime.BoundedPool(1, max_inflight=1) as pool:
        for _ in range(5):
            pool.submit(int)
            futures.wait(list(pool._pending))
    assert "pool-wait" not in runtime.counts_delta(n0)
    assert telemetry.is_registered("pool-wait")


# ---------------------------------------------------------------------------
# the fused chain
# ---------------------------------------------------------------------------

CHAIN_STAGES = ("host-pad", "host-map", "tmp-write", "tmp-read",
                "host-assemble", "host-merge", "host-map-ids",
                "host-features", "host-costs", "store-encode",
                "store-io", "store-decode", "store-io-read")


def _chain(root, vol, telemetry_on):
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir

    path = os.path.join(root, "d.n5")
    with ctp.file_reader(path) as f:
        ds = f.require_dataset("bmap", shape=vol.shape, chunks=[12, 48, 48],
                               dtype="uint8", compression="gzip")
        ds[:] = vol
    cfg = os.path.join(root, "cfg")
    ConfigDir(cfg).write_global_config(
        {"block_shape": [12, 48, 48], "device": "cpu",
         "telemetry_enabled": telemetry_on})
    ConfigDir(cfg).write_task_config(
        "fused_segmentation", {"halo": [2, 8, 8], "e_max": 2048,
                               "writer_threads": 1})
    tmp = os.path.join(root, "tmp")
    wf = ctp.MulticutSegmentationWorkflow(
        input_path=path, input_key="bmap", ws_path=path, ws_key="ws",
        problem_path=os.path.join(root, "p.n5"), output_path=path,
        output_key="seg", tmp_folder=tmp, config_dir=cfg, max_jobs=2,
        target="gpu", n_scales=1, fused=True)
    assert ctp.build([wf], raise_on_failure=True)
    statuses = {}
    for name in sorted(os.listdir(tmp)):
        if name.endswith(".status"):
            with open(os.path.join(tmp, name)) as fh:
                statuses[name] = json.load(fh)
    return statuses


def _volume(shape=(24, 96, 96), seed=3):
    from scipy import ndimage

    rng = np.random.RandomState(seed)
    bnd = ndimage.gaussian_filter(rng.rand(*shape), 2.0)
    bnd = (bnd - bnd.min()) / (bnd.max() - bnd.min())
    return (255 * bnd).astype("uint8")


def test_fused_chain_names_its_host_stages(tmp_path):
    vol = _volume()
    statuses = {}
    for on in (False, True):
        telemetry.reset()
        statuses[on] = _chain(str(tmp_path / f"on{int(on)}"), vol, on)
        if on:
            spans = telemetry.spans_snapshot()
    names = {s.name for s in spans if s.cat == "stage"}
    for name in CHAIN_STAGES:
        assert name in names, name
        assert telemetry.is_registered(name), name
    # the host graph tasks each run under their stage
    tasks = {"fused_face_assembly": "host-assemble",
             "merge_sub_graphs_s0_full": "host-merge",
             "map_edge_ids_s0": "host-map-ids",
             "fused_feature_ids": "host-map-ids",
             "merge_edge_features": "host-features",
             "probs_to_costs": "host-costs"}
    for task, name in tasks.items():
        counts = statuses[True][f"{task}.status"]["stage_counts"]
        assert counts.get(name, 0) >= 1, (task, counts)
    assert statuses[True].keys() == statuses[False].keys()
    for name in statuses[True]:
        on, off = statuses[True][name], statuses[False][name]
        assert on.keys() == off.keys(), name
        assert "device_busy_frac" not in on
        # how often a thread waits on the pool depends on timing alone
        strip = {"pool-wait"}
        assert {k: v for k, v in on["stage_counts"].items()
                if k not in strip} == \
            {k: v for k, v in off["stage_counts"].items()
             if k not in strip}, name


# ---------------------------------------------------------------------------
# the profiler's clock
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


#: what ``export_chrome_trace`` wrote for the recording below before it
#: took ``profiler_trace``
_DEFAULT_EXPORT = (
    '{"displayTimeUnit":"ms","traceEvents":[{"args":{"name":'
    '"cluster_tools_tpu_torch"},"name":"process_name","ph":"M","pid":1,'
    '"tid":0},{"args":{"name":"MainThread"},"name":"thread_name","ph":"M",'
    '"pid":1,"tid":1},{"args":{"fn":"f","parent":1,"sid":3},"cat":'
    '"queue-wait","dur":1500.0,"name":"pool-queue-wait","ph":"X","pid":1,'
    '"tid":1,"ts":0.0},{"args":{"block":0,"sid":1},"cat":"block","dur":'
    '2000.0,"name":"block:0","ph":"X","pid":1,"tid":1,"ts":1000.0},{"args":'
    '{"parent":1,"sid":2},"cat":"stage","dur":500.0,"name":"store-encode",'
    '"ph":"X","pid":1,"tid":1,"ts":1500.0},{"args":{"value":1.5},"name":'
    '"host_rss_gb","ph":"C","pid":1,"tid":0,"ts":2000.0}]}')


def test_default_export_is_unchanged(tmp_path):
    out = {}

    def record():
        telemetry.reset()
        telemetry.configure(enabled=True, clock=_Clock())
        with telemetry.span("block:0", cat="block", block=0):
            telemetry.record_stage("store-encode", 0.0005)
            telemetry.record("pool-queue-wait", 0.0, 0.0015,
                             cat="queue-wait", fn="f")
        telemetry.record("mem", 0.002, 0.002, cat="counter",
                         host_rss_gb=1.5)

    t = threading.Thread(target=record, name="MainThread")
    t.start()
    t.join()
    for name in ("a", "b"):
        path = str(tmp_path / f"{name}.json")
        assert telemetry.export_chrome_trace(path) == 6
        with open(path) as f:
            out[name] = f.read()
    assert out["a"] == out["b"] == _DEFAULT_EXPORT


def test_clock_anchor_is_taken_when_enabled():
    telemetry.reset()
    t0 = time.perf_counter()
    telemetry.configure(enabled=True)
    perf, unix_ns = telemetry.clock_anchor()
    assert t0 <= perf <= time.perf_counter()
    assert abs(unix_ns / 1e9 - time.time()) < 1.0
    assert telemetry.clock_anchor() == (perf, unix_ns)
    telemetry.reset()
    assert telemetry._REC.anchor is None


def test_merged_export_puts_spans_on_the_profiler_timeline(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    telemetry.configure(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):      # the profiler's first ranges cost more
            with record_function("warm"), telemetry.span("warm"):
                pass
        time.sleep(0.005)
        with record_function("probe"), telemetry.span("probe"):
            torch.ones(1000).sum()
            time.sleep(0.005)
    ptrace = str(tmp_path / "prof.json")
    prof.export_chrome_trace(ptrace)
    with open(ptrace) as f:
        pdoc = json.load(f)
    merged = str(tmp_path / "merged.json")
    n = telemetry.export_chrome_trace(merged, profiler_trace=ptrace)
    with open(merged) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    assert n == len(events)
    # the profiler's events and keys are kept as they were
    assert events[:len(pdoc["traceEvents"])] == pdoc["traceEvents"]
    assert {k: v for k, v in doc.items() if k != "traceEvents"} == \
        {k: v for k, v in pdoc.items() if k != "traceEvents"}
    ours = [e for e in events[len(pdoc["traceEvents"]):]
            if e.get("ph") == "X"]
    pids = {e["pid"] for e in pdoc["traceEvents"] if "pid" in e}
    assert ours and {e["pid"] for e in ours}.isdisjoint(pids)
    probe = {e["pid"] == ours[0]["pid"]: e for e in events
             if e.get("name") == "probe" and e.get("ph") == "X"}
    assert abs(probe[True]["ts"] - probe[False]["ts"]) <= 1000.0
    assert abs(probe[True]["dur"] - probe[False]["dur"]) <= 1000.0
