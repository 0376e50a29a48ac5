"""The readers of the storage, writer-pool, host-graph and unstaged-idle
metrics on hand-built traces with known numbers, and on traces of a
program that lacks their stages (each then reads nothing)."""

from __future__ import annotations

import pytest

from portbench.reduce import Trace, metric_reader

NAMES = ("store_encode_s", "store_io_s", "writer_wait_s", "graph_host_s",
         "unstaged_idle.volume")


def _trace(status=(), spans=(), device_ops=(), window_s=10.0, volumes=2):
    return Trace(cell={}, config={}, window_s=window_s,
                 device_ops=list(device_ops), spans=list(spans),
                 status=list(status), info={"volumes": volumes})


STATUS = [
    {"task": "fused_segmentation",
     "stages": {"store-write": 12.0, "store-encode": 9.0, "store-io": 1.5,
                "pool-wait": 2.25, "host-map": 1.0}},
    {"task": "fused_face_assembly",
     "stages": {"host-assemble": 1.5, "tmp-read": 0.25, "tmp-write": 0.5}},
    {"task": "merge_sub_graphs_s0_full",
     "stages": {"host-merge": 0.25, "store-encode": 0.5}},
    {"task": "map_edge_ids_s0", "stages": {"host-map-ids": 0.125}},
    {"task": "fused_feature_ids", "stages": {"host-map-ids": 0.375}},
    {"task": "merge_edge_features", "stages": {"host-features": 0.5}},
    {"task": "probs_to_costs", "stages": {"host-costs": 0.25}},
    {"task": "write_multicut",
     "stages": {"store-write": 8.0, "store-encode": 6.5, "store-io": 1.0,
                "pool-wait": 1.75}},
]


def _read(name, trace):
    return metric_reader(name)(trace)


def test_status_readers_sum_their_stages_per_volume():
    tr = _trace(STATUS, volumes=2)
    assert _read("store_encode_s", tr) == pytest.approx((9 + 0.5 + 6.5) / 2)
    assert _read("store_io_s", tr) == pytest.approx((1.5 + 1.0) / 2)
    assert _read("writer_wait_s", tr) == pytest.approx((2.25 + 1.75) / 2)
    assert _read("graph_host_s", tr) == pytest.approx(
        (1.5 + 0.25 + 0.125 + 0.375 + 0.5 + 0.25) / 2)


def test_unstaged_idle_is_the_window_no_stage_or_device_op_covers():
    spans = [
        ("store-write", "stage", 0.0, 2.0),
        ("store-encode", "stage", 0.5, 1.5),          # nested: no change
        ("host-merge", "stage", 4.0, 5.0),
        ("pool-wait", "stage", 4.5, 6.0),             # overlaps the last
        ("fused_segmentation", "attempt", 0.0, 10.0),  # not a stage
        ("block:0", "block", 2.0, 3.0),               # not a stage
        ("host-map", "stage", 9.5, 12.0),             # past the window
    ]
    ops = [("minplus", 2.5, 3.0), ("copy", 6.0, 7.0),
           ("early", -1.0, 0.25)]
    tr = _trace(spans=spans, device_ops=ops, window_s=10.0)
    # covered: [0, 2] + [2.5, 3] + [4, 7] + [9.5, 10] = 6 s of 10;
    # the gaps [2, 2.5], [3, 4] and [7, 9.5] are named by nothing
    assert _read("unstaged_idle.volume", tr) == pytest.approx(40.0)
    # every second covered reads 0
    tr = _trace(spans=[("host-costs", "stage", -1.0, 11.0)], window_s=10.0)
    assert _read("unstaged_idle.volume", tr) == pytest.approx(0.0)


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_the_stages_reads_nothing(name):
    """A program from before these stages: its status JSONs hold only
    the older stages, and a run without telemetry records no stage
    span."""
    old = [{"task": "fused_segmentation",
            "stages": {"store-write": 12.0, "dispatch": 1.0}},
           {"task": "fused_face_assembly", "stages": {}},
           {"task": "write_multicut"}]
    tr = _trace(old, spans=[("fused_segmentation", "attempt", 0.0, 9.0)],
                device_ops=[("minplus", 1.0, 2.0)])
    assert _read(name, tr) is None
    assert _read(name, _trace()) is None


@pytest.mark.parametrize("name", NAMES[:4])
def test_status_readers_need_the_volume_count(name):
    assert _read(name, _trace(STATUS, volumes=0)) is None
