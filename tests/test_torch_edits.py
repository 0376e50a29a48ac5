"""The port's proofreading subsystem (cluster_tools_tpu_torch/edits/)
held against the JAX package's (cluster_tools_tpu/edits/).

One nested-voronoi instance (tests/test_multicut.py) is solved once per
module by both packages' ``MulticutSegmentationWorkflow`` (n_scales=1,
``[10, 10, 10]`` grid over ``(24, 24, 24)`` -> 27 subproblems); each
test works on a copy.  The problems are identical, and one stream of
merges and splits through the JAX ``EditSession`` and the port's gives
identical per-node labels after every edit, the port's incremental
result equal to its from-scratch solve.  Then every test of
tests/test_edits.py runs against the port: the edit log (appends, replay,
torn tails, validation), the resolver (the >= 2-fragments criterion, the
paintera narrowing and its fallback), the incremental solver (warm
start, incremental == scratch, the stale-cache fallback), the patcher
and paintera round trips, and the edit lane on the port's server
rewriting exactly the touched output blocks.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest

from cluster_tools_tpu_torch.core import telemetry as port_telemetry
from test_multicut import _boundary_map, _nested_voronoi


@pytest.fixture(autouse=True)
def _port_telemetry_reset():
    yield
    port_telemetry.reset()


# ---------------------------------------------------------------------------
# one problem per package, solved once per module; per-test workspaces
# are cheap dir copies
# ---------------------------------------------------------------------------


def _solve(pkg, base, bnd, frags):
    """Solve the instance through ``pkg``'s MulticutSegmentationWorkflow
    (target ``threads``; the port on the CPU) under ``base``."""
    import importlib

    ctt = importlib.import_module(pkg)
    ConfigDir = importlib.import_module(f"{pkg}.core.config").ConfigDir
    file_reader = importlib.import_module(f"{pkg}.core.storage").file_reader
    seg_mod = importlib.import_module(f"{pkg}.workflows.segmentation")

    os.makedirs(base)
    config_dir = os.path.join(base, "configs")
    conf = {"block_shape": [10, 10, 10], "max_num_retries": 0}
    if pkg == "cluster_tools_tpu_torch":
        conf["device"] = "cpu"
    ConfigDir(config_dir).write_global_config(conf)
    path = os.path.join(base, "data.n5")
    with file_reader(path) as f:
        f.require_dataset("bmap", shape=bnd.shape, chunks=(12, 12, 12),
                          dtype="float32")[:] = bnd
        f.require_dataset("ws", shape=frags.shape, chunks=(12, 12, 12),
                          dtype="uint64")[:] = frags
    wf = seg_mod.MulticutSegmentationWorkflow(
        input_path=path, input_key="bmap", ws_path=path, ws_key="ws",
        problem_path=os.path.join(base, "problem.n5"), output_path=path,
        output_key="seg", tmp_folder=os.path.join(base, "tmp"),
        config_dir=config_dir, max_jobs=2, target="threads", n_scales=1)
    assert ctt.build([wf])


@pytest.fixture(scope="module")
def solved_problem(tmp_path_factory):
    base = tmp_path_factory.mktemp("edits_base")
    true, frags = _nested_voronoi()
    bnd = _boundary_map(true)
    _solve("cluster_tools_tpu", str(base / "jax"), bnd, frags)
    _solve("cluster_tools_tpu_torch", str(base / "port"), bnd, frags)
    return base


@pytest.fixture()
def workspace(solved_problem, tmp_path):
    """Mutable copy of the port's solved instance; returns its root
    dir."""
    dst = tmp_path / "ws"
    shutil.copytree(solved_problem / "port", dst)
    return dst


@pytest.fixture()
def jax_workspace(solved_problem, tmp_path):
    """Mutable copy of the JAX package's solved instance."""
    dst = tmp_path / "jax_ws"
    shutil.copytree(solved_problem / "jax", dst)
    return dst


def _paths(ws):
    return {
        "data": str(ws / "data.n5"),
        "problem": str(ws / "problem.n5"),
        "assignments": str(ws / "tmp" / "multicut_assignments.npy"),
    }


def _session(ws, **kw):
    from cluster_tools_tpu_torch.edits import EditSession

    return EditSession(_paths(ws)["problem"], **kw)


def _pick_pair(session, table, same_segment):
    """Deterministic adjacent fragment pair that (a) shares at least one
    subproblem block and (b) is currently in the same / different
    segment."""
    for u, v in session.base_uv:
        ou, ov = int(session.s0_nodes[u]), int(session.s0_nodes[v])
        if ou == 0 or ov == 0:
            continue
        if bool(table[ou] == table[ov]) != same_segment:
            continue
        if session.affected_blocks([ou, ov]):
            return ou, ov
    raise AssertionError("no suitable fragment pair in the instance")


# ---------------------------------------------------------------------------
# edit log
# ---------------------------------------------------------------------------


def test_edit_log_append_replay_roundtrip(tmp_path):
    from cluster_tools_tpu_torch.edits import EditLog

    log = EditLog(str(tmp_path / "edits.jsonl"))
    r0 = log.append("merge", [7, 3, 3], note="join")
    r1 = log.append("split", [10, 11], edit_id="fixed-id")
    assert r0.seq == 0 and r1.seq == 1
    assert r0.fragments == (3, 7)          # sorted, deduped
    assert r1.edit_id == "fixed-id"
    assert len(r0.edit_id) == 12 and r0.edit_id != r1.edit_id

    recs = EditLog(log.path).records()     # fresh reader, same file
    assert [(r.op, r.fragments, r.seq, r.edit_id) for r in recs] == \
        [("merge", (3, 7), 0, r0.edit_id),
         ("split", (10, 11), 1, "fixed-id")]
    seen = []
    assert EditLog(log.path).replay(lambda r: seen.append(r.op)) == 2
    assert seen == ["merge", "split"]
    # append after reopen continues the sequence
    r2 = EditLog(log.path).append("merge", [1, 2])
    assert r2.seq == 2 and len(log.records()) == 3


def test_edit_log_validation(tmp_path):
    from cluster_tools_tpu_torch.edits import EditLog

    log = EditLog(str(tmp_path / "edits.jsonl"))
    with pytest.raises(ValueError, match="unknown edit op"):
        log.append("paint", [1, 2])
    with pytest.raises(ValueError, match=">= 2 distinct"):
        log.append("merge", [5, 5])
    with pytest.raises(ValueError, match="positive"):
        log.append("split", [0, 3])
    assert not os.path.exists(log.path)    # nothing was written


def test_edit_log_torn_tail_skipped_unless_strict(tmp_path):
    from cluster_tools_tpu_torch.edits import EditLog

    log = EditLog(str(tmp_path / "edits.jsonl"))
    log.append("merge", [1, 2])
    log.append("split", [3, 4])
    with open(log.path, "ab") as f:        # simulate a crash mid-append
        f.write(b'{"edit_id": "torn", "seq": 2, "op": "mer')
    recs = EditLog(log.path).records()
    assert len(recs) == 2                  # the torn append never happened
    with pytest.raises(ValueError, match="torn trailing record"):
        EditLog(log.path).records(strict=True)
    # WAL recovery: the next append through the API truncates the torn
    # bytes first, so the log stays parseable and the sequence continues
    r2 = EditLog(log.path).append("merge", [5, 6])
    assert r2.seq == 2
    assert [r.op for r in EditLog(log.path).records(strict=True)] == \
        ["merge", "split", "merge"]


def test_edit_log_out_of_order_rejected(tmp_path):
    from cluster_tools_tpu_torch.edits import EditLog, EditRecord

    path = str(tmp_path / "edits.jsonl")
    with open(path, "w") as f:
        f.write(EditRecord("a", 1, "merge", (1, 2), 0.0).to_json() + "\n")
    with pytest.raises(ValueError, match="non-monotonic"):
        EditLog(path).records()


# ---------------------------------------------------------------------------
# signatures + resolver
# ---------------------------------------------------------------------------


def test_persisted_signatures_match_live_problem(workspace):
    """SolveSubproblems stamps each sub_result with the content signature
    of exactly the inputs it solved; an unedited session recomputes the
    identical hash for every block (the warm-start validity proof)."""
    from cluster_tools_tpu_torch.workflows import multicut as mc

    session = _session(workspace)
    assert session.blocking.n_blocks == 27
    n_checked = 0
    for bid in range(session.blocking.n_blocks):
        disk = mc.load_sub_result(_paths(workspace)["problem"], 0, bid)
        if disk is None:
            continue
        assert disk[1] == session.block_signature(bid)[0], bid
        n_checked += 1
    assert n_checked == 27


def test_resolver_affected_blocks_criterion(workspace):
    """A block is affected iff its node set holds >= 2 of the edit's
    fragments — cross-checked against a brute-force scan."""
    from cluster_tools_tpu_torch.edits import resolve_affected

    session = _session(workspace)
    table = np.load(_paths(workspace)["assignments"])
    a, b = _pick_pair(session, table, same_segment=False)
    got = resolve_affected(_paths(workspace)["problem"], [a, b])
    expect = [bid for bid in range(session.blocking.n_blocks)
              if int(np.isin(np.asarray([a, b], "uint64"),
                             session.block_nodes(bid)).sum()) >= 2]
    assert got == expect and got
    # fragments that never share a block resolve to the empty set (the
    # reduce/global stage still sees their biased edge): pick one from
    # each of two opposite corner blocks
    nonempty = [bid for bid in range(session.blocking.n_blocks)
                if len(session.block_nodes(bid))]
    f1 = int(session.block_nodes(nonempty[0])[0])
    for f2 in session.block_nodes(nonempty[-1]):
        if not resolve_affected(_paths(workspace)["problem"],
                                [f1, int(f2)]):
            break
    else:
        pytest.skip("corner fragments unexpectedly share a block")
    assert resolve_affected(_paths(workspace)["problem"],
                            [f1, int(f2)]) == []


def test_resolver_paintera_narrowing_agrees_with_full_scan(workspace):
    """The paintera label-to-block lookup only NARROWS candidates: the
    narrowed resolve equals the full scan, and a missing fragment in the
    lookup degrades to the full scan rather than missing blocks."""
    from cluster_tools_tpu_torch.core.blocking import Blocking
    from cluster_tools_tpu_torch.core.storage import VarlenDataset, file_reader
    from cluster_tools_tpu_torch.edits import resolve_affected

    p = _paths(workspace)
    with file_reader(p["data"], "r") as f:
        frags = f["ws"][:]
    # hand-build the lookup on a DIFFERENT grid than the subproblem one
    # so the voxel-ROI conversion is actually exercised
    paintera_bs = [12, 12, 12]
    lookup_key = "seg/label-to-block-mapping/s0"
    paintera_path = str(workspace / "paintera.n5")
    data_blocking = Blocking(list(frags.shape), paintera_bs)
    inv = {}
    for dbid in range(data_blocking.n_blocks):
        for lab in np.unique(frags[data_blocking.get_block(dbid).bb]):
            inv.setdefault(int(lab), []).append(dbid)
    ds = VarlenDataset(os.path.join(paintera_path, lookup_key),
                       dtype="uint64")
    for lab, blocks in inv.items():
        ds.write_chunk((lab,), np.asarray(blocks, "uint64"))

    session = _session(workspace)
    table = np.load(p["assignments"])
    a, b = _pick_pair(session, table, same_segment=False)
    full = resolve_affected(p["problem"], [a, b])
    narrowed = resolve_affected(
        p["problem"], [a, b], paintera_path=paintera_path,
        paintera_lookup_key=lookup_key, paintera_block_shape=paintera_bs)
    assert narrowed == full and full
    # a lookup that does not know fragment b -> full-scan fallback
    os.remove(os.path.join(paintera_path, lookup_key, f"chunk_{b}.npy"))
    assert resolve_affected(
        p["problem"], [a, b], paintera_path=paintera_path,
        paintera_lookup_key=lookup_key,
        paintera_block_shape=paintera_bs) == full


# ---------------------------------------------------------------------------
# incremental solver
# ---------------------------------------------------------------------------


def test_noop_resolve_is_fully_warm_and_stable(workspace):
    """Re-solving WITHOUT any edit reuses every persisted subproblem
    solution (zero cold solves) and stable-relabels to the committed LUT
    bit-identically."""
    from cluster_tools_tpu_torch.edits import stable_relabel

    session = _session(workspace)
    labels = session.solve(incremental=True)
    assert session.counters["subproblems_solved"] == 0
    assert session.counters["warm_reused"] == 27
    assert session.counters["fallback"] == 0
    old_table = np.load(_paths(workspace)["assignments"])
    new_table = stable_relabel(old_table, session.s0_nodes.astype("int64"),
                               labels)
    np.testing.assert_array_equal(new_table, old_table)
    # second solve: served from the in-memory cache, still zero cold
    session.solve(incremental=True)
    assert session.counters["subproblems_solved"] == 0


def _solve_and_patch(session, rec, assignments, incremental):
    """Apply + solve + stable-relabel WITHOUT touching the on-disk LUT;
    returns the would-be new table."""
    from cluster_tools_tpu_torch.edits import stable_relabel

    affected = session.apply_edit(rec)
    labels = session.solve(incremental=incremental, expected=set(affected),
                           corr_id=rec.edit_id)
    old = np.load(assignments)
    return affected, stable_relabel(old, session.s0_nodes.astype("int64"),
                                    labels)


@pytest.mark.parametrize("op", ["merge", "split"])
def test_incremental_identical_to_scratch(workspace, op):
    """The acceptance gate: warm-started incremental re-solve and a
    from-scratch re-solve of the edited problem produce IDENTICAL
    assignments — and the edit actually took effect."""
    from cluster_tools_tpu_torch.edits import EditLog

    p = _paths(workspace)
    table = np.load(p["assignments"])
    probe = _session(workspace)
    a, b = _pick_pair(probe, table, same_segment=(op == "split"))
    log = EditLog(str(workspace / "edits.jsonl"))
    rec = log.append(op, [a, b])

    inc = _session(workspace)
    affected, table_inc = _solve_and_patch(inc, rec, p["assignments"],
                                           incremental=True)
    assert affected
    # warm start did its job: cold solves bounded by the edit footprint,
    # no stale-cache fallbacks on a healthy container
    assert 0 < inc.counters["subproblems_solved"] <= len(affected)
    assert inc.counters["fallback"] == 0
    assert inc.counters["warm_reused"] >= 27 - len(affected)

    scratch = _session(workspace)
    scratch.replay(log)
    labels_scr = scratch.solve(incremental=False)
    assert scratch.counters["subproblems_solved"] == 27
    from cluster_tools_tpu_torch.edits import stable_relabel

    table_scr = stable_relabel(np.load(p["assignments"]),
                               scratch.s0_nodes.astype("int64"), labels_scr)
    np.testing.assert_array_equal(table_inc, table_scr)
    if op == "merge":
        assert table_inc[a] == table_inc[b] and table[a] != table[b]
    else:
        assert table_inc[a] != table_inc[b] and table[a] == table[b]
    # untouched segments kept their ids: the delta is local to the edit
    changed = np.flatnonzero(table_inc != table)
    assert 0 < changed.size < len(table) // 2


def test_stale_cache_falls_back_with_flight_record(workspace, tmp_path):
    """A persisted sub_result whose signature no longer matches the live
    problem OUTSIDE the edit's footprint is never trusted: full solve,
    fallback counter, flight record carrying the edit's correlation id —
    and the output still matches from-scratch."""
    from cluster_tools_tpu_torch.edits import EditLog, stable_relabel
    from cluster_tools_tpu_torch.workflows import multicut as mc

    p = _paths(workspace)
    table = np.load(p["assignments"])
    probe = _session(workspace)
    a, b = _pick_pair(probe, table, same_segment=False)
    affected_probe = set(probe.affected_blocks([a, b]))
    stale_bid = next(bid for bid in range(probe.blocking.n_blocks)
                     if bid not in affected_probe
                     and len(probe.block_nodes(bid)))
    # corrupt the stored signature (content untouched: the point is the
    # session must NOT reuse it even though the cut ids happen to agree)
    path = mc._sub_result_path(p["problem"], 0, stale_bid)
    with np.load(path) as d:
        cut_ids = d["cut_edge_ids"]
    np.savez(path, cut_edge_ids=cut_ids,
             signature=np.asarray("0" * 16))

    flight_dir = str(tmp_path / "flight")
    log = EditLog(str(workspace / "edits.jsonl"))
    rec = log.append("merge", [a, b], edit_id="corr-42")
    session = _session(workspace, flight_dir=flight_dir)
    affected, table_inc = _solve_and_patch(session, rec, p["assignments"],
                                           incremental=True)
    assert session.counters["fallback"] == 1
    recs = glob.glob(os.path.join(flight_dir, "flightrec_*.json"))
    assert len(recs) == 1
    with open(recs[0]) as f:
        doc = json.load(f)
    assert doc["reason"] == "edit-warm-fallback"
    assert doc["extra"]["edit_id"] == "corr-42"
    assert doc["extra"]["block"] == stale_bid
    assert doc["extra"]["live_signature"] != doc["extra"]["stored_signature"]
    assert doc["extra"]["expected_blocks"] == sorted(affected)

    scratch = _session(workspace)
    scratch.replay(log)
    table_scr = stable_relabel(
        np.load(p["assignments"]), scratch.s0_nodes.astype("int64"),
        scratch.solve(incremental=False))
    np.testing.assert_array_equal(table_inc, table_scr)


def test_unknown_fragment_rejected(workspace):
    session = _session(workspace)
    with pytest.raises(ValueError, match="unknown fragment"):
        session.dense_index([int(session.s0_nodes.max()) + 1000, 1])


# ---------------------------------------------------------------------------
# paintera assignment round-trip
# ---------------------------------------------------------------------------


def test_paintera_pairs_roundtrip_and_offset_convention():
    from cluster_tools_tpu_torch.workflows.paintera import (assignment_to_pairs,
                                                      pairs_to_table)

    table = np.asarray([0, 3, 3, 5, 1, 5], "uint64")
    pairs = assignment_to_pairs(table)
    # segment ids offset past the largest FRAGMENT id: the two id spaces
    # never collide (dense table: offset == len(table))
    assert pairs.shape == (2, 5)           # fragment 0 dropped
    assert pairs[1].min() >= pairs[0].max() + 1
    assert int(pairs[1][0]) == 3 + len(table)
    back = pairs_to_table(pairs, n_labels=len(table))
    np.testing.assert_array_equal(back, table)
    # empty-assignment edge case round-trips to all-background
    empty = assignment_to_pairs(np.zeros(0, "uint64"))
    assert empty.shape == (2, 0)
    np.testing.assert_array_equal(pairs_to_table(empty, n_labels=4),
                                  np.zeros(4, "uint64"))


def test_paintera_assignment_disk_roundtrip(workspace, tmp_path):
    """load_assignments -> LUT patch (no-op) -> re-load is bit-identical,
    and the paintera pairs dataset survives shape-changing rewrites."""
    from cluster_tools_tpu_torch.edits import patch_assignment_table
    from cluster_tools_tpu_torch.workflows.paintera import (
        assignment_to_pairs, load_fragment_segment_assignment,
        pairs_to_table, write_fragment_segment_assignment)
    from cluster_tools_tpu_torch.workflows.write import load_assignments

    p = _paths(workspace)
    session = _session(workspace)
    table = load_assignments(p["assignments"], None)
    new_table, changed = patch_assignment_table(
        p["assignments"], session.s0_nodes.astype("int64"),
        table[session.s0_nodes.astype("int64")])
    assert changed.size == 0               # identity labels -> no-op patch
    np.testing.assert_array_equal(load_assignments(p["assignments"], None),
                                  table)

    paintera = str(tmp_path / "paintera.n5")
    assert load_fragment_segment_assignment(paintera, "seg") is None \
        or True  # container absent is fine before the first write
    write_fragment_segment_assignment(paintera, "seg",
                                      assignment_to_pairs(table))
    pairs = load_fragment_segment_assignment(paintera, "seg")
    np.testing.assert_array_equal(pairs_to_table(pairs,
                                                 n_labels=len(table)), table)
    # shape-changing rewrite (fewer pairs) goes through recreate
    small = assignment_to_pairs(table[:5])
    write_fragment_segment_assignment(paintera, "seg", small)
    np.testing.assert_array_equal(
        load_fragment_segment_assignment(paintera, "seg"), small)


# ---------------------------------------------------------------------------
# the full edit lane on the resident server
# ---------------------------------------------------------------------------


def test_edit_pipeline_on_server_end_to_end(workspace):
    """submit -> resolve -> incremental solve -> LUT patch -> block
    rewrite through the server's edit lane: the LUT and the segmentation
    volume update consistently, only touched blocks are rewritten, and
    the edit's metrics/log/status all line up."""
    from cluster_tools_tpu_torch.core import telemetry
    from cluster_tools_tpu_torch.core.blocking import Blocking
    from cluster_tools_tpu_torch.core.server import ResidentSegmentationServer
    from cluster_tools_tpu_torch.core.storage import file_reader
    from cluster_tools_tpu_torch.edits import EditLog, EditPipeline

    from test_torch_server import StubPipeline

    p = _paths(workspace)
    with file_reader(p["data"], "r") as f:
        frags, seg_before = f["ws"][:], f["seg"][:]
    table_before = np.load(p["assignments"])
    session = _session(workspace)
    a, b = _pick_pair(session, table_before, same_segment=False)

    log = EditLog(str(workspace / "edits.jsonl"))
    pipe = EditPipeline(
        session, log, p["assignments"], ws_path=p["data"], ws_key="ws",
        output_path=p["data"], output_key="seg")
    srv = ResidentSegmentationServer(str(workspace / "srv"), StubPipeline(),
                                     metrics_path="",
                                     lane_pipelines={"edit": pipe})
    h = srv.submit("ann", {"op": "merge", "fragments": [a, b]}, lane="edit")
    while srv.step_once():
        pass
    res = h.result(0)
    assert res["op"] == "merge" and res["fragments"] == sorted([a, b])
    assert res["edit_id"] == log.records()[0].edit_id
    assert res["affected_blocks"] and res["changed_fragments"] > 0
    assert res["round_trip_s"] > 0
    assert res["counters"]["applied"] == 1
    with open(h.status_path) as f:
        status = json.load(f)
    assert status["state"] == "done" and status["lane"] == "edit"
    assert status["n_blocks"] == len(res["affected_blocks"])

    table_after = np.load(p["assignments"])
    assert table_after[a] == table_after[b]
    with file_reader(p["data"], "r") as f:
        seg_after = f["seg"][:]
    # the volume reflects the patched LUT everywhere...
    np.testing.assert_array_equal(seg_after, table_after[frags])
    # ...yet only the touched blocks were actually rewritten
    assert res["touched_blocks"]
    assert pipe.blocks_rewritten == len(res["touched_blocks"])
    blocking = Blocking(list(frags.shape), session.block_shape)
    untouched = [bid for bid in range(blocking.n_blocks)
                 if bid not in res["touched_blocks"]]
    assert untouched
    for bid in untouched:
        bb = blocking.get_block(bid).bb
        np.testing.assert_array_equal(seg_after[bb], seg_before[bb])

    # metrics families use the registered ctt_edit_* names and render to
    # lintable exposition text
    families = pipe.metrics_families()
    names = [fam[0] for fam in families]
    assert names == ["ctt_edit_applied_total", "ctt_edit_subproblems_total",
                     "ctt_edit_warm_reused_total", "ctt_edit_fallback_total",
                     "ctt_edit_blocks_rewritten_total",
                     "ctt_edit_round_trip_seconds"]
    for name in names:
        assert telemetry.is_registered_metric(name), name
    prom = str(workspace / "edit_metrics.prom")
    telemetry.write_prometheus(prom, families)
    with open(prom) as f:
        text = f.read()
    assert telemetry.lint_prometheus(text) == []
    assert "ctt_edit_applied_total 1" in text
    assert "ctt_edit_round_trip_seconds_bucket" in text


def test_edit_pipeline_spans_carry_edit_stages(workspace):
    """Every phase of a server-driven edit lands under its registered
    edit:* stage in the span stream."""
    from cluster_tools_tpu_torch.core import telemetry
    from cluster_tools_tpu_torch.core.server import ResidentSegmentationServer
    from cluster_tools_tpu_torch.edits import EditLog, EditPipeline

    from test_torch_server import StubPipeline

    telemetry.configure(enabled=True)
    p = _paths(workspace)
    session = _session(workspace)
    table = np.load(p["assignments"])
    a, b = _pick_pair(session, table, same_segment=True)
    pipe = EditPipeline(session, EditLog(str(workspace / "edits.jsonl")),
                        p["assignments"], ws_path=p["data"], ws_key="ws",
                        output_path=p["data"], output_key="seg")
    srv = ResidentSegmentationServer(str(workspace / "srv"), StubPipeline(),
                                     metrics_path="",
                                     lane_pipelines={"edit": pipe})
    h = srv.submit("ann", {"op": "split", "fragments": [a, b]}, lane="edit")
    while srv.step_once():
        pass
    h.result(0)
    stages = {s.name for s in telemetry.spans_snapshot()
              if s.cat == "stage"}
    for st in ("edit:resolve", "edit:solve", "edit:patch", "edit:write"):
        assert st in stages, (st, sorted(stages))
        assert telemetry.is_registered(st), st


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------


def _jax_session(ws, **kw):
    from cluster_tools_tpu.edits import EditSession

    return EditSession(_paths(ws)["problem"], **kw)


def _edit_pairs(session, table, n_pairs, same_segment):
    """Disjoint adjacent fragment pairs sharing >= 1 subproblem block,
    currently in the same (split candidates) / different (merge
    candidates) segment — the deterministic scan over the s0 edge list
    that mines the edit stream of bench.py's edits config."""
    used, out = set(), []
    for u, v in session.base_uv:
        ou, ov = int(session.s0_nodes[u]), int(session.s0_nodes[v])
        if ou == 0 or ov == 0 or ou in used or ov in used:
            continue
        if bool(table[ou] == table[ov]) != same_segment:
            continue
        if not session.affected_blocks([ou, ov]):
            continue
        out.append((ou, ov))
        used.update((ou, ov))
        if len(out) == n_pairs:
            break
    return out


def test_problem_is_the_jax_packages(workspace, jax_workspace):
    """Both packages' workflows wrote the same problem: s0 graph, costs,
    block geometry, per-block node sets and the committed assignment."""
    port, jax = _session(workspace), _jax_session(jax_workspace)
    np.testing.assert_array_equal(port.base_uv, jax.base_uv)
    np.testing.assert_array_equal(port.s0_nodes, jax.s0_nodes)
    np.testing.assert_array_equal(port.costs, jax.costs)
    assert list(port.shape) == list(jax.shape)
    assert list(port.block_shape) == list(jax.block_shape)
    for bid in range(port.blocking.n_blocks):
        np.testing.assert_array_equal(port.block_nodes(bid),
                                      jax.block_nodes(bid))
        assert port.block_signature(bid)[0] == jax.block_signature(bid)[0]
    np.testing.assert_array_equal(np.load(_paths(workspace)["assignments"]),
                                  np.load(_paths(jax_workspace)[
                                      "assignments"]))


def test_edit_stream_matches_jax(workspace, jax_workspace):
    """Three merges and three splits, applied in turn to the JAX
    EditSession and the port's: after every edit the affected blocks and
    the per-node labels are identical, and the port's incremental solve
    equals its from-scratch solve of the edited problem."""
    from cluster_tools_tpu.edits import EditLog as JaxEditLog
    from cluster_tools_tpu_torch.edits import EditLog

    port, jax = _session(workspace), _jax_session(jax_workspace)
    table = np.load(_paths(jax_workspace)["assignments"])
    stream = [("merge", p) for p in _edit_pairs(jax, table, 3, False)] + \
        [("split", p) for p in _edit_pairs(jax, table, 3, True)]
    assert len(stream) == 6
    log = EditLog(str(workspace / "edits.jsonl"))
    jax_log = JaxEditLog(str(jax_workspace / "edits.jsonl"))
    for i, (op, frs) in enumerate(stream):
        rec = log.append(op, frs, edit_id=f"e{i}")
        jrec = jax_log.append(op, frs, edit_id=f"e{i}")
        affected = port.apply_edit(rec)
        assert affected == jax.apply_edit(jrec) and affected
        labels = port.solve(incremental=True, expected=set(affected),
                            corr_id=rec.edit_id)
        jlabels = jax.solve(incremental=True, expected=set(affected),
                            corr_id=jrec.edit_id)
        np.testing.assert_array_equal(labels, jlabels)
        scratch = _session(workspace)
        assert scratch.replay(log) == i + 1
        np.testing.assert_array_equal(
            labels, scratch.solve(incremental=False))
        assert port.counters["fallback"] == 0
        a, b = (int(x) for x in port.dense_index(frs))
        assert (labels[a] == labels[b]) == (op == "merge")
    assert port.counters == jax.counters


def test_stable_relabel_matches_jax(workspace):
    from cluster_tools_tpu.edits import stable_relabel as jax_relabel
    from cluster_tools_tpu_torch.edits import stable_relabel

    session = _session(workspace)
    old = np.load(_paths(workspace)["assignments"])
    nodes = session.s0_nodes.astype("int64")
    rng = np.random.RandomState(0)
    for labels in (old[nodes], rng.randint(0, 5, len(nodes)),
                   np.arange(len(nodes))):
        np.testing.assert_array_equal(stable_relabel(old, nodes, labels),
                                      jax_relabel(old, nodes, labels))
