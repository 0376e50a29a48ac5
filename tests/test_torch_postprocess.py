"""The post-processing toolbox and region features of the port
(``workflows/postprocess.py``, ``workflows/region_features.py``,
``native.graph_watershed``) against the JAX package, on the CPU.

Every output is a label volume or an assignment table, held exactly: the
size filters (background and filling), the id and threshold filters, the
graph watershed, orphan merging and graph connected components run the
same numpy and C++ steps, and the filling size filter's seeded watershed
gives the JAX package's labels.  Region means are float64 sums of the
same samples (rtol 1e-12).  The JAX seeded watershed compiles once per
block shape, so the filling cases share one ``[8, 8, 8]`` block shape."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest


def _env(pkg, root, block=(8, 8, 8)):
    if pkg == "jax":
        import cluster_tools_tpu as M
        from cluster_tools_tpu import native
        from cluster_tools_tpu.core.config import ConfigDir
        from cluster_tools_tpu.core.graph import save_graph
        from cluster_tools_tpu.workflows import postprocess as P
        from cluster_tools_tpu.workflows import region_features as R
        extra = {}
    else:
        import cluster_tools_tpu_torch as M
        from cluster_tools_tpu_torch import native
        from cluster_tools_tpu_torch.core.config import ConfigDir
        from cluster_tools_tpu_torch.core.graph import save_graph
        from cluster_tools_tpu_torch.workflows import postprocess as P
        from cluster_tools_tpu_torch.workflows import region_features as R
        extra = {"device": "cpu"}
    os.makedirs(root, exist_ok=True)
    cfg = os.path.join(root, "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": list(block),
                                        "max_num_retries": 0, **extra})
    return SimpleNamespace(
        M=M, P=P, R=R, native=native, save_graph=save_graph,
        path=os.path.join(root, "d.n5"), problem=os.path.join(root, "p.n5"),
        common=dict(tmp_folder=os.path.join(root, "tmp"), config_dir=cfg,
                    max_jobs=2, target="threads"))


def _write(env, path, key, data, max_id=False):
    with env.M.file_reader(path) as f:
        chunks = [8] * data.ndim if data.ndim == 3 else None
        ds = f.require_dataset(key, shape=data.shape, chunks=chunks,
                               dtype=str(data.dtype))
        ds[tuple(slice(0, s) for s in data.shape)] = data
        if max_id:
            ds.attrs["maxId"] = int(data.max())


def _read(env, path, key):
    with env.M.file_reader(path, "r") as f:
        return f[key][:]


def _both(tmp_path, fn):
    """``fn(env)`` in the JAX package and in the port; returns both
    results."""
    return (fn(_env("jax", str(tmp_path / "jax"))),
            fn(_env("torch", str(tmp_path / "torch"))))


def _seg_volume(shape=(16, 16, 16)):
    """Labels 1..4 as axis-aligned slabs + one tiny segment 5 (the JAX
    package's test volume)."""
    seg = np.zeros(shape, "uint64")
    seg[:4] = 1
    seg[4:8] = 2
    seg[8:12] = 3
    seg[12:] = 4
    seg[0, 0, 0:3] = 5
    return seg


def _random_seg(shape=(16, 16, 16), seed=0):
    """Blocky segments of random sizes, some below the size threshold."""
    rng = np.random.RandomState(seed)
    seg = np.kron(rng.randint(1, 40, [s // 4 for s in shape]),
                  np.ones((4, 4, 4), "int64")).astype("uint64")
    seg[rng.rand(*shape) < 0.02] = 77  # scattered small id
    seg[0, :2, :2] = 0
    return seg


# ---------------------------------------------------------------------------
# size filters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("relabel", [False, True])
@pytest.mark.parametrize("vol", ["slabs", "random"])
def test_size_filter_background_matches_jax(tmp_path, relabel, vol):
    seg = _seg_volume() if vol == "slabs" else _random_seg()

    def run(env):
        _write(env, env.path, "seg", seg)
        wf = env.P.SizeFilterWorkflow(
            input_path=env.path, input_key="seg", output_path=env.path,
            output_key="filtered", size_threshold=10, relabel=relabel,
            **env.common)
        assert env.M.build([wf], raise_on_failure=True)
        return _read(env, env.path, "filtered")

    jx, pt = _both(tmp_path, run)
    np.testing.assert_array_equal(pt, jx)
    if vol == "slabs" and not relabel:
        assert (pt[seg == 5] == 0).all()
        for lbl in (1, 2, 3, 4):
            assert (pt[seg == lbl] == lbl).all()


@pytest.fixture(scope="module")
def fill_reference():
    """The JAX package's filling step (``FilterBlocksBase._fill``, its
    seeded watershed) on two ``(8, 8, 8)`` blocks, once per module."""
    from cluster_tools_tpu.workflows.postprocess import FilterBlocksBase

    rng = np.random.RandomState(3)
    cases = []
    for k in range(2):
        seg = _random_seg((8, 8, 8), seed=k)
        seg[rng.rand(8, 8, 8) < 0.3] = 0
        hmap = rng.rand(8, 8, 8).astype("float32")
        cases.append((seg, hmap, FilterBlocksBase._fill(seg, hmap)))
    return cases


@pytest.mark.parametrize("case", [0, 1])
def test_fill_matches_jax(fill_reference, case):
    from cluster_tools_tpu_torch.workflows.postprocess import \
        FilterBlocksBase

    seg, hmap, want = fill_reference[case]
    got = FilterBlocksBase._fill(seg, hmap, device="cpu")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (got > 0).all()


@pytest.mark.parametrize("hmap_kind", ["zeros", "random"])
def test_size_filter_filling_matches_jax(tmp_path, fill_reference,
                                         hmap_kind):
    """The JAX package's slow filling test at a tier-1 size (its blocks
    share the compiled watershed of ``fill_reference``): the sliver is
    regrown into the surrounding segment, no holes."""
    seg = _seg_volume()
    hmap = np.zeros(seg.shape, "float32") if hmap_kind == "zeros" else \
        np.random.RandomState(4).rand(*seg.shape).astype("float32")

    def run(env):
        _write(env, env.path, "seg", seg)
        _write(env, env.path, "hmap", hmap)
        wf = env.P.SizeFilterWorkflow(
            input_path=env.path, input_key="seg", output_path=env.path,
            output_key="filled", size_threshold=10, hmap_path=env.path,
            hmap_key="hmap", relabel=False, **env.common)
        assert env.M.build([wf], raise_on_failure=True)
        return _read(env, env.path, "filled")

    jx, pt = _both(tmp_path, run)
    np.testing.assert_array_equal(pt, jx)
    assert (pt[seg == 5] == 1).all()
    assert (pt > 0).all()


def test_merge_block_counts_matches_jax(tmp_path):
    from cluster_tools_tpu.workflows.postprocess import \
        merge_block_counts as jmerge

    from cluster_tools_tpu_torch.workflows.postprocess import \
        merge_block_counts

    rng = np.random.RandomState(0)
    for b in range(3):
        ids = np.unique(rng.randint(0, 20, 8)).astype("uint64")
        np.savez(str(tmp_path / f"cnt_block_{b}.npz"), ids=ids,
                 counts=rng.randint(1, 9, len(ids)).astype("uint64"))
    for got, want in zip(merge_block_counts(str(tmp_path), "cnt"),
                         jmerge(str(tmp_path), "cnt")):
        np.testing.assert_array_equal(got, want)
    empty = merge_block_counts(str(tmp_path), "none")
    assert len(empty[0]) == 0 and empty[0].dtype == np.uint64


# ---------------------------------------------------------------------------
# id and threshold filters, region features
# ---------------------------------------------------------------------------

def test_filter_labels_workflow_matches_jax(tmp_path):
    seg = _seg_volume()
    sem = (np.where(np.arange(16)[:, None, None] < 8, 9, 7)
           * np.ones(seg.shape, "uint64")).astype("uint64")

    def run(env):
        _write(env, env.path, "seg", seg, max_id=True)
        _write(env, env.path, "sem", sem)
        wf = env.P.FilterLabelsWorkflow(
            input_path=env.path, input_key="seg", label_path=env.path,
            label_key="sem", node_label_path=env.path,
            node_label_key="node_labels", output_path=env.path,
            output_key="filtered", filter_labels=[9], **env.common)
        assert env.M.build([wf], raise_on_failure=True)
        with open(os.path.join(env.common["tmp_folder"],
                               "filtered_ids.json")) as fh:
            ids = json.load(fh)
        return _read(env, env.path, "filtered"), ids

    (jx, jids), (pt, pids) = _both(tmp_path, run)
    np.testing.assert_array_equal(pt, jx)
    assert pids == jids == [1, 2, 5]
    assert set(np.unique(pt)) == {0, 3, 4}


def _seg_and_data(shape=(16, 16, 16), seed=0):
    rng = np.random.RandomState(seed)
    seg = np.zeros(shape, "uint64")
    seg[:, :8, :] = 1
    seg[:, 8:, :] = 2
    seg[4:8, 4:8, 4:8] = 3
    return seg, rng.rand(*shape).astype("float32")


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_region_features_workflow_matches_jax(tmp_path, dtype):
    seg, data = _seg_and_data()
    seg[0, 0, :4] = 0  # ignore label 0
    if dtype == "uint8":
        data = (data * 255).astype("uint8")

    def run(env):
        _write(env, env.path, "data", data)
        _write(env, env.path, "seg", seg, max_id=True)
        out = env.path[:-5] + "_f.n5"
        wf = env.R.RegionFeaturesWorkflow(
            input_path=env.path, input_key="data", labels_path=env.path,
            labels_key="seg", output_path=out, output_key="feats",
            **env.common)
        assert env.M.build([wf], raise_on_failure=True)
        return _read(env, out, "feats"), _read(env, out, "feats_counts")

    (jm, jc), (pm, pc) = _both(tmp_path, run)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_allclose(pm, jm, rtol=1e-12)
    scale = 255.0 if dtype == "uint8" else 1.0
    for lbl in (1, 2, 3):
        m = seg == lbl
        np.testing.assert_allclose(pm[lbl], data[m].mean() / scale,
                                   rtol=1e-5)
        assert pc[lbl] == m.sum()
    assert pc[0] == 0


@pytest.mark.parametrize("relabel", [False, True])
def test_filter_by_threshold_workflow_matches_jax(tmp_path, relabel):
    seg, _ = _seg_and_data()
    data = np.where((seg == 1) | (seg == 3), 0.9, 0.1).astype("float32")

    def run(env):
        _write(env, env.path, "data", data)
        _write(env, env.path, "seg", seg, max_id=True)
        wf = env.P.FilterByThresholdWorkflow(
            input_path=env.path, input_key="data", seg_in_path=env.path,
            seg_in_key="seg", seg_out_path=env.path, seg_out_key="filtered",
            threshold=0.5, relabel=relabel, **env.common)
        assert env.M.build([wf], raise_on_failure=True)
        return _read(env, env.path, "filtered")

    jx, pt = _both(tmp_path, run)
    np.testing.assert_array_equal(pt, jx)
    assert (pt[seg == 2] == 0).all()
    if not relabel:
        assert (pt[seg == 1] == 1).all() and (pt[seg == 3] == 3).all()


@pytest.mark.parametrize("mode", ["less", "greater", "equal"])
def test_apply_threshold_matches_jax(tmp_path, mode):
    feats = np.array([0.1, 0.5, 0.9, 0.5, 0.2], "float32")

    def run(env):
        _write(env, env.path, "f", feats)
        out = os.path.join(env.common["tmp_folder"], "ids.json")
        task = env.P.ApplyThreshold(feature_path=env.path, feature_key="f",
                                    out_path=out, threshold=0.5,
                                    threshold_mode=mode, **env.common)
        assert env.M.build([task], raise_on_failure=True)
        with open(out) as fh:
            return json.load(fh)

    jx, pt = _both(tmp_path, run)
    assert pt == jx
    from cluster_tools_tpu_torch.workflows.postprocess import ApplyThreshold
    with pytest.raises(ValueError, match="threshold_mode"):
        ApplyThreshold(feature_path="a", feature_key="f", out_path="o",
                       threshold=0.5, threshold_mode="between",
                       tmp_folder=str(tmp_path), config_dir=str(tmp_path))


# ---------------------------------------------------------------------------
# graph steps
# ---------------------------------------------------------------------------

def _random_graph(seed, n=40, p=0.12):
    rng = np.random.RandomState(seed)
    uv = np.array([(i, j) for i in range(n) for j in range(i + 1, n)
                   if rng.rand() < p], "uint64")
    return n, uv, rng.rand(len(uv))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("smallest_first", [True, False])
def test_graph_watershed_binding_matches_jax(seed, smallest_first):
    """The C++ graph watershed through the port's binding: identical
    labels, with the weights negated for ``grow_smallest_first``."""
    from cluster_tools_tpu import native as jn

    from cluster_tools_tpu_torch import native as pn

    n, uv, w = _random_graph(seed)
    rng = np.random.RandomState(seed + 10)
    seeds = np.where(rng.rand(n) < 0.2, rng.randint(1, 6, n), 0
                     ).astype("uint64")
    got = pn.graph_watershed(n, uv, w, seeds,
                             grow_smallest_first=smallest_first)
    np.testing.assert_array_equal(
        got, jn.graph_watershed(n, uv, w, seeds,
                                grow_smallest_first=smallest_first))
    assert got.dtype == np.uint64 and (seeds == np.asarray(seeds)).all()


def test_graph_watershed_binding_checks_sizes():
    from cluster_tools_tpu_torch import native

    uv = np.array([[0, 1]], "uint64")
    with pytest.raises(ValueError, match="one weight per edge"):
        native.graph_watershed(2, uv, np.ones(2), np.zeros(2, "uint64"))
    with pytest.raises(ValueError, match="one seed entry per node"):
        native.graph_watershed(2, uv, np.ones(1), np.zeros(3, "uint64"))


def _gws(env, uv, feats, assignments, discard, n_nodes, from_costs=False,
         relabel=False):
    env.save_graph(env.problem, "graph", np.arange(n_nodes, dtype="uint64"),
                   uv, (1, 1, 1))
    _write(env, env.problem, "features", feats)
    _write(env, env.problem, "assignments", assignments)
    discard_path = env.problem[:-5] + "_discard.npy"
    np.save(discard_path, np.asarray(discard, "uint64"))
    task = env.P.GraphWatershedAssignments(
        problem_path=env.problem, graph_key="graph", features_key="features",
        assignment_path=env.problem, assignment_key="assignments",
        output_path=env.problem, output_key="new_assignments",
        filter_nodes_path=discard_path, relabel=relabel,
        from_costs=from_costs, **env.common)
    assert env.M.build([task], raise_on_failure=True)
    return _read(env, env.problem, "new_assignments")


def test_graph_watershed_assignments_matches_jax(tmp_path):
    """The JAX package's case: the discarded segment joins across its
    weakest boundary, background preserved."""
    uv = np.array([[1, 3], [2, 3], [1, 2], [0, 4]], "uint64")
    feats = np.zeros((4, 10), "float64")
    feats[:, 0] = [0.1, 0.9, 0.8, 0.5]
    jx, pt = _both(tmp_path, lambda env: _gws(
        env, uv, feats, np.arange(5, dtype="uint64"), [3], 5))
    np.testing.assert_array_equal(pt, jx)
    assert pt[3] == 1 and pt[0] == 0
    assert pt[1] == 1 and pt[2] == 2 and pt[4] == 4


@pytest.mark.parametrize("from_costs", [False, True])
@pytest.mark.parametrize("relabel", [False, True])
def test_graph_watershed_assignments_random_match_jax(tmp_path, from_costs,
                                                      relabel):
    n, uv, w = _random_graph(5)
    rng = np.random.RandomState(6)
    assignments = rng.randint(0, 12, n).astype("uint64")
    discard = [3, 7, 8]
    feats = w if from_costs else np.stack([w] + [w * 0] * 9, axis=1)
    jx, pt = _both(tmp_path, lambda env: _gws(
        env, uv, feats, assignments, discard, n, from_costs, relabel))
    np.testing.assert_array_equal(pt, jx)
    assert not np.isin(pt, discard).any() or relabel


def test_graph_watershed_assignments_rejects_bad_input(tmp_path):
    from cluster_tools_tpu_torch.core.workflow import BuildError

    env = _env("torch", str(tmp_path))
    uv = np.array([[0, 1], [1, 2]], "uint64")
    feats = np.ones((2, 10))
    with pytest.raises(BuildError):
        _gws(env, uv, feats, np.arange(3, dtype="uint64"), [0], 3)
    logs = os.path.join(env.common["tmp_folder"], "logs")
    assert any("ignore label" in open(os.path.join(logs, n)).read()
               for n in os.listdir(logs))


def _orphans(env, uv, assignments, relabel=False):
    env.save_graph(env.problem, "graph",
                   np.arange(len(assignments), dtype="uint64"), uv,
                   (1, 1, 1))
    _write(env, env.problem, "assignments", assignments)
    task = env.P.OrphanAssignments(
        graph_path=env.problem, graph_key="graph",
        assignment_path=env.problem, assignment_key="assignments",
        output_path=env.problem, output_key="out", relabel=relabel,
        **env.common)
    assert env.M.build([task], raise_on_failure=True)
    return _read(env, env.problem, "out")


@pytest.mark.parametrize("case", ["orphan", "mutual", "random",
                                  "random_relabel"])
def test_orphan_assignments_match_jax(tmp_path, case):
    if case == "orphan":
        uv = np.array([[0, 1], [1, 2], [2, 0], [1, 3]], "uint64")
        assignments, want = np.array([1, 2, 3, 4], "uint64"), [1, 2, 3, 2]
    elif case == "mutual":
        uv = np.array([[0, 1]], "uint64")
        assignments, want = np.array([1, 2], "uint64"), [1, 1]
    else:
        n, uv, _ = _random_graph(7, n=30, p=0.07)
        assignments = np.random.RandomState(8).randint(0, 15, n
                                                       ).astype("uint64")
        want = None
    relabel = case == "random_relabel"
    jx, pt = _both(tmp_path, lambda env: _orphans(env, uv, assignments,
                                                  relabel))
    np.testing.assert_array_equal(pt, jx)
    if want is not None:
        np.testing.assert_array_equal(pt, want)


def _graph_cc(env, uv, assignments, write=False, frags=None):
    env.save_graph(env.problem, "graph",
                   np.arange(len(assignments), dtype="uint64"), uv,
                   (1, 1, 1))
    _write(env, env.problem, "assignments", assignments)
    kw = {}
    if write:
        _write(env, env.path, "frags", frags, max_id=True)
        kw = dict(path=env.path, fragments_key="frags", output_key="seg")
    wf = env.P.ConnectedComponentsWorkflow(
        problem_path=env.problem, graph_key="graph",
        assignment_path=env.problem, assignment_key="assignments",
        output_path=env.problem, assignment_out_key="cc", **kw, **env.common)
    assert env.M.build([wf], raise_on_failure=True)
    out = _read(env, env.problem, "cc")
    return (out, _read(env, env.problem, "seg")) if write else out


def test_graph_connected_components_matches_jax(tmp_path):
    """The JAX package's case: one assignment over two unconnected pairs
    splits in two, no component erased to background."""
    uv = np.array([[0, 1], [2, 3]], "uint64")
    jx, pt = _both(tmp_path, lambda env: _graph_cc(
        env, uv, np.array([1, 1, 1, 1], "uint64")))
    np.testing.assert_array_equal(pt, jx)
    assert pt[0] == pt[1] and pt[2] == pt[3] and pt[0] != pt[2]
    assert (pt != 0).all()


def test_connected_components_workflow_writes_matches_jax(tmp_path):
    """Random assignments over a random graph, written back to a fragment
    volume (``WriteAssignments``)."""
    n, uv, _ = _random_graph(9, n=27, p=0.1)
    assignments = np.random.RandomState(10).randint(0, 5, n).astype("uint64")
    frags = np.kron(np.arange(27, dtype="uint64").reshape(3, 3, 3),
                    np.ones((4, 4, 4), "uint64"))
    (jcc, jseg), (pcc, pseg) = _both(tmp_path, lambda env: _graph_cc(
        env, uv, assignments, write=True, frags=frags))
    np.testing.assert_array_equal(pcc, jcc)
    np.testing.assert_array_equal(pseg, jseg)


def test_size_filter_and_graph_watershed_workflow_matches_jax(tmp_path):
    """The JAX package's end-to-end case: the tiny segment found by size,
    re-assigned by the graph watershed and written back."""
    shape = (8, 8, 8)
    frag = np.zeros(shape, "uint64")
    frag[:, :4, :] = 1
    frag[:, 4:, :] = 2
    frag[0, 0, 0] = 3
    uv = np.array([[1, 2], [1, 3], [2, 3]], "uint64")
    feats = np.zeros((3, 10), "float64")
    feats[:, 0] = [0.9, 0.1, 0.8]

    def run(env):
        _write(env, env.path, "frags", frag, max_id=True)
        _write(env, env.path, "seg", frag, max_id=True)
        _write(env, env.path, "assignments", np.arange(4, dtype="uint64"))
        env.save_graph(env.problem, "graph", np.arange(4, dtype="uint64"),
                       uv, shape)
        _write(env, env.problem, "features", feats)
        wf = env.P.SizeFilterAndGraphWatershedWorkflow(
            problem_path=env.problem, graph_key="graph",
            features_key="features", path=env.path, segmentation_key="seg",
            assignment_key="assignments", size_threshold=5,
            output_path=env.problem, assignment_out_key="new_assignments",
            fragments_key="frags", output_key="seg_gws", **env.common)
        assert env.M.build([wf], raise_on_failure=True)
        return (_read(env, env.problem, "new_assignments"),
                _read(env, env.problem, "seg_gws"))

    (ja, jseg), (pa, pseg) = _both(tmp_path, run)
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_array_equal(pseg, jseg)
    assert pa[3] == 1 and pa[1] == 1 and pa[2] == 2
    assert (pseg[frag == 3] == 1).all()


def test_postprocess_workflows_default_to_the_card(tmp_path):
    """The six workflows default to target "gpu"; the filling size
    filter, the one that runs on the device, raises without a card."""
    import torch

    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir

    cfg = str(tmp_path / "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": [8, 8, 8]})
    common = dict(tmp_folder=str(tmp_path / "tmp"), config_dir=cfg)
    io = dict(input_path="a.n5", input_key="s", output_path="a.n5",
              output_key="o")
    graph = dict(problem_path="p.n5", graph_key="g", output_path="p.n5",
                 assignment_out_key="a")
    wfs = [ctp.SizeFilterWorkflow(size_threshold=5, hmap_path="a.n5",
                                  hmap_key="h", **io, **common),
           ctp.FilterLabelsWorkflow(label_path="a", label_key="l",
                                    node_label_path="a", node_label_key="n",
                                    filter_labels=[1], **io, **common),
           ctp.FilterByThresholdWorkflow(
               input_path="a", input_key="d", seg_in_path="a",
               seg_in_key="s", seg_out_path="a", seg_out_key="o",
               threshold=0.5, **common),
           ctp.ConnectedComponentsWorkflow(assignment_path="p.n5",
                                           assignment_key="x", **graph,
                                           **common),
           ctp.FilterOrphansWorkflow(graph_path="p.n5", graph_key="g",
                                     path="a", segmentation_key="s",
                                     assignment_key="x", output_path="p",
                                     assignment_out_key="a", **common),
           ctp.SizeFilterAndGraphWatershedWorkflow(
               features_key="f", path="a", segmentation_key="s",
               assignment_key="x", size_threshold=5, **graph, **common),
           ctp.RegionFeaturesWorkflow(labels_path="a", labels_key="s",
                                      **io, **common)]
    assert all(wf.target == "gpu" for wf in wfs)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctp.build([wfs[0]])
