"""Block stitching of the port against the JAX package, on the CPU.

``match_face_segments`` returns the JAX package's pairs;
``StitchingWorkflow`` (mutual-best-overlap face matching),
``StitchingAssignmentsWorkflow`` (merge every block-boundary RAG edge)
and ``SimpleStitchingWorkflow`` (the same over a feature-only problem)
write identical outputs through both packages on the same inputs.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

SHAPE = (20, 20, 20)
BLOCK = [10, 10, 10]


def _split_label_volume(shape, block_shape, n_cells=4, seed=0):
    """Voronoi cells, then relabelled per block (the unstitched state:
    every block uses its own ids) — the recipe of
    tests/test_stitching.py:14-35."""
    rng = np.random.RandomState(seed)
    points = rng.rand(n_cells, len(shape)) * np.array(shape)
    grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    coords = np.stack([g.ravel() for g in grids], axis=1)
    d = np.linalg.norm(coords[:, None, :] - points[None, :, :], axis=2)
    truth = (d.argmin(axis=1) + 1).reshape(shape).astype("uint64")
    return truth, _split_per_block(truth, block_shape)


def _split_per_block(truth, block_shape):
    """``truth`` relabelled with consecutive ids per block."""
    from cluster_tools_tpu_torch.core.blocking import Blocking

    blocking = Blocking(list(truth.shape), list(block_shape))
    split = np.zeros(truth.shape, "uint64")
    offset = 0
    for bid in range(blocking.n_blocks):
        bb = blocking.get_block(bid).bb
        uniq = np.unique(truth[bb])
        split[bb] = np.searchsorted(uniq, truth[bb]) + 1 + offset
        offset += len(uniq)
    return split


def _pkg(pkg):
    if pkg == "jax":
        import cluster_tools_tpu as M
        from cluster_tools_tpu.core.config import ConfigDir
        return M, ConfigDir, "threads", {}
    import cluster_tools_tpu_torch as M
    from cluster_tools_tpu_torch.core.config import ConfigDir
    return M, ConfigDir, "gpu", {"device": "cpu"}


def _common(pkg, root, task_configs=None, block=BLOCK):
    M, ConfigDir, target, extra = _pkg(pkg)
    cfg = os.path.join(root, f"cfg_{pkg}")
    ConfigDir(cfg).write_global_config({"block_shape": list(block),
                                        "max_num_retries": 0, **extra})
    for name, conf in (task_configs or {}).items():
        ConfigDir(cfg).write_task_config(name, conf)
    return M, dict(tmp_folder=os.path.join(root, f"tmp_{pkg}"),
                   config_dir=cfg, max_jobs=2, target=target)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.9])
def test_match_face_segments_matches_jax(seed, threshold):
    from cluster_tools_tpu.workflows.stitching import \
        match_face_segments as j_match
    from cluster_tools_tpu_torch.workflows.stitching import \
        match_face_segments as p_match

    rng = np.random.RandomState(seed)
    a = rng.randint(0, 6, (9, 11)).astype("uint64")
    b = np.where(rng.rand(9, 11) < 0.8, a + 10, rng.randint(0, 15, (9, 11)))
    b = b.astype("uint64")
    for ignore in (0, None):
        want = j_match(a, b, threshold, ignore)
        got = p_match(a, b, threshold, ignore, device="cpu")
        assert got.dtype == want.dtype == np.uint64
        np.testing.assert_array_equal(got, want)


def test_match_face_segments_rule():
    """The JAX package's cases (tests/test_stitching.py:38-57)."""
    from cluster_tools_tpu_torch.workflows.stitching import \
        match_face_segments

    a = np.array([[1, 1, 1, 2, 2, 2]], "uint64")
    b = np.array([[10, 10, 10, 11, 11, 11]], "uint64")
    pairs = match_face_segments(a, b, 0.5, device="cpu")
    assert sorted(map(tuple, pairs.tolist())) == [(1, 10), (2, 11)]
    a = np.array([[1, 1, 1, 1, 1, 2]], "uint64")
    b = np.array([[10, 11, 11, 11, 11, 11]], "uint64")
    pairs = set(map(tuple, match_face_segments(a, b, 0.3,
                                               device="cpu").tolist()))
    assert (1, 11) in pairs and (1, 10) not in pairs
    a = np.array([[1, 1, 2, 2]], "uint64")
    b = np.array([[10, 11, 11, 12]], "uint64")
    assert len(match_face_segments(a, b, 0.9, device="cpu")) == 0


def _stitch(pkg, root, path, threshold):
    M, common = _common(pkg, root,
                        {"stitch_faces": {"overlap_threshold": threshold}})
    if pkg == "jax":
        from cluster_tools_tpu.workflows.stitching import StitchingWorkflow
    else:
        StitchingWorkflow = M.StitchingWorkflow
    wf = StitchingWorkflow(labels_path=path, labels_key="split",
                           output_path=path, output_key=f"stitched_{pkg}",
                           **common)
    assert M.build([wf], raise_on_failure=True)
    with M.file_reader(path, "r") as f:
        return f[f"stitched_{pkg}"][:], f[f"stitched_{pkg}"].attrs["maxId"]


@pytest.mark.parametrize("seed,threshold", [(0, 0.5), (3, 0.9)])
def test_stitching_workflow_matches_jax(tmp_path, seed, threshold):
    from cluster_tools_tpu_torch.core.storage import file_reader
    from cluster_tools_tpu_torch.utils.validation import rand_index

    truth, split = _split_label_volume(SHAPE, BLOCK, n_cells=4, seed=seed)
    path = str(tmp_path / "data.n5")
    with file_reader(path) as f:
        f.require_dataset("split", data=split, chunks=BLOCK)
        f["split"].attrs["maxId"] = int(split.max())
    jx, j_max = _stitch("jax", str(tmp_path), path, threshold)
    pt, p_max = _stitch("torch", str(tmp_path), path, threshold)
    assert pt.dtype == jx.dtype == np.uint64 and p_max == j_max
    np.testing.assert_array_equal(pt, jx)
    # the JAX test's gates: no false merges, near-perfect recovery
    for sid in np.unique(pt):
        assert len(np.unique(truth[pt == sid])) == 1
    if threshold == 0.5:
        assert rand_index(pt, truth)[0] < 0.05


def test_false_merges_are_the_reference_rule(tmp_path):
    """At a realistic cell density the mutual-best-overlap rule on the two
    contact planes merges cells whose slivers meet across a face: the JAX
    package's workflow does, and the port gives the same labels."""
    from cluster_tools_tpu_torch.core.storage import file_reader
    from cluster_tools_tpu_torch.utils.synthetic import synthetic_instance

    block = [15, 80, 80]
    gt, _ = synthetic_instance((30, 160, 160), n_cells=60, seed=0)
    split = _split_per_block(gt, block)
    path = str(tmp_path / "data.n5")
    with file_reader(path) as f:
        f.require_dataset("split", data=split, chunks=[5, 40, 40])
        f["split"].attrs["maxId"] = int(split.max())
    out = {}
    for pkg in ("jax", "torch"):
        M, common = _common(pkg, str(tmp_path),
                            {"stitch_faces": {"overlap_threshold": 0.5}},
                            block=block)
        if pkg == "jax":
            from cluster_tools_tpu.workflows.stitching import \
                StitchingWorkflow
        else:
            StitchingWorkflow = M.StitchingWorkflow
        wf = StitchingWorkflow(labels_path=path, labels_key="split",
                               output_path=path, output_key=f"st_{pkg}",
                               **common)
        assert M.build([wf], raise_on_failure=True)
        with M.file_reader(path, "r") as f:
            out[pkg] = f[f"st_{pkg}"][:]
    np.testing.assert_array_equal(out["torch"], out["jax"])
    merged = [sid for sid in np.unique(out["torch"])
              if len(np.unique(gt[out["torch"] == sid])) > 1]
    assert merged  # the reference's rule, reproduced


def test_stitch_assignments_scans_for_a_missing_max_id(tmp_path):
    """Without the ``maxId`` attribute the assignment task scans the
    volume for it, as the JAX package's does."""
    from cluster_tools_tpu_torch.core.storage import file_reader

    truth, split = _split_label_volume(SHAPE, BLOCK, n_cells=4, seed=0)
    path = str(tmp_path / "data.n5")
    with file_reader(path) as f:
        f.require_dataset("split", data=split, chunks=BLOCK)
    jx, _ = _stitch("jax", str(tmp_path), path, 0.5)
    pt, _ = _stitch("torch", str(tmp_path), path, 0.5)
    np.testing.assert_array_equal(pt, jx)


def _problem_inputs(tmp_path):
    from cluster_tools_tpu_torch.core.storage import file_reader

    truth, split = _split_label_volume(SHAPE, BLOCK, n_cells=3, seed=5)
    uniq = np.unique(split)
    split = np.searchsorted(uniq, split).astype("uint64") + 1
    bmap = np.random.RandomState(0).rand(*SHAPE).astype("float32")
    path = str(tmp_path / "data.n5")
    with file_reader(path) as f:
        f.require_dataset("labels", data=split, chunks=BLOCK)
        f["labels"].attrs["maxId"] = int(split.max())
        f.require_dataset("boundaries", data=bmap, chunks=BLOCK)
    return truth, split, path


@pytest.mark.parametrize("edge_size_threshold", [0, 20])
def test_stitching_assignments_workflow_matches_jax(tmp_path,
                                                    edge_size_threshold):
    truth, split, path = _problem_inputs(tmp_path)
    out = {}
    for pkg in ("jax", "torch"):
        M, common = _common(pkg, str(tmp_path))
        if pkg == "jax":
            from cluster_tools_tpu.workflows.features import \
                EdgeFeaturesWorkflow
            from cluster_tools_tpu.workflows.graph import GraphWorkflow
            from cluster_tools_tpu.workflows.stitching import \
                StitchingAssignmentsWorkflow
        else:
            from cluster_tools_tpu_torch.workflows.features import \
                EdgeFeaturesWorkflow
            from cluster_tools_tpu_torch.workflows.graph import GraphWorkflow
            StitchingAssignmentsWorkflow = M.StitchingAssignmentsWorkflow
        problem = str(tmp_path / f"problem_{pkg}.n5")
        graph = GraphWorkflow(input_path=path, input_key="labels",
                              graph_path=problem, output_key="s0/graph",
                              **common)
        feats = EdgeFeaturesWorkflow(
            input_path=path, input_key="boundaries", labels_path=path,
            labels_key="labels", graph_path=problem, output_path=problem,
            graph_key="s0/graph", dependency=graph, **common)
        stitch = StitchingAssignmentsWorkflow(
            problem_path=problem, labels_path=path, labels_key="labels",
            assignments_path=problem, assignments_key="stitch_assignments",
            edge_size_threshold=edge_size_threshold, dependency=feats,
            **common)
        assert M.build([stitch], raise_on_failure=True)
        with M.file_reader(problem, "r") as f:
            out[pkg] = f["stitch_assignments"][:]
    np.testing.assert_array_equal(out["torch"], out["jax"])
    merged = out["torch"][split]
    if edge_size_threshold == 0:
        for cell in np.unique(truth):  # no splits left
            assert len(np.unique(merged[truth == cell])) == 1


def test_simple_stitching_workflow_matches_jax(tmp_path):
    truth, split, path = _problem_inputs(tmp_path)
    out = {}
    for pkg in ("jax", "torch"):
        M, common = _common(pkg, str(tmp_path))
        if pkg == "jax":
            from cluster_tools_tpu.workflows.segmentation import \
                SimpleStitchingWorkflow
        else:
            SimpleStitchingWorkflow = M.SimpleStitchingWorkflow
        wf = SimpleStitchingWorkflow(
            input_path=path, input_key="boundaries", ws_path=path,
            ws_key="labels", problem_path=str(tmp_path / f"p_{pkg}.n5"),
            output_path=path, output_key=f"seg_{pkg}", **common)
        assert M.build([wf], raise_on_failure=True)
        with M.file_reader(path, "r") as f:
            out[pkg] = (f[f"seg_{pkg}"][:], f[f"seg_{pkg}"].attrs["maxId"])
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    assert out["torch"][1] == out["jax"][1]
    for cell in np.unique(truth):
        assert len(np.unique(out["torch"][0][truth == cell])) == 1


def test_stitching_tasks_raise_without_a_card(tmp_path):
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir

    if torch.cuda.is_available():
        pytest.skip("this check needs a host without a CUDA device")
    truth, split, path = _problem_inputs(tmp_path)
    cfg = str(tmp_path / "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": BLOCK})
    common = dict(tmp_folder=str(tmp_path / "tmp"), config_dir=cfg)
    for wf in (ctp.StitchingWorkflow(labels_path=path, labels_key="labels",
                                     output_path=path, output_key="s",
                                     **common),
               ctp.StitchingAssignmentsWorkflow(
                   problem_path=str(tmp_path / "p.n5"), labels_path=path,
                   labels_key="labels", assignments_path=str(tmp_path),
                   assignments_key="a", **common),
               ctp.SimpleStitchingWorkflow(
                   input_path=path, input_key="boundaries", ws_path=path,
                   ws_key="labels", problem_path=str(tmp_path / "p.n5"),
                   output_path=path, output_key="s", **common)):
        assert wf.target == "gpu"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ctp.build([wf])
