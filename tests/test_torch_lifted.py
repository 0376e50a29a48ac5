"""The lifted multicut and agglomerative clustering segmentations of the
port against the JAX package, on the CPU.

The solvers are the same C++ (``native/src/solvers.cpp``) behind new
ctypes bindings, so labels and objectives are identical; the lifted
neighborhood is the same scipy sweep; the two workflows end to end
(``LiftedMulticutSegmentationWorkflow``,
``AgglomerativeClusteringWorkflow``) give the JAX workflows' segmentation
on the nested-voronoi instance of ``tests/test_multicut.py``, each run
once per module."""

import os

import numpy as np
import pytest

from tests.test_multicut import _boundary_map, _nested_voronoi


def _random_instance(seed, n=9):
    rng = np.random.RandomState(seed)
    uv = np.array([(i, j) for i in range(n) for j in range(i + 1, n)
                   if rng.rand() < 0.5], "int64")
    luv = np.array([(i, j) for i in range(n) for j in range(i + 1, n)
                    if rng.rand() < 0.25], "int64").reshape(-1, 2)
    return n, uv, rng.randn(len(uv)), luv, rng.randn(len(luv)) * 2


def _known_instances():
    sq = np.array([[0, 1], [1, 2], [2, 3], [3, 0]], "int64")
    chain = np.array([[0, 1], [1, 2]], "int64")
    empty = np.zeros((0, 2), "int64")
    return [
        (4, sq, np.ones(4), np.array([[0, 2]]), np.array([-10.0])),
        (4, sq, np.ones(4), empty, np.zeros(0)),
        (3, chain, np.array([0.2, -0.1]), np.array([[0, 2]]),
         np.array([1.0])),
        (3, chain, np.array([0.2, -0.1]), np.array([[0, 2]]),
         np.array([-1.0])),
    ]


@pytest.mark.parametrize("case", list(range(4)) + [f"random{s}"
                                                   for s in range(6)])
def test_lifted_bindings_match_jax(case):
    """``lifted_multicut_gaec``, ``lifted_multicut_kernighan_lin`` (with
    and without warm start) and ``lifted_objective``: identical labels
    and objectives on the instances of ``tests/test_lifted.py`` and on
    random ones."""
    from cluster_tools_tpu import native as jn

    from cluster_tools_tpu_torch import native as pn

    if isinstance(case, int):
        n, uv, c, luv, lc = _known_instances()[case]
    else:
        n, uv, c, luv, lc = _random_instance(int(case[6:]))
    np.testing.assert_array_equal(pn.lifted_multicut_gaec(n, uv, c, luv, lc),
                                  jn.lifted_multicut_gaec(n, uv, c, luv, lc))
    for warm in (True, False):
        lab = pn.lifted_multicut_kernighan_lin(n, uv, c, luv, lc,
                                               warmstart=warm)
        np.testing.assert_array_equal(
            lab, jn.lifted_multicut_kernighan_lin(n, uv, c, luv, lc,
                                                  warmstart=warm))
        assert pn.lifted_objective(uv, c, luv, lc, lab) == \
            jn.lifted_objective(uv, c, luv, lc, lab)


def test_lifted_known_instance_optimum():
    """The square with a strongly repulsive lifted diagonal is cut (the
    optimum, -8), as in the JAX package's test."""
    from cluster_tools_tpu_torch import native

    n, uv, c, luv, lc = _known_instances()[0]
    lab = native.lifted_multicut_kernighan_lin(n, uv, c, luv, lc)
    assert lab[0] != lab[2]
    assert native.lifted_objective(uv, c, luv, lc, lab) == -8.0


@pytest.mark.parametrize("mode", ["all", "same", "different"])
@pytest.mark.parametrize("depth", [2, 3, 4])
def test_lifted_neighborhood_matches_jax(mode, depth):
    from cluster_tools_tpu.workflows.lifted_features import \
        lifted_neighborhood as jax_nh

    from cluster_tools_tpu_torch.workflows.lifted_features import \
        lifted_neighborhood

    rng = np.random.RandomState(depth)
    n = 40
    uv = np.unique(np.sort(rng.randint(0, n, (90, 2)), axis=1), axis=0)
    uv = uv[uv[:, 0] != uv[:, 1]]
    labels = rng.randint(0, 4, n).astype("uint64")
    got = lifted_neighborhood(uv, n, labels, depth, mode, node_chunk=7)
    want = jax_nh(uv, n, labels, depth, mode, node_chunk=7)
    np.testing.assert_array_equal(got, want)
    assert len(want) > 0


def test_block_task_id_chunks_and_n_labels(tmp_path):
    from cluster_tools_tpu_torch.core.runtime import BlockTask
    from cluster_tools_tpu_torch.core.storage import file_reader

    assert BlockTask.id_chunks(0, 10) == [0]
    assert BlockTask.id_chunks(10, 10) == [0]
    assert BlockTask.id_chunks(11, 10) == [0, 1]
    path = str(tmp_path / "d.n5")
    with file_reader(path) as f:
        ds = f.require_dataset("seg", shape=(4,), chunks=(4,),
                               dtype="uint64")
        ds.attrs["maxId"] = 41

    class _Probe(BlockTask):
        task_name = "probe"

        def __init__(self):  # no config directory needed for the helper
            self.n_labels = None
            self.labels_path, self.labels_key = path, "seg"

    assert _Probe().resolve_n_labels() == 42


def _run(pkg, root, workflow, **kw):
    if pkg == "jax":
        import cluster_tools_tpu as M
        from cluster_tools_tpu.core.config import ConfigDir
        from cluster_tools_tpu.core.storage import file_reader
        target, extra = "tpu", {}
    else:
        import cluster_tools_tpu_torch as M
        from cluster_tools_tpu_torch.core.config import ConfigDir
        from cluster_tools_tpu_torch.core.storage import file_reader
        target, extra = "gpu", {"device": "cpu"}
    true, frags = _nested_voronoi()
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "d.n5")
    with file_reader(path) as f:
        f.require_dataset("bmap", shape=true.shape, chunks=(12, 12, 12),
                          dtype="float32")[:] = _boundary_map(true)
        ds = f.require_dataset("ws", shape=true.shape, chunks=(12, 12, 12),
                               dtype="uint64")
        ds[:] = frags
        ds.attrs["maxId"] = int(frags.max())
        # the semantic prior: the true cells; the clearing labels: two
        # halves of the volume
        f.require_dataset("sem", shape=true.shape, chunks=(12, 12, 12),
                          dtype="uint64")[:] = true
        half = np.ones(true.shape, "uint64")
        half[:, :, 12:] = 2
        f.require_dataset("half", shape=true.shape, chunks=(12, 12, 12),
                          dtype="uint64")[:] = half
    cfg = os.path.join(root, "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": [12, 12, 12],
                                        **extra})
    common = dict(input_path=path, input_key="bmap", ws_path=path,
                  ws_key="ws", problem_path=os.path.join(root, "p.n5"),
                  output_path=path, output_key="seg",
                  tmp_folder=os.path.join(root, "tmp"), config_dir=cfg,
                  max_jobs=2, target=target)
    if workflow == "lifted":
        wf = M.LiftedMulticutSegmentationWorkflow(
            labels_path=path, labels_key="sem", lifted_prefix="sem",
            nh_graph_depth=3, **kw, **common)
    else:
        wf = M.AgglomerativeClusteringWorkflow(threshold=0.5, **common)
    assert M.build([wf], raise_on_failure=True)
    out = {"true": true, "frags": frags}
    with file_reader(path, "r") as f:
        out["seg"] = f["seg"][:]
    pp = os.path.join(root, "p.n5")
    with file_reader(pp, "r") as f:
        if workflow == "lifted":
            nh = f["s0/lifted_nh_sem"]
            out["nh"] = nh[:][:int(nh.attrs.get("n_edges", nh.shape[0]))]
            out["lcosts"] = f["s0/lifted_costs_sem"][:]
    return out


@pytest.fixture(scope="module", params=[
    ("lifted", {"n_scales": 1}), ("lifted", {"n_scales": 2}),
    ("lifted", {"n_scales": 1, "clear_labels_path": "half"}),
    ("agglo", {})], ids=["lifted", "lifted_2scales", "lifted_cleared",
                         "agglomerative"])
def runs(request, tmp_path_factory):
    workflow, kw = request.param
    root = tmp_path_factory.mktemp(f"w{request.param_index}")
    outs = []
    for pkg in ("jax", "torch"):
        kw_pkg = dict(kw)
        if "clear_labels_path" in kw_pkg:
            kw_pkg["clear_labels_path"] = os.path.join(str(root), pkg,
                                                       "d.n5")
            kw_pkg["clear_labels_key"] = "half"
        outs.append(_run(pkg, str(root / pkg), workflow, **kw_pkg))
    return workflow, outs


def test_segmentation_workflows_match_jax(runs):
    """The same segmentation as the JAX workflow, voxel for voxel (the
    same problem, lifted edges and costs, and the same C++ solvers), and
    no segment spans two true cells."""
    workflow, (jx, pt) = runs
    np.testing.assert_array_equal(pt["seg"], jx["seg"])
    if workflow == "lifted":
        np.testing.assert_array_equal(pt["nh"], jx["nh"])
        np.testing.assert_array_equal(pt["lcosts"], jx["lcosts"])
        assert len(pt["nh"]) > 0
    pairs = np.unique(np.stack([pt["true"].ravel(), pt["seg"].ravel()], 1),
                      axis=0)
    assert len(pairs) == len(np.unique(pairs[:, 1]))
    assert len(np.unique(pt["seg"])) < len(np.unique(pt["frags"]))
