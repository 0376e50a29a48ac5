"""The random-forest edge classifier of the port (``workflows/learning.py``:
``EdgeLabels``, ``LearnRF``, ``RFPredict``, ``LearningWorkflow``) and
``EdgeCostsWorkflow(rf_path=...)`` against the JAX package, on the CPU.

sklearn stays on the host in both packages.  Its forests draw from numpy's
global generator, seeded alike before each build, so on the same features
the forests are the same and the probabilities and costs equal the JAX
package's.  ``LearningWorkflow`` builds its features with each package's
own problem workflow (float features within rtol 1e-5), so its forest is
held by the share of edges whose predicted class differs from the JAX
package's forest's (gate 1 %, as the pixel classifier's)."""

import os
import pickle

import numpy as np
import pytest

pytest.importorskip("sklearn")


def _pkg(pkg):
    if pkg == "jax":
        import cluster_tools_tpu as M
        from cluster_tools_tpu.core.config import ConfigDir
        from cluster_tools_tpu.core.graph import save_graph
        from cluster_tools_tpu.workflows import costs, learning
        return M, ConfigDir, save_graph, costs, learning, {}
    import cluster_tools_tpu_torch as M
    from cluster_tools_tpu_torch.core.config import ConfigDir
    from cluster_tools_tpu_torch.core.graph import save_graph
    from cluster_tools_tpu_torch.workflows import costs, learning
    return M, ConfigDir, save_graph, costs, learning, {"device": "cpu"}


def _toy(pkg, root):
    """The JAX package's separable toy problem (a chain graph; feature 0
    separates cut from merge edges) and the shared task arguments."""
    M, ConfigDir, save_graph, costs, learning, extra = _pkg(pkg)
    os.makedirs(root, exist_ok=True)
    problem = os.path.join(root, "p.n5")
    rng = np.random.RandomState(0)
    n_edges = 200
    labels = (rng.rand(n_edges) > 0.5).astype("int8")
    feats = np.zeros((n_edges, 10), "float32")
    feats[:, 0] = labels + 0.1 * rng.randn(n_edges)
    uv = np.stack([np.arange(n_edges), np.arange(1, n_edges + 1)], 1)
    node_labels = np.zeros(n_edges + 1, "uint64")
    for i in range(n_edges):
        node_labels[i + 1] = node_labels[i] + labels[i]
    node_labels += 1
    node_labels[5] = 0  # an ignore-label node: its edges are labelled -1
    save_graph(problem, "s0/graph", np.arange(n_edges + 1, dtype="uint64"),
               uv.astype("uint64"), (1, 1, 1))
    with M.file_reader(problem) as f:
        f.require_dataset("features", data=feats, chunks=(64, 10))
        f.require_dataset("gt_labels", data=node_labels, chunks=(201,))
    cfg = os.path.join(root, "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": [8, 8, 8],
                                        "max_num_retries": 0, **extra})
    ConfigDir(cfg).write_task_config("learn_rf", {"n_trees": 20})
    ConfigDir(cfg).write_task_config("rf_predict", {"chunk_size": 64})
    common = dict(tmp_folder=os.path.join(root, "tmp"), config_dir=cfg,
                  max_jobs=2, target="threads")
    el = learning.EdgeLabels(
        graph_path=problem, graph_key="s0/graph", node_labels_path=problem,
        node_labels_key="gt_labels", output_path=problem,
        output_key="edge_labels", **common)
    rf_path = os.path.join(root, "rf.pkl")
    rf = learning.LearnRF(features_dict={"a": (problem, "features")},
                          labels_dict={"a": (problem, "edge_labels")},
                          output_path=rf_path, dependency=el, **common)
    return M, costs, learning, problem, rf, rf_path, labels, common


def _predict(pkg, root):
    M, _, learning, problem, rf, rf_path, labels, common = _toy(pkg, root)
    pred = learning.RFPredict(
        rf_path=rf_path, features_path=problem, features_key="features",
        output_path=problem, output_key="probs", dependency=rf, **common)
    np.random.seed(0)  # the forests draw from numpy's global generator
    assert M.build([pred], raise_on_failure=True)
    with M.file_reader(problem, "r") as f:
        return f["edge_labels"][:], f["probs"][:], labels


def test_edge_labels_learn_and_predict_match_jax(tmp_path):
    """EdgeLabels -> LearnRF -> RFPredict (edges sharded over 4 jobs):
    the edge labels (the ignore label's edges -1) and the probabilities
    equal the JAX package's, and the forest separates the toy problem."""
    jx = _predict("jax", str(tmp_path / "jax"))
    pt = _predict("torch", str(tmp_path / "torch"))
    for a, b in zip(jx, pt):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    edge_labels, probs, labels = pt
    want = labels.copy()
    want[[4, 5]] = -1
    np.testing.assert_array_equal(edge_labels, want)
    keep = want >= 0
    assert ((probs[keep] > 0.5) == (labels[keep] == 1)).mean() > 0.95
    with open(str(tmp_path / "torch" / "rf.pkl"), "rb") as f:
        assert pickle.load(f).n_estimators == 20


def _rf_costs(pkg, root):
    M, costs, _, problem, rf, rf_path, labels, common = _toy(pkg, root)
    wf = costs.EdgeCostsWorkflow(
        features_path=problem, features_key="features",
        output_path=problem, output_key="s0/costs", graph_path=problem,
        graph_key="s0/graph", rf_path=rf_path, dependency=rf, **common)
    np.random.seed(0)
    assert M.build([wf], raise_on_failure=True)
    with M.file_reader(problem, "r") as f:
        return f["s0/costs"][:], f["rf_probs"][:], labels


def test_edge_costs_rf_path_matches_jax(tmp_path):
    """``EdgeCostsWorkflow(rf_path=...)``: the forest's probabilities
    (``rf_probs``) and the costs made from them equal the JAX package's;
    cut edges are repulsive, merge edges attractive."""
    jx = _rf_costs("jax", str(tmp_path / "jax"))
    pt = _rf_costs("torch", str(tmp_path / "torch"))
    for a, b in zip(jx[:2], pt[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    costs, _, labels = pt
    assert (costs[labels == 1] < 0).mean() > 0.9
    assert (costs[labels == 0] > 0).mean() > 0.9


def _volume():
    """Ground truth of four bodies, fragments splitting each in two, and a
    boundary map bright on the ground truth's faces."""
    shape = (16, 32, 32)
    gt = np.ones(shape, "uint64")
    gt[:, 16:, :] += 1
    gt[:, :, 16:] += 2
    frags = gt * 2 - (np.arange(shape[0]) < 8)[:, None, None]
    frags = frags.astype("uint64")
    rng = np.random.RandomState(0)
    bmap = rng.rand(*shape).astype("float32") * 0.2
    for ax in (1, 2):
        edge = np.diff(gt, axis=ax) != 0
        sl = [slice(None)] * 3
        sl[ax] = slice(0, -1)
        bmap[tuple(sl)][edge] += 0.7
    return gt, frags, bmap


def _learning(pkg, root):
    M, ConfigDir, _, _, _, extra = _pkg(pkg)
    os.makedirs(root, exist_ok=True)
    gt, frags, bmap = _volume()
    data = os.path.join(root, "d.n5")
    with M.file_reader(data) as f:
        f.require_dataset("bmap", data=bmap, chunks=(8, 16, 16))
        ds = f.require_dataset("ws", data=frags, chunks=(8, 16, 16))
        ds.attrs["maxId"] = int(frags.max())
        f.require_dataset("gt", data=gt, chunks=(8, 16, 16))
    cfg = os.path.join(root, "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": [8, 16, 16],
                                        "max_num_retries": 0, **extra})
    ConfigDir(cfg).write_task_config("learn_rf", {"n_trees": 20})
    rf_path = os.path.join(root, "rf.pkl")
    datasets = {"a": {"ws_path": data, "ws_key": "ws", "input_path": data,
                      "input_key": "bmap", "gt_path": data, "gt_key": "gt",
                      "problem_path": os.path.join(root, "problem_a.n5")}}
    wf = M.LearningWorkflow(datasets=datasets, output_path=rf_path,
                            tmp_folder=os.path.join(root, "tmp"),
                            config_dir=cfg, max_jobs=2, target="threads")
    np.random.seed(0)
    assert M.build([wf], raise_on_failure=True)
    with M.file_reader(datasets["a"]["problem_path"], "r") as f:
        out = (f["edge_labels"][:], f["features"][:],
               f["gt_node_labels"][:])
    with open(rf_path, "rb") as f:
        return out + (pickle.load(f),)


def test_learning_workflow_matches_jax(tmp_path):
    """``LearningWorkflow`` (problem -> ground-truth node labels -> edge
    labels -> forest) on four bodies split into eight fragments: the node
    and edge labels equal the JAX package's, the features agree, and the
    two forests predict the same class on every edge (gate 1 %)."""
    jl, jf, jn, jrf = _learning("jax", str(tmp_path / "jax"))
    pl, pf, pn, prf = _learning("torch", str(tmp_path / "torch"))
    np.testing.assert_array_equal(pn, jn)
    assert pl.dtype == jl.dtype
    np.testing.assert_array_equal(pl, jl)
    assert pf.shape == jf.shape and pf.dtype == jf.dtype
    np.testing.assert_allclose(pf, jf, rtol=1e-5, atol=1e-6)
    assert (pl == 1).sum() > 0 and (pl == 0).sum() > 0
    flipped = float((prf.predict(jf) != jrf.predict(jf)).mean())
    assert flipped <= 0.01, flipped
    assert prf.n_estimators == 20
