"""Pixel features and classification of the port
(``workflows/pixel_classification.py``: ``compute_feature_stack``,
``ImageFilterTask``, ``PixelClassificationWorkflow``, ``WriteCarving``)
against the JAX package, on the CPU.

The feature stacks carry the filters' tap order: rtol 1e-4 / atol 1e-5.
Both random forests draw from numpy's global generator, seeded alike
before each build, so the forests see the same draws; a prediction can
still flip where a feature lands on a split threshold, so the classifier
is gated by the share of voxels whose argmax differs from the JAX
package's (0 on these inputs, gate 1 %).  The classifier needs sklearn
on the host, as in the JAX package; the carving export writes HDF5 with
the port's own writer (no h5py)."""

import os

import numpy as np
import pytest

FEATURES = [["gaussianSmoothing", 0.7], ["gaussianSmoothing", 1.6],
            ["gaussianGradientMagnitude", 1.6],
            ["laplacianOfGaussian", 1.6]]


def _pkg(pkg):
    if pkg == "jax":
        import cluster_tools_tpu as M
        from cluster_tools_tpu.core.config import ConfigDir
        from cluster_tools_tpu.workflows import pixel_classification as P
        return M, ConfigDir, P, {}
    import cluster_tools_tpu_torch as M
    from cluster_tools_tpu_torch.core.config import ConfigDir
    from cluster_tools_tpu_torch.workflows import pixel_classification as P
    return M, ConfigDir, P, {"device": "cpu"}


def _setup(pkg, root, inputs):
    M, ConfigDir, P, extra = _pkg(pkg)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "d.n5")
    with M.file_reader(path) as f:
        for key, data in inputs.items():
            f.require_dataset(key, shape=data.shape, chunks=[8, 16, 16],
                              dtype=str(data.dtype))[:] = data
    cfg = os.path.join(root, "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": [8, 16, 16],
                                        "max_num_retries": 0, **extra})
    return M, P, path, dict(tmp_folder=os.path.join(root, "tmp"),
                            config_dir=cfg, max_jobs=2, target="threads")


def test_default_features_and_halo_match_jax():
    from cluster_tools_tpu.workflows import pixel_classification as J

    from cluster_tools_tpu_torch.workflows import pixel_classification as P

    assert P.DEFAULT_FEATURES == J.DEFAULT_FEATURES
    for feats in (P.DEFAULT_FEATURES, FEATURES):
        assert P._filter_halo(feats) == J._filter_halo(feats)
    assert P._filter_halo(P.DEFAULT_FEATURES) == 15


@pytest.mark.parametrize("features", ["default", "mixed"])
def test_compute_feature_stack_matches_jax(features):
    from cluster_tools_tpu.workflows.pixel_classification import \
        compute_feature_stack as jstack

    from cluster_tools_tpu_torch.workflows.pixel_classification import (
        DEFAULT_FEATURES, compute_feature_stack)

    feats = DEFAULT_FEATURES if features == "default" else FEATURES
    x = (np.random.RandomState(0).rand(10, 20, 18) * 255).astype("uint8")
    got = compute_feature_stack(x, feats, device="cpu")
    assert got.shape == (len(feats),) + x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, jstack(x, feats), rtol=1e-4, atol=1e-3)
    xf = x.astype("float32") / 255
    np.testing.assert_allclose(compute_feature_stack(xf, feats,
                                                     device="cpu"),
                               jstack(xf, feats), rtol=1e-4, atol=1e-5)


def test_image_filter_task_matches_jax(tmp_path):
    """Blockwise features with the filters' halo equal the JAX package's
    and scipy's whole-volume filters (the JAX package's oracle)."""
    from scipy import ndimage

    vol = np.random.RandomState(0).rand(16, 32, 32).astype("float32")
    out = {}
    for pkg in ("jax", "torch"):
        M, P, path, common = _setup(pkg, str(tmp_path / pkg), {"raw": vol})
        task = P.ImageFilterTask(input_path=path, input_key="raw",
                                 output_path=path, output_key="feats",
                                 features=FEATURES, **common)
        assert M.build([task], raise_on_failure=True)
        with M.file_reader(path, "r") as f:
            out[pkg] = f["feats"][:]
    feats = out["torch"]
    assert feats.shape == (len(FEATURES), 16, 32, 32)
    np.testing.assert_allclose(feats, out["jax"], rtol=1e-4, atol=1e-5)
    ref = ndimage.gaussian_filter(vol, 1.6, mode="reflect")
    assert np.abs(feats[1] - ref).max() < 0.02
    ref = ndimage.gaussian_gradient_magnitude(vol, 1.6, mode="reflect")
    assert np.abs(feats[2] - ref).max() < 0.02


def _classify(pkg, root, vol, scribbles, n_classes, dtype):
    M, P, path, common = _setup(pkg, root, {"raw": vol,
                                            "scribbles": scribbles})
    cfg_dir = common["config_dir"]
    _pkg(pkg)[1](cfg_dir).write_task_config(
        "train_pixel_classifier", {"n_trees": 20})
    _pkg(pkg)[1](cfg_dir).write_task_config(
        "predict_pixel_classifier", {"dtype": dtype})
    wf = P.PixelClassificationWorkflow(
        input_path=path, input_key="raw", labels_path=path,
        labels_key="scribbles", output_path=path, output_key="pred",
        n_classes=n_classes, features=FEATURES, **common)
    np.random.seed(0)  # the forests draw from numpy's global generator
    assert M.build([wf], raise_on_failure=True)
    with M.file_reader(path, "r") as f:
        return f["pred"][:]


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_pixel_classification_matches_jax(tmp_path, dtype):
    """The JAX package's separable two-class problem (bright class 2, dark
    class 1), both packages: the argmax differs on no voxel (gate 1 %),
    the probabilities agree and separate the halves."""
    shape = (16, 32, 32)
    rng = np.random.RandomState(0)
    vol = rng.rand(*shape).astype("float32") * 0.2
    vol[:, 16:, :] += 0.8
    scribbles = np.zeros(shape, "uint8")
    scribbles[4:8, 2:6, 8:24] = 1
    scribbles[4:8, 26:30, 8:24] = 2
    jx = _classify("jax", str(tmp_path / "jax"), vol, scribbles, 2, dtype)
    pt = _classify("torch", str(tmp_path / "torch"), vol, scribbles, 2,
                   dtype)
    assert pt.shape == (2,) + shape and pt.dtype == np.dtype(dtype)
    flipped = float((pt.argmax(0) != jx.argmax(0)).mean())
    assert flipped <= 0.01, flipped
    scale = 255.0 if dtype == "uint8" else 1.0
    p = pt.astype("float32") / scale
    assert p[1, :, 24:, :].mean() > 0.7
    assert p[0, :, :8, :].mean() > 0.7


def test_predict_rejects_classes_beyond_n_classes(tmp_path):
    from cluster_tools_tpu_torch.core.workflow import BuildError

    vol = np.random.RandomState(1).rand(8, 16, 16).astype("float32")
    scribbles = np.zeros(vol.shape, "uint8")
    scribbles[2:4, 2:6, 2:6] = 1
    scribbles[4:6, 8:12, 8:12] = 3
    with pytest.raises(BuildError):
        _classify("torch", str(tmp_path), vol, scribbles, 2, "float32")
    logs = str(tmp_path / "tmp" / "logs")
    assert any("n_classes=2" in open(os.path.join(logs, n)).read()
               for n in os.listdir(logs))


def _carving(pkg, root):
    M, P, path, common = _setup(pkg, root, {})
    if pkg == "jax":
        from cluster_tools_tpu.core.graph import save_graph
    else:
        from cluster_tools_tpu_torch.core.graph import save_graph
    graph_path = os.path.join(root, "graph.n5")
    edges = np.array([[0, 1], [1, 2], [0, 2], [2, 3], [3, 5]], "uint64")
    save_graph(graph_path, "graph", np.array([0, 1, 2, 3, 5], "uint64"),
               edges, {"n_nodes": 5, "n_edges": 5})
    feat_path = os.path.join(root, "feats.n5")
    feats = np.zeros((5, 10), "float64")
    feats[:, 0] = [0.1, 0.5, 0.9, 1.0, 0.3]
    with M.file_reader(feat_path) as f:
        f.require_dataset("features", data=feats, chunks=[5, 10])
    out = os.path.join(root, "carving.ilp")
    task = P.WriteCarving(graph_path=graph_path, graph_key="graph",
                          features_path=feat_path, features_key="features",
                          output_path=out, raw_path=path, raw_key="raw",
                          uid="test-uid", tmp_folder=common["tmp_folder"])
    assert M.build([task], raise_on_failure=True)
    return out


def _h5_contents(path, reader):
    """Every dataset (value, dtype, shape, string type) and every
    attribute of an HDF5 file, by path, through h5py or the port's
    reader."""
    out = {}

    def visit(name, obj):
        for k in obj.attrs.keys():
            v = obj.attrs[k]
            out[f"{name}@{k}"] = (v, np.asarray(v).dtype)
        if hasattr(obj, "keys"):
            out[name + "/"] = ("group",)
            for k in obj.keys():
                visit(f"{name}/{k}".lstrip("/"), obj[k])
        else:
            string = None
            if reader == "h5py":
                import h5py
                info = h5py.check_string_dtype(obj.dtype)
                string = info and (info.encoding, info.length)
            out[name] = (obj[()], obj.dtype, obj.shape, string)

    if reader == "h5py":
        import h5py
        with h5py.File(path, "r") as f:
            visit("", f)
    else:
        from cluster_tools_tpu_torch.core import hdf5
        with hdf5.File(path, "r") as f:
            visit("", f)
    return out


def _same_entry(a, b, key):
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, key
            assert x.tolist() == y.tolist(), key
        else:
            assert x == y and type(x) is type(y), (key, x, y)


def test_write_carving_matches_jax(tmp_path, monkeypatch):
    """The carving project of a graph with a missing node id (4): every
    dataset and attribute but the write time equals the JAX package's, in
    value, dtype, shape and string type, read through h5py and through
    the port's reader.  The port's export runs with h5py unimportable."""
    import sys

    jx = _carving("jax", str(tmp_path / "jax"))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)
        pt = _carving("torch", str(tmp_path / "torch"))
    want = _h5_contents(jx, "h5py")
    got = _h5_contents(pt, "h5py")
    port_read = _h5_contents(pt, "port")
    assert sorted(got) == sorted(want) and sorted(port_read) == sorted(want)
    assert len(want) == 35  # 24 datasets, 1 attribute, 10 groups
    for key in want:
        if key == "time":
            continue
        if key.endswith("filePath"):  # the raw data's path, in each root
            for entry in (got[key], port_read[key]):
                assert entry[0] == want[key][0].replace(b"/jax/", b"/torch/")
                assert entry[1] == want[key][1]
            continue
        _same_entry(got[key], want[key], key)
        _same_entry(port_read[key][:3], want[key][:3], key)
    ser = got["preprocessing/graph/graph"][0]
    assert list(ser[:4]) == [5, 5, 5, 4]
    assert got["preprocessing/graph@numNodes"][0] == 6
    assert got["workflowName"][0] == b"Carving"
    assert "carving/objects/" in got and "Input Data/local_data/" in got
    assert got["Input Data/infos/lane0000/Raw Data/datasetId"][0] == \
        b"test-uid"
    assert got["preprocessing/StorageVersion"][3] == ("utf-8", None)
    np.testing.assert_allclose(got["preprocessing/graph/edgeWeights"][0],
                               np.array([0.1, 0.5, 0.9, 1.0, 0.3]) * 255.0)


def test_serialize_graph_matches_jax():
    from cluster_tools_tpu.workflows.pixel_classification import \
        WriteCarving as J

    from cluster_tools_tpu_torch.workflows.pixel_classification import \
        WriteCarving as P

    uv = np.array([[0, 3], [1, 3], [2, 7]], "uint32")
    np.testing.assert_array_equal(P.serialize_graph(uv, 7),
                                  J.serialize_graph(uv, 7))
    empty = np.zeros((0, 2), "uint32")
    np.testing.assert_array_equal(P.serialize_graph(empty, 0),
                                  J.serialize_graph(empty, 0))


@pytest.mark.parametrize("which", ["image_filter", "classification"])
def test_feature_tasks_raise_without_a_card(tmp_path, which):
    import torch

    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir

    if torch.cuda.is_available():
        pytest.skip("this check needs a host without a CUDA device")
    cfg = str(tmp_path / "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": [8, 8, 8]})
    common = dict(tmp_folder=str(tmp_path / "tmp"), config_dir=cfg,
                  input_path="a.n5", input_key="x", output_path="a.n5",
                  output_key="y")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if which == "image_filter":
            ctp.ImageFilterTask(**common)
        else:
            wf = ctp.PixelClassificationWorkflow(
                labels_path="a.n5", labels_key="s", n_classes=2, **common)
            assert wf.target == "gpu"
            ctp.build([wf])
