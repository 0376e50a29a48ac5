"""Filter-bank edge features of the port (``BlockEdgeFeatures`` with
``filters``/``sigmas``) against the JAX package, on the CPU.

Each (filter, sigma) response contributes 9 statistics columns and the
count column comes once at the end, 9 * n_responses + 1 columns.  The
responses carry the filters' tap-order differences, so the features are
held at rtol 1e-4 / atol 1e-5 (the JAX package's own tolerance,
``tests/test_graph_stack.py``); the counts are exact.  The split chain
with filter-bank features runs once per module in both packages
(``tests/test_torch_split._run``)."""

import os

import numpy as np
import pytest

from tests.test_graph_stack import _toy_labels
from tests.test_torch_split import _instance, _run, _uint8

RESPONSES = {"filters": ["gaussianSmoothing", "gaussianGradientMagnitude",
                         "laplacianOfGaussian"], "sigmas": [0.7, 1.6]}


def _write(file_reader, path, key, data, chunks):
    with file_reader(path) as f:
        f.require_dataset(key, shape=data.shape, chunks=chunks,
                          dtype=str(data.dtype))[:] = data


def _features(pkg, root, labels, bmap, task_cfg, input_key="bmap",
              extra_inputs=()):
    """Graph + edge features of ``pkg`` over ``labels`` with the
    ``block_edge_features`` task config ``task_cfg``; returns the merged
    feature table."""
    if pkg == "jax":
        import cluster_tools_tpu as M
        from cluster_tools_tpu.core.config import ConfigDir
        from cluster_tools_tpu.core.storage import file_reader
        from cluster_tools_tpu.workflows.features import \
            EdgeFeaturesWorkflow
        extra, target = {}, "threads"
    else:
        import cluster_tools_tpu_torch as M
        from cluster_tools_tpu_torch.core.config import ConfigDir
        from cluster_tools_tpu_torch.core.storage import file_reader
        from cluster_tools_tpu_torch.workflows.features import \
            EdgeFeaturesWorkflow
        extra, target = {"device": "cpu"}, "threads"
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "d.n5")
    _write(file_reader, path, "labels", labels, (10, 10, 10))
    _write(file_reader, path, "bmap", bmap, (10, 10, 10))
    for key, data in extra_inputs:
        _write(file_reader, path, key, data, (10, 10, 10))
    cfg = os.path.join(root, "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": [10, 10, 10],
                                        **extra})
    ConfigDir(cfg).write_task_config("block_edge_features", task_cfg)
    tmp = os.path.join(root, "tmp")
    common = dict(tmp_folder=tmp, config_dir=cfg, max_jobs=2, target=target)
    graph = M.GraphWorkflow(input_path=path, input_key="labels",
                            graph_path=os.path.join(root, "g.n5"), **common)
    fw = EdgeFeaturesWorkflow(
        input_path=path, input_key=input_key, labels_path=path,
        labels_key="labels", graph_path=os.path.join(root, "g.n5"),
        output_path=os.path.join(root, "f.n5"), dependency=graph, **common)
    assert M.build([fw], raise_on_failure=True)
    with file_reader(os.path.join(root, "f.n5"), "r") as f:
        return f["features"][:]


@pytest.fixture(scope="module")
def toy():
    labels = _toy_labels()
    bmap = np.random.RandomState(2).rand(*labels.shape).astype("float32")
    return labels, bmap


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_filter_bank_features_match_jax(toy, tmp_path, dtype):
    labels, bmap = toy
    if dtype == "uint8":
        bmap = np.round(bmap * 255).astype("uint8")
    jx = _features("jax", str(tmp_path / "jax"), labels, bmap, RESPONSES)
    pt = _features("torch", str(tmp_path / "torch"), labels, bmap,
                   RESPONSES)
    n_resp = len(RESPONSES["filters"]) * len(RESPONSES["sigmas"])
    assert pt.shape == jx.shape == (jx.shape[0], 9 * n_resp + 1)
    np.testing.assert_array_equal(pt[:, -1], jx[:, -1])
    np.testing.assert_allclose(pt, jx, rtol=1e-4, atol=1e-5)


def test_filter_bank_group_is_the_plain_features_of_the_response(toy,
                                                                 tmp_path):
    """The JAX package's oracle on the port: group k of the filtered run
    equals the plain run on the precomputed response k (the support halo
    covers the kernel, so blockwise filtering is exact up to the volume
    border)."""
    import torch

    from cluster_tools_tpu_torch.ops.filters import apply_filter

    labels, bmap = toy
    responses = [("gaussianSmoothing", 1.0), ("laplacianOfGaussian", 1.0)]
    resp = [(f"resp_{fn}", apply_filter(torch.from_numpy(bmap), fn, s
                                        ).numpy()) for fn, s in responses]
    filtered = _features(
        "torch", str(tmp_path / "f"), labels, bmap,
        {"filters": [fn for fn, _ in responses], "sigmas": [1.0]})
    assert filtered.shape[1] == 9 * len(responses) + 1
    for k, (key, data) in enumerate(resp):
        plain = _features("torch", str(tmp_path / key), labels, bmap, {},
                          input_key=key, extra_inputs=[(key, data)])
        np.testing.assert_allclose(filtered[:, 9 * k:9 * k + 9],
                                   plain[:, :9], rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(filtered[:, -1], plain[:, 9])


@pytest.mark.parametrize("task_cfg,match", [
    ({"filters": ["gaussianSmoothing"], "sigmas": [1.0], "impl": "host"},
     "impl='host'"),
    ({"filters": ["gaussianSmoothing"], "sigmas": [1.0]}, "boundary maps"),
])
def test_filter_bank_rejects_host_impl_and_affinities(tmp_path, task_cfg,
                                                      match):
    """As in the JAX package: filter-bank features are boundary-map
    features of the device path."""
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir
    from cluster_tools_tpu_torch.core.workflow import BuildError
    from cluster_tools_tpu_torch.workflows.features import BlockEdgeFeatures

    labels = _toy_labels((10, 10, 10), n_seeds=4)
    path = str(tmp_path / "d.n5")
    _write(ctp.file_reader, path, "labels", labels, (10, 10, 10))
    affs = np.random.RandomState(0).rand(3, 10, 10, 10).astype("float32")
    _write(ctp.file_reader, path, "affs", affs, (3, 10, 10, 10))
    cfg = str(tmp_path / "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": [10, 10, 10],
                                        "device": "cpu",
                                        "max_num_retries": 0})
    ConfigDir(cfg).write_task_config("block_edge_features", task_cfg)
    common = dict(tmp_folder=str(tmp_path / "tmp"), config_dir=cfg,
                  target="inline")
    graph = ctp.GraphWorkflow(input_path=path, input_key="labels",
                              graph_path=str(tmp_path / "g.n5"), **common)
    offsets = None if "impl" in task_cfg else [[-1, 0, 0], [0, -1, 0],
                                               [0, 0, -1]]
    task = BlockEdgeFeatures(
        input_path=path, input_key="affs" if offsets else "labels",
        labels_path=path, labels_key="labels",
        graph_path=str(tmp_path / "g.n5"), output_path=str(tmp_path / "f"),
        offsets=offsets, dependency=graph, **common)
    with pytest.raises(BuildError, match="jobs \\[0\\] failed"):
        ctp.build([task], raise_on_failure=True)
    logs = str(tmp_path / "tmp" / "logs")
    text = "".join(open(os.path.join(logs, n)).read()
                   for n in os.listdir(logs))
    assert match in text and "ValueError" in text


@pytest.fixture(scope="module")
def split_filter_bank(tmp_path_factory):
    """The split chain with filter-bank edge features, both packages, on
    the uint8 instance with ``sigma_weights: 0`` (identical fragments)."""
    data = _uint8(_instance((24, 48, 44), seed=3))
    root = tmp_path_factory.mktemp("split_filter_bank")
    kw = dict(task_cfgs={"block_edge_features": RESPONSES})
    return (_run("jax", str(root / "jax"), data, {"sigma_weights": 0}, **kw),
            _run("torch", str(root / "torch"), data, {"sigma_weights": 0},
                 **kw))


def test_split_chain_filter_bank_fragments_and_graph(split_filter_bank):
    jx, pt = split_filter_bank
    np.testing.assert_array_equal(pt["ws"], jx["ws"])
    np.testing.assert_array_equal(pt["edges"], jx["edges"])


def test_split_chain_filter_bank_features_and_segmentation(
        split_filter_bank):
    """55 feature columns for 6 responses, within the tolerance; the
    costs read the first response's mean and the shared count, and the
    segmentation equals the JAX package's."""
    jx, pt = split_filter_bank
    assert pt["features"].shape[1] == 9 * 6 + 1
    np.testing.assert_allclose(pt["features"], jx["features"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(pt["costs"], jx["costs"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(pt["seg"], jx["seg"])
