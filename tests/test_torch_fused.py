"""The slice end to end: ``MulticutSegmentationWorkflow(fused=True)``
through the port (device "cpu", target "gpu") against the JAX package's run
of the same workflow (target "tpu" on the CPU), in separate tmp folders.

Three cases, each run once per module:

* float32 volume, the fused task's default height map (Gaussian-smoothed
  boundaries): the port's float32 Gaussian (shifted multiply-adds) and
  XLA's CPU convolution sum the taps in different orders, which moves a
  few height values by an ulp and flips a few voxels per block between
  neighboring fragments.  Gate: the repo's standing VOI <= 0.01
  (BASELINE.md "Measurement semantics") on fragments and segmentation,
  and the graph's edge count within 3% (the flipped voxels can add or
  remove small contacts);
* uint8 volume with ``sigma_weights: 0`` (no Gaussian on the height map,
  every other op of the chain bit-compatible): identical fragments,
  segmentation, graph and costs;
* a uint8 noise volume that drives blocks through the host fallback
  (watershed capacity overflow) and the cap-retry redo (pair compaction
  overflow): identical outputs, and both paths counted in the status.
"""

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

SHAPE = (34, 52, 48)
BLOCK = [16, 24, 24]


def _instance(shape, n_cells=10, seed=0):
    from scipy import ndimage

    rng = np.random.RandomState(seed)
    pts = rng.rand(n_cells, 3) * np.array(shape)
    grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    coords = np.stack([g.ravel() for g in grids], 1).astype("float32")
    d = np.linalg.norm(coords[:, None, :] - pts[None], axis=2)
    d.sort(axis=1)
    bnd = np.exp(-(d[:, 1] - d[:, 0]) ** 2 / 4.0).reshape(shape)
    return ndimage.gaussian_filter(bnd, 1.0).astype("float32")


def _run(pkg, root, data, task_cfg, block_shape):
    """Run the fused multicut workflow of ``pkg`` ("jax" or "torch") on
    ``data``; returns fragments, segmentation, graph edges, features,
    costs and the fused task's status."""
    if pkg == "jax":
        import cluster_tools_tpu as M
        from cluster_tools_tpu.core.config import ConfigDir
        from cluster_tools_tpu.core.graph import load_graph
        from cluster_tools_tpu.core.storage import file_reader
        target, extra = "tpu", {}
    else:
        import cluster_tools_tpu_torch as M
        from cluster_tools_tpu_torch.core.config import ConfigDir
        from cluster_tools_tpu_torch.core.graph import load_graph
        from cluster_tools_tpu_torch.core.storage import file_reader
        target, extra = "gpu", {"device": "cpu"}
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "d.n5")
    with file_reader(path) as f:
        ds = f.require_dataset("bmap", shape=data.shape, chunks=block_shape,
                               dtype=data.dtype)
        ds[:] = data
    cfg_dir = os.path.join(root, "cfg")
    ConfigDir(cfg_dir).write_global_config({"block_shape": block_shape,
                                            **extra})
    ConfigDir(cfg_dir).write_task_config("fused_segmentation", task_cfg)
    tmp = os.path.join(root, "tmp")
    wf = M.MulticutSegmentationWorkflow(
        input_path=path, input_key="bmap", ws_path=path, ws_key="ws",
        problem_path=os.path.join(root, "p.n5"), output_path=path,
        output_key="seg", tmp_folder=tmp, config_dir=cfg_dir, max_jobs=1,
        target=target, n_scales=1, fused=True)
    assert M.build([wf], raise_on_failure=True)
    out = {}
    with file_reader(path, "r") as f:
        out["ws"], out["seg"] = f["ws"][:], f["seg"][:]
        out["max_id"] = f["ws"].attrs["maxId"]
    _, out["edges"], _ = load_graph(os.path.join(root, "p.n5"), "s0/graph")
    with file_reader(os.path.join(root, "p.n5"), "r") as f:
        out["features"], out["costs"] = f["features"][:], f["s0/costs"][:]
    with open(os.path.join(tmp, "fused_segmentation.status")) as f:
        out["status"] = json.load(f)
    return out


def _both(tmp_path_factory, name, data, task_cfg, block_shape=BLOCK):
    root = tmp_path_factory.mktemp(name)
    return (_run("jax", str(root / "jax"), data, task_cfg, block_shape),
            _run("torch", str(root / "torch"), data, task_cfg, block_shape))


def _voi(a, b):
    from cluster_tools_tpu_torch.utils.validation import \
        variation_of_information

    return sum(variation_of_information(a, b))


@pytest.fixture(scope="module")
def float_default(tmp_path_factory):
    return _both(tmp_path_factory, "float_default", _instance(SHAPE),
                 {"threshold": 0.4, "size_filter": 25})


@pytest.fixture(scope="module")
def uint8_exact(tmp_path_factory):
    data = np.round(_instance(SHAPE) * 255).astype("uint8")
    return _both(tmp_path_factory, "uint8_exact", data,
                 {"threshold": 0.4, "size_filter": 25, "sigma_weights": 0})


@pytest.fixture(scope="module")
def fallback(tmp_path_factory):
    data = np.random.RandomState(0).randint(0, 256, (16, 24, 48)).astype(
        "uint8")
    # few seeds (low threshold) leave most basins unlabeled, so the coarse
    # solve's candidate table overflows (host fallback); pair_cap 1 clamps
    # the pair capacity to its floor, which noise overflows (cap-retry)
    return _both(tmp_path_factory, "fallback", data,
                 {"threshold": 0.05, "size_filter": 2, "sigma_weights": 0,
                  "sigma_seeds": 0, "e_max": 65536, "pair_cap": 1})


def test_float_default_fragments_voi(float_default):
    jx, pt = float_default
    assert _voi(pt["ws"], jx["ws"]) <= 0.01
    # globally consecutive ids without a relabel pass
    u = np.unique(pt["ws"])
    assert u[0] >= 1 and u[-1] == len(u) == pt["max_id"]


def test_float_default_segmentation_voi(float_default):
    jx, pt = float_default
    assert _voi(pt["seg"], jx["seg"]) <= 0.01


def test_float_default_graph_size(float_default):
    jx, pt = float_default
    assert abs(len(pt["edges"]) - len(jx["edges"])) <= 0.03 * len(jx["edges"])


def test_uint8_exact_fragments_and_segmentation(uint8_exact):
    jx, pt = uint8_exact
    np.testing.assert_array_equal(pt["ws"], jx["ws"])
    np.testing.assert_array_equal(pt["seg"], jx["seg"])
    assert pt["max_id"] == jx["max_id"]


def test_uint8_exact_graph_and_costs(uint8_exact):
    """Same edge set; features equal up to the histogram mean/variance
    (rtol 1e-6: the float32 ``hist @ levels`` dot sums in another order;
    every other column is exact), costs to the same rtol."""
    jx, pt = uint8_exact
    np.testing.assert_array_equal(pt["edges"], jx["edges"])
    np.testing.assert_array_equal(pt["features"][:, 2:],
                                  jx["features"][:, 2:])
    np.testing.assert_allclose(pt["features"][:, :2], jx["features"][:, :2],
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(pt["costs"], jx["costs"], rtol=1e-5,
                               atol=1e-6)


def test_fallback_and_cap_retry_paths(fallback):
    jx, pt = fallback
    for out in (jx, pt):
        counts = out["status"]["stage_counts"]
        assert counts.get("host-fallback", 0) > 0
        assert counts.get("cap-retry", 0) > 0
    assert (pt["status"]["stage_counts"]["host-fallback"]
            == jx["status"]["stage_counts"]["host-fallback"])
    np.testing.assert_array_equal(pt["ws"], jx["ws"])
    np.testing.assert_array_equal(pt["seg"], jx["seg"])
    np.testing.assert_array_equal(pt["edges"], jx["edges"])
