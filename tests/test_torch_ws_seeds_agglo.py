"""Seeded watershed from a given seed volume, block-local agglomeration
and the native bindings behind them, in the port against the JAX package
on the CPU.

``seeded_watershed_u8``, ``size_filter_u8`` and ``agglomerative_clustering``
are the same C++ (``native/src/solvers.cpp``) behind new ctypes bindings,
so their outputs are identical; ``WatershedFromSeedsTask`` and
``WatershedWorkflow(agglomeration=True)`` (``AgglomerateTask``: boundary
pairs on the device, the C++ agglomeration on the host) give the JAX
workflows' labels exactly, each run once per module.  So does
``WatershedWorkflow`` with the options of ``tests/test_torch_ws_options.py``
(the task's streamed and per-block branches).

The workflow cases take uint8 input with ``sigma_weights: 0``, the exact
family of the split-chain tests: the flood's 256 levels turn the
Gaussian's last-ulp tap-order differences (ROADMAP §C) into a few moved
voxels per block.  They run eight ``[16, 24, 24]`` blocks with a
``[2, 8, 8]`` halo: the flood runs hundreds of stencil bodies per block
on the CPU."""

import os

import numpy as np
import pytest
import torch

from tests.test_torch_split import BLOCK, _instance, _mask, _modules, _uint8

torch.set_num_threads(2)


def _heights(seed, shape=(12, 20, 18)):
    from scipy import ndimage

    rng = np.random.RandomState(seed)
    h = ndimage.gaussian_filter(rng.rand(*shape), 1.2)
    h = ((h - h.min()) / (h.max() - h.min()) * 255).astype("uint8")
    seeds = np.zeros(shape, "int64")
    seeds.flat[rng.choice(h.size, 12, replace=False)] = rng.randint(
        1, 9, 12)
    return h, seeds


@pytest.mark.parametrize("barrier", [False, True], ids=["free", "barrier"])
@pytest.mark.parametrize("seed", range(3))
def test_seeded_watershed_u8_matches_jax(seed, barrier):
    from cluster_tools_tpu import native as jn

    from cluster_tools_tpu_torch import native as pn

    h, seeds = _heights(seed)
    if barrier:  # negative seeds are barriers the flood never enters
        seeds[:, :, 8] = -1
    got = pn.seeded_watershed_u8(h, seeds)
    np.testing.assert_array_equal(got, jn.seeded_watershed_u8(h, seeds))
    assert (got != 0).all()
    np.testing.assert_array_equal(seeds, _heights(seed)[1] if not barrier
                                  else seeds)  # the input is not modified


@pytest.mark.parametrize("min_size", [5, 40, 400])
def test_size_filter_u8_matches_jax(min_size):
    from cluster_tools_tpu import native as jn

    from cluster_tools_tpu_torch import native as pn

    h, seeds = _heights(min_size)
    ws = pn.seeded_watershed_u8(h, seeds)
    ws[0, :3, :3] = 0  # background stays background
    np.testing.assert_array_equal(pn.size_filter_u8(h, ws, min_size),
                                  jn.size_filter_u8(h, ws, min_size))


def test_native_watershed_shape_checks():
    from cluster_tools_tpu_torch import native

    h, seeds = _heights(0)
    with pytest.raises(ValueError, match="3d"):
        native.seeded_watershed_u8(h[0], seeds[0])
    with pytest.raises(ValueError, match="same shape"):
        native.size_filter_u8(h, seeds[:, :, :-1], 5)


@pytest.mark.parametrize("reg", [0.0, 0.5])
@pytest.mark.parametrize("seed", range(3))
def test_agglomerative_clustering_matches_jax(seed, reg):
    from cluster_tools_tpu import native as jn

    from cluster_tools_tpu_torch import native as pn

    rng = np.random.RandomState(seed)
    n = 30
    uv = np.unique(np.sort(rng.randint(0, n, (80, 2)), axis=1), axis=0)
    uv = uv[uv[:, 0] != uv[:, 1]]
    w = rng.rand(len(uv))
    es = rng.randint(1, 20, len(uv)).astype("float64")
    ns = rng.randint(1, 50, n).astype("float64")
    for kw in ({}, {"edge_sizes": es, "node_sizes": ns}):
        got = pn.agglomerative_clustering(n, uv, w, threshold=0.6,
                                          size_regularizer=reg, **kw)
        want = jn.agglomerative_clustering(n, uv, w, threshold=0.6,
                                           size_regularizer=reg, **kw)
        np.testing.assert_array_equal(got, want)
        assert 1 < len(np.unique(got)) < n
    with pytest.raises(ValueError, match="one weight"):
        pn.agglomerative_clustering(n, uv, w[:-1])


def _seeds_volume(shape, seed=0):
    """A sparse seed volume: a few voxels of each of ten cells, with
    arbitrary (large) uint64 ids."""
    rng = np.random.RandomState(seed)
    seeds = np.zeros(shape, "uint64")
    pts = (rng.rand(10, 3) * np.array(shape)).astype(int)
    for i, (z, y, x) in enumerate(pts):
        seeds[z, max(y - 1, 0):y + 1, max(x - 1, 0):x + 1] = \
            np.uint64(2 ** 40 + 7 * i + 1)
    return seeds


def _run(pkg, root, data, what, masked=False):
    M, ConfigDir, _, file_reader, WatershedWorkflow, target, extra = \
        _modules(pkg)
    if pkg == "jax":
        from cluster_tools_tpu.workflows.watershed import \
            WatershedFromSeedsTask
    else:
        WatershedFromSeedsTask = M.WatershedFromSeedsTask
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "d.n5")
    with file_reader(path) as f:
        f.require_dataset("bmap", shape=data.shape, chunks=BLOCK,
                          dtype=data.dtype)[:] = data
        f.require_dataset("seeds", shape=data.shape, chunks=BLOCK,
                          dtype="uint64")[:] = _seeds_volume(data.shape)
        f.require_dataset("mask", shape=data.shape, chunks=BLOCK,
                          dtype="uint8")[:] = _mask(data.shape)
    cfg_dir = os.path.join(root, "cfg")
    ConfigDir(cfg_dir).write_global_config({"block_shape": BLOCK, **extra})
    ConfigDir(cfg_dir).write_task_config(
        "watershed", {"threshold": 0.4, "size_filter": 25,
                      "sigma_weights": 0, "halo": [2, 8, 8]})
    ConfigDir(cfg_dir).write_task_config("agglomerate", {"threshold": 0.3})
    common = dict(tmp_folder=os.path.join(root, "tmp"), config_dir=cfg_dir,
                  max_jobs=2, target=target)
    if what == "seeds":
        task = WatershedFromSeedsTask(
            input_path=path, input_key="bmap", seeds_path=path,
            seeds_key="seeds", output_path=path, output_key="out",
            mask_path=path if masked else "",
            mask_key="mask" if masked else "", **common)
    else:
        task = WatershedWorkflow(input_path=path, input_key="bmap",
                                 output_path=path, output_key="out",
                                 agglomeration=True, **common)
    assert M.build([task], raise_on_failure=True)
    with file_reader(path, "r") as f:
        return f["out"][:]


@pytest.fixture(scope="module", params=["seeds", "seeds_masked", "agglo"])
def runs(request, tmp_path_factory):
    data = _uint8(_instance((24, 40, 40)))
    root = tmp_path_factory.mktemp(request.param)
    return request.param, [
        _run(pkg, str(root / pkg), data, request.param.split("_")[0],
             masked=request.param.endswith("masked"))
        for pkg in ("jax", "torch")]


def test_workflows_match_jax(runs):
    what, (jx, pt) = runs
    np.testing.assert_array_equal(pt, jx)
    ids = np.unique(pt)
    if what.startswith("seeds"):
        # the given seed ids, grown: no new id appears
        assert set(ids) - {0} <= set(np.unique(_seeds_volume(pt.shape)))
        assert len(ids) > 5
    else:
        assert len(ids) > 3


def _ws_workflow(pkg, root, data, cfg, two_pass=False):
    from tests.test_torch_split import WS_TASKS

    M, ConfigDir, _, file_reader, WatershedWorkflow, target, extra = \
        _modules(pkg)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "d.n5")
    with file_reader(path) as f:
        f.require_dataset("bmap", shape=data.shape, chunks=BLOCK,
                          dtype=data.dtype)[:] = data
    cfg_dir = os.path.join(root, "cfg")
    ConfigDir(cfg_dir).write_global_config({"block_shape": BLOCK, **extra})
    for name in WS_TASKS:
        ConfigDir(cfg_dir).write_task_config(name, cfg)
    wf = WatershedWorkflow(input_path=path, input_key="bmap",
                           output_path=path, output_key="ws",
                           two_pass=two_pass,
                           tmp_folder=os.path.join(root, "tmp"),
                           config_dir=cfg_dir, max_jobs=2, target=target)
    assert M.build([wf], raise_on_failure=True)
    with file_reader(path, "r") as f:
        return f["ws"][:]


_WF_CFGS = {
    "ws_2d": ({"apply_ws_2d": True}, False),
    "nms": ({"non_maximum_suppression": True}, False),
    "flood": ({"ws_algorithm": "flood"}, False),
    "flood_two_pass": ({"ws_algorithm": "flood"}, True),
    "host": ({"impl": "host"}, False),
}


@pytest.fixture(scope="module", params=sorted(_WF_CFGS))
def ws_runs(request, tmp_path_factory):
    cfg, two_pass = _WF_CFGS[request.param]
    cfg = {"threshold": 0.4, "size_filter": 25, "sigma_weights": 0,
           "halo": [2, 8, 8], **cfg}
    data = _uint8(_instance((24, 40, 40)))
    root = tmp_path_factory.mktemp(request.param)
    return [_ws_workflow(pkg, str(root / pkg), data, cfg, two_pass)
            for pkg in ("jax", "torch")]


def test_watershed_workflow_options_match_jax(ws_runs):
    """``WatershedWorkflow`` (the task's streamed and per-block branches,
    the relabel) gives the JAX workflow's fragment ids."""
    jx, pt = ws_runs
    np.testing.assert_array_equal(pt, jx)
    assert len(np.unique(pt)) > 10
