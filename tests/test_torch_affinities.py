"""Derived pixel maps of the port (``workflows/affinities.py``: affinities
from labels, embedding-distance affinities, ``InsertAffinities``,
``SmoothedGradients``) against the JAX package, on the CPU.

Affinities from labels are a shifted equality: exact.  The embedding
distances sum over the embedding channels in another order (rtol 1e-5);
the gradient magnitude carries the filters' tap order (rtol 1e-4 / atol
1e-5, as ``tests/test_torch_filters.py``)."""

import os

import numpy as np
import pytest

OFFSETS = [[-1, 0, 0], [0, -1, 0], [0, 0, -1], [0, -3, 0], [2, 0, -4],
           [0, 5, 1]]


def _pkg(pkg):
    if pkg == "jax":
        import cluster_tools_tpu as M
        from cluster_tools_tpu.core.config import ConfigDir
        from cluster_tools_tpu.workflows import affinities as A
        return M, ConfigDir, A, {}
    import cluster_tools_tpu_torch as M
    from cluster_tools_tpu_torch.core.config import ConfigDir
    from cluster_tools_tpu_torch.workflows import affinities as A
    return M, ConfigDir, A, {"device": "cpu"}


def _labels(shape=(10, 16, 14), seed=0):
    rng = np.random.RandomState(seed)
    coarse = rng.randint(0, 5, size=(3, 4, 4)).astype("uint64") * 1000
    lab = np.kron(coarse, np.ones((4, 4, 4), "uint64"))
    return np.ascontiguousarray(lab[:shape[0], :shape[1], :shape[2]])


def test_compute_affinities_oracle():
    """The JAX package's oracle on the port."""
    from cluster_tools_tpu_torch.workflows.affinities import \
        compute_affinities

    labels = np.zeros((4, 4, 4), "uint64")
    labels[:, :2, :] = 1
    labels[:, 2:, :] = 2
    affs = compute_affinities(labels, [[0, -1, 0], [0, 0, -1]],
                              device="cpu")
    assert affs.shape == (2, 4, 4, 4) and affs.dtype == np.float32
    assert (affs[1, :, :, 1:] == 1).all()
    assert (affs[0, :, 2, :] == 0).all()
    assert (affs[0, :, 3, :] == 1).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_affinities_match_jax(seed):
    """Exact, with long, positive and negative offsets (the invalid
    border of each channel is 0), background 0 never affine."""
    from cluster_tools_tpu.workflows.affinities import \
        compute_affinities as jaff

    from cluster_tools_tpu_torch.workflows.affinities import \
        compute_affinities

    labels = _labels(seed=seed)
    np.testing.assert_array_equal(
        compute_affinities(labels, OFFSETS, device="cpu"),
        jaff(labels, OFFSETS))


def test_embedding_distance_oracle():
    from cluster_tools_tpu_torch.workflows.affinities import \
        embedding_distance_affinities

    emb = np.zeros((2, 4, 4, 4), "float32")
    emb[0, :, 2:, :] = 10.0
    affs = embedding_distance_affinities(emb, [[0, -1, 0]], device="cpu")
    assert affs[0, 0, 3, 0] > 0.99
    assert affs[0, 0, 2, 0] < 0.01


@pytest.mark.parametrize("norm", ["l2", "cosine"])
def test_embedding_distance_match_jax(norm):
    from cluster_tools_tpu.workflows.affinities import \
        embedding_distance_affinities as jemb

    from cluster_tools_tpu_torch.workflows.affinities import \
        embedding_distance_affinities

    emb = np.random.RandomState(4).randn(6, 8, 10, 9).astype("float32")
    emb[:, 2] = 0.0  # zero vectors: the cosine's clamped denominator
    got = embedding_distance_affinities(emb, OFFSETS[:4], norm,
                                        device="cpu")
    np.testing.assert_allclose(got, jemb(emb, OFFSETS[:4], norm),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unknown norm"):
        embedding_distance_affinities(emb, OFFSETS[:1], "l1", device="cpu")


def _run_task(pkg, root, cls_name, inputs, task_cfg=None, **kw):
    M, ConfigDir, A, extra = _pkg(pkg)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "d.n5")
    with M.file_reader(path) as f:
        for key, data in inputs.items():
            chunks = ([data.shape[0]] if data.ndim == 4 else []) + [8, 8, 8]
            f.require_dataset(key, shape=data.shape, chunks=chunks,
                              dtype=str(data.dtype))[:] = data
    cfg = os.path.join(root, "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": [8, 8, 8],
                                        "max_num_retries": 0, **extra})
    if task_cfg:
        ConfigDir(cfg).write_task_config(getattr(A, cls_name).task_name,
                                         task_cfg)
    task = getattr(A, cls_name)(output_path=path, output_key="out",
                                tmp_folder=os.path.join(root, "tmp"),
                                config_dir=cfg, max_jobs=2, target="threads",
                                **{k: (path if k.endswith("_path") else v)
                                   for k, v in kw.items()})
    assert M.build([task], raise_on_failure=True)
    with M.file_reader(path, "r") as f:
        return f["out"][:]


@pytest.mark.parametrize("sigma", [1.5, 2.0])
def test_smoothed_gradients_match_jax(tmp_path, sigma):
    from scipy import ndimage

    vol = np.random.RandomState(0).rand(16, 16, 16).astype("float32")
    kw = dict(input_path=True, input_key="raw", sigma=sigma)
    jx = _run_task("jax", str(tmp_path / "jax"), "SmoothedGradients",
                   {"raw": vol}, **kw)
    pt = _run_task("torch", str(tmp_path / "torch"), "SmoothedGradients",
                   {"raw": vol}, **kw)
    np.testing.assert_allclose(pt, jx, rtol=1e-4, atol=1e-5)
    ref = ndimage.gaussian_gradient_magnitude(vol, sigma, mode="reflect")
    assert np.abs(pt - ref).max() < 0.05


@pytest.mark.parametrize("dilate_by", [0, 2])
def test_insert_affinities_match_jax(tmp_path, dilate_by):
    """Objects pasted into a predicted affinity map, with and without the
    dilation ring, and a block without objects copied through: exact."""
    shape = (16, 16, 16)
    rng = np.random.RandomState(5)
    affs = rng.rand(3, *shape).astype("float32")
    objs = np.zeros(shape, "uint64")
    objs[2:7, 3:9, 1:6] = 7
    objs[3:6, 10:14, 2:7] = 3
    offsets = OFFSETS[:3]
    kw = dict(input_path=True, input_key="affs", objects_path=True,
              objects_key="objs", offsets=offsets)
    inputs = {"affs": affs, "objs": objs}
    cfg = {"dilate_by": dilate_by}
    jx = _run_task("jax", str(tmp_path / "jax"), "InsertAffinities", inputs,
                   cfg, **kw)
    pt = _run_task("torch", str(tmp_path / "torch"), "InsertAffinities",
                   inputs, cfg, **kw)
    np.testing.assert_array_equal(pt, jx)
    assert (pt >= affs).all() and (pt[:, 10:, :, 10:] == affs[:, 10:, :,
                                                              10:]).all()


@pytest.mark.parametrize("which", ["insert", "gradients"])
def test_affinity_tasks_raise_without_a_card(tmp_path, which):
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
        if which == "insert":
            ctp.InsertAffinities(objects_path="a.n5", objects_key="o",
                                 offsets=[[-1, 0, 0]], **common)
        else:
            ctp.SmoothedGradients(**common)
