"""The port's ``mesh`` execution target on the CPU: blocks spread over the
shard devices (``"mesh_devices"`` places 4 or 8 shards on the CPU),
against the port's inline runs and the JAX package's runs on its 8
virtual CPU devices.

* the fused chain and the watershed under ``mesh``: bitwise equal to
  the port's ``target="gpu"`` runs, and equal to the JAX package's runs
  of the same chains (uint8 input, ``sigma_weights`` 0: the port's exact
  configuration);
* ``ThresholdedComponentsWorkflow(target="mesh")``: bit-identical to the
  JAX package's ``target="mesh"`` run, with faces covered on the devices;
* ``predict_sharded``: within 2e-5 of the JAX function in float32 (both
  packages' U-Nets built in float32 for the comparison);
* the mutex watershed under ``target="mesh"``: the port's inline run."""

import json
import os

import numpy as np
import pytest
import torch

import cluster_tools_tpu_torch as ctp
from cluster_tools_tpu_torch.core.config import ConfigDir
from cluster_tools_tpu_torch.core.storage import file_reader

torch.set_num_threads(2)


def _bmap(shape, seed):
    from scipy import ndimage
    from scipy.spatial import cKDTree

    rng = np.random.RandomState(seed)
    pts = (rng.rand(10, 3) * np.array(shape)).astype("float32")
    grids = np.meshgrid(*[np.arange(s, dtype="float32") for s in shape],
                        indexing="ij")
    d, _ = cKDTree(pts).query(np.stack([g.ravel() for g in grids], 1), k=2)
    bnd = ndimage.gaussian_filter(
        np.exp(-0.5 * ((d[:, 1] - d[:, 0]) / 2.0) ** 2).reshape(shape), 1.0)
    return np.round(bnd * 255).astype("uint8")


SHAPE = (20, 40, 40)
BLOCK = [10, 20, 20]
FUSED_CFG = {"threshold": 0.4, "size_filter": 10, "sigma_weights": 0.0,
             "halo": [2, 8, 8]}
WS_CFG = {"threshold": 0.4, "size_filter": 10, "sigma_weights": 0.0,
          "halo": [2, 8, 8]}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_exec")
    path = str(root / "d.n5")
    with file_reader(path) as f:
        f.require_dataset("bmap", shape=SHAPE, chunks=tuple(BLOCK),
                          dtype="uint8")[:] = _bmap(SHAPE, 3)
    return root, path


def _port_cfg(root, tag, mesh_devices):
    cfg = str(root / f"cfg_{tag}")
    ConfigDir(cfg).write_global_config({
        "block_shape": BLOCK, "device": "cpu",
        "mesh_devices": mesh_devices})
    ConfigDir(cfg).write_task_config("fused_segmentation", FUSED_CFG)
    ConfigDir(cfg).write_task_config("watershed", WS_CFG)
    return cfg


def _port_fused(root, path, target, mesh_devices=4):
    tag = f"fused_{target}_{mesh_devices}"
    cfg = _port_cfg(root, tag, mesh_devices)
    mc = ctp.MulticutSegmentationWorkflow(
        input_path=path, input_key="bmap", ws_path=path, ws_key=f"ws_{tag}",
        problem_path=str(root / f"p_{tag}.n5"), output_path=path,
        output_key=f"seg_{tag}", tmp_folder=str(root / f"tmp_{tag}"),
        config_dir=cfg, max_jobs=2, target=target, n_scales=1, fused=True)
    assert ctp.build([mc], raise_on_failure=True)
    with file_reader(path, "r") as f:
        out = f[f"ws_{tag}"][:], f[f"seg_{tag}"][:]
    with open(root / f"tmp_{tag}" / "fused_segmentation.status") as f:
        return out, json.load(f)


def _jax_cfg(root, tag):
    from cluster_tools_tpu.core.config import ConfigDir as JConfigDir

    cfg = str(root / f"jcfg_{tag}")
    JConfigDir(cfg).write_global_config({"block_shape": BLOCK})
    JConfigDir(cfg).write_task_config("fused_segmentation", FUSED_CFG)
    JConfigDir(cfg).write_task_config("watershed", WS_CFG)
    return cfg


@pytest.mark.parametrize("mesh_devices", [4, 3])
def test_fused_mesh_rounds_bitwise_equal_inline_and_jax(store,
                                                        mesh_devices):
    """8 blocks, block i on shard i mod 4 (and mod 3: shards with unequal
    block counts): the fragments and the segmentation equal the port's
    ``gpu`` run bit for bit and the JAX package's ``tpu`` run (which its
    own tests hold equal to its ``mesh`` run)."""
    import cluster_tools_tpu as ctt
    from cluster_tools_tpu.core.storage import file_reader as jreader

    root, path = store
    (ws_m, seg_m), st = _port_fused(root, path, "mesh", mesh_devices)
    (ws_g, seg_g), _ = _port_fused(root, path, "gpu")
    np.testing.assert_array_equal(ws_m, ws_g)
    np.testing.assert_array_equal(seg_m, seg_g)
    assert st["mesh_devices"] == mesh_devices
    assert st["physical_devices"] == 1
    # one dispatch per block: no shard runs anything but its own blocks
    assert st["stage_counts"]["dispatch"] == 8
    tag = f"jax_fused_{mesh_devices}"
    if not os.path.exists(str(root / "jtmp_fused")):
        mc = ctt.MulticutSegmentationWorkflow(
            input_path=path, input_key="bmap", ws_path=path,
            ws_key="ws_jax", problem_path=str(root / "pj.n5"),
            output_path=path, output_key="seg_jax",
            tmp_folder=str(root / "jtmp_fused"),
            config_dir=_jax_cfg(root, tag), max_jobs=2, target="tpu",
            n_scales=1, fused=True)
        assert ctt.build([mc], raise_on_failure=True)
    with jreader(path, "r") as f:
        np.testing.assert_array_equal(ws_m, f["ws_jax"][:])
        np.testing.assert_array_equal(seg_m, f["seg_jax"][:])


def test_watershed_mesh_rounds_bitwise_equal_inline_and_jax(store):
    import cluster_tools_tpu as ctt
    from cluster_tools_tpu.core.storage import file_reader as jreader

    root, path = store
    segs = {}
    for target in ("mesh", "gpu"):
        cfg = _port_cfg(root, f"ws_{target}", 4)
        wf = ctp.WatershedWorkflow(
            input_path=path, input_key="bmap", output_path=path,
            output_key=f"w_{target}", tmp_folder=str(root / f"wt_{target}"),
            config_dir=cfg, max_jobs=2, target=target)
        assert ctp.build([wf], raise_on_failure=True)
        with file_reader(path, "r") as f:
            segs[target] = f[f"w_{target}"][:]
    np.testing.assert_array_equal(segs["mesh"], segs["gpu"])
    with open(root / "wt_mesh" / "watershed.status") as f:
        st = json.load(f)
    assert st["mesh_devices"] == 4 and st["physical_devices"] == 1
    # one dispatch per block over both jobs: no shard repeats a block
    assert st["stage_counts"]["dispatch"] == 8
    from cluster_tools_tpu.workflows.watershed import WatershedWorkflow

    wf = WatershedWorkflow(
        input_path=path, input_key="bmap", output_path=path,
        output_key="w_jax", tmp_folder=str(root / "wt_jax"),
        config_dir=_jax_cfg(root, "ws"), max_jobs=2, target="tpu")
    assert ctt.build([wf], raise_on_failure=True)
    with jreader(path, "r") as f:
        np.testing.assert_array_equal(segs["mesh"], f["w_jax"][:])
    assert (segs["mesh"] > 0).all()


def _blob_volume(shape, seed=0):
    from test_mesh_exec import _blob_volume as jblob

    return jblob(shape, seed)


def test_mesh_cc_bit_identical_to_jax_mesh(tmp_path):
    """``ThresholdedComponentsWorkflow(target="mesh")`` of both packages
    (8 shards each) write the same labels, the port's equal to its ``gpu``
    run, with the same faces merged on the devices."""
    from cluster_tools_tpu.core.config import ConfigDir as JConfigDir
    from cluster_tools_tpu.core.storage import file_reader as jreader
    from cluster_tools_tpu.core.workflow import build as jbuild
    from cluster_tools_tpu.workflows.thresholded_components import \
        ThresholdedComponentsWorkflow as JTC

    vol = _blob_volume((20, 30, 40))
    path = str(tmp_path / "d.n5")
    with file_reader(path) as f:
        f.require_dataset("vol", shape=vol.shape, chunks=(10, 10, 10),
                          dtype="float32")[:] = vol
    JConfigDir(str(tmp_path / "jc")).write_global_config(
        {"block_shape": [10, 10, 10]})
    assert jbuild([JTC(input_path=path, input_key="vol", output_path=path,
                       output_key="j", threshold=0.35,
                       tmp_folder=str(tmp_path / "jt"),
                       config_dir=str(tmp_path / "jc"), max_jobs=2,
                       target="mesh")], raise_on_failure=True)
    ConfigDir(str(tmp_path / "pc")).write_global_config(
        {"block_shape": [10, 10, 10], "device": "cpu", "mesh_devices": 8})
    for target in ("mesh", "gpu"):
        assert ctp.build([ctp.ThresholdedComponentsWorkflow(
            input_path=path, input_key="vol", output_path=path,
            output_key=f"p_{target}", threshold=0.35,
            tmp_folder=str(tmp_path / f"pt_{target}"),
            config_dir=str(tmp_path / "pc"), max_jobs=2, target=target)],
            raise_on_failure=True)
    with jreader(path, "r") as f:
        want = f["j"][:]
    with file_reader(path, "r") as f:
        got, gpu = f["p_mesh"][:], f["p_gpu"][:]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, gpu)
    assert len(np.unique(got)) > 5
    with open(tmp_path / "pt_mesh" / "cc_offsets.json") as f:
        pmeta = json.load(f)
    with open(tmp_path / "jt" / "cc_offsets.json") as f:
        jmeta = json.load(f)
    assert pmeta["covered_faces"] == jmeta["covered_faces"]
    assert len(pmeta["covered_faces"]) > 0


def test_mesh_cc_short_last_round_and_shard_count_check(tmp_path):
    """24 blocks over 5 shards: the last round runs 4 blocks on 4 shards
    and the labels equal the ``gpu`` run's; the task key ``n_devices``
    other than the shard count fails the job, naming ``mesh_devices``."""
    vol = _blob_volume((20, 30, 40))
    path = str(tmp_path / "d.n5")
    with file_reader(path) as f:
        f.require_dataset("vol", shape=vol.shape, chunks=(10, 10, 10),
                          dtype="float32")[:] = vol
    cfg = str(tmp_path / "pc")
    ConfigDir(cfg).write_global_config(
        {"block_shape": [10, 10, 10], "device": "cpu", "mesh_devices": 5})

    def run(target, tag):
        return ctp.build([ctp.ThresholdedComponentsWorkflow(
            input_path=path, input_key="vol", output_path=path,
            output_key=f"p_{tag}", threshold=0.35,
            tmp_folder=str(tmp_path / f"pt_{tag}"), config_dir=cfg,
            max_jobs=2, target=target)], raise_on_failure=True)

    assert run("mesh", "mesh") and run("gpu", "gpu")
    with file_reader(path, "r") as f:
        np.testing.assert_array_equal(f["p_mesh"][:], f["p_gpu"][:])
    with open(tmp_path / "pt_mesh" / "mesh_block_components.status") as f:
        st = json.load(f)
    assert st["mesh_devices"] == 5 and st["physical_devices"] == 1
    ConfigDir(cfg).write_task_config("mesh_block_components",
                                     {"n_devices": 3})
    with pytest.raises(Exception):
        run("mesh", "bad")
    logs = tmp_path / "pt_bad" / "logs"
    text = "".join(p.read_text() for p in logs.iterdir())
    assert "n_devices=3 differs from the 5 shard devices" in text


def test_predict_sharded_matches_jax(tmp_path, monkeypatch):
    """5 outer blocks over the (2, 2, 2) mesh's data axis (padded to 6),
    standardize and normalize, an outer shape that needs the reflect pad:
    within 2e-5 of the JAX package's ``predict_sharded`` with both U-Nets
    in float32; the default bfloat16 U-Net within the bfloat16 tolerance
    of ``tests/test_torch_inference.py``."""
    import jax.numpy as jnp

    from cluster_tools_tpu.models import checkpoint as jckpt
    from cluster_tools_tpu.workflows.inference import \
        predict_sharded as jps
    from cluster_tools_tpu.workflows import inference as jinf
    from cluster_tools_tpu_torch.models import checkpoint as pckpt
    from cluster_tools_tpu_torch.parallel.mesh import shard_devices
    from cluster_tools_tpu_torch.workflows import inference as pinf
    from test_torch_inference import _jax_params

    cfg = {"out_channels": 3, "features": [4, 8, 16], "anisotropic": True}
    path = str(tmp_path / "ckpt")
    jckpt.save_checkpoint(path, cfg, _jax_params(cfg, 1, 0))
    raw = np.random.RandomState(1).randint(0, 255, (5, 6, 14, 18)).astype(
        "uint8")
    devs = shard_devices("cpu", 8)
    for preprocess in ("standardize", "normalize"):
        bf16 = pinf.predict_sharded(path, raw, preprocess=preprocess,
                                    devices=devs)
        want_bf = np.asarray(jps(path, raw, preprocess=preprocess))
        assert bf16.shape == want_bf.shape == (5, 3, 6, 14, 18)
        assert np.abs(bf16 - want_bf).max() < 2e-2

    real_j, real_p = jckpt.load_checkpoint, pckpt.load_checkpoint

    def j32(p, params=True):
        model, prm = real_j(p, params=params)
        return model.clone(dtype=jnp.float32), prm

    def p32(p, params=True, dtype=torch.bfloat16):
        return real_p(p, params=params, dtype=torch.float32)

    monkeypatch.setattr(jckpt, "load_checkpoint", j32)
    monkeypatch.setattr(pckpt, "load_checkpoint", p32)
    jinf._sharded_fwd.cache_clear()
    pinf._load_model.cache_clear()
    try:
        for preprocess in ("standardize", "normalize"):
            got = pinf.predict_sharded(path, raw, preprocess=preprocess,
                                       devices=devs)
            want = np.asarray(jps(path, raw, preprocess=preprocess))
            assert np.abs(got - want).max() < 2e-5, \
                np.abs(got - want).max()
    finally:
        jinf._sharded_fwd.cache_clear()
        pinf._load_model.cache_clear()


def test_mws_mesh_target_runs_inline(tmp_path):
    """``MwsWorkflow(target="mesh")`` runs (it raised before) and equals
    the port's inline run: the mutex watershed has no mesh formulation."""
    from test_torch_mws import CASES, HALO, OFFSETS

    data = CASES["uint8"][0]
    segs = {}
    for target in ("mesh", "inline"):
        root = tmp_path / target
        path = str(root / "d.n5")
        os.makedirs(root)
        with file_reader(path) as f:
            f.require_dataset("affs", shape=data.shape,
                              chunks=[1, 10, 24, 24],
                              dtype=data.dtype)[:] = data
        cfg = str(root / "cfg")
        ConfigDir(cfg).write_global_config({
            "block_shape": [10, 24, 24], "device": "cpu",
            "mesh_devices": 4})
        wf = ctp.MwsWorkflow(input_path=path, input_key="affs",
                             output_path=path, output_key="seg",
                             offsets=OFFSETS, halo=HALO,
                             tmp_folder=str(root / "tmp"), config_dir=cfg,
                             max_jobs=2, target=target)
        assert ctp.build([wf], raise_on_failure=True)
        with file_reader(path, "r") as f:
            segs[target] = f["seg"][:]
    np.testing.assert_array_equal(segs["mesh"], segs["inline"])
    assert segs["mesh"].min() >= 1
