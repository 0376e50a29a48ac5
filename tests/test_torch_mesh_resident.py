"""The port's mesh-resident fused chain (``fused_pipeline.
mesh_resident_program`` / ``_process_mesh``) against the JAX package's
``_mesh_resident_program`` and its workflow, on the CPU.  The JAX side
runs on the 8 virtual CPU devices ``tests/conftest.py`` forces; the port
places its shards on the CPU (``"mesh_devices"``).

Gates: uint8 input with ``sigma_weights`` 0 — labels, meta and edge
tables identical, features identical but for mean and variance (rtol
1e-6: the float32 ``hist @ levels`` dot sums in another order, as in
``tests/test_torch_ops.py``); float32 input with the defaults' Gaussian —
VOI <= 0.01 and edge counts within 3 % (the Gaussian's tap order moves
voxels between fragments, ROADMAP §C)."""

import json

import numpy as np
import pytest
import torch
from scipy import ndimage

from cluster_tools_tpu_torch.core.storage import file_reader
from cluster_tools_tpu_torch.workflows import fused_pipeline as fp

VOI_GATE = 0.01


def _volume(shape, u8, seed=0):
    rng = np.random.RandomState(seed)
    vol = ndimage.gaussian_filter(rng.rand(*shape).astype("float32"), 2.0)
    vol = (vol - vol.min()) / (vol.max() - vol.min())
    return np.round(vol * 255).astype("uint8") if u8 else vol


def _padded(data, n):
    from cluster_tools_tpu_torch.workflows.watershed import reflect_indices

    slab_z = -(-data.shape[0] // n)
    zp = n * slab_z
    return (data[reflect_indices(0, zp, data.shape[0])]
            if zp > data.shape[0] else data), slab_z


def _run_both(shape, n, halo, u8, sigma_weights, e_max=4096,
              pair_cap=1 << 15):
    """The JAX program and the port's on one volume; returns (jax, port)
    as (labels, meta (n, 5), per-shard uv, per-shard feats)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cluster_tools_tpu.workflows.fused_pipeline import \
        _mesh_resident_program

    data = _volume(shape, u8)
    volp, slab_z = _padded(data, n)
    h = (min(halo[0], slab_z - 1), halo[1], halo[2])
    args = (n, slab_z, tuple(shape), h, str(data.dtype), 0.5, 1.0,
            sigma_weights, 0.8, 5, e_max, 2, pair_cap, 2)
    prog, mesh = _mesh_resident_program(*args)
    lab, meta, uv, feats = (np.asarray(a) for a in prog(jax.device_put(
        volp, NamedSharding(mesh, P("shard", None, None)))))
    uv = uv.reshape(n, e_max, 2)
    feats = feats.reshape(n, e_max, -1)
    meta = meta.astype("int64")
    jx = (lab, meta, [uv[s, :meta[s, 1]] for s in range(n)],
          [feats[s, :meta[s, 1]] for s in range(n)])

    p = fp.MeshParams(n, slab_z, tuple(shape), h, u8, 0.5, 1.0,
                      sigma_weights, 0.8, 5, e_max, 2, pair_cap, 2)
    slabs = [torch.from_numpy(volp[i * slab_z:(i + 1) * slab_z].copy())
             for i in range(n)]
    labs, metas, uvs, fts = fp.mesh_resident_program(slabs, p)
    pmeta = torch.stack(metas).numpy()
    pt = (torch.cat(labs).numpy(), pmeta,
          [uvs[s].numpy()[:pmeta[s, 1]] for s in range(n)],
          [fts[s].numpy()[:pmeta[s, 1]] for s in range(n)])
    return jx, pt


def test_mesh_slab_block_shape():
    from cluster_tools_tpu.workflows.fused_pipeline import \
        mesh_slab_block_shape as jmsbs

    for shape, n in (((48, 128, 128), 4), ((50, 128, 128), 4),
                     ((3, 8, 8), 8), ((125, 1250, 1250), 4)):
        assert fp.mesh_slab_block_shape(shape, n) == jmsbs(shape, n)
    assert fp.mesh_slab_block_shape((125, 1250, 1250), 4) == [32, 1250, 1250]


@pytest.mark.parametrize("shape,n,halo", [
    ((12, 16, 16), 2, (2, 4, 4)),
    ((32, 48, 48), 4, (2, 8, 8)),
    ((30, 32, 32), 4, (2, 4, 4)),   # the last slab carries the z pad
])
def test_uint8_program_matches_jax_exactly(shape, n, halo):
    jx, pt = _run_both(shape, n, halo, u8=True, sigma_weights=0.0)
    np.testing.assert_array_equal(pt[0], jx[0])
    np.testing.assert_array_equal(pt[1], jx[1])
    assert pt[1][:, 4].all() and (pt[1][:, 2:4] == 0).all()
    for s in range(n):
        np.testing.assert_array_equal(pt[2][s], jx[2][s])
        np.testing.assert_array_equal(pt[3][s][:, 2:], jx[3][s][:, 2:])
        np.testing.assert_allclose(pt[3][s][:, :2], jx[3][s][:, :2],
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n", [2, 4])
def test_float_program_within_voi_of_jax(n):
    from cluster_tools_tpu_torch.utils.validation import (
        ContingencyTable, cremi_score_from_table)

    jx, pt = _run_both((24, 32, 32), n, (2, 4, 4), u8=False,
                       sigma_weights=1.0)
    t = ContingencyTable.from_arrays_chunked(jx[0].astype("uint64"),
                                             pt[0].astype("uint64"))
    vs, vm, _, _ = cremi_score_from_table(t)
    assert vs + vm <= VOI_GATE, (vs, vm)
    e_j = sum(len(u) for u in jx[2])
    e_p = sum(len(u) for u in pt[2])
    assert abs(e_p - e_j) <= 0.03 * e_j, (e_p, e_j)


@pytest.mark.parametrize("u8", [True, False])
def test_shard_tables_union_to_the_rag(u8):
    """The union of the shard tables is EXACTLY the RAG of the emitted
    labels (interior pairs per shard plus every cross-shard face pair
    once), the labels are globally consecutive with disjoint shard
    ranges, and every pair carries two samples."""
    from cluster_tools_tpu_torch.ops.rag import host_label_pairs

    n, shape = 3, (18, 20, 20)
    data = _volume(shape, u8, seed=2)
    volp, slab_z = _padded(data, n)
    p = fp.MeshParams(n, slab_z, shape, (2, 4, 4), u8, 0.5, 1.0, 1.0, 0.8,
                      5, 4096, 2, 1 << 15, 2)
    slabs = [torch.from_numpy(volp[i * slab_z:(i + 1) * slab_z].copy())
             for i in range(n)]
    labs, metas, uvs, fts = fp.mesh_resident_program(slabs, p)
    meta = torch.stack(metas).numpy()
    lab = torch.cat(labs).numpy()
    ks = meta[:, 0]
    uniq = np.unique(lab)
    np.testing.assert_array_equal(uniq[uniq > 0], np.arange(1, ks.sum() + 1))
    offs = np.concatenate([[0], np.cumsum(ks)])
    for s in range(n):
        sv = np.unique(lab[s * slab_z:(s + 1) * slab_z])
        sv = sv[sv > 0]
        assert (sv > offs[s]).all() and (sv <= offs[s + 1]).all()
    got = np.concatenate([uvs[s].numpy()[:meta[s, 1]] for s in range(n)])
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    np.testing.assert_array_equal(got.astype("uint64"),
                                  host_label_pairs(lab.astype("uint64")))
    cnt = np.concatenate([fts[s].numpy()[:meta[s, 1], -1]
                          for s in range(n)])
    assert (cnt >= 2).all() and cnt.sum() % 2 == 0


def _workflow_data(root):
    from scipy.spatial import cKDTree

    rng = np.random.RandomState(0)
    shape = (24, 64, 64)
    pts = (rng.rand(8, 3) * np.array(shape)).astype("float32")
    grids = np.meshgrid(*[np.arange(s, dtype="float32") for s in shape],
                        indexing="ij")
    d, idx = cKDTree(pts).query(np.stack([g.ravel() for g in grids], 1),
                                k=2)
    gt = (idx[:, 0] + 1).reshape(shape).astype("uint64")
    bnd = np.exp(-0.5 * ((d[:, 1] - d[:, 0]) / 2.0) ** 2).reshape(shape)
    path = str(root / "d.n5")
    with file_reader(path) as f:
        ds = f.require_dataset("bmap", shape=shape, chunks=(8, 32, 32),
                               dtype="uint8")
        ds[:] = np.round(bnd * 255).astype("uint8")
    return path, gt


TASK_CFG = {"threshold": 0.4, "size_filter": 50, "halo": [2, 8, 8],
            "sigma_weights": 0.0, "mesh_shards": 4}


def _run_port(root, path, tag, mesh):
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir

    cfg_dir = str(root / f"pcfg_{tag}")
    ConfigDir(cfg_dir).write_global_config({
        "block_shape": [8, 32, 32], "device": "cpu", "mesh_devices": 4})
    ConfigDir(cfg_dir).write_task_config(
        "fused_segmentation", {**TASK_CFG, "mesh_resident": mesh})
    tmp = root / f"ptmp_{tag}"
    mc = ctp.MulticutSegmentationWorkflow(
        input_path=path, input_key="bmap", ws_path=path, ws_key=f"ws_{tag}",
        problem_path=str(root / f"pp_{tag}.n5"), output_path=path,
        output_key=f"seg_{tag}", tmp_folder=str(tmp), config_dir=cfg_dir,
        max_jobs=2, target="gpu", n_scales=1, fused=True)
    assert ctp.build([mc], raise_on_failure=True)
    with file_reader(path, "r") as f:
        out = f[f"ws_{tag}"][:], f[f"seg_{tag}"][:]
    with open(tmp / "fused_segmentation.status") as f:
        return out, json.load(f)


@pytest.fixture(scope="module")
def workflows(tmp_path_factory):
    """The port's fused chain blockwise and mesh-resident, and the JAX
    package's mesh-resident workflow, on one uint8 volume."""
    import cluster_tools_tpu as ctt
    from cluster_tools_tpu.core.config import ConfigDir as JConfigDir
    from cluster_tools_tpu.core.storage import file_reader as jreader

    root = tmp_path_factory.mktemp("mesh_wf")
    path, gt = _workflow_data(root)
    port_mesh, st_mesh = _run_port(root, path, "mesh", True)
    port_block, st_block = _run_port(root, path, "block", False)
    cfg_dir = str(root / "jcfg")
    JConfigDir(cfg_dir).write_global_config({"block_shape": [8, 32, 32]})
    JConfigDir(cfg_dir).write_task_config(
        "fused_segmentation", {**TASK_CFG, "mesh_resident": True})
    mc = ctt.MulticutSegmentationWorkflow(
        input_path=path, input_key="bmap", ws_path=path, ws_key="ws_jax",
        problem_path=str(root / "pj.n5"), output_path=path,
        output_key="seg_jax", tmp_folder=str(root / "jtmp"),
        config_dir=cfg_dir, max_jobs=2, target="tpu", n_scales=1,
        fused=True)
    assert ctt.build([mc], raise_on_failure=True)
    with jreader(path, "r") as f:
        jax_mesh = f["ws_jax"][:], f["seg_jax"][:]
    with file_reader(str(root / "pp_mesh.n5"), "r") as f:
        sub_bs = list(f["s0/graph"].attrs["sub_graph_block_shape"])
    return dict(gt=gt, port_mesh=port_mesh, st_mesh=st_mesh,
                port_block=port_block, st_block=st_block,
                jax_mesh=jax_mesh, sub_bs=sub_bs)


def _voi(a, b):
    from cluster_tools_tpu_torch.utils.validation import (
        ContingencyTable, cremi_score_from_table)

    vs, vm, _, _ = cremi_score_from_table(
        ContingencyTable.from_arrays_chunked(a, b))
    return vs + vm


def test_workflow_matches_jax_mesh_workflow(workflows):
    """uint8, ``sigma_weights`` 0: the port's mesh-resident fragments are
    the JAX package's; the segmentations are within the VOI gate."""
    np.testing.assert_array_equal(workflows["port_mesh"][0],
                                  workflows["jax_mesh"][0])
    assert _voi(workflows["port_mesh"][1],
                workflows["jax_mesh"][1]) <= VOI_GATE


def test_workflow_syncs_once_and_records_the_mesh(workflows):
    """ONE sync-execute for the volume against one per block blockwise,
    the slab decomposition in the problem, and the status naming 4 shards
    on 1 physical device."""
    st_m, st_b = workflows["st_mesh"], workflows["st_block"]
    assert st_m["stage_counts"]["sync-execute"] == 1
    assert st_b["stage_counts"]["sync-execute"] == 12
    assert st_m["mesh_devices"] == 4 and st_m["physical_devices"] == 1
    assert "mesh_devices" not in st_b
    assert workflows["sub_bs"] == [6, 64, 64]


def test_workflow_quality_against_ground_truth(workflows):
    """Both the blockwise and the mesh-resident segmentation recover the
    generator's objects (adapted Rand error below 0.2)."""
    from cluster_tools_tpu_torch.utils.validation import (
        ContingencyTable, cremi_score_from_table)

    for key in ("port_mesh", "port_block"):
        t = ContingencyTable.from_arrays_chunked(workflows["gt"],
                                                 workflows[key][1])
        assert cremi_score_from_table(t)[2] < 0.2, key


def test_mesh_resident_config_runs_without_raising(tmp_path):
    """``mesh_resident: true`` constructs (it raised before the port had
    the mesh path) and picks the slab blocking."""
    from cluster_tools_tpu_torch.core.config import ConfigDir

    path, _ = _workflow_data(tmp_path)
    cfg = str(tmp_path / "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": [8, 8, 8],
                                        "device": "cpu", "mesh_devices": 2})
    ConfigDir(cfg).write_task_config("fused_segmentation",
                                     {"mesh_resident": True})
    assert fp.mesh_resident_block_shape(cfg, path, "bmap") == [12, 64, 64]
    fp.FusedSegmentationBlocks(
        input_path=path, input_key="bmap", output_path=path,
        output_key="w", problem_path="p.n5",
        tmp_folder=str(tmp_path / "tmp"), config_dir=cfg)


@pytest.mark.parametrize("mesh_shards,ok", [(0, True), (2, True),
                                            (4, False)])
def test_mesh_shards_must_be_the_shard_count(tmp_path, mesh_shards, ok):
    """The shards are the global config's ``mesh_devices``; the task key
    ``mesh_shards`` (kept for config directories the JAX package writes)
    is 0 or that count, else the DAG construction raises."""
    from cluster_tools_tpu_torch.core.config import ConfigDir

    path, _ = _workflow_data(tmp_path)
    cfg = str(tmp_path / "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": [8, 8, 8],
                                        "device": "cpu", "mesh_devices": 2})
    ConfigDir(cfg).write_task_config(
        "fused_segmentation", {"mesh_resident": True,
                               "mesh_shards": mesh_shards})
    if ok:
        assert fp.mesh_resident_block_shape(cfg, path, "bmap") == \
            [12, 64, 64]
    else:
        with pytest.raises(ValueError, match="mesh_shards=4 differs"):
            fp.mesh_resident_block_shape(cfg, path, "bmap")
