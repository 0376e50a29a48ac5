"""Per-object morphology, region centers, meshes and skeletons of the port
(``workflows/{morphology,meshes,skeletons}.py``, ``utils/{mesh,
transformations}.py``, ``native.skeletonize_3d``) against the JAX
package, on the CPU.

Both packages run the same numpy, scipy and C++ steps on the host, so
every output is held exactly: the morphology table (float64, bitwise),
the region centers, the mesh vertices and faces, the skeleton voxels
(the same C++ thinning), the skeleton metrics and the affine helpers.
The tests of the JAX package's own files (``test_region_features.py``,
``test_pixel_classification.py::test_mesh_workflow``, ``test_utils.py``)
run on the port here, each beside the JAX package's result.  Containers
written by one package are read by the other."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest


def _env(pkg, root, block=(8, 8, 8)):
    if pkg == "jax":
        import cluster_tools_tpu as M
        from cluster_tools_tpu import native
        from cluster_tools_tpu.core.config import ConfigDir
        from cluster_tools_tpu.utils import mesh, transformations
        from cluster_tools_tpu.workflows import meshes, morphology, skeletons
        extra = {}
    else:
        import cluster_tools_tpu_torch as M
        from cluster_tools_tpu_torch import native
        from cluster_tools_tpu_torch.core.config import ConfigDir
        from cluster_tools_tpu_torch.utils import mesh, transformations
        from cluster_tools_tpu_torch.workflows import (meshes, morphology,
                                                       skeletons)
        extra = {"device": "cpu"}
    os.makedirs(root, exist_ok=True)
    cfg = os.path.join(root, "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": list(block),
                                        "max_num_retries": 0, **extra})
    return SimpleNamespace(
        M=M, ConfigDir=ConfigDir, native=native, mesh=mesh,
        tf=transformations, meshes=meshes,
        morphology=morphology, skeletons=skeletons,
        path=os.path.join(root, "d.n5"),
        common=dict(tmp_folder=os.path.join(root, "tmp"), config_dir=cfg,
                    max_jobs=2, target="threads"))


def _write(env, key, data, max_id=True, chunks=(8, 8, 8)):
    with env.M.file_reader(env.path) as f:
        ds = f.require_dataset(key, shape=data.shape, chunks=list(chunks),
                               dtype=str(data.dtype))
        ds[:] = data
        if max_id:
            ds.attrs["maxId"] = int(data.max())


def _read(env, key, path=None):
    with env.M.file_reader(path or env.path, "r") as f:
        return f[key][:]


def _both(tmp_path, fn, **kw):
    return (fn(_env("jax", str(tmp_path / "jax"), **kw)),
            fn(_env("torch", str(tmp_path / "torch"), **kw)))


def _seg_and_data(shape=(16, 16, 16)):
    """The JAX package's test segmentation (tests/test_region_features.py)."""
    seg = np.zeros(shape, "uint64")
    seg[:, :8, :] = 1
    seg[:, 8:, :] = 2
    seg[4:8, 4:8, 4:8] = 3
    return seg


def _random_objects(shape=(20, 24, 28), n=12, seed=0):
    """Random overlapping balls and boxes with ids 1..n (later ones win),
    some crossing block faces, one empty id left out of the volume."""
    rng = np.random.RandomState(seed)
    seg = np.zeros(shape, "uint64")
    grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    for i in range(1, n + 1):
        if i == 5:
            continue  # an id below maxId without voxels
        c = rng.rand(3) * np.asarray(shape)
        if i % 2:
            r = rng.uniform(2.5, 6.0)
            m = sum((g - cc) ** 2 for g, cc in zip(grids, c)) < r * r
        else:
            half = rng.randint(2, 6, 3)
            m = np.ones(shape, bool)
            for g, cc, h in zip(grids, c, half):
                m &= np.abs(g - cc) <= h
        seg[m] = i
    return seg


# ---------------------------------------------------------------------------
# morphology and region centers
# ---------------------------------------------------------------------------

def _morphology(env, seg):
    _write(env, "seg", seg)
    wf = env.morphology.MorphologyWorkflow(
        input_path=env.path, input_key="seg", output_path=env.path,
        output_key="morphology", **env.common)
    assert env.M.build([wf], raise_on_failure=True)
    return _read(env, "morphology")


@pytest.mark.parametrize("which", ["reference", "random"])
def test_morphology_table_matches_jax(tmp_path, which):
    seg = _seg_and_data() if which == "reference" else _random_objects()
    jax_t, port_t = _both(tmp_path, lambda e: _morphology(e, seg))
    assert jax_t.dtype == port_t.dtype == np.float64
    np.testing.assert_array_equal(port_t, jax_t)
    # the JAX package's oracle (tests/test_region_features.py)
    for lbl in np.unique(seg[seg > 0]):
        m = seg == lbl
        coords = np.stack(np.nonzero(m), 1)
        assert port_t[lbl, 1] == m.sum()
        np.testing.assert_allclose(port_t[lbl, 2:5], coords.mean(0),
                                   atol=1e-6)
        np.testing.assert_array_equal(port_t[lbl, 5:8], coords.min(0))
        np.testing.assert_array_equal(port_t[lbl, 8:11], coords.max(0))


def test_block_morphology_and_merge_match_jax():
    from cluster_tools_tpu.workflows import morphology as J
    from cluster_tools_tpu_torch.workflows import morphology as P

    seg = _random_objects(seed=3)
    rows_j = [J.block_morphology(seg[z:z + 7], (z, 0, 0))
              for z in range(0, seg.shape[0], 7)]
    rows_p = [P.block_morphology(seg[z:z + 7], (z, 0, 0))
              for z in range(0, seg.shape[0], 7)]
    for a, b in zip(rows_j, rows_p):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(
        P.merge_morphology_rows(np.concatenate(rows_p)),
        J.merge_morphology_rows(np.concatenate(rows_j)))
    for a, b in zip(J.decode_morphology(rows_j[0]),
                    P.decode_morphology(rows_p[0])):
        np.testing.assert_array_equal(b, a)


def _centers(env, seg):
    _write(env, "seg", seg)
    morpho = env.morphology.MorphologyWorkflow(
        input_path=env.path, input_key="seg", output_path=env.path,
        output_key="morphology", **env.common)
    centers = env.morphology.RegionCenters(
        input_path=env.path, input_key="seg", morphology_path=env.path,
        morphology_key="morphology", output_path=env.path,
        output_key="centers", n_labels=int(seg.max()) + 1,
        dependency=morpho, **env.common)
    assert env.M.build([centers], raise_on_failure=True)
    return _read(env, "centers")


@pytest.mark.parametrize("which", ["reference", "random"])
def test_region_centers_match_jax(tmp_path, which):
    seg = _seg_and_data() if which == "reference" else _random_objects()
    jax_c, port_c = _both(tmp_path, lambda e: _centers(e, seg))
    np.testing.assert_array_equal(port_c, jax_c)
    # centers lie inside their own segment (the point of EDT centers)
    for lbl in np.unique(seg[seg > 0]):
        assert seg[tuple(port_c[lbl].astype("int64"))] == lbl


def test_port_reads_jax_morphology_table(tmp_path):
    """RegionCenters of the port over a table the JAX package wrote, and
    the JAX package's over the port's."""
    seg = _random_objects(seed=1)
    jax_env = _env("jax", str(tmp_path / "jax"))
    port_env = _env("torch", str(tmp_path / "torch"))
    _morphology(jax_env, seg)
    _morphology(port_env, seg)
    out = {}
    for env, other in ((port_env, jax_env), (jax_env, port_env)):
        task = env.morphology.RegionCenters(
            input_path=env.path, input_key="seg",
            morphology_path=other.path, morphology_key="morphology",
            output_path=env.path, output_key="centers_x",
            n_labels=int(seg.max()) + 1,
            **dict(env.common, tmp_folder=env.common["tmp_folder"] + "_x"))
        assert env.M.build([task], raise_on_failure=True)
        out[env is port_env] = _read(env, "centers_x")
    np.testing.assert_array_equal(out[True], out[False])


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def _meshes(env, seg, task_cfg=None):
    _write(env, "seg", seg)
    if task_cfg:
        env.ConfigDir(env.common["config_dir"]).write_task_config(
            "compute_meshes", task_cfg)
    wf = env.meshes.MeshWorkflow(
        input_path=env.path, input_key="seg", output_path=env.path,
        output_key="meshes", **env.common)
    assert env.M.build([wf], raise_on_failure=True)
    return {lbl: env.meshes.load_mesh(env.path, "meshes", lbl)
            for lbl in range(int(seg.max()) + 1)}


def test_mesh_workflow_matches_jax(tmp_path):
    """The JAX package's test_mesh_workflow, run on both packages."""
    seg = np.zeros((16, 16, 16), "uint64")
    seg[4:12, 4:12, 4:12] = 1
    jax_m, port_m = _both(tmp_path, lambda e: _meshes(e, seg))
    verts, faces = port_m[1]
    np.testing.assert_array_equal(verts, jax_m[1][0])
    np.testing.assert_array_equal(faces, jax_m[1][1])
    assert len(verts) > 50 and len(faces) > 50
    assert verts.min() >= 2.5 and verts.max() <= 12.5
    assert port_m[0] is None and jax_m[0] is None


@pytest.mark.parametrize("task_cfg", [{}, {"smoothing_iterations": 3,
                                           "size_threshold": 150}])
def test_mesh_workflow_random_objects_match_jax(tmp_path, task_cfg):
    seg = _random_objects(seed=2)
    jax_m, port_m = _both(tmp_path, lambda e: _meshes(e, seg, task_cfg))
    assert jax_m.keys() == port_m.keys()
    n_meshes = 0
    for lbl in jax_m:
        if jax_m[lbl] is None:
            assert port_m[lbl] is None
            continue
        n_meshes += 1
        for a, b in zip(jax_m[lbl], port_m[lbl]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
        # closed: every edge shared by exactly two faces
        faces = port_m[lbl][1]
        edges = np.sort(np.concatenate(
            [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1)
        _, counts = np.unique(edges, axis=0, return_counts=True)
        assert (counts == 2).all(), lbl
    sizes = np.bincount(seg.ravel().astype("int64"))[1:]
    want = int(((sizes >= task_cfg.get("size_threshold", 1))
                & (sizes > 0)).sum())
    assert n_meshes == want


def test_mesh_extraction_matches_jax():
    """The JAX package's test_mesh_extraction_watertight on the port,
    vertices and faces equal to the JAX package's."""
    from cluster_tools_tpu.utils import mesh as J
    from cluster_tools_tpu_torch.utils import mesh as P

    zz, yy, xx = np.meshgrid(*[np.arange(20)] * 3, indexing="ij")
    seg = ((zz - 10) ** 2 + (yy - 10) ** 2 + (xx - 10) ** 2 < 49
           ).astype("uint64") * 3
    verts, faces = P.object_mesh(seg, 3)
    jv, jf = J.object_mesh(seg, 3)
    np.testing.assert_array_equal(verts, jv)
    np.testing.assert_array_equal(faces, jf)
    assert len(verts) > 100 and len(faces) > 100
    r = np.linalg.norm(verts - 10, axis=1)
    assert 5.5 < r.min() and r.max() < 8.5
    edges = np.sort(np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()
    smoothed = P.smooth_mesh(verts, faces, iterations=10)
    np.testing.assert_array_equal(
        smoothed, J.smooth_mesh(jv, jf, iterations=10))
    r2 = np.linalg.norm(smoothed - 10, axis=1)
    assert r2.std() < r.std()


@pytest.mark.parametrize("level", [0.3, 0.5, 0.8])
def test_marching_tetrahedra_matches_jax(level):
    from cluster_tools_tpu.utils import mesh as J
    from cluster_tools_tpu_torch.utils import mesh as P

    vol = np.random.RandomState(4).rand(7, 9, 8)
    for a, b in zip(J.marching_tetrahedra(vol, level),
                    P.marching_tetrahedra(vol, level)):
        np.testing.assert_array_equal(b, a)
    empty = P.marching_tetrahedra(np.zeros((1, 4, 4)))
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)


# ---------------------------------------------------------------------------
# affine transformations
# ---------------------------------------------------------------------------

def test_affine_matrices_roundtrip_match_jax():
    """The JAX package's test_affine_matrices_roundtrip on the port, every
    matrix and parameter equal to the JAX package's."""
    from cluster_tools_tpu.utils import transformations as J
    from cluster_tools_tpu_torch.utils import transformations as P

    m = P.matrix_2d(scale=(2.0, 3.0), rotation=30.0,
                    translation=(5.0, -2.0))
    np.testing.assert_array_equal(m, J.matrix_2d(
        scale=(2.0, 3.0), rotation=30.0, translation=(5.0, -2.0)))
    scale, rot, trans = P.parameters_from_matrix(m)
    assert (scale, rot, trans) == J.parameters_from_matrix(m)
    np.testing.assert_allclose(scale, (2.0, 3.0), rtol=1e-6)
    np.testing.assert_allclose(rot, 30.0, rtol=1e-6)
    np.testing.assert_allclose(trans, (5.0, -2.0), rtol=1e-6)

    m = P.matrix_3d(scale=(1.5, 2.0, 0.5), rotation=(10.0, -20.0, 30.0),
                    translation=(1.0, 2.0, 3.0))
    np.testing.assert_array_equal(m, J.matrix_3d(
        scale=(1.5, 2.0, 0.5), rotation=(10.0, -20.0, 30.0),
        translation=(1.0, 2.0, 3.0)))
    scale, rot, trans = P.parameters_from_matrix(m)
    assert (scale, rot, trans) == J.parameters_from_matrix(m)
    np.testing.assert_allclose(scale, (1.5, 2.0, 0.5), rtol=1e-6)
    np.testing.assert_allclose(rot, (10.0, -20.0, 30.0), rtol=1e-5)
    np.testing.assert_allclose(trans, (1.0, 2.0, 3.0), rtol=1e-6)

    m = P.matrix_3d(translation=(10.0, 0.0, 0.0))
    lo, hi = P.transform_roi((0, 0, 0), (4, 4, 4), m)
    assert (lo, hi) == J.transform_roi((0, 0, 0), (4, 4, 4), m)
    np.testing.assert_allclose(lo, (10, 0, 0))
    np.testing.assert_allclose(hi, (14, 4, 4))


@pytest.mark.parametrize("seed", range(4))
def test_random_affines_match_jax(seed):
    from cluster_tools_tpu.utils import transformations as J
    from cluster_tools_tpu_torch.utils import transformations as P

    rng = np.random.RandomState(seed)
    kw = dict(scale=tuple(rng.uniform(0.5, 3, 3)),
              rotation=tuple(rng.uniform(-80, 80, 3)),
              translation=tuple(rng.uniform(-20, 20, 3)))
    m = P.matrix_3d(**kw)
    np.testing.assert_array_equal(m, J.matrix_3d(**kw))
    assert P.parameters_from_matrix(m) == J.parameters_from_matrix(m)
    roi = (tuple(rng.randint(0, 10, 3)), tuple(rng.randint(10, 30, 3)))
    assert P.transform_roi(*roi, m) == J.transform_roi(*roi, m)


def test_gimbal_lock_parameters_match_jax():
    from cluster_tools_tpu.utils import transformations as J
    from cluster_tools_tpu_torch.utils import transformations as P

    m = P.matrix_3d(rotation=(0.0, 90.0, 0.0))
    scale, rot, trans = P.parameters_from_matrix(m)
    assert (scale, rot, trans) == J.parameters_from_matrix(m)
    assert np.isfinite(rot).all()
    m2 = P.matrix_3d(scale=scale, rotation=rot, translation=trans)
    np.testing.assert_allclose(m2, m, atol=1e-9)


# ---------------------------------------------------------------------------
# skeletons
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["bar", "ball", "random"])
def test_skeletonize_3d_matches_jax_native(which):
    """The port's binding of the C++ thinning gives the JAX package's
    skeleton voxel for voxel."""
    from cluster_tools_tpu import native as J
    from cluster_tools_tpu_torch import native as P

    if which == "bar":
        vol = np.zeros((8, 8, 24), bool)
        vol[2:6, 2:6, 2:22] = True
    elif which == "ball":
        zz, yy, xx = np.meshgrid(*[np.arange(15)] * 3, indexing="ij")
        vol = (zz - 7) ** 2 + (yy - 7) ** 2 + (xx - 7) ** 2 < 36
    else:
        seg = _random_objects(seed=5)
        vol = np.isin(seg, [1, 2, 3, 4])
    got = P.skeletonize_3d(vol)
    assert got.dtype == bool and got.shape == vol.shape
    np.testing.assert_array_equal(got, J.skeletonize_3d(vol))
    assert got.any() and not (got & ~vol).any()


def test_skeletonize_3d_rejects_2d():
    from cluster_tools_tpu_torch import native

    with pytest.raises(ValueError, match="3d"):
        native.skeletonize_3d(np.ones((4, 4), bool))


def _skeletons(env, seg, key="seg"):
    _write(env, key, seg)
    wf = env.skeletons.SkeletonWorkflow(
        input_path=env.path, input_key=key, output_path=env.path,
        output_key="skeletons", **env.common)
    assert env.M.build([wf], raise_on_failure=True)
    return {lbl: env.skeletons.load_skeleton(env.path, "skeletons", lbl)
            for lbl in range(1, int(seg.max()) + 1)}


def test_skeleton_workflow_matches_jax(tmp_path):
    """The JAX package's test_skeleton_workflow, run on both packages."""
    seg = np.zeros((8, 8, 24), "uint64")
    seg[2:6, 2:6, 2:22] = 1
    jax_s, port_s = _both(tmp_path, lambda e: _skeletons(e, seg))
    coords = port_s[1]
    np.testing.assert_array_equal(coords, jax_s[1])
    assert coords is not None and len(coords) > 5
    assert (seg[tuple(coords.T.astype("int64"))] == 1).all()
    assert coords[:, 2].max() - coords[:, 2].min() > 10


def test_skeleton_workflow_random_objects_match_jax(tmp_path):
    seg = _random_objects(seed=6)
    jax_s, port_s = _both(tmp_path, lambda e: _skeletons(e, seg))
    for lbl, coords in port_s.items():
        if jax_s[lbl] is None:
            assert coords is None, lbl
            continue
        np.testing.assert_array_equal(coords, jax_s[lbl])
        assert (seg[tuple(coords.T.astype("int64"))] == lbl).all()


def test_skeleton_evaluation_matches_jax(tmp_path):
    """The JAX package's test_skeleton_evaluation, and a second run against
    a segmentation that merges two objects and splits a third."""
    seg = _random_objects(seed=7)
    gt_seg = seg.copy()
    gt_seg[gt_seg == 2] = 1
    gt_seg[:, :, :10][gt_seg[:, :, :10] == 3] = 40

    def run(env):
        _skeletons(env, seg)
        _write(env, "gt_seg", gt_seg)
        out = {}
        for key in ("seg", "gt_seg"):
            out_json = os.path.join(os.path.dirname(env.path),
                                    f"eval_{key}.json")
            ev = env.skeletons.SkeletonEvaluation(
                skeleton_path=env.path, skeleton_key="skeletons",
                seg_path=env.path, seg_key=key,
                n_labels=int(seg.max()) + 1, output_path=out_json,
                **dict(env.common, tmp_folder=env.common["tmp_folder"]
                       + key))
            assert env.M.build([ev], raise_on_failure=True)
            with open(out_json) as f:
                out[key] = json.load(f)
        return out

    jax_r, port_r = _both(tmp_path, run)
    assert port_r == jax_r
    assert port_r["seg"]["mean_correctness"] == 1.0
    assert port_r["seg"]["n_false_merges"] == 0
    assert port_r["gt_seg"]["n_false_merges"] >= 1


def test_upsample_skeletons_matches_jax(tmp_path):
    """The JAX package's test_upsample_skeletons, run on both packages."""
    seg = np.zeros((16, 16, 48), "uint64")
    seg[4:12, 4:12, 4:44] = 1
    ds_seg = seg[::2, ::2, ::2]

    def run(env):
        _write(env, "seg", seg, max_id=False, chunks=(16, 16, 16))
        _write(env, "seg_s1", ds_seg)
        wf = env.skeletons.SkeletonWorkflow(
            input_path=env.path, input_key="seg_s1", output_path=env.path,
            output_key="skel_s1", **env.common)
        up = env.skeletons.UpsampleSkeletons(
            skeleton_path=env.path, skeleton_key="skel_s1",
            output_path=env.path, output_key="skel_s0", scale_factor=2,
            n_labels=2, seg_path=env.path, seg_key="seg", dependency=wf,
            **env.common)
        assert env.M.build([up], raise_on_failure=True)
        return (env.skeletons.load_skeleton(env.path, "skel_s1", 1),
                env.skeletons.load_skeleton(env.path, "skel_s0", 1))

    (jlo, jhi), (lo, hi) = _both(tmp_path, run)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    assert hi is not None and 0 < len(hi) <= len(lo)
    assert hi[:, 2].max() > ds_seg.shape[2]
    assert (seg[tuple(hi.T.astype("int64"))] == 1).all()


def test_skeletons_read_across_packages(tmp_path):
    """Skeleton datasets written by one package load with the other's
    ``load_skeleton``."""
    from cluster_tools_tpu.workflows.skeletons import \
        load_skeleton as jax_load
    from cluster_tools_tpu_torch.workflows.skeletons import \
        load_skeleton as port_load

    seg = _random_objects(seed=8)
    jax_s, port_s = _both(tmp_path, lambda e: _skeletons(e, seg))
    for lbl in jax_s:
        a = port_load(str(tmp_path / "jax" / "d.n5"), "skeletons", lbl)
        b = jax_load(str(tmp_path / "torch" / "d.n5"), "skeletons", lbl)
        if jax_s[lbl] is None:
            assert a is None and b is None
            continue
        np.testing.assert_array_equal(a, jax_s[lbl])
        np.testing.assert_array_equal(b, port_s[lbl])
