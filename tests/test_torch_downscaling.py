"""Multiscale pyramids, up-scaling, volume copies and the object fit of the
port (``workflows/downscaling.py``, ``workflows/copy_volume.py``) against
the JAX package, on the CPU.

Labels are exact (nearest, majority, ``fit_to_hmap``,
``ScaleToBoundariesTask``).  The linear resize is jax.image.resize's
scale-and-translate (antialiased when it downsamples), held within 1e-6;
float pooling within rtol 1e-6 (the window sums in another order).  The
JAX seeded watershed compiles once per shape, so the object fits run on
tiny volumes."""

import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch


def _pkg(pkg):
    if pkg == "jax":
        import cluster_tools_tpu as M
        from cluster_tools_tpu.core.config import ConfigDir
        from cluster_tools_tpu.workflows import copy_volume as C
        from cluster_tools_tpu.workflows import downscaling as D
        return M, ConfigDir, D, C, {}, "threads"
    import cluster_tools_tpu_torch as M
    from cluster_tools_tpu_torch.core.config import ConfigDir
    from cluster_tools_tpu_torch.workflows import copy_volume as C
    from cluster_tools_tpu_torch.workflows import downscaling as D
    return M, ConfigDir, D, C, {"device": "cpu"}, "threads"


def _setup(pkg, root, inputs, chunks=(8, 8, 8), task_cfgs=None,
           block_shape=(8, 8, 8)):
    M, ConfigDir, D, C, extra, target = _pkg(pkg)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "d.n5")
    with M.file_reader(path) as f:
        for key, data in inputs.items():
            ch = ([data.shape[0]] if data.ndim == 4 else []) + list(chunks)
            f.require_dataset(key, shape=data.shape, chunks=ch,
                              dtype=str(data.dtype))[:] = data
    cfg = os.path.join(root, "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": list(block_shape),
                                        "max_num_retries": 0, **extra})
    for name, tc in (task_cfgs or {}).items():
        ConfigDir(cfg).write_task_config(name, tc)
    common = dict(tmp_folder=os.path.join(root, "tmp"), config_dir=cfg,
                  max_jobs=2, target=target)
    return M, D, C, path, common


def _read(M, path, key):
    with M.file_reader(path, "r") as f:
        return f[key][:]


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

def test_downsample_samplers_oracle():
    """The JAX package's sampler oracle on the port."""
    from cluster_tools_tpu_torch.workflows.downscaling import (downsample,
                                                               upsample)

    x = np.arange(4 * 4 * 4, dtype="float32").reshape(4, 4, 4)
    mean = downsample(x, [2, 2, 2], "mean", device="cpu")
    assert mean.shape == (2, 2, 2)
    np.testing.assert_allclose(mean[0, 0, 0], x[:2, :2, :2].mean())
    mx = downsample(x, [2, 2, 2], "max", device="cpu")
    np.testing.assert_allclose(mx[0, 0, 0], x[:2, :2, :2].max())
    labels = np.zeros((4, 4, 4), "uint64")
    labels[:, :, 2:] = 7
    near = downsample(labels, [2, 2, 2], "nearest", device="cpu")
    assert set(np.unique(near)) <= {0, 7}
    assert set(np.unique(downsample(labels, [2, 2, 2], "majority",
                                    device="cpu"))) <= {0, 7}
    mixed = np.zeros((2, 2, 2), "uint64")
    mixed[0, 0, 0] = 5
    assert downsample(mixed, [2, 2, 2], "majority", device="cpu")[0, 0, 0] \
        == 0
    assert upsample(near, [2, 2, 2], "nearest", device="cpu").shape == \
        (4, 4, 4)
    assert downsample(x, [1, 2, 2], "mean", device="cpu").shape == (4, 2, 2)
    with pytest.raises(KeyError):
        downsample(x, [2, 2, 2], "median", device="cpu")


@pytest.mark.parametrize("sampler", ["mean", "max", "min", "nearest",
                                     "majority"])
@pytest.mark.parametrize("dtype", ["float32", "uint8", "uint64"])
def test_downsample_matches_jax(sampler, dtype):
    """Odd shapes (the upper border padded by repeating the edge) and
    anisotropic factors: integer outputs exact, float pooling within
    rtol 1e-6."""
    from cluster_tools_tpu.workflows.downscaling import downsample as jds

    from cluster_tools_tpu_torch.workflows.downscaling import downsample

    rng = np.random.RandomState(1)
    x = (rng.rand(9, 13, 11) * 200).astype(dtype)
    if dtype == "uint64":
        x = (x // 50).astype(dtype)
    for factor in ([2, 2, 2], [1, 2, 2], [3, 2, 4]):
        got = downsample(x, factor, sampler, device="cpu")
        want = jds(x, factor, sampler)
        assert got.dtype == want.dtype and got.shape == want.shape
        if dtype == "float32" and sampler == "mean":
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


def test_majority_pool_and_windows_match_jax():
    from cluster_tools_tpu.workflows import downscaling as J

    from cluster_tools_tpu_torch.workflows import downscaling as P

    x = np.random.RandomState(2).randint(0, 4, (7, 10, 9)).astype("uint64")
    for factor in ([2, 2, 2], [1, 3, 2]):
        out_shape = tuple(-(-s // f) for s, f in zip(x.shape, factor))
        np.testing.assert_array_equal(
            P.pooling_windows(x, factor, out_shape),
            J.pooling_windows(x, factor, out_shape))
        np.testing.assert_array_equal(P._majority_pool(x, factor, out_shape),
                                      J._majority_pool(x, factor, out_shape))


@pytest.mark.parametrize("in_shape,out_shape", [
    ((16, 16, 16), (8, 8, 8)), ((13, 17, 9), (5, 6, 3)),
    ((9, 11, 10), (9, 4, 5)), ((5, 6, 7), (10, 12, 14)),
    ((4, 7, 5), (4, 21, 15)), ((6, 9, 8), (3, 27, 8))])
def test_linear_resize_matches_jax_image_resize(in_shape, out_shape):
    """The antialiased triangle kernel when downsampling (widened by the
    inverse scale, renormalized at the border) and plain linear
    interpolation when upsampling: within 1e-6 of jax.image.resize at
    several factors and odd sizes, where torch's trilinear interpolation
    differs by up to 0.12."""
    import jax
    import jax.numpy as jnp

    from cluster_tools_tpu_torch.workflows.downscaling import linear_resize

    x = np.random.RandomState(3).rand(*in_shape).astype("float32")
    want = np.asarray(jax.image.resize(jnp.asarray(x), out_shape,
                                       method="linear"))
    got = linear_resize(torch.from_numpy(x), out_shape).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("factor", [[2, 2, 2], [1, 2, 2], [1, 3, 3]])
def test_interpolate_samplers_match_jax(factor):
    from cluster_tools_tpu.workflows.downscaling import downsample as jds
    from cluster_tools_tpu.workflows.downscaling import upsample as jus

    from cluster_tools_tpu_torch.workflows.downscaling import (downsample,
                                                               upsample)

    x = np.random.RandomState(4).rand(7, 12, 13).astype("float32")
    np.testing.assert_allclose(downsample(x, factor, "interpolate",
                                          device="cpu"),
                               jds(x, factor, "interpolate"), atol=1e-6)
    np.testing.assert_allclose(upsample(x, factor, "interpolate",
                                        device="cpu"),
                               jus(x, factor, "interpolate"), atol=1e-6)
    u8 = (x * 255).astype("uint8")
    got = downsample(u8, factor, "interpolate", device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, jds(u8, factor, "interpolate"),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(upsample(u8, factor, device="cpu"),
                                  jus(u8, factor))


# ---------------------------------------------------------------------------
# pyramid workflows
# ---------------------------------------------------------------------------

def _pyramid(pkg, root, vol, **wf_kw):
    M, D, C, path, common = _setup(pkg, root, {"raw/s0": vol})
    wf = D.DownscalingWorkflow(
        input_path=path, input_key="raw/s0",
        scale_factors=[[1, 2, 2], [2, 2, 2]], output_key_prefix="raw",
        metadata_dict={"resolution": [40.0, 4.0, 4.0]}, **wf_kw, **common)
    assert M.build([wf], raise_on_failure=True)
    with M.file_reader(path, "r") as f:
        return (f["raw/s1"][:], f["raw/s2"][:],
                f["raw/s1"].attrs.get("downsamplingFactors"),
                f["raw/s2"].attrs.get("downsamplingFactors"),
                {k: f["raw"].attrs.get(k)
                 for k in ("multiScale", "resolution", "offset")})


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_downscaling_workflow_matches_jax(tmp_path, dtype):
    vol = np.random.RandomState(0).rand(16, 32, 30).astype("float32")
    if dtype == "uint8":
        vol = (vol * 255).astype("uint8")
    jx = _pyramid("jax", str(tmp_path / "jax"), vol)
    pt = _pyramid("torch", str(tmp_path / "torch"), vol)
    for a, b in zip(pt[:2], jx[:2]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-6)
    assert pt[2:] == jx[2:]
    assert pt[2] == [2, 2, 1] and pt[3] == [4, 4, 2]
    assert pt[4]["multiScale"] is True
    assert pt[4]["resolution"] == [4.0, 4.0, 40.0]
    s1 = pt[0]
    np.testing.assert_allclose(s1[0, 0, 0], vol[0, :2, :2].mean(),
                               rtol=1e-5, atol=0.5 if dtype == "uint8"
                               else 0)
    if dtype == "uint8":
        # the window mean of uint8 is exact in float32 and rounds like
        # numpy
        want = np.round(vol.astype("float64").reshape(
            16, 16, 2, 15, 2).mean(axis=(2, 4))).astype("uint8")
        np.testing.assert_array_equal(s1, want)


def test_downscaling_bdv_metadata(tmp_path):
    """metadata_format='bdv' writes the setup attributes and the SpimData
    XML sidecar (the JAX package's test on the port)."""
    vol = np.random.RandomState(1).rand(8, 16, 16).astype("float32")
    M, D, C, path, common = _setup("torch", str(tmp_path),
                                   {"setup0/timepoint0/s0": vol})
    wf = D.DownscalingWorkflow(
        input_path=path, input_key="setup0/timepoint0/s0",
        scale_factors=[[2, 2, 2]], output_key_prefix="setup0/timepoint0",
        metadata_dict={"resolution": [40.0, 4.0, 4.0],
                       "offsets": [0.0, 8.0, 8.0], "unit": "nanometer"},
        metadata_format="bdv", **common)
    assert M.build([wf], raise_on_failure=True)
    root = ET.parse(str(tmp_path / "d.xml")).getroot()
    assert root.tag == "SpimData"
    assert [int(s) for s in root.find(".//ViewSetup/size").text.split()] \
        == [16, 16, 8]
    assert [float(v) for v in root.find(".//voxelSize/size").text.split()] \
        == [4.0, 4.0, 40.0]
    assert root.find(".//voxelSize/unit").text == "nanometer"
    affine = [float(a) for a in root.find(".//affine").text.split()]
    assert affine[0] == 4.0 and affine[5] == 4.0 and affine[10] == 40.0
    assert affine[7] == 8.0 and affine[11] == 0.0
    with M.file_reader(path, "r") as f:
        setup_attrs = f.require_group("setup0").attrs
        assert setup_attrs["downsamplingFactors"] == [[1, 1, 1], [2, 2, 2]]
        assert setup_attrs["dataType"] == "float32"
        assert f["setup0/timepoint0/s1"].shape == (4, 8, 8)
    with pytest.raises(ValueError, match="scale_offset"):
        D.WriteDownscalingMetadata(tmp_folder=str(tmp_path), output_path=path,
                                   scale_factors=[[2, 2, 2]], scale_offset=1,
                                   metadata_format="bdv")


def test_copy_volume_matches_jax(tmp_path):
    """Requantization float32 -> uint8 with re-chunking, then the channel
    mean of a 4-d stack; and uint16 -> uint8."""
    rng = np.random.RandomState(0)
    vol = rng.rand(16, 16, 16).astype("float32")
    affs = rng.rand(3, 16, 16, 16).astype("float32")
    u16 = (rng.rand(16, 16, 16) * 65535).astype("uint16")
    out = {}
    for pkg in ("jax", "torch"):
        M, D, C, path, common = _setup(pkg, str(tmp_path / pkg),
                                       {"raw": vol, "affs": affs,
                                        "u16": u16})
        tasks = [C.CopyVolumeTask(input_path=path, input_key="raw",
                                  output_path=path, output_key="raw_u8",
                                  dtype="uint8", chunks=[16, 16, 16],
                                  **common),
                 C.CopyVolumeTask(input_path=path, input_key="affs",
                                  output_path=path, output_key="bmap",
                                  reduce_channels="mean",
                                  identifier="reduce", **common),
                 C.CopyVolumeTask(input_path=path, input_key="u16",
                                  output_path=path, output_key="u8",
                                  dtype="uint8", identifier="requant",
                                  **common)]
        assert M.build(tasks, raise_on_failure=True)
        with M.file_reader(path, "r") as f:
            assert f["raw_u8"].dtype == np.uint8
            assert tuple(f["raw_u8"].chunks) == (16, 16, 16)
            out[pkg] = [f[k][:] for k in ("raw_u8", "bmap", "u8")]
    for a, b in zip(out["torch"], out["jax"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(out["torch"][0], np.round(vol * 255), atol=1)
    np.testing.assert_allclose(out["torch"][1], affs.mean(0), rtol=1e-5)


@pytest.mark.parametrize("sampler", ["nearest", "interpolate"])
def test_upscale_task_matches_jax(tmp_path, sampler):
    rng = np.random.RandomState(0)
    coarse = rng.randint(0, 9, size=(8, 8, 8)).astype("uint64")
    volf = rng.rand(8, 8, 8).astype("float32")
    vol8 = (volf * 255).astype("uint8")
    out = {}
    for pkg in ("jax", "torch"):
        M, D, C, path, common = _setup(
            pkg, str(tmp_path / pkg), {"coarse": coarse, "volf": volf,
                                       "vol8": vol8},
            task_cfgs={"upscaling": {"sampler": sampler}})
        keys = ("coarse", "volf", "vol8") if sampler == "interpolate" \
            else ("coarse",)
        tasks = [D.UpscaleTask(input_path=path, input_key=k,
                               output_path=path, output_key=f"fine_{k}",
                               scale_factor=[1, 2, 2] if k != "coarse"
                               else [2, 2, 2], identifier=k, **common)
                 for k in keys]
        assert M.build(tasks, raise_on_failure=True)
        out[pkg] = [_read(M, path, f"fine_{k}") for k in keys]
    for a, b in zip(out["torch"], out["jax"]):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, atol=1e-6)
        else:
            np.testing.assert_array_equal(a, b)
    if sampler == "nearest":
        np.testing.assert_array_equal(out["torch"][0], np.repeat(np.repeat(
            np.repeat(coarse, 2, 0), 2, 1), 2, 2))
    else:
        finef = out["torch"][1]
        assert finef.shape == (8, 16, 16)
        assert volf.min() - 1e-5 <= finef.min() <= finef.max() <= \
            volf.max() + 1e-5


def test_paintera_to_bdv_matches_jax(tmp_path):
    vol = np.random.RandomState(0).randint(0, 100, (8, 16, 16)
                                           ).astype("uint64")
    s1 = vol[:, ::2, ::2]
    outs = {}
    for pkg in ("jax", "torch"):
        M, D, C, path, common = _setup(pkg, str(tmp_path / pkg), {
            "seg/data/s0": vol, "seg/data/s1": s1})
        with M.file_reader(path) as f:
            f["seg/data/s1"].attrs["downsamplingFactors"] = [2, 2, 1]
            g = f.require_group("seg/data")
            g.attrs["resolution"] = [4.0, 4.0, 40.0]
            g.attrs["offset"] = [0.0, 0.0, 0.0]
        out_path = str(tmp_path / pkg / "bdv.n5")
        wf = D.PainteraToBdvWorkflow(input_path=path,
                                     input_key_prefix="seg/data",
                                     output_path=out_path, **common)
        assert M.build([wf], raise_on_failure=True)
        with M.file_reader(out_path, "r") as f:
            outs[pkg] = (f["setup0/timepoint0/s0"][:],
                         f["setup0/timepoint0/s1"][:],
                         dict(f["setup0"].attrs))
        with open(str(tmp_path / pkg / "bdv.xml")) as fh:
            outs[pkg] += (fh.read(),)
    pt, jx = outs["torch"], outs["jax"]
    np.testing.assert_array_equal(pt[0], vol)
    np.testing.assert_array_equal(pt[1], s1)
    np.testing.assert_array_equal(pt[1], jx[1])
    assert pt[2] == jx[2]
    assert pt[2]["downsamplingFactors"] == [[1, 1, 1], [2, 2, 1]]
    assert pt[2]["dataType"] == "uint64"
    assert "4.0 4.0 40.0" in pt[3]
    assert ET.fromstring(pt[3]).find(".//ViewSetup/size").text == \
        ET.fromstring(jx[3]).find(".//ViewSetup/size").text


# ---------------------------------------------------------------------------
# fitting objects to boundaries
# ---------------------------------------------------------------------------

def _objects(shape=(12, 24, 24)):
    objs = np.zeros(shape, "uint64")
    objs[2:9, 3:12, 4:14] = 5
    objs[3:10, 14:22, 6:20] = 9
    objs[0:2, 0:3, 20:24] = 11      # small: its erosion halves to 1
    return objs


def _naive_seeds(objs, bg_id, erode_by, max_erode):
    """The JAX package's seeds: every erosion over the whole array."""
    from scipy.ndimage import binary_erosion

    from cluster_tools_tpu_torch.workflows.downscaling import \
        _preserving_erosion

    seeds = (bg_id * binary_erosion(objs == 0, iterations=max_erode)
             ).astype("uint32")
    for obj_id in np.unique(objs[objs != 0]):
        mask = objs == obj_id
        er = erode_by[int(obj_id)] if isinstance(erode_by, dict) else erode_by
        seeds[_preserving_erosion(mask, er)] = obj_id
    return seeds


@pytest.mark.parametrize("erode_by", [1, 2, 4, {5: 3, 9: 1, 11: 2}])
def test_bounding_box_erosions_equal_whole_block(erode_by):
    """The erosions on each object's bounding box give the seeds of the
    erosions over the whole block (border_value 0 on both), in 3-d and per
    slice."""
    from cluster_tools_tpu_torch.workflows.downscaling import _fit_seeds

    objs = _objects()
    max_erode = max(erode_by.values()) if isinstance(erode_by, dict) \
        else erode_by
    np.testing.assert_array_equal(_fit_seeds(objs, 12, erode_by, max_erode),
                                  _naive_seeds(objs, 12, erode_by, max_erode))
    for z in (0, 5):
        np.testing.assert_array_equal(
            _fit_seeds(objs[z], 12, erode_by, max_erode),
            _naive_seeds(objs[z], 12, erode_by, max_erode))


@pytest.fixture(scope="module")
def fit_reference():
    """The JAX package's fit_to_hmap on the tiny instance, once per
    module: 3-d and per slice, an int and a per-object erode_by."""
    from cluster_tools_tpu.workflows.downscaling import fit_to_hmap

    objs = _objects()
    hmap = np.random.RandomState(0).rand(*objs.shape).astype("float32")
    hmap[:, :, 12:14] += 2.0
    cases = {}
    for fit_3d in (True, False):
        for erode_by in (2, {5: 3, 9: 1, 11: 2}):
            key = (fit_3d, str(erode_by))
            cases[key] = (erode_by, fit_to_hmap(objs, hmap, erode_by,
                                                fit_3d=fit_3d))
    return objs, hmap, cases


@pytest.mark.parametrize("fit_3d", [True, False])
@pytest.mark.parametrize("erode", ["int", "dict"])
def test_fit_to_hmap_matches_jax(fit_reference, fit_3d, erode):
    from cluster_tools_tpu_torch.workflows.downscaling import fit_to_hmap

    objs, hmap, cases = fit_reference
    key = [k for k in cases if k[0] == fit_3d
           and (k[1].startswith("{") == (erode == "dict"))][0]
    erode_by, want = cases[key]
    got = fit_to_hmap(objs, hmap, erode_by, fit_3d=fit_3d, device="cpu")
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)


def test_fit_to_hmap_launch_count_on_a_card():
    """The kernel launches of the fit: 3 in 3-d, 2 per block per slice
    (one EDT of the stack over its in-plane axes)."""
    import unittest.mock as mock

    from cluster_tools_tpu_torch.ops import edt
    from cluster_tools_tpu_torch.workflows.downscaling import fit_to_hmap

    calls = []
    real = edt.distance_transform_edt

    def spy(mask, sampling=None, axes=None):
        calls.append(3 if axes is None else len(axes))
        return real(mask, sampling, axes)

    objs = _objects()
    hmap = np.random.RandomState(1).rand(*objs.shape).astype("float32")
    with mock.patch.object(edt, "distance_transform_edt", spy):
        fit_to_hmap(objs, hmap, 2, fit_3d=True, device="cpu")
        fit_to_hmap(objs, hmap, 2, fit_3d=False, device="cpu")
    assert calls == [3, 2]


def _scale(pkg, root, objs_lr, bnd, task_cfg, offset=100):
    M, D, C, path, common = _setup(
        pkg, root, {"objs": objs_lr, "bnd": bnd},
        task_cfgs={"scale_to_boundaries": task_cfg},
        block_shape=(8, 16, 16))
    task = D.ScaleToBoundariesTask(
        input_path=path, input_key="objs", output_path=path,
        output_key="fitted", boundaries_path=path, boundaries_key="bnd",
        offset=offset, **common)
    assert M.build([task], raise_on_failure=True)
    return _read(M, path, "fitted")


@pytest.mark.parametrize("erode_3d", [True, False])
def test_scale_to_boundaries_matches_jax(tmp_path, erode_3d):
    """The JAX package's slow test at a tier-1 size: coarse objects read
    through the interpolated full-resolution view, fitted to the ridge of
    the boundary map in 2 blocks, offset and accumulated; identical labels
    in both packages, and the object grows to the ridge without leaking
    past it."""
    shape = (8, 16, 32)
    objs_lr = np.zeros((4, 8, 16), "uint64")
    objs_lr[:, :, :3] = 5
    objs_lr[:, :, 10:] = 7
    bnd = np.zeros(shape, "float32")
    bnd[:, :, 8:11] = 1.0
    cfg = {"erode_by": 2, "erode_3d": erode_3d}
    jx = _scale("jax", str(tmp_path / "jax"), objs_lr, bnd, cfg)
    pt = _scale("torch", str(tmp_path / "torch"), objs_lr, bnd, cfg)
    np.testing.assert_array_equal(pt, jx)
    assert set(np.unique(pt).tolist()) <= {0, 105, 107}
    inner = pt[2:6, 4:12, :16]
    assert (inner[:, :, :7] == 105).mean() > 0.9
    assert (inner[:, :, 11:16] != 105).all()


def test_scale_to_boundaries_rejects_ids_of_32_bits(tmp_path):
    from cluster_tools_tpu_torch.core.workflow import BuildError

    objs = np.zeros((8, 16, 16), "uint64")
    objs[2:5, 2:9, 2:9] = 2 ** 31
    with pytest.raises(BuildError):
        _scale("torch", str(tmp_path), objs, np.zeros((8, 16, 16),
                                                      "float32"), {})
    logs = str(tmp_path / "tmp" / "logs")
    assert any("2**31" in open(os.path.join(logs, n)).read()
               for n in os.listdir(logs))


@pytest.mark.parametrize("which", ["downscaling", "upscale", "scale"])
def test_pyramid_tasks_raise_without_a_card(tmp_path, which):
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir

    if torch.cuda.is_available():
        pytest.skip("this check needs a host without a CUDA device")
    path = str(tmp_path / "d.n5")
    with ctp.file_reader(path) as f:
        f.require_dataset("raw", shape=(8, 8, 8), chunks=(8, 8, 8),
                          dtype="uint8")
    cfg = str(tmp_path / "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": [8, 8, 8]})
    common = dict(tmp_folder=str(tmp_path / "tmp"), config_dir=cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if which == "downscaling":
            wf = ctp.DownscalingWorkflow(input_path=path, input_key="raw",
                                         scale_factors=[[1, 2, 2]],
                                         **common)
            assert wf.target == "gpu"
            ctp.build([wf])
        elif which == "upscale":
            ctp.UpscaleTask(input_path=path, input_key="raw",
                            output_path=path, output_key="up",
                            scale_factor=2, **common)
        else:
            ctp.ScaleToBoundariesTask(input_path=path, input_key="raw",
                                      output_path=path, output_key="f",
                                      boundaries_path=path,
                                      boundaries_key="raw", **common)
    with ctp.file_reader(path, "r") as f:
        assert "s1" not in f
