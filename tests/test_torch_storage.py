"""The port's chunk engine (numpy + zlib/gzip + its own blosc and HDF5)
against the JAX package's tensorstore- and h5py-backed storage, in both
directions: N5 raw/gzip, zarr null/zlib/blosc and HDF5, uint8/uint64/
float32, ragged edge chunks, partial (read-modify-write) chunk writes and
missing chunks.  Exact."""

import itertools

import numpy as np
import pytest

from cluster_tools_tpu.core.storage import file_reader as jax_reader
from cluster_tools_tpu_torch.core.storage import file_reader as port_reader

CASES = list(itertools.product(["n5", "zarr"], ["raw", "gzip"],
                               ["uint8", "uint64", "float32"]))
SHAPE, CHUNKS = (9, 13, 7), (4, 5, 3)


def _data(dtype, seed):
    rng = np.random.RandomState(seed)
    if dtype == "uint64":
        return rng.randint(0, 2 ** 62, SHAPE, dtype=np.uint64)
    return (rng.rand(*SHAPE) * 250).astype(dtype)


def _write(reader, path, key, data, compression):
    """Write all but the last z-slab (those chunks stay missing), then a
    region that cuts through chunks (read-modify-write)."""
    with reader(path) as f:
        ds = f.require_dataset(key, shape=data.shape, chunks=CHUNKS,
                               dtype=data.dtype, compression=compression)
        ds[:7] = data[:7]
        ds[2:5, 3:9, 1:6] = data[2:5, 3:9, 1:6] + 1
    want = data.copy()
    want[7:] = 0
    want[2:5, 3:9, 1:6] += 1
    return want


@pytest.mark.parametrize("ext,comp,dtype", CASES)
def test_port_reads_jax_written(tmp_path, ext, comp, dtype):
    data = _data(dtype, seed=len(ext + comp + dtype))
    path = str(tmp_path / f"d.{ext}")
    want = _write(jax_reader, path, "x", data, comp)
    with port_reader(path, "r") as f:
        ds = f["x"]
        assert ds.shape == SHAPE and ds.chunks == CHUNKS
        assert ds.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(ds[:], want)
        np.testing.assert_array_equal(ds[3, 2:11, -4:], want[3, 2:11, -4:])
        assert ds.read_chunk((2, 0, 0)) is None     # never written


@pytest.mark.parametrize("ext,comp,dtype", CASES)
def test_jax_reads_port_written(tmp_path, ext, comp, dtype):
    data = _data(dtype, seed=len(ext + comp + dtype) + 1)
    path = str(tmp_path / f"d.{ext}")
    want = _write(port_reader, path, "grp/x", data, comp)
    with jax_reader(path, "r") as f:
        np.testing.assert_array_equal(f["grp/x"][:], want)
    with port_reader(path, "r") as f:
        np.testing.assert_array_equal(f["grp/x"][:], want)


def test_attrs_and_varlen_roundtrip(tmp_path):
    from cluster_tools_tpu_torch.core.storage import VarlenDataset

    path = str(tmp_path / "d.n5")
    with port_reader(path) as f:
        ds = f.require_dataset("seg", shape=(4, 4), chunks=(2, 2),
                               dtype="uint64")
        ds.attrs["maxId"] = 17
        with pytest.raises(KeyError):
            ds.attrs["dimensions"] = [1]
    with jax_reader(path, "r") as f:
        assert f["seg"].attrs["maxId"] == 17
        np.testing.assert_array_equal(f["seg"][:], np.zeros((4, 4)))
    vl = VarlenDataset(str(tmp_path / "v"), dtype="uint64")
    vl.write_chunk((1, 2), np.arange(5))
    np.testing.assert_array_equal(vl.read_chunk((1, 2)), np.arange(5))
    assert vl.read_chunk((0, 0)) is None and vl.chunk_ids() == [(1, 2)]


@pytest.mark.parametrize("ext,comp", [("zarr", "blosc"), ("h5", "gzip"),
                                      ("h5", "raw")])
def test_blosc_and_hdf5_roundtrips(tmp_path, ext, comp):
    """Blosc zarr and ``.h5`` (once refused by the port) in both
    directions: each package reads what the other wrote, partial chunk
    writes and missing chunks included."""
    data = _data("uint64", seed=11)
    for writer, reader in ((port_reader, jax_reader),
                           (jax_reader, port_reader)):
        path = str(tmp_path / f"{writer.__module__.split('.')[0]}.{ext}")
        want = _write(writer, path, "grp/x", data, comp)
        with reader(path, "r") as f:
            ds = f["grp/x"]
            assert ds.shape == SHAPE and tuple(ds.chunks) == CHUNKS
            assert ds.dtype == np.uint64
            np.testing.assert_array_equal(ds[:], want)
            np.testing.assert_array_equal(ds[3, 2:11, 3:], want[3, 2:11, 3:])


@pytest.mark.parametrize("dtype", ["uint8", "uint64", "float32"])
def test_n5_blosc_creation_matches_jax(tmp_path, dtype):
    """``N5File.require_dataset(..., compression="blosc")`` writes what the
    JAX package writes: raw chunks, ``{"type": "raw"}`` in
    ``attributes.json``; the metadata equals the JAX package's and every
    chunk file is byte for byte the JAX package's."""
    import json
    import os

    data = _data(dtype, seed=12)
    trees = {}
    for name, reader in (("jax", jax_reader), ("port", port_reader)):
        path = str(tmp_path / f"{name}.n5")
        with reader(path) as f:
            ds = f.require_dataset("x", shape=SHAPE, chunks=CHUNKS,
                                   dtype=dtype, compression="blosc")
            ds[...] = data
        root = os.path.join(path, "x")
        files = {}
        for dirpath, _, names in os.walk(root):
            for n in names:
                full = os.path.join(dirpath, n)
                with open(full, "rb") as fh:
                    files[os.path.relpath(full, root)] = fh.read()
        trees[name] = files
    meta = {k: json.loads(v["attributes.json"]) for k, v in trees.items()}
    assert meta["port"] == meta["jax"]
    assert meta["port"]["compression"] == {"type": "raw"}
    assert trees["port"].keys() == trees["jax"].keys()
    chunks = [k for k in trees["jax"] if k != "attributes.json"]
    assert len(chunks) == 3 * 3 * 3
    for key in chunks:
        assert trees["port"][key] == trees["jax"][key], key
    with port_reader(str(tmp_path / "jax.n5"), "r") as f:
        np.testing.assert_array_equal(f["x"][...], data)


def test_config_dirs_read_unchanged_across_packages(tmp_path):
    """A config directory the JAX package writes is read by the port with
    the same keys and values (the port adds only ``device`` and
    ``mesh_devices``, the shards of its device meshes), and the fused
    task's defaults are the JAX package's."""
    from cluster_tools_tpu.core.config import ConfigDir as JaxConfigDir
    from cluster_tools_tpu.workflows.fused_pipeline import \
        FusedSegmentationBlocks as JaxFused
    from cluster_tools_tpu_torch.core.config import ConfigDir
    from cluster_tools_tpu_torch.workflows.fused_pipeline import \
        FusedSegmentationBlocks

    cfg = str(tmp_path / "cfg")
    JaxConfigDir(cfg).write_global_config({"block_shape": [8, 16, 16]})
    JaxConfigDir(cfg).write_task_config("fused_segmentation",
                                        {"threshold": 0.4, "e_max": 4096})
    jax_global = JaxConfigDir(cfg).global_config()
    port_global = ConfigDir(cfg).global_config()
    assert port_global == {**jax_global, "device": "cuda",
                           "mesh_devices": 0}
    defaults = FusedSegmentationBlocks.default_task_config()
    assert defaults == JaxFused.default_task_config()
    assert ConfigDir(cfg).task_config("fused_segmentation", defaults) == \
        JaxConfigDir(cfg).task_config("fused_segmentation",
                                      JaxFused.default_task_config())


@pytest.mark.parametrize("ext", ["raw", "png"])
def test_knossos_dataset_matches_jax(tmp_path, ext):
    """``tests/test_utils.py::test_knossos_dataset`` on the port beside the
    JAX package: a 2x1x1-cube pyramid level (raw cubes, and PNG cubes
    read through imageio), read whole and across the cube boundary, equal
    to the cubes and to the JAX package's reads."""
    import os

    from cluster_tools_tpu.utils.knossos import KnossosFile as JaxKnossos
    from cluster_tools_tpu_torch.utils import KnossosDataset, KnossosFile

    bs = KnossosDataset.block_size
    root = tmp_path / "mag1"
    rng = np.random.RandomState(0)
    cubes = {}
    for gx in range(2):
        d = root / f"x{gx:04d}" / "y0000" / "z0000"
        os.makedirs(d)
        cube = rng.randint(0, 255, size=(bs, bs, bs), dtype=np.uint8)
        cubes[gx] = cube
        name = str(d / f"x{gx:04d}_y0000_z0000.{ext}")
        if ext == "raw":
            cube.tofile(name)
        else:
            import imageio.v2 as imageio
            imageio.imwrite(name, cube.reshape(bs * bs, bs))
    ds = KnossosFile(str(tmp_path))["mag1"]
    ref = JaxKnossos(str(tmp_path))["mag1"]
    assert ds.shape == ref.shape == (bs, bs, 2 * bs)
    assert ds.dtype == np.uint8 and ds.chunks == ref.chunks
    np.testing.assert_array_equal(ds[:, :, :bs], cubes[0])
    np.testing.assert_array_equal(ds[:, :, bs:], cubes[1])
    sub = ds[10:20, 0:5, bs - 4:bs + 4]
    np.testing.assert_array_equal(sub, ref[10:20, 0:5, bs - 4:bs + 4])
    np.testing.assert_array_equal(sub[..., :4], cubes[0][10:20, 0:5, -4:])
    np.testing.assert_array_equal(sub[..., 4:], cubes[1][10:20, 0:5, :4])
    np.testing.assert_array_equal(ds[5, :, 130], ref[5, :, 130])


def test_knossos_prefix_discovery_and_file_reader(tmp_path):
    """The JAX package's test of the same name on the port: the
    experiment prefix is discovered and ``file_reader(".knossos")``
    dispatches to the read-only Knossos file; a missing cube reads as
    zeros."""
    import os

    from cluster_tools_tpu_torch.utils.knossos import KnossosDataset

    bs = KnossosDataset.block_size
    root = tmp_path / "vol.knossos" / "mag1"
    d = root / "x0000" / "y0000" / "z0000"
    os.makedirs(d)
    os.makedirs(root / "x0000" / "y0000" / "z0001")
    cube = np.random.RandomState(0).randint(0, 255, size=(bs, bs, bs),
                                            dtype=np.uint8)
    cube.tofile(str(d / "experiment_mag1_x0000_y0000_z0000.raw"))
    with port_reader(str(tmp_path / "vol.knossos"), "r") as f:
        ds = f["mag1"]
        assert ds.file_prefix == "experiment_mag1" and ds.ext == "raw"
        assert ds.shape == (2 * bs, bs, bs)
        np.testing.assert_array_equal(ds[:bs], cube)
        assert not ds[bs:].any()
        with pytest.raises(KeyError):
            f["mag2"]
    with pytest.raises(ValueError, match="read-only"):
        from cluster_tools_tpu_torch.utils import KnossosFile
        KnossosFile(str(tmp_path / "vol.knossos"), mode="a")
