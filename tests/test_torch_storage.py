"""The port's chunk engine (numpy + zlib/gzip) against the JAX package's
tensorstore-backed storage, in both directions: N5 raw/gzip and zarr
null/zlib, uint8/uint64/float32, ragged edge chunks, partial (read-
modify-write) chunk writes and missing chunks.  Exact."""

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


def test_unported_formats_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_reader(str(tmp_path / "d.h5"))
    with port_reader(str(tmp_path / "d.zarr")) as f:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            f.require_dataset("x", shape=(4,), dtype="uint8",
                              compression="blosc")


def test_config_dirs_read_unchanged_across_packages(tmp_path):
    """A config directory the JAX package writes is read by the port with
    the same keys and values (the port adds only ``device``), and the
    fused task's defaults are the JAX package's."""
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
    assert port_global == {**jax_global, "device": "cuda"}
    defaults = FusedSegmentationBlocks.default_task_config()
    assert defaults == JaxFused.default_task_config()
    assert ConfigDir(cfg).task_config("fused_segmentation", defaults) == \
        JaxConfigDir(cfg).task_config("fused_segmentation",
                                      JaxFused.default_task_config())
