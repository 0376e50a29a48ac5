"""The storage formats the JAX package reads through tensorstore and the
port reads with its own decoders, on the CPU.  Exact.

* the committed fixtures of ``tests/data/torch_formats/`` (written by
  tensorstore and h5py; ``chip_smoke.py`` phase 16e reads them on the
  card's machine) read by both packages' ``file_reader`` to the arrays
  ``make_fixtures.expected`` regenerates;
* zarr's ``zstd`` compressor at levels 1, 3, 19 and 22 on smooth, noisy,
  constant and label data, in chunks over 128 KiB (several zstd blocks),
  and a hypothesis property over random arrays;
* the port's Zstandard decoder on its own: an empty and a 1-byte chunk,
  several frames and skippable frames, content checksums, a frame that
  names a dictionary, corrupt frames;
* zarr F order and ``bz2``, N5 ``bzip2``, ``xz`` and ``zstd``, fresh from
  tensorstore;
* what still raises by name: zarr filters, N5 varlength chunks, unknown
  compressors, writing a format the port only reads.
"""

import json
import os
import sys

import numpy as np
import pytest
import tensorstore as ts
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from cluster_tools_tpu.core.storage import file_reader as jax_reader
from cluster_tools_tpu_torch.core import codecs
from cluster_tools_tpu_torch.core.storage import file_reader as port_reader

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "torch_formats")
sys.path.insert(0, FIXTURES)
import make_fixtures  # noqa: E402


def _both(path, key):
    with jax_reader(path, "r") as f:
        want = f[key][...]
    with port_reader(path, "r") as f:
        got = f[key][...]
    return want, got


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("case", make_fixtures.CASES,
                         ids=[f"{c}-{k}" for c, k, _, _ in
                              make_fixtures.CASES])
def test_committed_fixtures_read_like_the_jax_package(case):
    container, key, name, _ = case
    want, got = _both(os.path.join(FIXTURES, container), key)
    _same(want, make_fixtures.expected(name))
    _same(got, want)


def test_committed_fixtures_groups_and_attributes():
    """``latest.h5``'s dense 30-link group (with soft links) and its 20
    creation-ordered attributes (one a huge heap object) read as h5py
    reads them."""
    import h5py

    path = os.path.join(FIXTURES, "latest.h5")
    with h5py.File(path, "r") as h, port_reader(path, "r") as f:
        assert sorted(f["links"].keys()) == sorted(h["links"].keys())
        for i, name in enumerate(make_fixtures.link_names()):
            assert f[f"links/{name}"][()] == h[f"links/{name}"][()] == i
        assert f["links/relative"][()] == 3
        attrs = f["attrs"].attrs
        assert list(attrs.keys()) == list(h["attrs"].attrs.keys())
        for k, v in make_fixtures.attrs().items():
            np.testing.assert_array_equal(attrs[k], h["attrs"].attrs[k])
            np.testing.assert_array_equal(attrs[k], v)


def _ts_zarr(path, data, compressor, chunks, order="C"):
    t = ts.open({"driver": "zarr", "kvstore": {"driver": "file",
                                               "path": path},
                 "metadata": {"shape": list(data.shape),
                              "chunks": list(chunks),
                              "dtype": data.dtype.str,
                              "compressor": compressor, "order": order},
                 "create": True}).result()
    t[...] = data


def _zarr_root(tmp_path):
    root = tmp_path / "x.zarr"
    root.mkdir()
    (root / ".zgroup").write_text('{"zarr_format": 2}')
    return str(root)


def _kind(kind, shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    n = int(np.prod(shape))
    if kind == "smooth":
        return (np.arange(n) // 5 % 700).astype(dtype).reshape(shape)
    if kind == "noise":
        return rng.randint(0, 255, shape).astype(dtype)
    if kind == "constant":
        return np.full(shape, 77, dtype)
    ids = rng.randint(0, 2 ** 40, n // 23 + 1).astype(np.uint64)
    return np.repeat(ids, 23)[:n].reshape(shape).astype(dtype)


@pytest.mark.parametrize("level", [1, 3, 19, 22])
@pytest.mark.parametrize("kind", ["smooth", "noise", "constant",
                                  "fragments"])
def test_zstd_levels(tmp_path, level, kind):
    """Chunks of 8 * 64 * 72 uint64 (288 KiB: three zstd blocks) and an
    edge chunk; levels 19 and 22 bring treeless literals, repeat offsets
    and large windows."""
    data = _kind(kind, (12, 64, 72), "uint64", seed=level)
    root = _zarr_root(tmp_path)
    _ts_zarr(os.path.join(root, "x"), data, {"id": "zstd", "level": level},
             (8, 64, 72))
    want, got = _both(root, "x")
    _same(want, data)
    _same(got, want)


@settings(max_examples=20, deadline=None)
@given(dtype=st.sampled_from(["uint8", "uint16", "float32"]),
       shape=st.tuples(st.integers(1, 9), st.integers(1, 40),
                       st.integers(1, 40)),
       level=st.integers(1, 22), seed=st.integers(0, 2 ** 31 - 1),
       runs=st.integers(1, 50))
def test_zstd_property(tmp_path_factory, dtype, shape, level, seed, runs):
    """Random arrays (runs of repeated values) through tensorstore's zstd
    zarr read back identically through the port."""
    rng = np.random.RandomState(seed)
    n = int(np.prod(shape))
    vals = rng.randint(0, 2 ** 16 if dtype == "uint16" else 256,
                       n // runs + 1)
    data = np.repeat(vals, runs)[:n].reshape(shape).astype(dtype)
    if dtype == "float32":
        data = data / np.float32(7)
    root = os.path.join(str(tmp_path_factory.mktemp("z")), "x.zarr")
    _ts_zarr(os.path.join(root, "x"), data, {"id": "zstd", "level": level},
             [max(1, s // 2) for s in shape])
    with port_reader(root, "r") as f:
        got = f["x"][...]
    _same(got, data)


def test_zstd_frames_by_hand():
    """Frames tensorstore does not write: empty content, content
    checksums, several frames in a row and skippable frames, without a
    content size."""
    empty = zstandard.ZstdCompressor().compress(b"")
    assert codecs.zstd_decompress(empty, 0).size == 0
    one = zstandard.ZstdCompressor(level=3).compress(b"\x07")
    assert codecs.zstd_decompress(one, 1).tobytes() == b"\x07"
    parts = [bytes(range(256)) * 40, b"", b"abc" * 5000]
    frames = b""
    for i, part in enumerate(parts):
        frames += zstandard.ZstdCompressor(
            level=3 + 8 * i, write_checksum=True,
            write_content_size=bool(i % 2)).compress(part)
        frames += (0x184D2A50 + i).to_bytes(4, "little") + \
            (5).to_bytes(4, "little") + b"skip!"
    plain = b"".join(parts)
    assert codecs.zstd_decompress(frames, len(plain)).tobytes() == plain
    with pytest.raises(ValueError, match="expected"):
        codecs.zstd_decompress(frames, len(plain) + 1)


def test_zstd_one_byte_chunk(tmp_path):
    data = np.array([200], "uint8")
    root = _zarr_root(tmp_path)
    _ts_zarr(os.path.join(root, "x"), data, {"id": "zstd", "level": 3},
             (1,))
    want, got = _both(root, "x")
    _same(want, data)
    _same(got, data)


def test_zstd_dictionary_raises_by_name():
    """A frame whose header names a dictionary (neither tensorstore nor
    numcodecs writes one) raises ``NotImplementedError``."""
    d = zstandard.train_dictionary(4096, [b"label %d " % i * 30
                                          for i in range(400)])
    frame = zstandard.ZstdCompressor(dict_data=d).compress(b"label 7 " * 50)
    with pytest.raises(NotImplementedError, match="dictionar"):
        codecs.zstd_decompress(frame, 400)


def _corrupt_zarr(tmp_path, how):
    """A zstd zarr chunk rewritten with a content checksum (by
    ``zstandard``), then corrupted: ``"header"`` sets the frame header's
    reserved bit, ``"checksum"`` flips a checksum byte, ``"table"`` flips a
    byte of the first block's literals header."""
    data = _kind("smooth", (8, 32, 32), "uint16")
    root = _zarr_root(tmp_path)
    _ts_zarr(os.path.join(root, "x"), data, {"id": "zstd", "level": 3},
             (8, 32, 32))
    chunk = os.path.join(root, "x", "0.0.0")
    frame = bytearray(zstandard.ZstdCompressor(
        level=19, write_checksum=True).compress(data.tobytes()))
    if how == "header":
        frame[4] |= 0x08
    elif how == "checksum":
        frame[-1] ^= 0x5A
    elif how == "table":
        frame[9] ^= 0xFF
    with open(chunk, "wb") as f:
        f.write(bytes(frame))
    return root, data


@pytest.mark.parametrize("how", ["intact", "header", "checksum", "table"])
def test_corrupt_zstd_raises_like_the_jax_package(tmp_path, how):
    root, data = _corrupt_zarr(tmp_path, how)
    if how == "intact":
        want, got = _both(root, "x")
        _same(want, data)
        _same(got, data)
        return
    with pytest.raises(ValueError):
        with jax_reader(root, "r") as f:
            f["x"][...]
    with pytest.raises(ValueError, match="zstd frame"):
        with port_reader(root, "r") as f:
            f["x"][...]


@pytest.mark.parametrize("dtype", ["uint8", ">u2", "<i4", "float64",
                                   "uint64"])
def test_zarr_f_order(tmp_path, dtype):
    data = _kind("fragments", (9, 20, 14), dtype)
    root = _zarr_root(tmp_path)
    _ts_zarr(os.path.join(root, "x"), data, {"id": "zlib", "level": 1},
             (4, 8, 5), order="F")
    want, got = _both(root, "x")
    # both return big-endian zarr data in the native byte order
    _same(want, data.astype(data.dtype.newbyteorder("=")))
    _same(got, want)
    assert got.flags["C_CONTIGUOUS"]


@pytest.mark.parametrize("dtype", ["uint16", "float32"])
def test_zarr_bz2(tmp_path, dtype):
    data = _kind("smooth", (9, 20, 14), dtype)
    root = _zarr_root(tmp_path)
    _ts_zarr(os.path.join(root, "x"), data, {"id": "bz2", "level": 5},
             (4, 8, 5))
    want, got = _both(root, "x")
    _same(got, want)


@pytest.mark.parametrize("comp", [{"type": "bzip2", "blockSize": 5},
                                  {"type": "xz", "preset": 3},
                                  {"type": "zstd", "level": 5},
                                  {"type": "blosc", "cname": "zstd",
                                   "clevel": 5, "shuffle": 2}],
                         ids=["bzip2", "xz", "zstd", "blosc-bitshuffle"])
@pytest.mark.parametrize("dtype", ["uint8", "int16", "uint64", "float32"])
def test_n5_compressions(tmp_path, comp, dtype):
    data = _kind("fragments", (9, 20, 14), dtype)
    root = tmp_path / "x.n5"
    root.mkdir()
    (root / "attributes.json").write_text('{"n5": "2.0.0"}')
    t = ts.open({"driver": "n5", "kvstore": {"driver": "file",
                                             "path": str(root / "x")},
                 "metadata": {"dimensions": [14, 20, 9],
                              "blockSize": [5, 8, 4],
                              "dataType": np.dtype(dtype).name,
                              "compression": comp},
                 "create": True}).result()
    t.transpose()[...] = data
    want, got = _both(str(root), "x")
    _same(want, data)
    _same(got, want)


def _meta(path, **changes):
    with open(path) as f:
        meta = json.load(f)
    meta.update(changes)
    with open(path, "w") as f:
        json.dump(meta, f)


@pytest.mark.parametrize("case,match", [
    ("zarr_filters", "filters"),
    ("zarr_unknown", "compressor 'lzma'"),
    ("n5_varlength", "varlength"),
    ("n5_unknown", "compression 'lz4'"),
    ("write_zstd", "writing zarr C-order zstd"),
    ("write_n5_xz", "writing N5 xz"),
    ("write_f_order", "writing zarr F-order"),
])
def test_what_still_raises_by_name(tmp_path, case, match):
    data = _kind("smooth", (4, 6, 8), "uint16")
    root = _zarr_root(tmp_path)
    if case.startswith("n5") or case == "write_n5_xz":
        root = str(tmp_path / "x.n5")
        os.makedirs(root)
        with open(os.path.join(root, "attributes.json"), "w") as f:
            f.write('{"n5": "2.0.0"}')
        t = ts.open({"driver": "n5", "kvstore": {
            "driver": "file", "path": os.path.join(root, "x")},
            "metadata": {"dimensions": [8, 6, 4], "blockSize": [8, 6, 4],
                         "dataType": "uint16",
                         "compression": {"type": "xz"}},
            "create": True}).result()
        t.transpose()[...] = data
        attrs = os.path.join(root, "x", "attributes.json")
        if case == "n5_unknown":
            _meta(attrs, compression={"type": "lz4"})
        elif case == "n5_varlength":
            _meta(attrs, compression={"type": "raw"})
            with open(os.path.join(root, "x", "0", "0", "0"), "wb") as f:
                f.write(b"\x00\x01\x00\x03" + b"\x00" * 16)
    else:
        comp = {"zarr_unknown": {"id": "zlib", "level": 1},
                "write_zstd": {"id": "zstd", "level": 1}}.get(
                    case, {"id": "zlib", "level": 1})
        _ts_zarr(os.path.join(root, "x"), data, comp, (4, 6, 8),
                 order="F" if case == "write_f_order" else "C")
        zarray = os.path.join(root, "x", ".zarray")
        if case == "zarr_filters":
            _meta(zarray, filters=[{"id": "delta", "dtype": "<u2"}])
        elif case == "zarr_unknown":
            _meta(zarray, compressor={"id": "lzma"})
    with pytest.raises(NotImplementedError, match=match):
        with port_reader(root, "a") as f:
            if case.startswith("write"):
                f["x"][...] = data
            else:
                f["x"][...]
