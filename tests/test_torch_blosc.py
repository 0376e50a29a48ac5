"""The port's blosc (``core/blosc.py`` framing ``native/src/codecs.cpp``)
against tensorstore's c-blosc, on the CPU.  Exact.

* chunks that tensorstore writes, through zarr specs for ``lz4``,
  ``lz4hc``, ``blosclz`` and ``zlib`` with shuffle 0 and 1, over uint8,
  uint16, uint64 and float32, smooth and incompressible data, ragged edge
  chunks: the port decodes each chunk file to tensorstore's array;
* the JAX package's ``ZarrFile(compression="blosc")`` read by the port,
  and the port's blosc zarr read by the JAX package;
* n5-blosc datasets (as tensorstore and z5py write them) read by the port;
* Zstd, Snappy and the bitshuffle (type sizes 1, 2, 4 and 8, element
  counts that are not a multiple of 8) as tensorstore writes them; a
  dictionary-named Zstd stream and an unknown codec raise naming
  themselves;
* a hypothesis round trip of the frame over bytes, type sizes and
  shuffles.
"""

import itertools
import os

import numpy as np
import pytest
import tensorstore as ts
from hypothesis import given, settings
from hypothesis import strategies as st

from cluster_tools_tpu.core.storage import file_reader as jax_reader
from cluster_tools_tpu_torch.core import blosc
from cluster_tools_tpu_torch.core.storage import file_reader as port_reader

SHAPE, CHUNKS = (19, 40, 33), (8, 32, 16)
DTYPES = ["uint8", "uint16", "uint64", "float32"]


def _data(dtype, kind, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "smooth":
        a = (np.arange(np.prod(SHAPE)) // 7 % 1000).reshape(SHAPE)
        return a.astype(dtype)
    if dtype == "float32":
        return rng.rand(*SHAPE).astype(dtype)
    info = np.iinfo(dtype)
    return rng.randint(0, int(info.max), SHAPE, dtype=np.uint64).astype(
        dtype)


def _ts_zarr(path, data, compressor):
    t = ts.open({"driver": "zarr", "kvstore": {"driver": "file",
                                               "path": path},
                 "metadata": {"shape": list(SHAPE), "chunks": list(CHUNKS),
                              "dtype": data.dtype.str,
                              "compressor": compressor},
                 "create": True}).result()
    t[...] = data


@pytest.mark.parametrize("cname,shuffle,dtype", list(itertools.product(
    ["lz4", "lz4hc", "blosclz", "zlib"], [0, 1], DTYPES)))
def test_port_decodes_tensorstore_chunks(tmp_path, cname, shuffle, dtype):
    _decodes_tensorstore_chunks(tmp_path, cname, shuffle, dtype)


@pytest.mark.parametrize("cname,shuffle,dtype", [
    *itertools.product(["zstd", "snappy"], [0, 1, 2], DTYPES),
    *itertools.product(["lz4", "blosclz", "zlib"], [2], DTYPES)])
def test_port_decodes_zstd_snappy_and_bitshuffle_chunks(tmp_path, cname,
                                                        shuffle, dtype):
    """Zstd (one frame per stream) and Snappy streams, and the bitshuffle
    under every codec, each split or not as c-blosc chose."""
    _decodes_tensorstore_chunks(tmp_path, cname, shuffle, dtype)


def _decodes_tensorstore_chunks(tmp_path, cname, shuffle, dtype):
    for kind in ("smooth", "random"):
        data = _data(dtype, kind)
        path = str(tmp_path / kind)
        _ts_zarr(path, data, {"id": "blosc", "cname": cname, "clevel": 5,
                              "shuffle": shuffle})
        files = [n for n in os.listdir(path) if not n.startswith(".")]
        assert len(files) == 3 * 2 * 3
        for name in files:
            with open(os.path.join(path, name), "rb") as f:
                frame = f.read()
            flags = blosc.header(frame)[0]
            assert flags & 5 == {0: 0, 1: 1, 2: 4}[shuffle] or flags & 2
            pos = [int(p) for p in name.split(".")]
            bb = tuple(slice(p * c, min((p + 1) * c, s))
                       for p, c, s in zip(pos, CHUNKS, SHAPE))
            chunk = blosc.decompress(frame).view(data.dtype).reshape(CHUNKS)
            np.testing.assert_array_equal(
                chunk[tuple(slice(0, b.stop - b.start) for b in bb)],
                data[bb])
        with _zarr_dir(path) as ds:
            np.testing.assert_array_equal(ds[...], data)


class _zarr_dir:
    """The port's zarr dataset over a bare array directory."""

    def __init__(self, path):
        from cluster_tools_tpu_torch.core.config import read_config
        from cluster_tools_tpu_torch.core.storage import Dataset

        self.ds = Dataset(path, "zarr", read_config(
            os.path.join(path, ".zarray")))

    def __enter__(self):
        return self.ds

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_reads_jax_blosc_zarr(tmp_path, dtype):
    data = _data(dtype, "smooth", seed=1)
    path = str(tmp_path / "d.zarr")
    with jax_reader(path) as f:
        ds = f.require_dataset("x", shape=SHAPE, chunks=CHUNKS, dtype=dtype,
                               compression="blosc")
        ds[...] = data
    with port_reader(path, "r") as f:
        assert f["x"].dtype == np.dtype(dtype)
        np.testing.assert_array_equal(f["x"][...], data)
        np.testing.assert_array_equal(f["x"][3:11, 30:, 5],
                                      data[3:11, 30:, 5])


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_reads_port_blosc_zarr(tmp_path, dtype):
    """The port writes the JAX package's metadata for ``compression=
    "blosc"`` and frames that tensorstore decodes to the same array
    (a partial write included)."""
    data = _data(dtype, "random", seed=2)
    port, jax = str(tmp_path / "p.zarr"), str(tmp_path / "j.zarr")
    for reader, path in ((port_reader, port), (jax_reader, jax)):
        with reader(path) as f:
            ds = f.require_dataset("x", shape=SHAPE, chunks=CHUNKS,
                                   dtype=dtype, compression="blosc")
            ds[...] = data
            ds[2:9, 10:20, 3:30] = data[2:9, 10:20, 3:30] // 2
    with open(os.path.join(port, "x", ".zarray")) as f:
        port_meta = f.read()
    with open(os.path.join(jax, "x", ".zarray")) as f:
        jax_meta = f.read()
    import json
    assert json.loads(port_meta) == json.loads(jax_meta)
    want = data.copy()
    want[2:9, 10:20, 3:30] //= 2
    with jax_reader(port, "r") as f:
        np.testing.assert_array_equal(f["x"][...], want)


@pytest.mark.parametrize("dtype,cname", list(itertools.product(
    DTYPES, ["lz4", "blosclz", "zlib"])))
def test_n5_blosc_read(tmp_path, dtype, cname):
    data = _data(dtype, "smooth", seed=3)
    path = str(tmp_path / "d.n5")
    t = ts.open({"driver": "n5", "kvstore": {"driver": "file",
                                             "path": path + "/x"},
                 "metadata": {"dimensions": list(SHAPE[::-1]),
                              "blockSize": list(CHUNKS[::-1]),
                              "dataType": dtype,
                              "compression": {"type": "blosc",
                                              "cname": cname, "clevel": 5,
                                              "shuffle": 1}},
                 "create": True}).result()
    t.transpose()[...] = data  # N5 axes are the reverse of numpy's
    with open(os.path.join(path, "attributes.json"), "w") as f:
        f.write('{"n5": "2.0.0"}')
    with port_reader(path, "r") as f:
        np.testing.assert_array_equal(f["x"][...], data)
    with jax_reader(path, "r") as f:
        np.testing.assert_array_equal(f["x"][...], data)


@pytest.mark.parametrize("what", ["zstd", "bitshuffle"])
def test_zstd_and_bitshuffle_raise_by_name(tmp_path, what):
    """Zstd and the bitshuffle used to raise by name; they now read
    exactly as tensorstore wrote them.  What still raises by name in
    their place: a Zstd stream whose frame names a dictionary, and a
    codec id past Zstd's."""
    data = _data("uint16", "smooth")
    comp = ({"id": "blosc", "cname": "zstd", "clevel": 5, "shuffle": 1}
            if what == "zstd" else
            {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 2})
    path = str(tmp_path / "d")
    _ts_zarr(path, data, comp)
    with open(os.path.join(path, "0.0.0"), "rb") as f:
        frame = f.read()
    plain = blosc.decompress(frame).view("uint16").reshape(CHUNKS)
    np.testing.assert_array_equal(plain, data[:8, :32, :16])
    with _zarr_dir(path) as ds:
        np.testing.assert_array_equal(ds[...], data)
    head = bytearray(frame[:blosc.HEADER])
    if what == "zstd":
        import zstandard

        d = zstandard.train_dictionary(1024, [bytes([i % 7]) * 300 + b"x" * i
                                              for i in range(300)])
        block = b"\x05" * 4096
        stream = zstandard.ZstdCompressor(dict_data=d).compress(block)
        head[2] = (4 << 5) | 0x10  # Zstd, not split, no shuffle
        head[3] = 1
        head[4:16] = np.array([4096, 4096, 16 + 4 + 4 + len(stream)],
                              "<u4").tobytes()
        broken = bytes(head) + (20).to_bytes(4, "little") + len(
            stream).to_bytes(4, "little") + stream
        match = "dictionar"
    else:
        head[2] = (5 << 5) | (head[2] & 0x1F)
        broken = bytes(head) + frame[blosc.HEADER:]
        match = "codec 5"
    with pytest.raises(NotImplementedError, match=match):
        blosc.decompress(broken)


@pytest.mark.parametrize("typesize", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [64, 77, 8, 5])
def test_bitshuffle_type_sizes(tmp_path, typesize, n):
    """tensorstore's bitshuffled chunks of ``n`` elements of each type
    size (77 and 5: not a multiple of 8, stored unshuffled by c-blosc
    1.x, whose frames are of version 2)."""
    dtype = {1: "uint8", 2: "uint16", 4: "float32", 8: "uint64"}[typesize]
    rng = np.random.RandomState(n * typesize)
    data = (rng.randint(0, 200, (3, n)) // 3).astype(dtype)
    path = str(tmp_path / "d")
    t = ts.open({"driver": "zarr", "kvstore": {"driver": "file",
                                               "path": path},
                 "metadata": {"shape": [3, n], "chunks": [2, n],
                              "dtype": data.dtype.str,
                              "compressor": {"id": "blosc", "cname": "lz4",
                                             "clevel": 5, "shuffle": 2}},
                 "create": True}).result()
    t[...] = data
    with _zarr_dir(path) as ds:
        np.testing.assert_array_equal(ds[...], data)


def test_bitunshuffle_inverts_bitshuffle():
    """The C++ bitunshuffle against a numpy transcription of c-blosc's
    bitshuffle (byte planes, then each byte's bits in 8 rows), for
    version 3 frames too, where the elements past the last full group of
    8 are left as they lie."""
    from cluster_tools_tpu_torch.native import codecs

    rng = np.random.RandomState(0)
    lib = codecs()
    for typesize in (1, 2, 3, 4, 8):
        for n in (0, 8, 16, 24, 13, 200, 203):
            # and a partial element at the end
            raw = rng.randint(0, 256, n * typesize + typesize - 1).astype(
                np.uint8)
            size = n - n % 8
            body = raw[:size * typesize].reshape(size, typesize)
            # bit k of byte j of element i -> row (j, k), column i
            bits = np.unpackbits(body[:, :, None], axis=2,
                                 bitorder="little")  # (i, j, k)
            rows = bits.transpose(1, 2, 0).reshape(typesize * 8, size)
            shuffled = np.packbits(rows, axis=1, bitorder="little")
            stored = np.concatenate([shuffled.reshape(-1),
                                     raw[size * typesize:]])
            out = np.empty_like(raw)
            lib.bitunshuffle(stored.ctypes.data, len(raw), typesize, 3,
                             out.ctypes.data)
            np.testing.assert_array_equal(out, raw)
            if n % 8:  # version 2: such a block was stored as it lay
                lib.bitunshuffle(raw.ctypes.data, len(raw), typesize, 2,
                                 out.ctypes.data)
                np.testing.assert_array_equal(out, raw)


def test_corrupt_snappy_and_zstd_streams_raise():
    from cluster_tools_tpu_torch.core import codecs

    with pytest.raises(ValueError):
        codecs.snappy_decompress(b"\x0a\x08abc", 10)  # literal past end
    with pytest.raises(ValueError):
        codecs.snappy_decompress(b"\x04\x00a\x05\x09", 4)  # offset 9
    with pytest.raises(ValueError):
        codecs.zstd_decompress(b"\x28\xb5\x2f\xfd\x00", 10)


def test_corrupt_frames_raise():
    frame = blosc.compress(np.arange(50000, dtype="uint32"), 4)
    with pytest.raises(ValueError):
        blosc.decompress(frame[:-10])
    broken = bytearray(frame)
    start = int.from_bytes(frame[16:20], "little")
    broken[start:start + 4] = (10 ** 6).to_bytes(4, "little")
    with pytest.raises(ValueError, match="corrupt"):
        blosc.decompress(bytes(broken))
    broken = bytearray(frame)
    broken[start + 4:] = b"\xff" * (len(frame) - start - 4)
    with pytest.raises(ValueError, match="corrupt"):
        blosc.decompress(bytes(broken))


@settings(max_examples=60, deadline=None)
@given(data=st.binary(min_size=0, max_size=3000),
       repeat=st.integers(1, 200), typesize=st.integers(1, 16),
       shuffle=st.integers(0, 1))
def test_frame_roundtrip(data, repeat, typesize, shuffle):
    """Any bytes, repeated (compressible) or not, any type size, with and
    without the byte shuffle: the frame decodes to the bytes."""
    buf = data * repeat
    frame = blosc.compress(buf, typesize, shuffle=shuffle)
    flags, ts_, nbytes, blocksize, cbytes, codec = blosc.header(frame)
    assert nbytes == len(buf) and cbytes == len(frame) and codec == 1
    assert blosc.decompress(frame).tobytes() == buf


def test_a_large_chunk_is_fast():
    """A 20 MB uint64 chunk encodes and decodes in well under a second
    each (the streams run in C++)."""
    import time

    rng = np.random.RandomState(0)
    labels = np.repeat(rng.randint(0, 10 ** 9, (50, 256, 1)), 200,
                       axis=2).astype("uint64")
    t0 = time.perf_counter()
    frame = blosc.compress(labels, 8)
    t1 = time.perf_counter()
    out = blosc.decompress(frame)
    t2 = time.perf_counter()
    np.testing.assert_array_equal(out.view("uint64").reshape(labels.shape),
                                  labels)
    assert len(frame) < labels.nbytes // 10
    assert t1 - t0 < 1.0 and t2 - t1 < 1.0, (t1 - t0, t2 - t1)


def test_codec_library_is_built_and_counted():
    from cluster_tools_tpu_torch.core import build
    from cluster_tools_tpu_torch.native import codecs

    codecs()
    before = dict(build.EXEC_CACHE_STATS)
    lib = build.build_shared("ctt_torch_codecs", [os.path.join(
        os.path.dirname(build._PKG), "cluster_tools_tpu_torch", "native",
        "src", "codecs.cpp")], ["g++", "-O3", "-std=c++17", "-shared",
                                "-fPIC"])
    assert os.path.exists(lib) and lib.startswith(build.BUILD_DIR)
    assert build.EXEC_CACHE_STATS["hits"] == before["hits"] + 1
