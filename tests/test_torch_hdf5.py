"""The port's HDF5 reader and writer (``core/hdf5.py``) against h5py and
the JAX package's ``H5File``, on the CPU.  Exact: values, dtypes, shapes,
chunks and attributes.

* files h5py writes by default (contiguous, chunked, gzip + shuffle,
  fletcher32, compact, big-endian, partly written chunks with a fill
  value, more than 64 chunks so the chunk B-tree gets a second level,
  nested groups, every attribute kind, variable-length and fixed strings,
  bools, scalars) and files the JAX package's ``H5File`` writes, read by
  the port;
* files the port writes, read by h5py and the JAX package's
  ``file_reader``;
* the cases of ``tests/test_storage.py::test_roundtrip`` for ``.h5``
  across both packages;
* eight threads writing blocks through separate handles on one file;
* ``"a"`` on a file h5py wrote;
* the structures the port does not handle raising by name.
"""

import gc
import sys
import threading

import h5py
import numpy as np
import pytest

from cluster_tools_tpu.core.storage import file_reader as jax_reader
from cluster_tools_tpu_torch.core import hdf5
from cluster_tools_tpu_torch.core.storage import file_reader as port_reader

BIG = np.random.RandomState(0).randint(0, 1000, (40, 50, 60)).astype(
    "uint16")


def _dataset_cases(f):
    """Write one dataset per case through ``f`` (an h5py file); return the
    expected arrays."""
    rng = np.random.RandomState(1)
    want = {}

    def put(name, data, **kw):
        f.create_dataset(name, data=data, **kw)
        want[name] = _as_read(data)

    put("contiguous", rng.rand(5, 6))
    put("chunked", BIG, chunks=(7, 8, 9))  # 294 chunks: two B-tree levels
    put("gzip_shuffle", BIG.astype("int32"), chunks=(10, 10, 10),
        compression="gzip", shuffle=True)
    put("fletcher32", BIG.astype("float32"), chunks=(20, 20, 20),
        fletcher32=True, compression="gzip")
    put("big_endian", np.arange(6, dtype=">i4"))
    put("uint64", np.array([0, 2 ** 63 + 5, 2 ** 64 - 1], "uint64"))
    put("int8", np.array([-128, 0, 127], "int8"))
    put("float16", np.array([0.5, -2.25], "float16"))
    f.create_dataset("partial", shape=(30, 30), dtype="int64",
                     chunks=(10, 10), fillvalue=7)[0:10, 0:10] = 3
    part = np.full((30, 30), 7, "int64")
    part[:10, :10] = 3
    want["partial"] = part
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_INT32,
                    h5py.h5s.create_simple((4,)), dcpl=dcpl)
    f["compact"][:] = np.arange(4)
    want["compact"] = np.arange(4, dtype="int32")
    put("vlen_utf8", "0.2")
    put("vlen_ascii", b"zyx")
    put("vlen_list", [b"Raw Data", b"Overlay"])
    put("vlen_unicode", ["α", "bcd"], dtype=h5py.string_dtype())
    put("fixed", np.array([b"ab", b"cde"]))
    put("bool", True)
    put("bool_array", np.array([True, False, True]))
    put("scalar_int", 2)
    put("scalar_float", 1.0)
    put("a/b/c/nested", np.arange(3, dtype="uint8"))
    return want


def _as_read(value):
    """What h5py reads back from a dataset written with ``value``:
    variable-length strings as bytes."""
    if isinstance(value, str):
        return np.array(value.encode(), object)
    if isinstance(value, list) and value and isinstance(value[0], (str,
                                                                   bytes)):
        return np.array([v.encode() if isinstance(v, str) else v
                         for v in value], object)
    if isinstance(value, bytes):
        return np.array(value, object)
    return np.asarray(value)


ATTRS = {"int": 5, "float": 2.5, "str": "hi", "bytes": b"by", "bool": True,
         "float_array": np.arange(3.0), "str_list": ["x", "yy"],
         "fixed": np.bytes_(b"fixed"), "uint64": np.uint64(2 ** 63 + 5),
         "int8": np.int8(-3), "int_list": [1, 2, 3], "resolution": [40.0,
                                                                    4.0, 4.0]}


def _same(a, b):
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), (a, b)
        assert a.dtype == b.dtype and a.shape == b.shape, (a, b)
        if b.dtype == object:
            assert a.tolist() == b.tolist()
        else:
            np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def _h5py_file(path):
    with h5py.File(path, "w") as f:
        want = _dataset_cases(f)
        for k, v in ATTRS.items():
            f.attrs[k] = v
            f["chunked"].attrs[k] = v
        f["a/b/c"].attrs["deep"] = np.int8(-3)
    return want


def test_port_reads_h5py_datasets(tmp_path):
    path = str(tmp_path / "h.h5")
    want = _h5py_file(path)
    with hdf5.File(path, "r") as f, h5py.File(path, "r") as h:
        for name, data in want.items():
            got, ref = f[name][()], h[name][()]
            _same(got, ref)
            if data.dtype == object:
                assert np.asarray(got, object).tolist() == data.tolist()
            else:
                np.testing.assert_array_equal(got, data)
            assert f[name].chunks == h[name].chunks, name
            assert f[name].shape == h[name].shape, name
        np.testing.assert_array_equal(f["chunked"][3:9, 45:, 7],
                                      BIG[3:9, 45:, 7])
        assert f["partial"][25, 25] == 7
        assert sorted(f.keys()) == sorted(h.keys())
        assert f["a"]["b/c"].keys() == ["nested"]
        assert "a/b/c/nested" in f and "a/b/x" not in f


def test_port_reads_h5py_attributes(tmp_path):
    path = str(tmp_path / "h.h5")
    _h5py_file(path)
    with hdf5.File(path, "r") as f, h5py.File(path, "r") as h:
        for obj in ("/", "chunked"):
            assert sorted(f[obj].attrs.keys()) == sorted(h[obj].attrs.keys())
            for k in h[obj].attrs:
                _same(f[obj].attrs[k], h[obj].attrs[k])
        _same(f["a/b/c"].attrs["deep"], h["a/b/c"].attrs["deep"])


def test_port_reads_jax_written_h5(tmp_path):
    path = str(tmp_path / "j.h5")
    with jax_reader(path) as f:
        f.require_dataset("raw", data=BIG, chunks=(25, 25, 25),
                          compression="gzip")
        ds = f.require_dataset("seg", shape=(40, 50, 60), dtype="uint64",
                               chunks=(16, 16, 16))
        ds[:, 20:, :] = 9
        ds.attrs["maxId"] = 9
        f.require_group("g").attrs["x"] = [1.0, 2.0]
    with port_reader(path, "r") as f:
        np.testing.assert_array_equal(f["raw"][:], BIG)
        seg = f["seg"]
        assert seg.chunks == (16, 16, 16) and seg.dtype == np.uint64
        assert (seg[:, 20:, :] == 9).all() and (seg[:, :20, :] == 0).all()
        assert seg.attrs["maxId"] == 9 and seg.find_max() == 9
        np.testing.assert_array_equal(f["g"].attrs["x"], [1.0, 2.0])


def _port_file(path):
    with hdf5.File(path, "w") as f:
        want = {}
        f.create_dataset("contiguous", data=np.arange(12.0).reshape(3, 4))
        want["contiguous"] = np.arange(12.0).reshape(3, 4)
        ds = f.create_dataset("chunked", shape=BIG.shape, dtype="uint16",
                              chunks=(7, 8, 9), compression="gzip")
        ds[...] = BIG
        want["chunked"] = BIG
        ds = f.create_dataset("partial", shape=(30, 30), dtype="float32",
                              chunks=(7, 11))
        ds[3:20, 5:] = 1.5
        want["partial"] = np.zeros((30, 30), "float32")
        want["partial"][3:20, 5:] = 1.5
        for name, value in (("vlen_utf8", "0.2"), ("vlen_ascii", b"zyx"),
                            ("vlen_list", [b"Raw Data", b"Overlay"]),
                            ("bool", True), ("scalar_int", 2),
                            ("scalar_float", 1.0),
                            ("fixed", np.array([b"ab", b"cde"])),
                            ("x/y/nested", np.arange(3, dtype="uint8"))):
            f.create_dataset(name, data=value)
            want[name] = _as_read(value)
        f.create_dataset("empty", shape=(5,), dtype="uint8")
        want["empty"] = np.zeros(5, "uint8")
        for k, v in ATTRS.items():
            f.attrs[k] = v
            f["chunked"].attrs[k] = v
        for i in range(300):  # a group B-tree of two levels
            f.create_group(f"many/g{i:03d}")
    return want


def test_h5py_reads_port_written(tmp_path):
    path = str(tmp_path / "p.h5")
    want = _port_file(path)
    ref = str(tmp_path / "ref.h5")
    with h5py.File(ref, "w") as r:
        for k, v in ATTRS.items():
            r.attrs[k] = v
    with h5py.File(path, "r") as h, h5py.File(ref, "r") as r, \
            hdf5.File(path, "r") as f:
        for name, data in want.items():
            got = h[name][()]
            if data.dtype == object:
                assert np.asarray(got, object).tolist() == data.tolist()
            else:
                np.testing.assert_array_equal(got, data)
                assert h[name].dtype == data.dtype, name
            assert h[name].chunks == f[name].chunks, name
            _same(f[name][()], got)
        # h5py's string types: str -> UTF-8, bytes -> ASCII variable length
        assert h5py.check_string_dtype(h["vlen_utf8"].dtype).encoding == \
            "utf-8"
        assert h5py.check_string_dtype(h["vlen_ascii"].dtype).encoding == \
            "ascii"
        assert h5py.check_string_dtype(h["vlen_list"].dtype).length is None
        assert h["chunked"].compression == "gzip"
        assert h["chunked"].compression_opts == 4  # h5py's default level
        assert h["partial"].compression is None
        for obj in ("/", "chunked"):
            for k in ATTRS:
                _same(h[obj].attrs[k], r.attrs[k])
        assert len(h["many"]) == 300 and "g299" in h["many"]
    with jax_reader(path, "r") as f:
        np.testing.assert_array_equal(f["chunked"][:], BIG)
        assert f["chunked"].chunks == (7, 8, 9)
        np.testing.assert_array_equal(f["chunked"].attrs["resolution"],
                                      [40.0, 4.0, 4.0])


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax"),
                                           ("port", "port")])
def test_roundtrip_h5_across_packages(tmp_path, writer, reader):
    """``tests/test_storage.py::test_roundtrip`` for ``.h5``: one package
    writes, the other reads."""
    from cluster_tools_tpu.core.storage import get_shape as jax_shape
    from cluster_tools_tpu_torch.core.storage import get_shape as port_shape

    w = jax_reader if writer == "jax" else port_reader
    r = jax_reader if reader == "jax" else port_reader
    shape = port_shape if reader == "port" else jax_shape
    path = str(tmp_path / "vol.h5")
    data = np.random.RandomState(3).rand(32, 48).astype("float32")
    with w(path) as f:
        ds = f.require_dataset("data", shape=data.shape, chunks=(16, 16),
                               dtype="float32")
        ds[:, :] = data
        assert ds.chunks == (16, 16)
    with r(path, "r") as f:
        out = f["data"][:, :]
        assert f["data"].chunks == (16, 16)
    np.testing.assert_array_equal(out, data)
    assert shape(path, "data") == (32, 48)


def test_h5_container_surface_matches_jax(tmp_path):
    """``require_dataset``: chunks default to the shape, ``"raw"`` means no
    compression, ``data=`` fills only on creation; attrs and groups."""
    out = {}
    for pkg, reader in (("jax", jax_reader), ("port", port_reader)):
        path = str(tmp_path / f"{pkg}.h5")
        with reader(path) as f:
            ds = f.require_dataset("a", data=np.arange(10), compression="raw")
            again = f.require_dataset("a", data=np.zeros(10, "int64"))
            f.require_group("grp").require_dataset("b", shape=(4, 4),
                                                   dtype="uint8",
                                                   chunks=(2, 2))
            ds.attrs["maxId"] = 9
            out[pkg] = (ds.chunks, again[:], ds.dtype, ds.attrs["maxId"],
                        f["grp/b"].chunks, "grp/b" in f, ds.find_max())
            with pytest.raises(TypeError):
                f.require_dataset("a", shape=(11,), dtype="int64")
            with pytest.raises(TypeError):
                f.attrs["bad"] = {"a": 1}
    for a, b in zip(out["jax"], out["port"]):
        if isinstance(a, np.ndarray):
            _same(b, a)
        else:
            assert a == b and type(a) is type(b), (a, b)
    assert out["port"][0] == (10,) and out["port"][4] == (2, 2)
    np.testing.assert_array_equal(out["port"][1], np.arange(10))


def test_threads_write_blocks_through_separate_handles(tmp_path):
    """Eight threads, each with its own handle on one path (as the
    runtime's jobs open their output), write disjoint blocks and close:
    no close drops another handle's chunks."""
    path = str(tmp_path / "t.h5")
    with port_reader(path) as f:
        f.require_dataset("x", shape=(64, 64, 64), dtype="uint32",
                          chunks=(16, 16, 16), compression="gzip")
    want = np.arange(64 ** 3, dtype="uint32").reshape(64, 64, 64)
    blocks = [(z, y, x) for z in range(0, 64, 16) for y in range(0, 64, 16)
              for x in range(0, 64, 16)]
    errors = []

    def job(i):
        try:
            for z, y, x in blocks[i::8]:
                with port_reader(path) as f:
                    bb = np.s_[z:z + 16, y:y + 16, x:x + 16]
                    f["x"][bb] = want[bb]
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=job, args=(i,)) for i in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often: lost updates show
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    with h5py.File(path, "r") as h:
        np.testing.assert_array_equal(h["x"][:], want)
    with port_reader(path, "r") as f:
        np.testing.assert_array_equal(f["x"][:], want)


def test_unclosed_handle_is_flushed_when_collected(tmp_path):
    path = str(tmp_path / "gc.h5")
    ds = port_reader(path).require_dataset("x", shape=(8,), dtype="int16")
    ds[:] = np.arange(8)
    del ds
    gc.collect()
    with h5py.File(path, "r") as h:
        np.testing.assert_array_equal(h["x"][:], np.arange(8))


def test_append_to_h5py_file(tmp_path):
    path = str(tmp_path / "h.h5")
    want = _h5py_file(path)
    with hdf5.File(path, "a") as f:
        f.create_dataset("new/x", data=np.ones((3, 3)), chunks=(2, 2),
                         compression="gzip")
        f["chunked"][0:7, 0:8, 0:9] = 0
        f["partial"][25:, 25:] = 1
        f.attrs["added"] = "yes"
        f["a/b/c"].attrs["more"] = 1.5
    changed = BIG.copy()
    changed[0:7, 0:8, 0:9] = 0
    part = want["partial"].copy()
    part[25:, 25:] = 1
    with h5py.File(path, "r") as h:
        np.testing.assert_array_equal(h["new/x"][:], np.ones((3, 3)))
        np.testing.assert_array_equal(h["chunked"][:], changed)
        np.testing.assert_array_equal(h["partial"][:], part)
        np.testing.assert_array_equal(h["gzip_shuffle"][:], BIG)
        assert h.attrs["added"] == "yes" and h.attrs["int"] == 5
        assert h["a/b/c"].attrs["more"] == 1.5
        assert h["a/b/c"].attrs["deep"] == -3
        assert h["vlen_list"][()].tolist() == [b"Raw Data", b"Overlay"]
        assert h["chunked"].attrs["str"] == "hi"


@pytest.mark.parametrize("case,match", [
    ("latest", "superblock version 3"),
    ("dense_attributes", "version 2 object header"),
    ("lzf", "filter 'lzf'"),
    ("soft_link", "soft link"),
    ("compound", "compound datatype"),
])
def test_unsupported_structures_raise_by_name(tmp_path, case, match):
    """What the port does not read raises ``NotImplementedError`` naming
    it.  h5py stores more than 8 attributes densely only with creation
    order tracked, which needs a version 2 object header: that is the
    structure named."""
    path = str(tmp_path / f"{case}.h5")
    kw = {"libver": "latest"} if case == "latest" else {}
    with h5py.File(path, "w", **kw) as f:
        if case == "latest":
            f["x"] = 1
        elif case == "dense_attributes":
            g = f.create_group("x", track_order=True)
            for i in range(20):
                g.attrs[f"a{i}"] = i
        elif case == "lzf":
            f.create_dataset("x", data=np.arange(100), compression="lzf")
        elif case == "soft_link":
            f["y"] = 1
            f["g/x"] = h5py.SoftLink("/y")
        else:
            f["x"] = np.zeros(3, [("a", "i4"), ("b", "f8")])
    with pytest.raises(NotImplementedError, match=match):
        with hdf5.File(path, "r") as f:
            f["g/x" if case == "soft_link" else "x"][()]


def test_not_an_hdf5_file_and_modes(tmp_path):
    bad = tmp_path / "bad.h5"
    bad.write_bytes(b"no hdf5 here")
    with pytest.raises(OSError, match="not an HDF5 file"):
        hdf5.File(str(bad), "r")
    path = str(tmp_path / "m.h5")
    with pytest.raises(FileNotFoundError):
        hdf5.File(path, "r")
    with hdf5.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(3))
    with pytest.raises(FileExistsError):
        hdf5.File(path, "w-")
    with hdf5.File(path, "r") as f:
        with pytest.raises(OSError, match="read-only"):
            f.create_group("g")


def _fletcher32_file(path, corrupt):
    """A uint8 ``(16, 16, 16)`` ``arange`` dataset in ``(8, 8, 8)`` chunks
    with fletcher32, optionally with one byte of the first chunk flipped
    (offset 10 from its stored start)."""
    data = (np.arange(16 ** 3) % 256).astype("uint8").reshape(16, 16, 16)
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("x", data=data, chunks=(8, 8, 8),
                              fletcher32=True)
        start = ds.id.get_chunk_info(0).byte_offset
    if corrupt:
        with open(path, "r+b") as fh:
            fh.seek(start + 10)
            b = fh.read(1)
            fh.seek(start + 10)
            fh.write(bytes([b[0] ^ 0xFF]))
    return data


@pytest.mark.parametrize("corrupt", [False, True])
def test_fletcher32_is_verified_like_the_jax_package(tmp_path, corrupt):
    """A chunk whose Fletcher-32 does not match raises ``OSError`` in both
    packages, naming the dataset and the chunk in the port; the intact
    file reads the same array in both."""
    path = str(tmp_path / "f.h5")
    data = _fletcher32_file(path, corrupt)
    if corrupt:
        with pytest.raises(OSError):
            with jax_reader(path, "r") as f:
                f["x"][:]
        with pytest.raises(OSError, match=r"fletcher32.*'/x'.*chunk "
                                          r"\(0, 0, 0\)"):
            with port_reader(path, "r") as f:
                f["x"][:]
        # a chunk that was not touched still reads
        with port_reader(path, "r") as f:
            np.testing.assert_array_equal(f["x"][8:, 8:, 8:],
                                          data[8:, 8:, 8:])
        return
    with jax_reader(path, "r") as f:
        want = f["x"][:]
    with port_reader(path, "r") as f:
        got = f["x"][:]
    np.testing.assert_array_equal(want, data)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_bytes", [0, 1, 2, 245, 720, 721, 4096, 100001])
def test_fletcher32_matches_hdf5s_definition(n_bytes):
    """The port's Fletcher-32 against a word-by-word transcription of
    ``H5_checksum_fletcher32`` (runs of 360 words, odd trailing byte)."""
    rng = np.random.RandomState(n_bytes)
    data = rng.randint(0, 256, n_bytes).astype("uint8").tobytes()

    def reference(buf):
        sum1 = sum2 = 0
        n = len(buf) // 2
        i = 0
        while n:
            t = min(n, 360)
            n -= t
            for _ in range(t):
                sum1 = (sum1 + ((buf[i] << 8) | buf[i + 1])) & 0xFFFFFFFF
                i += 2
                sum2 = (sum2 + sum1) & 0xFFFFFFFF
            sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
            sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
        if len(buf) % 2:
            sum1 += buf[i] << 8
            sum2 += sum1
            sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
            sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
        return (sum2 << 16) | sum1

    assert hdf5.fletcher32(data) == reference(data)


def test_fletcher32_odd_chunks_read_from_h5py(tmp_path):
    """Chunks of an odd byte count (the trailing-byte rule) written by
    h5py read back through the port's check."""
    path = str(tmp_path / "odd.h5")
    data = np.random.RandomState(3).randint(0, 256, (7, 9, 5)).astype(
        "uint8")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=data, chunks=(7, 7, 5), fletcher32=True)
    with port_reader(path, "r") as f:
        np.testing.assert_array_equal(f["x"][:], data)
