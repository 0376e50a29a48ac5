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
* files h5py writes with ``libver="latest"`` (superblock version 3,
  version 2 object headers, dense links and attributes in fractal heaps
  and version 2 B-trees, every chunk index of layout version 4), LZF,
  scale-offset, compound datatypes and soft links, read as h5py reads
  them; corrupt checksummed metadata raising ``OSError``;
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
    ("dense_attributes", "external link"),
    ("lzf", "filter 'szip'"),
    ("soft_link", "dangling soft link"),
    ("compound", "variable-length"),
])
def test_unsupported_structures_raise_by_name(tmp_path, case, match):
    """These structures used to raise by name and now read as h5py reads
    them: a ``libver="latest"`` file, more than 8 attributes with creation
    order (dense storage in a version 2 object header), LZF, a soft link,
    a compound datatype.  Beside each, what still raises: writing to the
    ``libver="latest"`` file (``NotImplementedError``), an external link,
    szip, a dangling soft link (``KeyError``, as h5py), a compound with a
    variable-length member."""
    path = str(tmp_path / f"{case}.h5")
    kw = {"libver": "latest"} if case == "latest" else {}
    with h5py.File(path, "w", **kw) as f:
        if case == "latest":
            f["x"] = 1
        elif case == "dense_attributes":
            g = f.create_group("x", track_order=True)
            for i in range(20):
                g.attrs[f"a{i}"] = i
            f["y"] = h5py.ExternalLink("other.h5", "/z")
        elif case == "lzf":
            f.create_dataset("x", data=np.arange(100), compression="lzf")
            f.create_dataset("y", data=np.arange(100), compression="szip")
        elif case == "soft_link":
            f["x"] = 1
            f["g/x"] = h5py.SoftLink("/x")
            f["y"] = h5py.SoftLink("/nowhere")
        else:
            f["x"] = np.zeros(3, [("a", "i4"), ("b", "f8")])
            f["y"] = np.array([(1, "a"), (2, "bc")],
                              [("a", "i4"), ("s", h5py.string_dtype())])
    with h5py.File(path, "r") as h, hdf5.File(path, "r") as f:
        key = "g/x" if case == "soft_link" else "x"
        if case == "dense_attributes":
            assert list(f[key].attrs.keys()) == list(h[key].attrs.keys())
            assert all(f[key].attrs[k] == v for k, v in h[key].attrs.items())
        else:
            want, got = h[key][()], f[key][()]
            assert got.dtype == want.dtype and got.tobytes() == \
                want.tobytes()
    error = KeyError if case == "soft_link" else NotImplementedError
    with pytest.raises(error, match=match):
        with hdf5.File(path, "r" if case != "latest" else "a") as f:
            if case == "latest":
                f["x"][()] = 2
            else:
                f["y"][()]


#: the chunked layouts of ``libver="latest"``: (create_dataset keywords,
#: the chunk index h5py writes for them)
LATEST_LAYOUTS = {
    "contiguous": ({}, None),
    "single_chunk": ({"chunks": (12, 20, 17)}, 1),
    "single_chunk_gzip": ({"chunks": (12, 20, 17), "compression": "gzip"},
                          1),
    "fixed_array": ({"chunks": (5, 6, 7)}, 3),
    "fixed_array_gzip": ({"chunks": (5, 6, 7), "compression": "gzip",
                          "shuffle": True}, 3),
    "fixed_array_paged": ({"chunks": (1, 2, 3)}, 3),
    "fixed_array_fletcher32": ({"chunks": (1, 2, 3), "fletcher32": True},
                               3),
    "extensible_array": ({"chunks": (1, 5, 17), "maxshape": (None, 20, 17)},
                         4),
    "extensible_array_gzip": ({"chunks": (2, 4, 5), "compression": "gzip",
                               "maxshape": (None, 20, 17)}, 4),
    "btree2": ({"chunks": (3, 4, 5), "maxshape": (None, None, 17)}, 5),
    "btree2_gzip": ({"chunks": (2, 3, 4), "compression": "gzip",
                     "maxshape": (None, None, None)}, 5),
    "lzf": ({"chunks": (5, 6, 7), "compression": "lzf"}, 3),
    "lzf_shuffle": ({"chunks": (12, 20, 17), "compression": "lzf",
                     "shuffle": True, "maxshape": (None, 20, 17)}, 4),
}


@pytest.mark.parametrize("name", list(LATEST_LAYOUTS))
def test_latest_layouts_read_like_h5py(tmp_path, name):
    """Each chunk index of data layout version 4 (and the contiguous and
    compact layouts) as h5py writes it with ``libver="latest"``, partly
    written chunks included: values and dtype exactly as h5py reads."""
    kw, kind = LATEST_LAYOUTS[name]
    data = (np.arange(12 * 20 * 17) // 3 % 5000).reshape(12, 20, 17)
    data = data.astype("int32" if "gzip" in name else "uint16")
    path = str(tmp_path / "l.h5")
    with h5py.File(path, "w", libver="latest") as f:
        ds = f.create_dataset("x", shape=data.shape, dtype=data.dtype,
                              fillvalue=9, **kw)
        ds[:, :15, :] = data[:, :15, :]
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_INT16,
                        h5py.h5s.create_simple((4, 5)), dcpl=dcpl)
        f["compact"][...] = np.arange(20).reshape(4, 5)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((4, 5))
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        h5py.h5d.create(f.id, b"implicit", h5py.h5t.NATIVE_INT32,
                        h5py.h5s.create_simple((10, 12)), dcpl=dcpl)
        f["implicit"][2:9, 1:11] = np.arange(70).reshape(7, 10)
    with h5py.File(path, "r") as h, hdf5.File(path, "r") as f:
        for key in ("x", "compact", "implicit"):
            want, got = h[key][()], f[key][()]
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(f["x"][3:7, 10:18, 2:9],
                                      h["x"][3:7, 10:18, 2:9])
        assert f["x"]._obj.index_kind == kind
        assert f["implicit"]._obj.index_kind == 2
    with port_reader(path, "r") as f, jax_reader(path, "r") as j:
        np.testing.assert_array_equal(f["x"][:], j["x"][:])
        assert f["x"].chunks == j["x"].chunks


def _latest_groups_file(path, libver):
    with h5py.File(path, "w", libver=libver) as f:
        g = f.create_group("many")
        for i in range(300):
            g[f"d{i:03d}_" + "n" * (i % 40)] = np.int16(i)
        g = f.create_group("attrs", track_order=True)
        for i in range(20):
            g.attrs[f"a{i}"] = i
        g.attrs["big"] = np.arange(1500.0)  # a huge heap object
        g.attrs["s"] = "text"
        g.attrs["strs"] = ["x", "yy"]
        f.create_dataset("d", data=np.arange(4), track_order=True)
        for i in range(12):
            f["d"].attrs[f"b{i}"] = np.float32(i) / 3
        g = f.create_group("untracked")
        for i in (5, 3, 17, 1, 12, 9, 0, 2, 11, 4, 8):
            g.attrs[f"u{i:02d}"] = np.uint8(i)
        f["soft_abs"] = h5py.SoftLink("/many/d007_nnnnnnn")
        f["many"]["soft_rel"] = h5py.SoftLink("d002_nn")
        f["chain"] = h5py.SoftLink("/soft_abs")


@pytest.mark.parametrize("libver", ["latest", "v110", "earliest"])
def test_latest_groups_attributes_and_links(tmp_path, libver):
    """A 300-link group (dense: a fractal heap with indirect blocks and a
    v2 B-tree of its names), 22 creation-ordered attributes with one huge
    heap object, a dataset's dense attributes, soft links (absolute,
    relative, chained); ``earliest`` still writes the creation-ordered
    ones in version 2 object headers."""
    path = str(tmp_path / "g.h5")
    _latest_groups_file(path, (libver, "latest"))
    with h5py.File(path, "r") as h, hdf5.File(path, "r") as f:
        assert sorted(f["many"].keys()) == sorted(h["many"].keys())
        for name in list(h["many"].keys())[::7]:
            assert f["many"][name][()] == h["many"][name][()]
        for obj in ("attrs", "d", "untracked"):
            keys = list(f[obj].attrs.keys())
            # 11 untracked attributes: dense (listed by name, as h5py)
            # unless the file is of the earliest format (compact)
            if obj == "untracked" and libver == "earliest":
                keys = sorted(keys)
            assert keys == list(h[obj].attrs.keys())
            for k, v in h[obj].attrs.items():
                _same(f[obj].attrs[k], v)
        for link in ("soft_abs", "many/soft_rel", "chain"):
            assert f[link][()] == h[link][()]
        assert "soft_abs" in f and "soft_rel" in f["many"]


@pytest.mark.parametrize("dtype,scale", [
    ("int16", 0), ("uint8", 0), ("int64", 0), ("uint32", 0),
    ("float32", 2), ("float64", 3)])
def test_scaleoffset_reads_like_h5py(tmp_path, dtype, scale):
    """HDF5's scale-offset filter as h5py writes it: integers with the
    minimum bits found per chunk (a fill value reserving the all-ones
    code, a constant chunk, negative values), floats in D-scale mode (a
    lossy round: the port holds to h5py's own read of the same file)."""
    rng = np.random.RandomState(0)
    if dtype.startswith("float"):
        data = (rng.rand(30, 40) * 2000 - 700).astype(dtype)
    else:
        # below full precision: HDF5 1.14's filter fails to read chunks
        # stored at full precision (h5py raises OSError on them)
        lo = max(np.iinfo(dtype).min, -5000)
        data = rng.randint(lo, min(lo + 100, 5000), (30, 40)).astype(dtype)
    data[:10, :10] = data[0, 0]
    path = str(tmp_path / "s.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=data, chunks=(10, 10), scaleoffset=scale)
        f.create_dataset("fill", shape=data.shape, dtype=dtype,
                         chunks=(10, 10), scaleoffset=scale, fillvalue=3)
        f["fill"][5:25, 5:] = data[5:25, 5:]
    with h5py.File(path, "r") as h, hdf5.File(path, "r") as f:
        for key in ("x", "fill"):
            want, got = h[key][()], f[key][()]
            assert got.dtype == want.dtype
            assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("version", ["earliest", "latest"])
def test_compound_reads_like_h5py(tmp_path, version):
    """Compound datatypes (numbers, fixed strings, bools, a nested
    compound, padded members) as numpy structured arrays, in datasets and
    attributes."""
    inner = np.dtype([("x", "<f8"), ("y", "<i2")])
    dt = np.dtype({"names": ["id", "pt", "name", "ok"],
                   "formats": ["<u4", inner, "S6", "?"],
                   "offsets": [0, 8, 24, 31], "itemsize": 40})
    data = np.zeros(5, dt)
    data["id"] = np.arange(5) * 7
    data["pt"]["x"] = np.linspace(0, 1, 5)
    data["pt"]["y"] = -np.arange(5)
    data["name"] = [b"a", b"bb", b"ccc", b"dddd", b"eeeee"]
    data["ok"] = [True, False, True, True, False]
    path = str(tmp_path / "c.h5")
    with h5py.File(path, "w", libver=version) as f:
        f["x"] = data
        f.create_dataset("chunked", data=np.tile(data, 4), chunks=(6,),
                         compression="gzip")
        f.attrs["rec"] = data[1]
    with h5py.File(path, "r") as h, hdf5.File(path, "r") as f:
        for key in ("x", "chunked"):
            want, got = h[key][()], f[key][()]
            assert got.dtype == want.dtype
            assert got.tobytes() == want.tobytes()
        assert f.attrs["rec"].tobytes() == h.attrs["rec"].tobytes()


@pytest.mark.parametrize("what", ["superblock", "object header", "heap",
                                  "chunk index"])
def test_corrupt_latest_metadata_raises(tmp_path, what):
    """A flipped byte in a checksummed structure of a ``libver="latest"``
    file: h5py refuses the file or the object (``OSError``, or the
    ``KeyError`` it raises when an object will not open; on a fractal
    heap header its library aborts the process); the port raises
    ``OSError`` naming the structure's checksum."""
    path = str(tmp_path / "c.h5")
    _latest_groups_file(path, "latest")
    with h5py.File(path, "a") as f:
        f.create_dataset("chunked", data=np.arange(4000).reshape(40, 100),
                         chunks=(5, 10))
    with h5py.File(path, "r") as f:
        header = h5py.h5o.get_info(f["many"].id).addr
    buf = bytearray(open(path, "rb").read())
    at = {"superblock": 20, "object header": header + 8,
          "heap": buf.index(b"FRHP") + 12,
          "chunk index": buf.index(b"FAHD") + 9}[what]
    buf[at] ^= 0x40
    open(path, "wb").write(bytes(buf))
    key = "chunked" if what == "chunk index" else "many"

    def read(opener):
        with opener(path, "r") as f:
            g = f[key]
            return g[()] if key == "chunked" else list(g.keys())

    if what != "heap":  # HDF5 1.14 aborts the process on that one
        with pytest.raises((OSError, KeyError)):
            read(h5py.File)
    with pytest.raises(OSError, match="checksum"):
        read(hdf5.File)


def test_lookup3_is_hdf5s_metadata_checksum(tmp_path):
    """Jenkins' lookup3 against the checksums h5py's library stored: the
    superblock's and every version 2 object header's."""
    from cluster_tools_tpu_torch.core.codecs import lookup3

    path = str(tmp_path / "k.h5")
    _latest_groups_file(path, "latest")
    buf = open(path, "rb").read()
    assert lookup3(buf[:44]) == int.from_bytes(buf[44:48], "little")
    with hdf5.File(path, "r") as f:  # every header verified on load
        assert len(f["many"].keys()) == 301
    for n in range(0, 40):
        data = bytes(range(n))
        assert 0 <= lookup3(data) < 2 ** 32
    assert lookup3(b"") == 0xDEADBEEF


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
