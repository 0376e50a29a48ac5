"""The storage-format fixtures of this directory, and the arrays they hold.

The files here were written by tensorstore (zarr and N5) and h5py (HDF5
with ``libver="latest"``) in the forms other tools write and the port's
hand-written decoders read: blosc with Zstd, Snappy and the bitshuffle,
zarr's ``zstd`` and ``bz2`` compressors and F order, N5's ``bzip2``,
``xz`` and ``zstd``, HDF5's chunk indexes of layout version 4, dense
links and attributes, LZF, scale-offset, compound types and soft links.

No array is stored twice: :func:`expected` regenerates each from its
name with numpy alone (integer arithmetic, ``RandomState`` and IEEE
``+ - * / sqrt``, which give the same bits on every machine), so a
machine without tensorstore or h5py checks what it reads against it.

Rewrite the files (tensorstore and h5py needed) with

    python3 tests/data/torch_formats/make_fixtures.py
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: name -> (shape, dtype, kind, seed) of every array in the fixtures
ARRAYS: Dict[str, Tuple[Tuple[int, ...], str, str, int]] = {
    "smooth_u16": ((10, 40, 36), "uint16", "smooth", 1),
    "noise_u8": ((20, 40, 36), "uint8", "noise", 2),
    "frags_u64": ((20, 40, 36), "uint64", "fragments", 3),
    "rand_f32": ((10, 40, 36), "float32", "uniform", 4),
    "const_i32": ((20, 40, 36), "int32", "constant", 5),
    "big_u64": ((8, 64, 72), "uint64", "fragments", 6),
    "quarters_f32": ((24, 30), "float32", "quarters", 7),
    "signed_i16": ((24, 30), "int16", "signed", 8),
    "records": ((7,), "", "records", 9),
    "bmap": ((32, 96, 96), "uint8", "boundary", 10),
}

#: the compound type of ``records``
RECORD = np.dtype([("id", "<u4"), ("x", "<f8"), ("name", "S5"),
                   ("flag", "?")])

#: (container, key, array, codec) of every dataset a reader checks; the
#: codec names the decoder its chunks go through
CASES: List[Tuple[str, str, str, str]] = [
    ("formats.zarr", "blosc_lz4_u16", "smooth_u16", "blosc-lz4"),
    ("formats.zarr", "blosc_zstd_u16", "smooth_u16", "blosc-zstd"),
    ("formats.zarr", "blosc_zstd_u64", "frags_u64", "blosc-zstd"),
    ("formats.zarr", "blosc_snappy_u16", "smooth_u16", "blosc-snappy"),
    ("formats.zarr", "blosc_snappy_f32", "rand_f32", "blosc-snappy"),
    ("formats.zarr", "bitshuffle_u8", "noise_u8", "blosc-bitshuffle"),
    ("formats.zarr", "bitshuffle_u16", "smooth_u16", "blosc-bitshuffle"),
    ("formats.zarr", "bitshuffle_f32", "rand_f32", "blosc-bitshuffle"),
    ("formats.zarr", "bitshuffle_u64", "frags_u64", "blosc-bitshuffle"),
    ("formats.zarr", "zstd1_u16", "smooth_u16", "zstd"),
    ("formats.zarr", "zstd3_u8", "noise_u8", "zstd"),
    ("formats.zarr", "zstd19_u64", "frags_u64", "zstd"),
    ("formats.zarr", "zstd22_i32", "const_i32", "zstd"),
    ("formats.zarr", "zstd3_big", "big_u64", "zstd"),
    ("formats.zarr", "bz2_u16", "smooth_u16", "bz2"),
    ("formats.zarr", "forder_u64", "frags_u64", "zlib"),
    ("formats.n5", "bzip2_u16", "smooth_u16", "bz2"),
    ("formats.n5", "xz_f32", "rand_f32", "xz"),
    ("formats.n5", "zstd_u64", "frags_u64", "zstd"),
    ("formats.n5", "blosc_zstd_bitshuffle_u16", "smooth_u16",
     "blosc-zstd"),
    ("latest.h5", "contiguous", "smooth_u16", "raw"),
    ("latest.h5", "compact", "signed_i16", "raw"),
    ("latest.h5", "single_chunk", "smooth_u16", "deflate"),
    ("latest.h5", "fixed_array", "frags_u64", "deflate"),
    ("latest.h5", "extensible_array", "smooth_u16", "raw"),
    ("latest.h5", "btree2", "rand_f32", "deflate"),
    ("latest.h5", "lzf", "frags_u64", "lzf"),
    ("latest.h5", "scaleoffset_int", "signed_i16", "scale-offset"),
    ("latest.h5", "scaleoffset_float", "quarters_f32", "scale-offset"),
    ("latest.h5", "compound", "records", "raw"),
    ("latest.h5", "links/soft", "smooth_u16", "raw"),
    ("bmap.zarr", "bmap", "bmap", "blosc-zstd"),
    ("bmap.h5", "bmap", "bmap", "lzf"),
]

#: the links and attributes of ``latest.h5`` beside its datasets
N_LINKS, N_ATTRS = 30, 20


def _boundary(shape, seed: int) -> np.ndarray:
    """A boundary map of the cells of 24 random points: 230 where two
    cells meet, falling off as 1 / (1 + gap**2 / 4) with the gap between
    the nearest two points' distances, in steps of 8."""
    rng = np.random.RandomState(seed)
    pts = rng.rand(24, 3) * np.array(shape, np.float64)
    z, y, x = [a.reshape(-1, 1) + 0.5 for a in np.meshgrid(
        *[np.arange(s, dtype=np.float64) for s in shape], indexing="ij")]
    dz, dy, dx = z - pts[:, 0], y - pts[:, 1], x - pts[:, 2]
    dist = np.sqrt(dz * dz + dy * dy + dx * dx)
    two = np.sort(dist, axis=1)[:, :2]
    gap = two[:, 1] - two[:, 0]
    val = 230.0 / (1.0 + gap * gap / 4.0) // 8 * 8
    return val.astype(np.uint8).reshape(shape)


def expected(name: str) -> np.ndarray:
    """The array ``name`` of :data:`ARRAYS`, regenerated."""
    shape, dtype, kind, seed = ARRAYS[name]
    rng = np.random.RandomState(seed)
    n = int(np.prod(shape))
    if kind == "smooth":
        return (np.arange(n) // 7 % 1000).astype(dtype).reshape(shape)
    if kind == "noise":
        return rng.randint(0, 256, shape).astype(dtype)
    if kind == "fragments":  # label runs, as a watershed's chunks hold
        ids = rng.randint(0, 2 ** 40, n // 37 + 1).astype(np.uint64)
        return np.repeat(ids, 37)[:n].reshape(shape).astype(dtype)
    if kind == "uniform":  # in steps of 1/256: exact in any float
        return (rng.randint(0, 256, shape) / 256.0).astype(dtype)
    if kind == "constant":
        return np.full(shape, 123456, dtype)
    if kind == "quarters":  # exact under scale-offset's D-scale 2
        return (rng.randint(-4000, 4000, shape) / 4.0).astype(dtype)
    if kind == "signed":
        return rng.randint(-3000, 3000, shape).astype(dtype)
    if kind == "records":
        out = np.zeros(shape, RECORD)
        out["id"] = rng.randint(0, 2 ** 31, shape)
        out["x"] = rng.rand(*shape)
        out["name"] = [b"r%d" % i for i in range(shape[0])]
        out["flag"] = rng.randint(0, 2, shape).astype(bool)
        return out
    if kind == "boundary":
        return _boundary(shape, seed)
    raise KeyError(kind)


def link_names() -> List[str]:
    """The names of the one-element datasets in ``latest.h5``'s
    ``links`` group (more than h5py keeps compact: dense storage)."""
    return [f"item_{i:02d}" for i in range(N_LINKS)]


def attrs() -> Dict[str, object]:
    """The attributes of ``latest.h5``'s ``attrs`` group, in creation
    order (more than 8: dense storage)."""
    out: Dict[str, object] = {f"a{i:02d}": np.int64(i * i)
                              for i in range(N_ATTRS - 3)}
    out["resolution"] = np.array([40.0, 4.0, 4.0])
    out["name"] = "boundaries"
    out["offsets"] = np.arange(600, dtype=np.int64)  # a huge heap object
    return out


# ---------------------------------------------------------------------------
# writing (tensorstore and h5py)
# ---------------------------------------------------------------------------

ZARR = {
    "blosc_lz4_u16": ({"id": "blosc", "cname": "lz4", "clevel": 5,
                       "shuffle": 1}, (10, 20, 36), "C"),
    "blosc_zstd_u16": ({"id": "blosc", "cname": "zstd", "clevel": 5,
                        "shuffle": 1}, (10, 20, 36), "C"),
    "blosc_zstd_u64": ({"id": "blosc", "cname": "zstd", "clevel": 9,
                        "shuffle": 1}, (10, 40, 36), "C"),
    "blosc_snappy_u16": ({"id": "blosc", "cname": "snappy", "clevel": 5,
                          "shuffle": 1}, (10, 20, 36), "C"),
    "blosc_snappy_f32": ({"id": "blosc", "cname": "snappy", "clevel": 5,
                          "shuffle": 0}, (10, 20, 36), "C"),
    # 3 * 7 * 11 elements per chunk: not a multiple of 8
    "bitshuffle_u8": ({"id": "blosc", "cname": "lz4", "clevel": 5,
                       "shuffle": 2}, (3, 7, 11), "C"),
    "bitshuffle_u16": ({"id": "blosc", "cname": "zstd", "clevel": 5,
                        "shuffle": 2}, (10, 20, 36), "C"),
    "bitshuffle_f32": ({"id": "blosc", "cname": "lz4", "clevel": 5,
                        "shuffle": 2}, (5, 13, 9), "C"),
    "bitshuffle_u64": ({"id": "blosc", "cname": "zstd", "clevel": 5,
                        "shuffle": 2}, (10, 20, 36), "C"),
    "zstd1_u16": ({"id": "zstd", "level": 1}, (10, 20, 36), "C"),
    "zstd3_u8": ({"id": "zstd", "level": 3}, (10, 20, 36), "C"),
    "zstd19_u64": ({"id": "zstd", "level": 19}, (10, 20, 36), "C"),
    "zstd22_i32": ({"id": "zstd", "level": 22}, (20, 40, 36), "C"),
    # 288 KiB chunks: several zstd blocks each
    "zstd3_big": ({"id": "zstd", "level": 3}, (8, 64, 72), "C"),
    "bz2_u16": ({"id": "bz2", "level": 9}, (10, 20, 36), "C"),
    "forder_u64": ({"id": "zlib", "level": 5}, (10, 20, 16), "F"),
}

N5 = {
    "bzip2_u16": {"type": "bzip2", "blockSize": 9},
    "xz_f32": {"type": "xz", "preset": 6},
    "zstd_u64": {"type": "zstd", "level": 3},
    "blosc_zstd_bitshuffle_u16": {"type": "blosc", "cname": "zstd",
                                  "clevel": 5, "shuffle": 2},
}


def _array_of(container: str, key: str) -> str:
    return next(a for c, k, a, _ in CASES if c == container and k == key)


def _ts_zarr(path: str, data: np.ndarray, compressor, chunks, order):
    import tensorstore as ts

    t = ts.open({"driver": "zarr", "kvstore": {"driver": "file",
                                               "path": path},
                 "metadata": {"shape": list(data.shape),
                              "chunks": list(chunks),
                              "dtype": data.dtype.str,
                              "compressor": compressor, "order": order},
                 "create": True}).result()
    t[...] = data


def _ts_n5(path: str, data: np.ndarray, compression, chunks):
    import tensorstore as ts

    t = ts.open({"driver": "n5", "kvstore": {"driver": "file",
                                             "path": path},
                 "metadata": {"dimensions": list(data.shape[::-1]),
                              "blockSize": list(chunks[::-1]),
                              "dataType": data.dtype.name,
                              "compression": compression},
                 "create": True}).result()
    t.transpose()[...] = data  # N5's axes are the reverse of numpy's


def _write_zarr_n5() -> None:
    root = os.path.join(HERE, "formats.zarr")
    os.makedirs(root)
    with open(os.path.join(root, ".zgroup"), "w") as f:
        json.dump({"zarr_format": 2}, f)
    for key, (comp, chunks, order) in ZARR.items():
        _ts_zarr(os.path.join(root, key),
                 expected(_array_of("formats.zarr", key)), comp, chunks,
                 order)
    root = os.path.join(HERE, "formats.n5")
    os.makedirs(root)
    with open(os.path.join(root, "attributes.json"), "w") as f:
        json.dump({"n5": "2.0.0"}, f)
    for key, comp in N5.items():
        _ts_n5(os.path.join(root, key),
               expected(_array_of("formats.n5", key)), comp, (10, 20, 36))
    root = os.path.join(HERE, "bmap.zarr")
    os.makedirs(root)
    with open(os.path.join(root, ".zgroup"), "w") as f:
        json.dump({"zarr_format": 2}, f)
    _ts_zarr(os.path.join(root, "bmap"), expected("bmap"),
             {"id": "blosc", "cname": "zstd", "clevel": 5, "shuffle": 2},
             (32, 48, 48), "F")


def _write_h5() -> None:
    import h5py

    with h5py.File(os.path.join(HERE, "latest.h5"), "w",
                   libver="latest") as f:
        f.create_dataset("contiguous", data=expected("smooth_u16"))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        data = expected("signed_i16")
        h5py.h5d.create(f.id, b"compact", h5py.h5t.STD_I16LE,
                        h5py.h5s.create_simple(data.shape), dcpl=dcpl)
        f["compact"][...] = data
        data = expected("smooth_u16")
        f.create_dataset("single_chunk", data=data, chunks=data.shape,
                         compression="gzip")
        f.create_dataset("fixed_array", data=expected("frags_u64"),
                         chunks=(5, 10, 9), compression="gzip")
        data = expected("smooth_u16")
        ds = f.create_dataset("extensible_array", shape=(0, 40, 36),
                              maxshape=(None, 40, 36), chunks=(2, 20, 18),
                              dtype=data.dtype)
        ds.resize(data.shape)
        ds[...] = data
        data = expected("rand_f32")
        ds = f.create_dataset("btree2", shape=(1, 1, 36),
                              maxshape=(None, None, 36), chunks=(5, 10, 36),
                              dtype=data.dtype, compression="gzip",
                              shuffle=True)
        ds.resize(data.shape)
        ds[...] = data
        f.create_dataset("lzf", data=expected("frags_u64"),
                         chunks=(10, 20, 18), compression="lzf")
        f.create_dataset("scaleoffset_int", data=expected("signed_i16"),
                         chunks=(8, 10), scaleoffset=0)
        f.create_dataset("scaleoffset_float", data=expected("quarters_f32"),
                         chunks=(8, 10), scaleoffset=2)
        f.create_dataset("compound", data=expected("records"))
        g = f.create_group("links")
        for i, name in enumerate(link_names()):
            g[name] = np.int32(i)
        g["soft"] = h5py.SoftLink("/contiguous")
        g["relative"] = h5py.SoftLink("item_03")
        g = f.create_group("attrs", track_order=True)
        for k, v in attrs().items():
            g.attrs[k] = v
    with h5py.File(os.path.join(HERE, "bmap.h5"), "w",
                   libver="latest") as f:
        f.create_dataset("bmap", data=expected("bmap"), chunks=(32, 48, 48),
                         compression="lzf")


def main() -> None:
    for name in ("formats.zarr", "formats.n5", "bmap.zarr", "latest.h5",
                 "bmap.h5"):
        path = os.path.join(HERE, name)
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)
    _write_zarr_n5()
    _write_h5()


if __name__ == "__main__":
    main()
