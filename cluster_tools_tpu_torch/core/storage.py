"""Chunked volume storage (L0): N5, zarr v2, HDF5 and Knossos.

Re-specification of the reference's storage layer
(cluster_tools/utils/volume_utils.py:33-43 `file_reader` dispatching to
z5py/h5py; datasets are numpy-sliceable, support `require_dataset`,
per-chunk reads/writes and parallel IO).  The chunk engine is written here
with numpy, the standard library (``zlib`` / ``gzip`` / ``bz2`` /
``lzma``) and the package's own codecs (``core/blosc.py``,
``core/codecs.py``), so the package needs no storage library.  It reads
and writes the on-disk formats that tensorstore writes:

* N5: ``attributes.json`` metadata in column-major axis order; each chunk
  is a big-endian header (mode, ndim, chunk dims, column-major) followed by
  the big-endian elements, ``raw``, ``gzip`` or (read only) ``bzip2``,
  ``xz``, ``zstd`` or ``blosc`` compressed.  Edge chunks are written at
  the full block size (tensorstore's convention) and read at whatever
  size their header states (z5/n5-java truncate them).  ``compression="blosc"`` creates raw chunks,
  as the JAX package does.
* zarr v2: ``.zarray`` metadata, C order (F order read only), ``null``,
  ``zlib`` or ``blosc`` compressor (``bz2`` and ``zstd`` read only),
  full-size edge chunks.  ``filters`` raise by name.  tensorstore's
  ``"bfloat16"`` reads as uint16 bits.  :func:`open_zarr_array` reads an
  array through a key-value store: a directory, or the OCDBT store of an
  orbax checkpoint (``core/ocdbt.py``).

HDF5 files (``.h5``/``.hdf``/``.hdf5``) go through the package's own
reader and writer (``core/hdf5.py``), Knossos pyramids (read only) through
``utils/knossos.py``.

Missing chunks read as the fill value 0.  Chunk writes are atomic (a
temporary file, then a rename); a write that does not cover a whole chunk
is a read-modify-write under a per-chunk lock.

Irregular ("varlen") per-block results — cut-edge lists, sub-solutions —
use a dedicated :class:`VarlenDataset` of per-chunk flat files instead of
z5's varlen chunk encoding.

The store doubles as the inter-task data plane exactly as in the reference
(SURVEY.md §2.5): chunk-aligned block writes guarantee one writer per chunk.
"""

from __future__ import annotations

import bz2
import gzip
import json
import lzma
import os
import struct
import threading
import zlib
from itertools import product
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import blosc, codecs, hdf5
from .config import write_config

_N5_DTYPES = ("uint8", "uint16", "uint32", "uint64", "int8", "int16",
              "int32", "int64", "float32", "float64")


# ---------------------------------------------------------------------------
# attrs
# ---------------------------------------------------------------------------

class AttrsView:
    """Dict-like JSON attributes attached to a group/dataset.

    zarr v2 keeps user attributes in ``.zattrs``; N5 merges them into
    ``attributes.json`` alongside the array metadata (reserved keys are
    protected).  Mirrors z5py/h5py ``.attrs`` usage in the reference
    (e.g. ``maxId`` in write/write.py:269-277).
    """

    _N5_RESERVED = {"dimensions", "blockSize", "dataType", "compression"}

    def __init__(self, path: str, flavor: str, is_dataset: bool = False):
        # the reserved-key guard protects N5 *array* metadata only; group
        # attributes legitimately use these names
        self._guard = flavor == "n5" and is_dataset
        if flavor == "zarr":
            self._file = os.path.join(path, ".zattrs")
        else:
            self._file = os.path.join(path, "attributes.json")
        self._lock = threading.Lock()

    def _load(self) -> Dict[str, Any]:
        if not os.path.exists(self._file):
            return {}
        with open(self._file) as f:
            return json.load(f)

    def _store(self, data: Dict[str, Any]) -> None:
        write_config(self._file, data)

    def __getitem__(self, key: str) -> Any:
        return self._load()[key]

    def __setitem__(self, key: str, value: Any) -> None:
        if self._guard and key in self._N5_RESERVED:
            raise KeyError(f"{key} is reserved N5 metadata")
        with self._lock:  # ctt-lint: disable=blocking-under-lock (the attrs-file load-modify-store IS the critical section; the lock exists to serialize exactly this IO)
            data = self._load()
            data[key] = value
            self._store(data)

    def __contains__(self, key: str) -> bool:
        return key in self._load()

    def get(self, key: str, default: Any = None) -> Any:
        return self._load().get(key, default)

    def update(self, other: Dict[str, Any]) -> None:
        with self._lock:  # ctt-lint: disable=blocking-under-lock (the attrs-file load-modify-store IS the critical section; the lock exists to serialize exactly this IO)
            data = self._load()
            data.update(other)
            self._store(data)

    def keys(self):
        return self._load().keys()


# ---------------------------------------------------------------------------
# chunk codecs
# ---------------------------------------------------------------------------

def _atomic_write(path: str, payload: bytes) -> None:
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)


class _N5Codec:
    """N5 chunk format: big-endian header + big-endian C-order elements
    (C order over the numpy axes is column-major over N5's axes).  Reads
    ``raw``, ``gzip``, ``bzip2``, ``xz``, ``zstd`` and ``blosc`` chunks;
    writes ``raw`` and ``gzip``."""

    _READ = ("raw", "gzip", "bzip2", "xz", "zstd", "blosc")

    def __init__(self, meta: Dict[str, Any]):
        comp = meta.get("compression", {"type": "raw"})
        self.kind = comp.get("type", "raw")
        if self.kind not in self._READ:
            raise NotImplementedError(
                f"N5 compression {self.kind!r} is not supported")
        self.use_zlib = bool(comp.get("useZlib", False))
        self.level = int(comp.get("level", 1))
        if self.level < 0:
            self.level = 6
        self.dtype = np.dtype(meta["dataType"])
        self.be = self.dtype.newbyteorder(">")

    def decode(self, raw: bytes) -> np.ndarray:
        mode, ndim = struct.unpack(">HH", raw[:4])
        if mode != 0:
            raise NotImplementedError(f"N5 chunk mode {mode} (varlength)")
        dims = struct.unpack(f">{ndim}I", raw[4:4 + 4 * ndim])
        body = raw[4 + 4 * ndim:]
        n = int(np.prod(dims))
        if self.kind == "gzip":
            body = zlib.decompress(body) if self.use_zlib else \
                gzip.decompress(body)
        elif self.kind == "bzip2":
            body = bz2.decompress(body)
        elif self.kind == "xz":
            body = lzma.decompress(body)
        elif self.kind == "zstd":
            body = codecs.zstd_decompress(body, n * self.be.itemsize)
        elif self.kind == "blosc":
            body = blosc.decompress(body)
        arr = np.frombuffer(body, self.be, count=n)
        return arr.reshape(dims[::-1]).astype(self.dtype)

    def encode(self, arr: np.ndarray) -> bytes:
        head = struct.pack(f">HH{arr.ndim}I", 0, arr.ndim, *arr.shape[::-1])
        body = np.ascontiguousarray(arr, dtype=self.be).tobytes()
        if self.kind not in ("raw", "gzip"):
            raise NotImplementedError(
                f"writing N5 {self.kind} chunks is not supported (creation "
                "writes raw or gzip)")
        if self.kind == "gzip":
            body = zlib.compress(body, self.level) if self.use_zlib else \
                gzip.compress(body, compresslevel=self.level, mtime=0)
        return head + body


class _ZarrCodec:
    """zarr v2 chunk format: the elements in the metadata's byte order and
    C or F order (returned C-contiguous), ``null``, ``zlib``/``gzip``,
    ``bz2``, ``zstd`` or ``blosc`` compressed.  Writes C order, ``null``,
    ``zlib``/``gzip`` and ``blosc``.  tensorstore's dtype ``"bfloat16"``
    (which numpy does not know) reads as the elements' little-endian
    uint16 bits (``bfloat16`` is then true)."""

    _READ = (None, "zlib", "gzip", "bz2", "zstd", "blosc")

    def __init__(self, meta: Dict[str, Any]):
        self.order = meta.get("order", "C")
        if self.order not in ("C", "F"):
            raise NotImplementedError(f"zarr order {self.order!r}")
        if meta.get("filters"):
            raise NotImplementedError("zarr filters are not supported")
        comp = meta.get("compressor")
        self.kind = None if comp is None else comp.get("id")
        if self.kind not in self._READ:
            raise NotImplementedError(
                f"zarr compressor {self.kind!r} is not supported")
        self.level = int((comp or {}).get("level", 1))
        self.blosc = comp if self.kind == "blosc" else None
        self.bfloat16 = meta["dtype"] == "bfloat16"
        self.disk = np.dtype("<u2" if self.bfloat16 else meta["dtype"])
        self.dtype = self.disk.newbyteorder("=")
        self.chunks = tuple(meta["chunks"])

    def decode(self, raw: bytes) -> np.ndarray:
        if self.kind == "zlib":
            raw = zlib.decompress(raw)
        elif self.kind == "gzip":
            raw = gzip.decompress(raw)
        elif self.kind == "bz2":
            raw = bz2.decompress(raw)
        elif self.kind == "zstd":
            raw = codecs.zstd_decompress(
                raw, int(np.prod(self.chunks)) * self.disk.itemsize)
        elif self.kind == "blosc":
            raw = blosc.decompress(raw)
        arr = np.frombuffer(raw, self.disk).reshape(self.chunks,
                                                    order=self.order)
        # (ascontiguousarray makes a 0-d array 1-d)
        return np.ascontiguousarray(arr, dtype=self.dtype).reshape(
            arr.shape)

    def encode(self, arr: np.ndarray) -> bytes:
        if self.order != "C" or self.kind in ("bz2", "zstd"):
            raise NotImplementedError(
                f"writing zarr {self.order}-order {self.kind} chunks is not "
                "supported (creation writes C order, zlib or blosc)")
        body = np.ascontiguousarray(arr, dtype=self.disk).tobytes()
        if self.kind == "zlib":
            return zlib.compress(body, self.level)
        if self.kind == "gzip":
            return gzip.compress(body, compresslevel=self.level, mtime=0)
        if self.kind == "blosc":
            return blosc.compress(body, self.disk.itemsize,
                                  clevel=int(self.blosc.get("clevel", 5)),
                                  shuffle=int(self.blosc.get("shuffle", 1)),
                                  cname=self.blosc.get("cname", "lz4"))
        return body


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------

#: per-chunk-file locks for partial-chunk read-modify-writes
_CHUNK_LOCKS: Dict[str, threading.Lock] = {}
_CHUNK_LOCKS_GUARD = threading.Lock()


def _chunk_lock(path: str) -> threading.Lock:
    with _CHUNK_LOCKS_GUARD:
        lock = _CHUNK_LOCKS.get(path)
        if lock is None:
            lock = _CHUNK_LOCKS[path] = threading.Lock()
        return lock


def _normalize_index(bb, shape) -> Tuple[Tuple[slice, ...], List[int]]:
    """numpy-style basic index -> (per-axis unit-step slices, axes that were
    integers and are squeezed from the result)."""
    if not isinstance(bb, tuple):
        bb = (bb,)
    if any(b is Ellipsis for b in bb):
        i = next(i for i, b in enumerate(bb) if b is Ellipsis)
        fill = (slice(None),) * (len(shape) - len(bb) + 1)
        bb = bb[:i] + fill + bb[i + 1:]
    bb = bb + (slice(None),) * (len(shape) - len(bb))
    if len(bb) != len(shape):
        raise IndexError(f"index {bb} has too many axes for shape {shape}")
    out, squeeze = [], []
    for ax, (b, n) in enumerate(zip(bb, shape)):
        if isinstance(b, slice):
            start, stop, step = b.indices(n)
            if step != 1:
                raise IndexError("strided dataset indexing is not supported")
            out.append(slice(start, max(start, stop)))
        else:
            i = int(b)
            i = i + n if i < 0 else i
            if not 0 <= i < n:
                raise IndexError(f"index {b} out of range for axis {ax}")
            out.append(slice(i, i + 1))
            squeeze.append(ax)
    return tuple(out), squeeze


class DirectoryKV:
    """A directory as a key-value store: a key is a ``/``-separated path
    under it.  A chunked array reads its chunks through this interface
    (``get`` and ``has``), which ``core/ocdbt.py``'s store offers too.
    A key that would leave the directory raises ``OSError``, as a data
    file path of an OCDBT store does."""

    def __init__(self, path: str):
        self.path = path

    def file(self, key: str) -> str:
        parts = key.split("/")
        if key.startswith("/") or ".." in parts or "\0" in key:
            raise OSError(f"{self.path}: key {key!r} leaves the directory")
        return os.path.join(self.path, *parts)

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(self.file(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def has(self, key: str) -> bool:
        return os.path.exists(self.file(key))


class Dataset:
    """A chunked N5/zarr array with numpy-style slicing (C-order axes).

    Its chunks are files under ``path``; or, read only, the keys under
    ``prefix`` of a key-value store ``kv`` (:func:`open_zarr_array`).
    ``n_threads`` is accepted for reference API compatibility (z5's
    ds.n_threads, multicut/solve_subproblems.py:241) and ignored."""

    def __init__(self, path: str, flavor: str, meta: Dict[str, Any],
                 kv=None, prefix: str = ""):
        self.path = path
        self.flavor = flavor
        self._kv = DirectoryKV(path) if kv is None else kv
        self._prefix = prefix
        self._writable = kv is None
        self.attrs = AttrsView(path, flavor, is_dataset=True)
        self.n_threads = 1
        if flavor == "n5":
            self._shape = tuple(int(d) for d in meta["dimensions"][::-1])
            self._chunks = tuple(int(c) for c in meta["blockSize"][::-1])
            self._codec = _N5Codec(meta)
        else:
            self._shape = tuple(int(d) for d in meta["shape"])
            self._chunks = tuple(int(c) for c in meta["chunks"])
            self._codec = _ZarrCodec(meta)
            self._sep = meta.get("dimension_separator", ".")
            self._fill = meta.get("fill_value") or 0
            if self._codec.bfloat16 and self._fill:
                raise NotImplementedError(
                    f"{path}: bfloat16 fill value {self._fill!r} (null "
                    "and 0 are read)")
        self._dtype = self._codec.dtype

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def size(self) -> int:
        return int(np.prod(self._shape))

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @property
    def chunks(self) -> Tuple[int, ...]:
        return self._chunks

    @property
    def bfloat16(self) -> bool:
        """True for a zarr array of tensorstore's ``"bfloat16"``: the
        elements read as their uint16 bits (``dtype`` is uint16); view
        them as ``torch.bfloat16``."""
        return self.flavor == "zarr" and self._codec.bfloat16

    # -- chunk files -----------------------------------------------------
    def _chunk_key(self, chunk_id: Sequence[int]) -> str:
        if self.flavor == "zarr":
            # a zero-dimensional array's one chunk is "0"
            return self._prefix + (self._sep.join(str(c) for c in chunk_id)
                                   or "0")
        # N5 chunk directories are column-major: reverse the chunk id
        return self._prefix + "/".join(str(c)
                                       for c in reversed(tuple(chunk_id)))

    def _chunk_file(self, chunk_id: Sequence[int]) -> str:
        return self._kv.file(self._chunk_key(chunk_id))

    def _chunk_bb(self, chunk_id: Sequence[int]) -> Tuple[slice, ...]:
        return tuple(slice(c * cs, min((c + 1) * cs, s))
                     for c, cs, s in zip(chunk_id, self._chunks, self._shape))

    def _load_chunk(self, chunk_id) -> Optional[np.ndarray]:
        """The chunk's elements at its stored size, or None if missing."""
        raw = self._kv.get(self._chunk_key(chunk_id))
        return None if raw is None else self._codec.decode(raw)

    def _store_chunk(self, chunk_id, full: np.ndarray) -> None:
        path = self._chunk_file(chunk_id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _atomic_write(path, self._codec.encode(full))

    def _empty_chunk(self) -> np.ndarray:
        fill = self._fill if self.flavor == "zarr" else 0
        return np.full(self._chunks, fill, self._dtype)

    def _chunks_of(self, sl: Tuple[slice, ...]):
        ranges = [range(s.start // c, -(-s.stop // c)) if s.stop > s.start
                  else range(0) for s, c in zip(sl, self._chunks)]
        return product(*ranges)

    # -- numpy surface ---------------------------------------------------
    def __getitem__(self, bb) -> np.ndarray:
        sl, squeeze = _normalize_index(bb, self._shape)
        out = np.zeros([s.stop - s.start for s in sl], self._dtype)
        if self.flavor == "zarr" and self._fill:
            out[...] = self._fill
        for cid in self._chunks_of(sl):
            data = self._load_chunk(cid)
            if data is None:
                continue
            src, dst = [], []
            for c, cs, s, n in zip(cid, self._chunks, sl, data.shape):
                lo = max(s.start, c * cs)
                hi = min(s.stop, c * cs + n)
                if hi <= lo:
                    break
                src.append(slice(lo - c * cs, hi - c * cs))
                dst.append(slice(lo - s.start, hi - s.start))
            else:
                out[tuple(dst)] = data[tuple(src)]
        return out.squeeze(axis=tuple(squeeze)) if squeeze else out

    def __setitem__(self, bb, value) -> None:
        if not self._writable:
            raise NotImplementedError(f"{self.path}: an array read from a "
                                      "key-value store is read only")
        sl, squeeze = _normalize_index(bb, self._shape)
        region = [s.stop - s.start for s in sl]
        arr = np.asarray(value)
        if squeeze:
            arr = np.expand_dims(arr, tuple(squeeze)) if arr.ndim else arr
        arr = np.broadcast_to(arr.astype(self._dtype, copy=False), region)
        for cid in self._chunks_of(sl):
            cbb = self._chunk_bb(cid)
            inter = [slice(max(s.start, c.start), min(s.stop, c.stop))
                     for s, c in zip(sl, cbb)]
            src = tuple(slice(i.start - s.start, i.stop - s.start)
                        for i, s in zip(inter, sl))
            dst = tuple(slice(i.start - c.start, i.stop - c.start)
                        for i, c in zip(inter, cbb))
            whole = all(i == c for i, c in zip(inter, cbb))
            if whole:
                full = self._empty_chunk()
                full[dst] = arr[src]
                self._store_chunk(cid, full)
                continue
            with _chunk_lock(self._chunk_file(cid)):
                full = self._empty_chunk()
                old = self._load_chunk(cid)
                if old is not None:
                    full[tuple(slice(0, n) for n in old.shape)] = old
                full[dst] = arr[src]
                self._store_chunk(cid, full)

    # chunk-wise access (reference: z5 read_chunk/write_chunk,
    # multicut/solve_subproblems.py:206, multicut/reduce_problem.py:134)
    def read_chunk(self, chunk_id: Sequence[int]) -> Optional[np.ndarray]:
        """None for chunks never written; a present all-zero chunk returns
        zeros (z5 semantics distinguish missing from zero)."""
        if not self._kv.has(self._chunk_key(chunk_id)):
            return None
        return self[self._chunk_bb(chunk_id)]

    def write_chunk(self, chunk_id: Sequence[int], data: np.ndarray) -> None:
        bb = self._chunk_bb(chunk_id)
        self[bb] = np.asarray(data).reshape([s.stop - s.start for s in bb])

    def find_max(self) -> float:
        return float(np.max(self[...]))


def open_zarr_array(kv, key: str) -> Dataset:
    """The zarr v2 array stored under ``key`` of the key-value store
    ``kv`` (``.zarray`` and the chunks at ``<key>/<chunk>``; a
    :class:`DirectoryKV` or ``core.ocdbt.OcdbtStore``), read only."""
    raw = kv.get(f"{key}/.zarray")
    if raw is None:
        raise KeyError(f"no zarr array {key!r} in {kv.path}")
    return Dataset(f"{kv.path}/{key}", "zarr", json.loads(raw), kv=kv,
                   prefix=f"{key}/")


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

class _Container:
    """An N5 or zarr container directory holding groups and datasets."""

    flavor: str = ""
    _meta_name: str = ""

    def __init__(self, path: str, mode: str = "a"):
        self.path = path
        self.mode = mode
        if mode != "r":
            os.makedirs(path, exist_ok=True)
            self._init_root()
        self.attrs = AttrsView(path, self.flavor)
        self._cache: Dict[str, Dataset] = {}

    def _init_root(self) -> None:
        raise NotImplementedError

    def _read_meta(self, key: str) -> Optional[Dict[str, Any]]:
        meta = os.path.join(self.path, key, self._meta_name)
        if not os.path.exists(meta):
            return None
        with open(meta) as f:
            data = json.load(f)
        return data if self._is_array_meta(data) else None

    def _is_array_meta(self, meta: Dict[str, Any]) -> bool:
        raise NotImplementedError

    def _create_meta(self, shape, chunks, dtype, compression) -> Dict:
        raise NotImplementedError

    def __contains__(self, key: str) -> bool:
        return os.path.isdir(os.path.join(self.path, key))

    def __getitem__(self, key: str):
        if key not in self._cache:
            meta = self._read_meta(key)
            if meta is None:
                if key in self:
                    return self.require_group(key)
                raise KeyError(key)
            self._cache[key] = Dataset(os.path.join(self.path, key),
                                       self.flavor, meta)
        return self._cache[key]

    def require_group(self, key: str) -> "_Container":
        return type(self)(os.path.join(self.path, key), mode=self.mode)

    def require_dataset(self, key: str,
                        shape: Optional[Sequence[int]] = None,
                        chunks: Optional[Sequence[int]] = None,
                        dtype=None, compression: str = "raw",
                        data: Optional[np.ndarray] = None,
                        **_ignored: Any) -> Dataset:
        """Create-if-absent (reference: watershed/watershed.py:82-84).
        ``data=`` infers shape/dtype from the array and writes it after
        creation (z5py/h5py semantics: only on creation)."""
        if data is not None:
            data = np.asarray(data)
            shape = data.shape if shape is None else shape
            dtype = data.dtype if dtype is None else dtype
        if shape is None or dtype is None:
            raise TypeError("require_dataset needs shape+dtype or data=")
        shape = tuple(int(s) for s in shape)
        chunks = shape if chunks is None else tuple(int(c) for c in chunks)
        exists = self._read_meta(key) is not None
        if not exists:
            target = os.path.join(self.path, key)
            os.makedirs(target, exist_ok=True)
            meta = self._create_meta(shape, chunks, np.dtype(dtype),
                                     compression)
            write_config(os.path.join(target, self._meta_name), meta)
            self._cache.pop(key, None)
        ds = self[key]
        if tuple(ds.shape) != shape:
            raise ValueError(f"existing dataset {key} has shape {ds.shape}, "
                             f"requested {shape}")
        if data is not None and not exists:
            ds[tuple(slice(0, s) for s in shape)] = data
        return ds

    create_dataset = require_dataset

    def close(self) -> None:
        self._cache.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ZarrFile(_Container):
    flavor = "zarr"
    _meta_name = ".zarray"

    def _init_root(self) -> None:
        if not os.path.exists(os.path.join(self.path, ".zgroup")) and \
                not os.path.exists(os.path.join(self.path, ".zarray")):
            write_config(os.path.join(self.path, ".zgroup"),
                         {"zarr_format": 2})

    def _is_array_meta(self, meta):
        return "shape" in meta and "chunks" in meta

    def _create_meta(self, shape, chunks, dtype, compression):
        compressor = None
        if compression in ("gzip", "zlib"):
            compressor = {"id": "zlib", "level": 1}
        elif compression in ("blosc", "lz4"):
            # zarr-python's default and the JAX package's blosc settings
            compressor = {"blocksize": 0, "clevel": 5, "cname": "lz4",
                          "id": "blosc", "shuffle": 1}
        return {"zarr_format": 2, "shape": list(shape),
                "chunks": list(chunks), "dtype": dtype.newbyteorder("<").str,
                "compressor": compressor, "fill_value": 0, "filters": None,
                "order": "C", "dimension_separator": "."}


class N5File(_Container):
    flavor = "n5"
    _meta_name = "attributes.json"

    def _init_root(self) -> None:
        attrs = os.path.join(self.path, "attributes.json")
        if not os.path.exists(attrs):
            write_config(attrs, {"n5": "2.0.0"})

    def _is_array_meta(self, meta):
        return "dimensions" in meta

    def _create_meta(self, shape, chunks, dtype, compression):
        if dtype.name not in _N5_DTYPES:
            raise ValueError(f"dtype {dtype.name} not supported by N5")
        # as the JAX package: only gzip/zlib compress, anything else
        # (blosc included) writes raw chunks
        comp = ({"type": "gzip", "level": 1, "useZlib": False}
                if compression in ("gzip", "zlib") else {"type": "raw"})
        # N5 metadata is column-major: numpy-order shapes are reversed
        return {"dimensions": list(shape)[::-1],
                "blockSize": list(chunks)[::-1],
                "dataType": dtype.name, "compression": comp}


# ---------------------------------------------------------------------------
# HDF5 (core/hdf5.py)
# ---------------------------------------------------------------------------

class _H5Dataset:
    """The :class:`Dataset` surface over an HDF5 dataset (the JAX
    package's adapter of h5py datasets)."""

    def __init__(self, ds: hdf5.Dataset):
        self._ds = ds
        self.n_threads = 1

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._ds.shape)

    @property
    def ndim(self) -> int:
        return self._ds.ndim

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(self._ds.dtype)

    @property
    def chunks(self) -> Tuple[int, ...]:
        return tuple(self._ds.chunks) if self._ds.chunks else \
            tuple(self._ds.shape)

    @property
    def attrs(self):
        return self._ds.attrs

    def __getitem__(self, bb):
        return self._ds[bb]

    def __setitem__(self, bb, value):
        self._ds[bb] = value

    def find_max(self) -> float:
        return float(np.max(self._ds[...]))


class H5File:
    """An ``.h5`` container with the N5/zarr containers' surface: groups
    are :mod:`core.hdf5` groups, datasets :class:`_H5Dataset`."""

    flavor = "h5"

    def __init__(self, path: str, mode: str = "a"):
        self.path = path
        self._f = hdf5.File(path, mode)
        self.attrs = self._f.attrs

    def __contains__(self, key: str) -> bool:
        return key in self._f

    def __getitem__(self, key: str):
        obj = self._f[key]
        if isinstance(obj, hdf5.Dataset):
            return _H5Dataset(obj)
        return obj

    def require_group(self, key: str):
        return self._f.require_group(key)

    create_group = require_group

    def require_dataset(self, key: str,
                        shape: Optional[Sequence[int]] = None,
                        chunks: Optional[Sequence[int]] = None,
                        dtype=None, compression: Optional[str] = None,
                        data: Optional[np.ndarray] = None,
                        **_ignored: Any) -> _H5Dataset:
        """Create-if-absent; ``chunks`` defaults to the whole shape,
        ``compression="raw"`` means none, ``data=`` fills the dataset only
        when it is created."""
        if compression == "raw":
            compression = None
        if data is not None:
            data = np.asarray(data)
            shape = data.shape if shape is None else shape
            dtype = data.dtype if dtype is None else dtype
        if shape is None or dtype is None:
            raise TypeError("require_dataset needs shape+dtype or data=")
        chunks = tuple(shape) if chunks is None else tuple(chunks)
        exists = key in self._f
        ds = self._f.require_dataset(key, shape=tuple(shape), dtype=dtype,
                                     chunks=chunks, compression=compression)
        if data is not None and not exists:
            ds[...] = data
        return _H5Dataset(ds)

    create_dataset = require_dataset

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# varlen per-chunk results
# ---------------------------------------------------------------------------

class VarlenDataset:
    """Variable-length per-chunk flat arrays (replaces z5 varlen chunks used for
    cut-edge ids / per-block node results, multicut/solve_subproblems.py:204-211).

    Layout: one ``.npy`` file per chunk id under a directory, plus JSON attrs.
    Chunk writes are single-writer by construction (one block -> one chunk),
    matching the reference's race-freedom-by-layout design (SURVEY.md §5.2).
    """

    def __init__(self, path: str, dtype="uint64", mode: str = "a"):
        self.path = path
        if mode == "r":
            # a read must not mutate the container
            if not os.path.isdir(path):
                raise FileNotFoundError(
                    f"varlen dataset not found: {path}")
        else:
            os.makedirs(path, exist_ok=True)
        self.dtype = np.dtype(dtype)
        self.attrs = AttrsView(path, "n5")

    def _chunk_file(self, chunk_id: Sequence[int]) -> str:
        return os.path.join(self.path, "chunk_" + "_".join(map(str, chunk_id)) + ".npy")

    def write_chunk(self, chunk_id: Sequence[int], data: np.ndarray) -> None:
        arr = np.ascontiguousarray(data, dtype=self.dtype)
        tmp = self._chunk_file(chunk_id) + ".tmp"
        with open(tmp, "wb") as f:
            np.save(f, arr)
        os.replace(tmp, self._chunk_file(chunk_id))

    def read_chunk(self, chunk_id: Sequence[int]) -> Optional[np.ndarray]:
        f = self._chunk_file(chunk_id)
        if not os.path.exists(f):
            return None
        return np.load(f)

    def chunk_ids(self):
        out = []
        for name in sorted(os.listdir(self.path)):
            if name.startswith("chunk_") and name.endswith(".npy"):
                out.append(tuple(int(p) for p in name[6:-4].split("_")))
        return out


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

HDF5_EXTS = {".h5", ".hdf", ".hdf5"}
ZARR_EXTS = {".zarr", ".zr"}
N5_EXTS = {".n5"}
KNOSSOS_EXTS = {".knossos", ".k"}


def file_reader(path: str, mode: str = "a"):
    """Open a container by extension (reference: utils/volume_utils.py:33-43,
    incl. the read-only Knossos pyramid dispatch)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in N5_EXTS:
        return N5File(path, mode)
    if ext in ZARR_EXTS:
        return ZarrFile(path, mode)
    if ext in HDF5_EXTS:
        return H5File(path, mode)
    if ext in KNOSSOS_EXTS:
        from ..utils.knossos import KnossosFile

        return KnossosFile(path, mode="r")
    raise ValueError(f"unsupported container extension: {path}")


def get_shape(path: str, key: str) -> Tuple[int, ...]:
    with file_reader(path, "r") as f:
        return tuple(f[key].shape)


def read_max_id(path: str, key: str) -> int:
    """The maxId dataset attribute (written by the write tasks) as int;
    raises with guidance when absent."""
    with file_reader(path, "r") as f:
        ds = f[key]
        if "maxId" in ds.attrs:
            return int(ds.attrs["maxId"])
    raise ValueError(
        f"{path}:{key} has no maxId attribute; write tasks record it -- "
        "pass n_labels explicitly for volumes produced outside the framework")
