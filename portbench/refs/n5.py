"""A plain N5 reader and writer (the format's specification: big-endian
chunk headers and elements, column-major axes, ``gzip`` or ``raw``).

The benchmark writes the program's input with it and reads the program's
outputs back with it, so that neither passes through the program's own
storage layer.
"""

from __future__ import annotations

import gzip
import json
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from itertools import product
from typing import Sequence

import numpy as np


def _meta(path: str, key: str) -> dict:
    with open(os.path.join(path, key, "attributes.json")) as f:
        return json.load(f)


def write_array(path: str, key: str, arr: np.ndarray,
                chunks: Sequence[int], level: int = 1,
                threads: int = 8) -> None:
    """``arr`` as dataset ``key`` of the N5 container ``path``, gzip."""
    os.makedirs(os.path.join(path, key), exist_ok=True)
    root_attrs = os.path.join(path, "attributes.json")
    if not os.path.exists(root_attrs):
        with open(root_attrs, "w") as f:
            json.dump({"n5": "2.0.0"}, f)
    meta = {"dimensions": list(arr.shape)[::-1],
            "blockSize": list(chunks)[::-1],
            "dataType": arr.dtype.name,
            "compression": {"type": "gzip", "level": level}}
    with open(os.path.join(path, key, "attributes.json"), "w") as f:
        json.dump(meta, f)
    grid = [range(-(-s // c)) for s, c in zip(arr.shape, chunks)]
    be = arr.dtype.newbyteorder(">")

    def one(cid):
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(cid, chunks, arr.shape))
        part = np.ascontiguousarray(arr[sl], dtype=be)
        head = struct.pack(f">HH{part.ndim}I", 0, part.ndim,
                           *part.shape[::-1])
        body = gzip.compress(part.tobytes(), compresslevel=level, mtime=0)
        d = os.path.join(path, key, *[str(i) for i in cid[::-1][:-1]])
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, str(cid[::-1][-1])), "wb") as f:
            f.write(head + body)

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(one, product(*grid)))


def _decode(raw: bytes, comp: dict, dtype: np.dtype) -> np.ndarray:
    mode, ndim = struct.unpack(">HH", raw[:4])
    if mode != 0:
        raise ValueError(f"N5 chunk mode {mode} is not read here")
    dims = struct.unpack(f">{ndim}I", raw[4:4 + 4 * ndim])
    body = raw[4 + 4 * ndim:]
    kind = comp.get("type", "raw")
    if kind == "gzip":
        body = zlib.decompress(body) if comp.get("useZlib") else \
            gzip.decompress(body)
    elif kind != "raw":
        raise ValueError(f"N5 compression {kind!r} is not read here")
    n = int(np.prod(dims))
    arr = np.frombuffer(body, dtype.newbyteorder(">"), count=n)
    return arr.reshape(dims[::-1]).astype(dtype)


def read_array(path: str, key: str, threads: int = 8) -> np.ndarray:
    """The whole dataset ``key`` (absent chunks read as zeros)."""
    meta = _meta(path, key)
    shape = tuple(meta["dimensions"][::-1])
    chunks = tuple(meta["blockSize"][::-1])
    dtype = np.dtype(meta["dataType"])
    comp = meta.get("compression", {"type": "raw"})
    out = np.zeros(shape, dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]

    def one(cid):
        f = os.path.join(path, key, *[str(i) for i in cid[::-1]])
        if not os.path.exists(f):
            return
        with open(f, "rb") as fh:
            part = _decode(fh.read(), comp, dtype)
        # a writer may store border chunks whole: keep what lies inside
        sl = tuple(slice(i * c, min(i * c + p, s))
                   for i, c, p, s in zip(cid, chunks, part.shape, shape))
        out[sl] = part[tuple(slice(0, v.stop - v.start) for v in sl)]

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(one, product(*grid)))
    return out


def chunk_files(path: str, key: str):
    """Relative paths of the dataset's chunk files, sorted."""
    base = os.path.join(path, key)
    out = []
    for d, _, files in os.walk(base):
        for f in files:
            if f != "attributes.json":
                out.append(os.path.relpath(os.path.join(d, f), base))
    return sorted(out)
