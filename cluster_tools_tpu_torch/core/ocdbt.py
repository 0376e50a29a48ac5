"""A read-only reader of tensorstore's OCDBT key-value store.

OCDBT ("optionally cooperative distributed B+tree") is the store that
orbax writes a checkpoint's arrays into (``models/orbax.py``): one
directory holding ``manifest.ocdbt`` and data files under ``d/`` (orbax
adds one sub-database per process, ``ocdbt.process_<i>/``, and a merged
tree at the top).  The port reads it with the standard library, numpy and
its own codecs (``core/codecs.py``: Zstandard and CRC-32C), so the card's
machine needs neither tensorstore nor orbax.

Every manifest and B+tree node is framed the same way:

    magic        u32 big-endian (manifest 0x0cdb3a2a, B+tree node 0x0cdb20de)
    length       u64 little-endian, of the whole frame
    version      varint, 0
    compression  varint, 0 (none) or 1 (zstd, one frame)
    body         compressed as stated
    crc32c       u32 little-endian, of every byte before it

Varints are unsigned LEB128.  Lists are stored column by column.

* The manifest body: the config (a 16-byte uuid, the manifest kind, the
  largest inline value, the largest decoded node, the version tree's
  arity, the node compression and its zstd level as an int32), a data
  file table, the versions stored inline (generation, root height, root
  location, root statistics, commit time) and references to version-tree
  nodes of older versions (not read: only the newest version is).
* A B+tree node body: its height, a data file table, its entries' keys
  (each sharing a prefix with the one before it), and then, in a leaf,
  each value's length and kind (0 inline, 1 a reference to bytes of a
  data file) and the references' files and offsets, then the inline
  values; in an interior node, each child's key prefix common to its
  whole subtree (the child stores its keys without it), location and
  statistics.
* A data file table lists paths relative to the database's directory,
  each split into a base path and a relative path.  The base path of the
  file a node was read from is prepended to the paths of that node's
  table: a tree merged from ``ocdbt.process_0/`` keeps its nodes as they
  were written there.

Each checksum is verified; a mismatch, a frame that does not parse, a
data file path that leaves the directory or a value past the end of
its file raises ``OSError`` naming the file.  What the reader does not cover
raises ``NotImplementedError`` naming what it found: a format version
other than 0, a compression other than none and zstd, a numbered
manifest (``manifest_kind`` 1), a value kind other than inline and
data-file reference.
"""

from __future__ import annotations

import bisect
import os
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

from . import codecs

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
#: the offset and length of the root of an empty tree
_MISSING = 2 ** 64 - 1
#: the most a manifest may decode to (its nodes' bound is in its config)
_MANIFEST_LIMIT = 1 << 28

Key = Union[bytes, str]


class _DataFile(NamedTuple):
    """A data file: its path under the top directory, and the base path
    prepended to the tables of the nodes read from it."""

    path: str
    base: str


class _Ref(NamedTuple):
    """``length`` bytes at ``offset`` of a data file."""

    file: _DataFile
    offset: int
    length: int


class _Node(NamedTuple):
    height: int
    keys: List[bytes]
    #: leaf: the values (bytes or a _Ref); interior: (child, common
    #: prefix length) pairs
    entries: list


class _Cursor:
    """Reads the fields of a decoded body; running short raises
    ``OSError`` naming the file."""

    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def corrupt(self, what: str) -> OSError:
        return OSError(f"{self.where}: corrupt OCDBT data ({what})")

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise self.corrupt("truncated")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def u8(self) -> int:
        return self.take(1)[0]

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            if self.pos >= len(self.data) or shift > 63:
                raise self.corrupt("bad varint")
            c = self.data[self.pos]
            self.pos += 1
            out |= (c & 0x7F) << shift
            shift += 7
            if c < 0x80:
                return out

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise self.corrupt(f"{len(self.data) - self.pos} trailing bytes")


def _unframe(data: bytes, magic: int, where: str, limit: int) -> _Cursor:
    """The body of one manifest or node frame, checked and decompressed."""
    what = "manifest" if magic == MANIFEST_MAGIC else "B+tree node"
    if len(data) < 18 or struct.unpack(">I", data[:4])[0] != magic:
        raise OSError(f"{where}: not an OCDBT {what}")
    if struct.unpack("<Q", data[4:12])[0] != len(data):
        raise OSError(f"{where}: OCDBT {what} length does not match")
    want = struct.unpack("<I", data[-4:])[0]
    if codecs.crc32c(memoryview(data)[:-4]) != want:
        raise OSError(f"{where}: OCDBT {what} checksum mismatch")
    head = _Cursor(data[12:-4], where)
    version = head.varint()
    if version != 0:
        raise NotImplementedError(f"{where}: OCDBT format version "
                                  f"{version}")
    method = head.varint()
    body = head.data[head.pos:]
    if method == 1:
        try:
            body = codecs.zstd_decompress_unsized(body, limit).tobytes()
        except ValueError as e:
            raise OSError(f"{where}: OCDBT {what}: {e}") from None
    elif method != 0:
        raise NotImplementedError(f"{where}: OCDBT compression {method} "
                                  "(0 none and 1 zstd are read)")
    return _Cursor(body, where)


def _data_files(cur: _Cursor, base: str) -> List[_DataFile]:
    n = cur.varint()
    prefix = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    base_len = cur.varints(n)
    out: List[_DataFile] = []
    prev = b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise cur.corrupt("data file path prefix")
        path = prev[:prefix[i]] + cur.take(suffix[i])
        try:
            text, head = path.decode(), path[:base_len[i]].decode()
        except UnicodeDecodeError:
            text = head = "\0"
        # a relative path that stays under the database's directory
        if base_len[i] > len(path) or "\0" in text + head or \
                text.startswith("/") or ".." in text.split("/"):
            raise cur.corrupt(f"data file path {path!r}")
        out.append(_DataFile(base + text, base + head))
        prev = path
    return out


def _file_of(cur: _Cursor, files: List[_DataFile], i: int) -> _DataFile:
    if i >= len(files):
        raise cur.corrupt(f"data file {i} of {len(files)}")
    return files[i]


def _keys(cur: _Cursor, n: int, common: bool
          ) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    shared = cur.varints(n) if common else [0] * n
    keys: List[bytes] = []
    for i in range(n):
        prev = keys[-1] if keys else b""
        if prefix[i] > len(prev):
            raise cur.corrupt("key prefix")
        keys.append(prev[:prefix[i]] + cur.take(suffix[i]))
        if shared[i] > len(keys[-1]):
            raise cur.corrupt("subtree key prefix")
    return keys, shared


class OcdbtStore:
    """The newest version of the OCDBT database in directory ``path``.

    ``list()`` gives every key in order and ``read(key)`` its bytes, as
    tensorstore's ``ocdbt`` driver does; ``get(key)`` returns ``None``
    for a missing key (the interface ``core/storage.py`` reads zarr
    arrays through)."""

    def __init__(self, path: str):
        self.path = path
        where = os.path.join(path, "manifest.ocdbt")
        with open(where, "rb") as f:
            cur = _unframe(f.read(), MANIFEST_MAGIC, where,
                           _MANIFEST_LIMIT)
        cur.take(16)  # uuid
        kind = cur.varint()
        if kind != 0:
            raise NotImplementedError(
                f"{where}: OCDBT manifest kind {kind} (numbered manifests "
                "are not read; kind 0, a single manifest, is)")
        cur.varint()  # the largest inline value
        self.max_decoded_node_bytes = cur.varint()
        cur.u8()  # the version tree's arity (log2)
        method = cur.varint()
        if method == 1:
            cur.take(4)  # the zstd level, an int32
        elif method != 0:
            raise NotImplementedError(f"{where}: OCDBT node compression "
                                      f"{method} in the config")
        files = _data_files(cur, "")
        n = cur.varint()
        gens = cur.varints(n)
        heights = [cur.u8() for _ in range(n)]
        fids, offsets, lengths = (cur.varints(n) for _ in range(3))
        cur.varints(3 * n)  # keys, tree bytes, indirect value bytes
        cur.u64s(n)  # commit times
        m = cur.varint()  # references to version-tree nodes
        cur.varints(5 * m)  # generation, file, offset, length, count
        cur.u64s(m)  # commit times
        cur.take(m)  # heights
        cur.end()
        if any(b <= a for a, b in zip(gens, gens[1:])):
            raise cur.corrupt("generations out of order")
        self._root: Optional[Tuple[_Ref, int]] = None
        if n and lengths[-1] != _MISSING:
            self._root = (_Ref(_file_of(cur, files, fids[-1]), offsets[-1],
                               lengths[-1]), heights[-1])
        self._nodes: Dict[Tuple[str, int], _Node] = {}

    # -- nodes -----------------------------------------------------------
    def _bytes(self, ref: _Ref) -> bytes:
        where = os.path.join(self.path, ref.file.path)
        with open(where, "rb") as f:
            if ref.offset + ref.length > os.fstat(f.fileno()).st_size:
                raise OSError(f"{where}: {ref.length} bytes at "
                              f"{ref.offset} lie past the end of the file")
            f.seek(ref.offset)
            return f.read(ref.length)

    def _node(self, ref: _Ref, height: int) -> _Node:
        key = (ref.file.path, ref.offset)
        node = self._nodes.get(key)
        if node is not None:
            return node
        where = os.path.join(self.path, ref.file.path)
        if ref.offset:
            where += f" at {ref.offset}"
        cur = _unframe(self._bytes(ref), BTREE_MAGIC, where,
                       self.max_decoded_node_bytes)
        if cur.u8() != height:
            raise cur.corrupt(f"node height is not {height}")
        files = _data_files(cur, ref.file.base)
        n = cur.varint()
        keys, shared = _keys(cur, n, common=height > 0)
        if height == 0:
            lengths, kinds = cur.varints(n), cur.varints(n)
            for k in set(kinds) - {0, 1}:
                raise NotImplementedError(
                    f"{where}: OCDBT value kind {k} (0 inline and 1 a data "
                    "file reference are read)")
            ind = [i for i in range(n) if kinds[i] == 1]
            fids, offsets = cur.varints(len(ind)), cur.varints(len(ind))
            entries: list = [None] * n
            for i, f, o in zip(ind, fids, offsets):
                entries[i] = _Ref(_file_of(cur, files, f), o, lengths[i])
            for i in range(n):
                if kinds[i] == 0:
                    entries[i] = cur.take(lengths[i])
        else:
            fids, offsets, lengths = (cur.varints(n) for _ in range(3))
            cur.varints(3 * n)  # the children's statistics
            entries = [(_Ref(_file_of(cur, files, f), o, ln), s)
                       for f, o, ln, s in zip(fids, offsets, lengths,
                                              shared)]
        cur.end()
        if any(b <= a for a, b in zip(keys, keys[1:])):
            raise cur.corrupt("keys out of order")
        node = self._nodes[key] = _Node(height, keys, entries)
        return node

    # -- the key-value surface ---------------------------------------------
    def list(self) -> List[bytes]:
        """Every key of the newest version, in order."""
        out: List[bytes] = []

        def walk(ref: _Ref, height: int, prefix: bytes) -> None:
            node = self._node(ref, height)
            if height == 0:
                out.extend(prefix + k for k in node.keys)
                return
            for k, (child, shared) in zip(node.keys, node.entries):
                walk(child, height - 1, prefix + k[:shared])

        if self._root is not None:
            walk(*self._root, b"")
        return out

    def _find(self, key: Key) -> Union[bytes, _Ref, None]:
        """The leaf entry of ``key``: its inline bytes, a reference, or
        ``None`` if the store does not hold it."""
        if self._root is None:
            return None
        rel = key.encode() if isinstance(key, str) else bytes(key)
        ref, height = self._root
        while True:
            node = self._node(ref, height)
            i = bisect.bisect_right(node.keys, rel) - 1
            if height == 0:
                return node.entries[i] if i >= 0 and node.keys[i] == rel \
                    else None
            if i < 0:
                return None
            ref, shared = node.entries[i]
            if not rel.startswith(node.keys[i][:shared]):
                return None
            rel, height = rel[shared:], height - 1

    def get(self, key: Key) -> Optional[bytes]:
        """The value of ``key``, or ``None`` if the store does not hold
        it."""
        value = self._find(key)
        return self._bytes(value) if isinstance(value, _Ref) else value

    def read(self, key: Key) -> bytes:
        """The value of ``key``; ``KeyError`` if the store does not hold
        it."""
        value = self.get(key)
        if value is None:
            raise KeyError(key)
        return value

    def has(self, key: Key) -> bool:
        return self._find(key) is not None


__all__ = ["OcdbtStore"]
