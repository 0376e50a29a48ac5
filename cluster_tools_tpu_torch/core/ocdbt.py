"""A reader and a writer of tensorstore's OCDBT key-value store.

OCDBT ("optionally cooperative distributed B+tree") is the store that
orbax writes a checkpoint's arrays into (``models/orbax.py``): one
directory holding ``manifest.ocdbt`` and data files under ``d/`` (orbax
adds one sub-database per process, ``ocdbt.process_<i>/``, and a merged
tree at the top).  The port reads and writes it with the standard
library, numpy and its own codecs (``core/codecs.py``: Zstandard and
CRC-32C), so the card's machine needs neither tensorstore nor orbax.
:class:`OcdbtStore` reads the newest version of a database;
:class:`OcdbtWriter` writes a new database of one version, and
:func:`write_manifest` a manifest whose tree is another database's (the
top of an orbax checkpoint, over ``ocdbt.process_0/``).

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

The writer emits what the reader takes and what orbax's databases hold:
a single manifest (kind 0) of one version, generation 1, no version-tree
nodes; every manifest and node zstd-framed (``codecs.zstd_compress``
stores the bytes); values up to ``max_inline_value_bytes`` inline in the
leaves, longer ones in a data file under ``d/`` as they are put; leaves
cut where the next entry would pass ``max_decoded_node_bytes``, and
interior nodes over them only then; an empty database's root is the
missing sentinel in a data file of empty path, as tensorstore writes it.
"""

from __future__ import annotations

import bisect
import os
import struct
import time
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


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

#: orbax's OCDBT config (``max_inline_value_bytes``,
#: ``max_decoded_node_bytes``, ``version_tree_arity_log2``, the zstd level
#: of the nodes); tensorstore refuses to open a database whose config
#: differs from the one it is asked for
ORBAX_CONFIG = {"max_inline_value_bytes": 1024,
                "max_decoded_node_bytes": 100_000_000,
                "version_tree_arity_log2": 4, "zstd_level": 0}


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _common(a: bytes, b: bytes) -> int:
    return len(os.path.commonprefix([a, b]))


def _frame(magic: int, body: bytes) -> bytes:
    """``body`` framed: version 0, zstd, and the CRC-32C of it all."""
    payload = _varint(0) + _varint(1) + codecs.zstd_compress(body)
    head = struct.pack(">I", magic) + struct.pack("<Q", 16 + len(payload))
    return head + payload + struct.pack("<I", codecs.crc32c(head + payload))


def _file_table(files: List[Tuple[str, str]]) -> bytes:
    """The data file table of ``(base, relative path)`` pairs, in
    order."""
    full = [(b + r).encode() for b, r in files]
    prefix = [0] + [_common(a, b) for a, b in zip(full, full[1:])]
    return (_varint(len(full)) + _varints(prefix[1:])
            + _varints(len(f) - p for f, p in zip(full, prefix))
            + _varints(len(b.encode()) for b, _ in files)
            + b"".join(f[p:] for f, p in zip(full, prefix)))


def _key_columns(keys: List[bytes], interior: bool) -> bytes:
    """Keys, each sharing a prefix with the one before it; in an
    interior node with a subtree common prefix of 0 (children store
    their keys whole)."""
    prefix = [0] + [_common(a, b) for a, b in zip(keys, keys[1:])]
    return (_varints(prefix[1:])
            + _varints(len(k) - p for k, p in zip(keys, prefix))
            + (_varints(0 for _ in keys) if interior else b"")
            + b"".join(k[p:] for k, p in zip(keys, prefix)))


class Root(NamedTuple):
    """A written tree: its root node (a data file path relative to the
    database's directory, an offset and a length; ``file`` is ``None``
    for an empty tree), its height and its statistics."""

    file: Optional[str]
    offset: int
    length: int
    height: int
    num_keys: int
    tree_bytes: int
    indirect_bytes: int


class _Sub(NamedTuple):
    """A written subtree, as its parent's entry describes it."""

    first: bytes
    offset: int
    length: int
    num_keys: int
    tree_bytes: int
    indirect_bytes: int


#: a bound on the bytes of one varint the writer emits
_VARINT = 10


def write_manifest(path: str, root: Root, base: str = "") -> None:
    """Write ``path/manifest.ocdbt``: a single manifest of one version
    (generation 1) whose tree is ``root``, its node file read under
    ``base`` (``"ocdbt.process_0/"`` for a tree written in that
    subdirectory: the paths of that tree's own tables are then read
    under it too), with the config :data:`ORBAX_CONFIG`.  Written to a
    temporary file, then renamed."""
    cfg = ORBAX_CONFIG
    if root.file is None:
        files, offset, length = [("", "")], _MISSING, _MISSING
    else:
        files, offset, length = [(base, root.file)], root.offset, \
            root.length
    body = (os.urandom(16) + _varint(0)
            + _varint(cfg["max_inline_value_bytes"])
            + _varint(cfg["max_decoded_node_bytes"])
            + bytes([cfg["version_tree_arity_log2"]]) + _varint(1)
            + struct.pack("<i", cfg["zstd_level"])
            + _file_table(files) + _varint(1) + _varint(1)
            + bytes([root.height]) + _varints((0, offset, length))
            + _varints((root.num_keys, root.tree_bytes,
                        root.indirect_bytes))
            + struct.pack("<Q", time.time_ns()) + _varint(0))
    dst = os.path.join(path, "manifest.ocdbt")
    tmp = f"{dst}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(_frame(MANIFEST_MAGIC, body))
    os.replace(tmp, dst)


class OcdbtWriter:
    """A new OCDBT database in the directory ``path``, written once.

    ``put(key, value)`` stores a value: up to ``max_inline_value_bytes``
    it is kept for its leaf, longer it is appended at once to the data
    file ``d/<32 hex digits>``.  ``get`` and ``has`` read back what was
    put (the key-value surface ``core/storage.py``'s zarr arrays write
    through).  :meth:`commit` appends the B+tree's nodes to the same data
    file, writes the manifest and returns the :class:`Root`.  Keys are
    bytes or ``str`` (UTF-8); a key put twice keeps its last value.
    The bounds are :data:`ORBAX_CONFIG`'s."""

    def __init__(self, path: str):
        self.path = path
        self._name = f"d/{os.urandom(16).hex()}"
        self._values: Dict[bytes, Union[bytes, Tuple[int, int]]] = {}
        self._file = None
        self._size = 0
        self._root: Optional[Root] = None
        os.makedirs(os.path.join(path, "d"), exist_ok=True)

    @staticmethod
    def _key(key: Key) -> bytes:
        return key.encode() if isinstance(key, str) else bytes(key)

    def _append(self, data) -> int:
        """Append ``data`` to the data file; its offset there."""
        if self._file is None:
            self._file = open(os.path.join(self.path, self._name), "wb")
        at = self._size
        self._file.write(data)
        self._size += len(data)
        return at

    def put(self, key: Key, value) -> None:
        if self._root is not None:
            raise ValueError(f"{self.path}: the OCDBT database is "
                             "committed")
        value = memoryview(value).cast("B")
        self._values[self._key(key)] = bytes(value) if \
            len(value) <= ORBAX_CONFIG["max_inline_value_bytes"] else \
            (self._append(value), len(value))

    def get(self, key: Key) -> Optional[bytes]:
        value = self._values.get(self._key(key))
        if not isinstance(value, tuple):
            return value
        if self._file is not None:
            self._file.flush()
        with open(os.path.join(self.path, self._name), "rb") as f:
            f.seek(value[0])
            return f.read(value[1])

    def has(self, key: Key) -> bool:
        return self._key(key) in self._values

    # -- the tree ----------------------------------------------------------
    def _runs(self, sizes: List[int]) -> List[range]:
        """Consecutive entries per node: each node's body (its height,
        data file table and count, and for each entry at most
        ``sizes[i]`` bytes) within ``max_decoded_node_bytes``."""
        bound = ORBAX_CONFIG["max_decoded_node_bytes"]
        fixed = 1 + len(_file_table([("", self._name)])) + _VARINT
        runs, start, total = [], 0, fixed
        for i, n in enumerate(sizes):
            if total + n > bound and i > start:
                runs.append(range(start, i))
                start, total = i, fixed
            total += n
        runs.append(range(start, len(sizes)))
        return runs

    def _node(self, body: bytes) -> Tuple[int, int]:
        frame = _frame(BTREE_MAGIC, body)
        return self._append(frame), len(frame)

    def _leaves(self, keys: List[bytes]) -> List[_Sub]:
        vals = [self._values[k] for k in keys]
        sizes = [len(k) + (len(v) if isinstance(v, bytes) else 0)
                 + 6 * _VARINT for k, v in zip(keys, vals)]
        out = []
        for run in self._runs(sizes):
            ks, vs = keys[run.start:run.stop], vals[run.start:run.stop]
            refs = [v for v in vs if isinstance(v, tuple)]
            table = [("", self._name)] if refs else []
            offset, length = self._node(
                b"\0" + _file_table(table) + _varint(len(ks))
                + _key_columns(ks, interior=False)
                + _varints(len(v) if isinstance(v, bytes) else v[1]
                           for v in vs)
                + _varints(int(isinstance(v, tuple)) for v in vs)
                + _varints(0 for _ in refs) + _varints(r[0] for r in refs)
                + b"".join(v for v in vs if isinstance(v, bytes)))
            out.append(_Sub(ks[0], offset, length, len(ks), length,
                            sum(r[1] for r in refs)))
        return out

    def _interior(self, subs: List[_Sub], height: int) -> List[_Sub]:
        out = []
        for run in self._runs([len(s.first) + 10 * _VARINT
                               for s in subs]):
            ch = subs[run.start:run.stop]
            offset, length = self._node(
                bytes([height]) + _file_table([("", self._name)])
                + _varint(len(ch))
                + _key_columns([c.first for c in ch], interior=True)
                + _varints(0 for _ in ch)
                + b"".join(_varints(getattr(c, f) for c in ch) for f in (
                    "offset", "length", "num_keys", "tree_bytes",
                    "indirect_bytes")))
            out.append(_Sub(ch[0].first, offset, length,
                            sum(c.num_keys for c in ch),
                            length + sum(c.tree_bytes for c in ch),
                            sum(c.indirect_bytes for c in ch)))
        return out

    def commit(self) -> Root:
        """Write the B+tree and ``manifest.ocdbt``; the tree's
        :class:`Root`.  Nothing can be put after it."""
        if self._root is not None:
            return self._root
        root = Root(None, _MISSING, _MISSING, 0, 0, 0, 0)
        if self._values:
            subs, height = self._leaves(sorted(self._values)), 0
            while len(subs) > 1:
                height += 1
                subs = self._interior(subs, height)
            top = subs[0]
            root = Root(self._name, top.offset, top.length, height,
                        top.num_keys, top.tree_bytes, top.indirect_bytes)
        self.close()
        self._root = root
        write_manifest(self.path, root)
        return root

    def close(self) -> None:
        """Close the data file (:meth:`commit` does)."""
        if self._file is not None:
            self._file.close()
            self._file = None


__all__ = ["ORBAX_CONFIG", "OcdbtStore", "OcdbtWriter", "Root",
           "write_manifest"]
