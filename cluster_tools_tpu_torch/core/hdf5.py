"""HDF5 files read and written with numpy and the standard library.

The reference keeps raw EM data and ilastik projects in HDF5 through h5py;
this module reads what h5py writes, by default (``libver="earliest"``)
and with ``libver="latest"``, and writes h5py's default format, so the
package needs no HDF5 library.  It reads:

* superblock versions 0 to 3 (8-byte offsets and lengths);
* version 1 and 2 object headers with their continuation blocks;
* groups as symbol tables (a v1 B-tree of symbol-table nodes and a local
  heap), and as link messages, compact or dense (a fractal heap indexed
  by a version 2 B-tree); hard links and soft links, resolved as h5py
  resolves them;
* data layouts: contiguous, compact, and chunked with the v1 B-tree
  index or, in layout version 4, the single-chunk, implicit, fixed-array,
  extensible-array and version 2 B-tree indexes;
* filters deflate, shuffle, fletcher32 (verified: a mismatch raises
  ``OSError``), LZF and scale-offset (integers, and floats in D-scale
  mode);
* datatypes: fixed-point, IEEE float, fixed-length strings,
  variable-length strings (in global heap collections), h5py's bool enum
  (other enums read as their base integers), compounds of these (numpy
  structured arrays);
* scalar and simple dataspaces, compact and dense attributes.

The structures of ``libver="latest"`` live in ``core/hdf5_v2.py``; their
lookup3 checksums are verified, a mismatch raising ``OSError`` naming the
structure.  Anything else raises ``NotImplementedError`` naming it:
external and user-defined links, szip and the other plugin filters,
other datatype classes, shared messages, virtual layouts; and writing to
a file whose superblock is of version 2 or 3.

The writer is log-structured.  Chunks and contiguous data are appended at
the end of the file as they are written.  The metadata of every object
that changed (its object header, a group's B-tree, symbol-table nodes and
local heap, a dataset's chunk B-tree) is appended again at each flush,
bottom-up to the root group, and the superblock at offset 0 is rewritten
to point at the new root.  Replaced metadata and chunks stay in the file
as unreferenced space.  Objects that did not change keep their headers, so
``"a"`` on a file that h5py wrote in its default format adds to it in
place.

All handles on one path in one process share one state (as h5py's do):
each close flushes it, the last one closes the file descriptor.  A handle
that is garbage-collected closes itself.  Writes from several threads are
safe; writes from several processes to one file are not (nor are they
with h5py).
"""

from __future__ import annotations

import os
import struct
import threading
import weakref
import zlib
from itertools import product
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from . import codecs, hdf5_v2

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
#: the local heap's end-of-free-list marker
_FREE_NULL = 1
#: B-tree K values written by h5py (group leaf/internal, chunk index)
_LEAF_K, _GROUP_K, _CHUNK_K = 4, 16, 32
_GHEAP_MIN = 4096

_FILTERS = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
            5: "nbit", 6: "scaleoffset", 307: "bzip2", 32000: "lzf",
            32001: "blosc", 32004: "lz4", 32008: "bitshuffle",
            32015: "zstd"}
_MESSAGES = {0x0: "NIL", 0x1: "dataspace", 0x2: "link info",
             0x3: "datatype", 0x4: "fill value (old)", 0x5: "fill value",
             0x6: "link", 0x7: "external data files", 0x8: "data layout",
             0x9: "bogus", 0xA: "group info", 0xB: "filter pipeline",
             0xC: "attribute", 0xD: "object comment",
             0xE: "modification time (old)", 0xF: "shared message table",
             0x10: "continuation", 0x11: "symbol table",
             0x12: "modification time", 0x13: "B-tree 'K' values",
             0x14: "driver info", 0x15: "attribute info",
             0x16: "reference count"}
#: messages that carry nothing this module needs
_IGNORED = {0x0, 0x4, 0xA, 0xD, 0xE, 0x12, 0x13, 0x16}
_DT_CLASSES = {0: "fixed-point", 1: "floating-point", 2: "time",
               3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
               7: "reference", 8: "enumerated", 9: "variable-length",
               10: "array"}


def _u(fmt: str, buf, off: int = 0):
    return struct.unpack_from("<" + fmt, buf, off)


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _padded(b: bytes) -> bytes:
    return b + b"\0" * (_pad8(len(b)) - len(b))


# ---------------------------------------------------------------------------
# datatypes
# ---------------------------------------------------------------------------

class _DType:
    """A decoded HDF5 datatype: ``kind`` is ``num``, ``bool``, ``fstr``,
    ``vlen``, ``enum`` or ``compound``; ``disk`` the numpy dtype of one
    stored element; ``mem`` what reads return; ``raw`` the encoded
    message."""

    def __init__(self, kind: str, disk: np.dtype, raw: bytes,
                 charset: int = 0, mem: Optional[np.dtype] = None):
        self.kind = kind
        self.disk = np.dtype(disk)
        self.raw = raw
        self.charset = charset  # vlen strings: 0 ASCII, 1 UTF-8
        if mem is not None:  # compound: its members as they read
            self.mem = np.dtype(mem)
        elif kind == "bool":
            self.mem = np.dtype(bool)
        elif kind == "vlen":
            self.mem = np.dtype(object)
        else:  # as h5py: in the file's byte order
            self.mem = self.disk

    @property
    def size(self) -> int:
        return self.disk.itemsize


def _decode_dtype(buf, off: int = 0) -> Tuple[_DType, int]:
    """The datatype message at ``off`` and its encoded length."""
    b0 = buf[off]
    cls, version = b0 & 0x0F, b0 >> 4
    bits = bytes(buf[off + 1:off + 4])
    size = _u("I", buf, off + 4)[0]
    end = off + 8
    if cls == 0:
        order = ">" if bits[0] & 1 else "<"
        kind = "i" if bits[0] & 8 else "u"
        end += 4
        return _DType("num", np.dtype(f"{order}{kind}{size}"),
                      bytes(buf[off:end])), end - off
    if cls == 1:
        if bits[0] & 0x40:
            raise NotImplementedError("HDF5 VAX-order floating point")
        order = ">" if bits[0] & 1 else "<"
        end += 12
        return _DType("num", np.dtype(f"{order}f{size}"),
                      bytes(buf[off:end])), end - off
    if cls == 3:
        return _DType("fstr", np.dtype(f"S{size}"), bytes(buf[off:end]),
                      charset=bits[0] >> 4), end - off
    if cls == 8:
        base, n = _decode_dtype(buf, end)
        end += n
        n_members = bits[0] | (bits[1] << 8)
        names = []
        for _ in range(n_members):
            stop = bytes(buf[end:end + 256]).index(b"\0")
            names.append(bytes(buf[end:end + stop]))
            end += _pad8(stop + 1) if version < 3 else stop + 1
        values = np.frombuffer(bytes(buf[end:end + n_members * base.size]),
                               base.disk)
        end += n_members * base.size
        raw = bytes(buf[off:end])
        if (base.size == 1 and sorted(zip(names, values.tolist()))
                == [(b"FALSE", 0), (b"TRUE", 1)]):
            return _DType("bool", base.disk, raw), end - off
        return _DType("enum", base.disk, raw), end - off
    if cls == 6:
        return _decode_compound(buf, off, version, bits, size, end)
    if cls == 9:
        if bits[0] & 0x0F != 1:
            raise NotImplementedError(
                "HDF5 variable-length sequence datatype")
        _, n = _decode_dtype(buf, end)
        end += n
        return _DType("vlen", np.dtype("V16"), bytes(buf[off:end]),
                      charset=bits[1] & 0x0F), end - off
    raise NotImplementedError(
        f"HDF5 {_DT_CLASSES.get(cls, f'class {cls}')} datatype")


def _decode_compound(buf, off: int, version: int, bits: bytes, size: int,
                     end: int) -> Tuple[_DType, int]:
    """A compound datatype as the numpy structured dtype h5py reads it
    as: the members' names, offsets and types, the element's size."""
    n_members = bits[0] | (bits[1] << 8)
    names, disk, mem, offsets = [], [], [], []
    off_bytes = next(n for n in (1, 2, 3, 4) if size < 1 << (8 * n)) \
        if version >= 3 else 4
    for _ in range(n_members):
        stop = bytes(buf[end:end + 65536]).index(b"\0")
        names.append(bytes(buf[end:end + stop]).decode("utf-8"))
        end += stop + 1 if version >= 3 else _pad8(stop + 1)
        offsets.append(int.from_bytes(bytes(buf[end:end + off_bytes]),
                                      "little"))
        end += off_bytes
        if version == 1:
            if buf[end]:
                raise NotImplementedError("HDF5 compound member with "
                                          "array dimensions (version 1)")
            end += 28
        member, n = _decode_dtype(buf, end)
        end += n
        if member.kind == "vlen":
            raise NotImplementedError("HDF5 compound member of a "
                                      "variable-length type")
        disk.append(member.disk)
        mem.append(member.mem)
    spec = {"names": names, "offsets": offsets, "itemsize": size}
    return (_DType("compound", np.dtype({**spec, "formats": disk}),
                   bytes(buf[off:end]),
                   mem=np.dtype({**spec, "formats": mem})), end - off)


def _as_read(dt: _DType, arr: np.ndarray) -> np.ndarray:
    """Stored elements as h5py returns them: bools as bools, compounds
    member by member into zeroed records (h5py's padding bytes are 0)."""
    if dt.kind == "bool":
        return arr != 0
    if dt.kind == "compound":
        out = np.zeros(arr.shape, dt.mem)
        out[...] = arr
        return out
    return arr.astype(dt.mem)


def _fixed_point(size: int, signed: bool) -> bytes:
    return struct.pack("<BBBBIHH", 0x10, 0x08 if signed else 0, 0, 0, size,
                       0, 8 * size)


def _encode_dtype(dt: np.dtype, vlen: Optional[str] = None) -> _DType:
    """The datatype h5py writes for numpy dtype ``dt`` (``vlen``: the
    charset of a variable-length string, ``"ascii"`` or ``"utf-8"``)."""
    if vlen is not None:
        charset = 1 if vlen == "utf-8" else 0
        raw = struct.pack("<BBBBI", 0x19, 0x01, charset, 0, 16) + \
            _fixed_point(1, False)
        return _DType("vlen", np.dtype("V16"), raw, charset=charset)
    dt = np.dtype(dt)
    if dt.kind == "b":
        raw = (struct.pack("<BBBBI", 0x18, 2, 0, 0, 1) + _fixed_point(1, True)
               + b"FALSE\0\0\0" + b"TRUE\0\0\0\0" + b"\x00\x01")
        return _DType("bool", np.dtype("i1"), raw)
    if dt.kind in "iu":
        raw = struct.pack("<BBBBIHH", 0x10, 0x08 if dt.kind == "i" else 0,
                          0, 0, dt.itemsize, 0, 8 * dt.itemsize)
        return _DType("num", dt.newbyteorder("<"), raw)
    if dt.kind == "f":
        layout = {2: (15, 10, 5, 10, 15), 4: (31, 23, 8, 23, 127),
                  8: (63, 52, 11, 52, 1023)}.get(dt.itemsize)
        if layout is None:
            raise TypeError(f"no HDF5 float of {dt.itemsize} bytes")
        sign, eloc, esize, msize, bias = layout
        raw = struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, sign, 0, dt.itemsize,
                          0, 8 * dt.itemsize, eloc, esize, 0, msize, bias)
        return _DType("num", dt.newbyteorder("<"), raw)
    if dt.kind == "S":
        raw = struct.pack("<BBBBI", 0x13, 0x01, 0, 0, dt.itemsize)
        return _DType("fstr", dt, raw)
    raise TypeError(f"Object dtype {dt!r} has no native HDF5 equivalent")


def _value_and_type(value: Any) -> Tuple[np.ndarray, _DType]:
    """An array and the datatype h5py would store ``value`` with: ``str``
    as a UTF-8 and ``bytes`` as an ASCII variable-length string (lists of
    them as arrays of such), numpy ``S`` arrays as fixed-length strings."""
    if type(value) in (str, bytes):
        return (np.array(value, dtype=object),
                _encode_dtype(None, "utf-8" if type(value) is str
                              else "ascii"))
    arr = np.asarray(value)
    if arr.dtype.kind in "OU":
        flat = [v for v in arr.reshape(-1)]
        if flat and all(isinstance(v, str) for v in flat):
            return arr.astype(object), _encode_dtype(None, "utf-8")
        if flat and all(isinstance(v, bytes) for v in flat):
            return arr.astype(object), _encode_dtype(None, "ascii")
        raise TypeError(f"Object dtype {arr.dtype!r} has no native HDF5 "
                        "equivalent")
    if isinstance(value, (list, tuple)) and arr.dtype.kind == "S":
        return arr.astype(object), _encode_dtype(None, "ascii")
    return arr, _encode_dtype(arr.dtype)


# ---------------------------------------------------------------------------
# dataspaces, layouts, filters, attributes
# ---------------------------------------------------------------------------

def _decode_space(buf, off: int = 0) -> Optional[Tuple[int, ...]]:
    """The shape of a dataspace message (``()`` scalar, None null)."""
    version, rank, flags = buf[off], buf[off + 1], buf[off + 2]
    if version == 1:
        dims_at = off + 8
        kind = 1 if rank else 0
    elif version == 2:
        dims_at = off + 4
        kind = buf[off + 3]
    else:
        raise NotImplementedError(f"HDF5 dataspace message version "
                                  f"{version}")
    if kind == 2:
        return None
    return tuple(int(d) for d in _u(f"{rank}Q", buf, dims_at))


def _space_maxshape(buf) -> Tuple[int, ...]:
    """The maximum dimensions of a simple dataspace message (``UNDEF``
    for an unlimited axis; the dimensions where none are stored)."""
    version, rank, flags = buf[0], buf[1], buf[2]
    dims_at = 8 if version == 1 else 4
    at = dims_at + (8 * rank if flags & 1 else 0)
    return tuple(int(d) for d in _u(f"{rank}Q", buf, at))


def _encode_space(shape: Tuple[int, ...]) -> bytes:
    rank = len(shape)
    return (struct.pack("<BBBB4x", 1, rank, 1 if rank else 0, 0)
            + struct.pack(f"<{2 * rank}Q", *shape, *shape))


def _decode_filters(buf) -> List[Tuple[int, int, Tuple[int, ...]]]:
    version, n = buf[0], buf[1]
    pos = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        fid = _u("H", buf, pos)[0]
        pos += 2
        name_len = 0
        if version == 1 or fid >= 256:
            name_len = _u("H", buf, pos)[0]
            pos += 2
        flags, n_values = _u("HH", buf, pos)
        pos += 4
        pos += _pad8(name_len) if version == 1 else name_len
        values = _u(f"{n_values}I", buf, pos)
        pos += 4 * n_values
        if version == 1 and n_values % 2:
            pos += 4
        out.append((fid, flags, tuple(values)))
    return out


def _encode_filters(filters) -> bytes:
    out = struct.pack("<BB6x", 1, len(filters))
    for fid, flags, values in filters:
        out += struct.pack(f"<HHHH{len(values)}I", fid, 0, flags,
                           len(values), *values)
        if len(values) % 2:
            out += b"\0" * 4
    return out


def _decode_attr(buf) -> Tuple[str, _DType, Optional[Tuple[int, ...]],
                               bytes]:
    version = buf[0]
    name_size, dt_size, ds_size = _u("HHH", buf, 2)
    pos = 8
    if version == 3:
        pos += 1
    elif version not in (1, 2):
        raise NotImplementedError(f"HDF5 attribute message version "
                                  f"{version}")
    step = _pad8 if version == 1 else (lambda n: n)
    name = bytes(buf[pos:pos + name_size]).rstrip(b"\0").decode("utf-8")
    pos += step(name_size)
    if buf[1] & 0x3:
        raise NotImplementedError("HDF5 shared datatype or dataspace in "
                                  f"attribute {name!r}")
    dt, _ = _decode_dtype(buf, pos)
    pos += step(dt_size)
    shape = _decode_space(buf, pos)
    pos += step(ds_size)
    n = 0 if shape is None else int(np.prod(shape))
    return name, dt, shape, bytes(buf[pos:pos + n * dt.size])


def _encode_attr(name: str, dt: _DType, shape: Tuple[int, ...],
                 data: bytes) -> bytes:
    bname = name.encode("utf-8") + b"\0"
    space = _encode_space(shape)
    return (struct.pack("<BBHHH", 1, 0, len(bname), len(dt.raw), len(space))
            + _padded(bname) + _padded(dt.raw) + _padded(space) + data)


# ---------------------------------------------------------------------------
# shared file state
# ---------------------------------------------------------------------------

class _SoftLink:
    """A soft link: resolved by path each time it is opened, as h5py
    resolves it (absolute, or relative to the group holding it)."""

    def __init__(self, path: str):
        self.path = path


#: HDF5's limit on soft links followed in one traversal (H5L_NUM_LINKS)
_MAX_SOFT_LINKS = 16


class _Obj:
    """An object of the file: its header address (None until written),
    the header messages kept verbatim when it is rewritten, and its
    attributes as encoded attribute messages."""

    def __init__(self, state: "_State", addr: Optional[int],
                 parent: Optional["_GroupObj"]):
        self.state = state
        self.addr = addr
        self.parent = parent
        self.kept: List[Tuple[int, int, bytes]] = []
        self.attrs: Dict[str, bytes] = {}
        self.dirty = addr is None

    def touch(self) -> None:
        """Mark this object and its ancestors for rewriting."""
        obj: Optional[_Obj] = self
        while obj is not None:
            obj.dirty = True
            obj = obj.parent


class _GroupObj(_Obj):
    def __init__(self, state, addr, parent):
        super().__init__(state, addr, parent)
        # name -> object, or the header address of one not loaded yet
        self.children: Dict[str, Any] = {}
        # (B-tree, local heap) of its symbol table, once written or read
        self.btree_heap: Optional[Tuple[int, int]] = None


class _DatasetObj(_Obj):
    def __init__(self, state, addr, parent):
        super().__init__(state, addr, parent)
        self.shape: Tuple[int, ...] = ()
        self.dt: Optional[_DType] = None
        self.layout = "chunked"
        self.chunks: Optional[Tuple[int, ...]] = None
        self.maxshape: Tuple[int, ...] = ()
        # layout version 4: the chunk index's type (None: a v1 B-tree),
        # its parameters and the layout's flags
        self.index_kind: Optional[int] = None
        self.index_info: Dict[str, int] = {}
        self.layout_flags = 0
        self.filters: List[Tuple[int, int, Tuple[int, ...]]] = []
        self.fill: Optional[bytes] = None
        self.btree = UNDEF
        self._index: Optional[Dict[Tuple[int, ...], Tuple[int, int, int]]] \
            = None
        self.data_addr = UNDEF  # contiguous
        self.data_size = 0
        self.compact = b""
        self.chunk_locks: Dict[Tuple[int, ...], threading.Lock] = {}

    def index(self) -> Dict[Tuple[int, ...], Tuple[int, int, int]]:
        """Chunk grid position -> (address, stored bytes, filter mask)."""
        if self._index is None:
            with self.state.lock:
                if self._index is None:
                    self._index = self.state.read_chunk_btree(self)
        return self._index


_STATES: Dict[str, "_State"] = {}
_STATES_LOCK = threading.Lock()


class _State:
    """One open HDF5 file, shared by every handle on its path."""

    def __init__(self, path: str, mode: str):
        self.path = path
        self.key = os.path.realpath(path)
        self.lock = threading.RLock()
        self.refs = 0
        self.writable = mode != "r"
        self._gheaps: Dict[int, Dict[int, bytes]] = {}
        exists = os.path.exists(path)
        if mode in ("w-", "x") and exists:
            raise FileExistsError(f"{path} exists")
        if mode in ("r", "r+") and not exists:
            raise FileNotFoundError(path)
        create = mode in ("w", "w-", "x") or not exists
        flags = os.O_RDONLY if mode == "r" else os.O_RDWR | os.O_CREAT
        if create:
            flags |= os.O_TRUNC
        self.fd = os.open(path, flags, 0o644)
        self.leaf_k, self.group_k, self.chunk_k = _LEAF_K, _GROUP_K, _CHUNK_K
        try:
            if create:
                self.sb_version = 0
                self.eof = 96
                self.root = _GroupObj(self, None, None)
                self.flush()
            else:
                self._read_superblock()
        except BaseException:
            os.close(self.fd)
            raise

    # -- raw I/O -----------------------------------------------------------
    def read(self, addr: int, n: int) -> bytes:
        out = os.pread(self.fd, n, addr)
        if len(out) != n:
            raise OSError(f"{self.path}: truncated HDF5 file (read of {n} "
                          f"bytes at {addr})")
        return out

    def append(self, payload: bytes) -> int:
        """Write ``payload`` at the end of the file; its address."""
        with self.lock:
            addr = self.eof
            self.eof = _pad8(addr + len(payload))
        os.pwrite(self.fd, payload, addr)
        return addr

    def require_writable(self) -> None:
        """Raise unless this file takes writes: open writable, and in the
        format the writer appends (superblock version 0 or 1)."""
        if not self.writable:
            raise OSError(f"{self.path} is open read-only")
        if self.sb_version >= 2:
            raise NotImplementedError(
                f"writing to an HDF5 file with superblock version "
                f"{self.sb_version} (libver='latest'): the writer appends "
                "h5py's default format only")

    def reopen_writable(self) -> None:
        with self.lock:
            if not self.writable:
                fd = os.open(self.path, os.O_RDWR)
                os.close(self.fd)
                self.fd, self.writable = fd, True

    # -- superblock ----------------------------------------------------------
    def _read_superblock(self) -> None:
        head = os.pread(self.fd, 100, 0)
        if head[:8] != SIGNATURE:
            raise OSError(f"{self.path} is not an HDF5 file (no signature "
                          "at offset 0)")
        version = head[8]
        if version in (2, 3):
            root_addr, eof = hdf5_v2.superblock(self, head)
            self.sb_version = version
            self.eof = _pad8(max(eof, os.fstat(self.fd).st_size))
            self.root = self.load_group(root_addr, None)
            return
        if version not in (0, 1):
            raise NotImplementedError(f"HDF5 superblock version {version}")
        if head[13] != 8 or head[14] != 8:
            raise NotImplementedError(f"HDF5 offsets of {head[13]} and "
                                      f"lengths of {head[14]} bytes")
        self.leaf_k, self.group_k = _u("HH", head, 16)
        if version == 1:
            self.chunk_k = _u("H", head, 24)[0]
        pos = 24 + (4 if version == 1 else 0)
        base, _, eof, _ = _u("4Q", head, pos)
        if base != 0:
            raise NotImplementedError("HDF5 base address other than 0 "
                                      "(user block)")
        entry = pos + 32
        root_addr = _u("Q", head, entry + 8)[0]
        self.sb_version = version
        self.eof = _pad8(max(eof, os.fstat(self.fd).st_size))
        self.root = self.load_group(root_addr, None)

    def _write_superblock(self) -> None:
        root = self.root
        cache, scratch = 0, b"\0" * 16
        if root.btree_heap is not None:
            cache, scratch = 1, struct.pack("<QQ", *root.btree_heap)
        head = SIGNATURE + struct.pack("<BBBBBBBB", self.sb_version, 0, 0, 0,
                                       0, 8, 8, 0)
        head += struct.pack("<HHI", self.leaf_k, self.group_k, 0)
        if self.sb_version == 1:
            head += struct.pack("<HH", self.chunk_k, 0)
        head += struct.pack("<4Q", 0, UNDEF, self.eof, UNDEF)
        head += struct.pack("<QQII", 0, root.addr, cache, 0) + scratch
        os.pwrite(self.fd, head, 0)

    # -- object headers ------------------------------------------------------
    def messages(self, addr: int) -> List[Tuple[int, int, bytes]]:
        head = self.read(addr, 16)
        if head[:4] == b"OHDR":
            return hdf5_v2.object_header(self, addr)
        if head[0] != 1:
            raise NotImplementedError(f"HDF5 object header version "
                                      f"{head[0]}")
        size = _u("I", head, 8)[0]
        blocks = [(addr + 16, size)]
        out = []
        while blocks:
            start, size = blocks.pop(0)
            buf = self.read(start, size)
            pos = 0
            while pos + 8 <= size:
                mtype, msize, mflags = _u("HHB", buf, pos)
                data = buf[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == 0x10:
                    blocks.append(_u("QQ", data))
                elif mtype != 0:
                    out.append((mtype, mflags, data))
        return out

    def load(self, addr: int, parent: Optional[_GroupObj]) -> _Obj:
        msgs = self.messages(addr)
        types = {t for t, _, _ in msgs}
        if 0x8 in types:
            return self._load_dataset(addr, parent, msgs)
        if types & {0x11, 0x2, 0x6}:
            return self.load_group(addr, parent, msgs)
        raise NotImplementedError("HDF5 object that is neither a group "
                                  "nor a dataset (committed datatype?)")

    def _attrs_and_kept(self, obj: _Obj, msgs, handled) -> None:
        for mtype, mflags, data in msgs:
            if mtype == 0xC:
                name = _decode_attr(data)[0]
                obj.attrs[name] = data
            elif mtype == 0x15:
                flags = data[1]
                heap, names = _u("QQ", data, 2 + (2 if flags & 1 else 0))
                if heap != UNDEF:
                    for raw in hdf5_v2.dense_attributes(
                            self, heap, names, tracked=bool(flags & 1)):
                        obj.attrs[_decode_attr(raw)[0]] = raw
            elif mtype in handled or mtype in _IGNORED:
                if mtype not in (0x0, 0xA):
                    obj.kept.append((mtype, mflags, data))
            else:
                raise NotImplementedError(
                    "HDF5 object header message "
                    f"{_MESSAGES.get(mtype, f'type {mtype:#x}')}")

    def load_group(self, addr: int, parent, msgs=None) -> "_GroupObj":
        msgs = self.messages(addr) if msgs is None else msgs
        g = _GroupObj(self, addr, parent)
        self._attrs_and_kept(g, msgs, handled={0x11, 0x2, 0x6})
        g.kept = [m for m in g.kept if m[0] not in (0x11, 0x2, 0x6)]
        for mtype, _, data in msgs:
            if mtype == 0x11:
                btree, heap = _u("QQ", data)
                g.btree_heap = (btree, heap)
                g.children.update(self._symbol_table(btree, heap))
            elif mtype == 0x2:
                flags = data[1]
                heap, names = _u("QQ", data, 2 + (8 if flags & 1 else 0))
                if heap != UNDEF:
                    for raw in hdf5_v2.dense_links(self, heap, names):
                        name, target = _decode_link(raw)
                        g.children[name] = target
            elif mtype == 0x6:
                name, target = _decode_link(data)
                g.children[name] = target
        return g

    def _symbol_table(self, btree: int, heap: int) -> Dict[str, int]:
        head = self.read(heap, 32)
        if head[:4] != b"HEAP":
            raise OSError(f"{self.path}: bad local heap at {heap}")
        size, _, data_addr = _u("QQQ", head, 8)
        names = self.read(data_addr, size)

        def text(at: int) -> str:
            return names[at:names.index(b"\0", at)].decode("utf-8")

        out = {}
        for snod in self._btree_children(btree, node_type=0, key_size=8):
            buf = self.read(snod, 8)
            if buf[:4] != b"SNOD":
                raise OSError(f"{self.path}: bad symbol table node")
            n = _u("H", buf, 6)[0]
            entries = self.read(snod + 8, 40 * n)
            for i in range(n):
                name_off, obj, cache, _, link = _u("QQIII", entries, 40 * i)
                # cache type 2: a soft link, its value in the local heap
                out[text(name_off)] = (_SoftLink(text(link)) if cache == 2
                                       else obj)
        return out

    def _btree_children(self, addr: int, node_type: int, key_size: int
                        ) -> Iterator[int]:
        """The level-0 children of a v1 B-tree, in key order."""
        if addr == UNDEF:
            return
        head = self.read(addr, 24)
        if head[:4] != b"TREE" or head[4] != node_type:
            raise OSError(f"{self.path}: bad v1 B-tree node at {addr}")
        level, used = head[5], _u("H", head, 6)[0]
        body = self.read(addr + 24, used * (key_size + 8) + key_size)
        for i in range(used):
            child = _u("Q", body, i * (key_size + 8) + key_size)[0]
            if level == 0:
                yield child
            else:
                yield from self._btree_children(child, node_type, key_size)

    def _load_dataset(self, addr, parent, msgs) -> _DatasetObj:
        d = _DatasetObj(self, addr, parent)
        self._attrs_and_kept(d, msgs, handled={0x1, 0x3, 0x5, 0x8, 0xB})
        d.kept = [m for m in d.kept if m[0] != 0x8]
        for mtype, mflags, data in msgs:
            if mtype in (0x1, 0x3) and mflags & 0x2:
                raise NotImplementedError(
                    f"HDF5 shared {_MESSAGES[mtype]} message")
            if mtype == 0x1:
                shape = _decode_space(data)
                if shape is None:
                    raise NotImplementedError("HDF5 null dataspace")
                d.shape = shape
                d.maxshape = _space_maxshape(data) if shape else ()
            elif mtype == 0x3:
                d.dt = _decode_dtype(data)[0]
            elif mtype == 0x5:
                d.fill = _decode_fill(data)
            elif mtype == 0xB:
                d.filters = _decode_filters(data)
            elif mtype == 0x8:
                _decode_layout(d, data)
        for fid, _, values in d.filters:
            if fid not in (1, 2, 3, 6, 32000):
                raise NotImplementedError(
                    f"HDF5 filter {_FILTERS.get(fid, fid)!r}")
            if fid == 6 and (values[0] == 1 or values[6] != 0):
                raise NotImplementedError(
                    "HDF5 scale-offset filter in "
                    f"{'E-scale mode' if values[0] == 1 else 'big-endian'}")
        return d

    def read_chunk_btree(self, d: _DatasetObj):
        if d.index_kind is not None:
            return hdf5_v2.chunk_index(self, d)
        rank = len(d.shape)
        key_size = 8 + 8 * (rank + 1)
        index = {}
        for key, child in self._chunk_entries(d.btree, key_size, rank):
            nbytes, mask = key[0], key[1]
            pos = tuple(o // c for o, c in zip(key[2:2 + rank], d.chunks))
            index[pos] = (child, nbytes, mask)
        return index

    def _chunk_entries(self, addr, key_size, rank):
        if addr == UNDEF:
            return
        head = self.read(addr, 24)
        if head[:4] != b"TREE" or head[4] != 1:
            raise OSError(f"{self.path}: bad chunk B-tree node at {addr}")
        level, used = head[5], _u("H", head, 6)[0]
        body = self.read(addr + 24, used * (key_size + 8) + key_size)
        for i in range(used):
            at = i * (key_size + 8)
            key = _u(f"II{rank + 1}Q", body, at)
            child = _u("Q", body, at + key_size)[0]
            if level == 0:
                yield key, child
            else:
                yield from self._chunk_entries(child, key_size, rank)

    # -- global heap -----------------------------------------------------------
    def gheap_object(self, addr: int, index: int) -> bytes:
        with self.lock:
            objs = self._gheaps.get(addr)
            if objs is None:
                head = self.read(addr, 16)
                if head[:4] != b"GCOL":
                    raise OSError(f"{self.path}: bad global heap at {addr}")
                size = _u("Q", head, 8)[0]
                buf = self.read(addr, size)
                objs, pos = {}, 16
                while pos + 16 <= size:
                    idx, _, _, n = _u("HHIQ", buf, pos)
                    if idx == 0:
                        break
                    objs[idx] = buf[pos + 16:pos + 16 + n]
                    pos += 16 + _pad8(n)
                self._gheaps[addr] = objs
        return objs[index]

    def write_gheap(self, items: List[bytes]) -> int:
        body = b""
        for i, item in enumerate(items, 1):
            body += struct.pack("<HHIQ", i, 0, 0, len(item)) + _padded(item)
        size = max(_GHEAP_MIN, 16 + len(body) + 16)
        free = size - 16 - len(body)
        buf = (b"GCOL" + struct.pack("<B3xQ", 1, size) + body
               + struct.pack("<HHIQ", 0, 0, 0, free) + b"\0" * (free - 16))
        return self.append(buf)

    # -- element conversion ----------------------------------------------------
    def from_disk(self, dt: _DType, raw: bytes, shape) -> np.ndarray:
        n = int(np.prod(shape))
        if dt.kind == "vlen":
            refs = np.frombuffer(raw, np.dtype([("n", "<u4"), ("addr", "<u8"),
                                                ("idx", "<u4")]), n)
            out = np.empty(n, object)
            for i, (length, addr, idx) in enumerate(refs.tolist()):
                out[i] = (self.gheap_object(addr, idx)[:length]
                          if addr else b"")
            return out.reshape(shape)
        return _as_read(dt, np.frombuffer(raw, dt.disk, n).reshape(shape))

    def to_disk(self, dt: _DType, arr: np.ndarray) -> bytes:
        if dt.kind == "vlen":
            flat = [v.encode("utf-8") if isinstance(v, str) else bytes(v)
                    for v in np.asarray(arr, object).reshape(-1)]
            if not flat:
                return b""
            addr = self.write_gheap(flat)
            return b"".join(struct.pack("<IQI", len(v), addr, i)
                            for i, v in enumerate(flat, 1))
        return np.ascontiguousarray(arr, dtype=dt.disk).tobytes()

    # -- metadata writing --------------------------------------------------------
    def flush(self) -> None:
        with self.lock:
            if not self.writable or not self.root.dirty:
                return
            self._write_obj(self.root)
            self._write_superblock()

    def _write_obj(self, obj: _Obj) -> int:
        if not obj.dirty:
            return obj.addr
        if isinstance(obj, _GroupObj):
            entries = {}
            for name, child in obj.children.items():
                if isinstance(child, (str, _SoftLink)):
                    kind = ("soft link" if isinstance(child, _SoftLink)
                            else child)
                    raise NotImplementedError(
                        f"rewriting a group that holds an HDF5 {kind}")
                entries[name] = (child if isinstance(child, int)
                                 else self._write_obj(child))
            obj.btree_heap = self._write_symbol_table(entries)
            msgs = [(0x11, 0, struct.pack("<QQ", *obj.btree_heap))]
        else:
            msgs = [(0x8, 0, self._write_layout(obj))]
        msgs = obj.kept + msgs + [(0xC, 0, a) for a in obj.attrs.values()]
        obj.addr = self.append(_object_header(msgs))
        obj.dirty = False
        return obj.addr

    def _write_symbol_table(self, entries: Dict[str, int]
                            ) -> Tuple[int, int]:
        names = sorted(entries, key=lambda s: s.encode("utf-8"))
        heap, offsets = b"\0" * 8, {}
        for name in names:
            offsets[name] = len(heap)
            heap += _padded(name.encode("utf-8") + b"\0")
        heap_addr = self.append(
            b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), _FREE_NULL, 0)
            + heap)
        os.pwrite(self.fd, struct.pack("<Q", heap_addr + 32), heap_addr + 24)
        # symbol table nodes of up to 2K entries, each at full size
        leaves = []
        k = self.leaf_k
        for i in range(0, len(names), 2 * k):
            part = names[i:i + 2 * k]
            body = b"".join(struct.pack("<QQII16x", offsets[n], entries[n],
                                        0, 0) for n in part)
            node = (b"SNOD" + struct.pack("<BxH", 1, len(part)) + body
                    + b"\0" * (40 * (2 * k - len(part))))
            leaves.append((self.append(node), offsets[part[0]],
                           offsets[part[-1]]))

        def body(level, lo, hi):
            # a group key is the heap offset of the last name below the
            # child before it (the empty name before the first)
            out = struct.pack("<Q", level[lo - 1][2] if lo else 0)
            for child, _, last in level[lo:hi]:
                out += struct.pack("<QQ", child, last)
            return out

        return self._write_tree(0, self.group_k, 8, leaves, body), heap_addr

    def _write_tree(self, node_type: int, k: int, key_size: int,
                    children, body) -> int:
        """A v1 B-tree over ``children`` = [(address, first key, last key)]
        in key order, nodes of at most 2K children written at full size;
        its root's address.  ``body(level, lo, hi)`` encodes the keys and
        child pointers of the node over ``level[lo:hi]``."""
        node_size = 24 + (2 * k + 1) * key_size + 2 * k * 8
        depth = 0
        while True:
            bounds = [(i, min(i + 2 * k, len(children)))
                      for i in range(0, len(children), 2 * k)] or [(0, 0)]
            addrs = [self.append(b"\0" * node_size) for _ in bounds]
            parents = []
            for j, (lo, hi) in enumerate(bounds):
                left = addrs[j - 1] if j else UNDEF
                right = addrs[j + 1] if j + 1 < len(addrs) else UNDEF
                node = (b"TREE" + struct.pack("<BBHQQ", node_type, depth,
                                              hi - lo, left, right)
                        + body(children, lo, hi))
                os.pwrite(self.fd, node, addrs[j])
                if hi > lo:
                    parents.append((addrs[j], children[lo][1],
                                    children[hi - 1][2]))
            if len(addrs) == 1:
                return addrs[0]
            children, depth = parents, depth + 1

    def _write_layout(self, d: _DatasetObj) -> bytes:
        if d.layout == "contiguous":
            return struct.pack("<BBQQ", 3, 1, d.data_addr, d.data_size)
        if d.layout == "compact":
            return struct.pack("<BBH", 3, 0, len(d.compact)) + d.compact
        rank = len(d.shape)
        key = struct.Struct(f"<II{rank + 1}Q")
        index = d.index()
        # (chunk address, its key, its offsets) in C order
        chunks = []
        for pos in sorted(index):
            addr, nbytes, mask = index[pos]
            offs = [p * c for p, c in zip(pos, d.chunks)]
            chunks.append((addr, key.pack(nbytes, mask, *offs, 0), offs))

        def body(level, lo, hi):
            # a chunk key is the first chunk below the child after it; the
            # last one the end of the last chunk
            out = b""
            for child, first, _ in level[lo:hi]:
                out += first + struct.pack("<Q", child)
            if hi < len(level):
                return out + level[hi][1]
            end = [o + c for o, c in zip(level[hi - 1][2], d.chunks)]
            return out + key.pack(0, 0, *end, 0)

        d.btree = (self._write_tree(1, self.chunk_k, key.size, chunks, body)
                   if chunks else UNDEF)
        return (struct.pack("<BBBQ", 3, 2, rank + 1, d.btree)
                + struct.pack(f"<{rank + 1}I", *d.chunks, d.dt.size))


def _decode_link(data) -> Tuple[str, Any]:
    """(name, target) of a link message: a header address for a hard
    link, a :class:`_SoftLink`, or the kind's name for an external or
    user-defined link (opening it raises)."""
    version, flags = data[0], data[1]
    if version != 1:
        raise NotImplementedError(f"HDF5 link message version {version}")
    pos = 2
    link_type = 0
    if flags & 0x8:
        link_type = data[pos]
        pos += 1
    if flags & 0x4:
        pos += 8
    if flags & 0x10:
        pos += 1
    width = 1 << (flags & 3)
    n = int.from_bytes(data[pos:pos + width], "little")
    pos += width
    name = bytes(data[pos:pos + n]).decode("utf-8")
    pos += n
    if link_type == 0:
        return name, _u("Q", data, pos)[0]
    if link_type == 1:
        n = _u("H", data, pos)[0]
        return name, _SoftLink(bytes(data[pos + 2:pos + 2 + n]).decode(
            "utf-8"))
    return name, ("external link" if link_type == 64
                  else f"user-defined link (type {link_type})")


def _decode_fill(data) -> Optional[bytes]:
    version = data[0]
    if version in (1, 2):
        if version == 2 and not data[3]:
            return None
        size = _u("I", data, 4)[0]
        return bytes(data[8:8 + size]) if size else None
    if version == 3:
        flags = data[1]
        if not flags & 0x20:
            return None
        size = _u("I", data, 2)[0]
        return bytes(data[6:6 + size]) if size else None
    raise NotImplementedError(f"HDF5 fill value message version {version}")


def _decode_layout(d: _DatasetObj, data) -> None:
    version = data[0]
    if version in (1, 2):
        ndims, cls = data[1], data[2]
        pos = 8
        if cls != 0:
            addr = _u("Q", data, pos)[0]
            pos += 8
        dims = _u(f"{ndims}I", data, pos)
        pos += 4 * ndims
        if cls == 0:
            size = _u("I", data, pos)[0]
            d.layout, d.compact = "compact", bytes(data[pos + 4:pos + 4 + size])
        elif cls == 1:
            d.layout, d.data_addr = "contiguous", addr
            d.data_size = int(np.prod(d.shape)) * d.dt.size if d.dt else 0
        else:
            d.layout, d.btree, d.chunks = "chunked", addr, tuple(dims[:-1])
    elif version == 4 and data[1] == 2:
        hdf5_v2.decode_layout4(d, data)
    elif version in (3, 4):
        cls = data[1]
        if cls == 0:
            size = _u("H", data, 2)[0]
            d.layout, d.compact = "compact", bytes(data[4:4 + size])
        elif cls == 1:
            d.layout = "contiguous"
            d.data_addr, d.data_size = _u("QQ", data, 2)
        elif cls == 2:
            ndims = data[2]
            d.layout, d.btree = "chunked", _u("Q", data, 3)[0]
            d.chunks = tuple(_u(f"{ndims}I", data, 11)[:-1])
        else:
            raise NotImplementedError(f"HDF5 data layout class {cls}")
    else:
        raise NotImplementedError(f"HDF5 data layout message version "
                                  f"{version}")


def _object_header(msgs) -> bytes:
    body = b""
    for mtype, mflags, data in msgs:
        data = _padded(bytes(data))
        body += struct.pack("<HHB3x", mtype, len(data), mflags) + data
    return struct.pack("<BxHII4x", 1, len(msgs), 1, len(body)) + body


def _open_state(path: str, mode: str) -> _State:
    if mode not in ("r", "r+", "a", "w", "w-", "x"):
        raise ValueError(f"invalid HDF5 file mode {mode!r}")
    key = os.path.realpath(path)
    with _STATES_LOCK:
        state = _STATES.get(key)
        if state is not None:
            if mode in ("w", "w-", "x"):
                raise OSError(f"{path} is already open: cannot truncate it")
            if mode != "r":
                state.reopen_writable()
        else:
            state = _State(path, mode)
            _STATES[key] = state
        state.refs += 1
        return state


def _release(state: _State) -> None:
    with _STATES_LOCK:
        state.refs -= 1
        state.flush()
        if state.refs == 0:
            os.close(state.fd)
            del _STATES[state.key]


# ---------------------------------------------------------------------------
# the h5py-like surface
# ---------------------------------------------------------------------------

class AttributeManager:
    """``obj.attrs``: values as h5py returns them (numpy scalars and
    arrays, ``str`` for variable-length strings)."""

    def __init__(self, handle: "File", obj: _Obj):
        self._file = handle
        self._obj = obj

    def __getitem__(self, name: str) -> Any:
        raw = self._obj.attrs[name]
        _, dt, shape, data = _decode_attr(raw)
        if shape is None:
            return None
        arr = self._obj.state.from_disk(dt, data, shape)
        if dt.kind == "vlen":
            arr = np.vectorize(lambda b: b.decode("utf-8"), otypes=[object]
                               )(arr) if arr.size else arr
        return arr[()] if shape == () else arr

    def __setitem__(self, name: str, value: Any) -> None:
        arr, dt = _value_and_type(value)
        state = self._obj.state
        state.require_writable()
        raw = _encode_attr(name, dt, arr.shape, state.to_disk(dt, arr))
        if len(raw) > 65000:
            raise NotImplementedError(
                f"HDF5 attribute {name!r} of {len(raw)} bytes (dense "
                "attribute storage)")
        with state.lock:
            self._obj.attrs[name] = raw
            self._obj.touch()

    def __contains__(self, name: str) -> bool:
        return name in self._obj.attrs

    def keys(self):
        return list(self._obj.attrs)

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def get(self, name: str, default: Any = None) -> Any:
        return self[name] if name in self else default

    def update(self, other: Dict[str, Any]) -> None:
        for k, v in other.items():
            self[k] = v


def _split(path: str) -> List[str]:
    return [p for p in path.split("/") if p]


class Group:
    """A group: ``g[path]``, ``require_group``, ``create_dataset``,
    ``require_dataset``, ``attrs``, ``keys``."""

    def __init__(self, handle: "File", obj: _GroupObj, name: str):
        self.file = handle
        self._obj = obj
        self.name = name
        self.attrs = AttributeManager(handle, obj)

    def _child(self, g: _GroupObj, name: str, hops: int = 0) -> _Obj:
        child = g.children[name]
        if isinstance(child, _SoftLink):
            if hops >= _MAX_SOFT_LINKS:
                raise KeyError(f"too many soft links resolving {name!r}")
            obj = self._walk(g, child.path, hops + 1)
            if obj is None:
                raise KeyError(f"dangling soft link {name!r} -> "
                               f"{child.path!r}")
            return obj
        if isinstance(child, str):
            raise NotImplementedError(f"HDF5 {child} {name!r}")
        if isinstance(child, int):
            with g.state.lock:
                child = g.children[name]
                if isinstance(child, int):
                    child = g.children[name] = g.state.load(child, g)
        return child

    def _walk(self, start: _Obj, path: str, hops: int) -> Optional[_Obj]:
        """The object at ``path`` from ``start`` (from the root if the path
        is absolute), or None where a name is missing."""
        obj = start.state.root if path.startswith("/") else start
        for part in _split(path):
            if part == ".":  # HDF5 reads "." as here and ".." as a name
                continue
            if not isinstance(obj, _GroupObj) or part not in obj.children:
                return None
            obj = self._child(obj, part, hops)
        return obj

    def _resolve(self, path: str) -> Optional[_Obj]:
        """The object at ``path`` below this group, or None (also behind
        a dangling soft link)."""
        try:
            return self._walk(self._obj, "/".join(_split(path)), 0)
        except KeyError:
            return None

    def _wrap(self, obj: _Obj, path: str):
        name = "/" + "/".join(_split(self.name) + _split(path))
        if isinstance(obj, _GroupObj):
            return Group(self.file, obj, name)
        return Dataset(self.file, obj, name)

    def __getitem__(self, path: str):
        obj = self._walk(self._obj, "/".join(_split(path)), 0)
        if obj is None:
            raise KeyError(f"{path!r} does not exist in {self.name!r}")
        return self._wrap(obj, path)

    def __contains__(self, path: str) -> bool:
        """Whether the link at ``path`` exists (a dangling soft link
        does, as in h5py)."""
        parts = _split(path)
        parent = self._resolve("/".join(parts[:-1]))
        return isinstance(parent, _GroupObj) and (
            not parts or parts[-1] in parent.children)

    def keys(self) -> List[str]:
        return sorted(self._obj.children)

    def _writable(self) -> _State:
        state = self._obj.state
        state.require_writable()
        return state

    def _parent_of(self, path: str, create: bool) -> Tuple[_GroupObj, str]:
        parts = _split(path)
        if not parts:
            raise ValueError("empty HDF5 object name")
        g = self._obj
        for part in parts[:-1]:
            if part not in g.children:
                if not create:
                    raise KeyError(path)
                new = _GroupObj(g.state, None, g)
                g.children[part] = new
                g.touch()
            nxt = self._child(g, part)
            if not isinstance(nxt, _GroupObj):
                raise TypeError(f"{part!r} in {path!r} is not a group")
            g = nxt
        return g, parts[-1]

    def require_group(self, path: str) -> "Group":
        obj = self._resolve(path)
        if obj is not None:
            if not isinstance(obj, _GroupObj):
                raise TypeError(f"{path!r} exists and is not a group")
            return self._wrap(obj, path)
        return self.create_group(path)

    def create_group(self, path: str) -> "Group":
        state = self._writable()
        with state.lock:
            g, name = self._parent_of(path, create=True)
            if name in g.children:
                raise ValueError(f"{path!r} already exists")
            new = _GroupObj(state, None, g)
            g.children[name] = new
            g.touch()
        return self._wrap(new, path)

    def create_dataset(self, path: str, shape=None, dtype=None, data=None,
                       chunks=None, compression=None) -> "Dataset":
        """h5py's ``create_dataset``: chunked when ``chunks`` is given or
        a filter needs it (``chunks=True`` or a filter alone: the whole
        shape), else contiguous.  ``compression``: ``"gzip"`` (deflate at
        h5py's default level 4) or None."""
        state = self._writable()
        if data is not None:
            arr, dt = _value_and_type(data)
            if dtype is not None and dt.kind not in ("vlen",):
                arr = arr.astype(dtype)
                dt = _encode_dtype(arr.dtype)
            shape = arr.shape if shape is None else tuple(shape)
        else:
            if shape is None or dtype is None:
                raise TypeError("create_dataset needs shape and dtype or "
                                "data")
            arr, dt = None, _encode_dtype(np.dtype(dtype))
        shape = tuple(int(s) for s in shape)
        if compression in ("raw", None):
            compression = None
        elif compression not in ("gzip", "zlib", "deflate"):
            raise NotImplementedError(f"HDF5 compression {compression!r} "
                                      "(gzip is supported)")
        filters = [(1, 1, (4,))] if compression else []
        if chunks is True or (chunks is None and filters):
            chunks = shape
        d = _DatasetObj(state, None, None)
        d.shape, d.dt, d.filters = shape, dt, filters
        if chunks is not None and shape:
            if dt.kind == "vlen":
                raise NotImplementedError("chunked variable-length string "
                                          "datasets")
            chunks = tuple(int(c) for c in chunks)
            if len(chunks) != len(shape) or any(
                    c < 1 or (s and c > s) for c, s in zip(chunks, shape)):
                raise ValueError(f"Chunk shape {chunks} must not be greater "
                                 f"than data shape {shape} in any dimension")
            d.layout, d.chunks, d._index = "chunked", chunks, {}
        else:
            if filters:
                raise ValueError("filters need a chunked dataset")
            d.layout = "contiguous"
        if dt.kind != "vlen":
            d.fill = b"\0" * dt.size
        d.kept = [(0x1, 0, _encode_space(shape)), (0x3, 1, dt.raw),
                  (0x5, 1, _encode_fill(d))]
        if filters:
            d.kept.append((0xB, 0, _encode_filters(filters)))
        with state.lock:
            g, name = self._parent_of(path, create=True)
            if name in g.children:
                raise ValueError(f"{path!r} already exists")
            d.parent = g
            g.children[name] = d
            d.touch()
        ds = self._wrap(d, path)
        if arr is not None:
            ds[...] = arr
        return ds

    def require_dataset(self, path: str, shape, dtype, exact: bool = False,
                        **kwargs) -> "Dataset":
        obj = self._resolve(path)
        if obj is None:
            return self.create_dataset(path, shape=shape, dtype=dtype,
                                       **kwargs)
        if not isinstance(obj, _DatasetObj):
            raise TypeError(f"{path!r} exists and is not a dataset")
        if tuple(shape) != obj.shape:
            raise TypeError(f"Shapes do not match (existing {obj.shape} vs "
                            f"new {tuple(shape)})")
        want = np.dtype(dtype)
        if (exact and want != obj.dt.mem) or not np.can_cast(want,
                                                             obj.dt.mem):
            raise TypeError(f"Datatypes cannot be safely cast (existing "
                            f"{obj.dt.mem} vs new {want})")
        return self._wrap(obj, path)


def _encode_fill(d: _DatasetObj) -> bytes:
    alloc = 3 if d.layout == "chunked" else 2
    if d.fill is None:
        return struct.pack("<BBBB", 2, alloc, 2, 0)
    return struct.pack("<BBBBI", 2, alloc, 2, 1, len(d.fill)) + d.fill


class Dataset:
    """A dataset with numpy-style basic slicing (unit steps)."""

    def __init__(self, handle: "File", obj: _DatasetObj, name: str):
        self.file = handle
        self._obj = obj
        self.name = name
        self.attrs = AttributeManager(handle, obj)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._obj.shape

    @property
    def ndim(self) -> int:
        return len(self._obj.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self._obj.shape))

    @property
    def dtype(self) -> np.dtype:
        return self._obj.dt.mem

    @property
    def chunks(self) -> Optional[Tuple[int, ...]]:
        return self._obj.chunks if self._obj.layout == "chunked" else None

    def __len__(self) -> int:
        return self._obj.shape[0]

    # -- whole-extent (contiguous, compact) datasets -----------------------------
    def _read_all(self) -> np.ndarray:
        d, state = self._obj, self._obj.state
        if d.layout == "compact":
            raw = d.compact
        elif d.data_addr == UNDEF:
            return self._filled(d.shape)
        else:
            raw = state.read(d.data_addr, int(np.prod(d.shape)) * d.dt.size)
        return state.from_disk(d.dt, raw, d.shape)

    def _filled(self, shape) -> np.ndarray:
        d = self._obj
        if d.dt.kind == "vlen":
            out = np.empty(shape, object)
            out[...] = b""
            return out
        if d.fill is not None:
            value = self._obj.state.from_disk(d.dt, d.fill, ())
            return np.full(shape, value, d.dt.mem)
        return np.zeros(shape, d.dt.mem)

    # -- chunks ----------------------------------------------------------------
    def _decode_chunk(self, entry, pos) -> np.ndarray:
        d, state = self._obj, self._obj.state
        addr, nbytes, mask = entry
        raw = state.read(addr, nbytes)
        for i in reversed(range(len(d.filters))):
            if mask & (1 << i):
                continue
            fid, _, values = d.filters[i]
            if fid == 3:
                raw, stored = raw[:-4], raw[-4:]
                if not _fletcher32_matches(raw, stored):
                    raise OSError(
                        f"Can't read data (fletcher32 checksum mismatch in "
                        f"dataset {self.name!r}, chunk {tuple(pos)})")
                continue
            try:  # a stream that does not decode: h5py's OSError
                raw = self._unfilter(fid, values, raw)
            except (zlib.error, ValueError) as e:
                raise OSError(
                    f"Can't read data ({_FILTERS[fid]} failed in dataset "
                    f"{self.name!r}, chunk {tuple(pos)}: {e})") from e
        if len(raw) != int(np.prod(d.chunks)) * d.dt.size:
            raise OSError(f"Can't read data (chunk {tuple(pos)} of dataset "
                          f"{self.name!r} holds {len(raw)} bytes)")
        return state.from_disk(d.dt, raw, d.chunks)

    def _unfilter(self, fid: int, values, raw: bytes) -> bytes:
        """One filter of the pipeline undone (fletcher32 aside)."""
        d = self._obj
        if fid == 1:
            return zlib.decompress(raw)
        if fid == 2:
            return _unshuffle(raw, values[0] if values else d.dt.size)
        if fid == 6:
            return _scaleoffset_decode(raw, values, d.dt)
        # LZF (32000): its plain size is the chunk's, or the filter's
        # third value where a filter before it changed the size
        return codecs.lzf_decompress(raw, max(
            values[2] if len(values) > 2 else 0,
            int(np.prod(d.chunks)) * d.dt.size)).tobytes()

    def _encode_chunk(self, arr: np.ndarray) -> bytes:
        """The chunk's stored bytes: deflated where the dataset says so
        (files this module opens in ``"a"`` may carry filters it reads
        but does not write: writing to those raises)."""
        d = self._obj
        raw = d.state.to_disk(d.dt, arr)
        for fid, _, values in d.filters:
            if fid != 1:
                raise NotImplementedError(
                    f"writing chunks through the HDF5 filter "
                    f"{_FILTERS[fid]!r}")
            raw = zlib.compress(raw, values[0] if values else 4)
        return raw

    def _chunk_range(self, sl):
        return product(*[range(s.start // c, -(-s.stop // c))
                         if s.stop > s.start else range(0)
                         for s, c in zip(sl, self._obj.chunks)])

    def __getitem__(self, bb) -> np.ndarray:
        from .storage import _normalize_index

        d = self._obj
        if (d.layout == "contiguous" and d.shape and d.data_addr != UNDEF
                and d.dt.kind != "vlen"):
            # only the selection is read from the file
            mm = np.memmap(d.state.path, d.dt.disk, "r", d.data_addr,
                           d.shape)
            return _as_read(d.dt, np.array(mm[bb]))
        if d.shape == () or d.layout != "chunked":
            full = self._read_all()
            return full[bb] if bb != () else full[()]
        sl, squeeze = _normalize_index(bb, d.shape)
        out = self._filled([s.stop - s.start for s in sl])
        index = d.index()
        for pos in self._chunk_range(sl):
            entry = index.get(pos)
            if entry is None:
                continue
            data = self._decode_chunk(entry, pos)
            src, dst = [], []
            for p, c, s in zip(pos, d.chunks, sl):
                lo, hi = max(s.start, p * c), min(s.stop, (p + 1) * c)
                src.append(slice(lo - p * c, hi - p * c))
                dst.append(slice(lo - s.start, hi - s.start))
            out[tuple(dst)] = data[tuple(src)]
        return out.squeeze(axis=tuple(squeeze)) if squeeze else out

    def __setitem__(self, bb, value) -> None:
        from .storage import _normalize_index

        d, state = self._obj, self._obj.state
        state.require_writable()
        if d.layout != "chunked":
            full = self._read_all().copy() if d.shape else None
            if d.shape:
                full[bb] = value
            else:
                full = np.asarray(value, dtype=d.dt.mem if d.dt.kind !=
                                  "vlen" else object)
            raw = state.to_disk(d.dt, full)
            with state.lock:
                d.layout = "contiguous"
                d.data_addr, d.data_size = state.append(raw), len(raw)
                d.touch()
            return
        sl, squeeze = _normalize_index(bb, d.shape)
        region = [s.stop - s.start for s in sl]
        arr = np.asarray(value)
        if squeeze and arr.ndim:
            arr = np.expand_dims(arr, tuple(squeeze))
        arr = np.broadcast_to(arr.astype(d.dt.mem, copy=False), region)
        index = d.index()
        for pos in self._chunk_range(sl):
            cbb = [slice(p * c, min((p + 1) * c, s))
                   for p, c, s in zip(pos, d.chunks, d.shape)]
            inter = [slice(max(s.start, c.start), min(s.stop, c.stop))
                     for s, c in zip(sl, cbb)]
            src = tuple(slice(i.start - s.start, i.stop - s.start)
                        for i, s in zip(inter, sl))
            dst = tuple(slice(i.start - c.start, i.stop - c.start)
                        for i, c in zip(inter, cbb))
            if all(i.start == c.start and i.stop - i.start == ch
                   for i, c, ch in zip(inter, cbb, d.chunks)):
                full = np.empty(d.chunks, d.dt.mem)
                full[...] = arr[src]
                self._store(pos, full)
                continue
            with state.lock:
                lock = d.chunk_locks.setdefault(pos, threading.Lock())
            # ctt-lint: disable=blocking-under-lock (the chunk's read-modify-write IS the critical section: the per-chunk lock serializes partial writes of one chunk)
            with lock:
                entry = index.get(pos)
                full = (self._decode_chunk(entry, pos).copy()
                        if entry is not None
                        else self._filled(d.chunks))
                full[dst] = arr[src]
                self._store(pos, full)

    def _store(self, pos, full: np.ndarray) -> None:
        d, state = self._obj, self._obj.state
        raw = self._encode_chunk(full)
        addr = state.append(raw)
        with state.lock:
            d.index()[pos] = (addr, len(raw), 0)
            d.touch()


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (``H5_checksum_fletcher32`` in H5checksum.c):
    16-bit words, high byte first, summed in runs of 360 words with the
    two sums folded to 16 bits after each run, a trailing odd byte as the
    high byte of one more word, and a last fold."""
    buf = np.frombuffer(data, np.uint8)
    n_words = buf.size // 2
    words = (buf[:2 * n_words:2].astype(np.int64) << 8) \
        | buf[1:2 * n_words:2].astype(np.int64)
    sum1 = sum2 = 0
    for lo in range(0, n_words, 360):
        run = words[lo:lo + 360]
        # sum2 gains sum1 after every word: the previous sum1 once per
        # word plus the running prefix sums of this run
        # (masked to 32 bits: the sums are uint32 in HDF5)
        sum2 = (sum2 + len(run) * sum1 + int(np.cumsum(run).sum())) \
            & 0xFFFFFFFF
        sum1 = (sum1 + int(run.sum())) & 0xFFFFFFFF
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    if buf.size % 2:
        sum1 += int(buf[-1]) << 8
        sum2 += sum1
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
    sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    return ((sum2 << 16) | sum1) & 0xFFFFFFFF


def _fletcher32_matches(raw: bytes, stored: bytes) -> bool:
    """The stored checksum (little-endian) against the chunk's bytes;
    HDF5's reader also takes the byte-swapped form older versions wrote
    on little-endian machines (H5Zfletcher32.c)."""
    want = fletcher32(raw)
    swapped = bytes([stored[1], stored[0], stored[3], stored[2]])
    return want in (int.from_bytes(stored, "little"),
                    int.from_bytes(swapped, "little"))


def _scaleoffset_decode(raw: bytes, values, dt: _DType) -> bytes:
    """A chunk of HDF5's scale-offset filter (H5Zscaleoffset.c) decoded:
    a 21-byte head (the bits per element, the minimum), then each element
    less the minimum in that many bits, most significant bit first; the
    all-ones value stands for the fill value where one is defined.
    Integers (minimum bits), and floats in D-scale mode: the stored
    integers over 10**D plus the minimum, in the float's precision."""
    scale_type, factor, nelmts, cls, size, sign = values[:6]
    fill_defined = values[7]
    if len(raw) < 21:
        raise ValueError("corrupt scale-offset chunk (no head)")
    minbits = int.from_bytes(raw[:4], "little")
    minval = int.from_bytes(raw[5:5 + min(raw[4], 8)], "little")
    if minbits > 8 * size or size not in (1, 2, 4, 8):
        raise ValueError(f"corrupt scale-offset chunk ({minbits} bits)")
    itype = np.dtype(f"<{'i' if cls or sign else 'u'}{size}")
    if minbits == 8 * size:  # stored at full precision
        return raw[21:21 + nelmts * size]
    if minbits == 0:
        vals = np.zeros(nelmts, np.uint64)
    else:
        bits = np.unpackbits(np.frombuffer(raw, np.uint8, offset=21),
                             bitorder="big")
        if len(bits) < nelmts * minbits:
            raise ValueError("truncated scale-offset chunk")
        wide = np.zeros((nelmts, 64), np.uint8)
        wide[:, 64 - minbits:] = bits[:nelmts * minbits].reshape(nelmts,
                                                                 minbits)
        vals = np.packbits(wide, axis=1).view(">u8").reshape(-1).astype(
            np.uint64)
    fill_code = (1 << minbits) - 1
    fill = (np.frombuffer(struct.pack(f"<{len(values) - 8}I", *values[8:]),
                          np.uint8)[:size].view(dt.disk.newbyteorder("<"))
            [0] if fill_defined else None)
    is_fill = (vals == fill_code) if fill_defined else None
    if cls == 0:  # integers: the value plus the minimum, modulo the width
        out = (vals + np.uint64(minval)).astype(f"<u{size}").view(itype)
    else:  # D-scale floats: the bits as a signed integer of the width
        ftype = np.dtype(f"<f{size}")
        lo = minval & ((1 << (8 * size)) - 1)
        low = np.array([lo], f"<u{size}").view(ftype)[0]
        ints = vals.astype(f"<u{size}").view(itype)
        # powf / pow of 10 and the float's own arithmetic, as the filter
        scale = ftype.type(10.0 ** factor)
        out = ints.astype(ftype) / scale + low
        if fill_defined:
            is_fill = ints == np.array([fill_code], np.uint64).astype(
                f"<u{size}").view(itype)[0]
    out = out.astype(dt.disk.newbyteorder("<"))
    if fill_defined:
        out[is_fill] = fill
    return out.tobytes()


def _unshuffle(raw: bytes, typesize: int) -> bytes:
    n = len(raw) // typesize * typesize
    buf = np.frombuffer(raw, np.uint8)
    body = buf[:n].reshape(typesize, -1).T.tobytes()
    return body + bytes(buf[n:])


class File:
    """An HDF5 file (modes ``r`` (the default), ``r+``, ``a``, ``w``,
    ``w-``/``x``, as in h5py) with the root group's surface.  Handles on
    one path share one state; close (or garbage collection) flushes the
    metadata.  Groups, datasets and attribute views keep their handle
    open."""

    def __init__(self, path: str, mode: str = "r"):
        self.path = path
        self.mode = mode
        self._state = _open_state(path, mode)
        self._finalizer = weakref.finalize(self, _release, self._state)

    def _root(self) -> Group:
        # made per call: a stored one would tie the handle into a cycle
        return Group(self, self._state.root, "/")

    @property
    def attrs(self) -> AttributeManager:
        return AttributeManager(self, self._state.root)

    def __getitem__(self, path: str):
        return self._root()[path]

    def __contains__(self, path: str) -> bool:
        return path in self._root()

    def keys(self) -> List[str]:
        return self._root().keys()

    def require_group(self, path: str) -> Group:
        return self._root().require_group(path)

    def create_group(self, path: str) -> Group:
        return self._root().create_group(path)

    def create_dataset(self, path: str, **kwargs) -> Dataset:
        return self._root().create_dataset(path, **kwargs)

    def require_dataset(self, path: str, shape, dtype, **kwargs) -> Dataset:
        return self._root().require_dataset(path, shape, dtype, **kwargs)

    def close(self) -> None:
        self._finalizer()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
