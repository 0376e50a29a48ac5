"""The HDF5 structures of files written with ``libver="latest"``.

HDF5 1.8 and later write these where a file asks for the newest format
(h5py's ``libver="latest"`` or ``("v110", "latest")``), and in part also
for groups that track creation order (``track_order=True``):

* superblock versions 2 and 3;
* version 2 object headers (``OHDR``) and their continuation blocks
  (``OCHK``);
* dense link and attribute storage: a fractal heap (``FRHP``, its direct
  and indirect blocks ``FHDB``/``FHIB``; managed, huge and tiny objects)
  indexed by a version 2 B-tree (``BTHD``/``BTIN``/``BTLF``) of record
  types 5 (links by name hash) and 8 (attributes by name hash);
* the chunk indexes of data layout message version 4: single chunk,
  implicit, fixed array (``FAHD``/``FADB``, paged or not), extensible
  array (``EAHD``/``EAIB``/``EASB``/``EADB``) and version 2 B-tree record
  types 10 and 11.

Every one of these structures ends in Jenkins' lookup3 checksum; each is
verified as it is read, and a mismatch raises ``OSError`` naming the
structure and its address (the library under h5py refuses such a file
too).  ``core/hdf5.py`` calls in here through its file state, whose
``read(addr, n)`` gives the bytes and ``path`` names the file.
"""

from __future__ import annotations

import struct
from itertools import product
from typing import Dict, List, Optional, Tuple

import numpy as np

from .codecs import lookup3

UNDEF = 0xFFFFFFFFFFFFFFFF


def _le(buf, off: int, n: int) -> int:
    return int.from_bytes(bytes(buf[off:off + n]), "little")


def _enc_size(n: int) -> int:
    """HDF5's ``H5VM_limit_enc_size``: bytes to encode counts up to n."""
    return (max(n, 1).bit_length() - 1) // 8 + 1


def _log2(n: int) -> int:
    return max(n, 1).bit_length() - 1


def verify(state, buf, addr: int, what: str) -> None:
    """The lookup3 checksum in the last 4 bytes of ``buf`` against the
    bytes before it."""
    end = len(buf) - 4
    if end < 0 or lookup3(buf[:end]) != _le(buf, end, 4):
        raise OSError(f"{state.path}: incorrect metadata checksum in HDF5 "
                      f"{what} at {addr}")


def _signed(state, addr: int, n: int, sig: bytes, what: str) -> bytes:
    buf = state.read(addr, n)
    if buf[:4] != sig:
        raise OSError(f"{state.path}: bad HDF5 {what} signature at {addr}")
    return buf


# ---------------------------------------------------------------------------
# superblock and object headers
# ---------------------------------------------------------------------------

def superblock(state, head: bytes) -> Tuple[int, int]:
    """(root object header address, end of file) of a version 2 or 3
    superblock."""
    if head[9] != 8 or head[10] != 8:
        raise NotImplementedError(f"HDF5 offsets of {head[9]} and lengths "
                                  f"of {head[10]} bytes")
    verify(state, head[:48], 0, "superblock")
    base, _ext, eof, root = struct.unpack_from("<4Q", head, 12)
    if base != 0:
        raise NotImplementedError("HDF5 base address other than 0 (user "
                                  "block)")
    return root, eof


def _messages(buf, pos: int, end: int, crt_order: bool, out: List,
              blocks: List) -> None:
    head = 6 if crt_order else 4
    while pos + head <= end:
        mtype, size, mflags = buf[pos], _le(buf, pos + 1, 2), buf[pos + 3]
        pos += head
        data = buf[pos:pos + size]
        if pos + size > end:
            raise OSError("HDF5 object header message runs past its block")
        pos += size
        if mtype == 0x10:
            blocks.append(struct.unpack_from("<QQ", data))
        elif mtype != 0:
            out.append((mtype, mflags, data))


def object_header(state, addr: int) -> List[Tuple[int, int, bytes]]:
    """The messages (type, flags, data) of the version 2 object header at
    ``addr`` and its continuation blocks."""
    head = state.read(addr, 6)
    version, flags = head[4], head[5]
    if version != 2:
        raise NotImplementedError(f"HDF5 object header version {version}")
    prefix = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
    width = 1 << (flags & 3)
    size = _le(state.read(addr + prefix, width), 0, width)
    start = prefix + width
    buf = state.read(addr, start + size + 4)
    verify(state, buf, addr, "object header")
    out: List[Tuple[int, int, bytes]] = []
    blocks: List[Tuple[int, int]] = []
    crt = bool(flags & 0x04)
    _messages(buf, start, start + size, crt, out, blocks)
    while blocks:
        at, length = blocks.pop(0)
        buf = _signed(state, at, length, b"OCHK", "object header "
                      "continuation")
        verify(state, buf, at, "object header continuation")
        _messages(buf, 4, length - 4, crt, out, blocks)
    return out


# ---------------------------------------------------------------------------
# version 2 B-trees
# ---------------------------------------------------------------------------

def btree2_records(state, addr: int) -> Tuple[int, List[bytes]]:
    """(record type, every record in key order) of the version 2 B-tree
    at ``addr``."""
    head = _signed(state, addr, 38, b"BTHD", "v2 B-tree header")
    verify(state, head, addr, "v2 B-tree header")
    btype = head[5]
    node_size, rec_size, depth = struct.unpack_from("<IHH", head, 6)
    root, nrec_root = struct.unpack_from("<QH", head, 16)
    # the node geometry as H5B2__hdr_init derives it
    prefix = 10
    max_nrec = [(node_size - prefix) // rec_size]
    cum_max = [max_nrec[0]]
    cum_size = [0]
    nrec_size = _enc_size(max_nrec[0])
    for u in range(1, depth + 1):
        ptr = 8 + nrec_size + cum_size[u - 1]
        max_nrec.append((node_size - (prefix + ptr)) // (rec_size + ptr))
        cum_max.append((max_nrec[u] + 1) * cum_max[u - 1] + max_nrec[u])
        cum_size.append(_enc_size(cum_max[u]))
    out: List[bytes] = []

    def walk(at: int, nrec: int, level: int) -> None:
        if at == UNDEF or nrec == 0:
            return
        if level == 0:
            n = 6 + nrec * rec_size
            buf = _signed(state, at, n + 4, b"BTLF", "v2 B-tree leaf")
            verify(state, buf, at, "v2 B-tree leaf")
            out.extend(buf[6 + i * rec_size:6 + (i + 1) * rec_size]
                       for i in range(nrec))
            return
        ptr = 8 + nrec_size + cum_size[level - 1]
        n = 6 + nrec * rec_size + (nrec + 1) * ptr
        buf = _signed(state, at, n + 4, b"BTIN", "v2 B-tree internal node")
        verify(state, buf, at, "v2 B-tree internal node")
        kids = []
        for i in range(nrec + 1):
            p = 6 + nrec * rec_size + i * ptr
            kids.append((_le(buf, p, 8), _le(buf, p + 8, nrec_size)))
        for i, (child, child_nrec) in enumerate(kids):
            walk(child, child_nrec, level - 1)
            if i < nrec:
                out.append(buf[6 + i * rec_size:6 + (i + 1) * rec_size])

    walk(root, nrec_root, depth)
    return btype, out


# ---------------------------------------------------------------------------
# fractal heaps
# ---------------------------------------------------------------------------

class FractalHeap:
    """The objects of the fractal heap at ``addr``, by heap ID."""

    def __init__(self, state, addr: int):
        self.state = state
        head = _signed(state, addr, 146, b"FRHP", "fractal heap header")
        self.id_len, filter_len = struct.unpack_from("<HH", head, 5)
        if filter_len:
            raise NotImplementedError("HDF5 fractal heap with I/O filters")
        verify(state, head, addr, "fractal heap header")
        self.flags = head[9]
        self.max_man = _le(head, 10, 4)
        self.huge_btree = _le(head, 22, 8)
        self.width = _le(head, 110, 2)
        self.start_size = _le(head, 112, 8)
        self.max_direct = _le(head, 120, 8)
        max_heap_bits = _le(head, 128, 2)
        self.root = _le(head, 132, 8)
        self.root_rows = _le(head, 140, 2)
        self.off_size = (max_heap_bits + 7) // 8
        self.len_size = min((_log2(self.max_direct) + 7) // 8,
                            _enc_size(self.max_man))
        self.max_direct_rows = (_log2(self.max_direct)
                                - _log2(self.start_size) + 2)
        self.addr = addr
        self._blocks: Dict[int, bytes] = {}
        self._rows: Dict[int, Tuple[List[int], List[int]]] = {}
        self._huge: Optional[Dict[int, Tuple[int, int]]] = None

    def _row_size(self, row: int) -> int:
        return self.start_size << max(row - 1, 0)

    def _direct(self, at: int, size: int) -> bytes:
        buf = self._blocks.get(at)
        if buf is None:
            buf = _signed(self.state, at, size, b"FHDB",
                          "fractal heap direct block")
            if self.flags & 0x02:
                at_sum = 5 + 8 + self.off_size
                zeroed = buf[:at_sum] + b"\0" * 4 + buf[at_sum + 4:]
                if lookup3(zeroed) != _le(buf, at_sum, 4):
                    raise OSError(
                        f"{self.state.path}: incorrect metadata checksum in "
                        f"HDF5 fractal heap direct block at {at}")
            self._blocks[at] = buf
        return buf

    def _indirect(self, at: int, nrows: int) -> Tuple[List[int], List[int]]:
        if at not in self._rows:
            self._rows[at] = self._read_indirect(at, nrows)
        return self._rows[at]

    def _read_indirect(self, at: int, nrows: int
                       ) -> Tuple[List[int], List[int]]:
        n_direct = min(nrows, self.max_direct_rows) * self.width
        n_indirect = max(nrows - self.max_direct_rows, 0) * self.width
        n = 5 + 8 + self.off_size + 8 * (n_direct + n_indirect)
        buf = _signed(self.state, at, n + 4, b"FHIB",
                      "fractal heap indirect block")
        verify(self.state, buf, at, "fractal heap indirect block")
        pos = 5 + 8 + self.off_size
        entries = [_le(buf, pos + 8 * i, 8)
                   for i in range(n_direct + n_indirect)]
        return entries[:n_direct], entries[n_direct:]

    def _managed(self, offset: int, length: int) -> bytes:
        if self.root_rows == 0:  # the root is one direct block
            block = self._direct(self.root, self.start_size)
            if offset + length > len(block):
                raise OSError(f"{self.state.path}: HDF5 fractal heap object "
                              "past its block")
            return block[offset:offset + length]
        at, nrows, x = self.root, self.root_rows, offset
        for _ in range(64):
            direct, indirect = self._indirect(at, nrows)
            row, start = 0, 0
            while row < nrows and x >= start + self.width * self._row_size(
                    row):
                start += self.width * self._row_size(row)
                row += 1
            if row == nrows:
                break
            size = self._row_size(row)
            col = (x - start) // size
            x -= start + col * size
            if row < self.max_direct_rows:
                child = direct[row * self.width + col]
                if child == UNDEF:
                    break
                block = self._direct(child, size)
                if x + length > len(block):
                    break
                return block[x:x + length]
            at = indirect[(row - self.max_direct_rows) * self.width + col]
            nrows = _log2(size) - _log2(self.start_size * self.width) + 1
            if at == UNDEF:
                break
        raise OSError(f"{self.state.path}: HDF5 fractal heap object at "
                      f"offset {offset} not found")

    def get(self, heap_id: bytes) -> bytes:
        b0 = heap_id[0]
        if b0 >> 6:
            raise NotImplementedError(f"HDF5 fractal heap ID version "
                                      f"{b0 >> 6}")
        kind = (b0 >> 4) & 3
        if kind == 0:
            offset = _le(heap_id, 1, self.off_size)
            length = _le(heap_id, 1 + self.off_size, self.len_size)
            return self._managed(offset, length)
        if kind == 2:  # tiny: the object is in the ID
            if self.id_len - 1 > 17:
                n = (((b0 & 0x0F) << 8) | heap_id[1]) + 1
                return bytes(heap_id[2:2 + n])
            return bytes(heap_id[1:1 + (b0 & 0x0F) + 1])
        if kind == 1:  # huge: its own block, found directly or by B-tree
            if self.id_len - 1 >= 16:
                at, n = _le(heap_id, 1, 8), _le(heap_id, 9, 8)
            else:
                if self._huge is None:
                    btype, recs = btree2_records(self.state, self.huge_btree)
                    if btype != 1:
                        raise NotImplementedError(
                            f"HDF5 huge heap objects in B-tree records of "
                            f"type {btype}")
                    self._huge = {_le(r, 16, 8): (_le(r, 0, 8),
                                                  _le(r, 8, 8))
                                  for r in recs}
                key = _le(heap_id, 1, min(self.id_len - 1, 8))
                if key not in self._huge:
                    raise OSError(f"{self.state.path}: HDF5 huge heap "
                                  f"object {key} not found")
                at, n = self._huge[key]
            return self.state.read(at, n)
        raise OSError(f"{self.state.path}: bad HDF5 fractal heap ID")


def dense_links(state, heap_addr: int, name_btree: int) -> List[bytes]:
    """The link messages of a group's dense link storage."""
    heap = FractalHeap(state, heap_addr)
    btype, recs = btree2_records(state, name_btree)
    if btype != 5:
        raise OSError(f"{state.path}: HDF5 link name index of record type "
                      f"{btype}")
    return [heap.get(r[4:4 + heap.id_len]) for r in recs]


def dense_attributes(state, heap_addr: int, name_btree: int,
                     tracked: bool) -> List[bytes]:
    """The attribute messages of an object's dense attribute storage, in
    the order h5py lists them: by creation order where the object tracks
    it, else by name."""
    heap = FractalHeap(state, heap_addr)
    btype, recs = btree2_records(state, name_btree)
    if btype != 8:
        raise OSError(f"{state.path}: HDF5 attribute name index of record "
                      f"type {btype}")
    out = []
    for r in recs:
        if r[8] & 0x02:
            raise NotImplementedError("HDF5 shared attribute message")
        data = heap.get(r[:8])
        out.append((_le(r, 9, 4) if tracked else _attr_name(data), data))
    return [data for _, data in sorted(out, key=lambda t: t[0])]


def _attr_name(msg: bytes) -> bytes:
    """The name of an attribute message (versions 1-3)."""
    size = _le(msg, 2, 2)
    at = 8 + (1 if msg[0] == 3 else 0)
    return bytes(msg[at:at + size]).rstrip(b"\0")


# ---------------------------------------------------------------------------
# chunk indexes of data layout version 4
# ---------------------------------------------------------------------------

#: chunk index types of the layout message, by number
INDEX_TYPES = {1: "single chunk", 2: "implicit", 3: "fixed array",
               4: "extensible array", 5: "v2 B-tree"}


def decode_layout4(d, data) -> None:
    """Fill ``d`` (a ``core.hdf5._DatasetObj``) from a chunked data layout
    message of version 4."""
    flags, ndims, enc = data[2], data[3], data[4]
    pos = 5
    dims = [_le(data, pos + i * enc, enc) for i in range(ndims)]
    pos += ndims * enc
    kind = data[pos]
    pos += 1
    info: Dict[str, int] = {}
    if kind == 1:
        if flags & 0x02:
            info["size"] = _le(data, pos, 8)
            info["mask"] = _le(data, pos + 8, 4)
            pos += 12
    elif kind == 3:
        pos += 1
    elif kind == 4:
        pos += 5
    elif kind == 5:
        pos += 6
    elif kind != 2:
        raise NotImplementedError(f"HDF5 chunk index type {kind}")
    d.layout, d.chunks = "chunked", tuple(dims[:-1])
    d.index_kind, d.index_info, d.layout_flags = kind, info, flags
    d.btree = _le(data, pos, 8)


def _entry(buf, pos: int, size: int, filtered: bool) -> Tuple[int, int, int]:
    """(address, stored size or -1, filter mask) of one index entry."""
    addr = _le(buf, pos, 8)
    if not filtered:
        return addr, -1, 0
    n = size - 12
    return addr, _le(buf, pos + 8, n), _le(buf, pos + 8 + n, 4)


def _fixed_array(state, addr: int) -> List[Tuple[int, int, int]]:
    head = _signed(state, addr, 28, b"FAHD", "fixed array header")
    verify(state, head, addr, "fixed array header")
    client, esize, page_bits = head[5], head[6], head[7]
    n, dblk = struct.unpack_from("<QQ", head, 8)
    filtered = client == 1
    page = 1 << page_bits
    prefix = 4 + 1 + 1 + 8
    if n <= page:
        buf = _signed(state, dblk, prefix + n * esize + 4, b"FADB",
                      "fixed array data block")
        verify(state, buf, dblk, "fixed array data block")
        return [_entry(buf, prefix + i * esize, esize, filtered)
                for i in range(n)]
    npages = -(-n // page)
    nmap = (npages + 7) // 8
    head_buf = _signed(state, dblk, prefix + nmap + 4, b"FADB",
                       "fixed array data block")
    verify(state, head_buf, dblk, "fixed array data block")
    bitmap = head_buf[prefix:prefix + nmap]
    out: List[Tuple[int, int, int]] = []
    at = dblk + prefix + nmap + 4
    for k in range(npages):
        count = min(page, n - k * page)
        if bitmap[k // 8] & (0x80 >> (k % 8)):
            buf = state.read(at, count * esize + 4)
            verify(state, buf, at, "fixed array data block page")
            out.extend(_entry(buf, i * esize, esize, filtered)
                       for i in range(count))
        else:
            out.extend([(UNDEF, -1, 0)] * count)
        at += page * esize + 4
    return out


def _extensible_array(state, addr: int) -> Dict[int, Tuple[int, int, int]]:
    head = _signed(state, addr, 72, b"EAHD", "extensible array header")
    verify(state, head, addr, "extensible array header")
    client, esize, max_bits, idx_elmts, min_elmts, min_ptrs, page_bits = \
        head[5:12]
    filtered = client == 1
    iblock = _le(head, 60, 8)
    arr_off = (max_bits + 7) // 8
    page = 1 << page_bits
    nsblks = 1 + max_bits - _log2(min_elmts)
    # (data blocks, elements per data block, first index) of each super
    # block, as H5EA__hdr_init lays them out
    sblk = []
    start = 0
    for u in range(nsblks):
        ndblks, nelmts = 1 << (u // 2), (1 << ((u + 1) // 2)) * min_elmts
        sblk.append((ndblks, nelmts, start))
        start += ndblks * nelmts
    in_iblock = 2 * _log2(min_ptrs)
    n_dblk = 2 * (min_ptrs - 1)
    n_sblk = nsblks - in_iblock
    out: Dict[int, Tuple[int, int, int]] = {}
    if iblock == UNDEF:
        return out
    n = 6 + 8 + idx_elmts * esize + 8 * (n_dblk + n_sblk)
    buf = _signed(state, iblock, n + 4, b"EAIB", "extensible array index "
                  "block")
    verify(state, buf, iblock, "extensible array index block")
    for i in range(idx_elmts):
        out[i] = _entry(buf, 14 + i * esize, esize, filtered)
    pos = 14 + idx_elmts * esize
    dblks = [_le(buf, pos + 8 * i, 8) for i in range(n_dblk)]
    sblks = [_le(buf, pos + 8 * (n_dblk + i), 8) for i in range(n_sblk)]

    def data_block(at: int, base: int, nelmts: int,
                   pages: Optional[bytes]) -> None:
        prefix = 6 + 8 + arr_off
        if pages is None:
            b = _signed(state, at, prefix + nelmts * esize + 4, b"EADB",
                        "extensible array data block")
            verify(state, b, at, "extensible array data block")
            for i in range(nelmts):
                out[base + i] = _entry(b, prefix + i * esize, esize,
                                       filtered)
            return
        b = _signed(state, at, prefix + 4, b"EADB",
                    "extensible array data block")
        verify(state, b, at, "extensible array data block")
        p_at = at + prefix + 4
        for k in range(nelmts // page):
            if pages[k // 8] & (0x80 >> (k % 8)):
                pb = state.read(p_at, page * esize + 4)
                verify(state, pb, p_at, "extensible array data block page")
                for i in range(page):
                    out[base + k * page + i] = _entry(pb, i * esize, esize,
                                                      filtered)
            p_at += page * esize + 4

    k = 0
    for u in range(in_iblock):
        ndblks, nelmts, first = sblk[u]
        for j in range(ndblks):
            if dblks[k] != UNDEF:
                data_block(dblks[k], idx_elmts + first + j * nelmts, nelmts,
                           None)
            k += 1
    for s, at in enumerate(sblks):
        if at == UNDEF:
            continue
        ndblks, nelmts, first = sblk[in_iblock + s]
        npages = nelmts // page if nelmts > page else 0
        nmap = (npages + 7) // 8 if npages else 0
        n = 6 + 8 + arr_off + ndblks * nmap + 8 * ndblks
        b = _signed(state, at, n + 4, b"EASB", "extensible array super "
                    "block")
        verify(state, b, at, "extensible array super block")
        maps = 6 + 8 + arr_off
        for j in range(ndblks):
            dat = _le(b, maps + ndblks * nmap + 8 * j, 8)
            if dat != UNDEF:
                data_block(dat, idx_elmts + first + j * nelmts, nelmts,
                           b[maps + j * nmap:maps + (j + 1) * nmap]
                           if npages else None)
    return out


def chunk_index(state, d) -> Dict[Tuple[int, ...], Tuple[int, int, int]]:
    """Chunk grid position -> (address, stored bytes, filter mask) of a
    dataset whose layout message is of version 4."""
    rank = len(d.shape)
    nbytes = int(np.prod(d.chunks)) * d.dt.size
    grid = [-(-s // c) for s, c in zip(d.shape, d.chunks)]
    maxgrid = [g if m == UNDEF else -(-m // c)
               for g, m, c in zip(grid, d.maxshape, d.chunks)]
    kind = d.index_kind
    index: Dict[Tuple[int, ...], Tuple[int, int, int]] = {}

    def put(pos, addr, size, mask):
        if addr == UNDEF or any(p >= g for p, g in zip(pos, grid)):
            return
        if d.layout_flags & 0x01 and any(
                (p + 1) * c > s for p, c, s in zip(pos, d.chunks, d.shape)):
            mask = 0xFFFFFFFF  # partial edge chunks stored unfiltered
        index[tuple(pos)] = (addr, nbytes if size < 0 else size, mask)

    if kind == 1:
        info = d.index_info
        put((0,) * rank, d.btree, info.get("size", -1), info.get("mask", 0))
    elif kind == 2:
        if d.btree != UNDEF:
            for i, pos in enumerate(product(*[range(g) for g in maxgrid])):
                put(pos, d.btree + i * nbytes, -1, 0)
    elif kind == 3:
        if d.btree != UNDEF:
            entries = _fixed_array(state, d.btree)
            for pos, (addr, size, mask) in zip(
                    product(*[range(g) for g in maxgrid]), entries):
                put(pos, addr, size, mask)
    elif kind == 4:
        # the one unlimited axis varies slowest (H5VM_swizzle_coords)
        unlim = next((i for i, m in enumerate(d.maxshape) if m == UNDEF),
                     0)
        order = [unlim] + [i for i in range(rank) if i != unlim]
        down = [int(np.prod([maxgrid[a] for a in order[i + 1:]]))
                for i in range(rank)]
        if d.btree != UNDEF:
            for idx, (addr, size, mask) in _extensible_array(
                    state, d.btree).items():
                pos = [0] * rank
                for a, dn in zip(order, down):
                    pos[a], idx = divmod(idx, dn)
                put(pos, addr, size, mask)
    elif kind == 5:
        if d.btree != UNDEF:
            btype, recs = btree2_records(state, d.btree)
            if btype not in (10, 11):
                raise OSError(f"{state.path}: HDF5 chunk index of B-tree "
                              f"record type {btype}")
            for r in recs:
                tail = len(r) - 8 * rank
                scaled = struct.unpack_from(f"<{rank}Q", r, tail)
                if btype == 10:
                    put(scaled, _le(r, 0, 8), -1, 0)
                else:
                    n = tail - 12
                    put(scaled, _le(r, 0, 8), _le(r, 8, n),
                        _le(r, 8 + n, 4))
    return index
