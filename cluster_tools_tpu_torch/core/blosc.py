"""The Blosc1 frame: what zarr's and n5-blosc's ``blosc`` compressor writes.

A frame is a 16-byte header, then (unless the whole buffer was stored
plainly) a table of block starts and the blocks.  Each block is cut into
``typesize`` streams (one per byte of an element, after the byte shuffle)
unless the header's no-split flag is set or it is the ragged last block;
a stream whose compressed size equals its plain size is stored plainly.

Header, little-endian: ``version`` (2), ``versionlz``, ``flags`` (bit 0
byte shuffle, bit 1 the whole buffer stored plainly, bit 2 bitshuffle,
bit 4 blocks not split, bits 5-7 the codec: 0 BloscLZ, 1 LZ4 and LZ4HC,
2 Snappy, 3 zlib, 4 Zstd), ``typesize``, then uint32 ``nbytes`` (plain
size), ``blocksize`` and ``cbytes`` (the frame's size).

Decoded here: every codec of Blosc1 (BloscLZ, LZ4 and LZ4HC, Snappy, zlib
and Zstd: one Zstandard frame per stream) with no shuffle, the byte
shuffle or the bitshuffle, split or not.  The codec streams and both
unshuffles run in C++ (``native/src/codecs.cpp``); zlib is the standard
library's.  A codec id past 4 raises ``NotImplementedError`` naming it.
The bitshuffle follows c-blosc by the frame's format version: in version
2 frames (what c-blosc 1.x writes) a block whose element count is not a
multiple of 8 is stored as it lies; from version 3 on the elements past
the last full group of 8 are.  Encoded here: LZ4 with shuffle 0 or 1
(``clevel`` 0 stores the buffer plainly; any other level gives the same
LZ4 streams: the frame carries no level).  The bytes need not equal
c-blosc's; any Blosc1 decoder reads them.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

from ..native import codecs as _codecs
from .codecs import as_u8 as _as_u8

HEADER = 16
_SHUFFLE, _MEMCPYED, _BITSHUFFLE, _NO_SPLIT = 0x01, 0x02, 0x04, 0x10
_CODECS = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}
#: the encoder's block size (a multiple of the type size below it)
BLOCKSIZE = 1 << 18
#: buffers below this are stored plainly (c-blosc's MIN_BUFFERSIZE)
MIN_BUFFERSIZE = 128


def header(frame) -> Tuple[int, int, int, int, int, int]:
    """(flags, typesize, nbytes, blocksize, cbytes, codec id) of a frame."""
    src = _as_u8(frame)
    if len(src) < HEADER:
        raise ValueError(f"blosc frame of {len(src)} bytes has no header")
    flags, typesize = int(src[2]), int(src[3])
    nbytes, blocksize, cbytes = struct.unpack_from("<III", src, 4)
    return flags, typesize, nbytes, blocksize, cbytes, flags >> 5


def decompress(frame) -> np.ndarray:
    """The plain bytes (a uint8 array) of one Blosc1 frame."""
    src = _as_u8(frame)
    flags, typesize, nbytes, blocksize, cbytes, codec = header(src)
    if cbytes > len(src):
        raise ValueError(f"truncated blosc frame: {len(src)} of {cbytes} "
                         "bytes")
    out = np.empty(nbytes, np.uint8)
    if nbytes == 0:
        return out
    if blocksize == 0 or typesize == 0:
        raise ValueError("corrupt blosc header (block or type size 0)")
    if flags & _MEMCPYED:
        if HEADER + nbytes > len(src):
            raise ValueError("truncated blosc frame (stored plainly)")
        out[:] = src[HEADER:HEADER + nbytes]
        return out
    name = _CODECS.get(codec)
    if name is None:
        raise NotImplementedError(f"blosc compressor (codec {codec}) is not "
                                  "supported")
    lib = _codecs()
    decode = {"lz4": lib.lz4_decompress, "blosclz": lib.blosclz_decompress,
              "snappy": lib.snappy_decompress,
              "zstd": lib.zstd_decompress}.get(name)
    nblocks = -(-nbytes // blocksize)
    leftover = nbytes % blocksize
    if HEADER + 4 * nblocks > len(src):
        raise ValueError("truncated blosc frame (block starts)")
    starts = np.frombuffer(src, "<i4", nblocks, HEADER)
    shuffled = bool(flags & _SHUFFLE) and typesize > 1
    bitshuffled = not shuffled and bool(flags & _BITSHUFFLE)
    tmp = np.empty(blocksize, np.uint8) if shuffled or bitshuffled else None
    base = src.ctypes.data
    for b in range(nblocks):
        last = b == nblocks - 1 and leftover
        bsize = leftover if last else blocksize
        nsplits = 1 if (flags & _NO_SPLIT or last) else typesize
        if bsize % nsplits:
            raise ValueError("corrupt blosc frame (split of a block)")
        neblock = bsize // nsplits
        unshuffle = shuffled or (bitshuffled and bsize >= typesize)
        dest = tmp if unshuffle else out[b * blocksize:]
        pos = int(starts[b])
        for j in range(nsplits):
            if pos < HEADER or pos + 4 > len(src):
                raise ValueError("truncated blosc frame")
            n = struct.unpack_from("<i", src, pos)[0]
            pos += 4
            if n <= 0 or pos + n > len(src):
                raise ValueError(f"corrupt blosc stream of {n} bytes")
            at = j * neblock
            if n == neblock:
                dest[at:at + neblock] = src[pos:pos + n]
            elif decode is None:
                plain = zlib.decompress(src[pos:pos + n].tobytes())
                if len(plain) != neblock:
                    raise ValueError("corrupt blosc zlib stream")
                dest[at:at + neblock] = np.frombuffer(plain, np.uint8)
            else:
                got = decode(base + pos, n, dest.ctypes.data + at, neblock)
                if got == -2 and name == "zstd":
                    raise NotImplementedError(
                        "blosc zstd stream with a dictionary ID "
                        "(dictionaries are not supported)")
                if got != neblock:
                    raise ValueError(f"corrupt blosc {name} stream")
            pos += n
        if shuffled:
            lib.byte_unshuffle(tmp.ctypes.data, bsize, typesize,
                               out.ctypes.data + b * blocksize)
        elif unshuffle:
            lib.bitunshuffle(tmp.ctypes.data, bsize, typesize, int(src[0]),
                             out.ctypes.data + b * blocksize)
    return out


def compress(data, typesize: int, clevel: int = 5, shuffle: int = 1,
             cname: str = "lz4") -> bytes:
    """A Blosc1 frame of ``data`` (bytes or an array) in LZ4 streams."""
    if cname != "lz4":
        raise NotImplementedError(f"blosc compressor {cname!r} is not "
                                  "supported for writing (lz4 is)")
    if shuffle not in (0, 1):
        raise NotImplementedError(f"blosc shuffle {shuffle} is not "
                                  "supported (bitshuffle is 2)")
    src = _as_u8(data)
    nbytes = len(src)
    typesize = typesize if 0 < typesize <= 255 else 1
    flags = (1 << 5) | _NO_SPLIT | (_SHUFFLE if shuffle else 0)
    blocksize = min(nbytes, max(typesize, BLOCKSIZE // typesize * typesize))

    def frame(flags_, body: np.ndarray) -> bytes:
        head = struct.pack("<BBBBIII", 2, 1, flags_, typesize, nbytes,
                           blocksize, HEADER + len(body))
        return head + body.tobytes()

    if clevel == 0 or nbytes < MIN_BUFFERSIZE:
        return frame(flags | _MEMCPYED, src)
    lib = _codecs()
    nblocks = -(-nbytes // blocksize)
    cap = 4 * nblocks + nblocks * (4 + lib.lz4_bound(blocksize))
    body = np.empty(cap, np.uint8)
    starts = body[:4 * nblocks].view("<i4")
    tmp = np.empty(blocksize, np.uint8) if shuffle and typesize > 1 else None
    pos = 4 * nblocks
    for b in range(nblocks):
        lo = b * blocksize
        bsize = min(blocksize, nbytes - lo)
        block = src.ctypes.data + lo
        if tmp is not None:
            lib.byte_shuffle(block, bsize, typesize, tmp.ctypes.data)
            block = tmp.ctypes.data
        starts[b] = HEADER + pos
        n = lib.lz4_compress(block, bsize, body.ctypes.data + pos + 4,
                             cap - pos - 4)
        if n <= 0 or n >= bsize:  # incompressible: the stream is stored
            n = bsize
            np.copyto(body[pos + 4:pos + 4 + n],
                      tmp[:n] if tmp is not None else src[lo:lo + n])
        body[pos:pos + 4].view("<i4")[0] = n
        pos += 4 + n
    if pos >= nbytes:
        return frame(flags | _MEMCPYED, src)
    return frame(flags, body[:pos])
