"""The single-stream codecs of the chunk formats the storage layer reads.

Thin wrappers over the C++ decoders of ``native/src/codecs.cpp`` (built
by g++ at first use), taking bytes or a uint8 array and the plain size
the container's metadata states, and returning a uint8 array of exactly
that size:

* Zstandard frames (RFC 8878), as zarr's and N5's ``zstd`` compressors
  and blosc's codec 4 write them: several frames in a row and skippable
  frames read; the content checksum, where a frame has one, is verified;
  a frame that names a dictionary raises ``NotImplementedError``
  (tensorstore and numcodecs write none).  :func:`zstd_compress` writes
  a frame that stores its bytes (RLE blocks for runs of one byte, raw
  blocks otherwise) with the content size and checksum: what an orbax
  checkpoint's zarr chunks and OCDBT nodes need to be read by any
  Zstandard decoder (``core/ocdbt.py``, ``models/orbax.py``);
* Snappy's raw format (blosc's codec 2);
* liblzf's format (h5py's LZF filter, HDF5 filter 32000);
* Jenkins' lookup3, the checksum of HDF5's metadata, and CRC-32C, the
  checksum of tensorstore's OCDBT files (``core/ocdbt.py``).

(c-blosc's bitunshuffle runs in ``core/blosc.py`` on each block.)

Any malformed input raises ``ValueError``; the C++ never reads or writes
out of bounds.
"""

from __future__ import annotations

import numpy as np

from ..native import codecs as _codecs

_ZSTD_ERRORS = {-1: "corrupt", -3: "content checksum mismatch",
                -4: "more content than the chunk holds"}


def as_u8(data) -> np.ndarray:
    """``data`` (bytes-like or an array) as a flat uint8 array."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(data, np.uint8)


def _sized(n: int, nbytes: int, what: str) -> None:
    if n != nbytes:
        raise ValueError(f"{what} holds {n} bytes, expected {nbytes}")


def _zstd_into(src: np.ndarray, cap: int):
    """(output buffer, the C++ decoder's return code)."""
    out = np.empty(cap, np.uint8)
    return out, int(_codecs().zstd_decompress(src.ctypes.data, len(src),
                                              out.ctypes.data, cap))


def _zstd_check(n: int) -> None:
    if n == -2:
        raise NotImplementedError("zstd frame with a dictionary ID "
                                  "(dictionaries are not supported)")
    if n < 0:
        raise ValueError(f"zstd frame: {_ZSTD_ERRORS[n]}")


def zstd_compress(data) -> bytes:
    """One Zstandard frame of ``data``: its bytes stored in blocks of at
    most 128 KiB (a block of one repeated byte as an RLE block), the
    content size in the header, the XXH64 checksum at the end."""
    src = as_u8(data)
    lib = _codecs()
    out = np.empty(int(lib.zstd_bound(len(src))), np.uint8)
    n = int(lib.zstd_compress(src.ctypes.data, len(src), out.ctypes.data,
                              len(out)))
    return out[:n].tobytes()


def zstd_decompress(data, nbytes: int) -> np.ndarray:
    """The ``nbytes`` plain bytes of the Zstandard frame(s) ``data``."""
    out, n = _zstd_into(as_u8(data), nbytes)
    _zstd_check(n)
    _sized(n, nbytes, "zstd frame")
    return out


def zstd_decompress_unsized(data, limit: int) -> np.ndarray:
    """The plain bytes of the Zstandard frame(s) ``data`` whose size the
    frame header need not state (riegeli's writer, which tensorstore's
    OCDBT files use, leaves it out), decoded into a buffer of ``limit``
    bytes (committed only as far as it is written); more raises
    ``ValueError``."""
    out, n = _zstd_into(as_u8(data), int(limit))
    if n == -4:
        raise ValueError(f"zstd frame holds more than {limit} bytes")
    _zstd_check(n)
    return out[:n]


def snappy_decompress(data, nbytes: int) -> np.ndarray:
    """The ``nbytes`` plain bytes of the raw Snappy stream ``data``."""
    src = as_u8(data)
    out = np.empty(nbytes, np.uint8)
    n = _codecs().snappy_decompress(src.ctypes.data, len(src),
                                    out.ctypes.data, nbytes)
    if n < 0:
        raise ValueError("corrupt snappy stream")
    _sized(n, nbytes, "snappy stream")
    return out


def lzf_decompress(data, nbytes: int) -> np.ndarray:
    """The plain bytes of the LZF stream ``data``.  Its plain size is not
    stored: the output starts at ``nbytes`` and doubles while the stream
    does not fit, as h5py's filter does."""
    src = as_u8(data)
    cap = max(int(nbytes), 1)
    for _ in range(32):
        out = np.empty(cap, np.uint8)
        n = _codecs().lzf_decompress(src.ctypes.data, len(src),
                                     out.ctypes.data, cap)
        if n != -2:
            break
        cap *= 2
    if n < 0:
        raise ValueError("corrupt LZF stream")
    return out[:n]


def lookup3(data, initval: int = 0) -> int:
    """Jenkins' lookup3 ``hashlittle`` of ``data`` (HDF5's
    ``H5_checksum_metadata``)."""
    src = as_u8(data)
    return int(_codecs().lookup3(src.ctypes.data, len(src), initval))


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``: the checksum that closes each
    manifest and node of tensorstore's OCDBT format."""
    src = as_u8(data)
    return int(_codecs().crc32c(src.ctypes.data, len(src), 0))
