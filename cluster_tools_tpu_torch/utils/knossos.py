"""Read-only Knossos pyramid-format adapter.

Port of cluster_tools_tpu/utils/knossos.py, after the reference's
``utils/knossos_wrapper.py``
(KnossosDataset/KnossosFile :1-161): a Knossos dataset is a directory tree
``x%04i/y%04i/z%04i/<prefix>_x..._y..._z....<ext>`` of 128^3 uint8 cubes
(image-encoded in the reference via imageio; raw ``.raw`` cubes are also
supported here; image cubes import imageio where they are read, so a host
without it reads ``.raw`` cubes).  The adapter exposes the
dataset-like interface (shape/chunks/dtype/__getitem__) so tasks can read a
Knossos volume exactly like an N5 dataset."""

from __future__ import annotations

import os
from itertools import product
from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.volume_views import normalize_index


class KnossosDataset:
    """Read-only view of one magnification level."""

    block_size = 128

    def __init__(self, path: str, file_prefix: Optional[str] = None,
                 ext: Optional[str] = None):
        self.path = path
        if file_prefix is None or ext is None:
            file_prefix, ext = self._discover_naming(path, file_prefix, ext)
        self.file_prefix = file_prefix
        self.ext = ext
        self._shape, self._grid = self._shape_and_grid()
        self.n_threads = 1

    @staticmethod
    def _discover_naming(path, file_prefix, ext):
        """Infer '<prefix>_x0000_y0000_z0000.<ext>' naming from the first
        cube on disk (real Knossos datasets carry an experiment prefix)."""
        probe = os.path.join(path, "x0000", "y0000", "z0000")
        if os.path.isdir(probe):
            for name in sorted(os.listdir(probe)):
                stem, _, found_ext = name.rpartition(".")
                if "x0000" not in stem:
                    continue
                prefix = stem.split("_x0000")[0]
                if prefix == stem:  # no '_x0000' → unprefixed naming
                    prefix = ""
                return (prefix if file_prefix is None else file_prefix,
                        found_ext if ext is None else ext)
        raise FileNotFoundError(
            f"no Knossos cubes found under {probe}; cannot infer the "
            "file naming — pass file_prefix/ext explicitly")

    @staticmethod
    def _chunks_dim(root: str) -> int:
        return len([f for f in os.listdir(root)
                    if os.path.isdir(os.path.join(root, f))])

    def _shape_and_grid(self):
        cx = self._chunks_dim(self.path)
        cy = self._chunks_dim(os.path.join(self.path, "x0000"))
        cz = self._chunks_dim(os.path.join(self.path, "x0000", "y0000"))
        grid = (cz, cy, cx)
        return tuple(s * self.block_size for s in grid), grid

    @property
    def dtype(self):
        return np.dtype("uint8")

    @property
    def ndim(self) -> int:
        return 3

    @property
    def chunks(self) -> Tuple[int, int, int]:
        return (self.block_size,) * 3

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    def _block_path(self, grid_id: Sequence[int]) -> str:
        # knossos folders are x/y/z-ordered; our grid ids are zyx
        parts = [f"{dim}{gid:04d}"
                 for dim, gid in zip(("x", "y", "z"), grid_id[::-1])]
        fname = f"{self.file_prefix}_{'_'.join(parts)}.{self.ext}" \
            if self.file_prefix else f"{'_'.join(parts)}.{self.ext}"
        return os.path.join(self.path, *parts, fname)

    def load_block(self, grid_id: Sequence[int]) -> np.ndarray:
        path = self._block_path(grid_id)
        if not os.path.exists(path):
            return np.zeros(self.chunks, "uint8")
        if self.ext == "raw":
            data = np.fromfile(path, dtype="uint8")
        else:  # image-encoded cubes (png/jpg) via imageio when available
            import imageio.v2 as imageio

            data = np.asarray(imageio.imread(path))
        return data.reshape(self.chunks)

    def __getitem__(self, index) -> np.ndarray:
        roi, to_squeeze = normalize_index(index, self.shape)
        out_shape = tuple(r.stop - r.start for r in roi)
        out = np.zeros(out_shape, "uint8")
        grid_lo = [r.start // self.block_size for r in roi]
        grid_hi = [(r.stop + self.block_size - 1) // self.block_size
                   for r in roi]
        for grid_id in product(*[range(lo, hi)
                                 for lo, hi in zip(grid_lo, grid_hi)]):
            block = self.load_block(grid_id)
            begin = [g * self.block_size for g in grid_id]
            src = tuple(
                slice(max(r.start - b, 0),
                      min(r.stop - b, self.block_size))
                for r, b in zip(roi, begin))
            dst = tuple(
                slice(max(b - r.start, 0),
                      max(b - r.start, 0) + (s.stop - s.start))
                for r, b, s in zip(roi, begin, src))
            out[dst] = block[src]
        if to_squeeze:
            out = out.squeeze(axis=tuple(to_squeeze))
        return out


class KnossosFile:
    """Container dispatch: ``f['mag1']`` -> KnossosDataset (reference:
    knossos_wrapper.py KnossosFile)."""

    def __init__(self, path: str, mode: str = "r"):
        if "r" not in mode:
            raise ValueError("knossos datasets are read-only")
        self.path = path

    def __getitem__(self, key: str) -> KnossosDataset:
        ds_path = os.path.join(self.path, key)
        if not os.path.isdir(ds_path):
            raise KeyError(key)
        return KnossosDataset(ds_path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
