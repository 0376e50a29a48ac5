"""Lazy volume views: interpolated (multi-resolution) and affine-transformed.

A copy of cluster_tools_tpu/core/volume_views.py (numpy and scipy only),
the re-specification of the reference's volume classes
(utils/volume_classes.py:31-232): views expose ``__getitem__`` over the
*virtual* full-resolution/transformed shape so tasks can treat a low-res mask
as if it were full-res (utils/volume_utils.py:208-218 ``load_mask``).
Interpolation runs on the host via scipy (mask resampling is control-plane,
not a device hot path).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from scipy.ndimage import affine_transform, zoom


def normalize_index(index, shape) -> Tuple[Tuple[slice, ...], Tuple[int, ...]]:
    """Normalize an index to a tuple of non-negative slices over ``shape``
    (reference: utils/volume_classes.py:12)."""
    if not isinstance(index, tuple):
        index = (index,)
    squeeze_axes = []
    slices = []
    for d, ind in enumerate(index):
        if isinstance(ind, (int, np.integer)):
            i = int(ind)
            if i < 0:
                i += shape[d]
            slices.append(slice(i, i + 1))
            squeeze_axes.append(d)
        elif isinstance(ind, slice):
            start = 0 if ind.start is None else int(ind.start)
            stop = shape[d] if ind.stop is None else int(ind.stop)
            if start < 0:
                start += shape[d]
            if stop < 0:
                stop += shape[d]
            slices.append(slice(start, stop))
        else:
            raise TypeError(f"unsupported index {ind!r}")
    for d in range(len(slices), len(shape)):
        slices.append(slice(0, shape[d]))
    return tuple(slices), tuple(squeeze_axes)


class InterpolatedVolume:
    """Present a low-resolution volume at a virtual full-resolution ``shape``
    (reference: utils/volume_classes.py:155-232), with empty/uniform-block
    shortcuts (:223-228)."""

    def __init__(self, volume, shape: Sequence[int], spline_order: int = 0):
        self.volume = volume
        self.shape = tuple(int(s) for s in shape)
        self.ndim = len(self.shape)
        vshape = volume.shape
        if len(vshape) != self.ndim:
            raise ValueError("dim mismatch")
        self.scale = tuple(s / v for s, v in zip(self.shape, vshape))
        self.spline_order = spline_order
        self.dtype = np.dtype(getattr(volume, "dtype", np.float32))

    def __getitem__(self, index) -> np.ndarray:
        slices, squeeze_axes = normalize_index(index, self.shape)
        out_shape = tuple(s.stop - s.start for s in slices)
        # matching low-res bounding box (expanded by 1 voxel for interpolation)
        lo = [max(int(np.floor(s.start / sc)), 0) for s, sc in zip(slices, self.scale)]
        hi = [
            min(int(np.ceil(s.stop / sc)) + 1, vs)
            for s, sc, vs in zip(slices, self.scale, self.volume.shape)
        ]
        sub = np.asarray(self.volume[tuple(slice(l, h) for l, h in zip(lo, hi))])
        if sub.size == 0:
            return np.zeros(out_shape, dtype=self.dtype)
        # uniform-block shortcut
        first = sub.flat[0]
        if (sub == first).all():
            return np.full(out_shape, first, dtype=self.dtype)
        zoomed = zoom(sub, self.scale, order=self.spline_order,
                      mode="nearest", grid_mode=True)
        # crop the requested window out of the zoomed expanded box
        off = [s.start - int(l * sc) for s, l, sc in zip(slices, lo, self.scale)]
        bb = tuple(
            slice(max(o, 0), max(o, 0) + osz)
            for o, osz in zip(off, out_shape)
        )
        out = zoomed[bb]
        # pad if rounding left us short at the upper border
        if out.shape != out_shape:
            pad = [(0, osz - cs) for osz, cs in zip(out_shape, out.shape)]
            out = np.pad(out, pad, mode="edge")
        if squeeze_axes:
            out = np.squeeze(out, axis=tuple(squeeze_axes))
        return out.astype(self.dtype, copy=False)


class TransformedVolume:
    """Affine-resampled view of a volume (reference:
    utils/volume_classes.py:31-152): ``view[bb]`` returns the transformed
    data for that output bounding box."""

    def __init__(self, volume, matrix: np.ndarray, shape: Sequence[int] = None,
                 order: int = 0, fill_value: float = 0):
        self.volume = volume
        matrix = np.asarray(matrix, dtype="float64")
        ndim = volume.ndim if hasattr(volume, "ndim") else len(volume.shape)
        if matrix.shape != (ndim + 1, ndim + 1):
            raise ValueError(
                f"expected homogeneous {(ndim + 1, ndim + 1)} matrix, got {matrix.shape}")
        self.matrix = matrix
        self.shape = tuple(int(s) for s in (shape or volume.shape))
        self.ndim = len(self.shape)
        self.order = order
        self.fill_value = fill_value
        self.dtype = np.dtype(getattr(volume, "dtype", np.float32))

    def __getitem__(self, index) -> np.ndarray:
        slices, squeeze_axes = normalize_index(index, self.shape)
        out_shape = tuple(s.stop - s.start for s in slices)
        offset_vec = np.array([s.start for s in slices], dtype="float64")

        # output voxel o (+ window offset) -> input voxel: x = A^-1 @ o
        inv = np.linalg.inv(self.matrix)
        lin, trans = inv[:-1, :-1], inv[:-1, -1]
        trans = trans + lin @ offset_vec

        # conservative input bounding box for the window
        corners = np.array(np.meshgrid(
            *[[0, s] for s in out_shape], indexing="ij")).reshape(self.ndim, -1).T
        src = corners @ lin.T + trans
        lo = np.maximum(np.floor(src.min(axis=0)).astype(int) - 1, 0)
        hi = np.minimum(np.ceil(src.max(axis=0)).astype(int) + 2,
                        np.asarray(self.volume.shape))
        if (hi <= lo).any():
            out = np.full(out_shape, self.fill_value, dtype=self.dtype)
        else:
            sub = np.asarray(self.volume[tuple(slice(l, h) for l, h in zip(lo, hi))])
            out = affine_transform(
                sub, lin, offset=trans - lo,
                output_shape=out_shape, order=self.order,
                mode="constant", cval=self.fill_value,
            ).astype(self.dtype, copy=False)
        if squeeze_axes:
            out = np.squeeze(out, axis=tuple(squeeze_axes))
        return out


def load_mask(mask_path: str, mask_key: str, shape: Sequence[int]):
    """Open a (possibly low-res) mask as a full-res interpolated view
    (reference: utils/volume_utils.py:208-218)."""
    from .storage import file_reader

    f = file_reader(mask_path, "r")
    ds = f[mask_key]
    if tuple(ds.shape) == tuple(shape):
        return ds
    return InterpolatedVolume(ds, shape, spline_order=0)
