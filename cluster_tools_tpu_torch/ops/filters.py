"""Separable image filters on the card.

Port of cluster_tools_tpu/ops/filters.py (the reference's filter surface:
fastfilters/vigra ``gaussianSmoothing`` and ``localMaxima3D``).  Only the
filters the fused chain runs are ported: :func:`gaussian` and
:func:`local_maxima`.

The Gaussian is written as shifted multiply-adds over a symmetric-padded
copy (numpy ``"symmetric"`` mode: the edge sample is repeated), one axis at
a time.  A float32 convolution through cuDNN would run in TF32 by default
and move the height map by about 1e-3; shifted adds stay in float32 on
every device.  Taps are applied flipped (a true convolution), as the JAX
package does.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch


def _gaussian_kernel(sigma: float, order: int = 0,
                     truncate: float = 4.0) -> np.ndarray:
    """1-d Gaussian taps, matching scipy's normalization (float32)."""
    if order != 0:
        raise ValueError("only order-0 Gaussian taps are ported")
    radius = max(int(truncate * sigma + 0.5), 1)
    x = np.arange(-radius, radius + 1, dtype="float64")
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    return g.astype("float32")


def _symmetric_index(n: int, r: int, device) -> torch.Tensor:
    """Indices of numpy's ``"symmetric"`` pad of an axis of length n by r."""
    return torch.from_numpy(np.pad(np.arange(n), r, mode="symmetric")).to(
        device)


def _conv1d_along(x: torch.Tensor, taps: np.ndarray,
                  axis: int) -> torch.Tensor:
    """True convolution along one axis with symmetric padding."""
    k = taps.shape[0]
    r = (k - 1) // 2
    n = x.shape[axis]
    xp = torch.index_select(x, axis, _symmetric_index(n, r, x.device))
    flipped = taps[::-1]
    out = None
    for j in range(k):
        term = xp.narrow(axis, j, n) * float(flipped[j])
        out = term if out is None else out + term
    return out


def gaussian(x: torch.Tensor, sigma: Union[float, Tuple[float, ...]],
             truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian smoothing (reference: vigra gaussianSmoothing)."""
    sigmas = (sigma,) * x.dim() if np.isscalar(sigma) else tuple(sigma)
    out = x.to(torch.float32)
    for ax, s in enumerate(sigmas):
        if s > 0:
            out = _conv1d_along(out, _gaussian_kernel(s, 0, truncate), ax)
    return out


def rank_pool_max(x: torch.Tensor,
                  size: Union[int, Sequence[int]]) -> torch.Tensor:
    """Same-shape max filter over a box window, out-of-volume samples
    reading -inf (the JAX package's ``rank_pool(mode="max")``).  The box
    maximum is separable, so one pass per axis is exact."""
    sizes = (size,) * x.dim() if np.isscalar(size) else tuple(size)
    out = x.to(torch.float32)
    for ax, w in enumerate(int(s) for s in sizes):
        if w <= 1:
            continue
        lo, hi = (w - 1) // 2, w - 1 - (w - 1) // 2
        n = out.shape[ax]
        pad_shape = list(out.shape)
        pad_lo = out.new_full(pad_shape[:ax] + [lo] + pad_shape[ax + 1:],
                              -float("inf"))
        pad_hi = out.new_full(pad_shape[:ax] + [hi] + pad_shape[ax + 1:],
                              -float("inf"))
        xp = torch.cat([pad_lo, out, pad_hi], dim=ax)
        m = xp.narrow(ax, 0, n)
        for j in range(1, w):
            m = torch.maximum(m, xp.narrow(ax, j, n))
        out = m
    return out


def local_maxima(x: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Boolean mask of local maxima (plateaus included) within a cube window
    (reference: vigra localMaxima3D, watershed/watershed.py:187)."""
    return x >= rank_pool_max(x, 2 * radius + 1)
