"""Separable image filters on the card.

Port of cluster_tools_tpu/ops/filters.py (the reference's filter surface:
fastfilters/vigra ``gaussianSmoothing``, ``gaussianGradientMagnitude``,
``laplacianOfGaussian`` and ``localMaxima3D``; the by-name dispatch
:func:`apply_filter` of utils/volume_utils.py:95).

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
    """1-d Gaussian (or derivative-of-Gaussian) taps, matching scipy's
    normalization (float32)."""
    radius = max(int(truncate * sigma + 0.5), 1)
    x = np.arange(-radius, radius + 1, dtype="float64")
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    if order == 0:
        k = g
    elif order == 1:
        k = -x / sigma ** 2 * g
    elif order == 2:
        k = (x ** 2 / sigma ** 4 - 1.0 / sigma ** 2) * g
    else:
        raise ValueError(f"derivative order {order} not supported")
    return k.astype("float32")


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


def gaussian_gradient_magnitude(x: torch.Tensor,
                                sigma: float) -> torch.Tensor:
    """|∇(G_sigma * x)| (reference: vigra gaussianGradientMagnitude): for
    each axis, the first-derivative taps along it and the smoothing taps
    along the others."""
    x = x.to(torch.float32)
    acc = torch.zeros_like(x)
    for ax in range(x.dim()):
        d = x
        for ax2 in range(x.dim()):
            d = _conv1d_along(d, _gaussian_kernel(sigma, 1 if ax2 == ax
                                                  else 0), ax2)
        acc = acc + d * d
    return torch.sqrt(acc)


def laplacian_of_gaussian(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """ΔG_sigma * x (reference: vigra laplacianOfGaussian): for each axis,
    the second-derivative taps along it and the smoothing taps along the
    others, summed."""
    x = x.to(torch.float32)
    acc = torch.zeros_like(x)
    for ax in range(x.dim()):
        d = x
        for ax2 in range(x.dim()):
            d = _conv1d_along(d, _gaussian_kernel(sigma, 2 if ax2 == ax
                                                  else 0), ax2)
        acc = acc + d
    return acc


def rank_pool(x: torch.Tensor, size: Union[int, Sequence[int]],
              mode: str = "max") -> torch.Tensor:
    """Same-shape max or min filter over a box window, out-of-volume
    samples reading -inf (max) or +inf (min) (the JAX package's
    ``rank_pool``; scipy maximum_filter / minimum_filter).  The box
    extremum is separable, so one pass per axis is exact."""
    if mode == "max":
        fill, op = -float("inf"), torch.maximum
    elif mode == "min":
        fill, op = float("inf"), torch.minimum
    else:
        raise ValueError(mode)
    sizes = (size,) * x.dim() if np.isscalar(size) else tuple(size)
    out = x.to(torch.float32)
    for ax, w in enumerate(int(s) for s in sizes):
        if w <= 1:
            continue
        lo, hi = (w - 1) // 2, w - 1 - (w - 1) // 2
        n = out.shape[ax]
        pad_shape = list(out.shape)
        pad_lo = out.new_full(pad_shape[:ax] + [lo] + pad_shape[ax + 1:],
                              fill)
        pad_hi = out.new_full(pad_shape[:ax] + [hi] + pad_shape[ax + 1:],
                              fill)
        xp = torch.cat([pad_lo, out, pad_hi], dim=ax)
        m = xp.narrow(ax, 0, n)
        for j in range(1, w):
            m = op(m, xp.narrow(ax, j, n))
        out = m
    return out


def local_maxima(x: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Boolean mask of local maxima (plateaus included) within a cube window
    (reference: vigra localMaxima3D, watershed/watershed.py:187)."""
    return x >= rank_pool(x, 2 * radius + 1, "max")


FILTERS = {
    "gaussianSmoothing": gaussian,
    "gaussianGradientMagnitude": gaussian_gradient_magnitude,
    "laplacianOfGaussian": laplacian_of_gaussian,
}


def apply_filter(x: torch.Tensor, filter_name: str, sigma) -> torch.Tensor:
    """By-name dispatch (reference: utils/volume_utils.py:95 apply_filter).
    A per-axis ``sigma`` stays per axis for the Gaussian and is averaged to
    one value for the derivative filters."""
    if filter_name not in FILTERS:
        raise ValueError(f"unknown filter {filter_name}; have "
                         f"{sorted(FILTERS)}")
    if filter_name != "gaussianSmoothing" and not np.isscalar(sigma):
        sigma = float(np.mean(sigma))
    if filter_name == "gaussianSmoothing" and not np.isscalar(sigma):
        sigma = tuple(float(s) for s in sigma)
    return FILTERS[filter_name](x, sigma)
