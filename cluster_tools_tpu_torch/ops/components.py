"""Connected components via label propagation on the card.

Port of cluster_tools_tpu/ops/components.py, ``method="propagation"`` (the
method the fused chain uses for seed clusters): every foreground voxel
starts as its own label (its linear index) and repeatedly takes the
minimum over its neighborhood until nothing changes.  Labels are returned
as root-voxel linear indices + 1 (0 = background), identical to the JAX
package's.

The JAX package checks convergence after every 4-sweep body inside a
``while_loop``; here each check is a host sync, so the loop runs several
bodies between checks.  A converged state stays converged, so the labels
are identical; the iteration bound counts bodies exactly as there.
"""

from __future__ import annotations

from itertools import product
from typing import Sequence, Tuple

import numpy as np
import torch

#: 4-sweep bodies run between two convergence checks (host syncs)
CHECK_EVERY = 8


def _neighbor_offsets(ndim: int,
                      connectivity: int) -> Tuple[Tuple[int, ...], ...]:
    """Neighbor offsets with L1 norm <= connectivity (scipy/skimage convention:
    connectivity=1 -> faces, ndim -> full including corners)."""
    offs = []
    for off in product((-1, 0, 1), repeat=ndim):
        d = sum(abs(o) for o in off)
        if 0 < d <= connectivity:
            offs.append(off)
    return tuple(offs)


def _shifted(arr: torch.Tensor, offset: Sequence[int], fill) -> torch.Tensor:
    """Value of the neighbor at position ``i + offset`` for every voxel i,
    with out-of-volume neighbors reading ``fill``."""
    out = torch.full_like(arr, fill)
    src, dst = [], []
    for o, s in zip(offset, arr.shape):
        if o >= 0:
            src.append(slice(o, s))
            dst.append(slice(0, max(s - o, 0)))
        else:
            src.append(slice(0, s + o))
            dst.append(slice(-o, s))
    out[tuple(dst)] = arr[tuple(src)]
    return out


def _box_min(grid: torch.Tensor, fill) -> torch.Tensor:
    """Minimum over the full 3^ndim neighborhood (center included), with
    out-of-volume neighbors reading ``fill`` — separable, one pass per
    axis, exactly the minimum over all ``ndim``-connectivity offsets."""
    m = grid
    for ax in range(grid.dim()):
        off = [0] * grid.dim()
        off[ax] = 1
        lo = _shifted(m, off, fill)
        off[ax] = -1
        hi = _shifted(m, off, fill)
        m = torch.minimum(m, torch.minimum(lo, hi))
    return m


def connected_components(mask: torch.Tensor, connectivity: int = 1,
                         max_iter: int = 0,
                         method: str = "propagation") -> torch.Tensor:
    """Label connected components of a boolean mask.

    Returns an int32 tensor: 0 for background, ``root_linear_index + 1``
    for foreground (the minimum linear index of the component).
    ``connectivity`` follows the scipy/skimage convention (1 = faces,
    ndim = full).  ``max_iter=0`` bounds the loop at ``n//4 + 2`` bodies
    (the loop exits early on convergence)."""
    if method != "propagation":
        raise NotImplementedError(
            f"method {method!r}: only 'propagation' is ported")
    shape = mask.shape
    n = int(np.prod(shape))
    sentinel = n
    mask = mask.to(torch.bool)
    full = connectivity >= mask.dim()
    offsets = _neighbor_offsets(mask.dim(), connectivity)
    if max_iter == 0:
        max_iter = max(n // 4 + 2, 16)
    fg = mask.reshape(-1)
    p = torch.arange(n, dtype=torch.int32, device=mask.device)

    def neighbor_min(p):
        grid = torch.where(mask, p.reshape(shape), sentinel)
        if full:
            m = _box_min(grid, sentinel)
        else:
            m = grid
            for off in offsets:
                m = torch.minimum(m, _shifted(grid, off, sentinel))
        return torch.where(fg, m.reshape(-1), p)

    it = 0
    while it < max_iter:
        for _ in range(min(CHECK_EVERY, max_iter - it)):
            prev = p
            for _ in range(4):
                p = neighbor_min(p)
            it += 1
        if not bool((p != prev).any()):
            break
    return torch.where(fg, p + 1, 0).reshape(shape).to(torch.int32)
