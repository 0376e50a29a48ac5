"""Connected components on the card: union-find hooking with pointer
jumping, and label propagation.

Port of cluster_tools_tpu/ops/components.py.  Every foreground voxel
starts as its own parent (its linear index).  ``method="hooking"`` (the
default, as in the JAX package) takes the minimum parent over the
neighborhood, scatter-min "hooks" it onto the current root and
compresses paths by two pointer jumps; ``method="propagation"`` (the
method the multicut chains use for seed clusters) repeatedly takes the
neighborhood minimum.  Both converge to the component's minimum linear
index; labels are returned as that index + 1 (0 = background), identical
to the JAX package's.

The JAX package checks convergence after every body inside a
``while_loop``; here each check is a host sync, so the loop runs several
bodies between checks.  A converged state stays converged, so the labels
are identical.  Propagation's iteration bound counts bodies exactly as
there; hooking has no bound, as there.

``connected_components_batched`` labels a leading batch axis of equally
shaped blocks, each with its own linear indices (the JAX package's
``vmap``).
"""

from __future__ import annotations

from itertools import product
from typing import Sequence, Tuple

import numpy as np
import torch

#: propagation: 4-sweep bodies run between two convergence checks
CHECK_EVERY = 8
#: hooking: bodies run between two convergence checks
HOOK_CHECK_EVERY = 2


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
    """Minimum over the full 3^ndim spatial neighborhood (center
    included) of a batch ``(B, *spatial)``, with out-of-volume neighbors
    reading ``fill`` — separable, one pass per spatial axis, exactly the
    minimum over all ``ndim``-connectivity offsets."""
    m = grid
    for ax in range(1, grid.dim()):
        off = [0] * grid.dim()
        off[ax] = 1
        lo = _shifted(m, off, fill)
        off[ax] = -1
        hi = _shifted(m, off, fill)
        m = torch.minimum(m, torch.minimum(lo, hi))
    return m


def _label(masks: torch.Tensor, connectivity: int, max_iter: int,
           method: str) -> Tuple[torch.Tensor, int]:
    """Labels of a batch ``(B, *spatial)`` of boolean masks, each block
    with its own linear indices; returns ``(labels int32, bodies run)``."""
    if method not in ("hooking", "propagation"):
        raise ValueError(f"unknown method {method!r}; "
                         "choose 'hooking' or 'propagation'")
    shape = masks.shape
    nb, ndim = int(shape[0]), masks.dim() - 1
    n = int(np.prod(shape[1:]))
    sentinel = n
    masks = masks.to(torch.bool)
    full = connectivity >= ndim
    offsets = [(0,) + o for o in _neighbor_offsets(ndim, connectivity)]
    fg = masks.reshape(nb, n)
    p = torch.arange(n, dtype=torch.int32,
                     device=masks.device).repeat(nb, 1)

    def neighbor_min(p):
        grid = torch.where(masks, p.reshape(shape), sentinel)
        if full:
            m = _box_min(grid, sentinel)
        else:
            m = grid
            for off in offsets:
                m = torch.minimum(m, _shifted(grid, off, sentinel))
        return torch.where(fg, m.reshape(nb, n), p)

    bodies = 0
    if method == "propagation":
        if max_iter == 0:
            max_iter = max(n // 4 + 2, 16)
        while bodies < max_iter:
            for _ in range(min(CHECK_EVERY, max_iter - bodies)):
                prev = p
                for _ in range(4):
                    p = neighbor_min(p)
                bodies += 1
            if not bool((p != prev).any()):
                break
    else:
        # block b's parents index its own row of the flattened batch
        base = (torch.arange(nb, device=masks.device,
                             dtype=torch.int64) * n)[:, None]

        def body(p):
            m = neighbor_min(p)
            # hook the improved root onto the current root (p.at[p].min(m)),
            # then compress by two pointer jumps
            p2 = p.reshape(-1).clone()
            p2.scatter_reduce_(0, (p.long() + base).reshape(-1),
                               m.reshape(-1), reduce="amin",
                               include_self=True)
            p2 = p2.reshape(nb, n)
            p2 = torch.gather(p2, 1, p2.long())
            return torch.gather(p2, 1, p2.long())

        while True:
            for _ in range(HOOK_CHECK_EVERY):
                prev = p
                p = body(p)
                bodies += 1
            if not bool((p != prev).any()):
                break
    return torch.where(fg, p + 1, 0).reshape(shape).to(torch.int32), bodies


def connected_components(mask: torch.Tensor, connectivity: int = 1,
                         max_iter: int = 0, method: str = "hooking",
                         return_bodies: bool = False):
    """Label connected components of a boolean mask.

    Returns an int32 tensor: 0 for background, ``root_linear_index + 1``
    for foreground (the minimum linear index of the component).
    ``connectivity`` follows the scipy/skimage convention (1 = faces,
    ndim = full).  ``max_iter`` bounds propagation (0: ``n//4 + 2``
    bodies; the loop exits early on convergence); hooking runs until
    nothing changes.  ``return_bodies`` also returns the number of loop
    bodies run."""
    labels, bodies = _label(mask[None], connectivity, max_iter, method)
    return (labels[0], bodies) if return_bodies else labels[0]


def connected_components_batched(masks: torch.Tensor,
                                 connectivity: int = 1,
                                 method: str = "hooking") -> torch.Tensor:
    """CC over a batch of equally shaped blocks (leading batch axis, the
    JAX package's ``vmap``): neighbors on the spatial axes only, each
    block's linear indices starting at 0."""
    return _label(masks, connectivity, 0, method)[0]


def relabel_consecutive(
    labels: np.ndarray, start_label: int = 1, keep_zeros: bool = True
) -> Tuple[np.ndarray, int]:
    """Host-side consecutive relabeling (reference: vigra relabelConsecutive,
    used ubiquitously).  Returns (relabeled, max_id)."""
    labels = np.asarray(labels)
    uniques = np.unique(labels)
    if keep_zeros and uniques.size and uniques[0] == 0:
        nonzero = uniques[1:]
        new = np.searchsorted(nonzero, labels)
        out = np.where(labels == 0, 0, new + start_label).astype(np.uint64)
        max_id = start_label + nonzero.size - 1 if nonzero.size else 0
        return out, int(max_id)
    new = np.searchsorted(uniques, labels)
    out = (new + start_label).astype(np.uint64)
    return out, int(start_label + uniques.size - 1)


def threshold_volume(x: torch.Tensor, threshold: float,
                     mode: str = "greater") -> torch.Tensor:
    """Thresholding modes of the reference (block_components.py)."""
    if mode == "greater":
        return x > threshold
    if mode == "less":
        return x < threshold
    if mode == "equal":
        return x == threshold
    raise ValueError(f"unknown threshold mode {mode}")
