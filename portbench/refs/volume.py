"""Synthetic EM-like volumes made from a seed, on the device.

The frozen recipe of the repository's benchmark volume (Voronoi cells of
``CELL_DENSITY`` voxels; the boundary map ``exp(-0.5 ((d2 - d1) / 2)^2)``
of the distances ``d1 <= d2`` to the two nearest cell centres; uint8 as
``round(255 * b)``), rewritten in plain PyTorch so that it runs on the card
in about a second instead of a host k-d tree.

The two nearest centres are found exactly: the volume is cut into tiles,
and a tile's candidates are the centres whose distance to the tile's box is
at most an upper bound of the second-nearest distance of any voxel in the
tile (the farther of the two centres nearest to the tile's middle, plus the
tile's half diagonal).  The same seed gives the same volume on one device
type; nothing here reads the program.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

#: voxels per Voronoi cell (the repository's benchmark density)
CELL_DENSITY = 70000
#: tile edge lengths (z, y, x) of the exact two-nearest search
TILE = (25, 128, 128)


def cell_centres(shape: Sequence[int], seed: int,
                 device) -> torch.Tensor:
    """(n_cells, 3) float32 centres, uniform in the volume, from ``seed``."""
    n_cells = max(int(math.prod(shape) / CELL_DENSITY), 8)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand((n_cells, 3), generator=gen, device=device,
                   dtype=torch.float32)
    return u * torch.tensor([float(s) for s in shape], device=device)


def _two_nearest(q: torch.Tensor, pts: torch.Tensor):
    """Squared distances to and index of the nearest, and squared distance
    to the second nearest, of each query row among ``pts``."""
    d2 = ((q[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    if pts.shape[0] == 1:
        best = d2[:, 0]
        return best, torch.zeros_like(best, dtype=torch.long), \
            torch.full_like(best, float("inf"))
    vals, idx = torch.topk(d2, 2, dim=1, largest=False, sorted=True)
    return vals[:, 0], idx[:, 0], vals[:, 1]


def synthetic_volume(shape: Sequence[int], seed: int, device="cuda",
                     want_labels: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels int32 or None, boundaries uint8) of ``shape`` on ``device``."""
    shape = tuple(int(s) for s in shape)
    pts = cell_centres(shape, seed, device)
    bnd = torch.empty(shape, dtype=torch.uint8, device=device)
    lab = torch.empty(shape, dtype=torch.int32, device=device) \
        if want_labels else None
    for z0 in range(0, shape[0], TILE[0]):
        for y0 in range(0, shape[1], TILE[1]):
            for x0 in range(0, shape[2], TILE[2]):
                lo = (z0, y0, x0)
                hi = tuple(min(o + t, s) for o, t, s in zip(lo, TILE, shape))
                _fill_tile(pts, lo, hi, bnd, lab)
    return lab, bnd


def _fill_tile(pts, lo, hi, bnd, lab) -> None:
    dev = pts.device
    lo_t = torch.tensor([float(v) for v in lo], device=dev)
    hi_t = torch.tensor([float(v - 1) for v in hi], device=dev)
    mid = (lo_t + hi_t) / 2
    half_diag = float(torch.linalg.vector_norm(hi_t - lo_t)) / 2
    dm = torch.linalg.vector_norm(pts - mid, dim=1)
    k = min(2, pts.shape[0])
    bound = float(torch.topk(dm, k, largest=False).values[-1]) + half_diag
    # distance of each centre to the tile's box
    gap = torch.clamp(torch.maximum(lo_t - pts, pts - hi_t), min=0.0)
    cand = pts[torch.linalg.vector_norm(gap, dim=1) <= bound + 1e-3]
    axes = [torch.arange(a, b, device=dev, dtype=torch.float32)
            for a, b in zip(lo, hi)]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    q = torch.stack([zz.reshape(-1), yy.reshape(-1), xx.reshape(-1)], dim=1)
    d1, i1, d2 = _two_nearest(q, cand)
    diff = torch.sqrt(d2) - torch.sqrt(d1)
    b = torch.exp(-0.5 * (diff / 2.0) ** 2)
    sl = tuple(slice(a, b_) for a, b_ in zip(lo, hi))
    tshape = tuple(b_ - a for a, b_ in zip(lo, hi))
    bnd[sl] = torch.round(b * 255.0).to(torch.uint8).reshape(tshape)
    if lab is not None:
        # the global index of the nearest centre, + 1
        gidx = torch.nonzero(
            torch.linalg.vector_norm(gap, dim=1) <= bound + 1e-3)[:, 0]
        lab[sl] = (gidx[i1] + 1).to(torch.int32).reshape(tshape)
