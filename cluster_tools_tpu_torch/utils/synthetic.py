"""Synthetic EM-like volumes with ground truth, made from a seed.

A copy of the benchmark generator of the JAX package (``bench.py``
``synthetic_instance``): voronoi cells with smooth ridges at the benchmark's
cell density, generated in z-slabs through a cKDTree so memory stays
bounded at the scale of one CREMI sample, ``(125, 1250, 1250)``.  The
tree queries run on all host cores (``workers=-1``), which changes their
speed and not their result.
"""

from __future__ import annotations

import numpy as np

#: voxels per cell (the benchmark's density)
CELL_DENSITY = 70000


def synthetic_instance(shape, n_cells=None, seed=0):
    """(ground_truth uint32, boundary float32) of the given shape."""
    from scipy.spatial import cKDTree

    if n_cells is None:
        n_cells = max(int(np.prod(shape) / CELL_DENSITY), 8)
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n_cells, 3) * np.array(shape)).astype("float32")
    tree = cKDTree(pts)
    lab = np.zeros(shape, "uint32")
    bnd = np.zeros(shape, "float32")
    slab = max(int(2e7 // (shape[1] * shape[2])), 1)
    yy, xx = np.meshgrid(np.arange(shape[1], dtype="float32"),
                         np.arange(shape[2], dtype="float32"),
                         indexing="ij")
    for z0 in range(0, shape[0], slab):
        z1 = min(z0 + slab, shape[0])
        q = np.empty(((z1 - z0) * shape[1] * shape[2], 3), "float32")
        for i, z in enumerate(range(z0, z1)):
            base = i * shape[1] * shape[2]
            q[base:base + shape[1] * shape[2], 0] = z
            q[base:base + shape[1] * shape[2], 1] = yy.ravel()
            q[base:base + shape[1] * shape[2], 2] = xx.ravel()
        d, idx = tree.query(q, k=2, workers=-1)
        lab[z0:z1] = (idx[:, 0] + 1).reshape(z1 - z0, shape[1], shape[2])
        bnd[z0:z1] = np.exp(
            -0.5 * ((d[:, 1] - d[:, 0]) / 2.0) ** 2
        ).reshape(z1 - z0, shape[1], shape[2]).astype("float32")
    return lab, bnd


def as_uint8(bnd: np.ndarray) -> np.ndarray:
    """The boundary map requantized to uint8 (the reference's CNN-output
    convention, as the benchmark stores it)."""
    return np.round(bnd * 255).astype("uint8")
