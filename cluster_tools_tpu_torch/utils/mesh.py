"""Mesh extraction + smoothing for segmented objects.

Port of cluster_tools_tpu/utils/mesh.py (host numpy, as in the JAX
package), after the reference's ``utils/mesh_utils.py`` (marching cubes
via skimage + graph-neighbor smoothing :11-109).  skimage is not in the
image, so the iso-surface extraction is first-party **marching tetrahedra**:
each cell of the voxel grid is split into 6 tetrahedra; every tetrahedron
with a mixed-sign corner configuration emits 1-2 triangles with vertices at
edge midpoint interpolations.  Marching tetrahedra needs no 256-case table,
produces a watertight surface, and vectorizes over all cells at once."""

from __future__ import annotations

from typing import Tuple

import numpy as np

# the standard 6-tetrahedra decomposition of the unit cube around the main
# diagonal 0-7 (corner indices in binary ordering c = (dz<<2 | dy<<1 | dx));
# odd-parity cells use the mirrored table (c -> 7-c) so the induced face
# diagonals match between neighboring cells — without the parity flip the
# surface cracks along cell faces
_TETS = np.array([
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
    [0, 5, 1, 7],
], dtype="int64")
_TETS_ODD = 7 - _TETS

_CORNERS = np.array([[(c >> 2) & 1, (c >> 1) & 1, c & 1]
                     for c in range(8)], dtype="float64")


def marching_tetrahedra(volume: np.ndarray, level: float = 0.5
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices, faces) of the ``volume == level`` iso-surface.

    ``vertices``: (V, 3) float zyx coordinates; ``faces``: (F, 3) int64
    vertex indices.  Vertices shared between triangles are merged.
    """
    vol = np.asarray(volume, dtype="float64")
    if vol.ndim != 3:
        raise ValueError("marching_tetrahedra expects a 3d volume")
    nz, ny, nx = [s - 1 for s in vol.shape]
    if min(nz, ny, nx) < 1:
        return np.zeros((0, 3)), np.zeros((0, 3), "int64")

    # cell corner values: (cells, 8)
    base_all = np.stack(
        np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                    indexing="ij"), -1).reshape(-1, 3)
    corner_idx = base_all[:, None, :] + _CORNERS[None].astype("int64")
    vals_all = vol[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]

    tris = []
    parity = base_all.sum(axis=1) % 2
    for par, tets in ((0, _TETS), (1, _TETS_ODD)):
        group = parity == par
        base = base_all[group]
        vals = vals_all[group]
        if len(base) == 0:
            continue
        tris.extend(_extract_tets(base, vals, tets, level))

    if not tris:
        return np.zeros((0, 3)), np.zeros((0, 3), "int64")
    tri = np.concatenate(tris, axis=0)          # (F, 3, 3)
    # merge shared vertices (quantized to kill float noise)
    flat = np.round(tri.reshape(-1, 3), 6)
    verts, inv = np.unique(flat, axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3)
    # drop degenerate triangles
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts, faces[ok].astype("int64")


def _extract_tets(base, vals, tet_table, level):
    tris = []
    for tet in tet_table:
        tv = vals[:, tet]                      # (cells, 4)
        inside = tv > level                    # (cells, 4) bool
        n_in = inside.sum(axis=1)
        # corner positions of this tet for every cell: (cells, 4, 3)
        pos = base[:, None, :] + _CORNERS[tet][None]

        def edge_point(sel, a, b):
            va, vb = tv[sel, a], tv[sel, b]
            t = (level - va) / (vb - va)
            return pos[sel, a] + t[:, None] * (pos[sel, b] - pos[sel, a])

        for k, flip in ((1, False), (3, True)):
            # exactly one corner on the in-side (k=1) or out-side (k=3):
            # one triangle from that corner's three edges
            sel = np.flatnonzero(n_in == k)
            if len(sel) == 0:
                continue
            lone_in = inside[sel] if k == 1 else ~inside[sel]
            lone = np.argmax(lone_in, axis=1)
            others = np.array([[b for b in range(4) if b != a]
                               for a in range(4)])[lone]
            p = [edge_point(sel, lone, others[:, j]) for j in range(3)]
            tris.append(np.stack(p, axis=1))
        # 2-2 split: quad from the four crossing edges -> two triangles
        sel = np.flatnonzero(n_in == 2)
        if len(sel):
            ins = np.argsort(~inside[sel], axis=1)[:, :2]   # the two inside
            outs = np.argsort(inside[sel], axis=1)[:, :2]   # the two outside
            ins.sort(axis=1)
            outs.sort(axis=1)
            q00 = edge_point(sel, ins[:, 0], outs[:, 0])
            q01 = edge_point(sel, ins[:, 0], outs[:, 1])
            q11 = edge_point(sel, ins[:, 1], outs[:, 1])
            q10 = edge_point(sel, ins[:, 1], outs[:, 0])
            tris.append(np.stack([q00, q01, q11], axis=1))
            tris.append(np.stack([q00, q11, q10], axis=1))
    return tris


def smooth_mesh(vertices: np.ndarray, faces: np.ndarray,
                iterations: int = 5, lam: float = 0.5) -> np.ndarray:
    """Laplacian smoothing: move each vertex toward the mean of its mesh
    neighbors (reference: mesh_utils.py:11-34 graph-neighbor smoothing)."""
    verts = np.asarray(vertices, dtype="float64").copy()
    faces = np.asarray(faces, dtype="int64")
    n = len(verts)
    if n == 0 or len(faces) == 0:
        return verts
    # vertex adjacency from the face edges
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]])
    edges = np.unique(np.sort(edges, axis=1), axis=0)
    for _ in range(iterations):
        acc = np.zeros_like(verts)
        deg = np.zeros(n)
        np.add.at(acc, edges[:, 0], verts[edges[:, 1]])
        np.add.at(acc, edges[:, 1], verts[edges[:, 0]])
        np.add.at(deg, edges[:, 0], 1)
        np.add.at(deg, edges[:, 1], 1)
        mean = acc / np.maximum(deg, 1)[:, None]
        verts = verts + lam * (mean - verts)
    return verts


def object_mesh(seg: np.ndarray, label_id: int, smoothing_iterations: int = 0
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Mesh of one segment (the compute_meshes entry point the reference
    left as an empty placeholder, meshes/compute_meshes.py)."""
    obj = (np.asarray(seg) == label_id).astype("float64")
    # pad so surfaces at the volume border close
    obj = np.pad(obj, 1)
    verts, faces = marching_tetrahedra(obj, level=0.5)
    verts = verts - 1.0  # undo the pad offset
    if smoothing_iterations:
        verts = smooth_mesh(verts, faces, iterations=smoothing_iterations)
    return verts, faces
