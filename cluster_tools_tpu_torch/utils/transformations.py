"""Affine transformation helpers.

Port of cluster_tools_tpu/utils/transformations.py (host numpy, as in the
JAX package), after the reference's ``utils/transformation_utils.py``
(2d/3d affine matrix construction :18-113, matrix <-> parameter conversion,
``transform_roi``).  Matrices are homogeneous (ndim+1, ndim+1), acting on
zyx coordinate vectors — the convention of ``TransformedVolume``
(core/volume_views.py)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def matrix_2d(scale: Sequence[float] = (1.0, 1.0), rotation: float = 0.0,
              shear: float = 0.0,
              translation: Sequence[float] = (0.0, 0.0)) -> np.ndarray:
    """Homogeneous 2d affine from parameters (rotation in degrees;
    reference: transformation_utils.py:18-60)."""
    t = np.deg2rad(rotation)
    cos, sin = np.cos(t), np.sin(t)
    mat = np.eye(3)
    mat[0, 0] = scale[0] * cos
    mat[0, 1] = -scale[1] * (sin + shear)
    mat[1, 0] = scale[0] * (sin + shear)
    mat[1, 1] = scale[1] * cos
    mat[:2, 2] = translation
    return mat


def matrix_3d(scale: Sequence[float] = (1.0, 1.0, 1.0),
              rotation: Sequence[float] = (0.0, 0.0, 0.0),
              translation: Sequence[float] = (0.0, 0.0, 0.0)) -> np.ndarray:
    """Homogeneous 3d affine from parameters (Euler zyx rotations in
    degrees; reference: transformation_utils.py:62-113)."""
    a, b, c = np.deg2rad(rotation)
    rz = np.array([[np.cos(a), -np.sin(a), 0],
                   [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                   [-np.sin(b), 0, np.cos(b)]])
    rx = np.array([[1, 0, 0], [0, np.cos(c), -np.sin(c)],
                   [0, np.sin(c), np.cos(c)]])
    mat = np.eye(4)
    mat[:3, :3] = rz @ ry @ rx @ np.diag(scale)
    mat[:3, 3] = translation
    return mat


def parameters_from_matrix(matrix: np.ndarray):
    """(scale, rotation_degrees, translation) from a homogeneous affine
    (inverse of matrix_2d / matrix_3d for shear-free transforms)."""
    matrix = np.asarray(matrix)
    ndim = matrix.shape[0] - 1
    lin = matrix[:ndim, :ndim]
    translation = matrix[:ndim, ndim].copy()
    scale = np.linalg.norm(lin, axis=0)
    rot = lin / scale[None, :]
    if ndim == 2:
        rotation = float(np.rad2deg(np.arctan2(rot[1, 0], rot[0, 0])))
    else:
        # Euler zyx angles back from the rotation matrix
        ry = -np.arcsin(np.clip(rot[2, 0], -1, 1))
        if abs(np.cos(ry)) < 1e-9:
            # gimbal lock: rz and rx are degenerate; fix rz = 0
            rz = 0.0
            rx = np.arctan2(-rot[1, 2], rot[1, 1])
        else:
            rz = np.arctan2(rot[1, 0] / np.cos(ry), rot[0, 0] / np.cos(ry))
            rx = np.arctan2(rot[2, 1] / np.cos(ry), rot[2, 2] / np.cos(ry))
        rotation = tuple(np.rad2deg([rz, ry, rx]))
    return tuple(scale), rotation, tuple(translation)


def transform_roi(roi_begin: Sequence[float], roi_end: Sequence[float],
                  matrix: np.ndarray) -> Tuple[Tuple[float, ...],
                                               Tuple[float, ...]]:
    """Axis-aligned bounding box of a transformed ROI (reference:
    transformation_utils.py transform_roi): transform all corners, take the
    min/max envelope."""
    matrix = np.asarray(matrix)
    ndim = len(roi_begin)
    corners = []
    for bits in range(2 ** ndim):
        c = [roi_begin[d] if (bits >> d) & 1 == 0 else roi_end[d]
             for d in range(ndim)]
        corners.append(c + [1.0])
    pts = (matrix @ np.asarray(corners).T)[:ndim]
    return tuple(pts.min(axis=1)), tuple(pts.max(axis=1))
