"""Utility surface of the port (reference: cluster_tools/utils/):
validation metrics, affine transformations and mesh extraction.  The
Knossos reader of the JAX package's utils is not ported yet (ROADMAP
A16)."""

from .mesh import marching_tetrahedra, object_mesh, smooth_mesh
from .transformations import (matrix_2d, matrix_3d, parameters_from_matrix,
                              transform_roi)

__all__ = [
    "marching_tetrahedra", "object_mesh", "smooth_mesh",
    "matrix_2d", "matrix_3d", "parameters_from_matrix", "transform_roi",
]
