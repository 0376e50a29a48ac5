"""Utility surface of the port (reference: cluster_tools/utils/):
validation metrics, affine transformations, Knossos reader, mesh
extraction."""

from .knossos import KnossosDataset, KnossosFile
from .mesh import marching_tetrahedra, object_mesh, smooth_mesh
from .transformations import (matrix_2d, matrix_3d, parameters_from_matrix,
                              transform_roi)

__all__ = [
    "KnossosDataset", "KnossosFile",
    "marching_tetrahedra", "object_mesh", "smooth_mesh",
    "matrix_2d", "matrix_3d", "parameters_from_matrix", "transform_roi",
]
