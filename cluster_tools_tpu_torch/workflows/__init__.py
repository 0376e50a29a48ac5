"""Workflows of the port: the multicut segmentation chains (split and
fused), the watershed and the problem assembly."""

from .segmentation import MulticutSegmentationWorkflow, ProblemWorkflow
from .watershed import WatershedWorkflow

__all__ = ["MulticutSegmentationWorkflow", "ProblemWorkflow",
           "WatershedWorkflow"]
