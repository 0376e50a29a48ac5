"""Workflows of the port: the multicut segmentation chains (split and
fused), the watershed and the problem assembly, and the affinity path
(U-Net inference and the mutex watershed)."""

from .inference import InferenceTask
from .mutex_watershed import MwsWorkflow, TwoPassMwsWorkflow
from .segmentation import MulticutSegmentationWorkflow, ProblemWorkflow
from .watershed import WatershedWorkflow

__all__ = ["InferenceTask", "MulticutSegmentationWorkflow", "MwsWorkflow",
           "ProblemWorkflow", "TwoPassMwsWorkflow", "WatershedWorkflow"]
