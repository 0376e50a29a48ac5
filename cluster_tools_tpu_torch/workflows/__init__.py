"""Workflows of the port: the multicut segmentation chains (split and
fused), the watershed and the problem assembly, the affinity path (U-Net
inference and the mutex watershed), connected components of a
thresholded map, block stitching, node labels and evaluation."""

from .evaluation import EvaluationWorkflow
from .inference import InferenceTask
from .mutex_watershed import MwsWorkflow, TwoPassMwsWorkflow
from .node_labels import NodeLabelWorkflow
from .segmentation import (MulticutSegmentationWorkflow, ProblemWorkflow,
                           SimpleStitchingWorkflow)
from .stitching import StitchingAssignmentsWorkflow, StitchingWorkflow
from .thresholded_components import ThresholdedComponentsWorkflow
from .watershed import WatershedWorkflow

__all__ = ["EvaluationWorkflow", "InferenceTask",
           "MulticutSegmentationWorkflow", "MwsWorkflow",
           "NodeLabelWorkflow", "ProblemWorkflow", "SimpleStitchingWorkflow",
           "StitchingAssignmentsWorkflow", "StitchingWorkflow",
           "ThresholdedComponentsWorkflow", "TwoPassMwsWorkflow",
           "WatershedWorkflow"]
