"""Workflows of the port: the multicut segmentation chains (split and
fused), the watershed and the problem assembly, the lifted multicut and
agglomerative clustering segmentations, the affinity path (U-Net inference
and the mutex watershed), connected components of a thresholded map,
block stitching, node labels and evaluation.  ``__all__`` lists the JAX
package's exports that are ported; ``EvaluationWorkflow`` and
``NodeLabelWorkflow``, which the JAX package leaves out of its exports,
are importable here all the same."""

from .evaluation import EvaluationWorkflow
from .graph import GraphWorkflow
from .inference import InferenceTask
from .lifted_features import LiftedFeaturesFromNodeLabelsWorkflow
from .lifted_multicut import LiftedMulticutWorkflow
from .multicut import MulticutWorkflow
from .mutex_watershed import MwsWorkflow, TwoPassMwsWorkflow
from .node_labels import NodeLabelWorkflow
from .relabel import RelabelWorkflow
from .segmentation import (AgglomerativeClusteringWorkflow,
                           LiftedMulticutSegmentationWorkflow,
                           MulticutSegmentationWorkflow, ProblemWorkflow,
                           SimpleStitchingWorkflow)
from .stitching import StitchingAssignmentsWorkflow, StitchingWorkflow
from .thresholded_components import ThresholdedComponentsWorkflow
from .watershed import (AgglomerateTask, WatershedFromSeedsTask,
                        WatershedWorkflow)

__all__ = [
    "AgglomerateTask", "AgglomerativeClusteringWorkflow",
    "GraphWorkflow", "InferenceTask",
    "LiftedFeaturesFromNodeLabelsWorkflow",
    "LiftedMulticutSegmentationWorkflow", "LiftedMulticutWorkflow",
    "MulticutSegmentationWorkflow", "MulticutWorkflow", "MwsWorkflow",
    "ProblemWorkflow", "RelabelWorkflow",
    "SimpleStitchingWorkflow", "StitchingAssignmentsWorkflow",
    "StitchingWorkflow", "ThresholdedComponentsWorkflow",
    "TwoPassMwsWorkflow", "WatershedFromSeedsTask", "WatershedWorkflow",
]
