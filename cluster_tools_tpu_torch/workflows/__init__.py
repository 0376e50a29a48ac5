"""Workflows of the port: the multicut segmentation chains (split and
fused), the watershed and the problem assembly, the lifted multicut and
agglomerative clustering segmentations, the affinity path (U-Net inference
and the mutex watershed), connected components of a thresholded map,
block stitching, node labels and evaluation; the filter-bank workflows
(pixel features and classification, smoothed gradients), derived
affinities, multiscale pyramids and object fitting, region features and
the post-processing toolbox.  ``__all__`` lists the JAX
package's exports that are ported; ``EvaluationWorkflow`` and
``NodeLabelWorkflow``, which the JAX package leaves out of its exports,
are importable here all the same."""

from .affinities import InsertAffinities, SmoothedGradients
from .copy_volume import CopyVolumeTask
from .downscaling import (DownscalingWorkflow, PainteraToBdvWorkflow,
                          ScaleToBoundariesTask, UpscaleTask)
from .evaluation import EvaluationWorkflow
from .graph import GraphWorkflow
from .inference import InferenceTask
from .lifted_features import LiftedFeaturesFromNodeLabelsWorkflow
from .lifted_multicut import LiftedMulticutWorkflow
from .multicut import MulticutWorkflow
from .mutex_watershed import MwsWorkflow, TwoPassMwsWorkflow
from .node_labels import NodeLabelWorkflow
from .pixel_classification import (ImageFilterTask,
                                   PixelClassificationWorkflow, WriteCarving)
from .postprocess import (ConnectedComponentsWorkflow,
                          FilterByThresholdWorkflow, FilterLabelsWorkflow,
                          FilterOrphansWorkflow,
                          SizeFilterAndGraphWatershedWorkflow,
                          SizeFilterWorkflow)
from .region_features import RegionFeaturesWorkflow
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
    "ConnectedComponentsWorkflow", "CopyVolumeTask",
    "DownscalingWorkflow", "FilterByThresholdWorkflow",
    "FilterLabelsWorkflow", "FilterOrphansWorkflow",
    "GraphWorkflow", "ImageFilterTask", "InferenceTask", "InsertAffinities",
    "LiftedFeaturesFromNodeLabelsWorkflow",
    "LiftedMulticutSegmentationWorkflow", "LiftedMulticutWorkflow",
    "MulticutSegmentationWorkflow", "MulticutWorkflow", "MwsWorkflow",
    "PainteraToBdvWorkflow", "PixelClassificationWorkflow",
    "ProblemWorkflow", "RegionFeaturesWorkflow", "RelabelWorkflow",
    "ScaleToBoundariesTask", "SimpleStitchingWorkflow",
    "SizeFilterAndGraphWatershedWorkflow", "SizeFilterWorkflow",
    "SmoothedGradients", "StitchingAssignmentsWorkflow",
    "StitchingWorkflow", "ThresholdedComponentsWorkflow",
    "TwoPassMwsWorkflow", "UpscaleTask", "WatershedFromSeedsTask",
    "WatershedWorkflow", "WriteCarving",
]
