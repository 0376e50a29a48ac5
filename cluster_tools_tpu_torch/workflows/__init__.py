"""Workflows of the port: the multicut segmentation chains (split and
fused), the watershed and the problem assembly, the lifted multicut and
agglomerative clustering segmentations, the affinity path (U-Net inference
and the mutex watershed), connected components of a thresholded map,
block stitching, node labels and evaluation; the filter-bank workflows
(pixel features and classification, smoothed gradients), derived
affinities, multiscale pyramids and object fitting, region features and
the post-processing toolbox; the tools run after a segmentation
(morphology, meshes, skeletons, label multisets and the Paintera and
BigCat exports), masking, the decomposition multicut and the debugging
checks, and the random-forest edge classifier.  ``__all__`` lists the JAX package's exports that are ported;
``EvaluationWorkflow`` and ``NodeLabelWorkflow``, which the JAX package
leaves out of its exports, are importable here all the same."""

from .affinities import InsertAffinities, SmoothedGradients
from .copy_volume import CopyVolumeTask
from .debugging import CheckComponents, CheckSubGraphs
from .decomposition import DecompositionWorkflow
from .downscaling import (DownscalingWorkflow, PainteraToBdvWorkflow,
                          ScaleToBoundariesTask, UpscaleTask)
from .evaluation import EvaluationWorkflow
from .graph import GraphWorkflow
from .inference import InferenceTask
from .label_multisets import LabelMultisetWorkflow
from .learning import LearningWorkflow
from .lifted_features import LiftedFeaturesFromNodeLabelsWorkflow
from .lifted_multicut import LiftedMulticutWorkflow
from .masking import BlocksFromMask, MinFilterMask
from .meshes import MeshWorkflow
from .morphology import MorphologyWorkflow
from .multicut import MulticutWorkflow
from .mutex_watershed import MwsWorkflow, TwoPassMwsWorkflow
from .node_labels import NodeLabelWorkflow
from .paintera import BigcatWorkflow, PainteraConversionWorkflow
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
from .skeletons import SkeletonWorkflow, UpsampleSkeletons
from .stitching import StitchingAssignmentsWorkflow, StitchingWorkflow
from .thresholded_components import ThresholdedComponentsWorkflow
from .watershed import (AgglomerateTask, WatershedFromSeedsTask,
                        WatershedWorkflow)

__all__ = [
    "AgglomerateTask", "AgglomerativeClusteringWorkflow", "BigcatWorkflow",
    "BlocksFromMask", "CheckComponents", "CheckSubGraphs",
    "ConnectedComponentsWorkflow", "CopyVolumeTask",
    "DecompositionWorkflow", "DownscalingWorkflow",
    "FilterByThresholdWorkflow", "FilterLabelsWorkflow",
    "FilterOrphansWorkflow", "GraphWorkflow", "ImageFilterTask",
    "InferenceTask", "InsertAffinities", "LabelMultisetWorkflow",
    "LearningWorkflow",
    "LiftedFeaturesFromNodeLabelsWorkflow",
    "LiftedMulticutSegmentationWorkflow", "LiftedMulticutWorkflow",
    "MeshWorkflow", "MinFilterMask", "MorphologyWorkflow",
    "MulticutSegmentationWorkflow", "MulticutWorkflow", "MwsWorkflow",
    "PainteraConversionWorkflow", "PainteraToBdvWorkflow",
    "PixelClassificationWorkflow", "ProblemWorkflow",
    "RegionFeaturesWorkflow", "RelabelWorkflow", "ScaleToBoundariesTask",
    "SimpleStitchingWorkflow", "SizeFilterAndGraphWatershedWorkflow",
    "SizeFilterWorkflow", "SkeletonWorkflow", "SmoothedGradients",
    "StitchingAssignmentsWorkflow", "StitchingWorkflow",
    "ThresholdedComponentsWorkflow", "TwoPassMwsWorkflow", "UpscaleTask",
    "UpsampleSkeletons", "WatershedFromSeedsTask", "WatershedWorkflow",
    "WriteCarving",
]
