"""cluster_tools_tpu_torch — the PyTorch/CUDA port of cluster_tools_tpu.

Runs the JAX package's segmentation pipelines on an NVIDIA card: the
multicut chains — the split chain (``WatershedWorkflow`` ->
``MulticutSegmentationWorkflow``, its default) and the fused chain
(``fused=True``) — and the affinity path, U-Net prediction
(``InferenceTask``) feeding the mutex watershed (``MwsWorkflow``,
``TwoPassMwsWorkflow``); connected components of a thresholded map
with block stitching (``ThresholdedComponentsWorkflow``), overlap and
problem-based stitching (``StitchingWorkflow``,
``StitchingAssignmentsWorkflow``, ``SimpleStitchingWorkflow``), node
labels and evaluation (``NodeLabelWorkflow``, ``EvaluationWorkflow``);
the lifted multicut and agglomerative clustering segmentations
(``LiftedMulticutSegmentationWorkflow``,
``AgglomerativeClusteringWorkflow``); filter-bank edge and pixel features
(``ImageFilterTask``, ``PixelClassificationWorkflow``), derived maps
(``InsertAffinities``, ``SmoothedGradients``), multiscale pyramids and
object fitting (``DownscalingWorkflow``, ``PainteraToBdvWorkflow``,
``UpscaleTask``, ``ScaleToBoundariesTask``), region features and the
post-processing workflows (size filters, graph watershed, orphans,
graph connected components); the tools run after a segmentation —
per-object morphology, meshes and skeletons (``MorphologyWorkflow``,
``MeshWorkflow``, ``SkeletonWorkflow``, ``UpsampleSkeletons``), label
multisets and the Paintera and BigCat exports
(``LabelMultisetWorkflow``, ``PainteraConversionWorkflow``,
``BigcatWorkflow``) — masking (``BlocksFromMask``, ``MinFilterMask``),
the decomposition multicut (``DecompositionWorkflow``), the debugging
checks (``CheckSubGraphs``, ``CheckComponents``) and the random-forest
edge classifier (``LearningWorkflow``; sklearn on the host).  HDF5,
blosc-compressed zarr and N5, and Knossos volumes are read (and all but
Knossos written) by the package's own storage code.  Plain PyTorch for the
device code, a hand-written CUDA kernel where the JAX package had a Pallas
kernel (``csrc/``), and the same task configs, container formats and outputs.
Device tasks run on the global config's ``"device"`` (default
``"cuda"``); the CPU is used only when asked for.
"""

__version__ = "0.1.0"

from .core.workflow import Task, DummyTask, build
from .core.runtime import BlockTask, FailedJobsError
from .core.blocking import Blocking, blocks_in_volume, block_to_bb
from .core.storage import file_reader
# the ported workflow surface (reference: cluster_tools/__init__.py:1-9)
from .workflows import *  # noqa: F401,F403
from .workflows import EvaluationWorkflow, NodeLabelWorkflow  # noqa: F401
from . import workflows as _workflows

__all__ = [
    "Task", "DummyTask", "build", "BlockTask", "FailedJobsError",
    "Blocking", "blocks_in_volume", "block_to_bb", "file_reader",
] + list(_workflows.__all__)
