"""Top-level segmentation pipelines (reference: cluster_tools/workflows.py).

Port of cluster_tools_tpu/workflows/segmentation.py: ``ProblemWorkflow``
assembles the multicut problem container from existing fragments (graph +
features + costs, reference workflows.py:29-108), and
``MulticutSegmentationWorkflow`` chains a problem with the hierarchical
multicut and the final write (reference workflows.py:204-233) — the split
chain (``fused=False``, the default: fragments from an upstream
``WatershedWorkflow``) or the fused chain (``fused=True``: fragments,
graph and features from one device pass per block,
workflows/fused_pipeline.py).  ``SimpleStitchingWorkflow`` merges every
fragment pair across a block boundary over a feature-only problem
(reference workflows.py:361-386).  ``LiftedMulticutSegmentationWorkflow``
adds lifted edges from a semantic label volume and solves the lifted
multicut; ``AgglomerativeClusteringWorkflow`` agglomerates the raw-feature
problem to a threshold (reference workflows.py:236-358).
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..core.workflow import FileTarget, Task
from .costs import EdgeCostsWorkflow
from .features import EdgeFeaturesWorkflow
from .graph import GraphWorkflow
from .multicut import MulticutWorkflow
from .write import WriteAssignments


class ProblemWorkflow(Task):
    """graph -> edge features -> costs into one problem container
    (reference: ProblemWorkflow, workflows.py:29-108).  ``offsets`` makes
    the features affinity-map features; ``compute_costs=False`` stops
    after the merged features."""

    def __init__(self, input_path: str, input_key: str, ws_path: str,
                 ws_key: str, problem_path: str, tmp_folder: str,
                 config_dir: str, max_jobs: int = 1, target: str = "gpu",
                 n_scales_graph: int = 1,
                 offsets: Optional[List[List[int]]] = None,
                 compute_costs: bool = True,
                 dependency: Optional[Task] = None):
        self.input_path = input_path
        self.input_key = input_key
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.problem_path = problem_path
        self.n_scales_graph = n_scales_graph
        self.offsets = offsets
        self.compute_costs = compute_costs
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def _common(self):
        return dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                    max_jobs=self.max_jobs, target=self.target)

    def requires(self):
        graph_wf = GraphWorkflow(
            input_path=self.ws_path, input_key=self.ws_key,
            graph_path=self.problem_path, output_key="s0/graph",
            n_scales=self.n_scales_graph, dependency=self.dependency,
            **self._common())
        feat_wf = EdgeFeaturesWorkflow(
            input_path=self.input_path, input_key=self.input_key,
            labels_path=self.ws_path, labels_key=self.ws_key,
            graph_path=self.problem_path, graph_key="s0/graph",
            output_path=self.problem_path,
            output_key="features", offsets=self.offsets, dependency=graph_wf,
            **self._common())
        if not self.compute_costs:
            return feat_wf
        return EdgeCostsWorkflow(
            features_path=self.problem_path, features_key="features",
            output_path=self.problem_path, output_key="s0/costs",
            graph_path=self.problem_path, graph_key="s0/graph",
            dependency=feat_wf, **self._common())

    def output(self):
        name = ("probs_to_costs.status" if self.compute_costs
                else "merge_edge_features.status")
        return FileTarget(os.path.join(self.tmp_folder, name))


class MulticutSegmentationWorkflow(Task):
    """Problem -> hierarchical multicut -> write segmentation
    (reference: MulticutSegmentationWorkflow, workflows.py:204-233).

    With ``fused=False`` (the default) ``ws_path/ws_key`` are the watershed
    fragments: chain a ``WatershedWorkflow`` upstream through
    ``dependency``.  ``fused=True`` computes the fragments INSIDE the
    problem assembly, so ``ws_path/ws_key`` are outputs; it takes boundary
    maps only.  ``target`` is ``"gpu"`` for the card (the JAX package's
    ``"tpu"``), or ``inline`` / ``local`` / ``threads``; the device itself
    is the global config's ``"device"``."""

    def __init__(self, input_path: str, input_key: str, ws_path: str,
                 ws_key: str, problem_path: str, output_path: str,
                 output_key: str, tmp_folder: str, config_dir: str,
                 max_jobs: int = 1, target: str = "gpu",
                 n_scales: int = 1,
                 offsets: Optional[List[List[int]]] = None,
                 fused: bool = False,
                 dependency: Optional[Task] = None):
        if fused and offsets is not None:
            raise ValueError("fused=True supports boundary maps only "
                             "(affinity offsets need the split chain)")
        self.input_path = input_path
        self.input_key = input_key
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.problem_path = problem_path
        self.output_path = output_path
        self.output_key = output_key
        self.n_scales = n_scales
        self.offsets = offsets
        self.fused = fused
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def _common(self):
        return dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                    max_jobs=self.max_jobs, target=self.target)

    def requires(self):
        assignment_path = os.path.join(self.tmp_folder,
                                       "multicut_assignments.npy")
        write_bs_kw = {}
        if self.fused:
            from .fused_pipeline import (FusedProblemWorkflow,
                                         mesh_resident_block_shape)

            problem = FusedProblemWorkflow(
                input_path=self.input_path, input_key=self.input_key,
                ws_path=self.ws_path, ws_key=self.ws_key,
                problem_path=self.problem_path,
                dependency=self.dependency, **self._common())
            # mesh-resident fused chain: fragments staged one slab per
            # shard — the assignment write iterates the same slab grid so
            # the in-RAM fragment cache hits (store reads otherwise)
            mesh_bs = mesh_resident_block_shape(
                self.config_dir, self.input_path, self.input_key)
            if mesh_bs:
                write_bs_kw = {"block_shape": mesh_bs}
        else:
            problem = ProblemWorkflow(
                input_path=self.input_path, input_key=self.input_key,
                ws_path=self.ws_path, ws_key=self.ws_key,
                problem_path=self.problem_path, offsets=self.offsets,
                dependency=self.dependency, **self._common())
        multicut = MulticutWorkflow(
            problem_path=self.problem_path, assignment_path=assignment_path,
            n_scales=self.n_scales, dependency=problem, **self._common())
        return WriteAssignments(
            input_path=self.ws_path, input_key=self.ws_key,
            output_path=self.output_path, output_key=self.output_key,
            assignment_path=assignment_path, identifier="multicut",
            dependency=multicut, **write_bs_kw, **self._common())

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder,
                                       "write_multicut.status"))


class SimpleStitchingWorkflow(Task):
    """Problem (features only) -> merge block-boundary edges -> write
    (reference: SimpleStitchingWorkflow, workflows.py:361-386)."""

    def __init__(self, input_path: str, input_key: str, ws_path: str,
                 ws_key: str, problem_path: str, output_path: str,
                 output_key: str, tmp_folder: str, config_dir: str,
                 max_jobs: int = 1, target: str = "gpu",
                 edge_size_threshold: int = 0,
                 dependency: Optional[Task] = None):
        self.input_path = input_path
        self.input_key = input_key
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.problem_path = problem_path
        self.output_path = output_path
        self.output_key = output_key
        self.edge_size_threshold = edge_size_threshold
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def _common(self):
        return dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                    max_jobs=self.max_jobs, target=self.target)

    def requires(self):
        from .stitching import StitchingAssignmentsWorkflow

        problem = ProblemWorkflow(
            input_path=self.input_path, input_key=self.input_key,
            ws_path=self.ws_path, ws_key=self.ws_key,
            problem_path=self.problem_path, compute_costs=False,
            dependency=self.dependency, **self._common())
        stitch = StitchingAssignmentsWorkflow(
            problem_path=self.problem_path, labels_path=self.ws_path,
            labels_key=self.ws_key, assignments_path=self.problem_path,
            assignments_key="stitch_assignments", graph_key="s0/graph",
            features_key="features",
            edge_size_threshold=self.edge_size_threshold,
            dependency=problem, **self._common())
        return WriteAssignments(
            input_path=self.ws_path, input_key=self.ws_key,
            output_path=self.output_path, output_key=self.output_key,
            assignment_path=self.problem_path,
            assignment_key="stitch_assignments",
            identifier="simple_stitching", dependency=stitch,
            **self._common())

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder,
                                       "write_simple_stitching.status"))


class LiftedMulticutSegmentationWorkflow(Task):
    """Problem -> lifted features from semantic priors -> hierarchical
    lifted multicut -> write (reference:
    LiftedMulticutSegmentationWorkflow, workflows.py:236-323).  The
    problem assembly runs on the card; the lifted features and solves are
    host work over its graph files."""

    def __init__(self, input_path: str, input_key: str, ws_path: str,
                 ws_key: str, labels_path: str, labels_key: str,
                 problem_path: str, output_path: str, output_key: str,
                 lifted_prefix: str, tmp_folder: str, config_dir: str,
                 max_jobs: int = 1, target: str = "gpu", n_scales: int = 1,
                 nh_graph_depth: int = 4, mode: str = "all",
                 offsets: Optional[List[List[int]]] = None,
                 clear_labels_path: str = "", clear_labels_key: str = "",
                 dependency: Optional[Task] = None):
        self.input_path = input_path
        self.input_key = input_key
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.labels_path = labels_path
        self.labels_key = labels_key
        self.problem_path = problem_path
        self.output_path = output_path
        self.output_key = output_key
        self.lifted_prefix = lifted_prefix
        self.n_scales = n_scales
        self.nh_graph_depth = nh_graph_depth
        self.mode = mode
        self.offsets = offsets
        self.clear_labels_path = clear_labels_path
        self.clear_labels_key = clear_labels_key
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def _common(self):
        return dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                    max_jobs=self.max_jobs, target=self.target)

    def requires(self):
        from .lifted_features import LiftedFeaturesFromNodeLabelsWorkflow
        from .lifted_multicut import LiftedMulticutWorkflow

        assignment_path = os.path.join(self.tmp_folder,
                                       "lifted_multicut_assignments.npy")
        problem = ProblemWorkflow(
            input_path=self.input_path, input_key=self.input_key,
            ws_path=self.ws_path, ws_key=self.ws_key,
            problem_path=self.problem_path, offsets=self.offsets,
            dependency=self.dependency, **self._common())
        lifted_feats = LiftedFeaturesFromNodeLabelsWorkflow(
            ws_path=self.ws_path, ws_key=self.ws_key,
            labels_path=self.labels_path, labels_key=self.labels_key,
            graph_path=self.problem_path, graph_key="s0/graph",
            output_path=self.problem_path,
            nh_out_key=f"s0/lifted_nh_{self.lifted_prefix}",
            feat_out_key=f"s0/lifted_costs_{self.lifted_prefix}",
            prefix=self.lifted_prefix, nh_graph_depth=self.nh_graph_depth,
            mode=self.mode, clear_labels_path=self.clear_labels_path,
            clear_labels_key=self.clear_labels_key, dependency=problem,
            **self._common())
        lifted_mc = LiftedMulticutWorkflow(
            problem_path=self.problem_path, assignment_path=assignment_path,
            lifted_prefix=self.lifted_prefix, n_scales=self.n_scales,
            dependency=lifted_feats, **self._common())
        return WriteAssignments(
            input_path=self.ws_path, input_key=self.ws_key,
            output_path=self.output_path, output_key=self.output_key,
            assignment_path=assignment_path, identifier="lifted_multicut",
            dependency=lifted_mc, **self._common())

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder,
                                       "write_lifted_multicut.status"))


class AgglomerativeClusteringWorkflow(Task):
    """Problem (features only) -> global agglomerative clustering -> write
    (reference: AgglomerativeClusteringWorkflow, workflows.py:327-358)."""

    def __init__(self, input_path: str, input_key: str, ws_path: str,
                 ws_key: str, problem_path: str, output_path: str,
                 output_key: str, threshold: float, tmp_folder: str,
                 config_dir: str, max_jobs: int = 1, target: str = "gpu",
                 offsets: Optional[List[List[int]]] = None,
                 dependency: Optional[Task] = None):
        self.input_path = input_path
        self.input_key = input_key
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.problem_path = problem_path
        self.output_path = output_path
        self.output_key = output_key
        self.threshold = threshold
        self.offsets = offsets
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def _common(self):
        return dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                    max_jobs=self.max_jobs, target=self.target)

    def requires(self):
        from .agglomerative_clustering import AgglomerativeClustering

        assignment_path = os.path.join(self.tmp_folder,
                                       "agglomeration_assignments.npy")
        problem = ProblemWorkflow(
            input_path=self.input_path, input_key=self.input_key,
            ws_path=self.ws_path, ws_key=self.ws_key,
            problem_path=self.problem_path, offsets=self.offsets,
            compute_costs=False, dependency=self.dependency,
            **self._common())
        agglo = AgglomerativeClustering(
            problem_path=self.problem_path, assignment_path=assignment_path,
            threshold=self.threshold, dependency=problem, **self._common())
        return WriteAssignments(
            input_path=self.ws_path, input_key=self.ws_key,
            output_path=self.output_path, output_key=self.output_key,
            assignment_path=assignment_path,
            identifier="agglomerative_clustering", dependency=agglo,
            **self._common())

    def output(self):
        return FileTarget(os.path.join(
            self.tmp_folder, "write_agglomerative_clustering.status"))
