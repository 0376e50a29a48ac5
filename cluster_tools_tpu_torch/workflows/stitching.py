"""Stitching of blockwise segmentations.

Re-specification of the reference's ``stitching/`` package, two strategies:

* **Overlap-based face stitching** (reference: stitch_faces.py:110-175
  ``_stitch_face``): for each face between adjacent blocks, match segments by
  *mutual best overlap* — segment a of block A merges with segment b of
  block B iff b is a's best overlap partner AND a is b's, and their mean
  normalized overlap exceeds ``overlap_threshold``.  Deviation by design:
  the reference compares two halo-extended *versions* of the overlap region
  saved as per-block npy files by an upstream task; this framework's
  segmentation tasks write only their inner blocks (chunk-aligned
  single-writer invariant, SURVEY §5.2), so the mutual-overlap measure is
  computed on the two voxel planes in contact at the face — the information
  the committed volume actually carries.  The matching rule (bidirectional
  argmax + mean-overlap threshold) is the reference's.
* **Simple (multicut-problem) stitching** (reference:
  simple_stitch_edges.py:92 ``ndist.findBlockBoundaryEdges``,
  simple_stitch_assignments.py:97): mark every RAG edge that crosses a block
  boundary, drop those with contact area below ``edge_size_threshold``, and
  union-find-merge the rest into an assignment table.

Port of cluster_tools_tpu/workflows/stitching.py.  Pair counting runs on
the task's device (the global config's ``"device"``, default ``"cuda"``;
ops/overlaps.count_overlaps — packed pair keys counted by
``torch.unique``); the union-find is first-party C++
(native.ufd_merge_pairs).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.blocking import Blocking, iterate_faces
from ..core.device import task_device
from ..core.runtime import BlockTask
from ..core.storage import file_reader
from ..core.workflow import FileTarget, Task
from .write import WriteAssignments


def _face_planes(ds, blocking: Blocking, face) -> tuple:
    """The two voxel planes in contact at a lower face."""
    region = ds[face.outer_bb]
    return region[face.face_a], region[face.face_b]


def match_face_segments(plane_a: np.ndarray, plane_b: np.ndarray,
                        overlap_threshold: float,
                        ignore_label: Optional[int] = 0,
                        device: str = "cuda") -> np.ndarray:
    """Mutual-best-overlap matching of the segments in contact across a face
    (reference: stitch_faces.py:110-175), the pairs counted on ``device``.
    Returns (K, 2) uint64 pairs."""
    from ..ops.overlaps import count_overlaps

    ids_a, ids_b, counts = count_overlaps(plane_a, plane_b, device=device)
    if ignore_label is not None:
        keep = (ids_a != ignore_label) & (ids_b != ignore_label)
        ids_a, ids_b, counts = ids_a[keep], ids_b[keep], counts[keep]
    if len(ids_a) == 0:
        return np.zeros((0, 2), "uint64")
    counts = counts.astype("float64")

    # normalized overlap per segment: counts / total contact area of the
    # segment on this face (the overlapArraysNormalized analog)
    ua, inv_a = np.unique(ids_a, return_inverse=True)
    ub, inv_b = np.unique(ids_b, return_inverse=True)
    tot_a = np.zeros(len(ua))
    tot_b = np.zeros(len(ub))
    np.add.at(tot_a, inv_a, counts)
    np.add.at(tot_b, inv_b, counts)
    norm_a = counts / tot_a[inv_a]  # fraction of a's contact going to b
    norm_b = counts / tot_b[inv_b]  # fraction of b's contact going to a

    # best partner per segment (by raw counts, as ngt.overlap sorted=True)
    best_a = np.zeros(len(ua), dtype="int64")  # pair row of a's best b
    best_b = np.zeros(len(ub), dtype="int64")
    order = np.argsort(counts)  # ascending; later (bigger) wins
    best_a[inv_a[order]] = order
    best_b[inv_b[order]] = order

    rows = np.arange(len(counts))
    mutual = (best_a[inv_a] == rows) & (best_b[inv_b] == rows)
    measure = 0.5 * (norm_a + norm_b)
    keep = mutual & (measure > overlap_threshold)
    return np.stack([ids_a[keep], ids_b[keep]], axis=1).astype("uint64")


class StitchFaces(BlockTask):
    """Per-block mutual-max-overlap face matching (reference: StitchFacesBase,
    stitch_faces.py:23-95).  Emits per-job assignment-pair npy files."""

    task_name = "stitch_faces"

    def __init__(self, labels_path: str, labels_key: str, **kw):
        self.labels_path = labels_path
        self.labels_key = labels_key
        super().__init__(**kw)
        self.device = task_device(self.global_config)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"overlap_threshold": 0.9, "ignore_label": 0})
        return conf

    def run_impl(self):
        with file_reader(self.labels_path, "r") as f:
            shape = list(f[self.labels_key].shape)
        block_shape = self.global_block_shape()[-len(shape):]
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "labels_path": self.labels_path, "labels_key": self.labels_key,
            "shape": shape, "block_shape": block_shape,
            "device": self.device,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        threshold = float(cfg.get("overlap_threshold", 0.9))
        ignore_label = cfg.get("ignore_label", 0)
        f = file_reader(cfg["labels_path"], "r")
        ds = f[cfg["labels_key"]]
        halo = [1] * blocking.ndim

        # per-BLOCK result files: retry renumbers jobs from 0, so per-job
        # files would clobber earlier successful jobs' outputs (the runtime's
        # block-granular retry contract, runtime.py:400-411); block files are
        # idempotent under any re-execution
        for block_id in job_config["block_list"]:
            pairs: List[np.ndarray] = []
            for face in iterate_faces(blocking, block_id, halo,
                                      return_only_lower=True):
                plane_a, plane_b = _face_planes(ds, blocking, face)
                matched = match_face_segments(plane_a, plane_b, threshold,
                                              ignore_label, cfg["device"])
                if len(matched):
                    pairs.append(matched)
            out = (np.concatenate(pairs, axis=0) if pairs
                   else np.zeros((0, 2), "uint64"))
            np.save(os.path.join(job_config["tmp_folder"],
                                 f"stitch_faces_block_{block_id}.npy"), out)
            log_fn(f"processed block {block_id}")


class StitchAssignments(BlockTask):
    """Global union-find merge of the face assignments into a consecutive
    node labeling (the merge_assignments analog of SURVEY §3.5, applied to
    stitching pairs)."""

    task_name = "stitch_assignments"
    global_task = True
    allow_retry = False

    def __init__(self, labels_path: str, labels_key: str,
                 assignment_path: str, **kw):
        self.labels_path = labels_path
        self.labels_key = labels_key
        self.assignment_path = assignment_path
        super().__init__(**kw)

    def run_impl(self):
        self.run_jobs(None, {
            "labels_path": self.labels_path, "labels_key": self.labels_key,
            "assignment_path": self.assignment_path,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from ..native import ufd_merge_pairs

        cfg = job_config["config"]
        with file_reader(cfg["labels_path"], "r") as f:
            ds = f[cfg["labels_key"]]
            max_id = ds.attrs.get("maxId")
            if max_id is None:
                log_fn("maxId attribute missing; scanning volume")
                max_id = ds.find_max()
        n_labels = int(max_id) + 1

        # glob the per-block pair files (the StitchFaces task's completion
        # protocol — log-line success + retry — guarantees every block of
        # the upstream run wrote one)
        tmp = job_config["tmp_folder"]
        pair_lists = [np.load(os.path.join(tmp, name))
                      for name in sorted(os.listdir(tmp))
                      if name.startswith("stitch_faces_block_")
                      and name.endswith(".npy")]
        pairs = (np.concatenate(pair_lists, axis=0) if pair_lists
                 else np.zeros((0, 2), "uint64"))
        log_fn(f"merging {len(pairs)} face assignments over "
               f"{n_labels} labels")

        roots = ufd_merge_pairs(n_labels, pairs)
        # consecutive relabel preserving 0 (root 0 is never merged away
        # because ignore-label pairs are filtered at the face stage)
        uniq = np.unique(roots)
        table = np.searchsorted(uniq, roots).astype("uint64")
        if uniq[0] != 0:  # no background present: shift to keep 1-based ids
            table += 1
        np.save(cfg["assignment_path"], table)
        log_fn(f"stitched down to {len(uniq)} segments")


class StitchingWorkflow(Task):
    """StitchFaces -> StitchAssignments -> Write (reference capability:
    overlap-based stitching of blockwise segmentations, stitch_faces.py)."""

    def __init__(self, labels_path: str, labels_key: str, output_path: str,
                 output_key: str, tmp_folder: str, config_dir: str,
                 max_jobs: int = 1, target: str = "gpu",
                 dependency: Optional[Task] = None):
        self.labels_path = labels_path
        self.labels_key = labels_key
        self.output_path = output_path
        self.output_key = output_key
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def requires(self):
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                      max_jobs=self.max_jobs, target=self.target)
        assignment_path = os.path.join(self.tmp_folder,
                                       "stitching_assignments.npy")
        faces = StitchFaces(labels_path=self.labels_path,
                            labels_key=self.labels_key,
                            dependency=self.dependency, **common)
        assign = StitchAssignments(
            labels_path=self.labels_path, labels_key=self.labels_key,
            assignment_path=assignment_path, dependency=faces, **common)
        return WriteAssignments(
            input_path=self.labels_path, input_key=self.labels_key,
            output_path=self.output_path, output_key=self.output_key,
            assignment_path=assignment_path, identifier="stitching",
            dependency=assign, **common)

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder,
                                       "write_stitching.status"))


# ---------------------------------------------------------------------------
# simple (multicut-problem based) stitching
# ---------------------------------------------------------------------------

class SimpleStitchEdges(BlockTask):
    """Mark RAG edges crossing block boundaries (reference:
    SimpleStitchEdgesBase, simple_stitch_edges.py:24-121 via
    ``ndist.findBlockBoundaryEdges``).  Per job: scan every lower face of the
    job's blocks, extract the label pairs in contact (device pair counting),
    map them to global edge ids, and save the per-job boolean edge mask."""

    task_name = "simple_stitch_edges"

    def __init__(self, problem_path: str, labels_path: str, labels_key: str,
                 graph_key: str = "s0/graph", **kw):
        self.problem_path = problem_path
        self.labels_path = labels_path
        self.labels_key = labels_key
        self.graph_key = graph_key
        super().__init__(**kw)
        self.device = task_device(self.global_config)

    def run_impl(self):
        with file_reader(self.labels_path, "r") as f:
            shape = list(f[self.labels_key].shape)
        block_shape = self.global_block_shape()[-len(shape):]
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "problem_path": self.problem_path, "graph_key": self.graph_key,
            "labels_path": self.labels_path, "labels_key": self.labels_key,
            "shape": shape, "block_shape": block_shape,
            "device": self.device,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from ..core.graph import find_edge_ids, load_graph, unique_edges
        from ..ops.overlaps import count_overlaps

        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        _, uv_ids, attrs = load_graph(cfg["problem_path"], cfg["graph_key"])
        n_edges = int(attrs["n_edges"])
        f = file_reader(cfg["labels_path"], "r")
        ds = f[cfg["labels_key"]]
        halo = [1] * blocking.ndim

        found = 0
        for block_id in job_config["block_list"]:
            block_eids = []
            for face in iterate_faces(blocking, block_id,
                                      halo, return_only_lower=True):
                plane_a, plane_b = _face_planes(ds, blocking, face)
                ids_a, ids_b, _ = count_overlaps(plane_a, plane_b,
                                                 device=cfg["device"])
                keep = (ids_a != 0) & (ids_b != 0) & (ids_a != ids_b)
                uv = unique_edges(ids_a[keep], ids_b[keep])
                # non-strict: pairs can cross an ignore region not in the RAG
                eids = find_edge_ids(uv_ids, uv, strict=False)
                block_eids.append(eids[eids >= 0])
            out = (np.unique(np.concatenate(block_eids)) if block_eids
                   else np.zeros(0, "int64"))
            found += len(out)
            # per-block edge-id files: idempotent under block-granular retry
            np.save(os.path.join(job_config["tmp_folder"],
                                 f"simple_stitch_edges_block_{block_id}.npy"),
                    out)
            log_fn(f"processed block {block_id}")
        log_fn(f"found {found} boundary-edge hits over {n_edges} edges")


class SimpleStitchAssignments(BlockTask):
    """OR the per-job boundary-edge masks, drop small-contact edges, and
    union-find-merge into a node labeling (reference:
    simple_stitch_assignments.py:97-160)."""

    task_name = "simple_stitch_assignments"
    global_task = True
    allow_retry = False

    def __init__(self, problem_path: str, assignments_path: str,
                 assignments_key: str,
                 graph_key: str = "s0/graph", features_key: str = "features",
                 edge_size_threshold: int = 0, serialize_edges: bool = False,
                 **kw):
        self.problem_path = problem_path
        self.assignments_path = assignments_path
        self.assignments_key = assignments_key
        self.graph_key = graph_key
        self.features_key = features_key
        self.edge_size_threshold = edge_size_threshold
        self.serialize_edges = serialize_edges
        super().__init__(**kw)

    def run_impl(self):
        self.run_jobs(None, {
            "problem_path": self.problem_path, "graph_key": self.graph_key,
            "features_key": self.features_key,
            "assignments_path": self.assignments_path,
            "assignments_key": self.assignments_key,
            "edge_size_threshold": self.edge_size_threshold,
            "serialize_edges": self.serialize_edges,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from ..core.graph import load_graph
        from ..native import ufd_merge_pairs

        cfg = job_config["config"]
        nodes, uv_ids, attrs = load_graph(cfg["problem_path"],
                                          cfg["graph_key"])
        merge_edges = np.zeros(int(attrs["n_edges"]), dtype=bool)
        tmp = job_config["tmp_folder"]
        for name in sorted(os.listdir(tmp)):
            if (name.startswith("simple_stitch_edges_block_")
                    and name.endswith(".npy")):
                merge_edges[np.load(tmp + "/" + name)] = True

        with file_reader(cfg["problem_path"], "r") as f:
            ds_feat = f[cfg["features_key"]]
            # last feature column is the edge size (features[:, -1]
            # convention; tensorstore slicing has no negative indices)
            edge_sizes = ds_feat[:, ds_feat.shape[1] - 1]
        assert len(edge_sizes) == len(merge_edges)
        merge_edges &= edge_sizes > cfg["edge_size_threshold"]
        log_fn(f"merging along {int(merge_edges.sum())} edges")

        with file_reader(cfg["assignments_path"]) as f:
            if cfg["serialize_edges"]:
                f.require_dataset(cfg["assignments_key"],
                                  data=merge_edges.astype("uint8"),
                                  chunks=(min(int(1e6), len(merge_edges)),))
                return

            # the labeling must cover every node id — including isolated
            # nodes above the largest edge endpoint
            n_nodes = int(nodes.max()) + 1 if len(nodes) else (
                int(uv_ids.max()) + 1 if len(uv_ids) else 0)
            labeling = ufd_merge_pairs(n_nodes, uv_ids[merge_edges])
            uniq = np.unique(labeling)
            labeling = np.searchsorted(uniq, labeling).astype("uint64")
            f.require_dataset(cfg["assignments_key"], data=labeling,
                              chunks=(min(int(1e5), len(labeling)),))
        log_fn(f"stitched to {len(np.unique(labeling))} segments")


class StitchingAssignmentsWorkflow(Task):
    """SimpleStitchEdges -> SimpleStitchAssignments (reference:
    stitching_workflows.py:8-53 StitchingAssignmentsWorkflow)."""

    def __init__(self, problem_path: str, labels_path: str, labels_key: str,
                 assignments_path: str, assignments_key: str,
                 tmp_folder: str, config_dir: str, max_jobs: int = 1,
                 target: str = "gpu", graph_key: str = "s0/graph",
                 features_key: str = "features",
                 edge_size_threshold: int = 0, serialize_edges: bool = False,
                 dependency: Optional[Task] = None):
        self.problem_path = problem_path
        self.labels_path = labels_path
        self.labels_key = labels_key
        self.assignments_path = assignments_path
        self.assignments_key = assignments_key
        self.graph_key = graph_key
        self.features_key = features_key
        self.edge_size_threshold = edge_size_threshold
        self.serialize_edges = serialize_edges
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def requires(self):
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                      max_jobs=self.max_jobs, target=self.target)
        edges = SimpleStitchEdges(
            problem_path=self.problem_path, labels_path=self.labels_path,
            labels_key=self.labels_key, graph_key=self.graph_key,
            dependency=self.dependency, **common)
        return SimpleStitchAssignments(
            problem_path=self.problem_path,
            assignments_path=self.assignments_path,
            assignments_key=self.assignments_key,
            graph_key=self.graph_key,
            features_key=self.features_key,
            edge_size_threshold=self.edge_size_threshold,
            serialize_edges=self.serialize_edges, dependency=edges, **common)

    def output(self):
        return FileTarget(os.path.join(
            self.tmp_folder, "simple_stitch_assignments.status"))
