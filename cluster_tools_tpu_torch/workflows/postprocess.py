"""Segmentation post-processing toolbox.

Port of cluster_tools_tpu/workflows/postprocess.py (reference
``postprocess/`` package, postprocess_workflow.py:24-420): size filters
(background / watershed-fill modes), id filters over semantic node labels,
graph connected components, graph-watershed reassignment of discarded
fragments, orphan merging.

Structure: small blockwise map steps (count sizes, zero out filtered ids,
refill) plus global graph steps over the assignment tables.  The graph
steps run the native C++ (graph_watershed, ufd) over flat edge lists on
the host; the per-block refill runs the seeded watershed on the device,
the only device work here, so only the filling size filter asks for the
global config's device.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core.blocking import Blocking
from ..core.config import write_config
from ..core.device import task_device
from ..core.runtime import BlockTask
from ..core.storage import file_reader
from ..core.workflow import FileTarget, Task
from .relabel import RelabelWorkflow
from .write import WriteAssignments


def _relabel_consecutive(assignments: np.ndarray) -> np.ndarray:
    """vigra.relabelConsecutive(start_label=1, keep_zeros=True) equivalent."""
    nz = assignments != 0
    uniq = np.unique(assignments[nz])
    out = np.zeros_like(assignments)
    out[nz] = np.searchsorted(uniq, assignments[nz]).astype(
        assignments.dtype) + 1
    return out


class BlockCounts(BlockTask):
    """Per-block label histogram -> block npz (the FindUniques
    return_counts=True analog, reference: relabel/find_uniques.py +
    size_filter_blocks.py:23)."""

    task_name = "block_counts"

    def __init__(self, input_path: str, input_key: str,
                 identifier: str = "", **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.identifier = identifier
        super().__init__(**kw)

    def run_impl(self):
        with file_reader(self.input_path, "r") as f:
            shape = list(f[self.input_key].shape)
        block_shape = self.global_block_shape()[-len(shape):]
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "shape": shape, "block_shape": block_shape,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        f = file_reader(cfg["input_path"], "r")
        ds = f[cfg["input_key"]]
        for block_id in job_config["block_list"]:
            ids, counts = np.unique(ds[blocking.get_block(block_id).bb],
                                    return_counts=True)
            np.savez(os.path.join(
                job_config["tmp_folder"],
                f"{job_config['task_name']}_block_{block_id}.npz"),
                ids=ids.astype("uint64"), counts=counts.astype("uint64"))
            log_fn(f"processed block {block_id}")


def merge_block_counts(tmp_folder: str, prefix: str):
    """Sum the per-block histograms -> (ids, total_counts)."""
    all_ids: List[np.ndarray] = []
    all_counts: List[np.ndarray] = []
    for name in sorted(os.listdir(tmp_folder)):
        if name.startswith(prefix + "_block_") and name.endswith(".npz"):
            with np.load(os.path.join(tmp_folder, name)) as d:
                all_ids.append(d["ids"])
                all_counts.append(d["counts"])
    if not all_ids:
        return np.zeros(0, "uint64"), np.zeros(0, "uint64")
    ids = np.concatenate(all_ids)
    counts = np.concatenate(all_counts)
    uniq, inv = np.unique(ids, return_inverse=True)
    totals = np.zeros(len(uniq), "uint64")
    np.add.at(totals, inv, counts)
    return uniq, totals


class SizeFilterDiscardIds(BlockTask):
    """Global reduce: ids with total size below threshold -> discard npy
    (reference: size_filter_blocks.py)."""

    task_name = "size_filter_discard_ids"
    global_task = True
    allow_retry = False

    def __init__(self, counts_prefix: str, output_path: str,
                 size_threshold: int, identifier: str = "", **kw):
        self.counts_prefix = counts_prefix
        self.output_path = output_path
        self.size_threshold = size_threshold
        self.identifier = identifier
        super().__init__(**kw)

    def run_impl(self):
        self.run_jobs(None, {
            "counts_prefix": self.counts_prefix,
            "output_path": self.output_path,
            "size_threshold": self.size_threshold,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        ids, totals = merge_block_counts(job_config["tmp_folder"],
                                         cfg["counts_prefix"])
        discard = ids[(totals < cfg["size_threshold"]) & (ids != 0)]
        np.save(cfg["output_path"], discard)
        log_fn(f"discarding {len(discard)} / {len(ids)} ids below size "
               f"{cfg['size_threshold']}")


class FilterBlocksBase(BlockTask):
    """Shared map step: load the discard-id set, zero those ids out blockwise
    (reference: background_size_filter.py:20, filter_blocks.py:25).  The
    filling variant regrows the survivors over a height map instead of
    leaving holes (reference: filling_size_filter.py:21)."""

    filling: bool = False

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str, filter_path: str,
                 hmap_path: str = "", hmap_key: str = "", **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.filter_path = filter_path
        self.hmap_path = hmap_path
        self.hmap_key = hmap_key
        super().__init__(**kw)
        self.device = task_device(self.global_config) if self.filling \
            else None

    def run_impl(self):
        with file_reader(self.input_path, "r") as f:
            shape = list(f[self.input_key].shape)
        block_shape = self.global_block_shape()[-len(shape):]
        with file_reader(self.output_path) as f:
            f.require_dataset(self.output_key, shape=shape,
                              chunks=block_shape, dtype="uint64")
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "filter_path": self.filter_path,
            "hmap_path": self.hmap_path, "hmap_key": self.hmap_key,
            "shape": shape, "block_shape": block_shape,
            "device": self.device,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from ..core.device import resolve_device

        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        ds_in = file_reader(cfg["input_path"], "r")[cfg["input_key"]]
        ds_out = file_reader(cfg["output_path"])[cfg["output_key"]]
        if cfg["filter_path"].endswith(".json"):
            with open(cfg["filter_path"]) as f:
                discard = np.asarray(json.load(f), dtype="uint64")
        else:
            discard = np.load(cfg["filter_path"]).astype("uint64")
        discard = np.sort(discard)
        ds_hmap = None
        if cls.filling and cfg.get("hmap_path"):
            ds_hmap = file_reader(cfg["hmap_path"], "r")[cfg["hmap_key"]]
            device = str(resolve_device(cfg["device"]))

        for block_id in job_config["block_list"]:
            bb = blocking.get_block(block_id).bb
            seg = np.asarray(ds_in[bb])
            if len(discard):
                idx = np.searchsorted(discard, seg)
                hit = (idx < len(discard)) & (
                    discard[np.minimum(idx, len(discard) - 1)] == seg)
                seg = np.where(hit, np.uint64(0), seg)
            if ds_hmap is not None and (seg == 0).any() and (seg != 0).any():
                seg = cls._fill(seg, np.asarray(ds_hmap[bb]).astype("float32"),
                                device=device)
            ds_out[bb] = seg
            log_fn(f"processed block {block_id}")

    @staticmethod
    def _fill(seg: np.ndarray, hmap: np.ndarray,
              device: str = "cuda") -> np.ndarray:
        """Regrow surviving labels into the zeroed voxels over the height
        map (seeded watershed on ``device`` — the watershedsNew fill of
        filling_size_filter.py)."""
        import torch

        from ..ops.rag import densify_labels
        from ..ops.watershed import seeded_watershed

        lut, dense = densify_labels(seg)
        ws = seeded_watershed(torch.from_numpy(hmap).to(device),
                              torch.from_numpy(dense).to(device))
        return lut[ws.cpu().numpy()]


class BackgroundSizeFilter(FilterBlocksBase):
    task_name = "background_size_filter"
    filling = False


class FillingSizeFilter(FilterBlocksBase):
    task_name = "filling_size_filter"
    filling = True


class FilterBlocks(FilterBlocksBase):
    """Zero out an explicit id list (json) blockwise (reference:
    filter_blocks.py:25)."""

    task_name = "filter_blocks"
    filling = False


class IdFilter(BlockTask):
    """Find node ids whose (max-overlap) semantic label is in
    ``filter_labels`` -> json id list (reference: id_filter.py:22)."""

    task_name = "id_filter"
    global_task = True
    allow_retry = False

    def __init__(self, node_label_path: str, node_label_key: str,
                 output_path: str, filter_labels: Sequence[int], **kw):
        self.node_label_path = node_label_path
        self.node_label_key = node_label_key
        self.output_path = output_path
        self.filter_labels = list(filter_labels)
        super().__init__(**kw)

    def run_impl(self):
        self.run_jobs(None, {
            "node_label_path": self.node_label_path,
            "node_label_key": self.node_label_key,
            "output_path": self.output_path,
            "filter_labels": self.filter_labels,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        with file_reader(cfg["node_label_path"], "r") as f:
            node_labels = f[cfg["node_label_key"]][:]
        filter_mask = np.isin(node_labels,
                              np.asarray(cfg["filter_labels"], "uint64"))
        filter_ids = np.flatnonzero(filter_mask)
        write_config(cfg["output_path"], [int(i) for i in filter_ids])
        log_fn(f"filtering {len(filter_ids)} / {len(node_labels)} ids")


class GraphWatershedAssignments(BlockTask):
    """Re-assign discarded fragments by seeded graph watershed over the RAG
    edge weights (reference: graph_watershed_assignments.py:100-180)."""

    task_name = "graph_watershed_assignments"
    global_task = True
    allow_retry = False

    def __init__(self, problem_path: str, graph_key: str, features_key: str,
                 assignment_path: str, assignment_key: str, output_path: str,
                 output_key: str, filter_nodes_path: str,
                 relabel: bool = False, from_costs: bool = False, **kw):
        self.problem_path = problem_path
        self.graph_key = graph_key
        self.features_key = features_key
        self.assignment_path = assignment_path
        self.assignment_key = assignment_key
        self.output_path = output_path
        self.output_key = output_key
        self.filter_nodes_path = filter_nodes_path
        self.relabel = relabel
        self.from_costs = from_costs
        super().__init__(**kw)

    def run_impl(self):
        self.run_jobs(None, {
            "problem_path": self.problem_path, "graph_key": self.graph_key,
            "features_key": self.features_key,
            "assignment_path": self.assignment_path,
            "assignment_key": self.assignment_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "filter_nodes_path": self.filter_nodes_path,
            "relabel": self.relabel, "from_costs": self.from_costs,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from .. import native
        from ..core.graph import load_graph

        cfg = job_config["config"]
        nodes, uv_ids, _ = load_graph(cfg["problem_path"], cfg["graph_key"])
        n_nodes = max(int(nodes.max()) + 1 if len(nodes) else 0,
                      int(uv_ids.max()) + 1 if len(uv_ids) else 0)
        with file_reader(cfg["problem_path"], "r") as f:
            ds = f[cfg["features_key"]]
            feats = (ds[:, 0] if len(ds.shape) == 2 else ds[:]).astype(
                "float64").squeeze()
        if cfg["from_costs"]:
            # costs (attractive > 0) -> [0, 1] boundary probabilities
            feats = feats - feats.min()
            mx = feats.max()
            if mx > 0:
                feats = feats / mx
            feats = 1.0 - feats
        with file_reader(cfg["assignment_path"], "r") as f:
            assignments = f[cfg["assignment_key"]][:].astype("uint64")
        if n_nodes != len(assignments):
            raise ValueError(
                f"graph has {n_nodes} nodes but assignment table has "
                f"{len(assignments)} entries")

        discard_ids = np.load(cfg["filter_nodes_path"])
        if (discard_ids == 0).any():
            raise ValueError("discard ids must not contain the ignore label")
        # temporarily alias segment 0 so background survives the watershed
        seed_offset = np.uint64(int(assignments.max()) + 1)
        assignments[assignments == 0] = seed_offset
        discard_mask = np.isin(assignments, discard_ids.astype("uint64"))
        assignments[discard_mask] = 0
        log_fn(f"discarding {int(discard_mask.sum())} fragments")

        assignments = native.graph_watershed(
            n_nodes, uv_ids, feats, assignments, grow_smallest_first=True)
        assignments[assignments == seed_offset] = 0
        if cfg["relabel"]:
            assignments = _relabel_consecutive(assignments)
        with file_reader(cfg["output_path"]) as f:
            f.require_dataset(cfg["output_key"], data=assignments,
                              chunks=(min(int(1e5), len(assignments)),))
        log_fn(f"graph watershed reassigned; "
               f"{len(np.unique(assignments))} segments")


class OrphanAssignments(BlockTask):
    """Merge degree-one segments into their single neighbor (reference:
    orphan_assignments.py:95-150)."""

    task_name = "orphan_assignments"
    global_task = True
    allow_retry = False

    def __init__(self, graph_path: str, graph_key: str, assignment_path: str,
                 assignment_key: str, output_path: str, output_key: str,
                 relabel: bool = False, **kw):
        self.graph_path = graph_path
        self.graph_key = graph_key
        self.assignment_path = assignment_path
        self.assignment_key = assignment_key
        self.output_path = output_path
        self.output_key = output_key
        self.relabel = relabel
        super().__init__(**kw)

    def run_impl(self):
        self.run_jobs(None, {
            "graph_path": self.graph_path, "graph_key": self.graph_key,
            "assignment_path": self.assignment_path,
            "assignment_key": self.assignment_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "relabel": self.relabel,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from ..core.graph import load_graph, unique_edges

        cfg = job_config["config"]
        _, uv_ids, _ = load_graph(cfg["graph_path"], cfg["graph_key"])
        with file_reader(cfg["assignment_path"], "r") as f:
            assignments = f[cfg["assignment_key"]][:].astype("uint64")

        # segment-level graph (nt.EdgeMapping newUvIds equivalent)
        seg_u = assignments[uv_ids[:, 0]]
        seg_v = assignments[uv_ids[:, 1]]
        keep = (seg_u != seg_v) & (seg_u != 0) & (seg_v != 0)
        new_uv = unique_edges(seg_u[keep], seg_v[keep])
        ids, degrees = np.unique(new_uv, return_counts=True)
        orphans = ids[degrees == 1]
        log_fn(f"found {len(orphans)} orphans of "
               f"{len(np.unique(assignments))} segments")
        if len(orphans):
            # each orphan has exactly one incident edge; remap it to its
            # partner via a flat lookup table (one pass over the volume ids)
            seg_max = int(max(int(assignments.max()), int(new_uv.max())))
            remap = np.arange(seg_max + 1, dtype="uint64")
            lookup = np.sort(orphans)
            hits = []
            for col in (0, 1):
                idx = np.searchsorted(lookup, new_uv[:, col])
                hits.append((idx < len(lookup)) & (
                    lookup[np.minimum(idx, len(lookup) - 1)]
                    == new_uv[:, col]))
            # mutual-orphan pairs (their only edge is to each other) would
            # just swap labels — merge them to the smaller id instead
            both = hits[0] & hits[1]
            remap[new_uv[hits[0] & ~both, 0]] = new_uv[hits[0] & ~both, 1]
            remap[new_uv[hits[1] & ~both, 1]] = new_uv[hits[1] & ~both, 0]
            lo = np.minimum(new_uv[both, 0], new_uv[both, 1])
            remap[new_uv[both, 0]] = lo
            remap[new_uv[both, 1]] = lo
            assignments = remap[assignments]
        if cfg["relabel"]:
            assignments = _relabel_consecutive(assignments)
        with file_reader(cfg["output_path"]) as f:
            f.require_dataset(cfg["output_key"], data=assignments,
                              chunks=(min(int(1e5), len(assignments)),))


class GraphConnectedComponents(BlockTask):
    """Split spatially disconnected segments: connected components of the
    node graph restricted to same-assignment edges (reference:
    graph_connected_components.py via ndist.connectedComponentsFromNodes)."""

    task_name = "graph_connected_components"
    global_task = True
    allow_retry = False

    def __init__(self, problem_path: str, graph_key: str,
                 assignment_path: str, assignment_key: str, output_path: str,
                 output_key: str, **kw):
        self.problem_path = problem_path
        self.graph_key = graph_key
        self.assignment_path = assignment_path
        self.assignment_key = assignment_key
        self.output_path = output_path
        self.output_key = output_key
        super().__init__(**kw)

    def run_impl(self):
        self.run_jobs(None, {
            "problem_path": self.problem_path, "graph_key": self.graph_key,
            "assignment_path": self.assignment_path,
            "assignment_key": self.assignment_key,
            "output_path": self.output_path, "output_key": self.output_key,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from .. import native
        from ..core.graph import load_graph

        cfg = job_config["config"]
        nodes, uv_ids, _ = load_graph(cfg["problem_path"], cfg["graph_key"])
        with file_reader(cfg["assignment_path"], "r") as f:
            assignments = f[cfg["assignment_key"]][:].astype("uint64")
        n_nodes = len(assignments)
        same = (assignments[uv_ids[:, 0]] == assignments[uv_ids[:, 1]]) \
            & (assignments[uv_ids[:, 0]] != 0)
        roots = native.ufd_merge_pairs(n_nodes, uv_ids[same])
        # nodes sharing a root are one (connected) segment; nodes of the
        # same old assignment in different components get split.  +1 keeps a
        # component rooted at node 0 from being erased as background by the
        # relabel below.
        out = np.zeros(n_nodes, "uint64")
        nz = assignments != 0
        out[nz] = roots[nz] + np.uint64(1)
        out = _relabel_consecutive(out)
        n_old = len(np.unique(assignments))
        log_fn(f"split {n_old} segments into {len(np.unique(out))} "
               "connected components")
        with file_reader(cfg["output_path"]) as f:
            f.require_dataset(cfg["output_key"], data=out,
                              chunks=(min(int(1e5), len(out)),))


# ---------------------------------------------------------------------------
# workflows
# ---------------------------------------------------------------------------

class SizeFilterWorkflow(Task):
    """Count sizes -> discard small ids -> background or watershed-fill
    filter -> optional relabel (reference: postprocess_workflow.py:24-120)."""

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str, size_threshold: int, tmp_folder: str,
                 config_dir: str, max_jobs: int = 1, target: str = "gpu",
                 hmap_path: str = "", hmap_key: str = "",
                 relabel: bool = True, dependency: Optional[Task] = None):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.size_threshold = size_threshold
        self.hmap_path = hmap_path
        self.hmap_key = hmap_key
        self.relabel = relabel
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def requires(self):
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                      max_jobs=self.max_jobs, target=self.target)
        counts = BlockCounts(input_path=self.input_path,
                             input_key=self.input_key,
                             identifier="size_filter",
                             dependency=self.dependency, **common)
        discard_path = os.path.join(self.tmp_folder,
                                    "size_filter_discard.npy")
        discard = SizeFilterDiscardIds(
            counts_prefix=counts.name_with_id, output_path=discard_path,
            size_threshold=self.size_threshold, identifier="size_filter",
            dependency=counts, **common)
        filter_cls = FillingSizeFilter if self.hmap_path else \
            BackgroundSizeFilter
        dep: Task = filter_cls(
            input_path=self.input_path, input_key=self.input_key,
            output_path=self.output_path, output_key=self.output_key,
            filter_path=discard_path, hmap_path=self.hmap_path,
            hmap_key=self.hmap_key, dependency=discard, **common)
        if self.relabel:
            dep = RelabelWorkflow(
                input_path=self.output_path, input_key=self.output_key,
                identifier="relabel_size_filter", dependency=dep, **common)
        return dep

    def output(self):
        if self.relabel:
            return FileTarget(os.path.join(self.tmp_folder,
                                           "write_relabel_size_filter.status"))
        name = ("filling_size_filter" if self.hmap_path
                else "background_size_filter")
        return FileTarget(os.path.join(self.tmp_folder, f"{name}.status"))


class FilterLabelsWorkflow(Task):
    """Remove fragments whose max-overlap label (vs a semantic map) is in
    ``filter_labels`` (reference: postprocess_workflow.py:115-162)."""

    def __init__(self, input_path: str, input_key: str, label_path: str,
                 label_key: str, node_label_path: str, node_label_key: str,
                 output_path: str, output_key: str,
                 filter_labels: Sequence[int], tmp_folder: str,
                 config_dir: str, max_jobs: int = 1, target: str = "gpu",
                 dependency: Optional[Task] = None):
        self.input_path = input_path
        self.input_key = input_key
        self.label_path = label_path
        self.label_key = label_key
        self.node_label_path = node_label_path
        self.node_label_key = node_label_key
        self.output_path = output_path
        self.output_key = output_key
        self.filter_labels = list(filter_labels)
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def requires(self):
        from .node_labels import NodeLabelWorkflow

        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                      max_jobs=self.max_jobs, target=self.target)
        labels = NodeLabelWorkflow(
            ws_path=self.input_path, ws_key=self.input_key,
            input_path=self.label_path, input_key=self.label_key,
            output_path=self.node_label_path,
            output_key=self.node_label_key, prefix="filter_labels",
            max_overlap=True, dependency=self.dependency, **common)
        id_filter_path = os.path.join(self.tmp_folder, "filtered_ids.json")
        id_filter = IdFilter(
            node_label_path=self.node_label_path,
            node_label_key=self.node_label_key, output_path=id_filter_path,
            filter_labels=self.filter_labels, dependency=labels, **common)
        return FilterBlocks(
            input_path=self.input_path, input_key=self.input_key,
            output_path=self.output_path, output_key=self.output_key,
            filter_path=id_filter_path, dependency=id_filter, **common)

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder,
                                       "filter_blocks.status"))


class ApplyThreshold(BlockTask):
    """Threshold a per-node feature vector -> filtered-id json (reference:
    postprocess_workflow.py:164-196 ApplyThreshold)."""

    task_name = "apply_threshold"
    global_task = True
    allow_retry = False

    _MODES = ("less", "greater", "equal")

    def __init__(self, feature_path: str, feature_key: str, out_path: str,
                 threshold: float, threshold_mode: str = "less", **kw):
        if threshold_mode not in self._MODES:
            raise ValueError(f"threshold_mode must be one of {self._MODES}")
        self.feature_path = feature_path
        self.feature_key = feature_key
        self.out_path = out_path
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        super().__init__(**kw)

    def run_impl(self):
        self.run_jobs(None, {
            "feature_path": self.feature_path,
            "feature_key": self.feature_key, "out_path": self.out_path,
            "threshold": self.threshold,
            "threshold_mode": self.threshold_mode,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        with file_reader(cfg["feature_path"], "r") as f:
            feats = f[cfg["feature_key"]][:]
        mode = cfg["threshold_mode"]
        if mode == "less":
            mask = feats < cfg["threshold"]
        elif mode == "greater":
            mask = feats > cfg["threshold"]
        else:
            mask = feats == cfg["threshold"]
        filter_ids = np.flatnonzero(mask)
        write_config(cfg["out_path"], [int(i) for i in filter_ids])
        log_fn(f"filtering {len(filter_ids)} / {len(feats)} ids "
               f"({mode} {cfg['threshold']})")


class FilterByThresholdWorkflow(Task):
    """Region features -> threshold -> zero out filtered segments ->
    optional relabel (reference: postprocess_workflow.py:198-250)."""

    def __init__(self, input_path: str, input_key: str, seg_in_path: str,
                 seg_in_key: str, seg_out_path: str, seg_out_key: str,
                 threshold: float, tmp_folder: str, config_dir: str,
                 max_jobs: int = 1, target: str = "gpu",
                 relabel: bool = True, dependency: Optional[Task] = None):
        self.input_path = input_path
        self.input_key = input_key
        self.seg_in_path = seg_in_path
        self.seg_in_key = seg_in_key
        self.seg_out_path = seg_out_path
        self.seg_out_key = seg_out_key
        self.threshold = threshold
        self.relabel = relabel
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def requires(self):
        from .region_features import RegionFeaturesWorkflow

        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                      max_jobs=self.max_jobs, target=self.target)
        feat_path = os.path.join(self.tmp_folder, "reg_feats.n5")
        feats = RegionFeaturesWorkflow(
            input_path=self.input_path, input_key=self.input_key,
            labels_path=self.seg_in_path, labels_key=self.seg_in_key,
            output_path=feat_path, output_key="feats",
            dependency=self.dependency, **common)
        id_filter_path = os.path.join(self.tmp_folder, "filtered_ids.json")
        thresh = ApplyThreshold(
            feature_path=feat_path, feature_key="feats",
            out_path=id_filter_path, threshold=self.threshold,
            dependency=feats, **common)
        dep: Task = FilterBlocks(
            input_path=self.seg_in_path, input_key=self.seg_in_key,
            output_path=self.seg_out_path, output_key=self.seg_out_key,
            filter_path=id_filter_path, dependency=thresh, **common)
        if self.relabel:
            dep = RelabelWorkflow(
                input_path=self.seg_out_path, input_key=self.seg_out_key,
                identifier="relabel_filter", dependency=dep, **common)
        return dep

    def output(self):
        if self.relabel:
            return FileTarget(os.path.join(self.tmp_folder,
                                           "write_relabel_filter.status"))
        return FileTarget(os.path.join(self.tmp_folder,
                                       "filter_blocks.status"))


class ConnectedComponentsWorkflow(Task):
    """GraphConnectedComponents -> optional Write (reference:
    postprocess_workflow.py:296-340)."""

    def __init__(self, problem_path: str, graph_key: str,
                 assignment_path: str, assignment_key: str, output_path: str,
                 assignment_out_key: str, tmp_folder: str, config_dir: str,
                 max_jobs: int = 1, target: str = "gpu", path: str = "",
                 fragments_key: str = "", output_key: str = "",
                 dependency: Optional[Task] = None):
        self.problem_path = problem_path
        self.graph_key = graph_key
        self.assignment_path = assignment_path
        self.assignment_key = assignment_key
        self.output_path = output_path
        self.assignment_out_key = assignment_out_key
        self.path = path
        self.fragments_key = fragments_key
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
        dep: Task = GraphConnectedComponents(
            problem_path=self.problem_path, graph_key=self.graph_key,
            assignment_path=self.assignment_path,
            assignment_key=self.assignment_key,
            output_path=self.output_path,
            output_key=self.assignment_out_key,
            dependency=self.dependency, **common)
        if self.output_key:
            dep = WriteAssignments(
                input_path=self.path, input_key=self.fragments_key,
                output_path=self.output_path, output_key=self.output_key,
                assignment_path=self.output_path,
                assignment_key=self.assignment_out_key,
                identifier="graph_cc", dependency=dep, **common)
        return dep

    def output(self):
        if self.output_key:
            return FileTarget(os.path.join(self.tmp_folder,
                                           "write_graph_cc.status"))
        return FileTarget(os.path.join(self.tmp_folder,
                                       "graph_connected_components.status"))


class FilterOrphansWorkflow(Task):
    """OrphanAssignments -> optional Write (reference:
    postprocess_workflow.py:252-295; upstream marked 'FIXME not debugged',
    this implementation is tested)."""

    def __init__(self, graph_path: str, graph_key: str, path: str,
                 segmentation_key: str, assignment_key: str,
                 output_path: str, assignment_out_key: str, tmp_folder: str,
                 config_dir: str, max_jobs: int = 1, target: str = "gpu",
                 output_key: str = "", relabel: bool = False,
                 dependency: Optional[Task] = None):
        self.graph_path = graph_path
        self.graph_key = graph_key
        self.path = path
        self.segmentation_key = segmentation_key
        self.assignment_key = assignment_key
        self.output_path = output_path
        self.assignment_out_key = assignment_out_key
        self.output_key = output_key
        self.relabel = relabel
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def requires(self):
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                      max_jobs=self.max_jobs, target=self.target)
        dep: Task = OrphanAssignments(
            graph_path=self.graph_path, graph_key=self.graph_key,
            assignment_path=self.path, assignment_key=self.assignment_key,
            output_path=self.output_path,
            output_key=self.assignment_out_key, relabel=self.relabel,
            dependency=self.dependency, **common)
        if self.output_key:
            dep = WriteAssignments(
                input_path=self.path, input_key=self.segmentation_key,
                output_path=self.output_path, output_key=self.output_key,
                assignment_path=self.output_path,
                assignment_key=self.assignment_out_key,
                identifier="filter_orphans", dependency=dep, **common)
        return dep

    def output(self):
        if self.output_key:
            return FileTarget(os.path.join(self.tmp_folder,
                                           "write_filter_orphans.status"))
        return FileTarget(os.path.join(self.tmp_folder,
                                       "orphan_assignments.status"))


class SizeFilterAndGraphWatershedWorkflow(Task):
    """Find small segments, then re-assign their fragments by graph
    watershed instead of deleting them (reference:
    postprocess_workflow.py:342-420)."""

    def __init__(self, problem_path: str, graph_key: str, features_key: str,
                 path: str, segmentation_key: str, assignment_key: str,
                 size_threshold: int, output_path: str,
                 assignment_out_key: str, tmp_folder: str, config_dir: str,
                 max_jobs: int = 1, target: str = "gpu",
                 fragments_key: str = "", output_key: str = "",
                 relabel: bool = False, from_costs: bool = False,
                 dependency: Optional[Task] = None):
        self.problem_path = problem_path
        self.graph_key = graph_key
        self.features_key = features_key
        self.path = path
        self.segmentation_key = segmentation_key
        self.assignment_key = assignment_key
        self.size_threshold = size_threshold
        self.output_path = output_path
        self.assignment_out_key = assignment_out_key
        self.fragments_key = fragments_key
        self.output_key = output_key
        self.relabel = relabel
        self.from_costs = from_costs
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def requires(self):
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                      max_jobs=self.max_jobs, target=self.target)
        counts = BlockCounts(
            input_path=self.path, input_key=self.segmentation_key,
            identifier="gws", dependency=self.dependency, **common)
        discard_path = os.path.join(self.tmp_folder, "discard_ids.npy")
        discard = SizeFilterDiscardIds(
            counts_prefix=counts.name_with_id, output_path=discard_path,
            size_threshold=self.size_threshold, identifier="gws",
            dependency=counts, **common)
        dep: Task = GraphWatershedAssignments(
            problem_path=self.problem_path, graph_key=self.graph_key,
            features_key=self.features_key, assignment_path=self.path,
            assignment_key=self.assignment_key,
            output_path=self.output_path,
            output_key=self.assignment_out_key,
            filter_nodes_path=discard_path, relabel=self.relabel,
            from_costs=self.from_costs, dependency=discard, **common)
        if self.output_key:
            dep = WriteAssignments(
                input_path=self.path, input_key=self.fragments_key,
                output_path=self.output_path, output_key=self.output_key,
                assignment_path=self.output_path,
                assignment_key=self.assignment_out_key,
                identifier="size_filter_gws", dependency=dep, **common)
        return dep

    def output(self):
        if self.output_key:
            return FileTarget(os.path.join(
                self.tmp_folder, "write_size_filter_gws.status"))
        return FileTarget(os.path.join(
            self.tmp_folder, "graph_watershed_assignments.status"))
