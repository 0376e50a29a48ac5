"""Distributed region-adjacency-graph construction.

Port of cluster_tools_tpu/workflows/graph.py (reference ``graph/``
package, SURVEY §2.1): per-block sub-graphs -> hierarchical merge over
scales -> global graph -> block-edge -> global-edge id mapping.  The split
chain extracts each block's sub-graph on the device
(:class:`InitialSubGraphs`: axis-neighbor pairs and their dedup,
ops/rag.py; reference initial_sub_graphs.py:114-118
ndist.computeMergeableRegionGraph); the fused chain saves its sub-graphs
from ``FusedFaceAssembly``.  Both are merged into the global graph
(:class:`MergeSubGraphs`, merge_sub_graphs.py:133-141 ndist.mergeSubgraphs)
and block edges are mapped to global edge ids (:class:`MapEdgeIds`,
map_edge_ids.py:95-118 ndist.mapEdgeIds) with vectorized host set
operations (core/graph.py).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from ..core import graph as g
from ..core.blocking import Blocking
from ..core.device import task_device
from ..core.runtime import BlockTask, prefetch_iter, stage, stream_window
from ..core.storage import file_reader
from ..core.workflow import FileTarget, Task


class InitialSubGraphs(BlockTask):
    """Per-block RAG extraction (reference: InitialSubGraphs,
    initial_sub_graphs.py:21).  Reads the label block with a +1 upper-face
    halo (increaseRoi) so every inter-block face is owned exactly once;
    the pairs and their dedup run on the global config's device, and
    ``impl: "host"`` runs the numpy analog instead."""

    task_name = "initial_sub_graphs"

    def __init__(self, input_path: str, input_key: str, graph_path: str,
                 **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.graph_path = graph_path
        super().__init__(**kw)
        self.device = task_device(self.global_config)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"ignore_label": True})
        return conf

    def run_impl(self):
        with file_reader(self.input_path, "r") as f:
            shape = list(f[self.input_key].shape)
        block_shape = self.global_block_shape()
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "graph_path": self.graph_path,
            "shape": shape, "block_shape": block_shape,
            "device": self.device,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        import torch

        from ..core.device import resolve_device
        from ..ops.rag import (densify_labels, device_edge_stats_finalize,
                               device_edge_stats_submit, host_label_pairs,
                               label_pairs)

        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        ignore_label = bool(cfg.get("ignore_label", True))
        e_max = int(cfg.get("e_max", 65536))
        host_impl = cfg.get("impl") == "host"
        device = None if host_impl else resolve_device(cfg["device"])
        ds = file_reader(cfg["input_path"], "r")[cfg["input_key"]]

        # threaded read look-ahead feeds submit, submit enqueues the
        # block's device work, drain waits and saves: block i+1's transfer
        # and compute overlap block i's readback and IO
        def load(block_id: int):
            block = blocking.get_block(block_id)
            # +1 halo on upper faces only, clipped at the volume border
            end = [min(e + 1, s) for e, s in zip(block.end, cfg["shape"])]
            bb = tuple(slice(b, e) for b, e in zip(block.begin, end))
            with stage("store-read"):
                return block_id, block, np.asarray(ds[bb])

        def submit(entry):
            block_id, block, labels = entry
            if host_impl:
                uniq = np.unique(labels)
                zero_present = bool(len(uniq) and uniq[0] == 0)
                nodes = (uniq if (zero_present and not ignore_label)
                         else uniq[uniq != 0])
                edges = host_label_pairs(labels, ignore_label,
                                         tuple(block.shape))
                return block_id, nodes, None, edges.astype("uint64")
            with stage("host-densify"):
                lut, dense = densify_labels(labels)
            # nodes straight from the densification table (sorted uniques
            # with 0 prepended): no second unique over the block
            zero_present = bool(dense.min() == 0) if dense.size else False
            nodes = lut if (zero_present and not ignore_label) else lut[1:]
            with stage("dispatch"):
                u, v, ok = label_pairs(torch.from_numpy(dense).to(device),
                                       ignore_label=ignore_label,
                                       inner_shape=tuple(block.shape))
                # edge dedup on the device: only the compact edge table
                # is copied back
                handles = device_edge_stats_submit(
                    u, v, torch.zeros_like(u, dtype=torch.float32), ok,
                    e_max=e_max)
            return block_id, nodes, lut, handles

        def drain(entry):
            block_id, nodes, lut, handles = entry
            if lut is None:
                edges = handles
            else:
                with stage("sync-execute"):
                    uv_dense, _ = device_edge_stats_finalize(handles, e_max)
                edges = np.stack([lut[uv_dense[:, 0]], lut[uv_dense[:, 1]]],
                                 axis=1).astype("uint64")
            with stage("store-write"):
                g.save_sub_graph(cfg["graph_path"], 0, block_id,
                                 nodes.astype("uint64"), edges)
            log_fn(f"processed block {block_id}")

        for _ in stream_window(prefetch_iter(job_config["block_list"], load),
                               submit, drain,
                               window=int(cfg.get("stream_window", 3))):
            pass


class MergeSubGraphs(BlockTask):
    """Hierarchical union of child sub-graphs (reference: MergeSubGraphs,
    merge_sub_graphs.py).  At scale s, one merged block covers 2**s base
    blocks per axis; with ``merge_complete_graph`` the single top job writes
    the global graph dataset."""

    task_name = "merge_sub_graphs"

    def __init__(self, graph_path: str, scale: int,
                 merge_complete_graph: bool = False, output_key: str = "graph",
                 input_path: str = "", input_key: str = "", **kw):
        self.graph_path = graph_path
        self.scale = scale
        self.merge_complete_graph = merge_complete_graph
        self.output_key = output_key
        self.input_path = input_path
        self.input_key = input_key
        self.identifier = f"s{scale}" + ("_full" if merge_complete_graph else "")
        super().__init__(**kw)

    def run_impl(self):
        with file_reader(self.input_path, "r") as f:
            shape = list(f[self.input_key].shape)
        base_bs = self.global_block_shape()
        if self.merge_complete_graph:
            self.run_jobs(None, {
                "graph_path": self.graph_path, "scale": self.scale,
                "shape": shape, "block_shape": base_bs,
                "merge_complete_graph": True, "output_key": self.output_key,
                "ignore_label": True,
            })
            return
        factor = 2 ** self.scale
        scale_bs = [b * factor for b in base_bs]
        block_list = self.blocks_in_volume(shape, scale_bs)
        self.run_jobs(block_list, {
            "graph_path": self.graph_path, "scale": self.scale,
            "shape": shape, "block_shape": base_bs,
            "merge_complete_graph": False, "output_key": self.output_key,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        scale = int(cfg["scale"])
        base_bs = cfg["block_shape"]
        shape = cfg["shape"]
        graph_path = cfg["graph_path"]

        if cfg.get("merge_complete_graph"):
            # union every sub-graph at `scale` (scale may be 0: union of all
            # initial blocks)
            src_blocking = (Blocking(shape, [b * 2 ** scale for b in base_bs])
                            if scale > 0 else Blocking(shape, base_bs))
            read_scale = scale
            edge_lists = []
            node_lists = []
            for bid in range(src_blocking.n_blocks):
                data = g.load_sub_graph(graph_path, read_scale, bid)
                edge_lists.append(data["edges"])
                node_lists.append(data["nodes"])
            edges = g.merge_edge_lists(edge_lists)
            nodes = (np.unique(np.concatenate([n for n in node_lists if len(n)]))
                     if any(len(n) for n in node_lists) else np.zeros(0, "uint64"))
            g.save_graph(graph_path, cfg["output_key"], nodes, edges, shape,
                         ignore_label=bool(cfg.get("ignore_label", True)))
            # record the decomposition the sub-graphs were built on: the
            # problem container is self-describing, so the solver stack
            # (SolveSubproblems/ReduceProblem) iterates the SAME grid even
            # when it differs from the global block shape (mesh-resident
            # slabs)
            with file_reader(graph_path) as f:
                f[cfg["output_key"]].attrs["sub_graph_block_shape"] = \
                    list(base_bs)
            log_fn(f"global graph: {len(nodes)} nodes, {len(edges)} edges")
            return

        child_blocking = Blocking(shape, [b * 2 ** (scale - 1) for b in base_bs])
        merged_blocking = Blocking(shape, [b * 2 ** scale for b in base_bs])
        for block_id in job_config["block_list"]:
            block = merged_blocking.get_block(block_id)
            child_ids = child_blocking.blocks_in_roi(block.begin, block.end)
            edge_lists, node_lists = [], []
            for cid in child_ids:
                data = g.load_sub_graph(graph_path, scale - 1, cid)
                edge_lists.append(data["edges"])
                node_lists.append(data["nodes"])
            edges = g.merge_edge_lists(edge_lists)
            nodes = (np.unique(np.concatenate([n for n in node_lists if len(n)]))
                     if any(len(n) for n in node_lists) else np.zeros(0, "uint64"))
            g.save_sub_graph(graph_path, scale, block_id, nodes, edges)
            log_fn(f"processed block {block_id}")


class MapEdgeIds(BlockTask):
    """Map per-block edges to global edge ids at one scale (reference:
    MapEdgeIds, map_edge_ids.py:95-118)."""

    task_name = "map_edge_ids"

    def __init__(self, graph_path: str, scale: int, graph_key: str = "graph",
                 input_path: str = "", input_key: str = "", **kw):
        self.graph_path = graph_path
        self.scale = scale
        self.graph_key = graph_key
        self.input_path = input_path
        self.input_key = input_key
        self.identifier = f"s{scale}"
        super().__init__(**kw)

    def run_impl(self):
        with file_reader(self.input_path, "r") as f:
            shape = list(f[self.input_key].shape)
        base_bs = self.global_block_shape()
        scale_bs = [b * 2 ** self.scale for b in base_bs]
        block_list = self.blocks_in_volume(shape, scale_bs)
        self.run_jobs(block_list, {
            "graph_path": self.graph_path, "scale": self.scale,
            "graph_key": self.graph_key,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        _, global_edges, _ = g.load_graph(cfg["graph_path"], cfg["graph_key"])
        for block_id in job_config["block_list"]:
            data = g.load_sub_graph(cfg["graph_path"], cfg["scale"], block_id)
            edge_ids = g.find_edge_ids(global_edges, data["edges"])
            g.save_sub_graph(cfg["graph_path"], cfg["scale"], block_id,
                             data["nodes"], data["edges"], edge_ids)
            log_fn(f"processed block {block_id}")


class GraphWorkflow(Task):
    """InitialSubGraphs -> MergeSubGraphs (scales) -> final merge ->
    MapEdgeIds per scale (reference: graph_workflow.py:22-64)."""

    def __init__(self, input_path: str, input_key: str, graph_path: str,
                 tmp_folder: str, config_dir: str, max_jobs: int = 1,
                 target: str = "gpu", n_scales: int = 1,
                 output_key: str = "graph", dependency: Optional[Task] = None):
        self.input_path = input_path
        self.input_key = input_key
        self.graph_path = graph_path
        self.n_scales = n_scales
        self.output_key = output_key
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
        dep = InitialSubGraphs(
            input_path=self.input_path, input_key=self.input_key,
            graph_path=self.graph_path, dependency=self.dependency,
            **self._common())
        for scale in range(1, self.n_scales):
            dep = MergeSubGraphs(
                graph_path=self.graph_path, scale=scale,
                input_path=self.input_path, input_key=self.input_key,
                dependency=dep, **self._common())
        dep = MergeSubGraphs(
            graph_path=self.graph_path, scale=self.n_scales - 1,
            merge_complete_graph=True, output_key=self.output_key,
            input_path=self.input_path, input_key=self.input_key,
            dependency=dep, **self._common())
        for scale in range(self.n_scales):
            dep = MapEdgeIds(
                graph_path=self.graph_path, scale=scale,
                graph_key=self.output_key,
                input_path=self.input_path, input_key=self.input_key,
                dependency=dep, **self._common())
        return dep

    def output(self):
        return FileTarget(os.path.join(
            self.tmp_folder, f"map_edge_ids_s{self.n_scales - 1}.status"))
