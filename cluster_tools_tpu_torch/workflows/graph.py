"""Distributed region-adjacency-graph assembly: the host tasks of the
fused chain.

Re-specification of the reference's ``graph/`` package (SURVEY §2.1),
ported for the fused chain: the per-block sub-graphs that
``FusedFaceAssembly`` saves are merged into the global graph
(:class:`MergeSubGraphs`, reference merge_sub_graphs.py:133-141
ndist.mergeSubgraphs) and block edges are mapped to global edge ids
(:class:`MapEdgeIds`, map_edge_ids.py:95-118 ndist.mapEdgeIds) with
vectorized host set operations (core/graph.py).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from ..core import graph as g
from ..core.blocking import Blocking
from ..core.runtime import BlockTask
from ..core.storage import file_reader


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
