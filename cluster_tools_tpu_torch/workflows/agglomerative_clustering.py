"""Global agglomerative clustering of the RAG.

Port of cluster_tools_tpu/workflows/agglomerative_clustering.py (the
reference's ``agglomerative_clustering/`` package,
agglomerative_clustering.py:95-160 — single job: load graph + edge
features, run the edge-weighted cluster policy to a threshold, write the
node assignment table).  The priority-queue agglomeration is the first-party
native kernel (native.agglomerative_clustering, the nifty.graph.agglo
equivalent)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..core import graph as g
from ..core.runtime import BlockTask
from ..core.storage import file_reader


class AgglomerativeClustering(BlockTask):
    """Single-job RAG agglomeration (reference:
    agglomerative_clustering.py:24-92)."""

    task_name = "agglomerative_clustering"
    global_task = True
    allow_retry = False

    def __init__(self, problem_path: str, assignment_path: str,
                 threshold: float, features_key: str = "features",
                 graph_key: str = "s0/graph", **kw):
        self.problem_path = problem_path
        self.assignment_path = assignment_path
        self.threshold = threshold
        self.features_key = features_key
        self.graph_key = graph_key
        super().__init__(**kw)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"size_regularizer": 0.5})
        return conf

    def run_impl(self):
        self.run_jobs(None, {
            "problem_path": self.problem_path,
            "assignment_path": self.assignment_path,
            "threshold": self.threshold,
            "features_key": self.features_key, "graph_key": self.graph_key,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from .. import native

        cfg = job_config["config"]
        nodes, edges, _ = g.load_graph(cfg["problem_path"], cfg["graph_key"])
        graph = g.Graph(nodes, edges)
        uv_dense = np.stack([graph.node_index(edges[:, 0]),
                             graph.node_index(edges[:, 1])], axis=1) \
            if len(edges) else np.zeros((0, 2), "int64")
        with file_reader(cfg["problem_path"], "r") as f:
            ds = f[cfg["features_key"]]
            feats = ds[:]
        edge_weights = feats[:, 0]
        edge_sizes = feats[:, feats.shape[1] - 1]
        labels = native.agglomerative_clustering(
            len(nodes), uv_dense, edge_weights, edge_sizes=edge_sizes,
            threshold=float(cfg["threshold"]),
            size_regularizer=float(cfg.get("size_regularizer", 0.5)))
        log_fn(f"agglomerated {len(nodes)} nodes -> "
               f"{len(np.unique(labels))} clusters at threshold "
               f"{cfg['threshold']}")

        from .multicut import save_assignment_table

        save_assignment_table(nodes, labels, cfg["assignment_path"])
