"""Distributed edge-feature accumulation: the merge task of the fused
chain.

Re-specification of the reference's ``features/`` merge step
(merge_edge_features.py ndist.mergeFeatureBlocks): the per-block feature
tables that ``FeatureTablesToIds`` writes are merged into the global edge
table with count-weighted moments (ops/rag.py merge_feature_blocks).

Feature columns (ops/rag.py FEATURE_NAMES):
    [mean, variance, min, q10, q25, q50, q75, q90, max, count]
Costs consume column 0 (mean probability) and column 9 (edge size), matching
the reference's features[:, 0] / features[:, -1] convention
(costs/probs_to_costs.py).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from ..core import graph as g
from ..core.runtime import BlockTask
from ..core.storage import file_reader

_BLOCK_FEAT_DIR = "block_features"


def _block_feature_path(features_path: str, block_id: int) -> str:
    return os.path.join(features_path, _BLOCK_FEAT_DIR, f"block_{block_id}.npz")


class MergeEdgeFeatures(BlockTask):
    """Merge per-block features into the global edge table, sharded over the
    edge-id space (reference: MergeEdgeFeatures + §2.4.5 label-space
    sharding).  Each job owns a contiguous edge-id chunk and scans the block
    files for rows in its chunk."""

    task_name = "merge_edge_features"

    def __init__(self, graph_path: str, output_path: str,
                 output_key: str = "features", graph_key: str = "graph", **kw):
        self.graph_path = graph_path
        self.output_path = output_path
        self.output_key = output_key
        self.graph_key = graph_key
        super().__init__(**kw)

    def run_impl(self):
        _, edges, attrs = g.load_graph(self.graph_path, self.graph_key)
        n_edges = int(attrs["n_edges"])
        chunk = max(1, (n_edges + self.max_jobs - 1) // self.max_jobs)
        # feature width comes from the already-written block files (10 for
        # plain maps, 9*n_responses+1 for filter-bank features)
        n_feats = 10
        feat_dir = os.path.join(self.output_path, _BLOCK_FEAT_DIR)
        if os.path.isdir(feat_dir):
            for name in sorted(os.listdir(feat_dir)):
                if name.startswith("block_") and name.endswith(".npz"):
                    with np.load(os.path.join(feat_dir, name)) as d:
                        n_feats = int(d["features"].shape[1])
                    break
        with file_reader(self.output_path) as f:
            f.require_dataset(self.output_key, shape=(n_edges, n_feats),
                              chunks=(min(n_edges, 64 * 1024), n_feats),
                              dtype="float64")
        chunks = list(range(0, n_edges, chunk))
        self.run_jobs(chunks, {
            "graph_path": self.graph_path, "output_path": self.output_path,
            "output_key": self.output_key, "n_edges": n_edges, "chunk": chunk,
            "n_feats": n_feats,
        }, n_jobs=self.max_jobs, consecutive_blocks=True)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from ..ops.rag import merge_feature_blocks

        cfg = job_config["config"]
        n_edges, chunk = cfg["n_edges"], cfg["chunk"]
        n_feats = int(cfg.get("n_feats", 10))
        feat_dir = os.path.join(cfg["output_path"], _BLOCK_FEAT_DIR)
        block_files = [os.path.join(feat_dir, n) for n in os.listdir(feat_dir)
                       if n.startswith("block_") and n.endswith(".npz")]
        f_out = file_reader(cfg["output_path"])
        ds = f_out[cfg["output_key"]]
        # one pass over the block files per JOB: each file is read once and
        # its rows binned into every owned edge range (the r1-flagged
        # O(blocks x ranges) re-read pattern scaled as blocks x jobs x
        # ranges_per_job at terabyte volumes)
        ranges = [(e0, min(e0 + chunk, n_edges))
                  for e0 in job_config["block_list"]]
        partials = {e0: [] for e0, _ in ranges}
        for path in block_files:
            with np.load(path) as d:
                ids, feats = d["edge_ids"], d["features"]
            for e0, e1 in ranges:
                sel = (ids >= e0) & (ids < e1)
                if sel.any():
                    partials[e0].append((ids[sel] - e0, feats[sel]))
        for e0, e1 in ranges:
            merged = merge_feature_blocks(partials[e0], e1 - e0, n_feats)
            ds[slice(e0, e1), slice(0, n_feats)] = merged
            log_fn(f"processed block {e0}")
