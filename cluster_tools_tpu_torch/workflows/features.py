"""Distributed edge-feature accumulation.

Port of cluster_tools_tpu/workflows/features.py (reference ``features/``
package): per-block edge statistics from boundary or affinity maps
(:class:`BlockEdgeFeatures`, the split chain; reference
block_edge_features.py:113-141) — the samples at label faces are taken and
reduced per edge on the device (ops/rag.py), only the compact per-edge
tables come back — then the count-weighted merge of the per-block tables
into the global edge table (:class:`MergeEdgeFeatures`,
merge_edge_features.py ndist.mergeFeatureBlocks), which the fused chain's
``FeatureTablesToIds`` tables feed as well.

Feature columns (ops/rag.py FEATURE_NAMES):
    [mean, variance, min, q10, q25, q50, q75, q90, max, count]
Costs consume column 0 (mean probability) and column 9 (edge size), matching
the reference's features[:, 0] / features[:, -1] convention
(costs/probs_to_costs.py).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from ..core import graph as g
from ..core.blocking import Blocking
from ..core.device import task_device
from ..core.runtime import BlockTask, prefetch_iter, stage, stream_window
from ..core.storage import file_reader
from ..core.workflow import FileTarget, Task

_BLOCK_FEAT_DIR = "block_features"


def _block_feature_path(features_path: str, block_id: int) -> str:
    return os.path.join(features_path, _BLOCK_FEAT_DIR, f"block_{block_id}.npz")


class BlockEdgeFeatures(BlockTask):
    """Per-block accumulation (reference: BlockEdgeFeatures).  Boundary maps
    (3d input) sample both face voxels per edge; affinity maps (4d input,
    ``offsets``) sample the offset channel at the anchor.  Integer maps
    are probabilities scaled by the dtype's maximum.  ``impl: "host"``
    runs the numpy analog for boundary maps.  With ``filters`` and
    ``sigmas`` (boundary maps only) each (filter, sigma) response of the
    map contributes a 9-column stat group; the count column is shared and
    written once at the end (reference: block_edge_features.py:165-230
    ``_accumulate_block``)."""

    task_name = "block_edge_features"

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        # filters + sigmas: optional filter-bank features, 9 * n_responses
        # + 1 columns
        conf.update({"e_max": 65536, "filters": None, "sigmas": None})
        return conf

    def __init__(self, input_path: str, input_key: str, labels_path: str,
                 labels_key: str, graph_path: str, output_path: str,
                 offsets: Optional[List[List[int]]] = None,
                 graph_key: str = "graph", **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.labels_path = labels_path
        self.labels_key = labels_key
        self.graph_path = graph_path
        self.graph_key = graph_key
        self.output_path = output_path
        self.offsets = offsets
        super().__init__(**kw)
        self.device = task_device(self.global_config)

    def run_impl(self):
        with file_reader(self.labels_path, "r") as f:
            shape = list(f[self.labels_key].shape)
        block_shape = self.global_block_shape()
        block_list = self.blocks_in_volume(shape, block_shape)
        os.makedirs(os.path.join(self.output_path, _BLOCK_FEAT_DIR),
                    exist_ok=True)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "labels_path": self.labels_path, "labels_key": self.labels_key,
            "graph_path": self.graph_path, "graph_key": self.graph_key,
            "output_path": self.output_path, "offsets": self.offsets,
            "shape": shape, "block_shape": block_shape,
            "device": self.device,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        import torch

        from ..core.device import resolve_device
        from ..ops.filters import apply_filter
        from ..ops.rag import (N_FEATURES, affinity_pair_values,
                               boundary_pair_values, boundary_values,
                               densify_labels,
                               device_edge_stats_finalize,
                               device_edge_stats_submit,
                               device_edge_stats_submit_multi,
                               host_boundary_edge_features)

        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        offsets = cfg.get("offsets")
        host_impl = cfg.get("impl") == "host"
        responses = [(fn, s) for fn in (cfg.get("filters") or [])
                     for s in (cfg.get("sigmas") or [])]
        if responses and offsets is not None:
            raise ValueError("filter-bank features are defined for boundary "
                             "maps only (reference: _accumulate_block)")
        if host_impl and (responses or offsets is not None):
            raise ValueError("impl='host' supports plain boundary features "
                             "only")
        n_feats = 9 * len(responses) + 1 if responses else N_FEATURES
        device = None if host_impl else resolve_device(cfg["device"])
        ds_in = file_reader(cfg["input_path"], "r")[cfg["input_key"]]
        ds_lab = file_reader(cfg["labels_path"], "r")[cfg["labels_key"]]
        # integer inputs are quantized probabilities scaled by the dtype's
        # full range (uint8 -> /255, uint16 -> /65535, ...)
        if np.issubdtype(ds_in.dtype, np.signedinteger):
            raise ValueError(
                f"signed integer probability maps are not supported "
                f"(got {ds_in.dtype})")
        scale = (float(np.iinfo(ds_in.dtype).max)
                 if np.issubdtype(ds_in.dtype, np.integer) else 1.0)
        global_edges = None
        if offsets is not None:
            # affinity anchors are owned per voxel, so an anchor's edge may
            # live in a neighboring block's sub-graph: samples map straight
            # to GLOBAL edge ids (graph loaded once per job)
            _, global_edges, _ = g.load_graph(cfg["graph_path"],
                                              cfg.get("graph_key", "graph"))
        e_max = int(cfg.get("e_max", 65536))

        def load(block_id: int):
            """Host IO only (runs on the prefetch threads): geometry, label
            and map reads, sub-graph load."""
            block = blocking.get_block(block_id)
            if offsets is None:
                begin = list(block.begin)
                end = [min(e + 1, s) for e, s in zip(block.end, cfg["shape"])]
            else:
                # two-sided halo covering the longest offset (negative
                # offsets reach backwards from anchors in the inner block)
                reach = np.abs(np.asarray(offsets)).max(axis=0)
                begin = [max(b - int(r), 0)
                         for b, r in zip(block.begin, reach)]
                end = [min(e + int(r), s)
                       for e, r, s in zip(block.end, reach, cfg["shape"])]
            bb = tuple(slice(b, e) for b, e in zip(begin, end))
            data = g.load_sub_graph(cfg["graph_path"], 0, block_id)
            if len(data["edges"]) == 0 and offsets is None:
                # empty sub-graph: no read needed (affinity mode still
                # proceeds — the block may own seam anchors)
                return block_id, None, None, None, None, None, None, data
            obegin = begin
            with stage("store-read"):
                labels = np.asarray(ds_lab[bb])
                if responses:
                    # the support halo covers the whole kernel radius
                    # (truncate 4.0), so blockwise responses equal the
                    # global ones
                    halo_v = int(4.0 * max(cfg["sigmas"]) + 0.5) + 1
                    obegin = [max(b - halo_v, 0) for b in begin]
                    oend = [min(e + halo_v, s)
                            for e, s in zip(end, cfg["shape"])]
                    raw = np.asarray(ds_in[tuple(
                        slice(b, e) for b, e in zip(obegin, oend))])
                elif offsets is None:
                    raw = np.asarray(ds_in[bb])
                else:
                    raw = np.asarray(ds_in[(slice(0, len(offsets)),) + bb])
            return block_id, block, begin, end, obegin, labels, raw, data

        def submit(entry):
            block_id, block, begin, end, obegin, labels, raw, data = entry
            if block is None:
                return block_id, None, None, None
            if host_impl:
                uv, feats = host_boundary_edge_features(
                    labels, raw.astype("float32") / scale,
                    inner_shape=tuple(block.shape))
                return block_id, None, data, (uv, feats)
            with stage("host-densify"):
                lut, dense = densify_labels(labels)
                vals = raw.astype("float32") / scale
            with stage("dispatch"):
                dense_dev = torch.from_numpy(dense).to(device)
                vals_dev = torch.from_numpy(vals).to(device)
                if responses:
                    # one response per (filter, sigma) over the halo'd
                    # block, cropped to the label window; the pairs come
                    # from the labels alone, so they are extracted once
                    # and only the values are gathered per response
                    local = tuple(slice(b - ob, e - ob)
                                  for b, ob, e in zip(begin, obegin, end))
                    resp = [apply_filter(vals_dev, fn, s)[local]
                            for fn, s in responses]
                    u, v, _, ok = boundary_pair_values(
                        dense_dev, resp[0], inner_shape=tuple(block.shape))
                    handles = device_edge_stats_submit_multi(
                        u, v, ok, [boundary_values(r) for r in resp],
                        e_max=e_max)
                    return block_id, lut, data, handles
                if offsets is None:
                    u, v, val, ok = boundary_pair_values(
                        dense_dev, vals_dev, inner_shape=tuple(block.shape))
                else:
                    u, v, val, ok = affinity_pair_values(
                        dense_dev, vals_dev, offsets,
                        inner_begin=tuple(b - bo for b, bo in
                                          zip(block.begin, begin)),
                        inner_shape=tuple(block.shape))
                # per-edge reduction on the device: only the compact (uv,
                # stats) tables come back
                handles = device_edge_stats_submit(u, v, val, ok,
                                                   e_max=e_max)
            return block_id, lut, data, handles

        def drain(entry):
            block_id, lut, data, handles = entry
            if data is None:
                np.savez(_block_feature_path(cfg["output_path"], block_id),
                         edge_ids=np.zeros(0, "int64"),
                         features=np.zeros((0, n_feats), "float64"))
                log_fn(f"processed block {block_id}")
                return
            if lut is None:
                uv, edge_feats = handles
            else:
                with stage("sync-execute"):
                    if responses:
                        groups = [device_edge_stats_finalize(h, e_max)
                                  for h in handles]
                        uv_dense = groups[0][0]
                        edge_feats = np.concatenate(
                            [f[:, :9] for _, f in groups]
                            + [groups[-1][1][:, 9:10]], axis=1)
                    else:
                        uv_dense, edge_feats = device_edge_stats_finalize(
                            handles, e_max)
                uv = np.stack([lut[uv_dense[:, 0]], lut[uv_dense[:, 1]]],
                              axis=1)
            if offsets is None:
                # boundary faces share the RAG's ownership rule, so every
                # edge maps into the block's own sub-graph
                local_ids = g.find_edge_ids(data["edges"], uv)
                feats = np.zeros((len(data["edges"]), n_feats), "float64")
                feats[local_ids] = edge_feats
                out_ids = data["edge_ids"]
            else:
                # global mapping; long-range pairs that are not RAG edges
                # anywhere are dropped
                gids = g.find_edge_ids(global_edges, uv, strict=False)
                keep = gids >= 0
                out_ids, feats = gids[keep], edge_feats[keep]
            with stage("store-write"):
                np.savez(_block_feature_path(cfg["output_path"], block_id),
                         edge_ids=out_ids.astype("int64"), features=feats)
            log_fn(f"processed block {block_id}")

        for _ in stream_window(prefetch_iter(job_config["block_list"], load),
                               submit, drain,
                               window=int(cfg.get("stream_window", 3))):
            pass


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


class EdgeFeaturesWorkflow(Task):
    """BlockEdgeFeatures -> MergeEdgeFeatures (reference:
    features_workflow.py:33-59)."""

    def __init__(self, input_path: str, input_key: str, labels_path: str,
                 labels_key: str, graph_path: str, output_path: str,
                 tmp_folder: str, config_dir: str, max_jobs: int = 1,
                 target: str = "gpu", output_key: str = "features",
                 offsets: Optional[List[List[int]]] = None,
                 graph_key: str = "graph",
                 dependency: Optional[Task] = None):
        self.kw = dict(tmp_folder=tmp_folder, config_dir=config_dir,
                       max_jobs=max_jobs, target=target)
        self.args = dict(input_path=input_path, input_key=input_key,
                         labels_path=labels_path, labels_key=labels_key,
                         graph_path=graph_path, output_path=output_path)
        self.output_key = output_key
        self.offsets = offsets
        self.graph_key = graph_key
        self.tmp_folder = tmp_folder
        self.dependency = dependency
        super().__init__()

    def requires(self):
        t1 = BlockEdgeFeatures(offsets=self.offsets,
                               graph_key=self.graph_key,
                               dependency=self.dependency,
                               **self.args, **self.kw)
        return MergeEdgeFeatures(
            graph_path=self.args["graph_path"],
            output_path=self.args["output_path"],
            output_key=self.output_key, graph_key=self.graph_key,
            dependency=t1, **self.kw)

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder,
                                       "merge_edge_features.status"))
