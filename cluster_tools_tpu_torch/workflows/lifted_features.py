"""Sparse lifted problems from biological priors.

Port of cluster_tools_tpu/workflows/lifted_features.py (the reference's
``lifted_features/`` package), host work over the problem's graph files: a
lifted edge connects two fragments that are *not* RAG neighbors but lie
within ``graph_depth`` hops of each other; its cost comes from agreement of semantic
node labels (reference: sparse_lifted_neighborhood.py:107
``ndist.computeLiftedNeighborhoodFromNodeLabels``,
costs_from_node_labels.py:119-139, clear_lifted_edges_from_labels.py:83,
lifted_feature_workflow.py:14-160).

Design: the BFS-by-depth neighborhood is a node-chunked sparse
boolean matrix sweep (scipy CSR on host, memory bounded by the chunk);
costs are a vectorized label-compare over the lifted edge list, sharded
over edge chunks.

Problem-container layout:

    s0/lifted_nh_<prefix>     (L, 2) uint64 lifted pairs
    s0/lifted_costs_<prefix>  (L,) float64
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from ..core.runtime import BlockTask
from ..core.storage import file_reader
from ..core.workflow import FileTarget, Task
from .node_labels import NodeLabelWorkflow


def save_edge_list(path: str, key: str, edges: np.ndarray) -> None:
    """Store an (N, 2) edge list; zero-size datasets are not representable
    in the chunked store, so empty lists are padded to one row with the true
    count in the ``n_edges`` attribute."""
    edges = np.asarray(edges, dtype="uint64").reshape(-1, 2)
    data = edges if len(edges) else np.zeros((1, 2), "uint64")
    with file_reader(path) as f:
        ds = f.require_dataset(key, data=data, shape=data.shape,
                               chunks=(min(int(1e6), len(data)), 2))
        ds.attrs["n_edges"] = int(len(edges))


def load_edge_list(path: str, key: str) -> np.ndarray:
    with file_reader(path, "r") as f:
        ds = f[key]
        n = int(ds.attrs.get("n_edges", ds.shape[0]))
        return ds[:][:n]


def lifted_neighborhood(uv_ids: np.ndarray, n_nodes: int, node_labels:
                        np.ndarray, graph_depth: int, mode: str = "all",
                        ignore_label: int = 0,
                        node_chunk: int = 100_000) -> np.ndarray:
    """All node pairs with graph distance in [2, graph_depth] whose labels
    pass ``mode`` ('all' | 'same' | 'different'); nodes with the ignore
    label never participate (reference semantics of
    computeLiftedNeighborhoodFromNodeLabels).

    BFS runs in source-node chunks: global boolean matrix powers densify as
    degree^depth and would exhaust memory on million-node RAGs; a chunked
    (n_chunk x n_nodes) indicator sweep bounds peak memory by the chunk."""
    from scipy import sparse

    valid = node_labels != ignore_label
    uv = np.asarray(uv_ids, dtype="int64").reshape(-1, 2)
    # drop edges touching invalid nodes: paths THROUGH unlabeled nodes do
    # not create lifted edges between labeled ones
    keep = valid[uv[:, 0]] & valid[uv[:, 1]]
    uv = uv[keep]
    data = np.ones(len(uv), dtype=bool)
    adj = sparse.csr_matrix(
        (data, (uv[:, 0], uv[:, 1])), shape=(n_nodes, n_nodes))
    adj = (adj + adj.T).astype(bool)
    direct = sparse.csr_matrix(
        (np.ones(len(uv), bool),
         (np.minimum(uv[:, 0], uv[:, 1]), np.maximum(uv[:, 0], uv[:, 1]))),
        shape=(n_nodes, n_nodes)).tocsr()

    chunks_out = []
    for lo in range(0, n_nodes, node_chunk):
        hi = min(lo + node_chunk, n_nodes)
        # depth-1 reachability of this source chunk is just a row slice
        reach = adj[lo:hi].astype(bool).copy()
        acc = reach.copy()
        for _ in range(graph_depth - 1):
            reach = (reach @ adj).astype(bool)
            acc = (acc + reach).astype(bool)
        coo = acc.tocoo()
        rows = coo.row.astype("int64") + lo
        cols = coo.col.astype("int64")
        # upper triangle only (each pair reported once globally)
        m = rows < cols
        rows, cols = rows[m], cols[m]
        # minus direct RAG edges
        if len(rows):
            is_direct = np.asarray(
                direct[rows, cols]).ravel().astype(bool)
            rows, cols = rows[~is_direct], cols[~is_direct]
        if len(rows):
            chunks_out.append(
                np.stack([rows, cols], axis=1).astype("uint64"))
    pairs = (np.concatenate(chunks_out) if chunks_out
             else np.zeros((0, 2), "uint64"))
    la = node_labels[pairs[:, 0]]
    lb = node_labels[pairs[:, 1]]
    ok = (la != ignore_label) & (lb != ignore_label)
    if mode == "same":
        ok &= la == lb
    elif mode == "different":
        ok &= la != lb
    elif mode != "all":
        raise ValueError(f"unknown lifted mode {mode}")
    return pairs[ok]


class SparseLiftedNeighborhood(BlockTask):
    """Global task: compute the lifted pair list from the graph + node
    labels (reference: sparse_lifted_neighborhood.py)."""

    task_name = "sparse_lifted_neighborhood"
    global_task = True
    allow_retry = False

    def __init__(self, graph_path: str, graph_key: str, node_label_path: str,
                 node_label_key: str, output_path: str, output_key: str,
                 nh_graph_depth: int = 4, mode: str = "all",
                 node_ignore_label: int = 0, identifier: str = "", **kw):
        self.graph_path = graph_path
        self.graph_key = graph_key
        self.node_label_path = node_label_path
        self.node_label_key = node_label_key
        self.output_path = output_path
        self.output_key = output_key
        self.nh_graph_depth = nh_graph_depth
        self.mode = mode
        self.node_ignore_label = node_ignore_label
        self.identifier = identifier
        super().__init__(**kw)

    def run_impl(self):
        self.run_jobs(None, {
            "graph_path": self.graph_path, "graph_key": self.graph_key,
            "node_label_path": self.node_label_path,
            "node_label_key": self.node_label_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "nh_graph_depth": self.nh_graph_depth, "mode": self.mode,
            "node_ignore_label": self.node_ignore_label,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from ..core.graph import Graph, load_graph

        cfg = job_config["config"]
        nodes, edges, _ = load_graph(cfg["graph_path"], cfg["graph_key"])
        with file_reader(cfg["node_label_path"], "r") as f:
            node_labels = f[cfg["node_label_key"]][:]
        # graph node ids may be non-dense (s0 original labels): map to dense
        graph = Graph(nodes, edges)
        uv_dense = np.stack([graph.node_index(edges[:, 0]),
                             graph.node_index(edges[:, 1])], axis=1) \
            if len(edges) else np.zeros((0, 2), "int64")
        dense_labels = node_labels[nodes.astype("int64")] if len(nodes) else \
            np.zeros(0, node_labels.dtype)
        pairs = lifted_neighborhood(
            uv_dense, len(nodes), dense_labels, cfg["nh_graph_depth"],
            cfg.get("mode", "all"), cfg.get("node_ignore_label", 0))
        # back to original node ids
        pairs = np.stack([nodes[pairs[:, 0].astype("int64")],
                          nodes[pairs[:, 1].astype("int64")]], axis=1) \
            if len(pairs) else np.zeros((0, 2), "uint64")
        save_edge_list(cfg["output_path"], cfg["output_key"], pairs)
        log_fn(f"extracted {len(pairs)} lifted edges at depth "
               f"{cfg['nh_graph_depth']}")


class CostsFromNodeLabels(BlockTask):
    """Lifted costs from label agreement, sharded over edge chunks
    (reference: costs_from_node_labels.py:119-139): attractive
    ``intra_label_cost`` when both nodes carry the same semantic label,
    repulsive ``inter_label_cost`` otherwise."""

    task_name = "costs_from_node_labels"

    def __init__(self, nh_path: str, nh_key: str, node_label_path: str,
                 node_label_key: str, output_path: str, output_key: str,
                 inter_label_cost: float = -12.0,
                 intra_label_cost: float = 12.0, identifier: str = "", **kw):
        self.nh_path = nh_path
        self.nh_key = nh_key
        self.node_label_path = node_label_path
        self.node_label_key = node_label_key
        self.output_path = output_path
        self.output_key = output_key
        self.inter_label_cost = inter_label_cost
        self.intra_label_cost = intra_label_cost
        self.identifier = identifier
        super().__init__(**kw)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"chunk_size": int(1e6)})
        return conf

    def run_impl(self):
        with file_reader(self.nh_path, "r") as f:
            ds = f[self.nh_key]
            n_lifted = int(ds.attrs.get("n_edges", ds.shape[0]))
        chunk_size = int(self.task_config.get("chunk_size", 1e6))
        with file_reader(self.output_path) as f:
            f.require_dataset(self.output_key, shape=(max(n_lifted, 1),),
                              chunks=(min(chunk_size, max(n_lifted, 1)),),
                              dtype="float64")
        self.run_jobs(self.id_chunks(n_lifted, chunk_size), {
            "nh_path": self.nh_path, "nh_key": self.nh_key,
            "node_label_path": self.node_label_path,
            "node_label_key": self.node_label_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "inter_label_cost": self.inter_label_cost,
            "intra_label_cost": self.intra_label_cost,
            "chunk_size": chunk_size, "n_lifted": n_lifted,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        n_lifted = cfg["n_lifted"]
        chunk = cfg["chunk_size"]
        f_nh = file_reader(cfg["nh_path"], "r")
        f_lab = file_reader(cfg["node_label_path"], "r")
        f_out = file_reader(cfg["output_path"])
        ds_nh = f_nh[cfg["nh_key"]]
        node_labels = f_lab[cfg["node_label_key"]][:]
        ds_out = f_out[cfg["output_key"]]
        for block_id in job_config["block_list"]:
            lo = block_id * chunk
            hi = min(lo + chunk, n_lifted)
            if lo >= hi:
                log_fn(f"processed block {block_id}")
                continue
            uv = ds_nh[lo:hi]
            la = node_labels[uv[:, 0].astype("int64")]
            lb = node_labels[uv[:, 1].astype("int64")]
            costs = np.where(la == lb, cfg["intra_label_cost"],
                             cfg["inter_label_cost"]).astype("float64")
            ds_out[lo:hi] = costs
            log_fn(f"processed block {block_id}")


class ClearLiftedEdgesFromLabels(BlockTask):
    """Drop lifted edges whose endpoints carry different *clearing* labels
    — e.g. never keep a lifted edge across a known tissue boundary
    (reference: clear_lifted_edges_from_labels.py:83-120).  Rewrites the
    lifted nh dataset in place; the paired costs dataset (if it exists
    already) must be recomputed afterwards."""

    task_name = "clear_lifted_edges"
    global_task = True
    allow_retry = False

    def __init__(self, node_labels_path: str, node_labels_key: str,
                 lifted_edge_path: str, lifted_edge_key: str,
                 identifier: str = "", **kw):
        self.node_labels_path = node_labels_path
        self.node_labels_key = node_labels_key
        self.lifted_edge_path = lifted_edge_path
        self.lifted_edge_key = lifted_edge_key
        self.identifier = identifier
        super().__init__(**kw)

    def run_impl(self):
        self.run_jobs(None, {
            "node_labels_path": self.node_labels_path,
            "node_labels_key": self.node_labels_key,
            "lifted_edge_path": self.lifted_edge_path,
            "lifted_edge_key": self.lifted_edge_key,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        import shutil

        cfg = job_config["config"]
        with file_reader(cfg["node_labels_path"], "r") as f:
            node_labels = f[cfg["node_labels_key"]][:]
        lifted = load_edge_list(cfg["lifted_edge_path"],
                                cfg["lifted_edge_key"])
        mapped_a = node_labels[lifted[:, 0].astype("int64")]
        mapped_b = node_labels[lifted[:, 1].astype("int64")]
        keep = mapped_a == mapped_b
        new = lifted[keep]
        log_fn(f"cleared lifted edges {len(lifted)} -> {len(new)}")
        if len(new) < len(lifted):
            # shape changes: replace the dataset wholesale
            target = os.path.join(cfg["lifted_edge_path"],
                                  cfg["lifted_edge_key"])
            shutil.rmtree(target)
            save_edge_list(cfg["lifted_edge_path"], cfg["lifted_edge_key"],
                           new)


class LiftedFeaturesFromNodeLabelsWorkflow(Task):
    """NodeLabels(max-overlap) -> SparseLiftedNeighborhood ->
    CostsFromNodeLabels [-> ClearLiftedEdges] (reference:
    lifted_feature_workflow.py:80-160)."""

    def __init__(self, ws_path: str, ws_key: str, labels_path: str,
                 labels_key: str, graph_path: str, graph_key: str,
                 output_path: str, nh_out_key: str, feat_out_key: str,
                 prefix: str, tmp_folder: str, config_dir: str,
                 max_jobs: int = 1, target: str = "gpu",
                 nh_graph_depth: int = 4, mode: str = "all",
                 clear_labels_path: str = "", clear_labels_key: str = "",
                 dependency: Optional[Task] = None):
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.labels_path = labels_path
        self.labels_key = labels_key
        self.graph_path = graph_path
        self.graph_key = graph_key
        self.output_path = output_path
        self.nh_out_key = nh_out_key
        self.feat_out_key = feat_out_key
        self.prefix = prefix
        self.nh_graph_depth = nh_graph_depth
        self.mode = mode
        self.clear_labels_path = clear_labels_path
        self.clear_labels_key = clear_labels_key
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def requires(self):
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                      max_jobs=self.max_jobs, target=self.target)
        labels_key = f"node_overlaps/{self.prefix}"
        dep: Task = NodeLabelWorkflow(
            ws_path=self.ws_path, ws_key=self.ws_key,
            input_path=self.labels_path, input_key=self.labels_key,
            output_path=self.output_path, output_key=labels_key,
            prefix=self.prefix, max_overlap=True,
            dependency=self.dependency, **common)
        dep = SparseLiftedNeighborhood(
            graph_path=self.graph_path, graph_key=self.graph_key,
            node_label_path=self.output_path, node_label_key=labels_key,
            output_path=self.output_path, output_key=self.nh_out_key,
            nh_graph_depth=self.nh_graph_depth, mode=self.mode,
            identifier=self.prefix, dependency=dep, **common)
        if self.clear_labels_path:
            clear_key = f"node_overlaps/clear_{self.prefix}"
            dep = NodeLabelWorkflow(
                ws_path=self.ws_path, ws_key=self.ws_key,
                input_path=self.clear_labels_path,
                input_key=self.clear_labels_key,
                output_path=self.output_path, output_key=clear_key,
                prefix=f"clear_{self.prefix}", max_overlap=True,
                dependency=dep, **common)
            dep = ClearLiftedEdgesFromLabels(
                node_labels_path=self.output_path, node_labels_key=clear_key,
                lifted_edge_path=self.output_path,
                lifted_edge_key=self.nh_out_key, identifier=self.prefix,
                dependency=dep, **common)
        return CostsFromNodeLabels(
            nh_path=self.output_path, nh_key=self.nh_out_key,
            node_label_path=self.output_path, node_label_key=labels_key,
            output_path=self.output_path, output_key=self.feat_out_key,
            identifier=self.prefix, dependency=dep, **common)

    def output(self):
        return FileTarget(os.path.join(
            self.tmp_folder,
            f"costs_from_node_labels_{self.prefix}.status"))
