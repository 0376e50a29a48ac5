"""Host-side graph objects + serialization — the ndist graph-engine surface.

The reference keeps its distributed graph in C++ behind
``nifty.distributed`` (file-backed ``Graph``, ``mergeSubgraphs``,
``mapEdgeIds``, ``serializeMergedGraph`` — SURVEY §2.3).  The rebuild
re-specifies that as (a) on-device edge extraction (ops/rag.py) and (b) flat
numpy arrays + vectorized set operations on the host, serialized into the
problem container:

    <path>/s<scale>/sub_graphs/block_<id>.npz   (nodes, edges, edge_ids)
    <path>/<graph_key>: zarr group with `nodes`, `edges` datasets and
        attrs {n_nodes, n_edges, shape, ignore_label}

Edge arrays are (E, 2) uint64, canonicalized u < v, sorted lexicographically
— the invariant every lookup below relies on.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from .runtime import stage
from .storage import file_reader


def unique_edges(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Canonicalize + dedupe pair lists into sorted (E, 2) uint64."""
    if len(u) == 0:
        return np.zeros((0, 2), dtype="uint64")
    uv = np.stack([np.minimum(u, v), np.maximum(u, v)], axis=1).astype("uint64")
    return np.unique(uv, axis=0)


def _pack(uv: np.ndarray) -> np.ndarray:
    """View (E, 2) uint64 rows as one void scalar per row (for searchsorted)."""
    uv = np.ascontiguousarray(uv.astype("uint64"))
    return uv.view([("u", "uint64"), ("v", "uint64")]).reshape(-1)


def find_edge_ids(global_uv: np.ndarray, query_uv: np.ndarray,
                  strict: bool = True) -> np.ndarray:
    """Row index of each query edge in the (sorted) global edge list — the
    ndist.mapEdgeIds equivalent.  ``strict`` raises on missing edges;
    otherwise missing entries get id -1 (used by affinity accumulation,
    where long-range pairs may connect non-adjacent segments)."""
    if len(query_uv) == 0:
        return np.zeros(0, dtype="int64")
    g = _pack(global_uv)
    q = _pack(query_uv)
    if len(g) == 0:
        if strict:
            raise ValueError("empty global graph")
        return np.full(len(q), -1, dtype="int64")
    ids = np.searchsorted(g, q)
    missing = (ids >= len(g)) | (g[np.minimum(ids, len(g) - 1)] != q)
    if missing.any():
        if strict:
            raise ValueError(
                f"{int(missing.sum())} query edges not present in global graph")
        ids = np.where(missing, -1, ids)
    return ids.astype("int64")


def merge_edge_lists(edge_lists: Sequence[np.ndarray]) -> np.ndarray:
    nonempty = [e for e in edge_lists if len(e)]
    if not nonempty:
        return np.zeros((0, 2), dtype="uint64")
    return np.unique(np.concatenate(nonempty, axis=0), axis=0)


# ---------------------------------------------------------------------------
# container layout
# ---------------------------------------------------------------------------

def sub_graph_path(graph_path: str, scale: int, block_id: int) -> str:
    return os.path.join(graph_path, f"s{scale}", "sub_graphs",
                        f"block_{block_id}.npz")


def save_sub_graph(graph_path: str, scale: int, block_id: int,
                   nodes: np.ndarray, edges: np.ndarray,
                   edge_ids: Optional[np.ndarray] = None) -> None:
    path = sub_graph_path(graph_path, scale, block_id)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    data = {"nodes": nodes.astype("uint64"), "edges": edges.astype("uint64")}
    if edge_ids is not None:
        data["edge_ids"] = edge_ids.astype("int64")
    tmp = path + ".tmp.npz"
    with stage("tmp-write"):
        np.savez(tmp, **data)
        os.replace(tmp, path)


def load_sub_graph(graph_path: str, scale: int, block_id: int):
    with stage("tmp-read"), \
            np.load(sub_graph_path(graph_path, scale, block_id)) as d:
        return {k: d[k] for k in d.files}


def append_edge_ids(graph_path: str, scale: int, block_id: int,
                    edge_ids: np.ndarray) -> None:
    data = load_sub_graph(graph_path, scale, block_id)
    save_sub_graph(graph_path, scale, block_id, data["nodes"], data["edges"],
                   edge_ids)


def save_graph(graph_path: str, key: str, nodes: np.ndarray,
               edges: np.ndarray, shape: Sequence[int],
               ignore_label: bool = True) -> None:
    """Serialize the global graph into the zarr/n5 container."""
    with file_reader(graph_path) as f:
        g = f.require_group(key)
        if len(nodes):
            ds = g.require_dataset("nodes", shape=(len(nodes),),
                                   chunks=(max(len(nodes), 1),), dtype="uint64")
            ds[:] = nodes.astype("uint64")
        if len(edges):
            ds = g.require_dataset("edges", shape=edges.shape,
                                   chunks=(max(len(edges), 1), 2), dtype="uint64")
            ds[:] = edges.astype("uint64")
        g.attrs.update({"n_nodes": int(len(nodes)), "n_edges": int(len(edges)),
                        "shape": list(shape), "ignore_label": bool(ignore_label)})


def load_graph(graph_path: str, key: str):
    """Load (nodes, edges, attrs) of a serialized graph."""
    with file_reader(graph_path, "r") as f:
        g = f[key]
        attrs = {k: g.attrs[k] for k in ("n_nodes", "n_edges", "shape",
                                         "ignore_label") if k in g.attrs}
        nodes = g["nodes"][:] if int(attrs.get("n_nodes", 0)) else \
            np.zeros(0, "uint64")
        edges = g["edges"][:] if int(attrs.get("n_edges", 0)) else \
            np.zeros((0, 2), "uint64")
    return nodes, edges, attrs


class Graph:
    """In-memory undirected graph over uint64 node labels (the
    ndist.Graph/nifty.undirectedGraph stand-in used by the solver layer).

    Node ids need not be consecutive; ``node_index(labels)`` maps labels to
    dense [0, n) indices via the sorted node table.
    """

    def __init__(self, nodes: np.ndarray, edges: np.ndarray):
        self.nodes = np.asarray(nodes, dtype="uint64")
        self.uv_ids = np.asarray(edges, dtype="uint64").reshape(-1, 2)
        self._packed = _pack(self.uv_ids) if len(self.uv_ids) else None

    @classmethod
    def load(cls, graph_path: str, key: str) -> "Graph":
        nodes, edges, _ = load_graph(graph_path, key)
        return cls(nodes, edges)

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def n_edges(self) -> int:
        return len(self.uv_ids)

    def node_index(self, labels: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(self.nodes, labels)
        if len(self.nodes) and ((idx >= len(self.nodes)).any()
                                or (self.nodes[np.minimum(idx, len(self.nodes) - 1)]
                                    != labels).any()):
            raise ValueError("labels not present in graph")
        return idx.astype("int64")

    def extract_subgraph(self, node_labels: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """(inner_edge_ids, outer_edge_ids): edges with both / exactly one
        endpoint in ``node_labels`` (reference:
        graph.extractSubgraphFromNodes, multicut/solve_subproblems.py:151)."""
        node_labels = np.asarray(node_labels, dtype="uint64")
        if len(node_labels) == 0 or self.n_edges == 0:
            return np.zeros(0, "int64"), np.zeros(0, "int64")
        lookup = np.sort(node_labels)
        iu = np.minimum(np.searchsorted(lookup, self.uv_ids[:, 0]),
                        len(lookup) - 1)
        iv = np.minimum(np.searchsorted(lookup, self.uv_ids[:, 1]),
                        len(lookup) - 1)
        in_u = lookup[iu] == self.uv_ids[:, 0]
        in_v = lookup[iv] == self.uv_ids[:, 1]
        inner = np.flatnonzero(in_u & in_v).astype("int64")
        outer = np.flatnonzero(in_u ^ in_v).astype("int64")
        return inner, outer
