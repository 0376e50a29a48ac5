"""Multicut solver registry (reference: utils/segmentation_utils.py:22-150).

All solvers take ``(n_nodes, uv_ids, costs)`` over dense node ids and return
a dense uint64 node labeling.  Positive cost = attractive.  The combinatorial
kernels are first-party C++ (cluster_tools_tpu_torch.native), built at first use.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

import numpy as np

from .. import native


def multicut_gaec(n_nodes: int, uv_ids: np.ndarray, costs: np.ndarray,
                  time_limit: Optional[float] = None,
                  n_threads: int = 1) -> np.ndarray:
    return native.multicut_gaec(n_nodes, uv_ids, costs)


def multicut_kernighan_lin(n_nodes: int, uv_ids: np.ndarray,
                           costs: np.ndarray,
                           time_limit: Optional[float] = None,
                           n_threads: int = 1) -> np.ndarray:
    return native.multicut_kernighan_lin(n_nodes, uv_ids, costs,
                                         time_limit=time_limit or 0.0)


def multicut_decomposition(n_nodes: int, uv_ids: np.ndarray,
                           costs: np.ndarray,
                           time_limit: Optional[float] = None,
                           n_threads: int = 4) -> np.ndarray:
    """Decompose into components connected by attractive edges, solve each
    component independently in threads (reference:
    segmentation_utils.py:44-126 and decomposition_multicut/)."""
    uv = np.asarray(uv_ids, dtype="int64").reshape(-1, 2)
    costs = np.asarray(costs, dtype="float64")
    attractive = costs > 0
    comp = native.ufd_merge_pairs(n_nodes, uv[attractive]).astype("int64")
    _, comp = np.unique(comp, return_inverse=True)
    labels = np.zeros(n_nodes, dtype="uint64")

    edge_comp = comp[uv[:, 0]]
    inner = comp[uv[:, 0]] == comp[uv[:, 1]]
    order = np.argsort(edge_comp[inner], kind="stable")
    inner_uv = uv[inner][order]
    inner_costs = costs[inner][order]
    inner_comp = edge_comp[inner][order]
    starts = np.flatnonzero(np.r_[True, inner_comp[1:] != inner_comp[:-1]])
    bounds = np.r_[starts, len(inner_comp)]

    def solve_comp(ci):
        lo, hi = bounds[ci], bounds[ci + 1]
        sub_uv = inner_uv[lo:hi]
        sub_costs = inner_costs[lo:hi]
        nodes = np.unique(sub_uv)
        remap = {n: i for i, n in enumerate(nodes)}
        local_uv = np.array([[remap[u], remap[v]] for u, v in sub_uv],
                            dtype="int64")
        sub = native.multicut_kernighan_lin(len(nodes), local_uv, sub_costs,
                                            time_limit=time_limit or 0.0)
        return nodes, sub

    results = []
    with ThreadPoolExecutor(max(n_threads, 1)) as tp:
        results = list(tp.map(solve_comp, range(len(starts))))

    next_label = 0
    for nodes, sub in results:
        labels[nodes] = sub + next_label
        next_label += int(sub.max()) + 1 if len(sub) else 0
    # singleton / attractive-only-component nodes not covered by inner edges
    uncovered = np.ones(n_nodes, bool)
    for nodes, _ in results:
        uncovered[nodes] = False
    n_unc = int(uncovered.sum())
    labels[uncovered] = np.arange(next_label, next_label + n_unc, dtype="uint64")
    return labels


AGGLOMERATORS: Dict[str, Callable] = {
    "greedy-additive": multicut_gaec,
    "kernighan-lin": multicut_kernighan_lin,
    "decomposition": multicut_decomposition,
    "decomposition-gaec": multicut_decomposition,
    "fusion-moves": multicut_kernighan_lin,  # stub parity (reference :130)
}


def key_to_agglomerator(key: str) -> Callable:
    """Solver lookup (reference: segmentation_utils.py:142)."""
    if key not in AGGLOMERATORS:
        raise KeyError(f"unknown agglomerator {key}; "
                       f"choose from {sorted(AGGLOMERATORS)}")
    return AGGLOMERATORS[key]
