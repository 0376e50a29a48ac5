"""The plain multicut solver: greedy additive edge contraction (Keuper et
al. 2015) and a refinement by greedy node moves, plain Python.

``gaec`` contracts the most attractive edge while one has a positive
cost, summing parallel edges.  ``refine`` then moves single nodes to the
adjacent segment, or to a segment of their own, that lowers the objective
most, until a pass moves none: the node moves of a Kernighan-Lin pass.
Positive cost = attractive; the objective is the summed cost of the cut
edges, to be minimized.  Both return a dense node labelling.  ``lowp``
rounds every sum and difference of costs to bfloat16 (the control).
"""

from __future__ import annotations

import heapq
import struct

import numpy as np


MAX_PASSES = 1000


def _bf16(x: float) -> float:
    """``x`` rounded to the nearest bfloat16 (ties to even)."""
    b = struct.unpack("<I", struct.pack("<f", x))[0]
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return struct.unpack("<f", struct.pack("<I", b))[0]


def _add(lowp: bool):
    return (lambda a, b: _bf16(a + b)) if lowp else (lambda a, b: a + b)


def gaec(n_nodes: int, uv: np.ndarray, costs: np.ndarray,
         lowp: bool = False) -> np.ndarray:
    add = _add(lowp)
    adj = [dict() for _ in range(n_nodes)]
    for (u, v), c in zip(np.asarray(uv, "int64").tolist(),
                         np.asarray(costs, "float64").tolist()):
        if u == v:
            continue
        adj[u][v] = add(adj[u].get(v, 0.0), c)
        adj[v][u] = adj[u][v]
    parent = list(range(n_nodes))
    heap = [(-c, u, v) for u in range(n_nodes) for v, c in adj[u].items()
            if u < v and c > 0]
    heapq.heapify(heap)
    alive = [True] * n_nodes
    while heap:
        neg, u, v = heapq.heappop(heap)
        if not (alive[u] and alive[v]) or adj[u].get(v) != -neg:
            continue
        if len(adj[u]) < len(adj[v]):
            u, v = v, u
        # merge v into u
        alive[v] = False
        parent[v] = u
        del adj[u][v]
        for w, c in adj[v].items():
            if w == u:
                continue
            del adj[w][v]
            nc = add(adj[u].get(w, 0.0), c)
            adj[u][w] = nc
            adj[w][u] = nc
            if nc > 0:
                heapq.heappush(heap, (-nc, min(u, w), max(u, w)))
        adj[v] = {}
    labels = np.arange(n_nodes)
    for i in range(n_nodes):
        r = i
        while parent[r] != r:
            r = parent[r]
        labels[i] = r
    return np.unique(labels, return_inverse=True)[1]


def objective(uv: np.ndarray, costs: np.ndarray, labels: np.ndarray) -> float:
    """Summed cost of the edges whose nodes lie in different segments."""
    uv = np.asarray(uv, "int64")
    lab = np.asarray(labels)
    cut = lab[uv[:, 0]] != lab[uv[:, 1]]
    return float(np.asarray(costs, "float64")[cut].sum())


def refine(uv: np.ndarray, costs: np.ndarray, labels: np.ndarray,
           lowp: bool = False) -> np.ndarray:
    add = _add(lowp)
    sub = (lambda a, b: _bf16(a - b)) if lowp else (lambda a, b: a - b)
    n = len(labels)
    nbrs = [[] for _ in range(n)]
    for (u, v), c in zip(np.asarray(uv, "int64").tolist(),
                         np.asarray(costs, "float64").tolist()):
        if u != v:
            nbrs[u].append((v, c))
            nbrs[v].append((u, c))
    lab = np.asarray(labels, "int64").tolist()
    fresh = max(lab, default=-1) + 1
    # every move lowers the objective; the cap only guards against cycles
    # of moves that bfloat16 sums (lowp) could make
    for _ in range(MAX_PASSES):
        moved = False
        for x in range(n):
            if not nbrs[x]:
                continue
            w = {}
            for y, c in nbrs[x]:
                w[lab[y]] = add(w.get(lab[y], 0.0), c)
            own = lab[x]
            w_own = w.get(own, 0.0)
            # gain of a segment of its own, then of each adjacent segment
            best_gain, best = -w_own, fresh
            for seg, c in w.items():
                if seg != own and sub(c, w_own) > best_gain:
                    best_gain, best = sub(c, w_own), seg
            if best_gain > 1e-9:
                lab[x] = best
                fresh += best == fresh
                moved = True
        if not moved:
            break
    return np.unique(np.asarray(lab), return_inverse=True)[1]


def solve(n_nodes: int, uv: np.ndarray, costs: np.ndarray,
          lowp: bool = False) -> np.ndarray:
    """The reference multicut: ``gaec`` then ``refine``."""
    return refine(uv, costs, gaec(n_nodes, uv, costs, lowp), lowp=lowp)
