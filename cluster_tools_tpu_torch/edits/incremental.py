"""Incremental re-solve of an edited multicut problem.

An :class:`EditSession` holds the s0 problem in memory as a cost overlay:
a merge biases every edge between the edited fragments strongly
attractive, a split strongly repulsive (edges that do not exist yet are
appended past the base edge list, so persisted edge ids never move).
``solve`` then re-runs the blockwise ladder, but re-solves ONLY the
subproblems whose content signature no longer matches a cached solution
— everything else warm-starts from the in-memory cache or the
sub_results persisted by ``SolveSubproblems`` (which stamps the same
signature, workflows/multicut.py).

The safety contract is validate-then-reuse, never trust-the-cache: a
signature mismatch on a block OUTSIDE the edit's resolved footprint
means the persisted solution no longer describes the live problem
(stale cache); the session falls back to a full subproblem solve for
that block — wrong output is impossible, only wasted work — counts it,
and dumps a flight record carrying the edit's correlation id so the
incident is diagnosable post-hoc.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core import graph as g
from ..core import telemetry
from ..core.blocking import Blocking
from ..core.runtime import stage
from ..core.solvers import key_to_agglomerator
from ..workflows import multicut as mc
from . import resolver

#: magnitude of the cost bias an edit places on an edge — far beyond any
#: accumulated boundary evidence, so a single edit decision dominates the
#: subproblem objective without resorting to +/-inf (which the solvers'
#: float arithmetic must never see)
EDIT_COST = 1.0e6


class EditSession:
    """In-memory incremental re-segmentation over one problem container.

    Single-writer by design: the resident server serializes scheduling
    quanta, so session state is only ever mutated from one worker thread.
    Only flat (``n_scales == 1``-style) containers are supported — the
    session re-runs reduce+global itself after the per-block stage, which
    is exactly what the committed workflow does at that depth.
    """

    def __init__(self, problem_path: str, *,
                 fallback_block_shape: Optional[Sequence[int]] = None,
                 agglomerator: str = "kernighan-lin",
                 time_limit: Optional[float] = None,
                 flight_dir: Optional[str] = None,
                 paintera_path: Optional[str] = None,
                 paintera_lookup_key: Optional[str] = None,
                 paintera_block_shape: Optional[Sequence[int]] = None):
        self.problem_path = problem_path
        self.flight_dir = flight_dir
        self.paintera_path = paintera_path
        self.paintera_lookup_key = paintera_lookup_key
        self.paintera_block_shape = paintera_block_shape
        self._agglomerator_key = agglomerator
        self._time_limit = time_limit

        uv_dense, n_nodes, s0_nodes = mc._load_scale_graph(problem_path, 0)
        self.base_uv = uv_dense.astype("int64")
        self.n_nodes = int(n_nodes)
        self.s0_nodes = s0_nodes
        self.costs = mc._load_costs(problem_path, 0).astype("float64").copy()
        shape, base_bs = mc._problem_geometry(
            problem_path, fallback_block_shape or [64, 64, 64])
        self.shape, self.block_shape = shape, base_bs
        self.blocking = Blocking(shape, base_bs)

        # cost/edge overlay: extra edges append past the base list so base
        # edge ids (and with them every persisted sub_result) stay valid
        self.extra_uv = np.zeros((0, 2), "int64")
        self.extra_costs = np.zeros(0, "float64")
        self._extra_index: Dict[Tuple[int, int], int] = {}
        self._graph: Optional[g.Graph] = None
        self._graph_n_extra = -1

        self._block_nodes: Dict[int, np.ndarray] = {}
        #: block id -> (content signature, cut edge ids over combined list)
        self._cache: Dict[int, Tuple[str, np.ndarray]] = {}
        self.counters = {"applied": 0, "subproblems_solved": 0,
                         "warm_reused": 0, "fallback": 0}

    # -- combined (base + overlay) problem ---------------------------------

    def combined_uv(self) -> np.ndarray:
        if len(self.extra_uv) == 0:
            return self.base_uv
        return np.concatenate([self.base_uv, self.extra_uv], axis=0)

    def combined_costs(self) -> np.ndarray:
        if len(self.extra_costs) == 0:
            return self.costs
        return np.concatenate([self.costs, self.extra_costs])

    def _graph_obj(self) -> g.Graph:
        if self._graph is None or self._graph_n_extra != len(self.extra_uv):
            self._graph = g.Graph(np.arange(self.n_nodes, dtype="uint64"),
                                  self.combined_uv().astype("uint64"))
            self._graph_n_extra = len(self.extra_uv)
        return self._graph

    # -- fragment / block geometry -----------------------------------------

    def dense_index(self, fragments: Sequence[int]) -> np.ndarray:
        """Dense node ids of original fragment labels; raises on unknown
        fragments (an edit against labels the graph never saw is a client
        error, not something to paper over)."""
        labs = np.asarray(list(fragments), dtype="uint64")
        idx = np.searchsorted(self.s0_nodes, labs)
        bad = (idx >= len(self.s0_nodes)) | (self.s0_nodes[
            np.minimum(idx, len(self.s0_nodes) - 1)] != labs)
        if bad.any():
            raise ValueError(
                f"unknown fragment ids {labs[bad][:10].tolist()} "
                f"(not in the s0 node table)")
        return idx.astype("int64")

    def block_nodes(self, block_id: int) -> np.ndarray:
        if block_id not in self._block_nodes:
            self._block_nodes[block_id] = resolver.load_block_nodes(
                self.problem_path, 0, block_id)
        return self._block_nodes[block_id]

    def affected_blocks(self, fragments: Sequence[int]) -> List[int]:
        """Minimal re-solve set for an edit on ``fragments`` (resolver
        criterion: blocks whose node set holds >= 2 of them)."""
        return resolver.resolve_affected(
            self.problem_path, fragments,
            fallback_block_shape=self.block_shape,
            paintera_path=self.paintera_path,
            paintera_lookup_key=self.paintera_lookup_key,
            paintera_block_shape=self.paintera_block_shape,
            node_loader=self.block_nodes)

    def blocks_with_fragments(self, fragments: Sequence[int]) -> List[int]:
        """Blocks whose node set intersects ``fragments`` at all — the
        output blocks the patcher must rewrite after a LUT delta."""
        frs = np.unique(np.asarray(list(fragments), dtype="uint64"))
        return [bid for bid in range(self.blocking.n_blocks)
                if len(self.block_nodes(bid))
                and bool(np.isin(self.block_nodes(bid), frs).any())]

    # -- applying edits ----------------------------------------------------

    def apply_edit(self, record) -> List[int]:
        """Overlay one :class:`~..edits.log.EditRecord` onto the costs;
        returns the affected subproblem blocks.  Deterministic, so
        replaying the log reconstructs the same state."""
        bias = EDIT_COST if record.op == "merge" else -EDIT_COST
        dense = self.dense_index(record.fragments)
        pairs = np.asarray([(min(a, b), max(a, b))
                            for a, b in itertools.combinations(dense, 2)],
                           dtype="int64").reshape(-1, 2)
        eids = g.find_edge_ids(self.base_uv.astype("uint64"),
                               pairs.astype("uint64"), strict=False)
        for (u, v), eid in zip(map(tuple, pairs), eids):
            if eid >= 0:
                self.costs[eid] = bias
            elif (u, v) in self._extra_index:
                self.extra_costs[self._extra_index[(u, v)]] = bias
            else:
                self._extra_index[(u, v)] = len(self.extra_uv)
                self.extra_uv = np.concatenate(
                    [self.extra_uv, np.asarray([[u, v]], "int64")], axis=0)
                self.extra_costs = np.concatenate(
                    [self.extra_costs, np.asarray([bias], "float64")])
        self.counters["applied"] += 1
        return self.affected_blocks(record.fragments)

    # -- per-block solve / warm-start --------------------------------------

    def block_signature(self, block_id: int):
        """(signature, dense nodes, inner ids, outer ids) of the block's
        LIVE subproblem — same hash ``SolveSubproblems`` persists, so a
        match proves the stored solution solves today's problem."""
        nodes = self.block_nodes(block_id)
        dense = (np.searchsorted(self.s0_nodes, nodes).astype("int64")
                 if len(nodes) else np.zeros(0, "int64"))
        inner, outer = self._graph_obj().extract_subgraph(
            dense.astype("uint64"))
        uv, costs = self.combined_uv(), self.combined_costs()
        sig = mc.subproblem_signature(dense, uv[inner], costs[inner])
        return sig, dense, inner, outer

    def _solve_cold(self, inner: np.ndarray,
                    outer: np.ndarray) -> np.ndarray:
        """Full subproblem solve — byte-for-byte the cold path of
        ``SolveSubproblems._solve_block`` over the combined arrays."""
        if len(inner) == 0:
            return outer.astype("int64")
        uv, costs = self.combined_uv(), self.combined_costs()
        agglomerator = key_to_agglomerator(self._agglomerator_key)
        sub_uv = uv[inner]
        sub_nodes, local_flat = np.unique(sub_uv, return_inverse=True)
        local_uv = local_flat.reshape(-1, 2).astype("int64")
        with stage("host-solve"):
            res = agglomerator(len(sub_nodes), local_uv, costs[inner],
                               time_limit=self._time_limit)
        cut_mask = res[local_uv[:, 0]] != res[local_uv[:, 1]]
        return np.concatenate([inner[cut_mask], outer]).astype("int64")

    def ensure_block(self, block_id: int, *, expected: Set[int] = frozenset(),
                     corr_id: Optional[str] = None,
                     allow_warm: bool = True) -> np.ndarray:
        """Cut-edge ids for one block, warm-started when the signature
        validates; ``expected`` is the edit's resolved footprint — a
        mismatch outside it is a stale cache (see module docstring)."""
        sig, _, inner, outer = self.block_signature(block_id)
        if allow_warm:
            mem = self._cache.get(block_id)
            if mem is not None and mem[0] == sig:
                self.counters["warm_reused"] += 1
                return mem[1]
            disk = mc.load_sub_result(self.problem_path, 0, block_id)
            if disk is not None and disk[1] == sig:
                cut = disk[0]
                self._cache[block_id] = (sig, cut)
                self.counters["warm_reused"] += 1
                return cut
            if disk is not None and block_id not in expected:
                # persisted solution no longer matches the live problem
                # and no current edit explains it: stale cache.  Fall back
                # to the full solve (never wrong output) and leave a
                # flight record under the edit's correlation id.
                self.counters["fallback"] += 1
                if self.flight_dir:
                    telemetry.flight_record(
                        self.flight_dir, "edit-warm-fallback",
                        extra={"edit_id": corr_id, "block": int(block_id),
                               "live_signature": sig,
                               "stored_signature": disk[1],
                               "expected_blocks": sorted(
                                   int(b) for b in expected)})
        cut = self._solve_cold(inner, outer)
        self._cache[block_id] = (sig, cut)
        self.counters["subproblems_solved"] += 1
        return cut

    # -- global re-solve ---------------------------------------------------

    def solve(self, *, incremental: bool = True,
              expected: Set[int] = frozenset(),
              corr_id: Optional[str] = None) -> np.ndarray:
        """Per-node segment labels (dense s0 order) after re-running the
        ladder: per-block cuts (warm or cold) -> reduce -> global solve.
        ``incremental=False`` ignores every cache — the from-scratch
        reference the identity gate compares against."""
        from .. import native

        cut_lists = [self.ensure_block(bid, expected=expected,
                                       corr_id=corr_id,
                                       allow_warm=incremental)
                     for bid in range(self.blocking.n_blocks)]
        uv, costs = self.combined_uv(), self.combined_costs()
        cut_ids = (np.unique(np.concatenate(cut_lists))
                   if any(len(c) for c in cut_lists)
                   else np.zeros(0, "int64"))
        merge_mask = np.ones(len(uv), bool)
        merge_mask[cut_ids] = False

        # reduce (workflows/multicut.py ReduceProblem, in-memory)
        with stage("host-reduce"):
            roots = native.ufd_merge_pairs(self.n_nodes, uv[merge_mask])
        _, node_labeling = np.unique(roots, return_inverse=True)
        node_labeling = node_labeling.astype("int64")
        n_new = int(node_labeling.max()) + 1 if self.n_nodes else 0
        mapped = node_labeling[uv]
        keep = mapped[:, 0] != mapped[:, 1]
        mu = np.minimum(mapped[keep][:, 0], mapped[keep][:, 1])
        mv = np.maximum(mapped[keep][:, 0], mapped[keep][:, 1])
        pair = np.stack([mu, mv], axis=1)
        new_uv, inverse = np.unique(pair, axis=0, return_inverse=True)
        new_costs = np.zeros(len(new_uv), "float64")
        np.add.at(new_costs, inverse, costs[keep])

        # global solve over the reduced problem
        agglomerator = key_to_agglomerator(self._agglomerator_key)
        with stage("host-solve"):
            labels = agglomerator(n_new, new_uv.astype("int64"), new_costs,
                                  time_limit=self._time_limit)
        return np.asarray(labels)[node_labeling]

    def replay(self, edit_log) -> int:
        """Re-apply a durable :class:`~.log.EditLog` in order."""
        return edit_log.replay(self.apply_edit)
