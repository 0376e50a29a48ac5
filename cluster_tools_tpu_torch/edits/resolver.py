"""Affected-subgraph resolver.

Maps an edit's fragment ids to the minimal set of multicut subproblems
that must be re-solved.  The correctness criterion falls out of the
domain decomposition (Pape et al., ICCV'17): every subproblem cuts ALL
of its outer edges before the reduce step, so a block's solution is a
function of its inner edges only — and an edit only re-weights edges
between the edited fragments, so the affected blocks are exactly those
whose node set contains at least two of them.  Fragments that never
share a block still meet in the reduce/global stage, which the
incremental solver always re-runs.

Candidate narrowing goes through the paintera label-to-block lookup
when available: fragment -> paintera data blocks -> voxel ROI ->
``sub_graph_block_shape`` blocks, confirmed against the persisted
sub_graph node sets.  Without a lookup the resolver scans every s0
sub_graph — correct, and cheap at interactive block counts, but O(grid).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

import numpy as np

from ..core import graph as g
from ..core.blocking import Blocking
from ..workflows.multicut import _problem_geometry


def load_block_nodes(problem_path: str, scale: int,
                     block_id: int) -> np.ndarray:
    """Node-label set of one persisted sub_graph (empty if the block was
    masked out and never serialized)."""
    try:
        return g.load_sub_graph(problem_path, scale, block_id)["nodes"]
    except FileNotFoundError:
        return np.zeros(0, "uint64")


def paintera_candidate_blocks(paintera_path: str, lookup_key: str,
                              fragments: Sequence[int],
                              paintera_block_shape: Sequence[int],
                              blocking: Blocking) -> Optional[List[int]]:
    """Candidate subproblem blocks via the paintera label-to-block lookup:
    each fragment's data blocks -> voxel ROI -> subproblem grid.  Returns
    None when any fragment is missing from the lookup (stale mapping) so
    the caller falls back to the full scan instead of missing blocks."""
    from ..workflows.paintera import label_to_blocks

    data_blocking = Blocking(blocking.shape, paintera_block_shape)
    out: Set[int] = set()
    for frag in fragments:
        data_blocks = label_to_blocks(paintera_path, lookup_key, int(frag))
        if data_blocks is None:
            return None
        for dbid in np.asarray(data_blocks, dtype="int64"):
            block = data_blocking.get_block(int(dbid))
            out.update(blocking.blocks_in_roi(block.begin, block.end))
    return sorted(out)


def resolve_affected(
        problem_path: str, fragments: Sequence[int], *, scale: int = 0,
        fallback_block_shape: Optional[Sequence[int]] = None,
        paintera_path: Optional[str] = None,
        paintera_lookup_key: Optional[str] = None,
        paintera_block_shape: Optional[Sequence[int]] = None,
        node_loader: Optional[Callable[[int], np.ndarray]] = None,
) -> List[int]:
    """Subproblem block ids whose node set contains >= 2 of ``fragments``
    (see module docstring for why that is the minimal re-solve set).

    ``node_loader`` overrides per-block node-set loading (the edits
    session passes its in-memory cache); default reads the persisted
    sub_graphs.  Membership is always CONFIRMED against node sets — the
    paintera lookup only narrows which blocks get checked."""
    shape, base_bs = _problem_geometry(
        problem_path, fallback_block_shape or [64, 64, 64])
    scale_bs = [b * 2 ** scale for b in base_bs]
    blocking = Blocking(shape, scale_bs)

    candidates: Iterable[int] = range(blocking.n_blocks)
    if paintera_path and paintera_lookup_key and paintera_block_shape:
        narrowed = paintera_candidate_blocks(
            paintera_path, paintera_lookup_key, fragments,
            paintera_block_shape, blocking)
        if narrowed is not None:
            candidates = narrowed

    frs = np.unique(np.asarray(list(fragments), dtype="uint64"))
    if node_loader is None:
        def node_loader(bid, _p=problem_path, _s=scale):
            return load_block_nodes(_p, _s, bid)
    affected = []
    for bid in candidates:
        nodes = node_loader(bid)
        if len(nodes) and int(np.isin(frs, nodes).sum()) >= 2:
            affected.append(int(bid))
    return affected
