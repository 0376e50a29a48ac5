"""Assignment patcher.

Turns a re-solved node labeling into the smallest possible on-disk
delta: a STABLE relabeling against the previous fragment-segment LUT
(so untouched segments keep their ids and the delta stays local to the
edit), an atomic rewrite of the LUT, an optional refresh of the
paintera fragment-segment-assignment, and a fused-path rewrite of only
the output blocks whose fragments changed segment.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def stable_relabel(old_table: np.ndarray, nodes: np.ndarray,
                   labels: np.ndarray) -> np.ndarray:
    """New assignment table over the same fragment-id space, reusing old
    segment ids wherever possible.

    Rule: each old segment's REPRESENTATIVE is its smallest member
    fragment; a new cluster keeps an old id iff it contains that old
    segment's representative (ties — a cluster holding several
    representatives, i.e. a merge — keep the smallest old id).  Clusters
    holding no representative (the detached half of a split) get fresh
    ids past the old maximum.  Representatives are single fragments, so
    no two clusters can claim the same old id, and a no-op re-solve
    reproduces ``old_table`` bit-identically."""
    nodes = np.asarray(nodes, dtype="int64")
    labels = np.asarray(labels)
    old_ids = old_table[nodes].astype("uint64")
    uniq, inv = np.unique(labels, return_inverse=True)

    # representative fragment of each old segment = first occurrence of
    # the segment id in ascending-node order (nodes is the sorted s0
    # node table, so "first" == "smallest fragment")
    order = np.argsort(old_ids, kind="stable")
    sorted_old = old_ids[order]
    firsts = order[np.r_[True, sorted_old[1:] != sorted_old[:-1]]]

    # per cluster: smallest old id among the representatives it contains
    assign = np.zeros(len(uniq), "uint64")
    cl, oid = inv[firsts], old_ids[firsts]
    sel = oid != 0  # background never donates its id
    cl, oid = cl[sel], oid[sel]
    ord2 = np.lexsort((oid, cl))
    cl_s, oid_s = cl[ord2], oid[ord2]
    head = np.r_[True, cl_s[1:] != cl_s[:-1]] if len(cl_s) else \
        np.zeros(0, bool)
    assign[cl_s[head]] = oid_s[head]

    # fresh ids for clusters no old segment survives into
    unmatched = np.flatnonzero(assign == 0)
    next_id = int(old_table.max()) + 1
    assign[unmatched] = np.arange(
        next_id, next_id + len(unmatched), dtype="uint64")

    new_table = old_table.copy()
    new_table[nodes] = assign[inv]
    return new_table


def patch_assignment_table(assignment_path: str, nodes: np.ndarray,
                           labels: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Stable-relabel against the LUT on disk and atomically replace it;
    returns ``(new_table, changed_fragment_ids)`` — the delta the block
    rewrite and the paintera refresh key off."""
    old_table = np.load(assignment_path)
    new_table = stable_relabel(old_table, nodes, labels)
    changed = np.flatnonzero(new_table != old_table).astype("uint64")
    tmp = assignment_path + ".tmp.npy"
    np.save(tmp, new_table)
    os.replace(tmp, assignment_path)
    return new_table, changed


def patch_paintera_assignment(paintera_path: Optional[str],
                              label_group: Optional[str],
                              new_table: np.ndarray) -> bool:
    """Refresh an attached paintera project's fragment-segment pairs from
    the patched LUT (no-op without a configured project)."""
    if not (paintera_path and label_group):
        return False
    from ..workflows.paintera import (assignment_to_pairs,
                                      write_fragment_segment_assignment)

    write_fragment_segment_assignment(paintera_path, label_group,
                                      assignment_to_pairs(new_table))
    return True
