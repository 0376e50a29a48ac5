"""Segmentation-quality metrics: VI, adapted Rand, CREMI score, object VI.

Port of cluster_tools_tpu/utils/validation.py (the reference's metric
math, cluster_tools/utils/validation_utils.py:9-273):

* the contingency table is computed by vectorized key-packing + ``np.unique``
  on the host, or on a device through ops/overlaps.py (``on_device=True``,
  on ``device``);
* the VI / Rand primitives are vectorized numpy expressions.

API signatures and return conventions follow the reference exactly:
``variation_of_information(seg, gt) -> (vi_split, vi_merge)``,
``rand_index(seg, gt) -> (adapted_rand_error, rand_index)``,
``cremi_score(seg, gt) -> (vis, vim, are, cremi)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# contingency tables
# ---------------------------------------------------------------------------

class ContingencyTable:
    """Sparse contingency table between label images A and B.

    ``p_ids`` is (N, 2) uint64 of co-occurring (a, b) label pairs, ``p_counts``
    the voxel count per pair; ``a_ids``/``a_counts`` (and b) are the marginal
    label sizes.  ``n_points`` is the total voxel count.
    """

    def __init__(self, p_ids: np.ndarray, p_counts: np.ndarray):
        self.p_ids = np.asarray(p_ids, dtype="uint64").reshape(-1, 2)
        self.p_counts = np.asarray(p_counts, dtype="float64")
        if len(self.p_ids) != len(self.p_counts):
            raise ValueError("pair ids and counts disagree in length")
        self.a_ids, inv_a = np.unique(self.p_ids[:, 0], return_inverse=True)
        self.a_counts = np.bincount(inv_a, weights=self.p_counts,
                                    minlength=len(self.a_ids))
        self.b_ids, inv_b = np.unique(self.p_ids[:, 1], return_inverse=True)
        self.b_counts = np.bincount(inv_b, weights=self.p_counts,
                                    minlength=len(self.b_ids))
        self._inv_a = inv_a
        self._inv_b = inv_b
        self.n_points = float(self.p_counts.sum())

    @classmethod
    def from_arrays(cls, seg_a: np.ndarray, seg_b: np.ndarray,
                    on_device: bool = False,
                    device: str = "cuda") -> "ContingencyTable":
        """Contingency of two label images; ``on_device`` counts the
        pairs on ``device`` (ops/overlaps.py), else with numpy."""
        a = np.asarray(seg_a).ravel().astype("uint64")
        b = np.asarray(seg_b).ravel().astype("uint64")
        if a.shape != b.shape:
            raise ValueError("segmentations must have the same size")
        if a.size == 0:
            return cls(np.zeros((0, 2), "uint64"), np.zeros(0, "float64"))
        if on_device:
            from ..ops.overlaps import count_overlaps

            ia, ib, counts = count_overlaps(a, b, device=device)
            return cls(np.stack([ia, ib], axis=1), counts.astype("float64"))
        if a.max() < 2 ** 32 and b.max() < 2 ** 32:
            key = (a << np.uint64(32)) | b
            uniq, counts = np.unique(key, return_counts=True)
            p_ids = np.stack([uniq >> np.uint64(32),
                              uniq & np.uint64(0xFFFFFFFF)], axis=1)
        else:
            p_ids, counts = np.unique(np.stack([a, b], axis=1), axis=0,
                                      return_counts=True)
        return cls(p_ids, counts.astype("float64"))

    @classmethod
    def from_arrays_chunked(cls, seg_a, seg_b,
                            chunk: int = 1 << 24) -> "ContingencyTable":
        """Streaming variant of :func:`from_arrays`: the inputs are
        consumed in flat chunks (cast per chunk — callers can keep their
        narrow dtypes), so peak memory is O(chunk + unique pairs) instead
        of several full-volume uint64 temporaries.  Labels must fit 32
        bits (use from_arrays for the >4G-label edge case)."""
        a = np.asarray(seg_a).reshape(-1)
        b = np.asarray(seg_b).reshape(-1)
        if a.shape != b.shape:
            raise ValueError("segmentations must have the same size")
        keys_parts = []
        counts_parts = []
        for lo in range(0, a.size, chunk):
            aa = a[lo:lo + chunk].astype("uint64")
            bb = b[lo:lo + chunk].astype("uint64")
            if aa.size and (aa.max() >= 2 ** 32 or bb.max() >= 2 ** 32):
                raise ValueError("labels exceed 32 bits; use from_arrays")
            key = (aa << np.uint64(32)) | bb
            uniq, cnt = np.unique(key, return_counts=True)
            keys_parts.append(uniq)
            counts_parts.append(cnt.astype("float64"))
        if not keys_parts:
            return cls(np.zeros((0, 2), "uint64"), np.zeros(0, "float64"))
        keys = np.concatenate(keys_parts)
        cnts = np.concatenate(counts_parts)
        uniq, inv = np.unique(keys, return_inverse=True)
        counts = np.zeros(len(uniq), "float64")
        np.add.at(counts, inv, cnts)
        p_ids = np.stack([uniq >> np.uint64(32),
                          uniq & np.uint64(0xFFFFFFFF)], axis=1)
        return cls(p_ids, counts)

    def drop_pairs(self, mask: np.ndarray) -> "ContingencyTable":
        keep = ~np.asarray(mask, bool)
        return ContingencyTable(self.p_ids[keep], self.p_counts[keep])


def compute_ignore_mask(seg_a, seg_b, ignore_a, ignore_b) -> Optional[np.ndarray]:
    """Voxel mask selecting the points that enter the metrics (reference:
    validation_utils.py:38-53): voxels ignored in *both* inputs (or in the
    single given one) are excluded."""
    if ignore_a is None and ignore_b is None:
        return None
    mask_a = None if ignore_a is None else np.isin(seg_a, ignore_a)
    mask_b = None if ignore_b is None else np.isin(seg_b, ignore_b)
    if mask_a is None:
        ignore = mask_b
    elif mask_b is None:
        ignore = mask_a
    else:
        ignore = np.logical_and(mask_a, mask_b)
    return np.logical_not(ignore)


def drop_ignored_pairs(table: ContingencyTable,
                       ignore_a: Optional[Sequence[int]] = None,
                       ignore_b: Optional[Sequence[int]] = None
                       ) -> ContingencyTable:
    """Pair-level form of :func:`compute_ignore_mask`: each (a, b) pair stands
    for an exact voxel set, so dropping pairs ignored in both inputs (or in
    the single given one) is equivalent to voxel masking."""
    if ignore_a is None and ignore_b is None:
        return table
    in_a = (np.isin(table.p_ids[:, 0], np.asarray(ignore_a, "uint64"))
            if ignore_a is not None else None)
    in_b = (np.isin(table.p_ids[:, 1], np.asarray(ignore_b, "uint64"))
            if ignore_b is not None else None)
    if in_a is None:
        drop = in_b
    elif in_b is None:
        drop = in_a
    else:
        drop = in_a & in_b
    return table.drop_pairs(drop)


def _table_with_ignore(segmentation, groundtruth, ignore_seg, ignore_gt
                       ) -> ContingencyTable:
    """Contingency of (gt, seg) with the reference's ignore semantics."""
    mask = compute_ignore_mask(segmentation, groundtruth, ignore_seg, ignore_gt)
    seg = np.asarray(segmentation).ravel()
    gt = np.asarray(groundtruth).ravel()
    if mask is not None:
        mask = mask.ravel()
        seg, gt = seg[mask], gt[mask]
    return ContingencyTable.from_arrays(gt, seg)


# ---------------------------------------------------------------------------
# VI (reference: validation_utils.py:60-113)
# ---------------------------------------------------------------------------

def compute_vi_scores(table: ContingencyTable, use_log2: bool = True
                      ) -> Tuple[float, float]:
    """(vi_split, vi_merge) from a contingency table of (gt=A, seg=B)."""
    log = np.log2 if use_log2 else np.log
    n = table.n_points
    if n == 0:
        return 0.0, 0.0
    pa = table.a_counts / n
    pb = table.b_counts / n
    sum_a = float(-(pa * log(pa)).sum())
    sum_b = float(-(pb * log(pb)).sum())
    c = table.p_counts
    sum_ab = float(np.sum(
        c / n * log(n * c / (table.a_counts[table._inv_a]
                             * table.b_counts[table._inv_b]))))
    vi_split = sum_b - sum_ab
    vi_merge = sum_a - sum_ab
    return vi_split, vi_merge


def variation_of_information(segmentation, groundtruth, ignore_seg=None,
                             ignore_gt=None, use_log2: bool = True
                             ) -> Tuple[float, float]:
    table = _table_with_ignore(segmentation, groundtruth, ignore_seg, ignore_gt)
    return compute_vi_scores(table, use_log2=use_log2)


def compute_object_vi_scores(table: ContingencyTable, use_log2: bool = True
                             ) -> Dict[int, Tuple[float, float]]:
    """Per-gt-object (vi_split, vi_merge) (reference:
    validation_utils.py:116-134, after arXiv:1708.02599 p.16)."""
    log = np.log2 if use_log2 else np.log
    gt_sizes = table.a_counts[table._inv_a]
    seg_sizes = table.b_counts[table._inv_b]
    c = table.p_counts
    vim_terms = -c / gt_sizes * log(c / gt_sizes)
    vis_terms = -c / gt_sizes * log(c / seg_sizes)
    vim = np.bincount(table._inv_a, weights=vim_terms,
                      minlength=len(table.a_ids))
    vis = np.bincount(table._inv_a, weights=vis_terms,
                      minlength=len(table.a_ids))
    return {int(gt_id): (float(s), float(m))
            for gt_id, s, m in zip(table.a_ids, vis, vim)}


def object_vi(segmentation, groundtruth, ignore_seg=None, ignore_gt=None,
              use_log2: bool = True) -> Dict[int, Tuple[float, float]]:
    table = _table_with_ignore(segmentation, groundtruth, ignore_seg, ignore_gt)
    return compute_object_vi_scores(table, use_log2=use_log2)


# ---------------------------------------------------------------------------
# Rand (reference: validation_utils.py:178-231)
# ---------------------------------------------------------------------------

def compute_rand_scores(table: ContingencyTable) -> Tuple[float, float]:
    """(adapted_rand_error, rand_index) from a (gt, seg) contingency table."""
    n = table.n_points
    if n == 0:
        return 0.0, 1.0
    sum_a = float((table.a_counts ** 2).sum())
    sum_b = float((table.b_counts ** 2).sum())
    sum_ab = float((table.p_counts ** 2).sum())
    prec = sum_ab / sum_b
    rec = sum_ab / sum_a
    ari = 1.0 - (2 * prec * rec) / (prec + rec)
    ri = 1.0 - (sum_a + sum_b - 2 * sum_ab) / (n * n)
    return ari, ri


def rand_index(segmentation, groundtruth, ignore_seg=None, ignore_gt=None
               ) -> Tuple[float, float]:
    table = _table_with_ignore(segmentation, groundtruth, ignore_seg, ignore_gt)
    return compute_rand_scores(table)


# ---------------------------------------------------------------------------
# CREMI score (reference: validation_utils.py:234-273)
# ---------------------------------------------------------------------------

def cremi_score_from_table(table: ContingencyTable
                           ) -> Tuple[float, float, float, float]:
    """(vi_split, vi_merge, adapted_rand_error, cremi) from a (gt, seg)
    contingency table; cremi = sqrt(are * (vis + vim))."""
    vis, vim = compute_vi_scores(table, use_log2=True)
    ari, _ = compute_rand_scores(table)
    cs = float(np.sqrt(ari * (vis + vim)))
    return vis, vim, ari, cs


def cremi_score(segmentation, groundtruth, ignore_seg=None, ignore_gt=None
                ) -> Tuple[float, float, float, float]:
    table = _table_with_ignore(segmentation, groundtruth, ignore_seg, ignore_gt)
    return cremi_score_from_table(table)
