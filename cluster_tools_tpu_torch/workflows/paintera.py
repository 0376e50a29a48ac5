"""Paintera-format helpers: the label-to-block lookup and the
fragment-segment assignment of a paintera label group.

Port of the helpers of cluster_tools_tpu/workflows/paintera.py that the
proofreading subsystem (``edits/``) needs: the resolver narrows its
candidate blocks through the label-to-block lookup, and the assignment
patcher keeps an attached paintera project's fragment-segment pairs in
step with the patched lookup table.  The paintera conversion tasks
themselves (unique block labels, label-to-block mapping, multiscale
labels, BigCat export) are not ported yet (ROADMAP A17b).

Layout under ``<path>/<label_group>``:

    label-to-block-mapping/s<i>  per-label block-id lists (varlen)
    fragment-segment-assignment  (2, N) fragment->segment pairs
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np

from ..core.storage import VarlenDataset, file_reader


def label_to_blocks(path: str, key: str, label_id: int):
    """Blocks containing ``label_id`` (readBlockMapping equivalent)."""
    ds = VarlenDataset(os.path.join(path, key), dtype="uint64")
    return ds.read_chunk((label_id,))


def assignment_to_pairs(table: np.ndarray) -> np.ndarray:
    """Assignment table -> (2, N) paintera fragment->segment pairs.

    Accepts either a dense 1-d table (index = fragment id) or sparse
    (N, 2) ``(fragment, segment)`` rows.  Background (fragment 0) is
    dropped and segment ids are offset past the largest fragment id so
    the two id spaces never collide — the paintera convention the edits/
    assignment patcher writes."""
    if table.ndim == 2:
        frag, seg = table[:, 0], table[:, 1]
    else:
        frag = np.arange(len(table), dtype="uint64")
        seg = table
    keep = frag != 0
    offset = int(frag.max()) + 1 if len(frag) else 1
    return np.stack([frag[keep], seg[keep] + offset], axis=0).astype("uint64")


def pairs_to_table(pairs: np.ndarray,
                   n_labels: Optional[int] = None) -> np.ndarray:
    """Invert :func:`assignment_to_pairs` back to a dense table.

    The offset is recovered as ``max(fragment id) + 1`` — exactly what
    the forward direction used, since dropping fragment 0 never changes
    the maximum.  ``n_labels`` sizes the table (defaults to the smallest
    table covering every fragment id); an empty pair set round-trips to
    an all-background table."""
    pairs = np.asarray(pairs)
    if pairs.size == 0:
        return np.zeros(0 if n_labels is None else int(n_labels), "uint64")
    frag, seg = pairs[0].astype("uint64"), pairs[1].astype("uint64")
    offset = int(frag.max()) + 1
    n = int(n_labels) if n_labels is not None else offset
    table = np.zeros(n, "uint64")
    table[frag.astype("int64")] = seg - np.uint64(offset)
    return table


def load_fragment_segment_assignment(path: str, label_group: str):
    """The (2, N) pairs dataset of a paintera group, or None if absent."""
    key = os.path.join(label_group, "fragment-segment-assignment")
    with file_reader(path, "r") as f:
        if key not in f:
            return None
        return f[key][:]


def write_fragment_segment_assignment(path: str, label_group: str,
                                      pairs: np.ndarray) -> None:
    """(Re)write the (2, N) pairs dataset — the edits/ patcher's path for
    keeping an attached paintera project consistent after an edit.

    ``require_dataset`` refuses shape changes by design, so when N moved
    (merges change the pair count) a dir-backed dataset is deleted and
    recreated; same-shape rewrites go in place."""
    key = os.path.join(label_group, "fragment-segment-assignment")
    pairs = np.asarray(pairs, dtype="uint64")
    with file_reader(path) as f:
        if key in f and tuple(f[key].shape) == tuple(pairs.shape):
            f[key][:] = pairs
            return
    ds_dir = os.path.join(path, key)
    if os.path.isdir(ds_dir):
        shutil.rmtree(ds_dir)
    with file_reader(path) as f:
        f.require_dataset(key, data=pairs, shape=pairs.shape,
                          chunks=(2, max(min(int(1e6), pairs.shape[1]), 1)))
