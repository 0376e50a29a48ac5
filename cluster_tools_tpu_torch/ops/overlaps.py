"""Label-overlap counting on the card.

Port of cluster_tools_tpu/ops/overlaps.py (the reference's
``nifty.distributed.computeAndSerializeLabelOverlaps`` /
``nifty.ground_truth.overlap``).  Both volumes are densified to int32 on
the host (ops/rag.py ``densify_labels``), the pair ``(a, b)`` is packed
into one int64 key ``a * n_b + b`` on the device, and ``torch.unique``
counts the equal keys.  Its sorted keys are the pairs in the
lexicographic ``(a, b)`` order the JAX package's ``lexsort`` gives, so
the arrays come out equal to the JAX package's, order included.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from .rag import densify_labels


def count_overlaps(seg_a: np.ndarray, seg_b: np.ndarray,
                   device: str = "cuda"
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Co-occurrence counts of two label volumes of identical shape.

    Returns (ids_a, ids_b, counts): for each distinct (a, b) pair of labels
    occurring at the same voxel, how many voxels share it, sorted by
    (a, b).  Counting runs on ``device`` over densified ids; the result is
    exact uint64 labels."""
    seg_a = np.asarray(seg_a)
    seg_b = np.asarray(seg_b)
    if seg_a.shape != seg_b.shape:
        raise ValueError(f"shape mismatch: {seg_a.shape} vs {seg_b.shape}")
    dev = resolve_device(device)
    lut_a, dense_a = densify_labels(seg_a)
    lut_b, dense_b = densify_labels(seg_b)
    n_b = len(lut_b)
    a = torch.from_numpy(dense_a.ravel()).to(dev).to(torch.int64)
    b = torch.from_numpy(dense_b.ravel()).to(dev).to(torch.int64)
    keys, counts = torch.unique(a * n_b + b, sorted=True,
                                return_counts=True)
    keys = keys.cpu().numpy()
    counts = counts.cpu().numpy().astype("uint64")
    return lut_a[keys // n_b], lut_b[keys % n_b], counts
