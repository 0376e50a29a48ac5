"""Blockwise distance-transform watershed: the pieces the fused chain uses.

Port of the helpers of cluster_tools_tpu/workflows/watershed.py that the
fused task calls (reference watershed/watershed.py): the input
normalization policy (:func:`_normalize_input`, :func:`as_normalized_float`),
volume-level reflection (:func:`reflect_indices`) and the per-block
watershed pipeline :func:`run_ws_block` on its ``ws_algorithm="basins"``
path, which the fused task's host fallback runs for a block whose coarse
solve overflowed its capacities.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch


def _normalize_input(data: np.ndarray, cfg) -> np.ndarray:
    """Channel agglomeration + range normalization + optional inversion —
    the single policy shared by every reader (reference:
    watershed.py:267-283 _read_data)."""
    if data.ndim == 4:
        agglo = cfg.get("agglomerate_channels", "mean")
        data = data.max(axis=0) if agglo == "max" else data.mean(axis=0)
    mx = data.max()
    if mx > 1.0:
        data = data / 255.0 if mx <= 255 else data / mx
    if cfg.get("invert_inputs", False):
        data = 1.0 - data
    return data


def as_normalized_float(block: np.ndarray) -> np.ndarray:
    """Raw-path inverse: a uint8 block back to the [0,1] float scale the
    device pipeline uses (shared by every raw-read fallback site)."""
    if block.dtype == np.uint8:
        return block.astype("float32") / 255.0
    return np.asarray(block)


def reflect_indices(start: int, stop: int, n: int) -> np.ndarray:
    """Volume-level reflection indices for ``range(start, stop)`` over an
    axis of length n: out-of-volume positions fold back as the mirror of
    the WHOLE axis (period 2n-2), so every reader of a block's outer
    window sees identical phantom content."""
    idx = np.arange(start, stop)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * n - 2
    j = np.mod(idx, period)
    return np.where(j < n, j, period - j)


def _ws_algorithm(cfg) -> str:
    """The watershed ALGORITHM ('coarse'/'basins'/'flood') from the task
    config or the CTT_WS_METHOD env; distinct from the fused task's
    execution-strategy ws_method, whose values fall through to the
    default."""
    m = (cfg.get("ws_algorithm") or cfg.get("ws_method")
         or os.environ.get("CTT_WS_METHOD", "coarse"))
    return m if m in ("coarse", "basins", "flood") else "coarse"


def run_ws_block(data: np.ndarray, cfg: Dict[str, Any],
                 device="cpu") -> np.ndarray:
    """The per-block watershed pipeline (reference: _ws_block
    watershed.py:285-341) on ``device``, ``ws_algorithm="basins"``: EDT,
    height map, seeds from smoothed-DT maxima, basin-merging watershed,
    size filter.  Returns uint64 labels."""
    from ..ops.components import connected_components
    from ..ops.edt import distance_transform_edt
    from ..ops.filters import gaussian, local_maxima
    from ..ops.watershed import seeded_watershed, size_filter

    if _ws_algorithm(cfg) != "basins":
        raise NotImplementedError(
            "run_ws_block is ported for ws_algorithm='basins' only "
            "(ROADMAP A9)")
    for key in ("apply_dt_2d", "apply_ws_2d", "non_maximum_suppression"):
        if cfg.get(key):
            raise NotImplementedError(f"{key} is not ported yet (ROADMAP A9)")
    threshold = cfg.get("threshold", 0.25)
    sigma_seeds = cfg.get("sigma_seeds", 2.0)
    sigma_weights = cfg.get("sigma_weights", 2.0)
    min_size = cfg.get("size_filter", 25)
    alpha = cfg.get("alpha", 0.8)
    pixel_pitch = cfg.get("pixel_pitch")

    x = torch.from_numpy(np.ascontiguousarray(data)).to(device)
    fg = x < threshold
    dt = distance_transform_edt(
        fg, sampling=tuple(pixel_pitch) if pixel_pitch else None)
    hmap = gaussian(x, sigma_weights) if sigma_weights else x
    dmax = torch.clamp(dt.max(), min=1e-6)
    height = alpha * hmap + (1.0 - alpha) * (1.0 - dt / dmax)
    dt_smooth = gaussian(dt, sigma_seeds) if sigma_seeds else dt
    maxima = local_maxima(dt_smooth, radius=2) & fg
    seeds = connected_components(maxima, connectivity=x.dim(),
                                 method="propagation")
    ws = seeded_watershed(height, seeds, None, connectivity=1).cpu().numpy()
    if min_size:
        ws = size_filter(ws, height, min_size)
    return ws.astype("uint64")
