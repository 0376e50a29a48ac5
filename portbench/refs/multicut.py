"""Plain reference of the fused chain's problem and solution checks.

From the fragments ``ws`` (int64, whole volume) and the uint8 boundaries,
on the device in plain PyTorch:

* the region adjacency graph: every pair of face-adjacent voxels with
  different nonzero fragments gives the edge ``(min, max)``;
* the edge features: the boundary bytes of BOTH voxels of every such pair
  form the edge's sample multiset; from its 256-bin histogram, in float64,
  the mean, variance, minimum, the 0.1 / 0.25 / 0.5 / 0.75 / 0.9 quantiles
  (linear between order statistics, at position ``q (n - 1)``), maximum and
  the sample count, the levels being ``byte / 255``;
* the costs: ``log((1 - p) / p)`` with ``p = 0.998 * mean + 0.001``
  (positive = attractive);
* a missing or extra edge makes the feature and cost errors infinite;
* the segmentation's merge gain: the largest summed cost between two
  adjacent segments (a local optimum of the multicut has none above 0);
* the segmentation's objective gap: its multicut objective (the summed
  cost of the cut edges) above the plain solver's (``gaec.solve``) on the
  same graph and costs, as a share of the solver's |objective|, so that an
  over-merged segmentation, or one short of the solver's refinement, reads
  high where the merge gain reads 0.

``lowp`` computes the features and costs in bfloat16, and the solver's
sums (the control).
Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import gaec

QUANTILES = (0.1, 0.25, 0.5, 0.75, 0.9)


def rag_histograms(ws: torch.Tensor, bmap: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uv int64 (E, 2) sorted, hist int64 (E, 256))."""
    keys, bins = [], []
    for ax in range(3):
        n = ws.shape[ax] - 1
        a, b = ws.narrow(ax, 0, n), ws.narrow(ax, 1, n)
        m = (a != b) & (a > 0) & (b > 0)
        u = torch.minimum(a, b)[m]
        v = torch.maximum(a, b)[m]
        k = u * (1 << 32) + v
        keys += [k, k]
        bins += [bmap.narrow(ax, 0, n)[m].to(torch.int64),
                 bmap.narrow(ax, 1, n)[m].to(torch.int64)]
        del a, b, m, u, v
    key = torch.cat(keys)
    byte = torch.cat(bins)
    uniq, inv = torch.unique(key, return_inverse=True)
    hist = torch.bincount(inv * 256 + byte,
                          minlength=uniq.numel() * 256).reshape(-1, 256)
    uv = torch.stack([uniq >> 32, uniq & ((1 << 32) - 1)], dim=1)
    return uv, hist


def features(hist: torch.Tensor, lowp: bool = False) -> torch.Tensor:
    """(E, 10) float64: mean, var, min, 5 quantiles, max, count."""
    ft = torch.bfloat16 if lowp else torch.float64
    h = hist.to(ft)
    levels = (torch.arange(256, device=hist.device, dtype=torch.float64)
              / 255.0).to(ft)
    cnt = hist.sum(1).to(torch.float64)
    mean = (h * levels).sum(1) / cnt.to(ft)
    diff = levels[None, :] - mean[:, None]
    var = (h * diff * diff).sum(1) / cnt.to(ft)
    has = hist > 0
    first = torch.argmax(has.to(torch.int8), dim=1)
    last = 255 - torch.argmax(has.flip(1).to(torch.int8), dim=1)
    cum = torch.cumsum(hist, dim=1)

    def value_at(pos):
        idx = (cum <= pos[:, None]).sum(1)
        return levels[torch.clamp(idx, 0, 255)].to(torch.float64)

    cols = [mean.to(torch.float64), var.to(torch.float64),
            levels[first].to(torch.float64)]
    for q in QUANTILES:
        off = q * (cnt - 1.0)
        lo = torch.floor(off)
        frac = (off - lo).to(ft).to(torch.float64)
        lo_v = value_at(lo.to(torch.int64))
        hi_v = value_at(torch.minimum(lo + 1.0, cnt - 1.0).to(torch.int64))
        cols.append(lo_v * (1.0 - frac) + hi_v * frac)
    cols += [levels[last].to(torch.float64), cnt]
    return torch.stack(cols, dim=1)


def costs(mean: torch.Tensor, lowp: bool = False) -> torch.Tensor:
    ft = torch.bfloat16 if lowp else torch.float64
    p = (0.998 * mean.to(ft) + 0.001)
    return torch.log((1.0 - p) / p).to(torch.float64)


def match_edges(uv_ref: torch.Tensor, uv_prog: torch.Tensor):
    """(order of the program's edges in the reference's table, or None,
    and the size of the symmetric difference of the two edge sets)."""
    kr = uv_ref[:, 0] * (1 << 32) + uv_ref[:, 1]
    kp = uv_prog[:, 0] * (1 << 32) + uv_prog[:, 1]
    pos = torch.searchsorted(kr, kp).clamp(max=max(kr.numel() - 1, 0))
    found = kr[pos] == kp if kr.numel() else torch.zeros_like(kp, dtype=bool)
    n_missing = int((~found).sum())
    n_extra = int(kr.numel() - int(torch.unique(kp[found]).numel()))
    return (pos if n_missing == 0 else None), n_missing + n_extra


def fragment_segments(ws: torch.Tensor, seg: torch.Tensor):
    """(segment of each fragment id as a dense lookup, number of fragments
    that lie in more than one segment)."""
    w = ws.reshape(-1)
    s = seg.reshape(-1).to(torch.int64)
    pairs = torch.unique(w * (1 << 32) + s)
    frag = pairs >> 32
    n_split = int(pairs.numel() - torch.unique(frag).numel())
    lut = torch.zeros(int(w.max()) + 1, dtype=torch.int64, device=ws.device)
    lut[frag] = pairs & ((1 << 32) - 1)
    return lut, n_split


def merge_gain(uv: torch.Tensor, cost: torch.Tensor,
               lut: torch.Tensor) -> float:
    """Largest summed cost between two adjacent segments, at least 0."""
    su, sv = lut[uv[:, 0]], lut[uv[:, 1]]
    cut = su != sv
    if not bool(cut.any()):
        return 0.0
    a = torch.minimum(su, sv)[cut]
    b = torch.maximum(su, sv)[cut]
    key, inv = torch.unique(a * (1 << 32) + b, return_inverse=True)
    tot = torch.zeros(key.numel(), dtype=torch.float64, device=uv.device)
    tot.index_add_(0, inv, cost[cut].to(torch.float64))
    return max(float(tot.max()), 0.0)


def segments_objective(uv: torch.Tensor, cost: torch.Tensor,
                       lut: torch.Tensor) -> float:
    """The multicut objective of the fragment-to-segment map ``lut``."""
    return float(cost[lut[uv[:, 0]] != lut[uv[:, 1]]].sum())


def solved_lut(uv: torch.Tensor, cost: torch.Tensor,
               lowp: bool = False) -> torch.Tensor:
    """The plain solver's segmentation of the graph, as a fragment-to-
    segment map (``lowp``: its sums in bfloat16)."""
    nodes, dense = torch.unique(uv, return_inverse=True)
    labels = gaec.solve(int(nodes.numel()), dense.cpu().numpy(),
                        cost.cpu().numpy(), lowp)
    lut = torch.zeros(int(uv.max()) + 1 if uv.numel() else 1,
                      dtype=torch.int64, device=uv.device)
    lut[nodes] = torch.from_numpy(labels).to(uv.device) + 1
    return lut


def objective_gap(uv: torch.Tensor, cost: torch.Tensor,
                  lut: torch.Tensor) -> float:
    """(objective of ``lut`` - the plain solver's) / |the solver's|."""
    ref = segments_objective(uv, cost, solved_lut(uv, cost))
    return (segments_objective(uv, cost, lut) - ref) / max(abs(ref), 1e-12)


def feature_error(prog: np.ndarray, ref: torch.Tensor) -> float:
    """max |prog - ref| / (1 + |ref|) over every edge and column."""
    p = torch.from_numpy(np.asarray(prog, "float64")).to(ref.device)
    return float(((p - ref).abs() / (1.0 + ref.abs())).max()) \
        if ref.numel() else 0.0


def check_problem(ws: torch.Tensor, bmap: torch.Tensor, seg: torch.Tensor,
                  uv_prog: np.ndarray, feats_prog: np.ndarray,
                  costs_prog: np.ndarray) -> Dict[str, float]:
    """The numbers that judge the program's graph, features, costs and
    segmentation against the reference computed from ``ws``."""
    uv, hist = rag_histograms(ws, bmap)
    feats = features(hist)
    c_ref = costs(feats[:, 0])
    uvp = torch.from_numpy(np.asarray(uv_prog, "int64")).to(ws.device)
    order, n_diff = match_edges(uv, uvp)
    out = {}
    if order is None or n_diff:
        # a missing or extra edge fails both
        out.update(feature_err=float("inf"), cost_err=float("inf"))
    else:
        out["feature_err"] = feature_error(feats_prog, feats[order])
        out["cost_err"] = feature_error(
            np.asarray(costs_prog)[:, None], c_ref[order][:, None])
    lut, n_split = fragment_segments(ws, seg)
    if n_split:  # a fragment in two segments
        out.update(seg_merge_gain=float("inf"),
                   seg_objective_gap=float("inf"))
    else:
        out["seg_merge_gain"] = merge_gain(uv, c_ref, lut)
        out["seg_objective_gap"] = objective_gap(uv, c_ref, lut)
    return out
