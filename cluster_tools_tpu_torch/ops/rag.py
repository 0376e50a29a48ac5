"""Region-adjacency-graph primitives: boundary pairs and edge statistics.

Port of the pieces of cluster_tools_tpu/ops/rag.py that the fused and the
split chains run (the replacement for
``nifty.distributed.computeMergeableRegionGraph`` and the ndist feature
extraction, reference graph/initial_sub_graphs.py:114-118,
features/block_edge_features.py:113-141):

* device side: :func:`label_pairs` (every differing axis-neighbor pair
  with a validity mask), :func:`boundary_pair_values_dual` /
  :func:`boundary_pair_values` (the same pairs with boundary samples),
  :func:`affinity_pair_values` (offset-channel samples),
  :func:`compact_valid`, and the per-edge statistics — exact 256-bin
  histograms over packed keys for uint8 inputs
  (:func:`edge_stats_hist_packed`) and the sorted-position path for float
  inputs (:func:`edge_stats_device`), with the split chain's
  submit/finalize pair around the latter
  (:func:`device_edge_stats_submit`, :func:`device_edge_stats_finalize`);
* host side (numpy): :func:`densify_labels`, :func:`host_label_pairs`,
  :func:`host_boundary_edge_features`, :func:`unique_pairs`,
  :func:`segmented_stats`, :func:`merge_feature_blocks`.

Face ownership: the pair between voxel ``i`` and ``i+1`` along an axis
belongs to the block that owns voxel ``i``.

Every statistic is the JAX package's: mean, variance (centered second
pass), min, the q10..q90 position-interpolated quantiles, max and count.
JAX's ``lax.sort([key, payload], num_keys=1)`` becomes ``torch.sort`` plus
a gather, its ``lexsort`` a chain of stable sorts, its ``segment_*``
reductions ``index_add_`` / ``scatter_reduce_`` over identity-filled
outputs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

FEATURE_NAMES = ("mean", "variance", "min", "q10", "q25", "q50", "q75", "q90",
                 "max", "count")
N_FEATURES = len(FEATURE_NAMES)
_QS = (0.1, 0.25, 0.5, 0.75, 0.9)
_BIG = 2 ** 31 - 1


def densify_labels(labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Map arbitrary (uint64) labels to dense int32 ids for the device.
    Returns ``(lut, dense)`` with ``lut[dense] == labels`` and
    ``lut[0] == 0``, so the ignore-label-0 convention survives."""
    uniq, inv = np.unique(labels, return_inverse=True)
    inv = inv.reshape(labels.shape)
    if len(uniq) == 0 or uniq[0] != 0:
        uniq = np.concatenate([np.zeros(1, dtype=uniq.dtype), uniq])
        inv = inv + 1
    if len(uniq) >= 2 ** 31:  # one block can never hold this many labels
        raise ValueError("more than 2**31 distinct labels in one block")
    return uniq.astype("uint64"), inv.astype("int32")


def _axis_slices(ndim: int, axis: int, lo_size: int):
    lo = [slice(None)] * ndim
    hi = [slice(None)] * ndim
    lo[axis] = slice(0, lo_size)
    hi[axis] = slice(1, lo_size + 1)
    return tuple(lo), tuple(hi)


def _inner_ownership(valid: torch.Tensor, a_shape, axis: int, size: int,
                     inner) -> torch.Tensor:
    """Restrict ``valid`` to faces whose first voxel lies in the inner
    block, on every axis."""
    ndim = len(a_shape)
    for ax2 in range(ndim):
        lim = inner[ax2] if ax2 != axis else min(inner[ax2], size)
        if a_shape[ax2] > lim:
            shape = [1] * ndim
            shape[ax2] = a_shape[ax2]
            idx = torch.arange(a_shape[ax2], device=valid.device) < lim
            valid = valid & idx.reshape(shape)
    return valid


def label_pairs(labels: torch.Tensor, ignore_label: bool = True,
                inner_shape: Optional[Tuple[int, ...]] = None):
    """All differing axis-neighbor label pairs of the block.  ``labels`` is
    the block with a +1 halo on its upper faces; ``inner_shape`` restricts
    ownership to faces whose first voxel lies in the inner block.  Returns
    flat ``(u, v, valid)`` with u < v on valid entries and zeros
    elsewhere."""
    ndim = labels.dim()
    us, vs, ok = [], [], []
    inner = inner_shape or tuple(labels.shape)
    for axis in range(ndim):
        size = labels.shape[axis] - 1
        if size <= 0:
            continue
        lo_sl, hi_sl = _axis_slices(ndim, axis, size)
        a, b = labels[lo_sl], labels[hi_sl]
        valid = a != b
        if ignore_label:
            valid &= (a != 0) & (b != 0)
        m = _inner_ownership(valid, a.shape, axis, size, inner).reshape(-1)
        us.append(torch.where(m, torch.minimum(a, b).reshape(-1), 0))
        vs.append(torch.where(m, torch.maximum(a, b).reshape(-1), 0))
        ok.append(m)
    return torch.cat(us), torch.cat(vs), torch.cat(ok)


def affinity_pair_values(labels: torch.Tensor, affs: torch.Tensor,
                         offsets: Sequence[Sequence[int]],
                         ignore_label: bool = True,
                         inner_begin: Optional[Tuple[int, ...]] = None,
                         inner_shape: Optional[Tuple[int, ...]] = None):
    """Pairs + affinity samples for (long-range) offset channels: channel c
    of ``affs`` holds the affinity between anchor voxel i and voxel
    i + offsets[c].  One sample per differing in-bounds pair whose ANCHOR
    lies in the inner window ``[inner_begin, inner_begin + inner_shape)``
    of the two-sided-haloed block (reference: ndist
    extractBlockFeaturesFromAffinityMaps).  Returns flat
    ``(u, v, value, valid)``."""
    ndim = labels.dim()
    inner = inner_shape or tuple(labels.shape)
    begin = inner_begin or (0,) * ndim
    us, vs, vals, ok = [], [], [], []
    for c, off in enumerate(offsets):
        sl_a, sl_b = [], []
        for o, s in zip(off, labels.shape):
            if o >= 0:
                sl_a.append(slice(0, s - o))
                sl_b.append(slice(o, s))
            else:
                sl_a.append(slice(-o, s))
                sl_b.append(slice(0, s + o))
        a = labels[tuple(sl_a)]
        b = labels[tuple(sl_b)]
        fv = affs[c][tuple(sl_a)]
        valid = a != b
        if ignore_label:
            valid &= (a != 0) & (b != 0)
        for ax2 in range(ndim):
            pos = torch.arange(a.shape[ax2], device=labels.device) \
                + sl_a[ax2].start
            owned = (pos >= begin[ax2]) & (pos < begin[ax2] + inner[ax2])
            shape = [1] * ndim
            shape[ax2] = a.shape[ax2]
            valid = valid & owned.reshape(shape)
        m = valid.reshape(-1)
        us.append(torch.where(m, torch.minimum(a, b).reshape(-1), 0))
        vs.append(torch.where(m, torch.maximum(a, b).reshape(-1), 0))
        vals.append(fv.reshape(-1))
        ok.append(m)
    return torch.cat(us), torch.cat(vs), torch.cat(vals), torch.cat(ok)


def boundary_pair_values_dual(labels: torch.Tensor, bmap: torch.Tensor,
                              ignore_label: bool = True,
                              inner_shape: Optional[Tuple[int, ...]] = None):
    """Every axis-neighbor face pair ONCE, with BOTH side samples as
    separate columns.  Returns flat ``(u, v, value_a, value_b, valid)``
    with u < v on valid entries and zeros elsewhere."""
    ndim = labels.dim()
    us, vs, va, vb, ok = [], [], [], [], []
    inner = inner_shape or tuple(labels.shape)
    for axis in range(ndim):
        size = labels.shape[axis] - 1
        if size <= 0:
            continue
        lo_sl, hi_sl = _axis_slices(ndim, axis, size)
        a, b = labels[lo_sl], labels[hi_sl]
        fa, fb = bmap[lo_sl], bmap[hi_sl]
        valid = a != b
        if ignore_label:
            valid &= (a != 0) & (b != 0)
        m = _inner_ownership(valid, a.shape, axis, size, inner).reshape(-1)
        us.append(torch.where(m, torch.minimum(a, b).reshape(-1), 0))
        vs.append(torch.where(m, torch.maximum(a, b).reshape(-1), 0))
        va.append(fa.reshape(-1))
        vb.append(fb.reshape(-1))
        ok.append(m)
    return (torch.cat(us), torch.cat(vs), torch.cat(va), torch.cat(vb),
            torch.cat(ok))


def boundary_pair_values(labels: torch.Tensor, bmap: torch.Tensor,
                         ignore_label: bool = True,
                         inner_shape: Optional[Tuple[int, ...]] = None):
    """Pairs plus boundary samples, TWO samples per owned face (the nifty
    gridRag convention), concatenated: the two-sample expansion of
    :func:`boundary_pair_values_dual`."""
    u, v, va, vb, ok = boundary_pair_values_dual(
        labels, bmap, ignore_label=ignore_label, inner_shape=inner_shape)
    return (torch.cat([u, u]), torch.cat([v, v]), torch.cat([va, vb]),
            torch.cat([ok, ok]))


def boundary_values(bmap: torch.Tensor) -> torch.Tensor:
    """The samples of :func:`boundary_pair_values` alone, in its layout:
    the pairs depend on the labels only, so several maps over one label
    block share one pair extraction."""
    ndim = bmap.dim()
    va, vb = [], []
    for axis in range(ndim):
        size = bmap.shape[axis] - 1
        if size <= 0:
            continue
        lo_sl, hi_sl = _axis_slices(ndim, axis, size)
        va.append(bmap[lo_sl].reshape(-1))
        vb.append(bmap[hi_sl].reshape(-1))
    return torch.cat(va + vb)


def compact_valid(ok: torch.Tensor, arrays: Sequence[torch.Tensor],
                  cap: int):
    """Compact the valid samples of several same-layout arrays into ``cap``
    slots (slot s holds the s-th valid sample, the rest zeros).  Returns
    ``(compacted_list, cok, overflow)``: ``cok`` flags the populated
    slots, ``overflow`` counts valid samples past ``cap``."""
    pos = torch.nonzero(ok).squeeze(1)
    n_valid = pos.shape[0]
    pos = pos[:cap]
    out = []
    for x in arrays:
        c = torch.zeros(cap, dtype=x.dtype, device=x.device)
        c[:pos.shape[0]] = x[pos]
        out.append(c)
    cok = torch.arange(cap, device=ok.device) < min(n_valid, cap)
    overflow = torch.tensor(max(n_valid - cap, 0), dtype=torch.int32,
                            device=ok.device)
    return out, cok, overflow


def _lerp(lo: torch.Tensor, hi: torch.Tensor, frac: torch.Tensor,
          fused: str) -> torch.Tensor:
    """``lo * (1 - frac) + hi * frac`` with one of the two products fused
    with the sum into a single multiply-add (one rounding): ``fused="lo"``
    rounds ``hi * frac`` first, ``fused="hi"`` rounds ``lo * (1 - frac)``
    first.  XLA contracts the JAX package's expression into the first form
    in the histogram statistics and into the second in the sorted-position
    statistics; matching it keeps the quantiles bitwise equal.  The float64
    product of two float32 values is exact, so a float64 sum rounded to
    float32 is the multiply-add."""
    f64 = torch.float64
    if fused == "lo":
        return (lo.to(f64) * (1.0 - frac).to(f64)
                + (hi * frac).to(f64)).to(torch.float32)
    return (hi.to(f64) * frac.to(f64)
            + (lo * (1.0 - frac)).to(f64)).to(torch.float32)


def _segment_reduce(values, segs, num, reduce, identity):
    out = torch.full((num,), identity, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, segs, values, reduce, include_self=True)


def _runs(sorted_keys: torch.Tensor, valid: torch.Tensor, e_max: int):
    """Run ids of equal consecutive keys (invalid entries and runs past
    ``e_max`` land in the dump bin ``e_max``) and the run count."""
    prev = torch.cat([sorted_keys.new_full((1,), -1), sorted_keys[:-1]])
    starts = (sorted_keys != prev) & valid
    run_id = torch.cumsum(starts.to(torch.int32), 0, dtype=torch.int32) - 1
    n_runs = run_id[-1] + 1
    run_id = torch.where(valid & (run_id < e_max), run_id, e_max)
    return run_id, n_runs, starts


def _hist_finish(hist, u_o, v_o, run_id, valid, n_runs, e_max: int):
    """Exact mean/var/min/max and position-interpolated quantiles from
    per-edge 256-bin histograms (``hist`` still carries the flat dump
    bin), plus the per-edge (u, v) and overflow accounting."""
    dev = hist.device
    num = e_max + 1
    hist = hist[:e_max * 256].reshape(e_max, 256).to(torch.float32)
    cnt = hist.sum(dim=1)
    denom = torch.clamp(cnt, min=1.0)
    # the byte levels as XLA computes ``arange / 255``: a multiply by the
    # float32 reciprocal (its algebraic simplifier rewrites the division)
    levels = torch.arange(256, dtype=torch.float32, device=dev) * \
        torch.tensor(1.0 / 255.0, dtype=torch.float32, device=dev)
    mean = (hist @ levels) / denom
    # centered second moment (the raw sum-of-squares form cancels
    # catastrophically in float32 for low-variance edges)
    diff = levels[None, :] - mean[:, None]
    var = torch.clamp((hist * diff * diff).sum(dim=1) / denom, min=0.0)
    has = (hist > 0).to(torch.int8)
    first = torch.argmax(has, dim=1)
    last = 255 - torch.argmax(has.flip(1), dim=1)
    inf = float("inf")
    mn = torch.where(cnt > 0, levels[first], inf)
    mx = torch.where(cnt > 0, levels[last], -inf)
    cum = torch.cumsum(hist, dim=1)

    def value_at(pos):
        # value of the pos-th (0-based) sample in the edge's sorted
        # multiset: first bin whose cumulative count exceeds pos
        idx = (cum <= pos[:, None]).to(torch.int32).sum(dim=1)
        return levels[torch.clamp(idx, 0, 255)]

    qs = []
    for q in _QS:
        qoff = q * (cnt - 1.0)
        lo_off = torch.floor(qoff)
        frac = qoff - lo_off
        lo_v = value_at(lo_off)
        hi_v = value_at(torch.minimum(lo_off + 1.0, cnt - 1.0))
        qs.append(_lerp(lo_v, hi_v, frac, fused="lo"))

    in_run = run_id < e_max
    rid = run_id.long()
    uv_u = _segment_reduce(torch.where(in_run, u_o, _BIG), rid, num, "amin",
                           _BIG)
    uv_v = _segment_reduce(torch.where(in_run, v_o, _BIG), rid, num, "amin",
                           _BIG)
    feats = torch.stack([mean, var, mn] + qs + [mx, cnt], dim=1)
    uv = torch.stack([uv_u[:e_max], uv_v[:e_max]], dim=1)
    overflow = ((run_id == e_max) & valid).sum()
    return uv, feats, torch.clamp(n_runs, max=e_max), overflow


def plane_face_pairs(lab_a: torch.Tensor, lab_b: torch.Tensor,
                     valid: Optional[torch.Tensor] = None,
                     ignore_label: bool = True):
    """Face pairs between two OPPOSING boundary planes of adjacent
    subproblems (blocks or mesh shards): ``lab_a[i]`` and ``lab_b[i]`` are
    the labels of the two voxels straddling the face (the device form of
    the host face scan; the mesh-resident chain feeds it the neighbour
    shard's received first plane).  Returns flat ``(u, v, ok)`` with
    u < v where ``ok``, zeros elsewhere; ``valid`` masks out subproblems
    without a real upper neighbour (the pair (i, i+1) belongs to the
    subproblem owning voxel i)."""
    ok = lab_a != lab_b
    if ignore_label:
        ok &= (lab_a != 0) & (lab_b != 0)
    if valid is not None:
        ok &= valid
    u = torch.minimum(lab_a, lab_b).reshape(-1)
    v = torch.maximum(lab_a, lab_b).reshape(-1)
    m = ok.reshape(-1)
    return torch.where(m, u, 0), torch.where(m, v, 0), m


def edge_stats_hist_dual(u: torch.Tensor, v: torch.Tensor,
                         bins_a: torch.Tensor, bins_b: torch.Tensor,
                         ok: torch.Tensor, e_max: int):
    """Histogram edge statistics over DUAL-sample pairs
    (``_edge_stats_hist_dual``): each compacted slot carries the boundary
    bytes of both face sides; ids are unrestricted (the mesh-resident
    chain's global labels), so the pairs group by an int64 (u, v) key
    instead of :func:`edge_stats_hist_packed`'s packed one.  Returns
    ``(uv int32 (e_max, 2), feats float32 (e_max, 10), n_runs,
    overflow)``."""
    u_s = torch.where(ok, u, _BIG)
    v_s = torch.where(ok, v, _BIG)
    key = u_s.to(torch.int64) * (2 ** 31) + v_s.to(torch.int64)
    k_o, order = torch.sort(key, stable=True)
    u_o, v_o = u_s[order], v_s[order]
    ba = bins_a[order].to(torch.int64)
    bb = bins_b[order].to(torch.int64)
    valid = u_o != _BIG
    run_id, n_runs, _ = _runs(k_o, valid, e_max)
    in_run = run_id < e_max
    rid = run_id.to(torch.int64)
    size = e_max * 256 + 1
    hidx_a = torch.where(in_run, rid * 256 + ba, e_max * 256)
    hidx_b = torch.where(in_run, rid * 256 + bb, e_max * 256)
    hist = (torch.bincount(hidx_a, minlength=size)
            + torch.bincount(hidx_b, minlength=size))
    return _hist_finish(hist, u_o, v_o, run_id, valid, n_runs, e_max)


def edge_stats_hist_packed(key: torch.Tensor, vab: torch.Tensor,
                           ok: torch.Tensor, e_max: int):
    """Histogram edge statistics over PACKED dual-sample pairs
    (``_edge_stats_hist_packed``): ``key`` carries ``u * 32768 + v``
    (every dense label < 2^15 — the caller guards this) and ``vab``
    carries ``byte_a * 256 + byte_b``.  Returns ``(uv int32 (e_max, 2),
    feats float32 (e_max, 10), n_runs, overflow)``."""
    k_s = torch.where(ok, key, _BIG)
    k_o, order = torch.sort(k_s)
    vab_o = vab[order]
    valid = k_o != _BIG
    run_id, n_runs, _ = _runs(k_o, valid, e_max)
    ba = (vab_o >> 8).to(torch.int64)
    bb = (vab_o & 255).to(torch.int64)
    in_run = run_id < e_max
    rid = run_id.to(torch.int64)
    size = e_max * 256 + 1
    hidx_a = torch.where(in_run, rid * 256 + ba, e_max * 256)
    hidx_b = torch.where(in_run, rid * 256 + bb, e_max * 256)
    hist = (torch.bincount(hidx_a, minlength=size)
            + torch.bincount(hidx_b, minlength=size))
    u_o = k_o >> 15
    v_o = k_o & 32767
    return _hist_finish(hist, u_o, v_o, run_id, valid, n_runs, e_max)


def edge_stats_device(u: torch.Tensor, v: torch.Tensor,
                      values: torch.Tensor, ok: torch.Tensor, e_max: int):
    """Sorted-position per-edge statistics for float samples
    (``_edge_stats_device``): samples sorted by (u, v, value), segmented
    sums for the moments, sorted positions for min/max/quantiles."""
    n = u.shape[0]
    dev = u.device
    num = e_max + 1
    u_s = torch.where(ok, u, _BIG)
    v_s = torch.where(ok, v, _BIG)
    # lexsort by (u, v, value): stable sorts from the last key to the first
    order = torch.sort(values, stable=True).indices
    key = u_s.to(torch.int64) * (2 ** 31) + v_s.to(torch.int64)
    order = order[torch.sort(key[order], stable=True).indices]
    u_o, v_o = u_s[order], v_s[order]
    x = values[order].to(torch.float32)
    valid = u_o != _BIG
    run_id, n_runs, starts = _runs(u_o.to(torch.int64) * (2 ** 31)
                                   + v_o.to(torch.int64), valid, e_max)
    in_run = run_id < e_max
    rid = run_id.long()
    ones = torch.where(in_run, 1.0, 0.0)
    count = torch.zeros(num, dtype=torch.int32, device=dev).index_add_(
        0, rid, in_run.to(torch.int32)).to(torch.float32)
    s1 = torch.zeros(num, dtype=torch.float32, device=dev).index_add_(
        0, rid, x * ones)
    inf = float("inf")
    mn = _segment_reduce(torch.where(in_run, x, inf), rid, num, "amin", inf)
    mx = _segment_reduce(torch.where(in_run, x, -inf), rid, num, "amax",
                         -inf)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    start_pos = _segment_reduce(torch.where(starts, pos, n), rid, num,
                                "amin", _BIG)
    uv_u = _segment_reduce(torch.where(in_run, u_o, _BIG), rid, num, "amin",
                           _BIG)
    uv_v = _segment_reduce(torch.where(in_run, v_o, _BIG), rid, num, "amin",
                           _BIG)

    cnt = count[:e_max]
    denom = torch.clamp(cnt, min=1.0)
    mean = s1[:e_max] / denom
    # variance via the centered second pass
    mean_full = torch.cat([mean, mean.new_zeros(1)])
    centered = (x - mean_full[rid]) ** 2
    s2c = torch.zeros(num, dtype=torch.float32, device=dev).index_add_(
        0, rid, centered * ones)
    var = torch.clamp(s2c[:e_max] / denom, min=0.0)
    sp = start_pos[:e_max]
    last = torch.clamp(sp + cnt.to(torch.int32) - 1, 0, n - 1)
    qs = []
    for q in _QS:
        qoff = q * (cnt - 1.0)
        lo_off = torch.floor(qoff)
        lo = torch.clamp(sp + lo_off.to(torch.int32), 0, n - 1)
        hi = torch.minimum(lo + 1, last)
        frac = qoff - lo_off
        qs.append(_lerp(x[lo.long()], x[hi.long()], frac, fused="hi"))
    feats = torch.stack([mean, var, mn[:e_max]] + qs + [mx[:e_max], cnt],
                        dim=1)
    uv = torch.stack([uv_u[:e_max], uv_v[:e_max]], dim=1)
    overflow = ((run_id == e_max) & valid).sum()
    return uv, feats, torch.clamp(n_runs, max=e_max), overflow


# ---------------------------------------------------------------------------
# the split chain's submit/finalize pair over the sorted-position statistics
# ---------------------------------------------------------------------------


def _pad_pow2(arr: torch.Tensor, n_pad: int, fill=0) -> torch.Tensor:
    n = int(arr.shape[0])
    if n == n_pad:
        return arr
    return torch.cat([arr, arr.new_full((n_pad - n,), fill)])


def _should_compact(n: int, compact: Optional[bool]) -> bool:
    import os

    if compact is not None:
        return compact
    return n >= (1 << 20) and os.environ.get("CTT_RAG_COMPACT", "1") != "0"


def device_edge_stats_submit(u, v, values, ok, e_max: int = 65536,
                             compact: Optional[bool] = None):
    """The per-edge statistics of one block's samples, left on the device
    (pass the result to :func:`device_edge_stats_finalize`).  Inputs are
    padded to the next power of two (at least 16) as in the JAX package;
    padded arrays of 2^20 samples or more are first compacted to their
    valid entries into ``n_pad // 4`` slots (at least 2^14) — an overflow
    raises at finalize; ``compact=False`` or ``CTT_RAG_COMPACT=0`` turns
    the compaction off."""
    return device_edge_stats_submit_multi(u, v, ok, [values], e_max=e_max,
                                          compact=compact)[0]


def device_edge_stats_submit_multi(u, v, ok, values_list,
                                   e_max: int = 65536,
                                   compact: Optional[bool] = None):
    """:func:`device_edge_stats_submit` for several value channels sharing
    one ``(u, v, ok)`` layout: padding and compaction targets are shared."""
    n = int(u.shape[0])
    n_pad = 1 << max(int(np.ceil(np.log2(max(n, 1)))), 4)
    u = _pad_pow2(u, n_pad)
    v = _pad_pow2(v, n_pad)
    ok = _pad_pow2(ok, n_pad, fill=False)
    if _should_compact(n_pad, compact):
        cap = max(n_pad // 4, 1 << 14)
        compacted, cok, overflow = compact_valid(
            ok, [u, v] + [_pad_pow2(x, n_pad) for x in values_list], cap)
        cu, cv = compacted[0], compacted[1]
        return [("compact", edge_stats_device(cu, cv, cx, cok, e_max=e_max),
                 overflow, cap) for cx in compacted[2:]]
    return [("full", edge_stats_device(u, v, _pad_pow2(x, n_pad), ok,
                                       e_max=e_max))
            for x in values_list]


def device_edge_stats_finalize(handles, e_max: int = 65536):
    """Synchronize one submitted block and return its host tables
    ``(uv int64 [E, 2] dense labels, features float64 [E, 10])``; raises
    when the compaction or the edge capacity ``e_max`` overflowed."""
    if handles[0] == "compact":
        _, inner, cap_overflow, cap = handles
        if int(cap_overflow) > 0:
            raise RuntimeError(
                f"boundary samples exceeded the compaction capacity {cap} "
                "(boundary fraction > 25%); pass compact=False or set "
                "CTT_RAG_COMPACT=0 for this volume")
        handles = ("full", inner)
    uv, feats, n_runs, overflow = handles[1]
    if int(overflow) > 0:
        raise RuntimeError(
            f"block has more than e_max={e_max} distinct edges; "
            "increase e_max or use smaller blocks")
    n = int(n_runs)
    return (uv[:n].cpu().numpy().astype("int64"),
            feats[:n].cpu().numpy().astype("float64"))


def device_unique_edges(u, v, ok, e_max: int = 65536) -> np.ndarray:
    """The block's unique ``(u, v)`` edge table, deduplicated on the
    device (the statistics' sort, with zero values), synchronously."""
    zeros = torch.zeros_like(u, dtype=torch.float32)
    uv, _ = device_edge_stats_finalize(
        device_edge_stats_submit(u, v, zeros, ok, e_max=e_max), e_max)
    return uv


# ---------------------------------------------------------------------------
# host-side pair extraction and statistics (numpy)
# ---------------------------------------------------------------------------


def _host_axis_pairs(labels: np.ndarray, ignore_label: bool,
                     inner_shape) -> List[Tuple[np.ndarray, ...]]:
    ndim = labels.ndim
    inner = inner_shape or labels.shape
    out = []
    for axis in range(ndim):
        size = labels.shape[axis] - 1
        if size <= 0:
            continue
        lo = [slice(None)] * ndim
        hi = [slice(None)] * ndim
        lo[axis] = slice(0, size)
        hi[axis] = slice(1, size + 1)
        a, b = labels[tuple(lo)], labels[tuple(hi)]
        valid = a != b
        if ignore_label:
            valid &= (a != 0) & (b != 0)
        for ax2 in range(ndim):
            lim = inner[ax2] if ax2 != axis else min(inner[ax2], size)
            if a.shape[ax2] > lim:
                sl = [slice(None)] * ndim
                sl[ax2] = slice(lim, None)
                valid[tuple(sl)] = False
        out.append((a, b, valid, tuple(lo)))
    return out


def host_label_pairs(labels: np.ndarray, ignore_label: bool = True,
                     inner_shape=None) -> np.ndarray:
    """Numpy analog of :func:`label_pairs` + dedup: the block's sorted
    unique ``(u, v)`` edge table."""
    pairs = []
    for a, b, valid, _ in _host_axis_pairs(labels, ignore_label,
                                           inner_shape):
        av, bv = a[valid], b[valid]
        pairs.append(np.stack([np.minimum(av, bv), np.maximum(av, bv)],
                              axis=1))
    if not pairs:
        return np.zeros((0, 2), "uint64")
    return np.unique(np.concatenate(pairs), axis=0)


def host_boundary_edge_features(labels: np.ndarray, bmap: np.ndarray,
                                ignore_label: bool = True,
                                inner_shape=None
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy per-edge ``(uv, features)`` tables via :func:`segmented_stats`
    (two samples per face voxel pair, the nifty gridRag convention)."""
    ndim = labels.ndim
    us, vs, xs = [], [], []
    for a, b, valid, lo in _host_axis_pairs(labels, ignore_label,
                                            inner_shape):
        axis = next(d for d in range(ndim) if lo[d] != slice(None))
        hi_sl = list(lo)
        hi_sl[axis] = slice(1, a.shape[axis] + 1)
        av, bv = a[valid], b[valid]
        u, v = np.minimum(av, bv), np.maximum(av, bv)
        for side in (lo, tuple(hi_sl)):
            us.append(u)
            vs.append(v)
            xs.append(bmap[side][valid])
    if not us:
        return np.zeros((0, 2), "int64"), np.zeros((0, N_FEATURES),
                                                   "float64")
    u = np.concatenate(us)
    v = np.concatenate(vs)
    x = np.concatenate(xs).astype("float64")
    uv = np.stack([u, v], axis=1)
    uniq, inv = np.unique(uv, axis=0, return_inverse=True)
    feats = segmented_stats(inv.reshape(-1), x, len(uniq))
    return uniq.astype("int64"), feats


def unique_pairs(u: np.ndarray, v: np.ndarray):
    """Deduplicated ``(u, v)`` rows plus inverse indices (packed-u64-key
    ``np.unique``, with a structured fallback for ids past 2^32)."""
    u = np.asarray(u)
    v = np.asarray(v)
    if len(v) == 0:
        return np.zeros((0, 2), "uint64"), np.zeros((0,), "int64")
    if v.max() < (1 << 32):
        keys = (u.astype("uint64") << np.uint64(32)) | v.astype("uint64")
        ukeys, inv = np.unique(keys, return_inverse=True)
        uniq = np.stack([ukeys >> np.uint64(32),
                         ukeys & np.uint64(0xFFFFFFFF)], axis=1)
    else:
        pairs = np.stack([u.astype("uint64"), v.astype("uint64")], axis=1)
        uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
    return uniq.astype("uint64"), inv.reshape(-1)


def segmented_stats(edge_index: np.ndarray, values: np.ndarray,
                    n_edges: int) -> np.ndarray:
    """Per-edge [mean, var, min, q10..q90, max, count] over samples: one
    lexsort by (edge, value), reduceat for moments, fractional indexing
    for exact interpolated quantiles per segment."""
    out = np.zeros((n_edges, N_FEATURES), dtype="float64")
    if len(edge_index) == 0:
        return out
    order = np.lexsort((values, edge_index))
    e = edge_index[order]
    x = values[order].astype("float64")
    starts = np.flatnonzero(np.r_[True, e[1:] != e[:-1]])
    seg_ids = e[starts]
    counts = np.diff(np.r_[starts, len(e)])
    sums = np.add.reduceat(x, starts)
    sqs = np.add.reduceat(x * x, starts)
    mean = sums / counts
    var = np.maximum(sqs / counts - mean ** 2, 0.0)
    out[seg_ids, 0] = mean
    out[seg_ids, 1] = var
    out[seg_ids, 2] = x[starts]                      # min (sorted within seg)
    out[seg_ids, 8] = x[starts + counts - 1]         # max
    for qi, q in enumerate(_QS):
        pos = starts + q * (counts - 1)
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, starts + counts - 1)
        frac = pos - lo
        out[seg_ids, 3 + qi] = x[lo] * (1 - frac) + x[hi] * frac
    out[seg_ids, 9] = counts
    return out


def merge_feature_blocks(partials: Sequence[Tuple[np.ndarray, np.ndarray]],
                         n_edges: int, n_feats: int = N_FEATURES
                         ) -> np.ndarray:
    """Combine per-block feature rows into global per-edge features.

    ``partials`` = iterable of (edge_ids, features[E_b, n_feats]), where the
    columns are one or more 9-wide stat groups ([mean, variance, min,
    q10, q25, q50, q75, q90, max]) followed by a single shared sample-count
    column.  Mean/variance merge exactly (count-weighted moments); min/max
    elementwise; quantiles merge as count-weighted means — an approximation
    (the reference's C++ merge makes the same trade, nifty
    mergeFeatureBlocks).
    """
    n_groups = (n_feats - 1) // 9
    if n_groups * 9 + 1 != n_feats:
        raise ValueError(f"feature width {n_feats} is not 9*k+1")
    cnt = np.zeros(n_edges, "float64")
    s1 = np.zeros((n_edges, n_groups), "float64")    # Σ w·mean
    s2 = np.zeros((n_edges, n_groups), "float64")    # Σ w·(var + mean²)
    mn = np.full((n_edges, n_groups), np.inf)
    mx = np.full((n_edges, n_groups), -np.inf)
    qs = np.zeros((n_edges, n_groups, len(_QS)), "float64")
    for edge_ids, feats in partials:
        # zero-count rows (edges with no samples in this block) must not
        # pollute min/max/moments
        nz = feats[:, -1] > 0
        edge_ids, feats = edge_ids[nz], feats[nz]
        if len(edge_ids) == 0:
            continue
        w = feats[:, -1]
        np.add.at(cnt, edge_ids, w)
        for gi in range(n_groups):
            base = 9 * gi
            np.add.at(s1[:, gi], edge_ids, w * feats[:, base])
            np.add.at(s2[:, gi], edge_ids,
                      w * (feats[:, base + 1] + feats[:, base] ** 2))
            np.minimum.at(mn[:, gi], edge_ids, feats[:, base + 2])
            np.maximum.at(mx[:, gi], edge_ids, feats[:, base + 8])
            for qi in range(len(_QS)):
                np.add.at(qs[:, gi, qi], edge_ids,
                          w * feats[:, base + 3 + qi])
    out = np.zeros((n_edges, n_feats), "float64")
    nz = cnt > 0
    for gi in range(n_groups):
        base = 9 * gi
        out[nz, base] = s1[nz, gi] / cnt[nz]
        out[nz, base + 1] = np.maximum(
            s2[nz, gi] / cnt[nz] - out[nz, base] ** 2, 0.0)
        out[nz, base + 2] = mn[nz, gi]
        out[nz, base + 8] = mx[nz, gi]
        for qi in range(len(_QS)):
            out[nz, base + 3 + qi] = qs[nz, gi, qi] / cnt[nz]
    out[:, -1] = cnt
    return out
