"""Seeded watershed on the card: descent forest + saddle merging.

Port of the pieces of cluster_tools_tpu/ops/watershed.py that the fused
chain runs (the replacement for vigra's ``watershedsNew``, reference
utils/volume_utils.py:123-139):

* :func:`basins` (``_basins_impl``): steepest-descent forest with
  lexicographic (height, index) tie-breaking, pointer jumping to roots,
  dense basin ids, then Boruvka rounds that attach every unlabeled basin
  group across its lowest saddle; ``min_size`` strips too-small fragments
  and keeps merging.  ``b_cap``/``k_cap`` size the basin and candidate
  tables; demand beyond them clears the returned ``ok`` flag.
* :func:`coarse` (``_coarse_impl``): the same solve on a ``factor``-times
  coarser grid, upsampled and refined with steepest-descent sweeps.
* :func:`seeded_watershed_flood`: the quantized priority flood
  (``method="flood"``), the level-ordered formulation.
* :func:`dense_relabel`, :func:`extent_valid_mask`, :func:`seeded_watershed`
  (masked or not, either method), :func:`seeded_watershed_batched` (per
  z-slice) and :func:`size_filter` (the split chain's per-block watershed
  and the fused chain's host fallback).

Tie-breaking is lexicographic on (height, linear index), so given the same
height and seeds the labels equal the JAX package's exactly.  Where JAX
scatters with ``mode="drop"``, the targets are masked before the scatter;
``segment_min`` becomes ``scatter_reduce("amin")`` over an output filled
with the identity (+inf / int32 max), which is what JAX gives empty
segments.  Each ``while_loop`` convergence test is a host sync here; the
cheap pointer-jumping loops test every few iterations (a converged state
stays converged, so the result is the same).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .components import _neighbor_offsets, _shifted

_I32_MAX = 2 ** 31 - 1
_F32_MAX = float(np.finfo(np.float32).max)
#: pointer-jumping steps between two convergence checks (host syncs)
JUMP_CHECK_EVERY = 4


def extent_valid_mask(local_shape, extent=None, device=None, origin=None,
                      vol_shape=None) -> torch.Tensor:
    """Validity mask over a block- or shard-local window.

    Two conventions, one mask: pass ``extent`` (per-axis REAL size of a
    clipped border block — the blockwise chain's convention), or a
    shard-local ``origin`` plus the global ``vol_shape`` — the
    mesh-resident convention, where a shard's window may overrun the
    volume end by the shard-equalizing pad.  Positions at or past the
    volume end are invalid (their reflect-padded content must never enter
    label ranks, id counts or pair sets)."""
    if extent is None:
        if origin is None or vol_shape is None:
            raise ValueError("pass extent, or origin + vol_shape")
        extent = [int(vol_shape[d]) - int(origin[d])
                  for d in range(len(local_shape))]
    valid = torch.ones(tuple(local_shape), dtype=torch.bool, device=device)
    for d, n in enumerate(local_shape):
        shape_d = [1] * len(local_shape)
        shape_d[d] = n
        coord = torch.arange(n, device=device)
        valid &= (coord < int(extent[d])).reshape(shape_d)
    return valid


def dense_relabel(inner: torch.Tensor, n_bound: int,
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense per-window relabel (presence flags + cumsum rank) of the
    nonzero labels in ``inner``, whose values are bounded by ``n_bound``.
    ``valid`` masks voxels out of the relabel entirely.  Returns
    ``(dense_grid int32, k)`` with dense ids consecutive in [1, k]."""
    if valid is not None:
        inner = torch.where(valid, inner, 0)
    flat = inner.reshape(-1).to(torch.int64)
    size = n_bound + 2
    pres = torch.zeros(size, dtype=torch.int32, device=inner.device)
    pres[flat[flat < size]] = 1
    pres[0] = 0
    rank = torch.cumsum(pres, 0, dtype=torch.int32)
    # out-of-range labels read the last rank (JAX gathers clamp)
    dense = torch.where(flat > 0, rank[flat.clamp(max=size - 1)], 0)
    return dense.to(torch.int32).reshape(inner.shape), rank[-1]


def _jump(p: torch.Tensor, bound: int = 64) -> torch.Tensor:
    """Pointer jumping ``p = p[p]`` until fixed (at most ``bound`` steps)."""
    it = 0
    while it < bound:
        for _ in range(min(JUMP_CHECK_EVERY, bound - it)):
            prev = p
            p = p[p.long()]
            it += 1
        if not bool((p != prev).any()):
            break
    return p


def _segment_min(values: torch.Tensor, segs: torch.Tensor, num: int,
                 identity) -> torch.Tensor:
    out = torch.full((num,), identity, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, segs.long(), values, "amin",
                               include_self=True)


def basins(height: torch.Tensor, seeds: torch.Tensor,
           mask: Optional[torch.Tensor], connectivity: int, max_rounds: int,
           min_size: int, b_cap: int, k_cap: int, offsets=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Basin-merging seeded watershed (``_basins_impl``); returns
    ``(labels int32, ok bool tensor)``.  ``offsets`` replaces the
    neighborhood of ``connectivity`` (the per-slice watershed passes the
    in-plane offsets of a stack)."""
    shape = tuple(height.shape)
    dev = height.device
    n = int(np.prod(shape))
    height = height.to(torch.float32)
    mask = (torch.ones(shape, dtype=torch.bool, device=dev) if mask is None
            else mask.to(torch.bool))
    if offsets is None:
        offsets = _neighbor_offsets(len(shape), connectivity)
    big = _F32_MAX

    h = torch.where(mask, height, big)
    seeded = (seeds > 0) & mask
    h = torch.where(seeded, -big, h)
    flat_idx = torch.arange(n, dtype=torch.int32, device=dev).reshape(shape)

    # steepest-descent pointer: lexicographic min over (h, idx) of
    # self+nbrs; a seeded voxel may only point within its own seed cluster
    sv = seeds.to(torch.int32)
    best_h, best_i = h, flat_idx
    for off in offsets:
        nh = _shifted(h, off, big)
        ni = _shifted(flat_idx, off, n)
        ns = _shifted(sv, off, 0)
        allowed = ~(seeded & (ns != sv))
        better = allowed & ((nh < best_h) | ((nh == best_h) & (ni < best_i)))
        best_h = torch.where(better, nh, best_h)
        best_i = torch.where(better, ni, best_i)
    parent = torch.where(mask, best_i, flat_idx).reshape(-1)
    root = _jump(parent)

    seed_flat = sv.reshape(-1)
    mask_flat = mask.reshape(-1)
    h_flat = torch.where(mask, height, big).reshape(-1)
    idx = torch.arange(n, dtype=torch.int32, device=dev)

    # dense basin ids without scatters: a root is root[v] == v
    is_root = (root == idx) & mask_flat
    rank = torch.cumsum(is_root.to(torch.int32), 0, dtype=torch.int32) - 1
    n_basins = rank[-1] + 1 if n > 0 else torch.zeros((), dtype=torch.int32,
                                                       device=dev)
    rr = rank[root.long()]
    basin_of = torch.where(rr < b_cap, rr, b_cap)
    basin_label = torch.zeros(b_cap + 1, dtype=torch.int32, device=dev)
    basin_label[basin_of[is_root].long()] = seed_flat[is_root]

    basin_of_l = basin_of.long()
    h_grid = h_flat.reshape(shape)
    gidx = torch.arange(b_cap + 1, dtype=torch.int32, device=dev)

    def boruvka_round(bparent, blabel, ok):
        group = _jump(bparent)
        glab = blabel[group.long()]
        code = group * 2 + (glab > 0).to(torch.int32)
        vcode = code[basin_of_l]
        vg = vcode >> 1
        vlab = vcode & 1
        vg_grid = vg.reshape(shape)

        # voxel-space stencil: best (saddle, neighbor group) per voxel
        sad = torch.full((n,), big, dtype=torch.float32, device=dev)
        nbr = torch.full((n,), b_cap, dtype=torch.int32, device=dev)
        for off in offsets:
            oh = _shifted(h_grid, off, big).reshape(-1)
            og = _shifted(vg_grid, off, b_cap).reshape(-1)
            s = torch.maximum(h_flat, oh)
            valid = (og != vg) & (og < b_cap) & (s < big) & mask_flat
            bet = valid & ((s < sad) | ((s == sad) & (og < nbr)))
            sad = torch.where(bet, s, sad)
            nbr = torch.where(bet, og, nbr)
        cand = (vlab == 0) & mask_flat & (nbr < b_cap)
        # compaction of candidates to k_cap slots; demand beyond the cap
        # clears the ok flag
        ctgt = torch.cumsum(cand.to(torch.int32), 0, dtype=torch.int32) - 1
        if n > 0:
            ok = ok & (ctgt[-1] + 1 <= k_cap)
        sel = cand & (ctgt < k_cap)
        tgt = ctgt[sel].long()
        cg = torch.full((k_cap,), b_cap, dtype=torch.int32, device=dev)
        cs = torch.full((k_cap,), big, dtype=torch.float32, device=dev)
        cn = torch.full((k_cap,), b_cap, dtype=torch.int32, device=dev)
        cg[tgt] = vg[sel]
        cs[tgt] = sad[sel]
        cn[tgt] = nbr[sel]
        # basin-space segment mins over the compacted candidates
        smin = _segment_min(cs, cg, b_cap + 1, float("inf"))
        at_min = (cs == smin[cg.long()]) & (cs < big)
        attach = _segment_min(torch.where(at_min, cn, b_cap), cg,
                              b_cap + 1, _I32_MAX)
        attach = torch.where(attach < b_cap, attach, gidx)
        attach = torch.where(blabel > 0, gidx, attach)   # labeled absorb
        # break 2-cycles toward the lower group id
        attach2 = attach[attach.long()]
        attach = torch.where((attach2 == gidx) & (attach > gidx), gidx,
                             attach)
        new_parent = attach[group.long()]
        changed = bool((new_parent != bparent).any())
        return new_parent, ok, changed

    def merge_loop(bparent, blabel, ok):
        for _ in range(max_rounds):
            bparent, ok, changed = boruvka_round(bparent, blabel, ok)
            if not changed:
                break
        return bparent, ok

    ok = n_basins <= b_cap
    bparent = gidx.clone()
    bparent, ok = merge_loop(bparent, basin_label, ok)

    if min_size:
        # fused size filter: strip labels of too-small fragments, keep
        # merging — small fragments re-attach across their lowest saddles
        group = _jump(bparent).long()
        sizes = torch.zeros(b_cap + 1, dtype=torch.int32, device=dev)
        sizes.index_add_(0, group[basin_of_l], mask_flat.to(torch.int32))
        small = (sizes < min_size) & (sizes > 0)
        basin_label = torch.where(small[group], 0, basin_label[group])
        bparent, ok = merge_loop(bparent, basin_label, ok)

    group = _jump(bparent).long()
    labels = basin_label[group][basin_of_l]
    labels = torch.where(mask_flat, labels, 0)
    return labels.reshape(shape), ok


def seeded_watershed(height: torch.Tensor, seeds: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     connectivity: int = 1, max_iter: int = 0,
                     method: Optional[str] = None) -> torch.Tensor:
    """Grow ``seeds`` (int labels, 0 = unlabeled) over ``height`` restricted
    to ``mask``; int32 labels, 0 only outside the mask.

    ``method``: ``"basins"`` (the default; the environment's
    ``CTT_WS_METHOD`` overrides it, as in the JAX package) — the
    basin-merging watershed at the natural-volume capacities, re-run at the
    exact worst-case capacities when they overflow — or ``"flood"``, the
    quantized priority flood (:func:`seeded_watershed_flood`, bounded by
    ``max_iter``)."""
    method = method or os.environ.get("CTT_WS_METHOD", "basins")
    if method == "flood":
        return seeded_watershed_flood(height, seeds, mask, connectivity,
                                      max_iter)
    if method != "basins":
        raise ValueError(f"unknown watershed method {method!r} "
                         "(expected 'basins' or 'flood')")
    return _basins_retry(height, seeds, mask, connectivity)


def _basins_retry(height, seeds, mask, connectivity, offsets=None):
    """:func:`basins` at the natural-volume capacities, re-run at the
    exact worst-case capacities when they overflow."""
    n = int(np.prod(height.shape))
    labels, ok = basins(height, seeds, mask, connectivity, 64, 0,
                        max(n // 64, 1024), max(n // 8, 4096), offsets)
    if bool(ok):
        return labels
    labels, _ = basins(height, seeds, mask, connectivity, 64, 0,
                       n // 2 + 2, n, offsets)
    return labels


#: flood bodies run between two host reads of the loop condition
FLOOD_CHECK_EVERY = 8


def seeded_watershed_flood(height: torch.Tensor, seeds: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           connectivity: int = 1,
                           max_iter: int = 0) -> torch.Tensor:
    """Level-ordered (quantized priority flood) seeded watershed — the
    JAX package's ``seeded_watershed_flood``: a steepest-descent forest
    resolved by pointer jumping, then a 256-level flood (at each water
    level the unlabeled voxels at or below it adopt their lowest labeled
    neighbor's label until stable, then the level jumps to the lowest one
    on the frontier), then a backstop fill.

    The JAX package runs three ``while_loop`` loops.  Here the loop condition
    is read on the host every :data:`FLOOD_CHECK_EVERY` bodies; jumping and
    the fill reach fixed points, so their extra bodies change nothing, and
    every extra flood body is gated on the condition (a device bool), so
    the labels equal the JAX package's."""
    shape = tuple(height.shape)
    dev = height.device
    n = int(np.prod(shape))
    height = height.to(torch.float32)
    mask = (torch.ones(shape, dtype=torch.bool, device=dev) if mask is None
            else mask.to(torch.bool))
    if max_iter == 0:
        # the fill advances one voxel per body along geodesic paths, so the
        # only data-independent bound is the voxel count
        max_iter = max(n, 32)
    offsets = _neighbor_offsets(len(shape), connectivity)
    big = _F32_MAX

    h = torch.where(mask, height, big)
    seeded = (seeds > 0) & mask
    h = torch.where(seeded, -big, h)
    flat_idx = torch.arange(n, dtype=torch.int32, device=dev).reshape(shape)
    # steepest-descent pointer: the strictly lowest neighbor, ties toward
    # the lower linear index
    best_h, best_i = h, flat_idx
    for off in offsets:
        nh = _shifted(h, off, big)
        ni = _shifted(flat_idx, off, n)
        better = (nh < best_h) | ((nh == best_h) & (ni < best_i) & (nh < h))
        best_h = torch.where(better, nh, best_h)
        best_i = torch.where(better, ni, best_i)
    parent = torch.where(mask, best_i, flat_idx).reshape(-1)
    parent = torch.where(seeded.reshape(-1), flat_idx.reshape(-1), parent)
    parent = _jump(parent, bound=max_iter)

    seed_flat = seeds.to(torch.int32).reshape(-1)
    labels = torch.where(mask.reshape(-1), seed_flat[parent.long()], 0)

    n_levels = 256
    hg = torch.where(mask, height, big)
    h_lo = hg.min()
    h_hi = torch.where(mask, height, -big).max()
    hq = ((hg - h_lo) / torch.clamp(h_hi - h_lo, min=1e-6)
          * float(n_levels - 1)).to(torch.int32).clamp(0, n_levels - 1)
    hq = torch.where(mask, hq, n_levels)
    shifted_h = [_shifted(hg, off, big) for off in offsets]

    def lowest_labeled_neighbor(lab_g):
        nbr_h = torch.full(shape, big, dtype=torch.float32, device=dev)
        nbr_l = torch.zeros(shape, dtype=torch.int32, device=dev)
        for off, oh in zip(offsets, shifted_h):
            ol = _shifted(lab_g, off, 0)
            cand = (ol > 0) & (oh < nbr_h)
            nbr_h = torch.where(cand, oh, nbr_h)
            nbr_l = torch.where(cand, ol, nbr_l)
        return nbr_l

    def flood_body(lab, level):
        lab_g = lab.reshape(shape)
        nbr_l = lowest_labeled_neighbor(lab_g)
        free = (lab_g == 0) & mask & (nbr_l > 0)
        new = torch.where(free & (hq <= level), nbr_l, lab_g).reshape(-1)
        changed = (new != lab).any()
        # stable at this water level -> jump to the lowest level on the
        # frontier
        next_level = torch.where(free, hq, n_levels).min()
        level = torch.where(changed, level,
                            torch.maximum(level + 1, next_level))
        return new, level

    level = torch.zeros((), dtype=torch.int32, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    bound = max_iter + n_levels
    while True:
        for _ in range(FLOOD_CHECK_EVERY):
            active = (level < n_levels) & (it < bound)
            new, new_level = flood_body(labels, level)
            labels = torch.where(active, new, labels)
            level = torch.where(active, new_level, level)
            it = it + active.to(torch.int32)
        if not bool((level < n_levels) & (it < bound)):
            break

    # backstop only: does work solely if the flood's bound was hit early
    it = 0
    while it < max_iter:
        for _ in range(min(FLOOD_CHECK_EVERY, max_iter - it)):
            lab_g = labels.reshape(shape)
            nbr_l = lowest_labeled_neighbor(lab_g)
            adopt = (lab_g == 0) & mask & (nbr_l > 0)
            prev = labels
            labels = torch.where(adopt, nbr_l, lab_g).reshape(-1)
            it += 1
        if not bool((labels != prev).any()):
            break
    return labels.reshape(shape)


def seeded_watershed_batched(heights: torch.Tensor, seeds: torch.Tensor,
                             masks: Optional[torch.Tensor] = None,
                             connectivity: int = 1,
                             method: Optional[str] = None) -> torch.Tensor:
    """Per-slice seeded watershed over the leading axis (the JAX package
    maps it with ``vmap``): each slice solved alone.  ``basins`` runs once
    over the stack with the in-plane neighborhood only: no voxel sees
    another slice, every tie-break compares indices and group ids within
    one slice (whose order a slice's offset keeps), and the capacities
    change no result they hold; ``flood`` quantizes each slice's own
    height range, so it loops over the slices."""
    method = method or os.environ.get("CTT_WS_METHOD", "basins")
    if method == "basins":
        offsets = tuple((0,) + o for o in _neighbor_offsets(
            heights.dim() - 1, connectivity))
        return _basins_retry(heights, seeds, masks, connectivity, offsets)
    return torch.stack([
        seeded_watershed(heights[i], seeds[i],
                         None if masks is None else masks[i], connectivity,
                         method=method)
        for i in range(heights.shape[0])])


def coarse(height: torch.Tensor, seeds: torch.Tensor, min_size: int,
           refine_rounds: int, factor: int = 2, dense_ids: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``factor``x-coarse basin watershed (``_coarse_impl``): mean-pool the
    height, max-pool the seeds, solve with :func:`basins` on the coarse
    grid, upsample, and snap boundaries back at full resolution with
    ``refine_rounds`` steepest-descent adoption sweeps.  Short dims are
    edge-padded to a multiple of ``factor`` and cropped back.
    ``min_size`` is in full-resolution voxels."""
    shape = tuple(height.shape)
    f = int(factor)
    pads = [(f - s % f) % f for s in shape]
    height_p, seeds_p = height, seeds
    for ax, p in enumerate(pads):
        if p:
            edge = height_p.narrow(ax, height_p.shape[ax] - 1, 1)
            height_p = torch.cat([height_p] + [edge] * p, dim=ax)
            zshape = list(seeds_p.shape)
            zshape[ax] = p
            seeds_p = torch.cat([seeds_p, seeds_p.new_zeros(zshape)], dim=ax)
    cshape = tuple(s // f for s in height_p.shape)
    cn = int(np.prod(cshape))
    h6 = height_p.reshape(cshape[0], f, cshape[1], f, cshape[2], f)
    # the pooled sum runs over the window in row-major order, as XLA's
    # reduction does, then divides by the window size (exact for f = 2, 4)
    acc = None
    for a in range(f):
        for b in range(f):
            for c in range(f):
                term = h6[:, a, :, b, :, c]
                acc = term if acc is None else acc + term
    hc = acc / float(f ** 3)
    sc = seeds_p.reshape(cshape[0], f, cshape[1], f, cshape[2], f).amax(
        dim=(1, 3, 5))
    wsc, ok = basins(hc, sc, None, 1, 64, max(min_size // (f ** 3), 1),
                     min(max(cn // 8, 4096), cn // 2 + 2),
                     min(max(cn // 2, 16384), cn))
    if dense_ids:
        # dense-rank the label values on the coarse grid
        flatc = wsc.reshape(-1)
        s = torch.sort(flatc).values
        is_new = torch.cat([s[:1] > 0, (s[1:] != s[:-1]) & (s[1:] > 0)])
        rank = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32)
        pos = torch.searchsorted(s, flatc)
        wsc = torch.where(flatc > 0, rank[pos], 0).reshape(wsc.shape)
    ws = wsc.repeat_interleave(f, 0).repeat_interleave(f, 1) \
        .repeat_interleave(f, 2)
    ws = ws[tuple(slice(0, s) for s in shape)]

    big = 3.4e38
    face_offsets = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                    (0, 0, 1), (0, 0, -1))
    shifted_h = [_shifted(height, off, big) for off in face_offsets]
    for _ in range(refine_rounds):
        best_h, best_l = height, ws
        for off, nh in zip(face_offsets, shifted_h):
            nl = _shifted(ws, off, 0)
            better = (nh < best_h) & (nl > 0)
            best_h = torch.where(better, nh, best_h)
            best_l = torch.where(better, nl, best_l)
        ws = best_l
    return ws, ok


def size_filter(labels: np.ndarray, height: torch.Tensor,
                size_threshold: int, mask: Optional[torch.Tensor] = None,
                connectivity: int = 1, per_slice: bool = False
                ) -> np.ndarray:
    """Remove fragments smaller than ``size_threshold`` and regrow the
    remaining seeds over the height map within ``mask`` (a boolean tensor
    on the height map's device; reference:
    utils/volume_utils.py:123-139 watershed-and-size-filter).  Host-side
    counting + one watershed pass on the height map's device;
    ``per_slice`` regrows each z-slice on its own (the 2d watershed)."""
    labels = np.asarray(labels)
    flat = labels.ravel()
    uniques, inverse, counts = np.unique(flat, return_inverse=True,
                                         return_counts=True)
    inverse = inverse.reshape(-1)
    small = (counts < size_threshold) & (uniques != 0)
    if not small.any():
        return labels
    keep = np.where(small[inverse], 0, flat).reshape(labels.shape)
    # regrown labels must fit the watershed's int32 seed ids: compact first,
    # restore original ids after
    nz = uniques[(uniques != 0) & ~small]
    seed_ids = np.searchsorted(nz, keep).astype("int32") + 1
    seed_ids[keep == 0] = 0
    grow = seeded_watershed_batched if per_slice else seeded_watershed
    out = grow(height, torch.from_numpy(seed_ids).to(height.device), mask,
               connectivity).cpu().numpy()
    restored = np.zeros(out.shape, dtype=labels.dtype)
    fg = out > 0
    restored[fg] = nz[out[fg] - 1]
    return restored
