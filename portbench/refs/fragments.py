"""Plain reference of the fused chain's fragments, one block at a time.

A frozen transcription, in plain PyTorch, of the published per-block
watershed of the fused multicut chain at its default settings:

1. the volume reflect-padded by the halo at the volume level (period
   ``2n - 2``), each block's outer window cut from it;
2. the uint8 boundaries scaled by the float32 reciprocal of 255;
3. the exact Euclidean distance transform of ``x < threshold`` (a dense
   min-plus product per axis: exact integer squared distances, then the
   correctly rounded square root);
4. the height ``alpha * G(x) + (1 - alpha) * (1 - dt / max(dt))`` and the
   seeds, the 26-connected components of the local maxima (radius 2) of
   ``G(dt)`` inside the foreground, labelled by their least linear index
   plus one (``G``: Gaussian of sigma 2, truncated at 4 sigma, symmetric
   padding, taps applied as shifted multiply-adds in float32);
5. the basin watershed on the 2x coarser grid (mean-pooled height,
   max-pooled seeds): a steepest-descent forest with (height, index)
   tie-breaking, then Boruvka rounds attaching every unlabelled basin
   group across its lowest saddle, the size filter, and 3 refinement
   sweeps at full resolution.

Only the partition is compared, so the ids need not agree.  ``lowp``
computes steps 2 and 4's arithmetic in bfloat16 (the control).  Nothing
here imports the program.
"""

from __future__ import annotations

from itertools import product
from typing import Sequence, Tuple

import numpy as np
import torch

BIG = 1e10
_F32_MAX = float(np.finfo(np.float32).max)
_I32_MAX = 2 ** 31 - 1


# --- geometry ---------------------------------------------------------------

def reflect_indices(start: int, stop: int, n: int) -> np.ndarray:
    idx = np.arange(start, stop)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * n - 2
    j = np.mod(idx, period)
    return np.where(j < n, j, period - j)


def padded_volume(vol: torch.Tensor, block: Sequence[int],
                  halo: Sequence[int]) -> torch.Tensor:
    """The grid-aligned volume padded by ``halo`` by volume-level
    reflection (block b's outer window starts at ``b * block``)."""
    idx = []
    for h, b, s in zip(halo, block, vol.shape):
        g = -(-s // b)
        idx.append(torch.from_numpy(reflect_indices(-h, g * b + h, s)).to(
            vol.device))
    return vol[idx[0]][:, idx[1]][:, :, idx[2]]


# --- filters ----------------------------------------------------------------

def _gaussian_taps(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = max(int(truncate * sigma + 0.5), 1)
    x = np.arange(-radius, radius + 1, dtype="float64")
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    return g.astype("float32")


def gaussian(x: torch.Tensor, sigma: float) -> torch.Tensor:
    out = x
    taps = _gaussian_taps(sigma)[::-1]
    k = taps.shape[0]
    r = (k - 1) // 2
    for ax in range(x.dim()):
        n = out.shape[ax]
        sym = torch.from_numpy(np.pad(np.arange(n), r, mode="symmetric")).to(
            x.device)
        xp = torch.index_select(out, ax, sym)
        acc = None
        for j in range(k):
            term = xp.narrow(ax, j, n) * float(taps[j])
            acc = term if acc is None else acc + term
        out = acc
    return out


def box_max(x: torch.Tensor, w: int) -> torch.Tensor:
    out = x.to(torch.float32)
    lo, hi = (w - 1) // 2, w - 1 - (w - 1) // 2
    for ax in range(x.dim()):
        n = out.shape[ax]
        shp = list(out.shape)
        xp = torch.cat([out.new_full(shp[:ax] + [lo] + shp[ax + 1:],
                                     -float("inf")), out,
                        out.new_full(shp[:ax] + [hi] + shp[ax + 1:],
                                     -float("inf"))], dim=ax)
        m = xp.narrow(ax, 0, n)
        for j in range(1, w):
            m = torch.maximum(m, xp.narrow(ax, j, n))
        out = m
    return out


def edt(mask: torch.Tensor) -> torch.Tensor:
    """Exact EDT of a boolean mask (distance to the nearest False)."""
    dsq = torch.where(mask, BIG, 0.0).to(torch.float32)
    for ax in range(mask.dim()):
        n = dsq.shape[ax]
        xm = torch.movedim(dsq, ax, -1).contiguous()
        flat = xm.reshape(-1, n)
        i = torch.arange(n, device=mask.device, dtype=torch.int32)
        d = (i[:, None] - i[None, :]).to(torch.float32)
        cost = d * d
        rows = max((1 << 27 if mask.is_cuda else 1 << 22) // (n * n), 1)
        out = torch.empty_like(flat)
        for r0 in range(0, flat.shape[0], rows):
            t = flat[r0:r0 + rows]
            out[r0:r0 + rows] = torch.amin(t[:, None, :] + cost[None],
                                           dim=-1)
        dsq = torch.movedim(out.reshape(xm.shape), -1, ax)
    return torch.sqrt(dsq.to(torch.float64)).to(torch.float32)


# --- components and watershed ----------------------------------------------

def _offsets(ndim: int, connectivity: int):
    return tuple(o for o in product((-1, 0, 1), repeat=ndim)
                 if 0 < sum(abs(v) for v in o) <= connectivity)


def shifted(arr: torch.Tensor, offset, fill) -> torch.Tensor:
    """The value at ``i + offset`` for each voxel i (``fill`` outside)."""
    out = torch.full_like(arr, fill)
    src, dst = [], []
    for o, s in zip(offset, arr.shape):
        if o >= 0:
            src.append(slice(o, s))
            dst.append(slice(0, max(s - o, 0)))
        else:
            src.append(slice(0, s + o))
            dst.append(slice(-o, s))
    out[tuple(dst)] = arr[tuple(src)]
    return out


def components_min_index(mask: torch.Tensor) -> torch.Tensor:
    """26-connected components labelled least linear index + 1."""
    n = mask.numel()
    p = torch.arange(n, dtype=torch.int32, device=mask.device).reshape(
        mask.shape)
    p = torch.where(mask, p, n)
    while True:
        m = p
        for ax in range(3):
            off = [0, 0, 0]
            off[ax] = 1
            a = shifted(m, off, n)
            off[ax] = -1
            b = shifted(m, off, n)
            m = torch.minimum(m, torch.minimum(a, b))
        m = torch.where(mask, m, n)
        if torch.equal(m, p):
            break
        p = m
    return torch.where(mask, p + 1, 0).to(torch.int32)


def _jump(p: torch.Tensor) -> torch.Tensor:
    while True:
        q = p[p.long()]
        if torch.equal(q, p):
            return p
        p = q


def _segment_min(values, segs, num, identity):
    out = torch.full((num,), identity, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, segs.long(), values, "amin",
                               include_self=True)


def basins(height: torch.Tensor, seeds: torch.Tensor, min_size: int,
           b_cap: int, k_cap: int, max_rounds: int = 64):
    shape = tuple(height.shape)
    dev = height.device
    n = int(np.prod(shape))
    big = _F32_MAX
    offsets = _offsets(3, 1)
    seeded = seeds > 0
    h = torch.where(seeded, -big, height)
    flat_idx = torch.arange(n, dtype=torch.int32, device=dev).reshape(shape)
    sv = seeds.to(torch.int32)
    best_h, best_i = h, flat_idx
    for off in offsets:
        nh = shifted(h, off, big)
        ni = shifted(flat_idx, off, n)
        ns = shifted(sv, off, 0)
        allowed = ~(seeded & (ns != sv))
        better = allowed & ((nh < best_h) | ((nh == best_h) & (ni < best_i)))
        best_h = torch.where(better, nh, best_h)
        best_i = torch.where(better, ni, best_i)
    root = _jump(best_i.reshape(-1))
    seed_flat = sv.reshape(-1)
    h_flat = height.reshape(-1)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    is_root = root == idx
    rank = torch.cumsum(is_root.to(torch.int32), 0, dtype=torch.int32) - 1
    ok = bool(rank[-1] + 1 <= b_cap)
    rr = rank[root.long()]
    basin_of = torch.where(rr < b_cap, rr, b_cap)
    basin_label = torch.zeros(b_cap + 1, dtype=torch.int32, device=dev)
    basin_label[basin_of[is_root].long()] = seed_flat[is_root]
    basin_of_l = basin_of.long()
    h_grid = h_flat.reshape(shape)
    gidx = torch.arange(b_cap + 1, dtype=torch.int32, device=dev)

    def round_(bparent, blabel, ok):
        group = _jump(bparent)
        glab = blabel[group.long()]
        code = group * 2 + (glab > 0).to(torch.int32)
        vcode = code[basin_of_l]
        vg = vcode >> 1
        vlab = vcode & 1
        vg_grid = vg.reshape(shape)
        sad = torch.full((n,), big, dtype=torch.float32, device=dev)
        nbr = torch.full((n,), b_cap, dtype=torch.int32, device=dev)
        for off in offsets:
            oh = shifted(h_grid, off, big).reshape(-1)
            og = shifted(vg_grid, off, b_cap).reshape(-1)
            s = torch.maximum(h_flat, oh)
            valid = (og != vg) & (og < b_cap) & (s < big)
            bet = valid & ((s < sad) | ((s == sad) & (og < nbr)))
            sad = torch.where(bet, s, sad)
            nbr = torch.where(bet, og, nbr)
        cand = (vlab == 0) & (nbr < b_cap)
        ctgt = torch.cumsum(cand.to(torch.int32), 0, dtype=torch.int32) - 1
        ok = ok and bool(ctgt[-1] + 1 <= k_cap)
        sel = cand & (ctgt < k_cap)
        tgt = ctgt[sel].long()
        cg = torch.full((k_cap,), b_cap, dtype=torch.int32, device=dev)
        cs = torch.full((k_cap,), big, dtype=torch.float32, device=dev)
        cn = torch.full((k_cap,), b_cap, dtype=torch.int32, device=dev)
        cg[tgt] = vg[sel]
        cs[tgt] = sad[sel]
        cn[tgt] = nbr[sel]
        smin = _segment_min(cs, cg, b_cap + 1, float("inf"))
        at_min = (cs == smin[cg.long()]) & (cs < big)
        attach = _segment_min(torch.where(at_min, cn, b_cap), cg, b_cap + 1,
                              _I32_MAX)
        attach = torch.where(attach < b_cap, attach, gidx)
        attach = torch.where(blabel > 0, gidx, attach)
        attach2 = attach[attach.long()]
        attach = torch.where((attach2 == gidx) & (attach > gidx), gidx,
                             attach)
        new_parent = attach[group.long()]
        return new_parent, ok, not torch.equal(new_parent, bparent)

    def merge(bparent, blabel, ok):
        for _ in range(max_rounds):
            bparent, ok, changed = round_(bparent, blabel, ok)
            if not changed:
                break
        return bparent, ok

    bparent, ok = merge(gidx.clone(), basin_label, ok)
    if min_size:
        group = _jump(bparent).long()
        sizes = torch.zeros(b_cap + 1, dtype=torch.int32, device=dev)
        sizes.index_add_(0, group[basin_of_l],
                         torch.ones(n, dtype=torch.int32, device=dev))
        small = (sizes < min_size) & (sizes > 0)
        basin_label = torch.where(small[group], 0, basin_label[group])
        bparent, ok = merge(bparent, basin_label, ok)
    group = _jump(bparent).long()
    return basin_label[group][basin_of_l].reshape(shape), ok


def coarse_watershed(height: torch.Tensor, seeds: torch.Tensor,
                     min_size: int, refine_rounds: int, f: int = 2):
    shape = tuple(height.shape)
    hp, sp = height, seeds
    for ax, s in enumerate(shape):
        p = (f - s % f) % f
        if p:
            edge = hp.narrow(ax, hp.shape[ax] - 1, 1)
            hp = torch.cat([hp] + [edge] * p, dim=ax)
            zs = list(sp.shape)
            zs[ax] = p
            sp = torch.cat([sp, sp.new_zeros(zs)], dim=ax)
    cs = tuple(s // f for s in hp.shape)
    cn = int(np.prod(cs))
    h6 = hp.reshape(cs[0], f, cs[1], f, cs[2], f)
    acc = None
    for a in range(f):
        for b in range(f):
            for c in range(f):
                t = h6[:, a, :, b, :, c]
                acc = t if acc is None else acc + t
    hc = acc / float(f ** 3)
    sc = sp.reshape(cs[0], f, cs[1], f, cs[2], f).amax(dim=(1, 3, 5))
    wsc, ok = basins(hc, sc, max(min_size // (f ** 3), 1),
                     min(max(cn // 8, 4096), cn // 2 + 2),
                     min(max(cn // 2, 16384), cn))
    ws = wsc.repeat_interleave(f, 0).repeat_interleave(f, 1) \
        .repeat_interleave(f, 2)[tuple(slice(0, s) for s in shape)]
    faces = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
             (0, 0, -1))
    sh = [shifted(height, o, 3.4e38) for o in faces]
    for _ in range(refine_rounds):
        best_h, best_l = height, ws
        for o, nh in zip(faces, sh):
            nl = shifted(ws, o, 0)
            better = (nh < best_h) & (nl > 0)
            best_h = torch.where(better, nh, best_h)
            best_l = torch.where(better, nl, best_l)
        ws = best_l
    return ws, ok


def block_fragments(x: torch.Tensor, p: dict, lowp: bool = False
                    ) -> Tuple[torch.Tensor, bool]:
    """Fragments of one uint8 outer block ``x`` (all of it, halo
    included) and whether the watershed's tables held them."""
    ct = torch.bfloat16 if lowp else torch.float32
    xf = x.to(ct) * torch.tensor(1.0 / 255.0, dtype=torch.float32).to(ct)
    fg = xf < p["threshold"]
    dt = edt(fg).to(ct)
    hmap = gaussian(xf, p["sigma_weights"]) if p["sigma_weights"] else xf
    alpha = p["alpha"]
    height = alpha * hmap + (1.0 - alpha) * (
        1.0 - dt / torch.clamp(dt.max(), min=1e-6))
    dts = gaussian(dt, p["sigma_seeds"]) if p["sigma_seeds"] else dt
    dts = dts.to(torch.float32)
    maxima = (dts >= box_max(dts, 5)) & fg
    seeds = components_min_index(maxima)
    return coarse_watershed(height.to(torch.float32), seeds,
                            p["size_filter"], p["refine_rounds"],
                            p["coarse_factor"])


def pair_excess(a: torch.Tensor, b: torch.Tensor) -> int:
    """0 when the labellings ``a`` and ``b`` are the same partition, else
    the number of extra (a, b) label pairs over a one-to-one map."""
    a = a.reshape(-1).to(torch.int64)
    b = b.reshape(-1).to(torch.int64)
    key = torch.unique(a * (1 << 32) + b)
    na = torch.unique(a).numel()
    nb = torch.unique(b).numel()
    return int(2 * key.numel() - na - nb)
