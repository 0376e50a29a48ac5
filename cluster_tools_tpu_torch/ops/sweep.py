"""Gather-free seeded watershed and connected components by directional
scans, and run-length coding of labels.

Port of cluster_tools_tpu/ops/sweep.py in plain PyTorch, on the device of
the tensors it is given.  The flood's label assignment is the shortest-path
forest under Meyer's topographic distance: a step into voxel ``v`` from its
neighbor ``u`` costs ``max(0, h[v] - h[u])`` of ascent plus one step, and
path costs compose associatively along a grid line, so each directional
sweep is one associative scan.  Six sweeps (forward and reverse along each
axis, each feeding the next) make one round; rounds repeat until the state
stops changing.  A transit flag threaded through the scan keeps labels from
crossing masked voxels; the same algebra with zero step costs gives
connected components by minimum-index propagation (``sweep_cc_impl``).

The composition is associative only up to exact packed-cost ties, so the
order in which pairs are bracketed decides some tied voxels.
:class:`_Sweep` brackets them as ``jax.lax.associative_scan`` does (pairs,
recursion on the pair results, the remaining even elements, interleave;
reverse scans flip input and output), so the labels equal the JAX
package's.  A segment's metadata (ascent, steps, length, mask) does not
depend on the fronts, so each sweep combines it once, level by level of
that recursion, and every round scans only the fronts against it.  The
packed costs and labels, uint32 in the JAX package, are carried in int64
with the same bit fields and the same saturating minimums (PyTorch
supports few ops on uint32 CUDA tensors); the JAX
``while_loop`` is a Python loop with one host read of the "changed" flag
per round.  No JAX workflow calls these ops; ``rle_encode_packed`` is the
fused chain's device-to-host label encoder.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .components import _shifted

_INF = 0xFFFFFFFF
#: packed path cost, lexicographic: total ascent (anchored at the seed's
#: own height, 14 bits) | steps since the last ascent (9 bits) | total
#: steps (9 bits), all saturating.  Ascent alone ties every above-saddle
#: voxel between basins; steps since the last ascent divide contested level
#: bands like the flood front's BFS; total steps break the remaining tie at
#: a fresh riser toward the nearer basin.
CLIMB_BITS, RSTEP_BITS, TSTEP_BITS = 14, 9, 9
_CLIMB_MAX = (1 << CLIMB_BITS) - 1
_RSTEP_MAX = (1 << RSTEP_BITS) - 1
_TSTEP_MAX = (1 << TSTEP_BITS) - 1


def _lex_min(P1, lab1, P2, lab2):
    take1 = (P1 < P2) | ((P1 == P2) & (lab1 <= lab2))
    return torch.where(take1, P1, P2), torch.where(take1, lab1, lab2)


def _pack(climb, rsteps, tsteps):
    # tsteps saturates one short of its field max: a fully saturated pack
    # would otherwise equal the _INF unreachable sentinel exactly
    return ((climb.clamp(max=_CLIMB_MAX) << (RSTEP_BITS + TSTEP_BITS))
            | (rsteps.clamp(max=_RSTEP_MAX) << TSTEP_BITS)
            | tsteps.clamp(max=_TSTEP_MAX - 1))


def _transfer(P, C, t, L):
    """Move a carried front across a segment with total ascent C,
    trailing no-ascent run t, and length L: ascent accumulates; the
    reset-step counter restarts at t when the segment ascends, else
    grows by L; total steps always grow by L.  INF stays absorbing."""
    climb = (P >> (RSTEP_BITS + TSTEP_BITS)) + C
    rsteps = torch.where(C > 0, t, ((P >> TSTEP_BITS) & _RSTEP_MAX) + L)
    tsteps = (P & _TSTEP_MAX) + L
    return _pack(climb, rsteps, tsteps).masked_fill(P == _INF, _INF)


def _ws_combine(left, right, meta):
    """Compose two min-plus path segments' fronts.

    A front is ``(A, lab)``: the cheapest packed (ascent, reset-steps,
    total-steps) cost ending at the segment's last voxel from a source
    WITHIN the segment, and its label.  ``meta`` is the right segment's
    ``(C, t, L, m)``: total ascent, trailing no-ascent run, length, free of
    masked voxels.  The result is ``min(A2, m2 ? transfer(A1) : INF)``,
    ties to the smaller label.  Associative up to exact packed-cost ties
    — the class the flood itself resolves by queue order.
    """
    A1, l1 = left
    A2, l2 = right
    C2, t2, L2, m2 = meta
    moved = _transfer(A1, C2, t2, L2).masked_fill(~m2, _INF)
    return list(_lex_min(moved, l1, A2, l2))


def _ws_meta_combine(left, right):
    """Compose two segments' ``(C, t, L, m)``."""
    C1, t1, L1, m1 = left
    C2, t2, L2, m2 = right
    C = (C1 + C2).clamp(max=_CLIMB_MAX)
    t = torch.where(C2 > 0, t2, (t1 + L2).clamp(max=_RSTEP_MAX))
    L = (L1 + L2).clamp(max=_TSTEP_MAX)
    return [C, t, L, m1 & m2]


def _cc_combine(left, right, meta):
    (A1,), (A2,), (m2,) = left, right, meta
    return [torch.minimum(A2, A1.masked_fill(~m2, _INF))]


def _cc_meta_combine(left, right):
    return [left[0] & right[0]]


def _slice(x: torch.Tensor, axis: int, start: int, stop: Optional[int],
           step: int = 1) -> torch.Tensor:
    return x[(slice(None),) * axis + (slice(start, stop, step),)]


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """``a[0], b[0], a[1], b[1], ...`` along ``axis`` (``a`` as long as
    ``b`` or one longer)."""
    shape = list(a.shape)
    shape[axis] = a.shape[axis] + b.shape[axis]
    out = a.new_empty(shape)
    out[(slice(None),) * axis + (slice(0, None, 2),)] = a
    out[(slice(None),) * axis + (slice(1, None, 2),)] = b
    return out


class _Sweep:
    """One directional scan's static part: the segment metadata at every
    level of the scan's recursion (level k + 1 combines level k's adjacent
    pairs), computed once and reused by every round, whose fronts are the
    only part that changes."""

    def __init__(self, meta_combine, meta: List[torch.Tensor], axis: int,
                 reverse: bool):
        self.axis, self.reverse = axis, reverse
        if reverse:
            meta = [e.flip(axis) for e in meta]
        self.levels = [meta]
        while meta[0].shape[axis] >= 2:
            n = meta[0].shape[axis]
            meta = meta_combine([_slice(e, axis, 0, n - 1, 2) for e in meta],
                                [_slice(e, axis, 1, None, 2) for e in meta])
            self.levels.append(meta)

    def __call__(self, fn, carry: List[torch.Tensor]) -> List[torch.Tensor]:
        """Inclusive scan of the fronts ``carry`` along the axis, bracketed
        as ``jax.lax.associative_scan`` brackets it."""
        axis = self.axis
        if self.reverse:
            carry = [e.flip(axis) for e in carry]
        out = self._scan(fn, carry, 0)
        if self.reverse:
            out = [e.flip(axis) for e in out]
        return out

    def _scan(self, fn, carry, k):
        axis = self.axis
        n = carry[0].shape[axis]
        if n < 2:
            return carry
        meta = self.levels[k]
        # combine adjacent pairs, scan the pair results, then combine the
        # odd results with the remaining even elements; interleave
        reduced = fn([_slice(e, axis, 0, n - 1, 2) for e in carry],
                     [_slice(e, axis, 1, None, 2) for e in carry],
                     [_slice(e, axis, 1, None, 2) for e in meta])
        odd = self._scan(fn, reduced, k + 1)
        if n % 2 == 0:
            odd_left = [_slice(e, axis, 0, e.shape[axis] - 1) for e in odd]
        else:
            odd_left = odd
        even = fn(odd_left, [_slice(e, axis, 2, None, 2) for e in carry],
                  [_slice(e, axis, 2, None, 2) for e in meta])
        even = [torch.cat([_slice(e, axis, 0, 1), r], dim=axis)
                for e, r in zip(carry, even)]
        return [_interleave(a, b, axis) for a, b in zip(even, odd)]


def _step_elems(h: torch.Tensor, axis: int, reverse: bool):
    """Per-voxel segment metadata for a directional sweep: the ascent
    entering voxel i from its predecessor, and the trailing no-ascent
    run (0 after an ascent, else 1).  Line-leading voxels have no
    predecessor; their metadata only matters for carries, which start
    at INF there."""
    off = [0] * h.dim()
    off[axis] = 1 if reverse else -1
    prev = _shifted(h, off, 255)
    climb = (h - prev).clamp(min=0)
    return climb, (climb == 0).to(torch.int64)


def _ws_round(state_A, state_lab, sweeps, pin_A, pin_lab, seeded):
    """One Gauss-Seidel round: one directional scan per sweep, seeds
    re-pinned after each (a foreign front must not relabel a seed)."""
    for sweep in sweeps:
        state_A, state_lab = sweep(_ws_combine, [state_A, state_lab])
        state_A = torch.where(seeded, pin_A, state_A)
        state_lab = torch.where(seeded, pin_lab, state_lab)
    return state_A, state_lab


def sweep_watershed_impl(
    hq: torch.Tensor,
    seeds: torch.Tensor,
    mask: Optional[torch.Tensor],
    max_rounds: int = 24,
    min_size: int = 0,
    k_cap: int = 0,
    stats: Optional[Dict[str, int]] = None,
) -> Tuple[torch.Tensor, bool]:
    """Core: uint8 heights, dense int32 seed ids (< 2^24), on their device.

    Returns ``(labels int32, converged)``.  Unreachable voxels (outside
    mask, or cut off by it) keep label 0.  ``min_size`` strips fragments
    below the threshold and re-floods their voxels from the surviving
    fragments (the reference's watershed-and-size-filter,
    utils/volume_utils.py:123-139); it requires a bound ``k_cap`` on the
    seed-id space for the size histogram.  ``stats``, if given, receives
    the rounds run (``rounds``, and ``rounds_refill`` after a size
    filter).
    """
    ndim = hq.dim()
    dev = hq.device
    m = (torch.ones(hq.shape, dtype=torch.bool, device=dev) if mask is None
         else mask.to(torch.bool))
    seeded = (seeds > 0) & m
    h = hq.to(torch.int64)
    zero = torch.zeros_like(h)
    # a seed's cost starts at its OWN height: within a basin the ascent
    # total to v is then ~ h[v] regardless of seed depth, so a deep/high
    # seed cannot "ride a contour" into a neighbor's above-saddle shoulder
    pin_A = _pack(h, zero, zero).masked_fill(~seeded, _INF)
    pin_lab = seeds.to(torch.int64).masked_fill(~seeded, _INF)
    ones = torch.ones_like(h)
    sweeps = [_Sweep(_ws_meta_combine,
                     [*_step_elems(h, axis, reverse), ones, m], axis, reverse)
              for axis in range(ndim) for reverse in (False, True)]

    def run_rounds(A, lab, pinned):
        changed, rounds = True, 0
        while changed and rounds < max_rounds:
            nA, nlab = _ws_round(A, lab, sweeps, pin_A, pin_lab, pinned)
            changed = bool(((nA != A) | (nlab != lab)).any())
            A, lab = nA, nlab
            rounds += 1
        return A, lab, not changed, rounds

    P, lab, converged, rounds = run_rounds(pin_A, pin_lab, seeded)
    if stats is not None:
        stats["rounds"] = rounds

    if min_size:
        if not k_cap:
            raise ValueError("min_size needs a k_cap")
        labels = torch.where(m & (P < _INF), lab, 0)
        clipped = labels.clamp(max=k_cap)
        sizes = torch.bincount(clipped[m], minlength=k_cap + 1)
        small = (sizes < min_size) & (sizes > 0)
        small[0] = False
        strip = small[clipped]
        # stripped voxels revert to unlabeled; surviving fragment BODIES
        # act as the new seed set (every labeled voxel is already a
        # fixpoint source), so the re-flood is just more rounds
        P = P.masked_fill(strip, _INF)
        lab = lab.masked_fill(strip, _INF)
        P, lab, conv2, rounds = run_rounds(P, lab, seeded & ~strip)
        converged = converged and conv2
        if stats is not None:
            stats["rounds_refill"] = rounds

    labels = torch.where(m & (P < _INF), lab, 0)
    return labels.to(torch.int32), converged


def sweep_cc_impl(mask: torch.Tensor, max_rounds: int = 32,
                  stats: Optional[Dict[str, int]] = None):
    """Connected components (face connectivity) by min-linear-index
    propagation with the same directional-scan machinery.  Returns
    ``(labels int32 — root_index + 1, 0 outside mask —, converged)``;
    identical labeling contract to ``ops.components.connected_components``.
    """
    ndim = mask.dim()
    m = mask.to(torch.bool)
    idx = torch.arange(m.numel(), dtype=torch.int64,
                       device=m.device).reshape(m.shape)
    state = idx.masked_fill(~m, _INF)
    sweeps = [_Sweep(_cc_meta_combine, [m], axis, reverse)
              for axis in range(ndim) for reverse in (False, True)]
    changed, rounds = True, 0
    while changed and rounds < max_rounds:
        s = state
        for sweep in sweeps:
            s = sweep(_cc_combine, [s])[0]
        changed = bool((s != state).any())
        state = s
        rounds += 1
    if stats is not None:
        stats["rounds"] = rounds
    labels = torch.where(m, state + 1, 0).to(torch.int32)
    return labels, not changed


def compact_ids(labels: torch.Tensor, cap: int):
    """Dense-rank positive ids (device np.unique analog): presence flags +
    cumsum.  Ids must be < ``cap``.  Returns ``(dense int32 — 1..k, same
    zeros —, k)``."""
    flat = labels.reshape(-1).to(torch.int64)
    # the JAX scatter wraps negative indices and drops what is still out
    # of range; index_put_ would raise, so the indices are masked first
    slot = flat.clamp(max=cap + 1)
    slot = torch.where(slot < 0, slot + cap + 2, slot)
    pres = torch.zeros(cap + 2, dtype=torch.int64, device=flat.device)
    pres[slot[slot >= 0]] = 1
    pres[0] = 0
    rank = torch.cumsum(pres, 0)
    dense = torch.where(flat > 0, rank[flat.clamp(0, cap + 1)], 0)
    return dense.reshape(labels.shape).to(torch.int32), rank[cap + 1]


def sweep_watershed(
    height,
    seeds,
    mask=None,
    connectivity: int = 1,
    min_size: int = 0,
    max_rounds: int = 48,
) -> torch.Tensor:
    """Host-facing wrapper matching ``ops.watershed.seeded_watershed``:
    float heights (normalized to uint8 levels), arbitrary positive seed
    ids, on ``height``'s device."""
    if connectivity != 1:
        raise ValueError("sweep watershed propagates along faces "
                         "(connectivity=1)")
    dev = height.device
    if height.dtype == torch.uint8:
        hq = height
    else:
        h = height.to(torch.float32)
        lo = h.min()
        hq = torch.clamp(torch.round(
            (h - lo) / torch.clamp(h.max() - lo, min=1e-6) * 255.0),
            0, 255).to(torch.uint8)
    if mask is not None:
        mask = mask.to(dev)
    # host-side dense compaction: callers may pass arbitrary (e.g.
    # globally offset) seed ids beyond the rank scatter's id range
    seeds_np = seeds.cpu().numpy()
    uniq = np.unique(seeds_np)
    uniq = uniq[uniq > 0]
    k = len(uniq)
    # ctt-lint: disable=dtype-int32 (this IS the sanctioned compaction: searchsorted ranks are < k <= block voxel count, never raw global ids)
    dense = np.searchsorted(uniq, seeds_np).astype("int32") + 1
    dense[seeds_np <= 0] = 0
    dense = torch.from_numpy(dense).to(dev)
    k_cap = 1 << max(int(np.ceil(np.log2(max(k, 2)))), 6) if min_size else 0
    dense_lab, converged = sweep_watershed_impl(
        hq, dense, mask, max_rounds=max_rounds, min_size=min_size,
        k_cap=k_cap)
    if not converged:  # pathological serpentine plateaus
        dense_lab, _ = sweep_watershed_impl(
            hq, dense, mask, max_rounds=4 * max_rounds, min_size=min_size,
            k_cap=k_cap)
    # map dense ranks back to the caller's seed ids
    if uniq.size and uniq[-1] >= np.iinfo(np.int32).max:
        raise ValueError("seed ids exceed int32")
    lab = dense_lab.cpu().numpy()
    out = np.zeros(lab.shape, np.int64)
    fg = lab > 0
    out[fg] = uniq.astype(np.int64)[lab[fg] - 1]
    return torch.from_numpy(out.astype(np.int32)).to(dev)


def rle_encode(flat: torch.Tensor, cap: int):
    """Run-length encode a flat label tensor on its device: returns
    ``(starts int64[cap], values int32[cap], n_runs, ok)``.  Runs past
    ``cap`` are dropped (fixed-cap buffers; the host reads only the
    ``n_runs`` prefix) and ``ok`` is False then."""
    n = int(flat.shape[0])
    dev = flat.device
    starts = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    values = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    if n == 0:
        return starts[:cap], values[:cap], 0, True
    brk = torch.ones(n, dtype=torch.bool, device=dev)
    brk[1:] = flat[1:] != flat[:-1]
    tgt = torch.cumsum(brk.to(torch.int64), 0) - 1
    n_runs = int(tgt[-1]) + 1
    keep = brk & (tgt < cap)
    starts[tgt[keep]] = torch.arange(n, dtype=torch.int64, device=dev)[keep]
    values[tgt[keep]] = flat[keep].to(torch.int32)
    return starts[:cap], values[:cap], n_runs, n_runs <= cap


def rle_decode(starts: np.ndarray, values: np.ndarray,
               total: int) -> np.ndarray:
    """Host-side inverse of :func:`rle_encode` (numpy repeat)."""
    starts = np.asarray(starts, dtype=np.int64)
    lengths = np.diff(np.append(starts, total))
    return np.repeat(np.asarray(values), lengths)


#: forced run break interval: lengths must fit 16 bits
RLE_STRIDE = 1 << 15


def rle_encode_packed(flat: torch.Tensor, cap: int):
    """Run-length encode label ids < 2^16 into ``cap`` packed words
    ``length << 16 | value``, runs force-split every ``RLE_STRIDE``
    elements so lengths fit 16 bits.  The stream is computed in int64 on
    the device and read as uint32 on the host.  Returns ``(packed
    int64[cap], n_runs, ok)``: words past ``n_runs`` are zero; ``ok`` is
    False on cap overflow or ids >= 2^16 (the caller then copies the dense
    labels instead)."""
    n = int(flat.shape[0])
    dev = flat.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    brk = torch.ones(n, dtype=torch.bool, device=dev)
    brk[1:] = flat[1:] != flat[:-1]
    brk |= (idx % RLE_STRIDE) == 0
    starts = torch.nonzero(brk).squeeze(1)
    n_runs = int(starts.shape[0])
    ok = n_runs <= cap and (n == 0 or int(flat.max()) < (1 << 16))
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    words = ((ends - starts) << 16) | (flat[starts].to(torch.int64) & 0xFFFF)
    packed = torch.zeros(cap, dtype=torch.int64, device=dev)
    packed[:min(n_runs, cap)] = words[:cap]
    return packed, n_runs, ok


def rle_decode_packed(packed: np.ndarray, n_runs: int,
                      total: int) -> np.ndarray:
    """Host-side inverse of :func:`rle_encode_packed`."""
    arr = np.asarray(packed[:n_runs]).astype(np.uint32)
    lengths = (arr >> 16).astype(np.int64)
    values = (arr & 0xFFFF).astype(np.uint16)
    out = np.repeat(values, lengths)
    if out.size != total:
        raise ValueError(f"RLE decode size {out.size} != {total}")
    return out
