"""Mutex-watershed grid-graph edge extraction + segmentation.

Port of cluster_tools_tpu/ops/mws.py (affogato's
``compute_mws_segmentation`` / ``MWSGridGraph.compute_nh_and_weights``
replacement; reference utils/segmentation_utils.py:226-295,
mutex_watershed/mws_blocks.py:136-174).  Edge weights, stride
subsampling, masking and noise are tensor code on the caller's device;
the sequential Kruskal-with-mutex-constraints clustering runs in the
first-party C++ solvers (``native.mutex_clustering`` and
``native.mutex_clustering_sorted``).

Edge semantics (the mutex-watershed paper's convention):

* channel ``c`` holds the affinity between anchor voxel ``i`` and voxel
  ``i + offsets[c]``; affinity 1 = same object;
* the first ``ndim`` channels (direct neighbors) give *attractive* edges
  with merge priority ``aff``;
* the remaining (long-range) channels give *mutex* edges with separation
  priority ``1 - aff``;
* all edges are processed jointly in descending priority order.

The device-sorted stream (:func:`_sorted_edges_device`) sorts the key
``-w`` with a stable sort over the channels in order, exactly as the JAX
package's ``jax.lax.sort(..., is_stable=True)``: ties (uint8 affinities
quantize priorities to 1/255 steps) keep the channel-concatenation order,
so both packages emit the same stream.  The key is never ``+0.0``
(attractive ``w = 0`` is dropped and invalid edges get ``+inf``; a valid
mutex edge of affinity 1 gives ``-(1 - 1) = -0.0``), so the two
frameworks' different orderings of signed zeros never meet.

Randomness (``noise_level > 0``, ``randomize_strides``) draws from a
``torch.Generator`` seeded with ``seed``; it cannot reproduce the JAX
package's PRNG bits, only their distribution.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native

#: bit 30 of a packed partner index marks a mutex edge, bit 29 a dropped
#: edge; bits 0-28 hold the partner voxel
_MUTEX_BIT = 30
_DROPPED_BIT = 29
_MAX_PACKED_VOXELS = 1 << 29


def _offset_slices(off: Sequence[int], shape: Sequence[int]):
    """Anchor/partner slice tuples for one offset channel (in-bounds only).

    An offset as long as the block's extent or longer gives two empty
    slices (the JAX package's slices then differ in length, which its
    device path cannot concatenate)."""
    sl_a, sl_b = [], []
    for o, s in zip(off, shape):
        if o >= 0:
            sl_a.append(slice(0, max(s - o, 0)))
            sl_b.append(slice(min(o, s), s))
        else:
            sl_a.append(slice(min(-o, s), s))
            sl_b.append(slice(0, max(s + o, 0)))
    return tuple(sl_a), tuple(sl_b)


def _on_stride_grid(sub_shape, sl_a, strides, device) -> torch.Tensor:
    """Flat bool mask of the anchors of one channel that lie on the
    stride grid (volume coordinates ``pos % stride == 0``)."""
    ndim = len(sub_shape)
    on_grid = torch.ones(sub_shape, dtype=torch.bool, device=device)
    for ax in range(ndim):
        pos = torch.arange(sub_shape[ax], device=device) \
            + (sl_a[ax].start or 0)
        shp = [1] * ndim
        shp[ax] = sub_shape[ax]
        on_grid &= ((pos % strides[ax]) == 0).reshape(shp)
    return on_grid.reshape(-1)


def _grid_edges_device(affs: torch.Tensor, mask: Optional[torch.Tensor],
                       generator: Optional[torch.Generator],
                       noise_level: float,
                       offsets: Sequence[Sequence[int]], n_attractive: int,
                       strides: Sequence[int], randomize_strides: bool):
    """Per-channel (u, v, w, valid) flat tensors on ``affs``' device; u/v
    are flat voxel indices.

    Mutex channels are subsampled on the stride grid (or a random subset of
    matching density when ``randomize_strides`` — reference config knob,
    mws_blocks.py:44).  ``generator`` feeds the noise and the random
    subsets (None when neither is asked for).
    """
    shape = tuple(affs.shape[1:])
    dev = affs.device
    nvox = int(np.prod(shape))
    flat = torch.arange(nvox, dtype=torch.int32, device=dev).reshape(shape)
    if noise_level > 0:
        affs = affs + noise_level * torch.rand(
            affs.shape, generator=generator, device=dev)
    density = 1.0 / float(np.prod(strides))
    out = []
    for c, off in enumerate(offsets):
        sl_a, sl_b = _offset_slices(off, shape)
        u = flat[sl_a].reshape(-1)
        v = flat[sl_b].reshape(-1)
        w = affs[c][sl_a].reshape(-1)
        valid = torch.ones(u.shape, dtype=torch.bool, device=dev)
        if mask is not None:
            valid &= mask[sl_a].reshape(-1) & mask[sl_b].reshape(-1)
        if c >= n_attractive:
            w = 1.0 - w
            if randomize_strides:
                valid &= torch.rand(u.shape, generator=generator,
                                    device=dev) < density
            elif any(s > 1 for s in strides):
                valid &= _on_stride_grid(tuple(affs[c][sl_a].shape), sl_a,
                                         strides, dev)
        out.append((u, v, w, valid))
    return out


def _cat_uv(xs):
    return (np.concatenate(xs, axis=0) if xs
            else np.zeros((0, 2), dtype="int64"))


def grid_graph_edges_host(affs: np.ndarray,
                          offsets: Sequence[Sequence[int]],
                          strides: Optional[Sequence[int]] = None,
                          mask: Optional[np.ndarray] = None,
                          id_offset: int = 0):
    """Host (numpy) edge extraction — same semantics as the device path
    for the deterministic cases (no noise, no randomized strides).

    ``id_offset`` shifts the flat voxel ids into a global frame (a
    shard-local origin's flat offset)."""
    ndim = len(offsets[0])
    shape = affs.shape[1:]
    strides = tuple(int(s) for s in (strides or (1,) * ndim))
    if mask is not None:
        mask = np.asarray(mask).astype(bool)
    flat = np.arange(int(np.prod(shape)), dtype=np.int64).reshape(shape) \
        + np.int64(id_offset)
    uva, wa, uvm, wm = [], [], [], []
    for c, off in enumerate(offsets):
        sl_a, sl_b = _offset_slices(off, shape)
        u = flat[sl_a].reshape(-1)
        v = flat[sl_b].reshape(-1)
        # float32 arithmetic first, exactly like the device program —
        # computing 1-w in float64 would order some edge priorities
        # differently between the two impls
        w = affs[c][sl_a].reshape(-1).astype("float32")
        valid = np.ones(u.shape, bool)
        if mask is not None:
            valid &= (mask[sl_a].reshape(-1) & mask[sl_b].reshape(-1))
        if c >= ndim:
            w = np.float32(1.0) - w
            if any(s > 1 for s in strides):
                on_grid = np.ones(affs[c][sl_a].shape, bool)
                for ax in range(ndim):
                    pos = np.arange(on_grid.shape[ax]) \
                        + (sl_a[ax].start or 0)
                    sel = (pos % strides[ax]) == 0
                    shp = [1] * ndim
                    shp[ax] = on_grid.shape[ax]
                    on_grid &= sel.reshape(shp)
                valid &= on_grid.reshape(-1)
        uv = np.stack([u[valid], v[valid]], axis=1)
        (uva if c < ndim else uvm).append(uv)
        (wa if c < ndim else wm).append(w[valid].astype("float64"))
    return (_cat_uv(uva), np.concatenate(wa) if wa else np.zeros(0),
            _cat_uv(uvm), np.concatenate(wm) if wm else np.zeros(0))


def grid_graph_edges(affs: np.ndarray, offsets: Sequence[Sequence[int]],
                     strides: Optional[Sequence[int]] = None,
                     randomize_strides: bool = False,
                     mask: Optional[np.ndarray] = None,
                     noise_level: float = 0.0, seed: int = 0,
                     impl: str = "auto", id_offset: int = 0,
                     device: str = "cuda"):
    """Extract (uv_attractive, w_attractive, uv_mutex, w_mutex) host arrays.

    ``impl='auto'`` uses the host path for the deterministic cases (see
    grid_graph_edges_host) and the tensor program on ``device`` when noise
    injection or randomized strides need the random stream.
    ``id_offset`` shifts voxel ids into a global frame."""
    if impl == "auto":
        impl = ("device" if (noise_level > 0 or randomize_strides)
                else "host")
    if impl == "host":
        return grid_graph_edges_host(affs, offsets, strides=strides,
                                     mask=mask, id_offset=id_offset)
    if impl != "device":
        raise ValueError(f"unknown impl {impl!r} (host, device, auto)")
    ndim = len(offsets[0])
    if affs.shape[0] != len(offsets):
        raise ValueError(f"{affs.shape[0]} channels for {len(offsets)} "
                         "offsets")
    strides = tuple(int(s) for s in (strides or (1,) * ndim))
    dev = torch.device(device)
    generator = None
    if noise_level > 0 or randomize_strides:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    mask_dev = (None if mask is None else
                torch.from_numpy(np.asarray(mask).astype(bool)).to(dev))
    per_channel = _grid_edges_device(
        torch.from_numpy(np.ascontiguousarray(affs, dtype=np.float32)).to(
            dev), mask_dev, generator, float(noise_level),
        offsets, ndim, strides, bool(randomize_strides))
    # four concatenated downloads instead of four per channel
    lengths = [int(u.shape[0]) for u, _, _, _ in per_channel]
    u_all = torch.cat([u for u, _, _, _ in per_channel]).cpu().numpy()
    v_all = torch.cat([v for _, v, _, _ in per_channel]).cpu().numpy()
    w_all = torch.cat([w for _, _, w, _ in per_channel]).cpu().numpy()
    ok_all = torch.cat([ok for _, _, _, ok in per_channel]).cpu().numpy()
    u_all = u_all.astype("int64") + id_offset
    v_all = v_all.astype("int64") + id_offset
    uva: List[np.ndarray] = []
    wa: List[np.ndarray] = []
    uvm: List[np.ndarray] = []
    wm: List[np.ndarray] = []
    pos = 0
    for c, ln in enumerate(lengths):
        sl = slice(pos, pos + ln)
        pos += ln
        sel = ok_all[sl]
        uv = np.stack([u_all[sl][sel], v_all[sl][sel]], axis=1)
        (uva if c < ndim else uvm).append(uv)
        (wa if c < ndim else wm).append(w_all[sl][sel].astype("float64"))
    return (_cat_uv(uva), np.concatenate(wa) if wa else np.zeros(0),
            _cat_uv(uvm), np.concatenate(wm) if wm else np.zeros(0))


def _sorted_edges_device(affs: torch.Tensor, seeds: Optional[torch.Tensor],
                         offsets: Sequence[Sequence[int]],
                         strides: Sequence[int]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Extract ALL grid edges and sort them by DESCENDING mutex-watershed
    priority on ``affs``' device, returning (u, v_packed) int32 streams the
    host union-find scan consumes directly
    (native.mutex_clustering_sorted).

    v_packed packs the partner index with the edge class: bit 30 = mutex
    edge, bit 29 = dropped (zero-affinity attractive or off-stride mutex;
    kept in the stream so the layout is static, skipped by the scan via
    u = -1).

    ``seeds`` (int32 volume, 0 = unseeded, or None) boost intra-seed
    attractive edges above every data weight (the two-pass seeded
    variant).
    """
    shape = tuple(affs.shape[1:])
    ndim = len(shape)
    dev = affs.device
    flat = torch.arange(int(np.prod(shape)), dtype=torch.int32,
                        device=dev).reshape(shape)
    sflat = None if seeds is None else seeds.reshape(-1)
    us, vs, ws, ms, oks = [], [], [], [], []
    for c, off in enumerate(offsets):
        sl_a, sl_b = _offset_slices(off, shape)
        u = flat[sl_a].reshape(-1)
        v = flat[sl_b].reshape(-1)
        w = affs[c][sl_a].reshape(-1).to(torch.float32)
        is_mutex = c >= ndim
        valid = torch.ones(u.shape, dtype=torch.bool, device=dev)
        if is_mutex:
            w = 1.0 - w
            if any(s > 1 for s in strides):
                valid &= _on_stride_grid(tuple(affs[c][sl_a].shape), sl_a,
                                         strides, dev)
        else:
            if sflat is not None:
                su, sv = sflat[u.long()], sflat[v.long()]
                w = torch.where((su != 0) & (su == sv),
                                torch.tensor(2.0, device=dev), w)
            # zero-affinity attractive edges carry no merge evidence
            # (deliberate deviation from affogato, see
            # mutex_watershed_segmentation)
            valid &= w > 0
        us.append(u)
        vs.append(v)
        ws.append(w)
        ms.append(torch.full(u.shape, is_mutex, dtype=torch.bool,
                             device=dev))
        oks.append(valid)
    u_all = torch.cat(us)
    v_all = torch.cat(vs)
    w_all = torch.cat(ws)
    m_all = torch.cat(ms)
    ok_all = torch.cat(oks)
    # invalid edges sink to the end of the descending order
    key = torch.where(ok_all, -w_all, torch.tensor(float("inf"),
                                                   device=dev))
    u_s = torch.where(ok_all, u_all, torch.tensor(-1, dtype=torch.int32,
                                                  device=dev))
    v_packed = (v_all
                | (m_all.to(torch.int32) << _MUTEX_BIT)
                | ((~ok_all).to(torch.int32) << _DROPPED_BIT))
    order = torch.sort(key, stable=True).indices
    return u_s[order], v_packed[order]


def compact_seeds_int32(seeds: np.ndarray) -> np.ndarray:
    """Equality-preserving block-local relabel of seed ids to int32.

    The seeded pass-2 device path feeds uint64 GLOBAL labels
    (``block_id * offset_unit + 1 + rank``) as seeds; a plain
    ``astype('int32')`` wraps once ``block_id * offset_unit > 2^31``,
    colliding distinct seeds or wrapping a seed to 0.  Only EQUALITY
    matters inside ``_sorted_edges_device``, so a dense block-local
    relabel is exact: 0 (unseeded) stays 0, distinct ids stay distinct,
    and the result always fits int32 (a block holds < 2^29 voxels)."""
    s = np.asarray(seeds)
    if s.size == 0 or int(s.max()) < (1 << 31):
        # the common case: the cast is already exact
        return s.astype("int32")
    uniq, inv = np.unique(s, return_inverse=True)
    inv = inv.astype("int32").reshape(s.shape)
    if uniq.size and uniq[0] == 0:
        return inv
    return inv + 1  # no zeros present: keep every id nonzero


def _sorted_edges_resident(affs_dev: torch.Tensor, origin: Sequence[int],
                           outer_shape: Sequence[int],
                           offsets: Sequence[Sequence[int]],
                           strides: Sequence[int],
                           seeds: Optional[np.ndarray] = None):
    """Enqueue one block's extract+sort against the DEVICE-RESIDENT
    affinity volume without synchronizing: slice the outer window, sort
    every grid edge by descending priority.  Returns (u_sorted, v_packed,
    block_affinity_sum) tensors on the volume's device; the sum
    reproduces the host path's skip-empty-block rule."""
    if int(np.prod(outer_shape)) >= _MAX_PACKED_VOXELS:
        # v_packed carries the partner voxel index in bits 0-28 (flags at
        # 29/30): a larger outer block would silently corrupt the edge
        # stream.  Callers route oversized blocks to the host path
        raise ValueError(
            f"outer block {tuple(outer_shape)} has >= 2^29 voxels — the "
            "packed edge stream cannot address it; use the host path or "
            "shrink blocks")
    bb = tuple(slice(int(o), int(o) + int(s))
               for o, s in zip(origin, outer_shape))
    affs = affs_dev[(slice(None),) + bb]
    seeds_dev = None
    if seeds is not None:
        seeds_dev = torch.from_numpy(compact_seeds_int32(seeds)).to(
            affs_dev.device)
    u_sorted, vp_sorted = _sorted_edges_device(affs, seeds_dev, offsets,
                                               strides)
    return u_sorted, vp_sorted, affs.sum()


def _consecutive(labels: np.ndarray, shape,
                 mask: Optional[np.ndarray]) -> np.ndarray:
    """Cluster ids to uint64 labels consecutive from 1 (0 on masked
    voxels)."""
    labels = labels.reshape(shape)
    if mask is not None:
        labels = np.where(mask, labels + 1, 0)
    else:
        labels = labels + 1
    uniq, inv = np.unique(labels, return_inverse=True)
    if uniq.size and uniq[0] == 0:
        return inv.reshape(shape).astype("uint64")
    return (inv.reshape(shape) + 1).astype("uint64")


def mutex_watershed_scan_sorted(u: np.ndarray, vp: np.ndarray, shape,
                                mask: Optional[np.ndarray] = None):
    """Host half of the sorted finalize: the C++ union-find scan over a
    DOWNLOADED sorted edge stream; returns uint64 labels consecutive
    from 1 (0 on masked voxels)."""
    dropped = (vp >> _DROPPED_BIT) & 1
    u = np.where(dropped != 0, np.int32(-1), u)
    v = vp & np.int32(_MAX_PACKED_VOXELS - 1)
    flags = ((vp >> _MUTEX_BIT) & 1).astype(np.uint8)
    n_nodes = int(np.prod(shape))
    cluster = native.mutex_clustering_sorted(n_nodes, u, v, flags)
    return _consecutive(cluster, shape, mask)


def mutex_watershed_finalize_sorted(handles, shape, asum=None,
                                    mask: Optional[np.ndarray] = None):
    """Download one block's sorted edge stream and run the host scan.
    Returns (labels, affinity_sum): uint64 labels consecutive from 1
    (0 on masked voxels); when ``asum`` reports an all-zero block the
    scan is skipped and labels is None."""
    u_sorted, vp_sorted = handles
    a = float(asum) if asum is not None else None
    if a == 0.0:
        return None, 0.0
    labels = mutex_watershed_scan_sorted(
        u_sorted.cpu().numpy(), vp_sorted.cpu().numpy(), shape, mask=mask)
    return labels, (a if a is not None else 1.0)


def mutex_watershed_segmentation(
        affs: np.ndarray, offsets: Sequence[Sequence[int]],
        strides: Optional[Sequence[int]] = None,
        randomize_strides: bool = False,
        mask: Optional[np.ndarray] = None,
        noise_level: float = 0.0, seed: int = 0,
        seeds: Optional[np.ndarray] = None,
        return_seed_assignments: bool = False,
        device: str = "cuda"):
    """Mutex watershed over an affinity volume.

    ``seeds`` (same shape as the volume, 0 = unseeded) implement the
    reference's two-pass seeded variant (utils/segmentation_utils.py:252-295):
    direct-neighbor edges inside one seed become maximally attractive, so a
    seed region is never split; distinct seeds *may* still merge when the
    affinities support it, and the caller reconciles those merges through the
    returned (segment_label, seed_label) assignments.

    The edges are extracted on the host, or on ``device`` where noise or
    randomized strides need the random stream.  Returns labels (uint64,
    consecutive from 1; 0 on masked-out voxels), and optionally the
    seed-assignment pairs.
    """
    shape = affs.shape[1:]
    uva, wa, uvm, wm = grid_graph_edges(
        affs, offsets, strides=strides, randomize_strides=randomize_strides,
        mask=mask, noise_level=noise_level, seed=seed, device=device)
    if seeds is not None:
        sflat = np.asarray(seeds).reshape(-1)
        su, sv = sflat[uva[:, 0]], sflat[uva[:, 1]]
        same_seed = (su != 0) & (su == sv)
        # above every data weight (affinities are normalized to [0, 1])
        wa = np.where(same_seed, 2.0, wa)
    # an attractive edge with zero affinity carries no merge evidence;
    # keeping it would let unconstrained clusters merge arbitrarily at the
    # bottom of the priority queue (deliberate deviation from affogato).
    # After seed boosting, so intra-seed edges always survive.
    keep = wa > 0
    uva, wa = uva[keep], wa[keep]
    n_nodes = int(np.prod(shape))
    cluster = native.mutex_clustering(n_nodes, uva, wa, uvm, wm)
    labels = _consecutive(cluster, shape, mask)
    if not return_seed_assignments:
        return labels
    assignments = np.zeros((0, 2), dtype="uint64")
    if seeds is not None:
        sflat = np.asarray(seeds).reshape(-1)
        lflat = labels.reshape(-1)
        seeded = sflat != 0
        if seeded.any():
            assignments = np.unique(
                np.stack([lflat[seeded].astype("uint64"),
                          sflat[seeded].astype("uint64")], axis=1), axis=0)
    return labels, assignments
