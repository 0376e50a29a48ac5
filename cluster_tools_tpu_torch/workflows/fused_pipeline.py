"""Fused per-block segmentation chain on the card: watershed + relabel +
RAG + edge features in one pass per block against a DEVICE-RESIDENT
volume.

Port of cluster_tools_tpu/workflows/fused_pipeline.py, ``ws_method="device"``
(the streamed resident path).  Per block:

* the reflect-padded input volume uploads ONCE; each block slices its
  outer window from device memory;
* :func:`resident_block` runs the chain: normalize -> EDT (the CUDA
  min-plus kernel) -> filters -> seed connected components -> 2x-COARSE
  basin watershed with full-res refinement (ops/watershed.coarse) -> dense
  per-block relabel (the driver adds a running global offset, so written
  fragments are globally consecutive) -> interior RAG pairs compacted
  ONCE per pair with both side samples -> per-edge statistics (exact
  256-bin histograms for uint8 inputs) -> run-length coding of the labels;
* the block's meta/edge table and its run-length stream are copied into
  pinned host buffers with ``non_blocking=True`` right after the block's
  work is enqueued, and the drain waits on a CUDA event recorded after the
  copies — block i's download overlaps block i+1's compute;
* fragments stage in host RAM (``_FRAGMENT_CACHE``), so FusedFaceAssembly
  and the final write compose from memory instead of re-reading the store.

Cross-block (face) edges cannot be known in a single pass — the neighbor
block's ids do not exist yet — so a cheap host task (FusedFaceAssembly)
adds them afterwards from the staged planes, completing the per-block
sub-graphs in the exact format the merge/solve stack consumes.

``ws_method`` picks the execution: ``"device"`` (the default, above),
``"hybrid"`` (device stage A — normalize, EDT, filters, seeds — then the
host C++ priority flood and size filter, then device stage B — interior
pairs and edge statistics — one block behind, so block i's stage B runs
on the card while block i+1 floods on the host), or ``"legacy"`` (one
upload per block and the basins watershed on the card, the JAX package's
per-block chain; a store that is not 3-d takes this path).  Neither
``hybrid`` nor ``legacy`` stages fragments in RAM: face assembly reads
them from the store.

The device is the global config's ``"device"`` (default ``"cuda"``): a run
that asks for the card on a machine without one raises; nothing falls back
to the CPU, and ``hybrid`` raises without a C++ compiler.
Task config ``mesh_resident: true`` kills the per-block loop: the volume
splits into z-slabs over the shard devices (the global config's
``mesh_devices``) and :func:`mesh_resident_program` runs the whole chain
with halos over a ring, label offsets from a scan of the shard counts and
the cross-shard faces on the device (one slab == one problem block; no
face-assembly pass).  Under ``target="mesh"`` the streamed path places
block i on shard device i mod n and drains in block order, bitwise equal
to the inline run.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..core import graph as g
from ..core.blocking import Blocking
from ..core.config import write_config
from ..core.device import resolve_device, task_device
from ..core.runtime import BlockTask
from ..core.storage import file_reader
from ..core.workflow import FileTarget, Task


def _staged_path(tmp_folder: str, block_id: int) -> str:
    return os.path.join(tmp_folder, f"fused_feats_raw_block_{block_id}.npz")


# ---------------------------------------------------------------------------
# in-process staging caches (the ``gpu`` target runs every task inline in the
# driver process): the fused pass keeps each block's dense LOCAL labels and
# the raw input volume in host RAM, so FusedFaceAssembly and the final write
# compose from memory instead of re-reading the store.  Tasks that run in
# OTHER processes (``local`` target workers) miss the cache and fall back to
# store reads — the cache is an overlap optimization, never a correctness
# dependency.
# ---------------------------------------------------------------------------

#: (ws_path, ws_key, block_id) -> (local_dense uint16/uint32, offset, bb)
_FRAGMENT_CACHE: Dict = {}
#: (input_path, input_key) -> (host volume array, is_raw_uint8)
_RAW_CACHE: Dict = {}


def fragment_cache_get(path: str, key: str, block_id: int,
                       expect_bb=None):
    """Staged (local_dense, offset, bb) for a block, or None.  A hit is
    only valid when the fused pass's block grid matches the consumer's
    bounding box ``expect_bb``."""
    ent = _FRAGMENT_CACHE.get((os.path.abspath(path), key, block_id))
    if ent is not None and expect_bb is not None and \
            tuple(ent[2]) != tuple(expect_bb):
        return None
    return ent


def raw_cache_get(path: str, key: str):
    return _RAW_CACHE.get((os.path.abspath(path), key))


def clear_caches() -> None:
    from ..core import runtime as rt
    _FRAGMENT_CACHE.clear()
    _RAW_CACHE.clear()
    rt.ledger_clear("fragment_cache")
    rt.ledger_clear("raw_cache")


def _fragment_cache_put(key, local, off, bb) -> None:
    """Insert into the fragment cache, keeping the live-buffer ledger in
    sync (overwrites release the previous entry's bytes first)."""
    from ..core import runtime as rt
    prev = _FRAGMENT_CACHE.get(key)
    _FRAGMENT_CACHE[key] = (local, int(off), bb)
    rt.ledger_add("fragment_cache",
                  int(local.nbytes) - (int(prev[0].nbytes) if prev else 0),
                  0 if prev else 1)


def _raw_cache_put(key, vol, is_u8) -> None:
    from ..core import runtime as rt
    prev = _RAW_CACHE.get(key)
    _RAW_CACHE[key] = (vol, is_u8)
    rt.ledger_add("raw_cache",
                  int(vol.nbytes) - (int(prev[0].nbytes) if prev else 0),
                  0 if prev else 1)


# ---------------------------------------------------------------------------
# the per-block device chain
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ResidentParams:
    """Everything the per-block chain depends on besides the block's
    origin and extent (the JAX package's ``_resident_program`` args)."""
    outer_shape: tuple
    halo: tuple
    is_u8: bool
    threshold: float
    sigma_seeds: float
    sigma_weights: float
    alpha: float
    min_size: int
    e_max: int
    rle_cap: int
    refine_rounds: int
    pair_cap: int = 1 << 21
    coarse_factor: int = 2


def _normalized(x: torch.Tensor) -> torch.Tensor:
    """Raw uint8 boundaries to the [0, 1] float scale (a multiply by the
    float32 reciprocal, as XLA computes the JAX package's ``* (1/255)``);
    float blocks arrive normalized."""
    return x.to(torch.float32) * (1.0 / 255.0) if x.dtype == torch.uint8 \
        else x


def _height_and_seeds(xf: torch.Tensor, p: "ResidentParams"):
    """The front of every per-block chain: EDT (the CUDA kernel on the
    card), the height map blending the (smoothed) boundaries with the
    inverted DT, and the seeds — connected maxima of the smoothed DT."""
    from ..ops.components import connected_components
    from ..ops.edt import distance_transform_edt
    from ..ops.filters import gaussian, local_maxima

    fg = xf < p.threshold
    dt = distance_transform_edt(fg)
    hmap = gaussian(xf, p.sigma_weights) if p.sigma_weights else xf
    height = p.alpha * hmap + (1.0 - p.alpha) * (
        1.0 - dt / torch.clamp(dt.max(), min=1e-6))
    dt_smooth = gaussian(dt, p.sigma_seeds) if p.sigma_seeds else dt
    maxima = local_maxima(dt_smooth, radius=2) & fg
    seeds = connected_components(maxima, connectivity=3,
                                 method="propagation")
    return height, seeds


def _stats_table(dense_inner: torch.Tensor, xf_inner: torch.Tensor,
                 e_max: int, head) -> torch.Tensor:
    """Interior pairs (two samples per face) of the dense inner labels,
    compacted, and their sorted-position edge statistics, packed into one
    float64 table: row 0 ``head + [n_runs, overflow]``, rows 1.. ``[u, v,
    feats...]`` (float64 holds every id and float32 feature exactly)."""
    from ..ops.rag import boundary_pair_values, compact_valid, \
        edge_stats_device

    u, v, vals, okp = boundary_pair_values(dense_inner, xf_inner)
    n = int(u.shape[0])
    cap = max(1 << max(int(np.ceil(np.log2(max(n // 6, 1)))), 14), 1 << 14)
    (cu, cv, cvals), cok, cap_overflow = compact_valid(okp, [u, v, vals],
                                                       cap)
    uv, feats, n_runs, e_overflow = edge_stats_device(cu, cv, cvals, cok,
                                                      e_max=e_max)
    f64 = torch.float64
    meta = torch.stack([h.to(f64) for h in head]
                       + [n_runs.to(f64), (e_overflow + cap_overflow).to(f64)])
    body = torch.cat([uv.to(f64), feats.to(f64)], dim=1)
    meta_row = torch.zeros((1, body.shape[1]), dtype=f64, device=body.device)
    meta_row[0, :meta.shape[0]] = meta
    return torch.cat([meta_row, body], dim=0)


def legacy_block(x: torch.Tensor, extent: Sequence[int],
                 p: "ResidentParams"):
    """The JAX package's per-block upload chain (``_fused_program``) on one
    uploaded outer block ``x``: the front, the full-resolution basins
    watershed with the fused size filter, the dense relabel of the inner
    block (the padded remainder past ``extent`` masked out) and the edge
    statistics.  Returns ``(tbl, dense_grid)``: ``tbl`` float64 with row 0
    ``[k, ok, n_runs, overflow]`` (:func:`_stats_table`)."""
    from ..ops.watershed import basins, dense_relabel, extent_valid_mask

    n_outer = int(np.prod(p.outer_shape))
    inner_sl = tuple(slice(h, o - h) for h, o in zip(p.halo, p.outer_shape))
    xf = _normalized(x)
    height, seeds = _height_and_seeds(xf, p)
    ws, ok = basins(height, seeds, None, 1, 64, p.min_size,
                    max(n_outer // 64, 1024), max(n_outer // 8, 4096))
    inner = ws[inner_sl]
    valid = extent_valid_mask(inner.shape, extent, device=x.device)
    dense_grid, k = dense_relabel(inner, n_outer, valid=valid)
    tbl = _stats_table(dense_grid, xf[inner_sl], p.e_max, [k, ok])
    return tbl, dense_grid


def hybrid_pre(x: torch.Tensor, p: "ResidentParams", seed_cap: int):
    """Hybrid stage A (``_hybrid_pre_program``): the front on the card,
    returning the height quantized to uint8 (round half to even, as
    ``jnp.round``) and the seeds as COO — the linear position and id of
    the first ``seed_cap`` seed voxels in index order — plus the seed-voxel
    count (more than ``seed_cap`` is an overflow the caller raises on)."""
    xf = _normalized(x)
    height, seeds = _height_and_seeds(xf, p)
    hq = torch.clamp(torch.round(height * 255.0), 0, 255).to(torch.uint8)
    sflat = seeds.reshape(-1)
    n = sflat.shape[0]
    has = sflat > 0
    tgt = torch.cumsum(has.to(torch.int32), 0, dtype=torch.int32) - 1
    n_seeds = tgt[-1:] + 1
    # slot seed_cap takes every voxel that is no seed or past the capacity
    # (its content is discarded): no host sync for the compaction
    tgt = torch.where(has & (tgt < seed_cap), tgt, seed_cap).long()
    pos = torch.zeros(seed_cap + 1, dtype=torch.int32, device=x.device)
    pos.scatter_(0, tgt, torch.arange(n, dtype=torch.int32,
                                      device=x.device))
    sid = torch.zeros(seed_cap + 1, dtype=torch.int32, device=x.device)
    sid.scatter_(0, tgt, sflat.to(torch.int32))
    return hq, pos[:seed_cap], sid[:seed_cap], n_seeds


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host block on ``device``: through pinned memory with an
    asynchronous copy on the card (a pageable copy would wait for the
    stream's earlier work)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def resident_block(vol: torch.Tensor, origin: Sequence[int],
                   extent: Sequence[int], p: ResidentParams):
    """The whole chain for one block of the resident padded volume ``vol``
    (outer window at ``origin``, REAL clipped inner size ``extent``).

    Returns ``(tbl, packed, dense_grid)`` on the volume's device: ``tbl``
    is float32 ``(1 + e_max, 12)`` — row 0 the meta vector ``[k, n_runs,
    e_overflow, cap_overflow, ok, n_rle, rle_ok]``, rows 1.. ``[u, v,
    feats...]`` (every value exact in float32: ids < 2^15, counts <
    2^24) — ``packed`` the int64 run-length stream and ``dense_grid`` the
    int32 dense inner labels."""
    from ..ops.rag import (boundary_pair_values, boundary_pair_values_dual,
                           compact_valid, edge_stats_device,
                           edge_stats_hist_packed)
    from ..ops.sweep import rle_encode_packed
    from ..ops.watershed import coarse, dense_relabel, extent_valid_mask

    dev = vol.device
    outer = p.outer_shape
    inner_sl = tuple(slice(h, o - h) for h, o in zip(p.halo, outer))
    x = vol[tuple(slice(o, o + s) for o, s in zip(origin, outer))]
    xf = _normalized(x)
    height, seeds = _height_and_seeds(xf, p)
    ws, ok = coarse(height, seeds, p.min_size, p.refine_rounds,
                    p.coarse_factor, dense_ids=True)

    # dense per-block relabel of the INNER region; the reflect-padded
    # remainder of border blocks is masked out of the rank, the id count
    # and the pair set.  Coarse ids are already dense on the coarse grid,
    # so the presence table is coarse-voxel-sized
    cf = p.coarse_factor
    cn_bound = int(np.prod([-(-o // cf) for o in outer]))
    inner = ws[inner_sl]
    valid = extent_valid_mask(inner.shape, extent, device=dev)
    dense_grid, k = dense_relabel(inner, cn_bound, valid=valid)

    if p.is_u8:
        # uint8 inputs keep their raw byte samples (the histogram
        # statistics are exact); each pair compacts ONCE carrying both
        # side samples packed into two int32 channels — (u, v) as
        # u*2^15+v and the side bytes as a*256+b.  Packing needs every
        # dense label < 2^15; the ok guard below routes any other block
        # to the host fallback
        u, v, va, vb, okp = boundary_pair_values_dual(dense_grid,
                                                      x[inner_sl])
        n = int(u.shape[0])
        cap = max(min(p.pair_cap, 1 << int(np.ceil(np.log2(max(n, 2))))),
                  1 << 13)
        key = u * 32768 + v
        vab = va.to(torch.int32) * 256 + vb.to(torch.int32)
        (ckey, cvab), cok, cap_overflow = compact_valid(okp, [key, vab],
                                                        cap)
        uv, feats, n_runs, e_overflow = edge_stats_hist_packed(
            ckey, cvab, cok, e_max=p.e_max)
        ok = ok & (k < (1 << 15))
    else:
        # float inputs: the full sorted-position path; pair_cap is
        # pair-denominated and this path carries two samples per pair
        u, v, vals, okp = boundary_pair_values(dense_grid, xf[inner_sl])
        n = int(u.shape[0])
        cap = max(min(2 * p.pair_cap,
                      1 << int(np.ceil(np.log2(max(n, 2))))), 1 << 14)
        (cu, cv, cvals), cok, cap_overflow = compact_valid(
            okp, [u, v, vals], cap)
        uv, feats, n_runs, e_overflow = edge_stats_device(
            cu, cv, cvals, cok, e_max=p.e_max)

    packed, n_rle, rle_ok = rle_encode_packed(dense_grid.reshape(-1),
                                              p.rle_cap)
    meta = torch.stack([
        k.to(torch.float32), n_runs.to(torch.float32),
        e_overflow.to(torch.float32), cap_overflow.to(torch.float32),
        ok.to(torch.float32),
        torch.tensor(float(n_rle), device=dev),
        torch.tensor(float(rle_ok), device=dev)])
    body = torch.cat([uv.to(torch.float32), feats.to(torch.float32)], dim=1)
    meta_row = torch.zeros((1, body.shape[1]), dtype=torch.float32,
                           device=dev)
    meta_row[0, :meta.shape[0]] = meta
    tbl = torch.cat([meta_row, body], dim=0)
    return tbl, packed, dense_grid


class _Download:
    """Pinned host copies of device tensors, started with
    ``non_blocking=True`` when the download is created, and the one CUDA
    event that marks them done (on the CPU: the tensors themselves)."""

    def __init__(self, *tensors):
        if tensors[0].device.type == "cuda":
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = list(tensors), None

    def wait(self):
        """The host copies as numpy arrays, once the copies are done."""
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


# ---------------------------------------------------------------------------
# the mesh-resident chain: the whole volume split into z-slabs over a 1-d
# device mesh (one subproblem per shard), watershed + RAG + edge statistics
# per shard, with the reduce as collectives instead of host stitching: halos
# over the ring of parallel/stencil.py, label offsets from an exclusive scan
# of the per-shard counts, cross-shard face edges from the next shard's
# received first plane, joined into the same edge reduction as the interior
# pairs.  No per-block dispatch, no halo re-upload, no FusedFaceAssembly.
# ---------------------------------------------------------------------------


def mesh_slab_block_shape(shape, n_shards: int):
    """The slab decomposition of the mesh-resident path: z split into
    ``n_shards`` equal slabs (the last one clipped), y/x unsplit."""
    slab_z = -(-int(shape[0]) // int(n_shards))
    return [int(slab_z), int(shape[1]), int(shape[2])]


def mesh_resident_block_shape(config_dir: str, input_path: str,
                              input_key: str):
    """Slab block shape the fused chain will use under the
    ``mesh_resident`` task config, or None when the chain runs blockwise.
    Workflows call this at DAG-construction time so every downstream task
    (sub-graph merge, edge-id map, feature join, assignment write)
    iterates the slab grid the mesh program produced."""
    from ..core.config import ConfigDir

    cdir = ConfigDir(config_dir)
    cfg = cdir.task_config("fused_segmentation",
                           FusedSegmentationBlocks.default_task_config())
    if not cfg.get("mesh_resident") or cfg.get("ws_method",
                                               "device") != "device":
        return None
    try:
        with file_reader(input_path, "r") as f:
            shape = list(f[input_key].shape)
    except (OSError, KeyError, ValueError):
        return None
    if len(shape) != 3:
        return None
    n = len(mesh_shard_devices(cfg, cdir.global_config()))
    return mesh_slab_block_shape(shape, n)


def mesh_shard_devices(cfg: Dict[str, Any],
                       global_config: Dict[str, Any]) -> list:
    """The mesh-resident chain's shards: one z-slab per shard device of
    the global config (``device`` and ``mesh_devices``).  The task key
    ``mesh_shards`` stays only so one config directory reads the same in
    both packages; it must be 0 or the shard count."""
    from ..parallel.mesh import config_devices

    devices = config_devices(global_config)
    n = int(cfg.get("mesh_shards") or 0)
    if n and n != len(devices):
        raise ValueError(
            f"mesh_shards={n} differs from the {len(devices)} shard "
            "devices: set the global config's mesh_devices instead")
    return devices


@dataclass(frozen=True)
class MeshParams:
    """Everything the mesh-resident program depends on besides the slabs
    (the JAX package's ``_mesh_resident_program`` args)."""
    n_shards: int
    slab_z: int
    vol_shape: tuple
    halo: tuple         # (hz, hy, hx), clamped to size - 1
    is_u8: bool
    threshold: float
    sigma_seeds: float
    sigma_weights: float
    alpha: float
    min_size: int
    e_max: int
    refine_rounds: int
    pair_cap: int
    coarse_factor: int


def mesh_params(cfg, shape, n_shards: int, halo, is_u8: bool, e_max: int,
                n_fine_blocks: int) -> MeshParams:
    """The mesh-resident program's parameters for ``shape`` split into
    ``n_shards`` slabs, from the fused task config ``cfg``.  Reflect
    padding (slab ends, y/x) mirrors around the border plane, so the halo
    is capped at size - 1 on every axis.  The capacities scale with the
    slab, not the block: ``e_max`` times the blocks per shard, and the
    slab's pairs (doubled for float input's two samples) over 6, rounded
    up to a power of two; ``mesh_e_max`` / ``mesh_pair_cap`` override
    them (an overflow is a hard error naming the knob)."""
    slab_z = -(-int(shape[0]) // int(n_shards))
    e_mesh = int(cfg.get("mesh_e_max") or 0) or \
        int(e_max) * max(-(-n_fine_blocks // n_shards), 1)
    pair_cap = int(cfg.get("mesh_pair_cap") or 0)
    if not pair_cap:
        n_pairs = 3 * slab_z * int(shape[1]) * int(shape[2])
        if not is_u8:
            n_pairs *= 2
        pair_cap = max(1 << int(np.ceil(np.log2(max(n_pairs // 6, 2)))),
                       1 << 14)
    return MeshParams(
        n_shards=int(n_shards), slab_z=slab_z,
        vol_shape=tuple(int(s) for s in shape),
        halo=(min(int(halo[0]), max(slab_z - 1, 0)),
              min(int(halo[1]), int(shape[1]) - 1),
              min(int(halo[2]), int(shape[2]) - 1)), is_u8=is_u8,
        threshold=float(cfg.get("threshold", 0.25)),
        sigma_seeds=float(cfg.get("sigma_seeds", 2.0)),
        sigma_weights=float(cfg.get("sigma_weights", 2.0)),
        alpha=float(cfg.get("alpha", 0.8)),
        min_size=int(cfg.get("size_filter", 25) or 0), e_max=e_mesh,
        refine_rounds=int(cfg.get("refine_rounds", 3)), pair_cap=pair_cap,
        coarse_factor=int(cfg.get("coarse_factor", 2)))


def _reflect_pad_yx(x: torch.Tensor, hy: int, hx: int) -> torch.Tensor:
    """numpy ``reflect`` padding of the y and x axes (border plane
    excluded), by index: exact for every dtype."""
    for axis, h in ((1, hy), (2, hx)):
        if h:
            idx = np.pad(np.arange(x.shape[axis]), (h, h), mode="reflect")
            x = torch.index_select(x, axis, torch.from_numpy(idx).to(
                x.device))
    return x


def _mesh_front(grown: torch.Tensor, sid: int, p: MeshParams):
    """Phase (a) of one shard: the chain on its z-grown slab up to the
    dense relabel.  Returns ``(dense_grid, k, ok, xin)``: the int32 dense
    inner labels, their count, the watershed's capacity flag and the
    shard's raw inner input."""
    from ..ops.watershed import coarse, dense_relabel, extent_valid_mask

    hz, hy, hx = p.halo
    Z, Y, X = p.vol_shape
    x = _reflect_pad_yx(grown, hy, hx)
    xf = _normalized(x)
    rp = ResidentParams(
        outer_shape=tuple(x.shape), halo=tuple(p.halo), is_u8=p.is_u8,
        threshold=p.threshold, sigma_seeds=p.sigma_seeds,
        sigma_weights=p.sigma_weights, alpha=p.alpha, min_size=p.min_size,
        e_max=p.e_max, rle_cap=1, refine_rounds=p.refine_rounds)
    height, seeds = _height_and_seeds(xf, rp)
    del xf
    # same watershed core as the blockwise chain, at slab scope
    ws, ok = coarse(height, seeds, p.min_size, p.refine_rounds,
                    p.coarse_factor, dense_ids=True)
    del height, seeds
    cf = p.coarse_factor
    cn_bound = int(np.prod([-(-o // cf) for o in x.shape]))
    inner = ws[hz:hz + p.slab_z, hy:hy + Y, hx:hx + X]
    # shard-local origin -> validity: the shard-equalizing z-pad (and
    # nothing else — y/x span the volume) never enters the ranks
    valid = extent_valid_mask((p.slab_z, Y, X), origin=[sid * p.slab_z, 0, 0],
                              vol_shape=(Z, Y, X), device=x.device)
    dense_grid, k = dense_relabel(inner, cn_bound, valid=valid)
    xin = x[hz:hz + p.slab_z, hy:hy + Y, hx:hx + X].contiguous()
    return dense_grid, k, ok, xin


def _mesh_stats(lab: torch.Tensor, xin: torch.Tensor,
                recv_lab: torch.Tensor, recv_x: torch.Tensor,
                has_next: bool, p: MeshParams):
    """Phase (c) of one shard: interior pairs of its global labels plus the
    face pairs with the next shard's first plane, compacted once, and the
    edge statistics.  Returns ``(uv, feats, n_runs, e_over, cap_over)``."""
    from ..ops.rag import (boundary_pair_values, boundary_pair_values_dual,
                           compact_valid, edge_stats_device,
                           edge_stats_hist_dual, plane_face_pairs)

    last = p.slab_z - 1
    # the pair (i, i+1) belongs to the shard owning voxel i: only shards
    # with a next shard contribute face pairs
    has = torch.full(tuple(lab.shape[1:]), bool(has_next),
                     device=lab.device)
    fu, fv, fok = plane_face_pairs(lab[last], recv_lab, valid=has)
    if p.is_u8:
        # dual-sample pairs, exact 256-bin histogram statistics; face
        # samples are (my last plane byte, the next shard's first plane
        # byte), FusedFaceAssembly's two-sided convention
        u, v, va, vb, okp = boundary_pair_values_dual(lab, xin)
        vab = va.to(torch.int32) * 256 + vb.to(torch.int32)
        fvab = (xin[last].to(torch.int32) * 256
                + recv_x.to(torch.int32)).reshape(-1)
        (cu, cv, cvab), cok, cap_over = compact_valid(
            torch.cat([okp, fok]), [torch.cat([u, fu]), torch.cat([v, fv]),
                                    torch.cat([vab, fvab])], p.pair_cap)
        uv, feats, n_runs, e_over = edge_stats_hist_dual(
            cu, cv, cvab >> 8, cvab & 255, cok, p.e_max)
    else:
        # float inputs: sorted-position path, two samples per pair (each
        # face pair twice, once per side sample)
        u, v, vals, okp = boundary_pair_values(lab, xin)
        fvals = torch.cat([xin[last].reshape(-1), recv_x.reshape(-1)])
        (cu, cv, cvals), cok, cap_over = compact_valid(
            torch.cat([okp, fok, fok]),
            [torch.cat([u, fu, fu]), torch.cat([v, fv, fv]),
             torch.cat([vals, fvals])], p.pair_cap)
        uv, feats, n_runs, e_over = edge_stats_device(cu, cv, cvals, cok,
                                                      p.e_max)
    return uv, feats, n_runs, e_over, cap_over


def mesh_resident_program(slabs, p: MeshParams):
    """The whole volume's chain over the shards ``slabs`` (shard i the
    ``(slab_z, Y, X)`` slab i of the z-padded volume, on its device), in
    three phases with the collectives between them:

    (a) per shard: the z-halo over the ring (reflect at the outer ends),
        y/x reflect, normalize, EDT (the CUDA min-plus kernel on the card:
        3 launches per shard), Gaussians, maxima, seed CC, the coarse
        watershed at slab scope, the dense relabel with the shard-origin
        validity mask — one shard at a time, keeping only its labels and
        inner input, so the shards' working sets never coexist;
    (b) the exclusive scan of the per-shard counts gives the label offsets
        (on the first shard's device, then one scalar to each shard);
    (c) per shard: the next shard's first label and input planes received
        (real copies), the face pairs, and the edge statistics.

    Returns per-shard lists ``(labs, metas, uvs, feats)``: ``labs`` int32
    global labels, ``metas`` int64 ``[k, n_runs, e_over, cap_over, ok]``,
    ``uvs`` ``(e_max, 2)``, ``feats`` ``(e_max, 10)``, each on its shard's
    device."""
    from ..parallel.mesh import send
    from ..parallel.stencil import grow_shard

    n = p.n_shards
    hz = p.halo[0]
    fronts = []
    for sid in range(n):
        # this shard's part of the ring exchange: its neighbours' slabs
        fronts.append(_mesh_front(grow_shard(slabs, sid, hz, 0,
                                             mode="reflect"), sid, p))
    dev0 = slabs[0].device
    ks = torch.stack([send(f[1].reshape(()).to(torch.int64), dev0)
                      for f in fronts])
    offs = torch.cumsum(ks, 0) - ks
    labs = []
    for sid, (dense_grid, _, _, _) in enumerate(fronts):
        off = send(offs[sid], dense_grid.device).to(torch.int32)
        labs.append(torch.where(dense_grid > 0, dense_grid + off, 0))
    metas, uvs, feats_all = [], [], []
    for sid in range(n):
        lab = labs[sid]
        dense_grid, k, ok, xin = fronts[sid]
        if sid < n - 1:
            recv_lab = send(labs[sid + 1][0], lab.device)
            recv_x = send(fronts[sid + 1][3][0], lab.device)
        else:
            recv_lab = torch.zeros_like(lab[0])
            recv_x = xin[0]
        uv, feats, n_runs, e_over, cap_over = _mesh_stats(
            lab, xin, recv_lab, recv_x, sid < n - 1, p)
        metas.append(torch.stack([
            k.reshape(()).to(torch.int64), n_runs.reshape(()).to(torch.int64),
            e_over.reshape(()).to(torch.int64),
            cap_over.reshape(()).to(torch.int64),
            ok.reshape(()).to(torch.int64)]))
        uvs.append(uv)
        feats_all.append(feats)
    return labs, metas, uvs, feats_all


# ---------------------------------------------------------------------------
# host fallback
# ---------------------------------------------------------------------------


def _host_block_fallback(data, cfg, halo, block, device="cuda"):
    """Always-correct per-block redo (watershed capacity overflow on
    pathological heights): the full-resolution basins watershed with
    exact-capacity retry + numpy edge features, returning (dense
    real-shaped labels, uv, feats, k)."""
    from ..ops.rag import host_boundary_edge_features
    from .watershed import as_normalized_float, run_ws_block

    # the coarse solve just reported the capacity overflow — force the
    # exact-capacity basins path instead of repeating a doomed attempt
    cfg = {**cfg, "ws_algorithm": "basins"}
    ws = run_ws_block(as_normalized_float(data), cfg, device=device)
    inner_sl = tuple(slice(h, h + (b.stop - b.start))
                     for h, b in zip(halo, block.bb))
    inner = ws[inner_sl]
    uniq = np.unique(inner)
    nonzero = uniq[uniq > 0]
    dense = np.searchsorted(nonzero, inner).astype("uint64") + 1
    dense[inner == 0] = 0
    bmap = as_normalized_float(data)[inner_sl]
    uv_h, feats_h = host_boundary_edge_features(dense, bmap)
    return dense, uv_h, feats_h, int(nonzero.size)


def _params(cfg, outer_shape, halo, e_max: int,
            is_u8: bool) -> ResidentParams:
    """The per-block chain's parameters from the task config (``is_u8``:
    the resident volume holds raw bytes; the per-block paths read it from
    each block's dtype)."""
    return ResidentParams(
        outer_shape=tuple(outer_shape), halo=tuple(halo), is_u8=is_u8,
        threshold=float(cfg.get("threshold", 0.25)),
        sigma_seeds=float(cfg.get("sigma_seeds", 2.0)),
        sigma_weights=float(cfg.get("sigma_weights", 2.0)),
        alpha=float(cfg.get("alpha", 0.8)),
        min_size=int(cfg.get("size_filter", 25) or 0), e_max=e_max,
        rle_cap=int(cfg.get("rle_cap", 1 << 22)),
        refine_rounds=int(cfg.get("refine_rounds", 3)),
        pair_cap=int(cfg.get("pair_cap", 1 << 21)),
        coarse_factor=int(cfg.get("coarse_factor", 2)))


class FusedSegmentationBlocks(BlockTask):
    """The fused blockwise pass: fragments written with globally
    consecutive ids (running offset, single job owns the device) plus
    staged interior edge/feature tables per block."""

    task_name = "fused_segmentation"

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str, problem_path: str, **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.problem_path = problem_path
        super().__init__(**kw)
        # the card unless the global config asks for the CPU; no card
        # raises here, at DAG construction, before any work starts
        self.device = task_device(self.global_config)
        method = self.task_config.get("ws_method", "device")
        if method not in ("device", "hybrid", "legacy"):
            raise ValueError(f"unknown ws_method {method!r} (expected "
                             "'device', 'hybrid' or 'legacy')")

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({
            "threshold": 0.25, "sigma_seeds": 2.0, "sigma_weights": 2.0,
            "size_filter": 25, "alpha": 0.8, "halo": [4, 32, 32],
            # buffer capacities size the per-block downloads; overflows
            # raise with a config pointer (e_max) or fall back to a dense
            # download (rle_cap)
            "e_max": 16384, "stream_window": 3,
            # 'device' = resident-volume coarse-basins chain (fastest);
            # 'hybrid' = host C++ flood between two device stages;
            # 'legacy' = per-block-upload device chain
            "ws_method": "device",
            "rle_cap": 1 << 20, "refine_rounds": 3,
            # coarse watershed pooling factor: 2 (conservative) or 4
            "coarse_factor": 2,
            # pair-compaction capacity; an overflowing block is redone at
            # the worst-case capacity, so the tight default only costs
            # when it trips
            "pair_cap": 1 << 21,
            # host-tail pool for the resident drain: RLE decode + fragment
            # staging + store write run per block in these threads while
            # the main thread waits on the NEXT block's device work.
            # 0 = fully sequential drain (bit-identical reference mode)
            "writer_threads": 4,
            # mesh-resident mode: the volume split into z-slabs over the
            # shard devices and the WHOLE chain run as one mesh program
            # (one subproblem per shard device: the global config's
            # mesh_devices; mesh_shards is 0 or that count, see
            # mesh_shard_devices); mesh_e_max / mesh_pair_cap 0 = the
            # blockwise knobs scaled to the slab
            "mesh_resident": False, "mesh_shards": 0,
            "mesh_e_max": 0, "mesh_pair_cap": 0,
        })
        return conf

    def run_impl(self):
        with file_reader(self.input_path, "r") as f:
            in_shape = f[self.input_key].shape
        # a channel store (4-d) segments its 3-d spatial grid
        shape = list(in_shape[1:] if len(in_shape) == 4 else in_shape)
        block_shape = self.global_block_shape()[-len(shape):]
        with file_reader(self.output_path) as f:
            f.require_dataset(self.output_key, shape=shape,
                              chunks=block_shape, dtype="uint64",
                              compression="gzip")
        block_list = self.blocks_in_volume(shape, block_shape)
        # one job: the driver owns the device and the running offset
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "problem_path": self.problem_path,
            "shape": shape, "block_shape": block_shape,
            "device": self.device,
        }, n_jobs=1)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        halo = (cfg.get("halo") or [0] * blocking.ndim)[-blocking.ndim:]
        outer_shape = tuple(b + 2 * h
                            for b, h in zip(cfg["block_shape"], halo))
        e_max = int(cfg.get("e_max", 65536))
        f_in = file_reader(cfg["input_path"], "r")
        f_out = file_reader(cfg["output_path"])
        ds_in = f_in[cfg["input_key"]]
        ds_out = f_out[cfg["output_key"]]
        tmp_folder = job_config["tmp_folder"]

        state = {"offset": np.uint64(0)}
        max_ids: Dict[int, int] = {}
        # per-run staging: a previous chain's fragments for the same store
        # paths would otherwise be served to FusedFaceAssembly / the write
        clear_caches()
        method = cfg.get("ws_method", "device")
        if method == "device" and ds_in.ndim != 3:
            log_fn("resident device path needs a 3d scalar store; "
                   "using the legacy streamed path")
            method = "legacy"
        impl = {"device": (cls._process_mesh if cfg.get("mesh_resident")
                           else cls._process_device),
                "hybrid": cls._process_hybrid,
                "legacy": cls._process_legacy}[method]
        impl(job_config, log_fn, blocking, halo, outer_shape, e_max, ds_in,
             ds_out, tmp_folder, state, max_ids)
        with file_reader(cfg["output_path"]) as f:
            f[cfg["output_key"]].attrs["maxId"] = int(state["offset"])
        write_config(os.path.join(tmp_folder, "fused_max_ids.json"),
                     {str(k_): v for k_, v in max_ids.items()})

    @classmethod
    def _process_device(cls, job_config, log_fn, blocking, halo,
                        outer_shape, e_max, ds_in, ds_out, tmp_folder,
                        state, max_ids):
        """Resident-volume PIPELINED streaming loop: upload the padded
        input volume ONCE, run the chain per block against it
        (:func:`resident_block`), and start the table/RLE device-to-host
        copies asynchronously at submit time so block i's downloads overlap
        block i+1's compute.  The drain's host tail — RLE decode, fragment
        staging, store write — runs in a bounded writer pool, so the main
        thread's only sequential work is the meta parse that chains the
        running label offset."""
        from ..core import telemetry
        from ..core.runtime import (stage, stage_add, stage_bytes,
                                    status_fields, stream_window,
                                    writer_pool)
        from ..ops.edt import build_kernel
        from ..ops.sweep import rle_decode_packed

        cfg = job_config["config"]
        device = resolve_device(cfg.get("device", "cuda"))
        if device.type == "cuda":
            with stage("host-build"):
                build_kernel()
        inner_shape = tuple(o - 2 * h for o, h in zip(outer_shape, halo))
        n_inner = int(np.prod(inner_shape))
        bs = cfg["block_shape"]
        shape = cfg["shape"]

        with stage("store-read"):
            vol = ds_in[...]
        stage_bytes("store-read", vol.nbytes)
        mx = float(vol.max()) if vol.size else 0.0
        is_u8 = (vol.dtype == np.uint8 and mx > 1
                 and not cfg.get("invert_inputs", False))
        # record the volume-level normalization so face assembly in OTHER
        # processes puts face samples on the same scale as the interior
        # samples (a thin plane's own max is not the volume's)
        scale = 255.0 if (mx > 1.0 and mx <= 255) else (mx if mx > 1.0
                                                        else 1.0)
        write_config(os.path.join(tmp_folder, "fused_input_scale.json"),
                     {"scale": scale,
                      "invert": bool(cfg.get("invert_inputs", False))})
        from .watershed import _normalize_input, reflect_indices

        if not is_u8:
            vol = _normalize_input(vol.astype("float32"), cfg).astype(
                "float32")
        _raw_cache_put((os.path.abspath(cfg["input_path"]),
                        cfg["input_key"]), vol, is_u8)

        gdims = [-(-s // b) for s, b in zip(shape, bs)]
        # grid-aligned + halo padding by VOLUME-level reflection
        volp = vol[np.ix_(*[
            reflect_indices(-h, g_ * b + h, s)
            for h, g_, b, s in zip(halo, gdims, bs, shape)])]
        with stage("h2d-upload"):
            vol_dev = torch.from_numpy(np.ascontiguousarray(volp)).to(device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        stage_bytes("h2d-upload", volp.nbytes)

        params = _params(cfg, outer_shape, halo, e_max, is_u8)

        ws_cache_key = (os.path.abspath(cfg["output_path"]),
                        cfg["output_key"])

        def _write(bb, arr):
            t0 = time.perf_counter()
            ds_out[bb] = arr
            stage_add("store-write", time.perf_counter() - t0)
            stage_bytes("store-write", arr.nbytes)

        def _run(bid, p, vol=None):
            block = blocking.get_block(bid)
            extent = [e - b for b, e in zip(block.begin, block.end)]
            tbl, packed, dense_grid = resident_block(
                vol_dev if vol is None else vol, block.begin, extent, p)
            return _Download(tbl, packed), dense_grid

        def _complete(bid, block, real, off, k_i, dense_np, uv_np,
                      feats_np):
            """Per-block host tail, safe to run from a pool worker: the
            offset chain was already advanced by the (sequential) drain,
            and blocks write disjoint chunk-aligned regions."""
            local = dense_np[real]
            local = local.astype("uint16" if k_i < 65536 else "uint32")
            _fragment_cache_put(ws_cache_key + (bid,), local, off, block.bb)
            out = local.astype("uint64")
            out[out > 0] += off
            _write(block.bb, out)
            np.savez(_staged_path(tmp_folder, bid),
                     uv=uv_np.astype("uint64") + off, feats=feats_np,
                     k=np.int64(k_i), offset=np.uint64(off))
            log_fn(f"processed block {bid}")

        def _fetch_and_complete(bid, block, real, off, k_i, n_rle, rle_ok,
                                packed, dense_grid, uv_np, feats_np):
            if rle_ok:
                with stage("fetch-rle"):
                    packed = packed[:n_rle]
                stage_bytes("fetch-rle", packed.nbytes)
                with stage("host-decode"):
                    dense_np = rle_decode_packed(
                        packed, n_rle, n_inner).reshape(inner_shape)
            else:
                with stage("fetch-dense"):
                    dense_np = dense_grid.cpu().numpy()
                stage_bytes("fetch-dense", dense_np.nbytes)
            _complete(bid, block, real, off, k_i, dense_np, uv_np,
                      feats_np)

        def drain(entry, retried: bool = False):
            # one block span per drained block (the cap-retry redo stays
            # inside the original block's span, under its cap-retry stage)
            if retried or not telemetry.enabled():
                return _drain_body(entry, retried)
            with telemetry.span(f"block:{entry[0]}", cat="block",
                                block=entry[0]) as sp:
                out = _drain_body(entry, retried)
                telemetry.annotate_memory(sp)
                return out

        def _drain_body(entry, retried: bool = False):
            bid, (res, dense_grid) = entry
            with stage("sync-execute"):
                tbl, packed = res.wait()
            stage_bytes("sync-execute", tbl.nbytes)
            (k_i, n_r, e_over, cap_over, ws_ok, n_rle,
             rle_ok) = (int(x) for x in tbl[0, :7])
            if cap_over > 0 and not retried:
                # pair compaction overflow (unusually dense fragment
                # boundaries): redo this block once at the worst-case
                # capacity, 3*n_inner valid pairs rounded up
                worst = 1 << int(np.ceil(np.log2(3 * n_inner)))
                with stage("cap-retry"):
                    big = ResidentParams(**{**params.__dict__,
                                            "pair_cap": worst})
                    return _drain_body((bid, _run(bid, big)), retried=True)
            if cap_over > 0:
                raise RuntimeError(
                    f"block {bid}: pair compaction overflow persists at "
                    "the worst-case capacity — shrink blocks")
            if e_over > 0:
                raise RuntimeError(
                    f"block {bid}: edge capacity exceeded "
                    f"(e_max={e_max}) — raise e_max or shrink blocks")
            block = blocking.get_block(bid)
            real = tuple(slice(0, e - b) for b, e in zip(block.begin,
                                                         block.end))
            off = state["offset"]
            if not ws_ok:
                # watershed capacity overflow (pathological heights):
                # always-correct per-block redo, kept on the main thread
                with stage("host-fallback"):
                    outer_sl = tuple(
                        slice(b, b + o) for b, o in zip(block.begin,
                                                        outer_shape))
                    data = volp[outer_sl]
                    dense_np, uv_np, feats_np, k_i = _host_block_fallback(
                        data, cfg, halo, block, device=device)
                max_ids[bid] = k_i
                state["offset"] = off + np.uint64(k_i)
                finisher.submit(_complete, bid, block, real, off, k_i,
                                dense_np, uv_np, feats_np)
                return
            # uv + feats parse out of the already-fetched table; the
            # offset chain advances HERE (sequentially), so the pooled
            # tails are order-free and the pipelined drain stays
            # bit-identical to the sequential one
            uv_np = tbl[1:1 + n_r, :2].astype("int64")
            feats_np = tbl[1:1 + n_r, 2:].astype("float64")
            max_ids[bid] = k_i
            state["offset"] = off + np.uint64(k_i)
            finisher.submit(_fetch_and_complete, bid, block, real, off,
                            k_i, n_rle, rle_ok, packed, dense_grid, uv_np,
                            feats_np)

        block_ids = list(job_config["block_list"])
        window = int(cfg.get("stream_window", 3))
        vols = [vol_dev]
        if job_config.get("target") == "mesh":
            # the mesh target: block i runs on shard device i mod n against
            # the volume resident there, in the same stream with at least
            # two blocks per shard in flight; the drain stays in block
            # order, so offsets and staging equal the one-device run's
            from ..parallel.mesh import blocks_mesh, config_devices, send

            mesh = blocks_mesh(devices=config_devices(
                job_config["global_config"]))
            status_fields(log_fn, mesh_devices=mesh.size,
                          physical_devices=mesh.physical_devices)
            # the padded volume once per distinct device (a real copy on
            # every device but the first)
            copies = {str(vol_dev.device): vol_dev}
            for d in mesh.device_list:
                if str(d) not in copies:
                    copies[str(d)] = send(vol_dev, d)
            vols = [copies[str(d)] for d in mesh.device_list]
            window = max(window, 2 * mesh.size)

        def submit(item):
            i, bid = item
            with stage("dispatch"):
                return bid, _run(bid, params, vols[i % len(vols)])

        with writer_pool(cfg, ds_out) as finisher:
            for _ in stream_window(enumerate(block_ids), submit, drain,
                                   window=window):
                pass

    @classmethod
    def _process_mesh(cls, job_config, log_fn, blocking, halo, outer_shape,
                      e_max, ds_in, ds_out, tmp_folder, state, max_ids):
        """Mesh-resident driver: upload the z-padded volume SPLIT over the
        shard devices once, run :func:`mesh_resident_program` for the whole
        volume, and consume complete per-shard results — globally labelled
        fragments and per-shard edge/feature tables that already include
        the cross-shard faces.  The host's remaining work is slab writes,
        sub-graph/feature staging (one slab == one problem block) and the
        fragment cache for the final assignment write; the device is
        waited on once for the whole volume (``sync-execute``)."""
        from ..core import telemetry
        from ..core.runtime import stage, stage_add, stage_bytes, \
            status_fields, writer_pool
        from ..ops.edt import build_kernel
        from ..parallel.mesh import Placement, shard, single_axis_mesh
        from .watershed import _normalize_input, reflect_indices

        cfg = job_config["config"]
        shape = cfg["shape"]
        slab_bs = list(cfg["block_shape"])     # one slab per shard
        slab_z = int(slab_bs[0])
        devices = mesh_shard_devices(cfg, job_config["global_config"])
        n_shards = len(devices)
        if mesh_slab_block_shape(shape, n_shards) != slab_bs:
            # the task was built without the slab blocking the mesh
            # program produces (FusedProblemWorkflow wires it through the
            # block_shape override): the blockwise path is always valid
            log_fn("mesh_resident set but task blocking is not the slab "
                   "grid; using the streamed per-block path")
            return cls._process_device(job_config, log_fn, blocking, halo,
                                       outer_shape, e_max, ds_in, ds_out,
                                       tmp_folder, state, max_ids)
        mesh = single_axis_mesh("shard", n_shards, devices=devices)
        log_fn(f"mesh-resident: {n_shards} shards on "
               f"{mesh.physical_devices} device(s)")
        status_fields(log_fn, mesh_devices=mesh.size,
                      physical_devices=mesh.physical_devices)
        if any(d.type == "cuda" for d in mesh.device_list):
            with stage("host-build"):
                build_kernel()

        with stage("store-read"):
            vol = ds_in[...]
        stage_bytes("store-read", vol.nbytes)
        mx = float(vol.max()) if vol.size else 0.0
        is_u8 = (vol.dtype == np.uint8 and mx > 1
                 and not cfg.get("invert_inputs", False))
        scale = 255.0 if (mx > 1.0 and mx <= 255) else (mx if mx > 1.0
                                                        else 1.0)
        write_config(os.path.join(tmp_folder, "fused_input_scale.json"),
                     {"scale": scale,
                      "invert": bool(cfg.get("invert_inputs", False))})
        if not is_u8:
            vol = _normalize_input(vol.astype("float32"), cfg).astype(
                "float32")
        _raw_cache_put((os.path.abspath(cfg["input_path"]),
                        cfg["input_key"]), vol, is_u8)

        # equalize the shards: pad z to n_shards * slab_z by VOLUME-level
        # reflection (the blockwise readers' fold; the padded planes are
        # masked out of ranks and pair sets on the device)
        Zp = n_shards * slab_z
        volp = (vol[reflect_indices(0, Zp, shape[0])] if Zp > shape[0]
                else vol)

        fine_bs = job_config["global_config"]["block_shape"]
        params = mesh_params(cfg, shape, n_shards, halo, is_u8, e_max,
                             Blocking(shape, fine_bs[-3:]).n_blocks)
        log_fn(f"mesh-resident capacities: e_max {params.e_max} pair_cap "
               f"{params.pair_cap}")

        with stage("h2d-upload"):
            slabs = shard(torch.from_numpy(np.ascontiguousarray(volp)),
                          mesh, Placement(("shard",)))
        stage_bytes("h2d-upload", volp.nbytes)

        with stage("dispatch"):
            labs, metas, uvs, feats = mesh_resident_program(slabs, params)
            del slabs
            dl_meta = _Download(torch.stack([m.to(metas[0].device)
                                             for m in metas]))
        # ONE steady-state wait for the whole volume (the per-block path
        # waits once per block)
        with stage("sync-execute"):
            meta = dl_meta.wait()[0].astype("int64")   # (n_shards, 5)
        stage_bytes("sync-execute", meta.nbytes)

        ks = meta[:, 0]
        if not meta[:, 4].all():
            raise RuntimeError(
                "mesh-resident watershed capacity exceeded on shards "
                f"{np.flatnonzero(meta[:, 4] == 0).tolist()} — run with "
                "mesh_resident=false (the blockwise path has a host "
                "fallback) or shrink the volume per shard")
        if (meta[:, 3] > 0).any():
            raise RuntimeError("mesh-resident pair compaction overflow "
                               f"(cap={params.pair_cap}) — raise "
                               "mesh_pair_cap")
        if (meta[:, 2] > 0).any():
            raise RuntimeError("mesh-resident edge capacity exceeded "
                               f"(e_max={params.e_max}) — raise "
                               "mesh_e_max")

        offs = np.concatenate([[0], np.cumsum(ks)]).astype("uint64")
        with stage("d2h-labels"):
            lab = np.concatenate([t.cpu().numpy() for t in labs])[:shape[0]]
            n_runs = meta[:, 1]
            uv_all = [u[:int(n)].cpu().numpy() for u, n in zip(uvs, n_runs)]
            feats_all = [f[:int(n)].cpu().numpy().astype("float64")
                         for f, n in zip(feats, n_runs)]
        stage_bytes("d2h-labels", lab.nbytes)
        del labs, uvs, feats

        ws_cache_key = (os.path.abspath(cfg["output_path"]),
                        cfg["output_key"])

        def _write(bb, arr):
            t0 = time.perf_counter()
            ds_out[bb] = arr
            stage_add("store-write", time.perf_counter() - t0)
            stage_bytes("store-write", arr.nbytes)

        def _drain_slab(sid, pool):
            block = blocking.get_block(sid)
            off, k_i = int(offs[sid]), int(ks[sid])
            sl = lab[block.bb]
            local = np.where(sl > 0, sl.astype("int64") - off, 0)
            local = local.astype("uint16" if k_i < 65536 else "uint32")
            _fragment_cache_put(ws_cache_key + (sid,), local, off, block.bb)
            pool.submit(_write, block.bb, sl.astype("uint64"))
            uv_np = uv_all[sid].astype("uint64")
            feats_np = feats_all[sid]
            order = np.lexsort((uv_np[:, 1], uv_np[:, 0]))
            uv_np, feats_np = uv_np[order], feats_np[order]
            np.savez(_staged_path(tmp_folder, sid), uv=uv_np,
                     feats=feats_np, k=np.int64(k_i), offset=np.uint64(off))
            # the shard tables are already COMPLETE sub-graphs (the device
            # added the cross-shard faces): save them now — there is no
            # FusedFaceAssembly pass on this path
            nodes = np.arange(off + 1, off + k_i + 1, dtype="uint64")
            if len(uv_np):
                nodes = np.unique(np.concatenate([nodes, uv_np.ravel()]))
            g.save_sub_graph(cfg["problem_path"], 0, sid, nodes, uv_np)
            np.savez(_staged_path(tmp_folder, sid) + ".full.npz",
                     uv=uv_np, feats=feats_np)
            max_ids[sid] = k_i
            log_fn(f"processed block {sid}")

        with writer_pool(cfg, ds_out) as pool:
            for sid in range(blocking.n_blocks):
                with telemetry.span(f"slab:{sid}", cat="block",
                                    block=sid) as sp:
                    _drain_slab(sid, pool)
                    telemetry.annotate_memory(sp)
        state["offset"] = np.uint64(offs[-1])

    @staticmethod
    def _write_dense(ds_out, block, dense, off):
        """Offset a block's dense inner labels by the running offset and
        write them (timed as ``store-write``)."""
        from ..core.runtime import stage_add, stage_bytes

        out = dense.astype("uint64")
        out[out > 0] += off
        t0 = time.perf_counter()
        ds_out[block.bb] = out
        stage_add("store-write", time.perf_counter() - t0)
        stage_bytes("store-write", out.nbytes)

    @staticmethod
    def _prefetch_blocks(job_config, blocking, halo, ds_in):
        """The job's (block id, reflect-padded raw outer block) pairs, read
        ahead on a thread pool."""
        from ..core.runtime import prefetch_iter, stage
        from .watershed import _read_padded_input

        cfg = job_config["config"]

        def read(bid):
            with stage("store-read"):
                return bid, _read_padded_input(
                    ds_in, blocking.get_block(bid), cfg, halo, raw=True)

        return prefetch_iter(list(job_config["block_list"]), read)

    @classmethod
    def _process_legacy(cls, job_config, log_fn, blocking, halo,
                        outer_shape, e_max, ds_in, ds_out, tmp_folder,
                        state, max_ids):
        """The JAX package's per-block streamed loop: each block's outer
        window is read (reflect-padded), uploaded and run through
        :func:`legacy_block`; its table and dense labels are copied to
        pinned host memory behind one event while the next blocks run.  A
        block whose watershed capacities overflow (``ok`` false) is redone
        by :func:`_host_block_fallback` (the basins watershed on the same
        device, then host edge features), counted as ``device-ws-redo``."""
        from ..core.runtime import stage, stream_window
        from ..ops.edt import build_kernel

        cfg = job_config["config"]
        device = resolve_device(cfg.get("device", "cuda"))
        if device.type == "cuda":
            with stage("host-build"):
                build_kernel()
        params = _params(cfg, outer_shape, halo, e_max, is_u8=False)

        def submit(entry):
            bid, data = entry
            block = blocking.get_block(bid)
            extent = [b.stop - b.start for b in block.bb]
            with stage("dispatch"):
                tbl, dense_grid = legacy_block(_upload(data, device), extent,
                                               params)
                return bid, data, _Download(tbl, dense_grid)

        def drain(entry):
            bid, data, res = entry
            with stage("sync-execute"):
                tbl, dense_np = res.wait()
            k_i, ok, n_r, overflow = (int(v) for v in tbl[0, :4])
            block = blocking.get_block(bid)
            if overflow > 0:
                raise RuntimeError(
                    f"block {bid}: edge/compaction capacity exceeded "
                    f"(e_max={e_max}) — raise e_max or shrink blocks")
            if not ok:
                with stage("device-ws-redo"):
                    dense_np, uv_np, feats_np, k_i = _host_block_fallback(
                        data, cfg, halo, block, device=device)
                log_fn(f"block {bid}: watershed capacity overflow, redone "
                       "with the exact-capacity basins watershed")
            else:
                uv_np = tbl[1:1 + n_r, :2].astype("int64")
                feats_np = tbl[1:1 + n_r, 2:]
            off = state["offset"]
            # crop the uniform inner frame to the real (clipped) block
            real = tuple(slice(0, b.stop - b.start) for b in block.bb)
            cls._write_dense(ds_out, block, dense_np[real], off)
            np.savez(_staged_path(tmp_folder, bid),
                     uv=uv_np.astype("uint64") + off, feats=feats_np,
                     k=np.int64(k_i), offset=np.uint64(off))
            max_ids[bid] = k_i
            state["offset"] = off + np.uint64(k_i)
            log_fn(f"processed block {bid}")

        reads = cls._prefetch_blocks(job_config, blocking, halo, ds_in)
        for _ in stream_window(reads, submit, drain,
                               window=int(cfg.get("stream_window", 3))):
            pass

    @classmethod
    def _process_hybrid(cls, job_config, log_fn, blocking, halo,
                        outer_shape, e_max, ds_in, ds_out, tmp_folder,
                        state, max_ids):
        """Hybrid streaming loop: device stage A (:func:`hybrid_pre`) ->
        host C++ flood + local size filter + dense compaction -> device
        stage B (:func:`_stats_table`), one block behind: block i's stage
        B is enqueued before block i+1's flood starts and collected after
        it, so the card computes while the host floods.  Writes go through
        the writer pool."""
        from collections import deque

        from .. import native
        from ..core.runtime import stage, stream_window, writer_pool
        from ..ops.edt import build_kernel

        cfg = job_config["config"]
        device = resolve_device(cfg.get("device", "cuda"))
        with stage("host-build"):
            native.load()
            if device.type == "cuda":
                build_kernel()
        params = _params(cfg, outer_shape, halo, e_max, is_u8=False)
        n_outer = int(np.prod(outer_shape))
        seed_cap = max(n_outer // 64, 1 << 14)
        inner_shape = tuple(o - 2 * h for o, h in zip(outer_shape, halo))
        inner_sl = tuple(slice(h, o - h) for h, o in zip(halo, outer_shape))
        min_size = params.min_size
        pending_b = deque()

        def finalize_b():
            bid, res, k_i, off = pending_b.popleft()
            with stage("sync-stats"):
                (tbl,) = res.wait()
            n_r, overflow = int(tbl[0, 0]), int(tbl[0, 1])
            if overflow > 0:
                raise RuntimeError(
                    f"block {bid}: edge capacity exceeded (e_max={e_max})")
            np.savez(_staged_path(tmp_folder, bid),
                     uv=tbl[1:1 + n_r, :2].astype("uint64") + off,
                     feats=tbl[1:1 + n_r, 2:], k=np.int64(k_i),
                     offset=np.uint64(off))
            log_fn(f"processed block {bid}")

        def submit(entry):
            bid, data = entry
            with stage("dispatch"):
                x_dev = _upload(data, device)
                return bid, x_dev, _Download(*hybrid_pre(x_dev, params,
                                                         seed_cap))

        def drain(entry):
            bid, x_dev, res = entry
            with stage("sync-execute"):
                hq, pos, sid, n_seeds = res.wait()
            n_seeds = int(n_seeds[0])
            if n_seeds > seed_cap:
                raise RuntimeError(
                    f"block {bid}: {n_seeds} seed voxels exceed the COO "
                    f"capacity {seed_cap}")
            with stage("host-flood"):
                markers = np.zeros(n_outer, "int64")
                markers[pos[:n_seeds]] = sid[:n_seeds]
                ws = native.seeded_watershed_u8(
                    hq, markers.reshape(outer_shape))
                if min_size:
                    ws = native.size_filter_u8(hq, ws, min_size)
            block = blocking.get_block(bid)
            with stage("host-compact"):
                inner = ws[tuple(slice(h, h + (b.stop - b.start))
                                 for h, b in zip(halo, block.bb))]
                uniq = np.unique(inner)
                nonzero = uniq[uniq > 0]
                dense = np.searchsorted(nonzero, inner).astype("int32") + 1
                dense[inner == 0] = 0
            k_i = int(nonzero.size)
            off = state["offset"]
            writer.submit(cls._write_dense, ds_out, block, dense, off)
            max_ids[bid] = k_i
            state["offset"] = off + np.uint64(k_i)
            # pad the (clipped) dense inner back to the uniform frame; the
            # pad is background, so it adds no pair
            if dense.shape != inner_shape:
                dense = np.pad(dense, [(0, i - s) for i, s in
                                       zip(inner_shape, dense.shape)])
            with stage("dispatch"):
                tbl = _stats_table(_upload(dense, device),
                                   _normalized(x_dev)[inner_sl], e_max, [])
                pending_b.append((bid, _Download(tbl), k_i, off))
            if len(pending_b) > 1:
                finalize_b()

        reads = cls._prefetch_blocks(job_config, blocking, halo, ds_in)
        with writer_pool(cfg, ds_out) as writer:
            for _ in stream_window(reads, submit, drain,
                                   window=int(cfg.get("stream_window", 2))):
                pass
            while pending_b:
                finalize_b()


class FusedFaceAssembly(BlockTask):
    """Add the cross-block face edges (+ their feature samples) from thin
    plane reads and save the COMPLETE per-block sub-graphs (reference
    ownership rule: the pair (i, i+1) belongs to the block owning voxel i,
    so each block contributes its UPPER faces)."""

    task_name = "fused_face_assembly"

    def __init__(self, input_path: str, input_key: str, ws_path: str,
                 ws_key: str, problem_path: str, **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.problem_path = problem_path
        super().__init__(**kw)

    def run_impl(self):
        with file_reader(self.ws_path, "r") as f:
            shape = list(f[self.ws_key].shape)
        block_shape = self.global_block_shape()[-len(shape):]
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "ws_path": self.ws_path, "ws_key": self.ws_key,
            "problem_path": self.problem_path,
            "shape": shape, "block_shape": block_shape,
            "fused_tmp": self.tmp_folder,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from ..core.runtime import stage
        from ..ops.rag import segmented_stats, unique_pairs
        from .watershed import _normalize_input, _read_input

        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        f_ws = file_reader(cfg["ws_path"], "r")
        f_in = file_reader(cfg["input_path"], "r")
        ds_ws = f_ws[cfg["ws_key"]]
        ds_in = f_in[cfg["input_key"]]

        def ws_plane(bb, owner_bid):
            """Fragment plane, from the fused pass's in-RAM copy when this
            process ran it, else from the store."""
            ent = fragment_cache_get(
                cfg["ws_path"], cfg["ws_key"], owner_bid,
                expect_bb=blocking.get_block(owner_bid).bb)
            if ent is not None:
                local, off, obb = ent
                rel = tuple(slice(s.start - o.start, s.stop - o.start)
                            for s, o in zip(bb, obb))
                out = local[rel].astype("uint64")
                out[out > 0] += np.uint64(off)
                return out.ravel()
            with stage("store-read"):
                return np.asarray(ds_ws[bb]).ravel()

        def input_plane(bb):
            """Boundary-map plane on the SAME scale the fused block read
            used (one normalization policy for interior + face samples)."""
            raw = raw_cache_get(cfg["input_path"], cfg["input_key"])
            if raw is not None:
                vol, is_u8 = raw
                x = vol[bb].astype("float64")
                return (x / 255.0 if is_u8 else x).ravel()
            with stage("store-read"):
                if ds_in.ndim == len(bb) + 1:
                    # a channel store: the per-block paths' channel
                    # agglomeration and normalization
                    return _read_input(ds_in, bb, cfg).astype(
                        "float64").ravel()
                x = np.asarray(ds_in[bb])
            sidecar = os.path.join(cfg["fused_tmp"],
                                   "fused_input_scale.json")
            if os.path.exists(sidecar):
                # volume-level normalization recorded by the fused pass
                with open(sidecar) as f:
                    sc = json.load(f)
                x = x.astype("float64") / float(sc["scale"])
                if sc.get("invert"):
                    x = 1.0 - x
                return x.ravel()
            if np.issubdtype(x.dtype, np.integer):
                x = x.astype("float64") / float(np.iinfo(x.dtype).max)
                if cfg.get("invert_inputs", False):
                    x = 1.0 - x
                return x.ravel()
            return _normalize_input(x.astype("float32"),
                                    cfg).astype("float64").ravel()

        for bid in job_config["block_list"]:
            with np.load(_staged_path(cfg["fused_tmp"], bid)) as d:
                uv_int = d["uv"]
                feats_int = d["feats"]
                k = int(d["k"])
                off = int(d["offset"])
            block = blocking.get_block(bid)
            face_u, face_v, face_x = [], [], []
            extra_nodes = []  # +1-halo labels: the classic sub-graph node
            #                   set includes them (reference reads the
            #                   block with increaseRoi)
            for axis in range(blocking.ndim):
                nb = blocking.neighbor_id(bid, axis, +1)
                if nb is None:
                    continue
                hi = block.end[axis]
                bb_lo = tuple(
                    slice(hi - 1, hi) if d_ == axis else s
                    for d_, s in enumerate(block.bb))
                bb_hi = tuple(
                    slice(hi, hi + 1) if d_ == axis else s
                    for d_, s in enumerate(block.bb))
                la = ws_plane(bb_lo, bid)
                lb = ws_plane(bb_hi, nb)
                extra_nodes.append(np.unique(lb[lb > 0]))
                xa = input_plane(bb_lo)
                xb = input_plane(bb_hi)
                fg = (la > 0) & (lb > 0) & (la != lb)
                if not fg.any():
                    continue
                u = np.minimum(la[fg], lb[fg])
                v = np.maximum(la[fg], lb[fg])
                # two samples per face pair (nifty gridRag convention)
                face_u.extend([u, u])
                face_v.extend([v, v])
                face_x.extend([xa[fg], xb[fg]])
            if face_u:
                fu = np.concatenate(face_u)
                fv = np.concatenate(face_v)
                fx = np.concatenate(face_x)
                uniq, inv = unique_pairs(fu, fv)
                feats_face = segmented_stats(inv, fx, len(uniq))
                uv_all = np.concatenate([uv_int, uniq])
                feats_all = np.concatenate([feats_int, feats_face])
            else:
                uv_all, feats_all = uv_int, feats_int
            order = np.lexsort((uv_all[:, 1], uv_all[:, 0]))
            uv_all, feats_all = uv_all[order], feats_all[order]
            nodes = np.arange(off + 1, off + k + 1, dtype="uint64")
            if extra_nodes:
                nodes = np.unique(np.concatenate(
                    [nodes] + [e.astype("uint64") for e in extra_nodes]))
            g.save_sub_graph(cfg["problem_path"], 0, bid, nodes,
                             uv_all.astype("uint64"))
            np.savez(_staged_path(cfg["fused_tmp"], bid) + ".full.npz",
                     uv=uv_all.astype("uint64"), feats=feats_all)
            log_fn(f"processed block {bid}")


class FeatureTablesToIds(BlockTask):
    """Join the staged (uv, feats) tables with the global edge ids (after
    MergeSubGraphs + MapEdgeIds) and write the per-block feature files in
    the format MergeEdgeFeatures consumes."""

    task_name = "fused_feature_ids"

    def __init__(self, ws_path: str, ws_key: str, problem_path: str, **kw):
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.problem_path = problem_path
        super().__init__(**kw)

    def run_impl(self):
        with file_reader(self.ws_path, "r") as f:
            shape = list(f[self.ws_key].shape)
        block_shape = self.global_block_shape()[-len(shape):]
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "problem_path": self.problem_path,
            "shape": shape, "block_shape": block_shape,
            "fused_tmp": self.tmp_folder,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from .features import _block_feature_path

        cfg = job_config["config"]
        os.makedirs(os.path.dirname(
            _block_feature_path(cfg["problem_path"], 0)), exist_ok=True)
        for bid in job_config["block_list"]:
            data = g.load_sub_graph(cfg["problem_path"], 0, bid)
            with np.load(_staged_path(cfg["fused_tmp"], bid)
                         + ".full.npz") as d:
                uv = d["uv"]
                feats = d["feats"]
            local = g.find_edge_ids(data["edges"], uv)
            out = np.zeros((len(data["edges"]), feats.shape[1] if
                            len(feats) else 10), "float64")
            out[local] = feats
            np.savez(_block_feature_path(cfg["problem_path"], bid),
                     edge_ids=data["edge_ids"].astype("int64"),
                     features=out)
            log_fn(f"processed block {bid}")


class FusedProblemWorkflow(Task):
    """Fused analog of WatershedWorkflow + ProblemWorkflow: fragments +
    graph + features + costs from one device pass per block plus cheap
    host assembly (the ``target='gpu'`` path of
    MulticutSegmentationWorkflow)."""

    def __init__(self, input_path: str, input_key: str, ws_path: str,
                 ws_key: str, problem_path: str, tmp_folder: str,
                 config_dir: str, max_jobs: int = 1, target: str = "gpu",
                 compute_costs: bool = True,
                 dependency: Optional[Task] = None):
        self.input_path = input_path
        self.input_key = input_key
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.problem_path = problem_path
        self.compute_costs = compute_costs
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def _common(self):
        return dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                    max_jobs=self.max_jobs, target=self.target)

    def requires(self):
        from .costs import EdgeCostsWorkflow
        from .features import MergeEdgeFeatures
        from .graph import MapEdgeIds, MergeSubGraphs

        # mesh-resident mode: ONE z-slab subproblem per shard — every task
        # below iterates the slab grid the mesh program produced (the
        # device already added the cross-shard faces, so the host face
        # assembly drops out of the DAG)
        mesh_bs = mesh_resident_block_shape(
            self.config_dir, self.input_path, self.input_key)
        bs_kw = {"block_shape": mesh_bs} if mesh_bs else {}

        fused = FusedSegmentationBlocks(
            input_path=self.input_path, input_key=self.input_key,
            output_path=self.ws_path, output_key=self.ws_key,
            problem_path=self.problem_path, dependency=self.dependency,
            **bs_kw, **self._common())
        if mesh_bs:
            faces = fused
        else:
            faces = FusedFaceAssembly(
                input_path=self.input_path, input_key=self.input_key,
                ws_path=self.ws_path, ws_key=self.ws_key,
                problem_path=self.problem_path, dependency=fused,
                **self._common())
        merge = MergeSubGraphs(
            graph_path=self.problem_path, scale=0,
            merge_complete_graph=True, output_key="s0/graph",
            input_path=self.ws_path, input_key=self.ws_key,
            dependency=faces, **bs_kw, **self._common())
        mapped = MapEdgeIds(
            graph_path=self.problem_path, scale=0, graph_key="s0/graph",
            input_path=self.ws_path, input_key=self.ws_key,
            dependency=merge, **bs_kw, **self._common())
        feat_ids = FeatureTablesToIds(
            ws_path=self.ws_path, ws_key=self.ws_key,
            problem_path=self.problem_path, dependency=mapped,
            **bs_kw, **self._common())
        merged_feats = MergeEdgeFeatures(
            graph_path=self.problem_path, graph_key="s0/graph",
            output_path=self.problem_path, output_key="features",
            dependency=feat_ids, **bs_kw, **self._common())
        if not self.compute_costs:
            return merged_feats
        return EdgeCostsWorkflow(
            features_path=self.problem_path, features_key="features",
            output_path=self.problem_path, output_key="s0/costs",
            graph_path=self.problem_path, graph_key="s0/graph",
            dependency=merged_feats, **self._common())

    def output(self):
        name = ("probs_to_costs.status" if self.compute_costs
                else "merge_edge_features.status")
        return FileTarget(os.path.join(self.tmp_folder, name))
