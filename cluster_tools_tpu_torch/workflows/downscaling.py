"""Multiscale pyramid creation + up-scaling, and fitting objects to
boundaries.

Port of cluster_tools_tpu/workflows/downscaling.py (reference
``downscaling/`` package: downscaling.py:232-311 ``_ds_block`` with
vigra-resize / skimage block_reduce samplers, downscaling_workflow.py:33-349
incl. Paintera and BigDataViewer multiscale metadata, upscaling.py:206-257,
scale_to_boundaries.py).  On the device: mean/max/min pooling as a
reshape-reduce and the linear resize; on the host, as in the JAX package:
the label samplers (nearest, majority) and the erosions that make the
seeds of :func:`fit_to_hmap`, whose EDT and seeded watershed run on the
device.

The linear resize is ``jax.image.resize(method="linear")``'s: a
scale-and-translate with a triangle kernel that, when it downsamples, is
widened by the inverse scale (antialiasing) and renormalized at the
border — one weight matrix per axis (:func:`linear_resize_weights`),
applied as a product.  ``torch.nn.functional.interpolate`` neither widens
nor renormalizes, and differs from it by up to 0.12 on random data.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from ..core.blocking import Blocking
from ..core.device import task_device
from ..core.runtime import BlockTask
from ..core.storage import file_reader
from ..core.workflow import FileTarget, Task

ScaleFactor = Union[int, Sequence[int]]


def _factor3(scale_factor: ScaleFactor) -> List[int]:
    if isinstance(scale_factor, int):
        return [scale_factor] * 3
    return [int(s) for s in scale_factor]


def linear_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """``(in_size, out_size)`` float32 weights of ``jax.image.resize``'s
    linear method along one axis: the triangle kernel at the output
    sample centers, widened by ``in_size / out_size`` when it downsamples,
    each column renormalized to sum 1, columns whose sample lies outside
    the input zeroed."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                * np.float32(inv_scale) - np.float32(0.5))
    x = np.abs(sample_f[np.newaxis, :] - np.arange(
        in_size, dtype=np.float32)[:, np.newaxis]) / kernel_scale
    weights = np.maximum(np.float32(0), np.float32(1) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[np.newaxis, :], weights, 0).astype(np.float32)


def linear_resize(x, out_shape: Sequence[int]):
    """``jax.image.resize(x, out_shape, method="linear")`` of a float32
    tensor on its device: one weight matrix per resized axis, contracted
    in float64 and rounded to float32 once."""
    import torch

    y = x.to(torch.float64)
    for ax, (n_in, n_out) in enumerate(zip(x.shape, out_shape)):
        if n_in == n_out:
            continue
        w = torch.from_numpy(linear_resize_weights(n_in, n_out)).to(
            device=x.device, dtype=torch.float64)
        y = torch.movedim(torch.tensordot(y, w, dims=([ax], [0])), -1, ax)
    return y.to(torch.float32)


def _resize_array(x: np.ndarray, out_shape, device) -> np.ndarray:
    """:func:`linear_resize` of a host array on ``device``; float inputs
    keep their dtype, integer ones come back as float32."""
    import torch

    y = linear_resize(torch.from_numpy(
        np.ascontiguousarray(x, dtype="float32")).to(device), out_shape)
    return y.cpu().numpy().astype(
        x.dtype if np.issubdtype(x.dtype, np.floating) else "float32")


def _edge_pad(t, out_shape, factor):
    """``t`` padded at its upper border up to ``out_shape * factor`` by
    repeating the last sample (numpy's ``"edge"`` mode)."""
    import torch

    for ax, (o, f) in enumerate(zip(out_shape, factor)):
        n = t.shape[ax]
        if o * f != n:
            idx = torch.from_numpy(np.minimum(np.arange(o * f), n - 1)).to(
                t.device)
            t = torch.index_select(t, ax, idx)
    return t


def downsample(x: np.ndarray, factor: Sequence[int], sampler: str = "mean",
               device: str = "cuda") -> np.ndarray:
    """Downsample by integer factors.

    samplers: 'mean' | 'max' | 'min' (pooling, on ``device``), 'nearest'
    (label-safe subsampling, host), 'majority' (label-safe mode pooling,
    host), 'interpolate' (linear resize — the vigra.sampling.resize analog,
    on ``device``).
    """
    import torch

    factor = list(factor)
    # pad up to a multiple of the factor (edge replicate), pool, crop back
    out_shape = tuple(-(-s // f) for s, f in zip(x.shape, factor))

    if sampler == "interpolate":
        return _resize_array(x, out_shape, device)
    if sampler == "nearest":
        # subsample at the window centers — exact for label volumes
        idx = tuple(np.minimum(np.arange(o) * f + f // 2, s - 1)
                    for o, f, s in zip(out_shape, factor, x.shape))
        return x[np.ix_(*idx)]
    if sampler == "majority":
        return _majority_pool(x, factor, out_shape)
    if sampler not in ("mean", "max", "min"):
        raise KeyError(sampler)

    t = torch.from_numpy(np.ascontiguousarray(x, dtype="float32")).to(device)
    r = _edge_pad(t, out_shape, factor).reshape(
        out_shape[0], factor[0], out_shape[1], factor[1], out_shape[2],
        factor[2])
    if sampler == "mean":
        y = r.mean(dim=(1, 3, 5))
    else:
        y = r.amax(dim=(1, 3, 5)) if sampler == "max" else \
            r.amin(dim=(1, 3, 5))
    y = y.cpu().numpy()
    if np.issubdtype(x.dtype, np.integer):
        info = np.iinfo(x.dtype)
        y = np.clip(np.round(y), info.min, info.max)
    return y.astype(x.dtype)


def pooling_windows(x: np.ndarray, factor, out_shape,
                    pad_mode: str = "edge") -> np.ndarray:
    """``(out_shape..., prod(factor))`` view of x's pooling windows, with
    the upper border padded to a factor multiple (shared by the majority
    pool here and the label-multiset computation)."""
    pad = tuple((0, o * f - s) for s, f, o in zip(x.shape, factor,
                                                  out_shape))
    xp = np.pad(x, pad, mode=pad_mode)
    r = xp.reshape(out_shape[0], factor[0], out_shape[1], factor[1],
                   out_shape[2], factor[2])
    return r.transpose(0, 2, 4, 1, 3, 5).reshape(*out_shape, -1)


def _majority_pool(x: np.ndarray, factor, out_shape) -> np.ndarray:
    """Mode over each pooling window (label-safe downsampling)."""
    windows = pooling_windows(x, factor, out_shape)
    w = np.sort(windows, axis=-1)
    # longest run in the sorted window = the mode
    n = w.shape[-1]
    best = w[..., 0].copy()
    best_run = np.ones(out_shape, "int32")
    run = np.ones(out_shape, "int32")
    for k in range(1, n):
        same = w[..., k] == w[..., k - 1]
        run = np.where(same, run + 1, 1)
        upd = run > best_run
        best_run = np.where(upd, run, best_run)
        best = np.where(upd, w[..., k], best)
    return best.astype(x.dtype)


def upsample(x: np.ndarray, factor: Sequence[int],
             sampler: str = "nearest", device: str = "cuda") -> np.ndarray:
    """Upsample by integer factors (reference: upscaling.py:206-257):
    ``'interpolate'`` is the linear resize on ``device``, anything else
    repeats the samples (host)."""
    out_shape = tuple(s * f for s, f in zip(x.shape, factor))
    if sampler == "interpolate":
        return _resize_array(x, out_shape, device)
    return np.repeat(np.repeat(np.repeat(x, factor[0], 0), factor[1], 1),
                     factor[2], 2)


class UpscaleTask(BlockTask):
    """Blockwise up-scaling of a coarse volume to a finer grid (reference:
    upscaling.py ``UpscalingBase`` / ``_upsample_block``, upscaling.py:206-257).

    Blocks cover the OUTPUT (fine) volume; each block loads the covering
    coarse window, resizes it on device (``'interpolate'`` — the
    vigra.sampling.resize analog) or repeats it (``'nearest'``, label-safe),
    and crops the exact window.  Empty coarse windows are skipped; uint8/16
    outputs are rounded and clipped like the reference."""

    task_name = "upscaling"

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str, scale_factor: ScaleFactor,
                 identifier: str = "", **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.scale_factor = _factor3(scale_factor)
        self.identifier = identifier
        super().__init__(**kw)
        self.device = task_device(self.global_config)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"sampler": "nearest"})
        return conf

    def run_impl(self):
        with file_reader(self.input_path, "r") as f:
            ds = f[self.input_key]
            in_shape = list(ds.shape)
            dtype = str(ds.dtype)
        out_shape = [s * f for s, f in zip(in_shape, self.scale_factor)]
        block_shape = [min(b, s) for b, s in
                       zip(self.global_block_shape(), out_shape)]
        with file_reader(self.output_path) as f:
            f.require_dataset(self.output_key, shape=out_shape,
                              chunks=block_shape, dtype=dtype)
        block_list = self.blocks_in_volume(out_shape, block_shape)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "scale_factor": self.scale_factor, "shape": out_shape,
            "block_shape": block_shape, "in_shape": in_shape,
            "device": self.device,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from ..core.device import resolve_device

        cfg = job_config["config"]
        device = str(resolve_device(cfg["device"]))
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        factor = cfg["scale_factor"]
        ds_in = file_reader(cfg["input_path"], "r")[cfg["input_key"]]
        ds_out = file_reader(cfg["output_path"])[cfg["output_key"]]
        sampler = cfg.get("sampler", "nearest")
        dtype = ds_out.dtype

        # interpolation needs a 1-voxel coarse halo so values at block faces
        # see their neighbors — without it the resize renormalizes at the
        # window border and every block face shows a seam
        pad = 1 if sampler == "interpolate" else 0
        for block_id in job_config["block_list"]:
            bb = blocking.get_block(block_id).bb
            in_bb = tuple(
                slice(max(b.start // f - pad, 0),
                      min(-(-b.stop // f) + pad, s))
                for b, f, s in zip(bb, factor, cfg["in_shape"]))
            x = np.asarray(ds_in[in_bb])
            if not x.any():
                log_fn(f"processed block {block_id}")
                continue
            y = upsample(x, factor, sampler, device=device)
            # crop the requested fine window out of the upsampled cover
            off = [b.start - i.start * f
                   for b, i, f in zip(bb, in_bb, factor)]
            local = tuple(slice(o, o + (b.stop - b.start))
                          for o, b in zip(off, bb))
            y = y[local]
            if np.dtype(dtype) in (np.dtype("uint8"), np.dtype("uint16")):
                y = np.clip(np.round(y), 0, np.iinfo(dtype).max)
            ds_out[bb] = y.astype(dtype)
            log_fn(f"processed block {block_id}")


def _normalize01(x: np.ndarray) -> np.ndarray:
    x = x.astype("float32")
    lo, hi = float(x.min()), float(x.max())
    return (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)


def _preserving_erosion(mask: np.ndarray, erode_by: int) -> np.ndarray:
    """Erode, halving the radius until a nonempty seed survives
    (reference: utils/volume_utils.py preserving_erosion)."""
    from scipy.ndimage import binary_erosion

    eroded = binary_erosion(mask, iterations=erode_by)
    while not eroded.any():
        if erode_by == 1:
            return mask
        erode_by //= 2
        eroded = binary_erosion(mask, iterations=erode_by)
    return eroded


def _fit_seeds(objs: np.ndarray, bg_id: int, erode_by,
               max_erode: int) -> np.ndarray:
    """uint32 seeds of one block (or slice): the background eroded by
    ``max_erode`` as ``bg_id``, each object eroded by its radius.  Each
    object's erosion runs on its bounding box: the mask is zero outside
    it, and the erosion reads zero beyond the array's border too
    (``border_value=0``), so the result equals the erosion of the whole
    block."""
    from scipy.ndimage import binary_erosion, find_objects

    seeds = (bg_id * binary_erosion(objs == 0, iterations=max_erode)
             ).astype("uint32")
    ids, dense = np.unique(objs, return_inverse=True)
    dense = dense.reshape(objs.shape)
    for k, box in enumerate(find_objects(dense + 1)):
        obj_id = int(ids[k])
        if obj_id == 0 or box is None:
            continue
        er = erode_by[obj_id] if isinstance(erode_by, dict) else erode_by
        seeds[box][_preserving_erosion(dense[box] == k, er)] = obj_id
    return seeds


def fit_to_hmap(objs: np.ndarray, hmap: np.ndarray, erode_by,
                fit_3d: bool = True, device: str = "cuda") -> np.ndarray:
    """Re-fit object boundaries to a height map: erode objects/background
    into seeds, then grow them back with a seeded watershed over the height
    map blended with a boundary distance (reference:
    utils/volume_utils.py:294-391 ``fit_to_hmap``/``fit_seeds``).  The
    erosions stay on the host (few objects); the EDT (three min-plus
    launches; two with ``fit_3d=False``, the per-slice EDT of the stack)
    and the watershed (per slice with ``fit_3d=False``) run on
    ``device``."""
    import torch

    from ..ops.edt import distance_transform_edt
    from ..ops.watershed import seeded_watershed

    obj_ids = np.unique(objs)
    obj_ids = obj_ids[obj_ids != 0]
    bg_id = int(obj_ids[-1]) + 1 if len(obj_ids) else 1
    if isinstance(erode_by, dict):
        erode_by = {int(k): v for k, v in erode_by.items()}
        max_erode = max(erode_by.values())
    else:
        max_erode = erode_by

    hmap = _normalize01(hmap)
    threshd = hmap > 0.3
    alpha = 0.8
    # distance of every voxel to the thresholded boundary set (per slice
    # without fit_3d)
    dt = distance_transform_edt(
        torch.from_numpy(~threshd).to(device),
        axes=None if fit_3d else (1, 2)).cpu().numpy()

    def _height(hm, d):
        return alpha * hm + (1.0 - alpha) * (1.0 - _normalize01(d))

    def _ws(height, seeds):
        return seeded_watershed(
            torch.from_numpy(height).to(device),
            torch.from_numpy(seeds.astype("int64")).to(device)).cpu().numpy()

    if fit_3d:
        new = _ws(_height(hmap, dt), _fit_seeds(objs, bg_id, erode_by,
                                                max_erode))
    else:
        new = np.zeros(objs.shape, "uint32")
        for z in range(objs.shape[0]):
            new[z] = _ws(_height(hmap[z], dt[z]),
                         _fit_seeds(objs[z], bg_id, erode_by, max_erode))
    new = new.astype("uint64")
    new[new == bg_id] = 0
    return new


class ScaleToBoundariesTask(BlockTask):
    """Fit (possibly low-resolution) objects to a full-resolution boundary
    map (reference: downscaling/scale_to_boundaries.py:148-182
    ``_scale_block`` / ``scale_to_boundaries``).

    Blocks load the objects through an interpolated full-res view with an
    ``erode_by`` halo, re-fit them to the boundary map via
    :func:`fit_to_hmap`, add ``offset`` to the foreground, and ACCUMULATE
    into the output (``out[fg] += obj[fg]``) so several object sets can be
    painted with disjoint offset ranges, like the reference."""

    task_name = "scale_to_boundaries"
    allow_retry = False  # read-modify-write accumulate is not idempotent

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str, boundaries_path: str, boundaries_key: str,
                 offset: int = 0, **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.boundaries_path = boundaries_path
        self.boundaries_key = boundaries_key
        self.offset = int(offset)
        self.identifier = f"offset{offset}"
        super().__init__(**kw)
        self.device = task_device(self.global_config)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"erode_by": 12, "erode_3d": True, "channel": 0,
                     "dtype": "uint64"})
        return conf

    def run_impl(self):
        with file_reader(self.boundaries_path, "r") as f:
            shape = list(f[self.boundaries_key].shape)
        if len(shape) == 4:
            shape = shape[1:]
        block_shape = [min(b, s) for b, s in
                       zip(self.global_block_shape(), shape)]
        with file_reader(self.output_path) as f:
            f.require_dataset(self.output_key, shape=shape,
                              chunks=block_shape,
                              dtype=self.task_config.get("dtype", "uint64"))
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "boundaries_path": self.boundaries_path,
            "boundaries_key": self.boundaries_key, "offset": self.offset,
            "shape": shape, "block_shape": block_shape,
            "device": self.device,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from ..core.device import resolve_device
        from ..core.volume_views import InterpolatedVolume

        cfg = job_config["config"]
        device = str(resolve_device(cfg["device"]))
        shape = cfg["shape"]
        blocking = Blocking(shape, cfg["block_shape"])
        erode_by = cfg.get("erode_by", 12)
        erode_3d = bool(cfg.get("erode_3d", True))
        channel = int(cfg.get("channel", 0))
        offset = int(cfg["offset"])
        halo_r = (max(erode_by.values()) if isinstance(erode_by, dict)
                  else int(erode_by))
        halo = [halo_r] * 3 if erode_3d else [0, halo_r, halo_r]

        ds_bd = file_reader(cfg["boundaries_path"], "r")[cfg["boundaries_key"]]
        ds_out = file_reader(cfg["output_path"])[cfg["output_key"]]
        ds_in = file_reader(cfg["input_path"], "r")[cfg["input_key"]]
        if tuple(ds_in.shape) != tuple(shape):
            ds_in = InterpolatedVolume(ds_in, shape)

        for block_id in job_config["block_list"]:
            block = blocking.get_block_with_halo(block_id, halo)
            in_bb, out_bb = block.outer.bb, block.inner.bb
            local_bb = block.inner_local.bb
            obj = np.asarray(ds_in[in_bb])
            if not obj.any():
                log_fn(f"processed block {block_id}")
                continue
            if int(obj.max()) >= 2 ** 31:
                raise ValueError(
                    "scale_to_boundaries seeds are 32-bit (as in the "
                    "reference's fit_seeds); relabel object ids below "
                    "2**31 first")
            if ds_bd.ndim == 4:
                hmap = np.asarray(ds_bd[(slice(channel, channel + 1),)
                                        + in_bb])[0]
            else:
                hmap = np.asarray(ds_bd[in_bb])
            fitted = fit_to_hmap(obj, hmap, erode_by, fit_3d=erode_3d,
                                 device=device)
            fitted = fitted[local_bb]
            fg = fitted != 0
            out = np.asarray(ds_out[out_bb])
            out[fg] += (fitted[fg] + offset).astype(out.dtype)
            ds_out[out_bb] = out
            log_fn(f"processed block {block_id}")


class PainteraToBdvWorkflow(Task):
    """Convert a Paintera multiscale group to a BigDataViewer (bdv.n5)
    pyramid (reference: downscaling_workflow.py:352+ ``PainteraToBdvWorkflow``).

    Discovers the ``s0..sN`` scale levels under ``input_key_prefix``, copies
    each to the bdv.n5 layout ``setup0/timepoint0/s{i}`` with CopyVolume
    tasks, and writes the bdv metadata + SpimData XML sidecar.  Resolution /
    offset attributes found on the paintera group are carried over
    (java-order XYZ -> ZYX).  Output stays n5 — the reference itself notes
    "HDF5 is frickin slow" and computes in n5; our bdv export is the bdv.n5
    flavor rather than the legacy bdv.h5 one.

    Like the reference, ``requires()`` inspects the paintera group at
    DAG-construction time (reference: downscaling_workflow.py get_scales),
    so the group must already exist when this workflow is constructed —
    build upstream producers in a separate ``build()`` first; ``dependency``
    only sequences tasks that do not create the group."""

    def __init__(self, input_path: str, input_key_prefix: str,
                 output_path: str, tmp_folder: str, config_dir: str,
                 max_jobs: int = 1, target: str = "gpu",
                 dtype: Optional[str] = None, metadata_dict=None,
                 dependency: Optional[Task] = None):
        self.input_path = input_path
        self.input_key_prefix = input_key_prefix
        self.output_path = output_path
        self.dtype = dtype
        self.metadata_dict = dict(metadata_dict or {})
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def _scales(self) -> List[int]:
        root = os.path.join(self.input_path, self.input_key_prefix)
        scales = []
        for name in os.listdir(root):
            if not name.startswith("s"):
                continue
            if not os.path.isdir(os.path.join(root, name)):
                continue
            try:
                scales.append(int(name[1:]))
            except ValueError:
                pass
        return sorted(scales)

    def requires(self):
        from .copy_volume import CopyVolumeTask

        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                      max_jobs=self.max_jobs, target=self.target)
        scales = self._scales()
        dep = self.dependency
        prev = None
        rel_factors = []  # ZYX, per scale > 0
        with file_reader(self.input_path, "r") as f:
            for scale in scales:
                in_key = os.path.join(self.input_key_prefix, f"s{scale}")
                eff = f[in_key].attrs.get("downsamplingFactors", [1, 1, 1])
                eff = [eff] * 3 if isinstance(eff, (int, float)) else list(eff)
                if scale > 0:
                    rel = [int(round(e / p)) for e, p in zip(eff, prev)]
                    if any(r < 1 for r in rel):
                        raise ValueError(
                            f"scale s{scale} downsamplingFactors {eff} not "
                            f"monotone over previous {prev} — missing or "
                            "inconsistent paintera attributes")
                    rel_factors.append(rel[::-1])
                prev = list(eff)
            attrs = f[self.input_key_prefix].attrs
            offsets = attrs.get("offset")
            resolution = attrs.get("resolution")
        meta = dict(self.metadata_dict)
        if "offsets" not in meta and offsets is not None:
            meta["offsets"] = list(offsets)[::-1]
        if "resolution" not in meta and resolution is not None:
            meta["resolution"] = list(resolution)[::-1]

        for scale in scales:
            dep = CopyVolumeTask(
                input_path=self.input_path,
                input_key=os.path.join(self.input_key_prefix, f"s{scale}"),
                output_path=self.output_path,
                output_key=f"setup0/timepoint0/s{scale}",
                dtype=self.dtype, identifier=f"bdv_s{scale}",
                dependency=dep, **common)
        return WriteDownscalingMetadata(
            tmp_folder=self.tmp_folder, output_path=self.output_path,
            scale_factors=rel_factors,
            output_key_prefix="setup0/timepoint0",
            metadata_dict=meta, metadata_format="bdv",
            identifier="paintera_to_bdv", dependency=dep)

    def output(self):
        return FileTarget(os.path.join(
            self.tmp_folder, "downscaling_metadata_paintera_to_bdv.status"))


class DownscaleTask(BlockTask):
    """One pyramid level: blockwise downsample of the previous level
    (reference: DownscalingBase, downscaling.py:31-140)."""

    task_name = "downscaling"

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str, scale_factor: ScaleFactor,
                 sampler: Optional[str] = None, identifier: str = "", **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.scale_factor = _factor3(scale_factor)
        #: constructor override of the config-tier sampler (label pyramids
        #: must be nearest/majority regardless of the shared task config)
        self.sampler = sampler
        self.identifier = identifier
        super().__init__(**kw)
        self.device = task_device(self.global_config)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"sampler": "mean"})
        return conf

    def run_impl(self):
        with file_reader(self.input_path, "r") as f:
            in_shape = list(f[self.input_key].shape)
        out_shape = [-(-s // f) for s, f in zip(in_shape, self.scale_factor)]
        block_shape = [min(b, s) for b, s in
                       zip(self.global_block_shape(), out_shape)]
        with file_reader(self.output_path) as f:
            f.require_dataset(self.output_key, shape=out_shape,
                              chunks=block_shape,
                              dtype=str(f_dtype(self.input_path,
                                                self.input_key)))
        block_list = self.blocks_in_volume(out_shape, block_shape)
        extra = {} if self.sampler is None else {"sampler": self.sampler}
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "scale_factor": self.scale_factor,
            "shape": out_shape, "block_shape": block_shape,
            "in_shape": in_shape, "device": self.device, **extra,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from ..core.device import resolve_device

        cfg = job_config["config"]
        device = str(resolve_device(cfg["device"]))
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        factor = cfg["scale_factor"]
        ds_in = file_reader(cfg["input_path"], "r")[cfg["input_key"]]
        ds_out = file_reader(cfg["output_path"])[cfg["output_key"]]
        sampler = cfg.get("sampler", "mean")

        for block_id in job_config["block_list"]:
            block = blocking.get_block(block_id)
            in_bb = tuple(slice(b.start * f, min(b.stop * f, s))
                          for b, f, s in zip(block.bb, factor,
                                             cfg["in_shape"]))
            x = np.asarray(ds_in[in_bb])
            if not x.any():
                log_fn(f"processed block {block_id}")
                continue
            y = downsample(x, factor, sampler, device=device)
            ds_out[block.bb] = y[tuple(slice(0, b.stop - b.start)
                                       for b in block.bb)]
            log_fn(f"processed block {block_id}")


def f_dtype(path: str, key: str):
    with file_reader(path, "r") as f:
        return f[key].dtype


class WriteDownscalingMetadata(Task):
    """Multiscale metadata: per-level downsamplingFactors + group attrs
    (reference: downscaling_workflow.py:33-215).

    ``metadata_format``: ``'paintera'`` (default — multiScale group attrs,
    XYZ axis order) or ``'bdv'`` (bdv.n5 setup-level attrs + a BigDataViewer
    SpimData XML sidecar next to the container, reference:
    downscaling_workflow.py:97-202 ``_write_bdv_xml``).  For ``'bdv'`` the
    pyramid must use the bdv.n5 layout ``setup{i}/timepoint{t}/s{L}`` —
    i.e. pass ``output_key_prefix='setup0/timepoint0'`` — so
    BigDataViewer's n5 backend can resolve the scale datasets; the required
    ``downsamplingFactors``/``dataType`` attributes are written on the
    setup group."""

    def __init__(self, tmp_folder: str, output_path: str, scale_factors,
                 output_key_prefix: str = "", metadata_dict=None,
                 scale_offset: int = 0, metadata_format: str = "paintera",
                 identifier: str = "", dependency: Optional[Task] = None):
        assert metadata_format in ("paintera", "bdv"), metadata_format
        self.identifier = identifier
        # the bdv factor list and XML size are absolute (relative to s0);
        # with an offset the factors below it are unknown to this task
        if metadata_format == "bdv" and scale_offset != 0:
            raise ValueError("metadata_format='bdv' requires scale_offset=0")
        self.tmp_folder = tmp_folder
        self.output_path = output_path
        self.scale_factors = [_factor3(s) for s in scale_factors]
        self.output_key_prefix = output_key_prefix
        self.metadata_dict = dict(metadata_dict or {})
        self.scale_offset = scale_offset
        self.metadata_format = metadata_format
        self.dependency = dependency
        super().__init__()

    def requires(self):
        return self.dependency

    def _write_bdv_xml(self, shape) -> None:
        """SpimData XML sidecar: sizes, voxel resolution and the affine
        placing the volume in world space (one channel / one timepoint, like
        the reference)."""
        import xml.etree.ElementTree as ET

        nz, ny, nx = [int(s) for s in shape]
        dz, dy, dx = [float(r) for r in
                      self.metadata_dict.get("resolution", [1.0] * 3)]
        oz, oy, ox = [float(o) for o in
                      self.metadata_dict.get("offsets", [0.0] * 3)]
        unit = self.metadata_dict.get("unit", "micrometer")

        root = ET.Element("SpimData", version="0.2")
        ET.SubElement(root, "BasePath", type="relative").text = "."
        seq = ET.SubElement(root, "SequenceDescription")
        loader = ET.SubElement(seq, "ImageLoader", format="bdv.n5")
        ET.SubElement(loader, "n5", type="relative").text = \
            os.path.basename(self.output_path)
        views = ET.SubElement(seq, "ViewSetups")
        setup = ET.SubElement(views, "ViewSetup")
        ET.SubElement(setup, "id").text = "0"
        ET.SubElement(setup, "name").text = "channel 1"
        ET.SubElement(setup, "size").text = f"{nx} {ny} {nz}"
        vox = ET.SubElement(setup, "voxelSize")
        ET.SubElement(vox, "unit").text = unit
        ET.SubElement(vox, "size").text = f"{dx} {dy} {dz}"
        tp = ET.SubElement(seq, "Timepoints", type="range")
        ET.SubElement(tp, "first").text = "0"
        ET.SubElement(tp, "last").text = "0"
        regs = ET.SubElement(root, "ViewRegistrations")
        reg = ET.SubElement(regs, "ViewRegistration", timepoint="0",
                            setup="0")
        vt = ET.SubElement(reg, "ViewTransform", type="affine")
        ET.SubElement(vt, "affine").text = (
            f"{dx} 0.0 0.0 {ox} 0.0 {dy} 0.0 {oy} 0.0 0.0 {dz} {oz}")
        xml_path = os.path.splitext(self.output_path.rstrip("/"))[0] + ".xml"
        ET.ElementTree(root).write(xml_path)

    def run(self):
        effective = [1, 1, 1]
        all_factors = [[1, 1, 1]]  # XYZ, s0 included (bdv.n5 convention)
        with file_reader(self.output_path) as f:
            for scale, factor in enumerate(self.scale_factors):
                key = os.path.join(self.output_key_prefix,
                                   f"s{scale + self.scale_offset + 1}")
                effective = [e * s for e, s in zip(effective, factor)]
                # paintera/bdv axis order is XYZ; ours is ZYX -> reverse
                f[key].attrs["downsamplingFactors"] = effective[::-1]
                all_factors.append(effective[::-1])
            level0 = os.path.join(self.output_key_prefix,
                                  f"s{self.scale_offset}")
            max_id = f[level0].attrs.get("maxId")
            if self.metadata_format == "paintera":
                group = (f.require_group(self.output_key_prefix)
                         if self.output_key_prefix else f)
                group.attrs["multiScale"] = True
                group.attrs["resolution"] = list(
                    self.metadata_dict.get("resolution", [1.0] * 3))[::-1]
                group.attrs["offset"] = list(
                    self.metadata_dict.get("offsets", [0.0] * 3))[::-1]
                if max_id is not None:
                    group.attrs["maxId"] = int(max_id)
            else:  # bdv.n5: setup-level attrs + SpimData XML sidecar
                # the pyramid lives at setup{i}/timepoint{t}/s{L}; the
                # attrs BigDataViewer's n5 backend requires go on the
                # *setup* group (parent of the timepoint group)
                setup_key = os.path.dirname(self.output_key_prefix)
                setup = (f.require_group(setup_key) if setup_key else
                         (f.require_group(self.output_key_prefix)
                          if self.output_key_prefix else f))
                setup.attrs["downsamplingFactors"] = all_factors
                setup.attrs["dataType"] = str(f[level0].dtype)
                if max_id is not None:
                    setup.attrs["maxId"] = int(max_id)
                shape = f[level0].shape
        if self.metadata_format == "bdv":
            self._write_bdv_xml(shape)
        self.output().touch()

    def output(self):
        suffix = f"_{self.identifier}" if self.identifier else ""
        return FileTarget(os.path.join(
            self.tmp_folder, f"downscaling_metadata{suffix}.status"))


class DownscalingWorkflow(Task):
    """Chain of DownscaleTasks (s1..sN from s0) + metadata (reference:
    DownscalingWorkflow, downscaling_workflow.py:218-349; existing scale
    datasets are skipped by the tasks' status targets)."""

    def __init__(self, input_path: str, input_key: str,
                 scale_factors: Sequence[ScaleFactor], tmp_folder: str,
                 config_dir: str, max_jobs: int = 1, target: str = "gpu",
                 output_key_prefix: str = "", metadata_dict=None,
                 metadata_format: str = "paintera",
                 dependency: Optional[Task] = None):
        self.input_path = input_path
        self.input_key = input_key
        self.scale_factors = list(scale_factors)
        self.output_key_prefix = output_key_prefix
        self.metadata_dict = metadata_dict or {}
        self.metadata_format = metadata_format
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def _scale_key(self, scale: int) -> str:
        if scale == 0:
            return self.input_key
        return os.path.join(self.output_key_prefix, f"s{scale}")

    def requires(self):
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                      max_jobs=self.max_jobs, target=self.target)
        dep = self.dependency
        for scale, factor in enumerate(self.scale_factors):
            dep = DownscaleTask(
                input_path=self.input_path,
                input_key=self._scale_key(scale),
                output_path=self.input_path,
                output_key=self._scale_key(scale + 1),
                scale_factor=factor, identifier=f"s{scale + 1}",
                dependency=dep, **common)
        return WriteDownscalingMetadata(
            tmp_folder=self.tmp_folder, output_path=self.input_path,
            scale_factors=self.scale_factors,
            output_key_prefix=self.output_key_prefix,
            metadata_dict=self.metadata_dict,
            metadata_format=self.metadata_format, dependency=dep)

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder,
                                       "downscaling_metadata.status"))
