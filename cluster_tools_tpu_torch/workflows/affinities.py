"""Derived pixel maps: affinities from labels, object insertion, embedding
distances, smoothed gradients.

Port of cluster_tools_tpu/workflows/affinities.py (reference ``affinities/``
package: insert_affinities.py:159-213 — paste object-derived affinities
into a predicted affinity map; embedding_distances.py:139-165 — affinities
from pixel embeddings; gradients.py:131-176 — smoothed gradient maps).  The
affinities are a shifted equality over the offset channels on the device
(exact); the EDT with nearest indices that grows objects into their
dilation ring stays scipy on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np

from ..core.blocking import Blocking
from ..core.device import task_device
from ..core.runtime import BlockTask
from ..core.storage import file_reader


def _shifted(x, offset, first_axis: int = 0):
    """``x`` shifted so that position i holds x[i + offset] (a roll, as
    ``jnp.roll(x, -o)`` per axis), from axis ``first_axis`` on."""
    import torch

    dims = tuple(range(first_axis, first_axis + len(offset)))
    return torch.roll(x, shifts=tuple(-int(o) for o in offset), dims=dims)


def compute_affinities(labels: np.ndarray, offsets: Sequence[Sequence[int]],
                       device: str = "cuda") -> np.ndarray:
    """(C, *shape) float32 affinities: channel c is 1 where voxel i and
    voxel i + offsets[c] carry the same nonzero label (affogato
    compute_affinities equivalent)."""
    import torch

    from ..ops.rag import densify_labels

    _, dense = densify_labels(np.asarray(labels))
    x = torch.from_numpy(dense).to(device)
    out = []
    for off in offsets:
        valid = torch.ones_like(x, dtype=torch.bool)
        for ax, o in enumerate(off):
            idx = torch.arange(x.shape[ax], device=x.device) + int(o)
            ok = (idx >= 0) & (idx < x.shape[ax])
            shape = [1] * x.dim()
            shape[ax] = -1
            valid = valid & ok.reshape(shape)
        out.append((x == _shifted(x, off)) & (x > 0) & valid)
    return torch.stack(out).to(torch.float32).cpu().numpy()


def embedding_distance_affinities(embeddings: np.ndarray,
                                  offsets: Sequence[Sequence[int]],
                                  norm: str = "l2",
                                  device: str = "cuda") -> np.ndarray:
    """(C, *shape) affinities from pixel embeddings (E, *shape): channel c =
    exp(-d(e_i, e_{i+off})) with the ``l2`` or ``cosine`` distance
    (reference: embedding_distances.py:139-165); the shift wraps around
    the volume, as the JAX package's roll does."""
    import torch

    if norm not in ("l2", "cosine"):
        raise ValueError(f"unknown norm {norm}")
    e = torch.from_numpy(np.ascontiguousarray(
        embeddings, dtype="float32")).to(device)
    out = []
    for off in offsets:
        shifted = _shifted(e, off, first_axis=1)
        if norm == "l2":
            d = torch.sqrt(((e - shifted) ** 2).sum(dim=0))
        else:
            num = (e * shifted).sum(dim=0)
            den = torch.clamp(torch.linalg.vector_norm(e, dim=0)
                              * torch.linalg.vector_norm(shifted, dim=0),
                              min=1e-6)
            d = 1.0 - num / den
        out.append(torch.exp(-d))
    return torch.stack(out).cpu().numpy()


class InsertAffinities(BlockTask):
    """Paste object-derived affinities into a predicted affinity map
    (reference: insert_affinities.py:159-213): where dilated objects exist,
    affinities become the max of prediction and object affinity."""

    task_name = "insert_affinities"

    def __init__(self, input_path: str, input_key: str, objects_path: str,
                 objects_key: str, output_path: str, output_key: str,
                 offsets: Sequence[Sequence[int]], **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.objects_path = objects_path
        self.objects_key = objects_key
        self.output_path = output_path
        self.output_key = output_key
        self.offsets = [list(o) for o in offsets]
        super().__init__(**kw)
        self.device = task_device(self.global_config)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"dilate_by": 2})
        return conf

    def run_impl(self):
        with file_reader(self.input_path, "r") as f:
            in_shape = list(f[self.input_key].shape)
        if len(in_shape) != 4:
            raise ValueError(f"affinities need a 4-d (channel) store, got "
                             f"shape {in_shape}")
        shape = in_shape[1:]
        block_shape = self.global_block_shape()[-3:]
        with file_reader(self.output_path) as f:
            f.require_dataset(self.output_key, shape=in_shape,
                              chunks=[1] + block_shape, dtype="float32")
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "objects_path": self.objects_path,
            "objects_key": self.objects_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "offsets": self.offsets,
            "shape": shape, "block_shape": block_shape,
            "device": self.device,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from scipy.ndimage import binary_dilation, distance_transform_edt

        from ..core.device import resolve_device

        cfg = job_config["config"]
        device = str(resolve_device(cfg["device"]))
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        offsets = cfg["offsets"]
        halo = np.abs(np.asarray(offsets)).max(axis=0).tolist()
        dilate_by = int(cfg.get("dilate_by", 2))
        halo = [h + dilate_by for h in halo]
        ds_in = file_reader(cfg["input_path"], "r")[cfg["input_key"]]
        ds_obj = file_reader(cfg["objects_path"], "r")[cfg["objects_key"]]
        ds_out = file_reader(cfg["output_path"])[cfg["output_key"]]

        for block_id in job_config["block_list"]:
            bh = blocking.get_block_with_halo(block_id, halo)
            inner = (slice(None),) + bh.inner.bb
            local = (slice(None),) + bh.inner_local.bb
            objs = np.asarray(ds_obj[bh.outer.bb])
            if not objs.any():
                ds_out[inner] = np.asarray(ds_in[inner])
                log_fn(f"processed block {block_id}")
                continue
            affs = np.asarray(
                ds_in[(slice(None),) + bh.outer.bb]).astype("float32")
            if dilate_by > 0:
                # the dilation ring takes the id of the nearest object
                # voxel
                grown = binary_dilation(objs > 0, iterations=dilate_by)
                _, idx = distance_transform_edt(objs == 0,
                                                return_indices=True)
                objs = np.where(grown, objs[tuple(idx)], objs)
            obj_affs = compute_affinities(objs, offsets, device=device)
            affs = np.maximum(affs, obj_affs)
            ds_out[inner] = affs[local]
            log_fn(f"processed block {block_id}")


class SmoothedGradients(BlockTask):
    """Gaussian gradient-magnitude map (reference: gradients.py:131-176),
    on the device (ops/filters)."""

    task_name = "smoothed_gradients"

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str, sigma: float = 2.0, **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.sigma = sigma
        super().__init__(**kw)
        self.device = task_device(self.global_config)

    def run_impl(self):
        with file_reader(self.input_path, "r") as f:
            shape = list(f[self.input_key].shape)
        block_shape = self.global_block_shape()[-len(shape):]
        with file_reader(self.output_path) as f:
            f.require_dataset(self.output_key, shape=shape,
                              chunks=block_shape, dtype="float32")
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "sigma": self.sigma,
            "shape": shape, "block_shape": block_shape,
            "device": self.device,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        import torch

        from ..core.device import resolve_device
        from ..ops.filters import gaussian_gradient_magnitude

        cfg = job_config["config"]
        device = resolve_device(cfg["device"])
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        sigma = cfg["sigma"]
        halo = [int(4 * sigma + 1)] * blocking.ndim
        ds_in = file_reader(cfg["input_path"], "r")[cfg["input_key"]]
        ds_out = file_reader(cfg["output_path"])[cfg["output_key"]]
        for block_id in job_config["block_list"]:
            bh = blocking.get_block_with_halo(block_id, halo)
            x = np.asarray(ds_in[bh.outer.bb]).astype("float32")
            g = gaussian_gradient_magnitude(torch.from_numpy(x).to(device),
                                            sigma)
            ds_out[bh.inner.bb] = g[bh.inner_local.bb].cpu().numpy()
            log_fn(f"processed block {block_id}")
