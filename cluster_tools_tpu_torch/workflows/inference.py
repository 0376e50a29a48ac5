"""Blockwise neural-network inference (BASELINE config 5).

Port of cluster_tools_tpu/workflows/inference.py (reference:
inference/inference.py — halo + reflect-pad loads :202-232, the
load->preprocess->predict->write pipeline overlapping IO and the device
:244-343, multi-dataset channel mapping :87-104, uint8 requantization
:235-241, mask-skip :268-276):

* the default model is the first-party 3D U-Net (models/unet.py) loaded
  from a checkpoint in the JAX package's format (models/checkpoint.py);
  externally trained torch modules are loadable through the framework
  registry (config ``framework='pytorch'``, models/frameworks.py);
* input normalization (zero-mean/unit-variance) and the reflect-padding up
  to the U-Net's divisibility constraint run on the task's device (the
  global config's ``"device"``, default ``"cuda"``): the host hands the raw
  outer block over and gets the cropped prediction back;
* a prefetch pool reads upcoming blocks, the main thread streams them
  through the device, a writer pool commits the outputs.

``predict_sharded`` runs a batch of outer blocks split over the devices of
a mesh (one model per distinct device).
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core.blocking import Blocking
from ..core.device import task_device
from ..core.runtime import BlockTask
from ..core.storage import file_reader


def load_with_halo(ds, offset: Sequence[int], block_shape: Sequence[int],
                   halo: Sequence[int], padding_mode: str = "reflect",
                   channel_slice: Optional[slice] = None) -> np.ndarray:
    """Read ``[offset-halo, offset+block_shape+halo)`` with out-of-volume
    parts padded by ``np.pad(mode=padding_mode)`` (reference:
    inference/inference.py:202-232 ``_load_input``).  Always returns the
    full outer shape, so every block reaches the device at one shape."""
    shape = ds.shape[-len(offset):]
    starts = [off - ha for off, ha in zip(offset, halo)]
    stops = [off + bs + ha for off, bs, ha in zip(offset, block_shape, halo)]
    pad_left = tuple(max(0, -s) for s in starts)
    pad_right = tuple(max(0, stop - sh) for stop, sh in zip(stops, shape))
    bb = tuple(slice(max(0, s), min(sh, stop))
               for s, stop, sh in zip(starts, stops, shape))
    if channel_slice is not None:
        bb = (channel_slice,) + bb
        pad_left = (0,) + pad_left
        pad_right = (0,) + pad_right
    data = ds[bb]
    if any(pad_left) or any(pad_right):
        data = np.pad(data, tuple(zip(pad_left, pad_right)), mode=padding_mode)
    return data


def to_uint8(data: np.ndarray, float_range=(0.0, 1.0),
             safe_scale: bool = True) -> np.ndarray:
    """Requantize float predictions to uint8 (reference:
    inference/inference.py:235-241 ``_to_uint8``)."""
    if safe_scale:
        mult = np.floor(255.0 / (float_range[1] - float_range[0]))
    else:
        mult = np.ceil(255.0 / (float_range[1] - float_range[0]))
    add = 255 - mult * float_range[1]
    return np.clip((data * mult + add).round(), 0, 255).astype("uint8")


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _checkpoint_mtime(path: str):
    """Content signature of a checkpoint directory (or file): newest mtime
    plus total byte size.  mtime alone has ~1 s resolution on many
    filesystems — an in-place retrain rewriting params.npz within the same
    timestamp tick would serve stale weights from the model cache."""
    def _stat(p):
        st = os.stat(p)
        return st.st_mtime, st.st_size

    try:
        if os.path.isdir(path):
            stats = [_stat(os.path.join(path, f)) for f in os.listdir(path)]
            if not stats:
                return (0.0, 0)
            return (max(s[0] for s in stats), sum(s[1] for s in stats))
        return _stat(path)
    except OSError:
        return (0.0, 0)


@lru_cache(maxsize=4)
def _load_model(checkpoint_path: str, signature,
                device: str) -> torch.nn.Module:
    """The checkpoint's (bfloat16) U-Net on ``device``, shared by the jobs
    of a task (read-only, under ``no_grad``); keyed on the checkpoint's
    content signature so an in-place retrain is picked up."""
    from ..models.checkpoint import load_checkpoint

    model, _ = load_checkpoint(checkpoint_path)
    return model.to(device)


def make_predictor(checkpoint_path: str, outer_shape: Sequence[int],
                   halo: Sequence[int], preprocess: str = "standardize",
                   device: str = "cuda"):
    """Build the block predictor on ``device``.

    Accepts ``(*outer_shape)`` single-channel or ``(C, *outer_shape)``
    multi-channel raw blocks; returns ``(C_out, *inner_shape)`` float32.
    On the device: standardize (population std) or normalize -> reflect-pad
    to the U-Net divisor (high side only) -> forward -> crop the halo.
    """
    dev = torch.device(device)
    model = _load_model(checkpoint_path, _checkpoint_mtime(checkpoint_path),
                        str(dev))
    div = model.min_divisor()
    padded = tuple(_round_up(s, d) for s, d in zip(outer_shape, div))
    # F.pad lists (low, high) pairs from the last axis backwards
    pad = tuple(v for p, s in reversed(list(zip(padded, outer_shape)))
                for v in (0, p - s))
    crop = tuple(slice(h, s - h) for s, h in zip(outer_shape, halo))

    def predict(block: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(block)).to(dev)
        x = x.to(torch.float32)
        if x.ndim == len(outer_shape):
            x = x[None]
        with torch.no_grad():
            spatial = (1, 2, 3)
            if preprocess == "standardize":
                # zero-mean/unit-variance per channel (reference
                # preprocessor, inference/frameworks.py:137-161)
                mean = x.mean(dim=spatial, keepdim=True)
                std = x.std(dim=spatial, keepdim=True,
                            correction=0).clamp_min(1e-6)
                x = (x - mean) / std
            elif preprocess == "normalize":
                lo = x.amin(dim=spatial, keepdim=True)
                hi = x.amax(dim=spatial, keepdim=True)
                x = (x - lo) / (hi - lo).clamp_min(1e-6)
            if any(pad):
                x = F.pad(x[None], pad, mode="reflect")[0]
            # the halo crop lies inside the outer block: it drops the pad
            pred = model(x[None])[0]
            return pred[(slice(None),) + crop].cpu().numpy()

    return predict


class InferenceTask(BlockTask):
    """Blockwise model prediction (reference: InferenceBase,
    inference/inference.py:25-137).

    ``output_key`` is a dict ``{dataset_key: [channel_begin, channel_end]}``
    (reference channel mapping, inference.py:87-104): each output dataset
    receives the given slice of prediction channels; single-channel outputs
    are written as plain 3D volumes.
    """

    task_name = "inference"

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: Dict[str, Sequence[int]], checkpoint_path: str,
                 halo: Sequence[int], mask_path: str = "", mask_key: str = "",
                 **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = dict(output_key)
        self.checkpoint_path = checkpoint_path
        self.halo = list(halo)
        self.mask_path = mask_path
        self.mask_key = mask_key
        super().__init__(**kw)
        self.device = task_device(self.global_config)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"dtype": "uint8", "preprocess": "standardize",
                     "framework": "self", "tta": "",
                     "channel_begin": 0, "channel_end": None})
        return conf

    def run_impl(self):
        with file_reader(self.input_path, "r") as f:
            in_shape = f[self.input_key].shape
        shape = list(in_shape[-3:])
        block_shape = self.global_block_shape()[-3:]
        dtype = self.task_config.get("dtype", "uint8")
        if dtype not in ("uint8", "float32"):
            raise ValueError(f"output dtype {dtype!r}: uint8 or float32")

        with file_reader(self.output_path) as f:
            for out_key, (c0, c1) in self.output_key.items():
                n_channels = c1 - c0
                if n_channels <= 0:
                    raise ValueError(f"empty channel range for {out_key!r}")
                if n_channels > 1:
                    f.require_dataset(out_key, shape=(n_channels, *shape),
                                      chunks=[1] + block_shape, dtype=dtype)
                else:
                    f.require_dataset(out_key, shape=shape,
                                      chunks=block_shape, dtype=dtype)

        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "output_path": self.output_path,
            "output_keys": list(self.output_key.keys()),
            "channel_mapping": [list(v) for v in self.output_key.values()],
            "checkpoint_path": self.checkpoint_path, "halo": self.halo,
            "mask_path": self.mask_path, "mask_key": self.mask_key,
            "shape": shape, "block_shape": block_shape,
            "device": self.device,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from ..core.device import resolve_device
        from ..core.runtime import stage
        from ..models.frameworks import get_predictor

        cfg = job_config["config"]
        device = str(resolve_device(cfg["device"]))
        shape, block_shape = cfg["shape"], cfg["block_shape"]
        halo = cfg["halo"]
        blocking = Blocking(shape, block_shape)
        f_in = file_reader(cfg["input_path"], "r")
        f_out = file_reader(cfg["output_path"])
        ds_in = f_in[cfg["input_key"]]
        ds_outs = [f_out[k] for k in cfg["output_keys"]]
        channel_mapping = cfg["channel_mapping"]
        dtype = np.dtype(cfg.get("dtype", "uint8"))

        mask = None
        if cfg.get("mask_path"):
            from ..core.volume_views import load_mask

            mask = load_mask(cfg["mask_path"], cfg["mask_key"], shape)

        outer_shape = tuple(bs + 2 * h for bs, h in zip(block_shape, halo))
        predict = get_predictor(cfg.get("framework", "self"),
                                cfg["checkpoint_path"], outer_shape, halo,
                                cfg.get("preprocess", "standardize"),
                                tta=cfg.get("tta", ""), device=device)
        n_threads = int(cfg.get("threads_per_job", 1)) or 1

        # channel selection for 4D (C, Z, Y, X) inputs
        channel_slice = None
        if len(ds_in.shape) == 4:
            c0 = int(cfg.get("channel_begin") or 0)
            c1 = cfg.get("channel_end")
            channel_slice = slice(c0, ds_in.shape[0] if c1 is None else int(c1))

        def _load(block_id: int):
            block = blocking.get_block(block_id)
            if mask is not None and not np.any(np.asarray(mask[block.bb])):
                return block_id, None, None
            with stage("store-read"):
                data = load_with_halo(ds_in, block.begin, block_shape, halo,
                                      channel_slice=channel_slice)
            return block_id, block, data

        def _write(block_id: int, block, pred: np.ndarray):
            # crop to the actual (volume-clipped) inner extent
            actual = [e - b for b, e in zip(block.begin, block.end)]
            pred = pred[(slice(None),) + tuple(slice(0, a) for a in actual)]
            if dtype == np.uint8:
                pred = to_uint8(pred)
            with stage("store-write"):
                for ds_out, (c0, c1) in zip(ds_outs, channel_mapping):
                    out = pred[c0:c1]
                    if c1 - c0 == 1:
                        ds_out[block.bb] = out[0].astype(dtype)
                    else:
                        ds_out[(slice(None),) + block.bb] = out.astype(dtype)
            return block_id

        block_list = list(job_config["block_list"])
        # prefetch reads and defer writes on thread pools; device compute
        # stays on this thread (the reference's dask threaded pipeline,
        # inference.py:336-343).  The look-ahead window is bounded, so host
        # memory stays constant regardless of job size.
        window = 2 * n_threads
        with ThreadPoolExecutor(n_threads) as read_pool, \
                ThreadPoolExecutor(n_threads) as write_pool:
            loads = deque(read_pool.submit(_load, b)
                          for b in block_list[:window])
            next_block = window
            writes = deque()
            while loads:
                block_id, block, data = loads.popleft().result()
                if next_block < len(block_list):
                    loads.append(read_pool.submit(_load,
                                                  block_list[next_block]))
                    next_block += 1
                if data is None:
                    log_fn(f"processed block {block_id}")
                    continue
                with stage("predict"):
                    pred = predict(data)
                writes.append((block_id,
                               write_pool.submit(_write, block_id, block, pred)))
                while len(writes) > window:
                    done_id, w = writes.popleft()
                    w.result()
                    log_fn(f"processed block {done_id}")
            for done_id, w in writes:
                w.result()
                log_fn(f"processed block {done_id}")


def predict_sharded(checkpoint_path: str, volume: np.ndarray,
                    n_devices: Optional[int] = None,
                    preprocess: str = "standardize",
                    devices: Optional[Sequence[torch.device]] = None
                    ) -> np.ndarray:
    """Multi-device batch forward: a batch of outer blocks split over the
    mesh's ``data`` axis, each data shard's sub-batch through one model on
    its device (blocks are independent — halos come from the store — so
    this is pure device parallelism, the reference's one-GPU-per-job
    mapping, inference/inference.py:370-375).  The batch is padded to a
    multiple of ``mesh.shape["data"]`` (the padding is never computed);
    each block runs through :func:`make_predictor` — per-block
    standardize / normalize, reflect padding to the U-Net divisor, one
    forward — so the results are the per-block predictor's.

    ``volume``: ``(N, D, H, W)`` stacked outer blocks; returns ``(N, C, D,
    H, W)`` float32 predictions.  ``devices``: the shard devices (default
    :func:`~..parallel.mesh.shard_devices`: every visible card)."""
    from ..parallel import mesh as mesh_lib

    devs = list(devices) if devices is not None else \
        mesh_lib.shard_devices()
    mesh = mesh_lib.make_mesh(n_devices or len(devs), devices=devs)
    n, *spatial = volume.shape
    dp = mesh.shape["data"]
    per = _round_up(max(n, dp), dp) // dp
    # the model/space positions of one data index hold the same sub-batch
    # (replicated): the first of them computes it
    per_data = mesh.size // dp
    outs = []
    for i in range(dp):
        predict = make_predictor(
            checkpoint_path, spatial, (0,) * len(spatial), preprocess,
            device=str(mesh.device_list[i * per_data]))
        outs += [predict(b) for b in volume[i * per:(i + 1) * per]]
    return np.stack(outs)
