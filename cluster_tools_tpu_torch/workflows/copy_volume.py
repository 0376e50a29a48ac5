"""Blockwise volume copy / format conversion.

Port of cluster_tools_tpu/workflows/copy_volume.py (reference
``copy_volume/`` package, copy_volume.py:23-211): copy between containers,
dtype casting with range scaling, channel reduction and chunk re-layout, on
the host (numpy), as in the JAX package.  ``PainteraToBdvWorkflow`` copies
each scale level with it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

from ..core.blocking import Blocking
from ..core.runtime import BlockTask
from ..core.storage import file_reader


def _cast(data: np.ndarray, dtype: np.dtype) -> np.ndarray:
    in_dt, out_dt = data.dtype, np.dtype(dtype)
    if in_dt == out_dt:
        return data
    if np.issubdtype(in_dt, np.integer) and np.issubdtype(out_dt, np.integer):
        in_max = float(np.iinfo(in_dt).max)
        out_max = float(np.iinfo(out_dt).max)
        if in_max > out_max:  # requantize down (e.g. uint16 -> uint8)
            return np.round(data.astype("float64") * out_max / in_max
                            ).astype(out_dt)
        return data.astype(out_dt)
    if np.issubdtype(in_dt, np.floating) and np.issubdtype(out_dt, np.integer):
        out_max = float(np.iinfo(out_dt).max)
        return np.clip(np.round(data * out_max), 0, out_max).astype(out_dt)
    return data.astype(out_dt)


class CopyVolumeTask(BlockTask):
    """Blockwise copy with optional dtype cast, channel reduce and chunk
    re-layout (reference: CopyVolumeBase, copy_volume.py:23-120)."""

    task_name = "copy_volume"

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str, dtype: Optional[str] = None,
                 chunks: Optional[Sequence[int]] = None,
                 reduce_channels: str = "", identifier: str = "", **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.dtype = dtype
        self.chunks = list(chunks) if chunks else None
        self.reduce_channels = reduce_channels
        self.identifier = identifier
        super().__init__(**kw)

    def run_impl(self):
        with file_reader(self.input_path, "r") as f:
            ds = f[self.input_key]
            in_shape = list(ds.shape)
            dtype = self.dtype or str(ds.dtype)
        shape = in_shape[1:] if (len(in_shape) == 4 and
                                 self.reduce_channels) else in_shape
        block_shape = self.global_block_shape()[-len(shape):]
        block_shape = [min(b, s) for b, s in zip(block_shape, shape)]
        chunks = self.chunks or block_shape
        with file_reader(self.output_path) as f:
            f.require_dataset(self.output_key, shape=shape, chunks=chunks,
                              dtype=dtype)
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "dtype": dtype, "reduce_channels": self.reduce_channels,
            "shape": shape, "block_shape": block_shape,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        ds_in = file_reader(cfg["input_path"], "r")[cfg["input_key"]]
        ds_out = file_reader(cfg["output_path"])[cfg["output_key"]]
        reduce_channels = cfg.get("reduce_channels", "")
        dtype = np.dtype(cfg["dtype"])

        for block_id in job_config["block_list"]:
            bb = blocking.get_block(block_id).bb
            if reduce_channels and ds_in.ndim == len(bb) + 1:
                data = np.asarray(ds_in[(slice(None),) + bb])
                data = (data.max(axis=0) if reduce_channels == "max"
                        else data.mean(axis=0))
            else:
                data = np.asarray(ds_in[bb])
            ds_out[bb] = _cast(data, dtype)
            log_fn(f"processed block {block_id}")
