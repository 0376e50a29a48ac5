"""ROI masking: block lists from masks, min-filtered masks.

Port of cluster_tools_tpu/workflows/masking.py (host numpy and scipy, as
in the JAX package), after the reference's ``masking/`` package
(blocks_from_mask.py:82-97 — list of blocks intersecting a low-res mask,
written to ``block_list_path`` for the global config; minfilter.py:110-121 —
minimum-filter a mask so only fully-valid regions survive)."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence

import numpy as np

from ..core.blocking import Blocking
from ..core.config import write_config
from ..core.runtime import BlockTask
from ..core.storage import file_reader
from ..core.workflow import FileTarget, Task


class BlocksFromMask(Task):
    """Write the list of mask-intersecting blocks to ``block_list_path``
    (feeds the global config's block-list restriction, SURVEY §5.6)."""

    def __init__(self, mask_path: str, mask_key: str, shape: Sequence[int],
                 block_shape: Sequence[int], output_path: str,
                 tmp_folder: str, dependency: Optional[Task] = None):
        self.mask_path = mask_path
        self.mask_key = mask_key
        self.shape = list(shape)
        self.block_shape = list(block_shape)
        self.output_path = output_path
        self.tmp_folder = tmp_folder
        self.dependency = dependency
        super().__init__()

    def requires(self):
        return self.dependency

    def run(self):
        from ..core.volume_views import load_mask

        mask = load_mask(self.mask_path, self.mask_key, self.shape)
        blocking = Blocking(self.shape, self.block_shape)
        blocks = [bid for bid in range(blocking.n_blocks)
                  if np.any(np.asarray(
                      mask[blocking.get_block(bid).bb]) > 0)]
        write_config(self.output_path, blocks)
        self.output().touch()

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder,
                                       "blocks_from_mask.status"))


class MinFilterMask(BlockTask):
    """Blockwise minimum filter over a mask (reference:
    minfilter.py:110-121): shrinks the valid region so every surviving
    voxel has a fully-valid filter window."""

    task_name = "minfilter_mask"

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str, filter_shape: Sequence[int], **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.filter_shape = list(filter_shape)
        super().__init__(**kw)

    def run_impl(self):
        with file_reader(self.input_path, "r") as f:
            shape = list(f[self.input_key].shape)
        block_shape = [min(b, s) for b, s in
                       zip(self.global_block_shape(), shape)]
        with file_reader(self.output_path) as f:
            f.require_dataset(self.output_key, shape=shape,
                              chunks=block_shape, dtype="uint8")
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "filter_shape": self.filter_shape,
            "shape": shape, "block_shape": block_shape,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from scipy.ndimage import minimum_filter

        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        halo = [fs // 2 + 1 for fs in cfg["filter_shape"]]
        f_in = file_reader(cfg["input_path"], "r")
        f_out = file_reader(cfg["output_path"])
        ds_in, ds_out = f_in[cfg["input_key"]], f_out[cfg["output_key"]]
        for block_id in job_config["block_list"]:
            bh = blocking.get_block_with_halo(block_id, halo)
            mask = np.asarray(ds_in[bh.outer.bb])
            filtered = minimum_filter(mask, size=cfg["filter_shape"])
            ds_out[bh.inner.bb] = filtered[bh.inner_local.bb].astype("uint8")
            log_fn(f"processed block {block_id}")
