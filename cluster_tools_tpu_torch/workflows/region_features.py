"""Per-segment (node) statistics of an input map.

Port of cluster_tools_tpu/workflows/region_features.py (host numpy, as in
the JAX package), after the reference's region features
(features/region_features.py:30 — vigra extractRegionFeatures with
['mean', 'count'] per block, serialized as (id, count, mean) triples;
features/merge_region_features.py:20 — count-weighted moving-average merge
sharded over the node-id space).

The per-block accumulation is plain bincount arithmetic (memory-bound
gather/scatter over a few MB — host numpy sits right next to the IO and a
device round-trip buys nothing); the merge shards the 1-D node-id space,
the reference's "label-space sharding" strategy (SURVEY §2.4.5).

Outputs: ``output_key`` -> (n_labels,) float32 mean per node,
``output_key + '_counts'`` -> (n_labels,) float32 voxel counts.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from ..core.blocking import Blocking
from ..core.runtime import BlockTask
from ..core.storage import file_reader
from ..core.workflow import FileTarget, Task

_BLOCK_DIR = "region_features_blocks"


def _block_path(output_path: str, prefix: str, block_id: int) -> str:
    return os.path.join(output_path, _BLOCK_DIR,
                        f"{prefix}block_{block_id}.npz")


class RegionFeatures(BlockTask):
    """Per-block (ids, counts, mean) accumulation (reference:
    region_features.py:122-167 ``_block_features``)."""

    task_name = "region_features"

    def __init__(self, input_path: str, input_key: str, labels_path: str,
                 labels_key: str, output_path: str,
                 ignore_label: Optional[int] = 0, prefix: str = "", **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.labels_path = labels_path
        self.labels_key = labels_key
        self.output_path = output_path
        self.ignore_label = ignore_label
        self.prefix = prefix
        self.identifier = prefix
        super().__init__(**kw)

    def run_impl(self):
        with file_reader(self.labels_path, "r") as f:
            shape = list(f[self.labels_key].shape)
        block_shape = self.global_block_shape()[-len(shape):]
        os.makedirs(os.path.join(self.output_path, _BLOCK_DIR), exist_ok=True)
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "labels_path": self.labels_path, "labels_key": self.labels_key,
            "output_path": self.output_path,
            "ignore_label": self.ignore_label, "prefix": self.prefix,
            "shape": shape, "block_shape": block_shape,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        ds_in = file_reader(cfg["input_path"], "r")[cfg["input_key"]]
        ds_lab = file_reader(cfg["labels_path"], "r")[cfg["labels_key"]]
        ignore_label = cfg.get("ignore_label")
        # integer inputs are quantized: scale by the dtype range
        scale = (float(np.iinfo(ds_in.dtype).max)
                 if np.issubdtype(ds_in.dtype, np.integer) else 1.0)

        for block_id in job_config["block_list"]:
            bb = blocking.get_block(block_id).bb
            labels = np.asarray(ds_lab[bb]).ravel()
            data = np.asarray(ds_in[bb]).ravel().astype("float64") / scale
            if ignore_label is not None:
                keep = labels != ignore_label
                labels, data = labels[keep], data[keep]
            if len(labels) == 0:
                np.savez(_block_path(cfg["output_path"], cfg["prefix"],
                                     block_id),
                         ids=np.zeros(0, "uint64"),
                         counts=np.zeros(0, "float64"),
                         mean=np.zeros(0, "float64"))
                log_fn(f"processed block {block_id}")
                continue
            ids, inv = np.unique(labels, return_inverse=True)
            counts = np.bincount(inv, minlength=len(ids)).astype("float64")
            sums = np.bincount(inv, weights=data, minlength=len(ids))
            np.savez(_block_path(cfg["output_path"], cfg["prefix"],
                                 block_id),
                     ids=ids.astype("uint64"), counts=counts,
                     mean=sums / counts)
            log_fn(f"processed block {block_id}")


class MergeRegionFeatures(BlockTask):
    """Count-weighted merge, sharded over node-id ranges (reference:
    merge_region_features.py:90-130)."""

    task_name = "merge_region_features"

    def __init__(self, output_path: str, output_key: str,
                 n_labels: Optional[int] = None, labels_path: str = "",
                 labels_key: str = "", prefix: str = "", **kw):
        self.output_path = output_path
        self.output_key = output_key
        self.n_labels = n_labels
        self.labels_path = labels_path
        self.labels_key = labels_key
        self.prefix = prefix
        self.identifier = prefix
        super().__init__(**kw)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"id_chunk_size": int(1e6)})
        return conf

    def run_impl(self):
        self.resolve_n_labels()
        chunk = int(self.task_config.get("id_chunk_size", 1e6))
        n = max(self.n_labels, 1)
        with file_reader(self.output_path) as f:
            f.require_dataset(self.output_key, shape=(n,),
                              chunks=(min(chunk, n),), dtype="float32")
            f.require_dataset(self.output_key + "_counts", shape=(n,),
                              chunks=(min(chunk, n),), dtype="float32")
        self.run_jobs(self.id_chunks(self.n_labels, chunk), {
            "output_path": self.output_path, "output_key": self.output_key,
            "n_labels": self.n_labels, "id_chunk_size": chunk,
            "prefix": self.prefix,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        chunk = cfg["id_chunk_size"]
        n_labels = cfg["n_labels"]
        block_dir = os.path.join(cfg["output_path"], _BLOCK_DIR)
        prefix = cfg["prefix"] + "block_"
        # read each per-block file once per job and accumulate into every
        # owned range at once (not once per range: O(blocks x ranges))
        ranges = [(bid * chunk, min((bid + 1) * chunk, n_labels))
                  for bid in job_config["block_list"]]
        sums = {bid: np.zeros(hi - lo) for bid, (lo, hi)
                in zip(job_config["block_list"], ranges)}
        counts = {bid: np.zeros(hi - lo) for bid, (lo, hi)
                  in zip(job_config["block_list"], ranges)}
        for name in sorted(os.listdir(block_dir)):
            if not (name.startswith(prefix) and name.endswith(".npz")):
                continue
            with np.load(os.path.join(block_dir, name)) as d:
                ids, cnt, mean = d["ids"], d["counts"], d["mean"]
            for bid, (lo, hi) in zip(job_config["block_list"], ranges):
                m = (ids >= lo) & (ids < hi)
                if not m.any():
                    continue
                local = (ids[m] - lo).astype("int64")
                np.add.at(sums[bid], local, mean[m] * cnt[m])
                np.add.at(counts[bid], local, cnt[m])

        f_out = file_reader(cfg["output_path"])
        ds_mean = f_out[cfg["output_key"]]
        ds_counts = f_out[cfg["output_key"] + "_counts"]
        for bid, (lo, hi) in zip(job_config["block_list"], ranges):
            c = counts[bid]
            ds_mean[lo:hi] = np.where(c > 0, sums[bid] / np.maximum(c, 1),
                                      0).astype("float32")
            ds_counts[lo:hi] = c.astype("float32")
            log_fn(f"processed block {bid}")


class RegionFeaturesWorkflow(Task):
    """RegionFeatures -> MergeRegionFeatures (reference:
    features/region_features workflow wiring in
    postprocess_workflow.py:210-218)."""

    def __init__(self, input_path: str, input_key: str, labels_path: str,
                 labels_key: str, output_path: str, output_key: str,
                 tmp_folder: str, config_dir: str, max_jobs: int = 1,
                 target: str = "gpu", n_labels: Optional[int] = None,
                 prefix: str = "", dependency: Optional[Task] = None):
        self.input_path = input_path
        self.input_key = input_key
        self.labels_path = labels_path
        self.labels_key = labels_key
        self.output_path = output_path
        self.output_key = output_key
        self.n_labels = n_labels
        self.prefix = prefix
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def requires(self):
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                      max_jobs=self.max_jobs, target=self.target)
        feats = RegionFeatures(
            input_path=self.input_path, input_key=self.input_key,
            labels_path=self.labels_path, labels_key=self.labels_key,
            output_path=self.output_path, prefix=self.prefix,
            dependency=self.dependency, **common)
        return MergeRegionFeatures(
            output_path=self.output_path, output_key=self.output_key,
            n_labels=self.n_labels, labels_path=self.labels_path,
            labels_key=self.labels_key, prefix=self.prefix, dependency=feats,
            **common)

    def output(self):
        name = "merge_region_features" + (f"_{self.prefix}" if self.prefix
                                          else "")
        return FileTarget(os.path.join(self.tmp_folder, f"{name}.status"))
