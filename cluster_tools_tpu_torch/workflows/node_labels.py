"""Node-label overlaps: map fragment ids to overlapping labels of a second
volume (groundtruth, semantic maps, ...).

Port of cluster_tools_tpu/workflows/node_labels.py (the reference's
``node_labels/`` package: block_node_labels.py:125-158 per-block
``computeAndSerializeLabelOverlaps``, merge_node_labels.py:117-153
label-range-sharded ``mergeAndSerializeOverlaps``):

* per-block overlap counting runs **on the task's device** (the global
  config's ``"device"``, default ``"cuda"``; ops/overlaps.py: packed pair
  keys counted by ``torch.unique``) instead of in C++;
* per-block results are written **pre-sharded by node-id range**: block b
  writes ``overlaps/shard_<s>/block_<b>.npy`` only for shards its fragment
  ids touch.  The merge job for shard s then reads exactly the files under
  its own shard directory — total merge IO is O(n_blocks), not
  O(n_blocks x n_jobs) (the scaling trap VERDICT flagged for the edge-feature
  merge).

Layout per file: (n, 3) uint64 rows of (node_id, label_id, count).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

from ..core.blocking import Blocking
from ..core.config import write_config
from ..core.device import task_device
from ..core.runtime import BlockTask
from ..core.storage import VarlenDataset, file_reader
from ..core.storage import read_max_id as _read_max_id
from ..core.workflow import FileTarget, Task


def overlaps_dir(tmp_folder: str, prefix: str) -> str:
    return os.path.join(tmp_folder, f"overlaps_{prefix}" if prefix else "overlaps")


class BlockNodeLabels(BlockTask):
    """Per-block overlap extraction (reference: block_node_labels.py).

    Counts, for every fragment (node) id in ``ws`` and every label in the
    second volume, the co-occurring voxels; writes the counts pre-sharded by
    node-id range into the tmp folder.
    """

    task_name = "block_node_labels"

    def __init__(self, ws_path: str, ws_key: str, input_path: str,
                 input_key: str, prefix: str = "",
                 ignore_label: Optional[int] = None,
                 n_labels: Optional[int] = None,
                 include_zeros: bool = False, **kw):
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.input_path = input_path
        self.input_key = input_key
        self.prefix = prefix
        self.ignore_label = ignore_label
        self.n_labels = n_labels
        #: count overlaps of node id 0 too and never skip empty blocks —
        #: required when the table must be an exact contingency table
        #: (evaluation), not just fragment->label assignments
        self.include_zeros = include_zeros
        self.identifier = prefix
        super().__init__(**kw)
        self.device = task_device(self.global_config)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"shard_size": 1_000_000})
        return conf

    def run_impl(self):
        with file_reader(self.ws_path, "r") as f:
            shape = list(f[self.ws_key].shape)
        n_labels = self.n_labels or (_read_max_id(self.ws_path, self.ws_key) + 1)
        block_shape = self.global_block_shape()[-len(shape):]
        block_list = self.blocks_in_volume(shape, block_shape)
        out_dir = overlaps_dir(self.tmp_folder, self.prefix)
        os.makedirs(out_dir, exist_ok=True)
        # record shard geometry once; the merge task reads it back so the two
        # tasks can never disagree on shard_size/n_labels (separately
        # configurable task configs must not shift shard boundaries)
        write_config(os.path.join(out_dir, "meta.json"),
                     {"shard_size": int(self.task_config["shard_size"]),
                      "n_labels": int(n_labels)})
        self.run_jobs(block_list, {
            "ws_path": self.ws_path, "ws_key": self.ws_key,
            "input_path": self.input_path, "input_key": self.input_key,
            "shape": shape, "block_shape": block_shape,
            "ignore_label": self.ignore_label,
            "include_zeros": self.include_zeros,
            "overlaps_dir": out_dir, "n_labels": n_labels,
            "device": self.device,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from ..ops.overlaps import count_overlaps

        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        shard_size = int(cfg.get("shard_size", 1_000_000))
        ignore_label = cfg.get("ignore_label")
        out_dir = cfg["overlaps_dir"]
        f_ws = file_reader(cfg["ws_path"], "r")
        f_in = file_reader(cfg["input_path"], "r")
        ds_ws, ds_in = f_ws[cfg["ws_key"]], f_in[cfg["input_key"]]
        include_zeros = bool(cfg.get("include_zeros", False))
        for block_id in job_config["block_list"]:
            bb = blocking.get_block(block_id).bb
            ws = ds_ws[bb]
            if not include_zeros and not ws.any():
                log_fn(f"block {block_id} is empty")
                log_fn(f"processed block {block_id}")
                continue
            labels = ds_in[bb]
            ids_ws, ids_lab, counts = count_overlaps(ws, labels,
                                                     device=cfg["device"])
            keep = np.ones(len(ids_ws), dtype=bool)
            if not include_zeros:
                keep &= ids_ws != 0  # node id 0 is background everywhere
            if ignore_label is not None:
                keep &= ids_lab != np.uint64(ignore_label)
            ids_ws, ids_lab, counts = ids_ws[keep], ids_lab[keep], counts[keep]
            if len(ids_ws) == 0:
                log_fn(f"processed block {block_id}")
                continue
            rows = np.stack([ids_ws, ids_lab, counts], axis=1)
            shards = (ids_ws // np.uint64(shard_size)).astype("int64")
            for s in np.unique(shards):
                shard_dir = os.path.join(out_dir, f"shard_{s}")
                os.makedirs(shard_dir, exist_ok=True)
                # tmp name must not match the block_*.npy aggregation glob
                tmp = os.path.join(shard_dir, f".tmp_block_{block_id}.npy")
                np.save(tmp, rows[shards == s])
                os.replace(tmp, os.path.join(shard_dir, f"block_{block_id}.npy"))
            log_fn(f"processed block {block_id}")


def _aggregate_shard(shard_dir: str) -> np.ndarray:
    """Concatenate a shard's per-block files and sum counts per
    (node, label) pair.  Returns (n, 3) uint64 (node, label, count)."""
    chunks = []
    if os.path.isdir(shard_dir):
        for name in sorted(os.listdir(shard_dir)):
            if name.startswith("block_") and name.endswith(".npy"):
                chunks.append(np.load(os.path.join(shard_dir, name)))
    if not chunks:
        return np.zeros((0, 3), dtype="uint64")
    rows = np.concatenate(chunks, axis=0)
    pairs, inv = np.unique(rows[:, :2], axis=0, return_inverse=True)
    counts = np.bincount(inv, weights=rows[:, 2].astype("float64"),
                         minlength=len(pairs)).astype("uint64")
    return np.concatenate([pairs, counts[:, None]], axis=1)


class MergeNodeLabels(BlockTask):
    """Merge per-block overlaps, sharded over **node-id space** (reference:
    merge_node_labels.py, label-range blocking).

    ``max_overlap=True`` writes the argmax label per node into the output
    dataset (ties break to the smallest label id, deterministically);
    ``max_overlap=False`` serializes the full merged overlaps per shard into a
    varlen dataset for downstream consumers (evaluation measures)."""

    task_name = "merge_node_labels"

    def __init__(self, output_path: str, output_key: str,
                 n_labels: Optional[int] = None,
                 prefix: str = "", max_overlap: bool = True, **kw):
        self.output_path = output_path
        self.output_key = output_key
        self.n_labels = n_labels
        self.prefix = prefix
        self.max_overlap = max_overlap
        self.identifier = prefix
        super().__init__(**kw)

    def run_impl(self):
        # shard geometry comes from the extraction task's metadata — written
        # when BlockNodeLabels ran (i.e. lazily, not at DAG-construction time)
        meta_path = os.path.join(
            overlaps_dir(self.tmp_folder, self.prefix), "meta.json")
        with open(meta_path) as f:
            meta = json.load(f)
        shard_size = int(meta["shard_size"])
        n_labels = int(self.n_labels or meta["n_labels"])
        n_shards = max((n_labels + shard_size - 1) // shard_size, 1)
        if self.max_overlap:
            with file_reader(self.output_path) as f:
                f.require_dataset(
                    self.output_key, shape=(n_labels,),
                    chunks=(min(shard_size, n_labels),), dtype="uint64")
        self.run_jobs(list(range(n_shards)), {
            "output_path": self.output_path, "output_key": self.output_key,
            "overlaps_dir": overlaps_dir(self.tmp_folder, self.prefix),
            "max_overlap": self.max_overlap, "n_labels": n_labels,
            "shard_size": shard_size,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        shard_size = int(cfg["shard_size"])
        n_labels = int(cfg["n_labels"])
        for shard_id in job_config["block_list"]:
            rows = _aggregate_shard(
                os.path.join(cfg["overlaps_dir"], f"shard_{shard_id}"))
            if cfg["max_overlap"]:
                begin = shard_id * shard_size
                end = min(begin + shard_size, n_labels)
                out = np.zeros(end - begin, dtype="uint64")
                if len(rows):
                    # argmax count per node, ties to the smallest label id:
                    # sort by (node, -count, label), take the first row per node
                    nodes = rows[:, 0].astype("int64") - begin
                    srt = np.lexsort((rows[:, 1],
                                      -rows[:, 2].astype("int64"), nodes))
                    first = np.flatnonzero(
                        np.r_[True, nodes[srt][1:] != nodes[srt][:-1]])
                    sel = srt[first]
                    out[nodes[sel]] = rows[sel, 1]
                with file_reader(cfg["output_path"]) as f:
                    f[cfg["output_key"]][begin:end] = out
            else:
                ds = VarlenDataset(os.path.join(
                    cfg["output_path"], cfg["output_key"]), dtype="uint64")
                ds.write_chunk((int(shard_id),), rows.ravel())
            log_fn(f"processed block {shard_id}")


def load_merged_overlaps(output_path: str, output_key: str) -> np.ndarray:
    """Read back overlaps serialized by MergeNodeLabels(max_overlap=False) as
    one (n, 3) uint64 array of (node, label, count) rows."""
    ds = VarlenDataset(os.path.join(output_path, output_key), dtype="uint64")
    parts = []
    for chunk_id in ds.chunk_ids():
        data = ds.read_chunk(chunk_id)
        if data is not None and data.size:
            parts.append(data.reshape(-1, 3))
    if not parts:
        return np.zeros((0, 3), dtype="uint64")
    return np.concatenate(parts, axis=0)


class NodeLabelWorkflow(Task):
    """BlockNodeLabels -> MergeNodeLabels (reference:
    node_labels/node_label_workflow.py)."""

    def __init__(self, ws_path: str, ws_key: str, input_path: str,
                 input_key: str, output_path: str, output_key: str,
                 tmp_folder: str, config_dir: str, max_jobs: int = 1,
                 target: str = "gpu", prefix: str = "",
                 max_overlap: bool = True,
                 ignore_label: Optional[int] = None,
                 n_labels: Optional[int] = None,
                 dependency: Optional[Task] = None):
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.prefix = prefix
        self.max_overlap = max_overlap
        self.ignore_label = ignore_label
        self.n_labels = n_labels
        self.dependency = dependency
        super().__init__()

    def _common(self):
        return dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                    max_jobs=self.max_jobs, target=self.target)

    def requires(self):
        t1 = BlockNodeLabels(
            ws_path=self.ws_path, ws_key=self.ws_key,
            input_path=self.input_path, input_key=self.input_key,
            prefix=self.prefix, ignore_label=self.ignore_label,
            n_labels=self.n_labels, dependency=self.dependency,
            **self._common())
        t2 = MergeNodeLabels(
            output_path=self.output_path, output_key=self.output_key,
            prefix=self.prefix, max_overlap=self.max_overlap,
            dependency=t1, **self._common())
        return t2

    def output(self):
        suffix = f"_{self.prefix}" if self.prefix else ""
        return FileTarget(os.path.join(
            self.tmp_folder, f"merge_node_labels{suffix}.status"))
