"""Per-segment morphology statistics: size, center of mass, bounding box.

Port of cluster_tools_tpu/workflows/morphology.py (host numpy and scipy,
as in the JAX package), after the reference's ``morphology/`` package
(block_morphology.py:111-137 ``ndist.computeAndSerializeMorphology``,
merge_morphology.py:104+ label-range-sharded merge, region_centers.py:106-135
EDT-based region centers).  Table layout matches the reference exactly
(documented at skeletons/skeletonize.py:176-181):

    column 0     label id
    column 1     voxel size
    columns 2:5  center of mass (zyx)
    columns 5:8  bounding-box min (zyx)
    columns 8:11 bounding-box max (zyx, inclusive)
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from ..core.blocking import Blocking
from ..core.runtime import BlockTask
from ..core.storage import file_reader
from ..core.workflow import FileTarget, Task

N_COLS = 11
_BLOCK_DIR = "morphology_blocks"


def block_morphology(seg: np.ndarray, offset) -> np.ndarray:
    """(n_ids, 11) morphology rows for one block (global coordinates)."""
    ids, inv = np.unique(seg, return_inverse=True)
    inv = inv.reshape(seg.shape)
    n = len(ids)
    out = np.zeros((n, N_COLS), "float64")
    out[:, 0] = ids
    out[:, 1] = np.bincount(inv.ravel(), minlength=n)
    coords = np.meshgrid(*[np.arange(s) for s in seg.shape], indexing="ij")
    for ax, grid in enumerate(coords):
        sums = np.bincount(inv.ravel(), weights=grid.ravel(), minlength=n)
        out[:, 2 + ax] = sums / out[:, 1] + offset[ax]
        mins = np.full(n, np.inf)
        maxs = np.full(n, -np.inf)
        np.minimum.at(mins, inv.ravel(), grid.ravel())
        np.maximum.at(maxs, inv.ravel(), grid.ravel())
        out[:, 5 + ax] = mins + offset[ax]
        out[:, 8 + ax] = maxs + offset[ax]
    return out


def decode_morphology(table: np.ndarray):
    """(sizes, bb_min, bb_max_exclusive) from morphology-table rows (the
    column layout documented in the module docstring)."""
    return (table[:, 1], table[:, 5:8].astype("int64"),
            table[:, 8:11].astype("int64") + 1)


def merge_morphology_rows(rows: np.ndarray) -> np.ndarray:
    """Merge per-block rows sharing label ids (count-weighted com, min/max
    bbox, summed sizes)."""
    ids, inv = np.unique(rows[:, 0], return_inverse=True)
    n = len(ids)
    out = np.zeros((n, N_COLS), "float64")
    out[:, 0] = ids
    np.add.at(out[:, 1], inv, rows[:, 1])
    for ax in range(3):
        com = np.zeros(n)
        np.add.at(com, inv, rows[:, 2 + ax] * rows[:, 1])
        out[:, 2 + ax] = com / out[:, 1]
        mins = np.full(n, np.inf)
        maxs = np.full(n, -np.inf)
        np.minimum.at(mins, inv, rows[:, 5 + ax])
        np.maximum.at(maxs, inv, rows[:, 8 + ax])
        out[:, 5 + ax] = mins
        out[:, 8 + ax] = maxs
    return out


class BlockMorphology(BlockTask):
    """Per-block morphology rows -> block npz (reference:
    block_morphology.py:111-137)."""

    task_name = "block_morphology"

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 prefix: str = "", **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.prefix = prefix
        self.identifier = prefix
        super().__init__(**kw)

    def run_impl(self):
        with file_reader(self.input_path, "r") as f:
            shape = list(f[self.input_key].shape)
        block_shape = self.global_block_shape()[-len(shape):]
        os.makedirs(os.path.join(self.output_path, _BLOCK_DIR), exist_ok=True)
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "output_path": self.output_path, "prefix": self.prefix,
            "shape": shape, "block_shape": block_shape,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        f_in = file_reader(cfg["input_path"], "r")
        ds = f_in[cfg["input_key"]]
        for block_id in job_config["block_list"]:
            block = blocking.get_block(block_id)
            seg = np.asarray(ds[block.bb])
            rows = block_morphology(seg, block.begin)
            rows = rows[rows[:, 0] != 0]  # drop the ignore label
            np.savez(os.path.join(
                cfg["output_path"], _BLOCK_DIR,
                f"{cfg['prefix']}block_{block_id}.npz"), rows=rows)
            log_fn(f"processed block {block_id}")


class MergeMorphology(BlockTask):
    """Label-range-sharded merge into the (n_labels, 11) morphology table
    (reference: merge_morphology.py:104+)."""

    task_name = "merge_morphology"

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
            f.require_dataset(self.output_key, shape=(n, N_COLS),
                              chunks=(min(chunk, n), N_COLS),
                              dtype="float64")
        self.run_jobs(self.id_chunks(self.n_labels, chunk), {
            "output_path": self.output_path, "output_key": self.output_key,
            "n_labels": self.n_labels, "id_chunk_size": chunk,
            "prefix": self.prefix,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        chunk, n_labels = cfg["id_chunk_size"], cfg["n_labels"]
        block_dir = os.path.join(cfg["output_path"], _BLOCK_DIR)
        prefix = cfg["prefix"] + "block_"
        ranges = {bid: (bid * chunk, min((bid + 1) * chunk, n_labels))
                  for bid in job_config["block_list"]}
        parts: Dict[int, list] = {bid: [] for bid in ranges}
        for name in sorted(os.listdir(block_dir)):
            if not (name.startswith(prefix) and name.endswith(".npz")):
                continue
            with np.load(os.path.join(block_dir, name)) as d:
                rows = d["rows"]
            for bid, (lo, hi) in ranges.items():
                m = (rows[:, 0] >= lo) & (rows[:, 0] < hi)
                if m.any():
                    parts[bid].append(rows[m])

        f_out = file_reader(cfg["output_path"])
        ds = f_out[cfg["output_key"]]
        for bid, (lo, hi) in ranges.items():
            out = np.zeros((hi - lo, N_COLS), "float64")
            out[:, 0] = np.arange(lo, hi)
            if parts[bid]:
                merged = merge_morphology_rows(np.concatenate(parts[bid]))
                out[merged[:, 0].astype("int64") - lo] = merged
            ds[lo:hi, :] = out
            log_fn(f"processed block {bid}")


class RegionCenters(BlockTask):
    """In-object center per segment: argmax of the EDT inside the segment's
    bounding box (reference: region_centers.py:106-135), label-range
    sharded."""

    task_name = "region_centers"

    def __init__(self, input_path: str, input_key: str,
                 morphology_path: str, morphology_key: str,
                 output_path: str, output_key: str, n_labels: int,
                 ignore_label: Optional[int] = 0, **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.morphology_path = morphology_path
        self.morphology_key = morphology_key
        self.output_path = output_path
        self.output_key = output_key
        self.n_labels = n_labels
        self.ignore_label = ignore_label
        super().__init__(**kw)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"id_chunk_size": 1000, "resolution": [1, 1, 1]})
        return conf

    def run_impl(self):
        chunk = int(self.task_config.get("id_chunk_size", 1000))
        n = max(self.n_labels, 1)
        with file_reader(self.output_path) as f:
            f.require_dataset(self.output_key, shape=(n, 3),
                              chunks=(min(chunk, n), 3), dtype="float32")
        self.run_jobs(self.id_chunks(self.n_labels, chunk), {
            "input_path": self.input_path, "input_key": self.input_key,
            "morphology_path": self.morphology_path,
            "morphology_key": self.morphology_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "n_labels": self.n_labels, "id_chunk_size": chunk,
            "ignore_label": self.ignore_label,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from scipy.ndimage import distance_transform_edt

        cfg = job_config["config"]
        chunk, n_labels = cfg["id_chunk_size"], cfg["n_labels"]
        resolution = cfg.get("resolution") or [1, 1, 1]
        f_morph = file_reader(cfg["morphology_path"], "r")
        ds_morph = f_morph[cfg["morphology_key"]]
        f_in = file_reader(cfg["input_path"], "r")
        f_out = file_reader(cfg["output_path"])
        ds_in = f_in[cfg["input_key"]]
        ds_out = f_out[cfg["output_key"]]
        ignore = cfg.get("ignore_label")

        for block_id in job_config["block_list"]:
            lo, hi = block_id * chunk, min((block_id + 1) * chunk, n_labels)
            # chunk-aligned read of only the owned id range (the table can
            # be GBs at cluster scale; never load it whole per job)
            morpho = ds_morph[lo:hi, :]
            sizes, bb_min, bb_max = decode_morphology(morpho)
            centers = np.zeros((hi - lo, 3), "float32")
            for label_id in range(lo, hi):
                if label_id == ignore or sizes[label_id - lo] == 0:
                    continue
                bb = tuple(slice(b, e) for b, e in
                           zip(bb_min[label_id - lo],
                               bb_max[label_id - lo]))
                obj = np.asarray(ds_in[bb]) == label_id
                if not obj.any():
                    continue
                # the deepest-inside point (EDT argmax) — tiny per-object
                # arrays, so host scipy beats a device round-trip per object
                dist = distance_transform_edt(obj, sampling=resolution)
                center = np.unravel_index(int(np.argmax(dist)), obj.shape)
                centers[label_id - lo] = [c + b.start for c, b
                                          in zip(center, bb)]
            ds_out[lo:hi, :] = centers
            log_fn(f"processed block {block_id}")


class MorphologyWorkflow(Task):
    """BlockMorphology -> MergeMorphology (reference:
    morphology_workflow wiring)."""

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str, tmp_folder: str, config_dir: str,
                 max_jobs: int = 1, target: str = "gpu",
                 n_labels: Optional[int] = None, prefix: str = "",
                 dependency: Optional[Task] = None):
        self.input_path = input_path
        self.input_key = input_key
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
        blocks = BlockMorphology(
            input_path=self.input_path, input_key=self.input_key,
            output_path=self.output_path, prefix=self.prefix,
            dependency=self.dependency, **common)
        return MergeMorphology(
            output_path=self.output_path, output_key=self.output_key,
            n_labels=self.n_labels, labels_path=self.input_path,
            labels_key=self.input_key, prefix=self.prefix, dependency=blocks,
            **common)

    def output(self):
        name = "merge_morphology" + (f"_{self.prefix}" if self.prefix else "")
        return FileTarget(os.path.join(self.tmp_folder, f"{name}.status"))
