"""Paintera-format conversion + legacy BigCat export.

Port of cluster_tools_tpu/workflows/paintera.py, after the reference's
``paintera/`` package (conversion_workflow.py:104-357 — steps: copy labels
to the paintera data group, multiscale label downsampling, per-block
unique-label lists, label-to-block lookup, fragment-segment assignment,
java-axis-order (XYZ) metadata; unique_block_labels.py:123-145,
label_block_mapping.py:103-117) and the ``bigcat/`` package
(bigcat_workflow.py:13-115 — fragment-segment pairs + offset attrs).  The
label downsampling (``DownscaleTask``) runs on the global config's device;
every other step runs on the host, as in the JAX package.  The proofreading
subsystem (``edits/``) uses the label-to-block lookup and the
fragment-segment assignment helpers.  The BigCat export writes HDF5 (the
reference's format, through ``core/hdf5.py``), N5 or zarr.

Layout produced under ``<path>/<label_group>``:

    data/s0..sN                multiscale label volumes
    unique-labels/s<i>         per-block unique-label lists (varlen)
    label-to-block-mapping/s<i>  per-label block-id lists (varlen)
    fragment-segment-assignment  (2, N) fragment->segment pairs
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core.blocking import Blocking
from ..core.runtime import BlockTask
from ..core.storage import VarlenDataset, file_reader
from ..core.workflow import FileTarget, Task
from .copy_volume import CopyVolumeTask
from .downscaling import DownscaleTask, _factor3


class UniqueBlockLabels(BlockTask):
    """Per-block unique label lists for one scale level (reference:
    unique_block_labels.py:123-145, incl. the label-multiset variant —
    with ``from_multiset`` the input is a multiset level written by
    workflows/label_multisets.py and uniques come from the multiset ids
    without touching the dense volume)."""

    task_name = "unique_block_labels"

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str, identifier: str = "",
                 from_multiset: bool = False, **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.identifier = identifier
        self.from_multiset = from_multiset
        super().__init__(**kw)

    def run_impl(self):
        if self.from_multiset:
            src = VarlenDataset(os.path.join(self.input_path,
                                             self.input_key),
                                dtype="uint64", mode="r")
            shape = list(src.attrs["multisetShape"])
            block_shape = list(src.attrs["blockShape"])
        else:
            with file_reader(self.input_path, "r") as f:
                shape = list(f[self.input_key].shape)
            block_shape = [min(b, s) for b, s in
                           zip(self.global_block_shape(), shape)]
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "shape": shape, "block_shape": block_shape,
            "from_multiset": self.from_multiset,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        out = VarlenDataset(os.path.join(cfg["output_path"],
                                         cfg["output_key"]), dtype="uint64")
        if cfg.get("from_multiset"):
            from .label_multisets import load_multiset_block

            src = VarlenDataset(os.path.join(cfg["input_path"],
                                             cfg["input_key"]),
                                dtype="uint64", mode="r")
            for block_id in job_config["block_list"]:
                entry = load_multiset_block(cfg["input_path"],
                                            cfg["input_key"], block_id,
                                            ds=src)
                ids = (np.zeros(0, "uint64") if entry is None
                       else np.unique(entry[1]))
                out.write_chunk((block_id,), ids.astype("uint64"))
                log_fn(f"processed block {block_id}")
            return
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        f_in = file_reader(cfg["input_path"], "r")
        ds = f_in[cfg["input_key"]]
        for block_id in job_config["block_list"]:
            uniques = np.unique(ds[blocking.get_block(block_id).bb])
            out.write_chunk((block_id,), uniques.astype("uint64"))
            log_fn(f"processed block {block_id}")


class LabelBlockMapping(BlockTask):
    """Invert the per-block unique lists into a per-label block-id lookup,
    sharded over label-id ranges (reference: label_block_mapping.py:103-117
    ``ndist.serializeBlockMapping``)."""

    task_name = "label_block_mapping"

    def __init__(self, uniques_path: str, uniques_key: str, output_path: str,
                 output_key: str, n_labels: Optional[int] = None,
                 labels_path: str = "", labels_key: str = "",
                 identifier: str = "", **kw):
        self.uniques_path = uniques_path
        self.uniques_key = uniques_key
        self.output_path = output_path
        self.output_key = output_key
        self.n_labels = n_labels
        self.labels_path = labels_path
        self.labels_key = labels_key
        self.identifier = identifier
        super().__init__(**kw)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"id_chunk_size": int(1e6)})
        return conf

    def run_impl(self):
        self.resolve_n_labels()
        chunk = int(self.task_config.get("id_chunk_size", 1e6))
        self.run_jobs(self.id_chunks(self.n_labels, chunk), {
            "uniques_path": self.uniques_path,
            "uniques_key": self.uniques_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "n_labels": self.n_labels, "id_chunk_size": chunk,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        chunk, n_labels = cfg["id_chunk_size"], cfg["n_labels"]
        uniques = VarlenDataset(os.path.join(cfg["uniques_path"],
                                             cfg["uniques_key"]),
                                dtype="uint64")
        # one pass over the block lists, binned into owned label ranges
        ranges = {bid: (bid * chunk, min((bid + 1) * chunk, n_labels))
                  for bid in job_config["block_list"]}
        mapping: Dict[int, Dict[int, List[int]]] = {
            bid: {} for bid in ranges}
        for chunk_id in uniques.chunk_ids():
            ids = uniques.read_chunk(chunk_id)
            if ids is None:
                continue
            block = int(chunk_id[0])
            for bid, (lo, hi) in ranges.items():
                m = (ids >= lo) & (ids < hi)
                for lab in ids[m]:
                    mapping[bid].setdefault(int(lab), []).append(block)
        out = VarlenDataset(os.path.join(cfg["output_path"],
                                         cfg["output_key"]), dtype="uint64")
        for bid, (lo, hi) in ranges.items():
            for lab, blocks in mapping[bid].items():
                out.write_chunk((lab,), np.asarray(blocks, "uint64"))
            log_fn(f"processed block {bid}")


def label_to_blocks(path: str, key: str, label_id: int):
    """Blocks containing ``label_id`` (readBlockMapping equivalent)."""
    ds = VarlenDataset(os.path.join(path, key), dtype="uint64")
    return ds.read_chunk((label_id,))


def assignment_to_pairs(table: np.ndarray) -> np.ndarray:
    """Assignment table -> (2, N) paintera fragment->segment pairs.

    Accepts either a dense 1-d table (index = fragment id) or sparse
    (N, 2) ``(fragment, segment)`` rows.  Background (fragment 0) is
    dropped and segment ids are offset past the largest fragment id so
    the two id spaces never collide — the paintera convention shared by
    the conversion export, the BigCat export, and the edits/ assignment
    patcher."""
    if table.ndim == 2:
        frag, seg = table[:, 0], table[:, 1]
    else:
        frag = np.arange(len(table), dtype="uint64")
        seg = table
    keep = frag != 0
    offset = int(frag.max()) + 1 if len(frag) else 1
    return np.stack([frag[keep], seg[keep] + offset], axis=0).astype("uint64")


def pairs_to_table(pairs: np.ndarray,
                   n_labels: Optional[int] = None) -> np.ndarray:
    """Invert :func:`assignment_to_pairs` back to a dense table.

    The offset is recovered as ``max(fragment id) + 1`` — exactly what
    the forward direction used, since dropping fragment 0 never changes
    the maximum.  ``n_labels`` sizes the table (defaults to the smallest
    table covering every fragment id); an empty pair set round-trips to
    an all-background table."""
    pairs = np.asarray(pairs)
    if pairs.size == 0:
        return np.zeros(0 if n_labels is None else int(n_labels), "uint64")
    frag, seg = pairs[0].astype("uint64"), pairs[1].astype("uint64")
    offset = int(frag.max()) + 1
    n = int(n_labels) if n_labels is not None else offset
    table = np.zeros(n, "uint64")
    table[frag.astype("int64")] = seg - np.uint64(offset)
    return table


def load_fragment_segment_assignment(path: str, label_group: str):
    """The (2, N) pairs dataset of a paintera group, or None if absent."""
    key = os.path.join(label_group, "fragment-segment-assignment")
    with file_reader(path, "r") as f:
        if key not in f:
            return None
        return f[key][:]


def write_fragment_segment_assignment(path: str, label_group: str,
                                      pairs: np.ndarray) -> None:
    """(Re)write the (2, N) pairs dataset — the edits/ patcher's path for
    keeping an attached paintera project consistent after an edit.

    ``require_dataset`` refuses shape changes by design, so when N moved
    (merges change the pair count) a dir-backed dataset is deleted and
    recreated; same-shape rewrites go in place."""
    key = os.path.join(label_group, "fragment-segment-assignment")
    pairs = np.asarray(pairs, dtype="uint64")
    with file_reader(path) as f:
        if key in f and tuple(f[key].shape) == tuple(pairs.shape):
            f[key][:] = pairs
            return
    ds_dir = os.path.join(path, key)
    if os.path.isdir(ds_dir):
        shutil.rmtree(ds_dir)
    with file_reader(path) as f:
        f.require_dataset(key, data=pairs, shape=pairs.shape,
                          chunks=(2, max(min(int(1e6), pairs.shape[1]), 1)))


class FragmentSegmentAssignment(Task):
    """(2, N) fragment->segment table inside the paintera group (reference:
    conversion_workflow.py fragment_segment_assignment step)."""

    def __init__(self, path: str, label_group: str, assignment_path: str,
                 assignment_key: Optional[str], tmp_folder: str,
                 dependency: Optional[Task] = None):
        self.path = path
        self.label_group = label_group
        self.assignment_path = assignment_path
        self.assignment_key = assignment_key
        self.tmp_folder = tmp_folder
        self.dependency = dependency
        super().__init__()

    def requires(self):
        return self.dependency

    def run(self):
        from .write import load_assignments

        table = load_assignments(self.assignment_path, self.assignment_key)
        pairs = assignment_to_pairs(table)
        write_fragment_segment_assignment(self.path, self.label_group, pairs)
        self.output().touch()

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder,
                                       "fragment_segment_assignment.status"))


class WritePainteraMetadata(Task):
    """Paintera group attributes (reference: WritePainteraMetadata,
    conversion_workflow.py:21-101): painteraData type, maxId,
    labelBlockLookup, multiScale + per-scale downsamplingFactors in XYZ
    axis order."""

    def __init__(self, path: str, label_group: str, scale_factors,
                 resolution, offset, max_id, tmp_folder: str,
                 dependency: Optional[Task] = None):
        # max_id may be an (path, key) tuple resolved at run time
        self.path = path
        self.label_group = label_group
        self.scale_factors = [_factor3(s) for s in scale_factors]
        self.resolution = list(resolution)
        self.offset = list(offset)
        self.max_id = max_id
        self.tmp_folder = tmp_folder
        self.dependency = dependency
        super().__init__()

    def requires(self):
        return self.dependency

    def run(self):
        max_id = self.max_id
        if isinstance(max_id, (tuple, list)):
            from ..core.storage import read_max_id

            max_id = read_max_id(*max_id)
        with file_reader(self.path) as f:
            group = f.require_group(self.label_group)
            group.attrs["painteraData"] = {"type": "label"}
            group.attrs["maxId"] = int(max_id)
            pattern = os.path.join(self.label_group,
                                   "label-to-block-mapping", "s%d")
            group.attrs["labelBlockLookup"] = {
                "type": "n5-filesystem",
                "root": os.path.abspath(self.path),
                "scaleDatasetPattern": pattern,
            }
            data_group = f.require_group(
                os.path.join(self.label_group, "data"))
            data_group.attrs["maxId"] = int(max_id)
            data_group.attrs["multiScale"] = True
            # java n5 axis order is XYZ; ours is ZYX -> reverse
            data_group.attrs["resolution"] = self.resolution[::-1]
            data_group.attrs["offset"] = self.offset[::-1]
            effective = [1, 1, 1]
            for scale, factor in enumerate(self.scale_factors):
                effective = [e * s for e, s in zip(effective, factor)]
                f[os.path.join(self.label_group, "data",
                               f"s{scale + 1}")].attrs[
                    "downsamplingFactors"] = effective[::-1]
        self.output().touch()

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder,
                                       "paintera_metadata.status"))


class PainteraConversionWorkflow(Task):
    """Full conversion: copy labels -> multiscale (label-safe) downsample ->
    per-scale unique-block lists -> label-to-block lookup -> assignment ->
    metadata (reference: ConversionWorkflow, conversion_workflow.py:104-357).
    """

    def __init__(self, input_path: str, input_key: str, path: str,
                 label_group: str, scale_factors: Sequence,
                 tmp_folder: str, config_dir: str, max_jobs: int = 1,
                 target: str = "gpu", assignment_path: str = "",
                 assignment_key: Optional[str] = None,
                 resolution=(1.0, 1.0, 1.0), offset=(0.0, 0.0, 0.0),
                 dependency: Optional[Task] = None):
        self.input_path = input_path
        self.input_key = input_key
        self.path = path
        self.label_group = label_group
        self.scale_factors = list(scale_factors)
        self.assignment_path = assignment_path
        self.assignment_key = assignment_key
        self.resolution = resolution
        self.offset = offset
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def requires(self):
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                      max_jobs=self.max_jobs, target=self.target)
        data_prefix = os.path.join(self.label_group, "data")

        # step 1: copy labels to data/s0
        dep: Task = CopyVolumeTask(
            input_path=self.input_path, input_key=self.input_key,
            output_path=self.path,
            output_key=os.path.join(data_prefix, "s0"),
            identifier="paintera_labels", dependency=self.dependency,
            **common)
        # step 2: label-safe multiscale
        for scale, factor in enumerate(self.scale_factors):
            dep = DownscaleTask(
                input_path=self.path,
                input_key=os.path.join(data_prefix, f"s{scale}"),
                output_path=self.path,
                output_key=os.path.join(data_prefix, f"s{scale + 1}"),
                scale_factor=factor, sampler="nearest",
                identifier=f"paintera_s{scale + 1}",
                dependency=dep, **common)
        # step 3+4: uniques + label-to-block lookup per scale
        n_scales = len(self.scale_factors) + 1
        for scale in range(n_scales):
            uniques_key = os.path.join(self.label_group, "unique-labels",
                                       f"s{scale}")
            dep = UniqueBlockLabels(
                input_path=self.path,
                input_key=os.path.join(data_prefix, f"s{scale}"),
                output_path=self.path, output_key=uniques_key,
                identifier=f"s{scale}", dependency=dep, **common)
            dep = LabelBlockMapping(
                uniques_path=self.path, uniques_key=uniques_key,
                output_path=self.path,
                output_key=os.path.join(self.label_group,
                                        "label-to-block-mapping",
                                        f"s{scale}"),
                labels_path=self.input_path, labels_key=self.input_key,
                identifier=f"s{scale}",
                dependency=dep, **common)
        # step 5: fragment-segment assignment (optional)
        if self.assignment_path:
            dep = FragmentSegmentAssignment(
                path=self.path, label_group=self.label_group,
                assignment_path=self.assignment_path,
                assignment_key=self.assignment_key,
                tmp_folder=self.tmp_folder, dependency=dep)
        # step 6: metadata
        return WritePainteraMetadata(
            path=self.path, label_group=self.label_group,
            scale_factors=self.scale_factors, resolution=self.resolution,
            offset=self.offset, max_id=(self.input_path, self.input_key),
            tmp_folder=self.tmp_folder, dependency=dep)

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder,
                                       "paintera_metadata.status"))


class BigcatWorkflow(Task):
    """Legacy BigCat export: fragment volume + fragment-segment pairs +
    offset attrs (reference: bigcat/bigcat_workflow.py:13-115), into an
    HDF5, N5 or zarr container."""

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 assignment_path: str, assignment_key: Optional[str],
                 tmp_folder: str, config_dir: str, max_jobs: int = 1,
                 target: str = "gpu", resolution=(1.0, 1.0, 1.0),
                 dependency: Optional[Task] = None):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.assignment_path = assignment_path
        self.assignment_key = assignment_key
        self.resolution = resolution
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def requires(self):
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                      max_jobs=self.max_jobs, target=self.target)
        copy = CopyVolumeTask(
            input_path=self.input_path, input_key=self.input_key,
            output_path=self.output_path,
            output_key="volumes/labels/fragments", identifier="bigcat",
            dependency=self.dependency, **common)
        return _BigcatFinalize(
            output_path=self.output_path,
            assignment_path=self.assignment_path,
            assignment_key=self.assignment_key,
            resolution=self.resolution, tmp_folder=self.tmp_folder,
            dependency=copy)

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder,
                                       "bigcat_finalize.status"))


class _BigcatFinalize(Task):
    def __init__(self, output_path: str, assignment_path: str,
                 assignment_key, resolution, tmp_folder: str,
                 dependency: Optional[Task] = None):
        self.output_path = output_path
        self.assignment_path = assignment_path
        self.assignment_key = assignment_key
        self.resolution = resolution
        self.tmp_folder = tmp_folder
        self.dependency = dependency
        super().__init__()

    def requires(self):
        return self.dependency

    def run(self):
        from .write import load_assignments

        table = load_assignments(self.assignment_path, self.assignment_key)
        pairs = assignment_to_pairs(table)
        with file_reader(self.output_path) as f:
            f.require_dataset("fragment_segment_lut",
                              data=pairs.astype("uint64"), shape=pairs.shape,
                              chunks=(2, max(min(int(1e6),
                                                 pairs.shape[1]), 1)))
            ds = f["volumes/labels/fragments"]
            ds.attrs["resolution"] = list(self.resolution)
            ds.attrs["offset"] = [0.0, 0.0, 0.0]
            f.attrs["next_id"] = int(pairs.max()) + 1
        self.output().touch()

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder,
                                       "bigcat_finalize.status"))
