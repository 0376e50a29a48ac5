"""Label multisets: per-voxel (label, count) multisets at downsampled
scales.

Port of cluster_tools_tpu/workflows/label_multisets.py (host numpy, as in
the JAX package).  The reference leaves this component as an empty stub
(label_multisets/__init__.py is 1 line; paintera/conversion_workflow.py:14-15
carries the TODO) — Paintera's multiscale label datasets want, for every
coarse voxel, the multiset of fine labels inside its window so proofreading
tools can render and pick ids without touching full resolution.  This is a
working implementation with a documented flat serialization (not Paintera's
java binary layout, which cannot be validated here):

Per coarse block (one VarlenDataset chunk per block id), a single uint64
array::

    [n_voxels,
     offsets[0..n_voxels]          (exclusive prefix sum, last = n_entries),
     ids[0..n_entries),
     counts[0..n_entries)]

where voxel ``i`` of the C-ordered coarse block owns entries
``offsets[i]:offsets[i+1]``, sorted by id.  ``unpack_multiset_block``
restores (offsets, ids, counts).

The multiset computation is a sort + run-length encode over pooling
windows — pure vectorized numpy per block, no per-voxel Python.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.blocking import Blocking
from ..core.runtime import BlockTask
from ..core.storage import VarlenDataset, file_reader
from ..core.workflow import FileTarget, Task
from .downscaling import ScaleFactor, _factor3


def compute_multisets(fine: np.ndarray, factor: Sequence[int]
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Multisets of ``fine`` labels per ``factor`` pooling window.

    Returns (offsets[n+1], ids[m], counts[m]) over the C-ordered coarse
    voxels; ids are sorted within each voxel.  Windows at the upper border
    are padded by edge replication and the pad contributions removed from
    the counts, so border voxels carry exactly their real fine voxels.
    """
    from .downscaling import pooling_windows

    out_shape = tuple(-(-s // f) for s, f in zip(fine.shape, factor))
    w = int(np.prod(factor))
    windows = pooling_windows(fine, factor, out_shape).reshape(-1, w)
    # pad-tracking: count only real voxels
    rmask = pooling_windows(np.ones(fine.shape, "int64"), factor,
                            out_shape, pad_mode="constant").reshape(-1, w)
    n, w = windows.shape
    order = np.argsort(windows, axis=1, kind="stable")
    sw = np.take_along_axis(windows, order, axis=1)
    sm = np.take_along_axis(rmask, order, axis=1)
    # run starts within each row
    first = np.ones((n, w), bool)
    first[:, 1:] = sw[:, 1:] != sw[:, :-1]
    # real-voxel count per run via prefix sums of the mask
    csum = np.cumsum(sm, axis=1)
    run_start_flat = np.flatnonzero(first.ravel())
    row = run_start_flat // w
    ends = np.r_[run_start_flat[1:], [n * w]]
    # runs never cross rows (first[:,0] is always True)
    ends = np.where(np.r_[row[1:] != row[:-1], [True]],
                    (row + 1) * w, ends)
    csum_flat = csum.ravel()
    total_at_end = csum_flat[ends - 1]
    prev = run_start_flat - 1
    total_before = np.where(run_start_flat % w == 0, 0, csum_flat[prev])
    counts = total_at_end - total_before
    ids = sw.ravel()[run_start_flat]
    keep = counts > 0  # runs made purely of pad voxels
    ids, counts, row = ids[keep], counts[keep], row[keep]
    offsets = np.zeros(n + 1, "int64")
    np.add.at(offsets, row + 1, 1)
    offsets = np.cumsum(offsets)
    return offsets, ids.astype("uint64"), counts.astype("int64")


def pack_multiset_block(offsets: np.ndarray, ids: np.ndarray,
                        counts: np.ndarray) -> np.ndarray:
    n = len(offsets) - 1
    return np.concatenate([
        np.asarray([n], "uint64"), offsets.astype("uint64"),
        ids.astype("uint64"), counts.astype("uint64")])


def unpack_multiset_block(flat: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    n = int(flat[0])
    offsets = flat[1:n + 2].astype("int64")
    m = int(offsets[-1])
    ids = flat[n + 2:n + 2 + m]
    counts = flat[n + 2 + m:n + 2 + 2 * m].astype("int64")
    return offsets, ids, counts


def merge_multisets(entries, n_parents: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Union child multisets into parent multisets (exact: pooling windows
    partition the volume, so summing child counts per id is byte-identical
    to recomputing from level 0).

    ``entries`` = iterable of (parent_voxel_indices[int64], ids, counts)
    flat triples.  Returns (offsets[n_parents + 1], ids, counts) sorted by
    (parent, id).
    """
    all_parents, all_ids, all_counts = [], [], []
    for parent_vox, ids, counts in entries:
        all_parents.append(parent_vox)
        all_ids.append(ids)
        all_counts.append(counts)
    if not all_parents:
        return np.zeros(n_parents + 1, "int64"), \
            np.zeros(0, "uint64"), np.zeros(0, "int64")
    parents = np.concatenate(all_parents)
    ids = np.concatenate(all_ids)
    counts = np.concatenate(all_counts)
    order = np.lexsort((ids, parents))
    parents, ids, counts = parents[order], ids[order], counts[order]
    first = np.ones(len(parents), bool)
    first[1:] = (parents[1:] != parents[:-1]) | (ids[1:] != ids[:-1])
    starts = np.flatnonzero(first)
    merged_counts = np.add.reduceat(counts, starts)
    merged_ids = ids[starts]
    merged_parents = parents[starts]
    offsets = np.zeros(n_parents + 1, "int64")
    np.add.at(offsets, merged_parents + 1, 1)
    return np.cumsum(offsets), merged_ids, merged_counts.astype("int64")


class LabelMultisetTask(BlockTask):
    """One multiset scale level, blockwise over the COARSE grid.

    From a dense label volume (``input_is_multiset=False``): read the fine
    window, compute per-voxel multisets.  From the previous multiset level
    (``input_is_multiset=True``, ``scale_factor`` = the RELATIVE factor):
    union the child voxels' multisets per parent voxel — exact and far
    cheaper than re-reading level 0 (the fine window grows with the
    cumulative factor cubed)."""

    task_name = "label_multisets"

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str, scale_factor: ScaleFactor,
                 effective_factor: Optional[Sequence[int]] = None,
                 input_is_multiset: bool = False, identifier: str = "", **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.scale_factor = _factor3(scale_factor)
        self.effective_factor = list(effective_factor or self.scale_factor)
        self.input_is_multiset = input_is_multiset
        self.identifier = identifier
        super().__init__(**kw)

    def run_impl(self):
        if self.input_is_multiset:
            src = VarlenDataset(os.path.join(self.input_path,
                                             self.input_key),
                                dtype="uint64", mode="r")
            in_shape = list(src.attrs["multisetShape"])
        else:
            with file_reader(self.input_path, "r") as f:
                in_shape = list(f[self.input_key].shape)
        out_shape = [-(-s // f) for s, f in zip(in_shape, self.scale_factor)]
        block_shape = [min(b, s) for b, s in
                       zip(self.global_block_shape(), out_shape)]
        out = VarlenDataset(os.path.join(self.output_path, self.output_key),
                            dtype="uint64")
        out.attrs["isLabelMultiset"] = True
        out.attrs["downsamplingFactors"] = self.effective_factor[::-1]
        out.attrs["multisetShape"] = out_shape
        out.attrs["blockShape"] = block_shape
        block_list = self.blocks_in_volume(out_shape, block_shape)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "scale_factor": self.scale_factor,
            "input_is_multiset": self.input_is_multiset,
            "shape": out_shape, "block_shape": block_shape,
            "in_shape": in_shape,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        factor = cfg["scale_factor"]
        out = VarlenDataset(os.path.join(cfg["output_path"],
                                         cfg["output_key"]), dtype="uint64")
        if cfg.get("input_is_multiset"):
            cls._merge_level_job(job_config, blocking, factor, out, log_fn)
            return
        f_in = file_reader(cfg["input_path"], "r")
        ds = f_in[cfg["input_key"]]
        for block_id in job_config["block_list"]:
            block = blocking.get_block(block_id)
            fine_bb = tuple(slice(b.start * f, min(b.stop * f, s))
                            for b, f, s in zip(block.bb, factor,
                                               cfg["in_shape"]))
            offsets, ids, counts = compute_multisets(
                np.asarray(ds[fine_bb]), factor)
            out.write_chunk((block_id,),
                            pack_multiset_block(offsets, ids, counts))
            log_fn(f"processed block {block_id}")

    @staticmethod
    def _merge_level_job(job_config, blocking, factor, out, log_fn):
        cfg = job_config["config"]
        child_shape = cfg["in_shape"]
        src = VarlenDataset(os.path.join(cfg["input_path"],
                                         cfg["input_key"]),
                            dtype="uint64", mode="r")
        child_bs = src.attrs["blockShape"]
        child_blocking = Blocking(child_shape, child_bs)

        for block_id in job_config["block_list"]:
            block = blocking.get_block(block_id)
            child_bb = [(b.start * f, min(b.stop * f, s))
                        for b, f, s in zip(block.bb, factor, child_shape)]
            pshape = [b.stop - b.start for b in block.bb]
            n_parents = int(np.prod(pshape))
            entries = []
            for cbid in child_blocking.blocks_in_roi(
                    [lo for lo, _ in child_bb], [hi for _, hi in child_bb]):
                flat = src.read_chunk((cbid,))
                if flat is None:
                    continue
                coffsets, cids, ccounts = unpack_multiset_block(flat)
                cblock = child_blocking.get_block(cbid)
                # per-axis 1-D coords broadcast to the block's C-order
                # voxel grid (no dense meshgrids)
                ax_coord = [np.arange(b.start, b.stop) for b in cblock.bb]
                ax_inside = [(c >= lo) & (c < hi)
                             for c, (lo, hi) in zip(ax_coord, child_bb)]
                ax_parent = [c // f - b.start
                             for c, f, b in zip(ax_coord, factor, block.bb)]
                inside = (ax_inside[0][:, None, None]
                          & ax_inside[1][None, :, None]
                          & ax_inside[2][None, None, :])
                pidx = ((ax_parent[0][:, None, None] * pshape[1]
                         + ax_parent[1][None, :, None]) * pshape[2]
                        + ax_parent[2][None, None, :])
                # expand per-voxel offsets to per-entry rows
                lens = np.diff(coffsets)
                vox_of_entry = np.repeat(np.arange(len(lens)), lens)
                keep = inside.ravel()[vox_of_entry]
                entries.append((pidx.ravel()[vox_of_entry[keep]],
                                cids[keep], ccounts[keep]))
            offsets, ids, counts = merge_multisets(entries, n_parents)
            out.write_chunk((block_id,),
                            pack_multiset_block(offsets, ids, counts))
            log_fn(f"processed block {block_id}")


def load_multiset_block(path: str, key: str, block_id: int,
                        ds: Optional[VarlenDataset] = None):
    """(offsets, ids, counts) of one coarse block, or None if absent.
    Pass a pre-opened ``ds`` when reading many blocks."""
    if ds is None:
        ds = VarlenDataset(os.path.join(path, key), dtype="uint64",
                           mode="r")
    flat = ds.read_chunk((block_id,))
    if flat is None:
        return None
    return unpack_multiset_block(flat)


class LabelMultisetWorkflow(Task):
    """Pyramid of multiset levels from a full-resolution label dataset:
    level 1 pools the dense labels; level k > 1 unions level k-1's
    multisets per window — exact counts (pooling windows partition the
    volume) without re-reading the cumulative-factor-cubed fine window."""

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_prefix: str, scale_factors: Sequence[ScaleFactor],
                 tmp_folder: str, config_dir: str, max_jobs: int = 1,
                 target: str = "gpu", dependency: Optional[Task] = None):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_prefix = output_prefix
        self.scale_factors = [_factor3(s) for s in scale_factors]
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def requires(self):
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                      max_jobs=self.max_jobs, target=self.target)
        dep = self.dependency
        cumulative = [1, 1, 1]
        prev_key = None
        for scale, factor in enumerate(self.scale_factors):
            cumulative = [c * f for c, f in zip(cumulative, factor)]
            key = os.path.join(self.output_prefix, f"s{scale + 1}")
            if prev_key is None:
                dep = LabelMultisetTask(
                    input_path=self.input_path, input_key=self.input_key,
                    output_path=self.output_path, output_key=key,
                    scale_factor=factor,
                    effective_factor=list(cumulative),
                    identifier=f"s{scale + 1}", dependency=dep, **common)
            else:
                dep = LabelMultisetTask(
                    input_path=self.output_path, input_key=prev_key,
                    output_path=self.output_path, output_key=key,
                    scale_factor=factor,
                    effective_factor=list(cumulative),
                    input_is_multiset=True,
                    identifier=f"s{scale + 1}", dependency=dep, **common)
            prev_key = key
        return dep

    def output(self):
        return FileTarget(os.path.join(
            self.tmp_folder,
            f"label_multisets_s{len(self.scale_factors)}.status"))
