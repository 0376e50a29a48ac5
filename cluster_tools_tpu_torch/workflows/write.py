"""Generic assignment-writing task (terminal step of most segmentation
workflows).

Re-specification of the reference's ``write/`` component (write/write.py:28 —
apply a node->segment assignment table to a fragment volume, blockwise,
optionally with per-block label offsets; writes the ``maxId`` attribute).
The table lookup itself is a flat gather — bandwidth-bound, done on host next
to the IO; device acceleration buys nothing here.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict, Optional

import numpy as np

from ..core.blocking import Blocking
from ..core.runtime import BlockTask
from ..core.storage import file_reader


def load_assignments(path: str, key: Optional[str]) -> np.ndarray:
    """Load a dense assignment table: npy, pickled dict (sparse), or a 1d/2d
    dataset in a container (reference: write/write.py:237-266)."""
    if path.endswith(".npy"):
        table = np.load(path)
    elif path.endswith(".pkl"):
        with open(path, "rb") as f:
            d = pickle.load(f)
        n = max(d.keys()) + 1
        table = np.arange(n, dtype="uint64")
        table[list(d.keys())] = list(d.values())
    else:
        with file_reader(path, "r") as f:
            table = f[key][...]
    if table.ndim == 2 and table.shape[1] == 2:
        # pairwise (id, new_id) rows; keep sparse (ids can be huge after
        # per-block offsetting: block_id * prod(block_shape), reference
        # watershed.py:307) and apply via searchsorted
        order = np.argsort(table[:, 0], kind="stable")
        table = table[order]
    return table.astype("uint64", copy=False)


def apply_assignment_table(seg: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Apply a dense (1d lookup) or sparse (sorted (id, new_id) pairs)
    assignment table to a fragment array (reference: nifty.tools.takeDict /
    take usage in write/_apply_node_labels)."""
    if table.ndim == 1:
        if seg.max() >= table.size:
            raise ValueError(
                f"fragment id {int(seg.max())} outside assignment table "
                f"of size {table.size}")
        return table[seg]
    idx = np.searchsorted(table[:, 0], seg)
    if (idx >= table.shape[0]).any() or (table[idx.ravel(), 0] != seg.ravel()).any():
        missing = seg.ravel()[table[np.minimum(idx.ravel(), table.shape[0] - 1), 0]
                              != seg.ravel()][:5]
        raise ValueError(f"fragment ids missing from sparse table: {missing}")
    return table[idx, 1]


def rewrite_blocks(input_path: str, input_key: str, output_path: str,
                   output_key: str, table: np.ndarray, block_ids,
                   block_shape, log_fn=None) -> int:
    """Rewrite ONLY ``block_ids`` of the output through ``table`` — the
    fused-write path (staged-fragment cache first, store read as the
    fallback, host-map gather, store write) callable outside the task
    graph.  The edits/ assignment patcher uses this to refresh exactly
    the blocks an edit touched; every other output block stays as
    written by the bulk workflow."""
    import time

    from ..core.runtime import stage, stage_add, stage_bytes
    from .fused_pipeline import fragment_cache_get

    in_place = (input_path == output_path and input_key == output_key)
    f_in = file_reader(input_path, "a" if in_place else "r")
    f_out = f_in if in_place else file_reader(output_path)
    ds_in, ds_out = f_in[input_key], f_out[output_key]
    blocking = Blocking(list(ds_in.shape), list(block_shape))
    for block_id in block_ids:
        bb = blocking.get_block(block_id).bb
        ent = fragment_cache_get(input_path, input_key, block_id,
                                 expect_bb=bb)
        if ent is not None:
            local, f_off, _ = ent
            seg = local.astype("uint64")
            seg[seg > 0] += np.uint64(f_off)
        else:
            with stage("store-read"):
                seg = ds_in[bb].astype("uint64")
            stage_bytes("store-read", seg.nbytes)
        with stage("host-map"):
            out = apply_assignment_table(seg, table)
        t0 = time.perf_counter()
        ds_out[bb] = out
        stage_add("store-write", time.perf_counter() - t0)
        stage_bytes("store-write", out.nbytes)
        if log_fn:
            log_fn(f"rewrote block {block_id}")
    return len(list(block_ids))


class WriteAssignments(BlockTask):
    """Map fragment ids through an assignment table, blockwise.

    Constructor params: input_path/input_key (fragments), output_path/
    output_key, assignment_path[/assignment_key], optional offsets_path (the
    per-block offset JSON produced by merge-offset steps).  ``identifier``
    distinguishes multiple writes in one workflow (reference: the ws/
    multicut/filtered write steps all reuse this task).
    """

    task_name = "write"

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str, assignment_path: str,
                 assignment_key: Optional[str] = None,
                 offsets_path: Optional[str] = None, identifier: str = "", **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.assignment_path = assignment_path
        self.assignment_key = assignment_key
        self.offsets_path = offsets_path
        self.identifier = identifier
        super().__init__(**kw)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        # writer_threads sizes the map+write pool (0 = strictly
        # sequential; forced to 0 for in-place writes, 1 for HDF5)
        conf.update({"chunks": None, "writer_threads": 4})
        return conf

    def run_impl(self):
        block_shape = self.global_block_shape()
        with file_reader(self.input_path, "r") as f:
            shape = f[self.input_key].shape
        ndim = len(shape)
        block_shape = block_shape[-ndim:] if len(block_shape) >= ndim else block_shape
        chunks = self.task_config.get("chunks") or block_shape
        with file_reader(self.output_path) as f:
            # segmentations compress ~100x at gzip-1; write time drops
            # below the assignment-mapping cost
            f.require_dataset(self.output_key, shape=shape, chunks=chunks,
                              dtype="uint64", compression="gzip")
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "assignment_path": self.assignment_path,
            "assignment_key": self.assignment_key,
            "offsets_path": self.offsets_path,
            "shape": list(shape), "block_shape": list(block_shape),
        }, n_jobs=self.max_jobs)
        # maxId attribute for downstream consumers (reference: write.py:269-277)
        table = load_assignments(self.assignment_path, self.assignment_key)
        max_id = int(table[:, 1].max()) if table.ndim == 2 else int(table.max())
        with file_reader(self.output_path) as f:
            f[self.output_key].attrs["maxId"] = max_id
        # the write is the terminal consumer of the fused chain's in-RAM
        # staging; release it so long-lived drivers don't pin the volume
        from .fused_pipeline import clear_caches

        clear_caches()

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        import time

        from ..core.runtime import stage, stage_add, stage_bytes, writer_pool

        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        table = load_assignments(cfg["assignment_path"], cfg.get("assignment_key"))
        offsets = None
        if cfg.get("offsets_path"):
            with open(cfg["offsets_path"]) as f:
                offsets = json.load(f)["offsets"]
        in_place = (cfg["input_path"] == cfg["output_path"]
                    and cfg["input_key"] == cfg["output_key"])
        f_in = file_reader(cfg["input_path"], "r" if not in_place else "a")
        f_out = f_in if in_place else file_reader(cfg["output_path"])
        ds_in, ds_out = f_in[cfg["input_key"]], f_out[cfg["output_key"]]

        from .fused_pipeline import fragment_cache_get

        def _write(bb, out):
            t0 = time.perf_counter()
            ds_out[bb] = out
            stage_add("store-write", time.perf_counter() - t0)
            stage_bytes("store-write", out.nbytes)

        def _map_cached(block_id, bb, local, f_off):
            """Fused-drain write path: gather the block's assignments
            through a BLOCK-LOCAL slice of the table (k+1 entries, cache
            resident) over the staged uint16/32 fragments — one pass over
            the output instead of three volume-sized temporaries
            (offset-add, zeros, global gather), and no store re-read."""
            with stage("host-map"):
                k = int(local.max())
                if f_off + k >= table.size:
                    raise ValueError(
                        f"fragment id {f_off + k} outside assignment "
                        f"table of size {table.size}")
                lut = np.empty(k + 1, "uint64")
                lut[0] = table[0]  # background
                lut[1:] = table[f_off + 1:f_off + k + 1]
                out = lut[local]
            _write(bb, out)
            log_fn(f"processed block {block_id}")

        def _map_general(block_id, bb, seg):
            with stage("host-map"):
                out = apply_assignment_table(seg, table)
            _write(bb, out)
            log_fn(f"processed block {block_id}")

        # sized writer pool: tensorstore's gzip+IO releases the GIL, so N
        # blocks compress/write concurrently while the main thread walks
        # the cache — the final write was a fully serial ~10 s tail after
        # the (0.3 s) solve in the r4/r5 benches.  In-place jobs run
        # strictly sequentially: overlapping the write of block i with
        # the read of block i+1 can tear a chunk spanning both blocks
        # when the chunk grid is not block-aligned (ADVICE r5)
        with writer_pool(cfg, ds_out, sequential=in_place) as pool:
            for block_id in job_config["block_list"]:
                bb = blocking.get_block(block_id).bb
                # the fused pass stages fragments in RAM (same process) —
                # no store re-read on the flagship path (r3: 25.7 s)
                ent = fragment_cache_get(cfg["input_path"],
                                         cfg["input_key"], block_id,
                                         expect_bb=bb)
                if ent is not None and table.ndim == 1 and offsets is None:
                    local, f_off, _ = ent
                    pool.submit(_map_cached, block_id, bb, local,
                                int(f_off))
                    continue
                if ent is not None:
                    local, f_off, _ = ent
                    seg = local.astype("uint64")
                    seg[seg > 0] += np.uint64(f_off)
                else:
                    with stage("store-read"):
                        seg = ds_in[bb].astype("uint64")
                    stage_bytes("store-read", seg.nbytes)
                if offsets is not None:
                    off = np.uint64(offsets[block_id])
                    seg[seg != 0] += off
                pool.submit(_map_general, block_id, bb, seg)
