"""Blockwise mutex watershed over long-range affinities.

Port of cluster_tools_tpu/workflows/mutex_watershed.py (the reference's
``mutex_watershed/`` package: mws_blocks.py:136-174,
two_pass_mws.py:100-280, two_pass_assignments.py:26, mws_workflow.py).
Two stitching strategies, as in the reference:

* **MwsWorkflow** — independent per-block MWS with per-block label offsets
  and a consecutive relabel; no stitching (block boundaries stay cuts).
* **TwoPassMwsWorkflow** — checkerboard two-pass: pass-1 blocks run plain
  MWS; pass-2 blocks run *seeded* MWS where the halo-visible pass-1 labels
  act as seeds, and the (segment, seed) co-occurrences are reconciled by a
  global union-find into one assignment table.

Two block paths, chosen per task by ``impl`` (task config; ``"auto"``
by default):

* ``"device"`` — the affinity volume is uploaded once to the task's
  device (the global config's ``"device"``, default ``"cuda"``), and each
  block's grid edges are extracted and sorted there
  (``ops.mws._sorted_edges_resident``); the host runs only the C++
  union-find scan, on block i while the device sorts block i+1 (with the
  ``threads`` target the scans of the jobs also overlap each other: the
  solver call releases the interpreter lock);
* ``"host"`` — per-block numpy edge extraction and the C++ Kruskal
  (``ops.mws.mutex_watershed_segmentation``), with masks, noise and
  randomized strides.

``"auto"`` takes the device path on a CUDA device for blocks without a
mask, noise or randomized strides, and the host path otherwise.  Both
give identical labels on the deterministic cases.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..core.blocking import Blocking
from ..core.device import task_device
from ..core.runtime import BlockTask
from ..core.storage import file_reader
from ..core.workflow import FileTarget, Task
from .relabel import RelabelWorkflow
from .write import WriteAssignments


def normalize(data: np.ndarray,
              mx: Optional[float] = None) -> np.ndarray:
    """Affinities to float32 in [0, 1]; integer dtypes scale by their dtype
    range (reference vu.normalize, utils/volume_utils.py:113-120).

    ``mx`` pins the scale for float inputs: blockwise callers MUST pass
    the volume-global max so per-block normalization matches the
    device-resident path, which normalizes the whole volume at once."""
    if np.issubdtype(data.dtype, np.integer):
        return data.astype("float32") / np.iinfo(data.dtype).max
    data = data.astype("float32")
    mx = float(data.max()) if mx is None else float(mx)
    return data / np.float32(mx) if mx > 1.0 else data


def _chunked_max(ds, slab_voxels: int = 1 << 26) -> float:
    """Volume-global max with BOUNDED memory: one z-slab of the (channel,
    z, y, x) dataset at a time — never the full volume."""
    shape = tuple(ds.shape)
    if 0 in shape:
        return 0.0
    per_row = int(np.prod(shape[:1] + shape[2:]))
    rows = max(int(slab_voxels // max(per_row, 1)), 1)
    mx = -np.inf
    for z0 in range(0, shape[1], rows):
        z1 = min(z0 + rows, shape[1])
        mx = max(mx, float(np.max(ds[(slice(None), slice(z0, z1))])))
    return mx


def _mask_own_color(seeds: np.ndarray, blocking: Blocking, block_id: int,
                    outer_bb, block_shape) -> np.ndarray:
    """Zero the seeds of voxels owned by blocks of ``block_id``'s own
    checkerboard color: only the *other* color carries finished pass-1
    labels, and same-color halos may be written concurrently by other
    jobs (masking them removes the read race and makes the result
    order-independent; the reference leaves this as a TODO,
    two_pass_mws.py:212-215)."""
    own_color = sum(blocking.block_grid_position(block_id)) % 2
    grids = np.meshgrid(*[np.arange(b.start, b.stop) // bs
                          for b, bs in zip(outer_bb, block_shape)],
                        indexing="ij")
    owner_color = sum(grids) % 2
    seeds[owner_color == own_color] = 0
    return seeds


def _compact_block(seg: np.ndarray, block_id: int, offset_unit: int):
    """Compact the full (outer) labeling so halo-only segments keep valid
    global ids for the seed assignments, then offset by the block's id
    budget; returns (global labels, sorted nonzero local ids)."""
    nonzero = np.unique(seg[seg > 0])
    if len(nonzero) >= offset_unit:
        raise RuntimeError(
            f"block {block_id}: {len(nonzero)} labels exceed the "
            f"per-block offset budget {offset_unit}")
    compact = np.searchsorted(nonzero, seg).astype("uint64")
    compact += np.uint64(block_id * offset_unit + 1)
    compact[seg == 0] = 0
    return compact, nonzero


def _save_pairs(tmp_folder: str, block_id: int, pairs: np.ndarray) -> None:
    np.save(os.path.join(tmp_folder,
                         f"mws_two_pass_assignments_block_{block_id}.npy"),
            pairs)


class _SortedBlock:
    """A submitted block of the device path: its sorted edge stream and
    affinity sum, copied into pinned host buffers right after the sort
    (so the copies of block i are queued before block i+1's sort), with
    one event after the sort and one after the copies."""

    def __init__(self, u, vp, asum):
        if u.device.type == "cuda":
            self.sorted = torch.cuda.Event()
            self.sorted.record()
            self.u = torch.empty(u.shape, dtype=u.dtype, pin_memory=True)
            self.vp = torch.empty(vp.shape, dtype=vp.dtype, pin_memory=True)
            self.asum = torch.empty((), dtype=asum.dtype, pin_memory=True)
            self.u.copy_(u, non_blocking=True)
            self.vp.copy_(vp, non_blocking=True)
            self.asum.copy_(asum, non_blocking=True)
            self.copied = torch.cuda.Event()
            self.copied.record()
        else:
            self.sorted = self.copied = None
            self.u, self.vp, self.asum = u, vp, asum

    def wait_sorted(self) -> None:
        if self.sorted is not None:
            self.sorted.synchronize()

    def wait_copied(self) -> None:
        if self.copied is not None:
            self.copied.synchronize()


#: device-resident normalized affinity volume, shared by the pass-1 and
#: pass-2 tasks of one workflow process; keyed on (path, key, device) and
#: cleared when the first task of a workflow starts or another volume
#: arrives
_AFFS_DEV_CACHE: Dict = {}
_AFFS_DEV_LOCK = threading.Lock()


class MwsBlocksBase(BlockTask):
    """Shared machinery for the single-pass and two-pass MWS block tasks."""

    # pass_id: None = all blocks (single pass); 0/1 = checkerboard color
    pass_id: Optional[int] = None
    seeded: bool = False

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str, offsets: Sequence[Sequence[int]],
                 halo: Optional[Sequence[int]] = None,
                 mask_path: str = "", mask_key: str = "", **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.offsets = [list(o) for o in offsets]
        self.halo = list(halo) if halo is not None else None
        self.mask_path = mask_path
        self.mask_key = mask_key
        super().__init__(**kw)
        # target="mesh" runs inline, as in the JAX package (the mutex
        # watershed has no mesh formulation)
        self.device = task_device(self.global_config)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"strides": [1, 1, 1], "randomize_strides": False,
                     "noise_level": 0.0, "impl": "auto"})
        return conf

    def run_impl(self):
        if not self.seeded:
            # a new workflow starts: the store may hold new affinities
            with _AFFS_DEV_LOCK:
                _AFFS_DEV_CACHE.clear()
        global_max = None
        with file_reader(self.input_path, "r") as f:
            ds = f[self.input_key]
            shape = list(ds.shape)
            if (self.task_config.get("impl") == "host"
                    and not np.issubdtype(np.dtype(ds.dtype), np.integer)):
                # float inputs need the VOLUME-global max so per-block host
                # normalization matches the device-resident path; one
                # chunked scan here, reused by every job via the config
                global_max = _chunked_max(ds)
        if len(shape) != 4:
            raise ValueError("need 4d (channel, spatial...) input for MWS")
        n_channels, shape = shape[0], shape[1:]
        if n_channels != len(self.offsets):
            raise ValueError(f"{n_channels} channels for "
                             f"{len(self.offsets)} offsets")
        block_shape = self.global_block_shape()[-len(shape):]
        with file_reader(self.output_path) as f:
            f.require_dataset(self.output_key, shape=shape, chunks=block_shape,
                              dtype="uint64")
        block_list = self.blocks_in_volume(shape, block_shape)
        if self.pass_id is not None:
            colors = Blocking(shape, block_shape).checkerboard()
            allowed = set(block_list)
            block_list = [b for b in colors[self.pass_id] if b in allowed]
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "offsets": self.offsets, "halo": self.halo,
            "mask_path": self.mask_path, "mask_key": self.mask_key,
            "shape": shape, "block_shape": block_shape,
            "seeded": self.seeded, "global_max": global_max,
            "device": self.device,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from ..core.device import resolve_device
        from ..ops.mws import mutex_watershed_segmentation

        cfg = job_config["config"]
        device = resolve_device(cfg["device"])
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        halo = cfg["halo"]
        seeded = cfg["seeded"]
        f_in = file_reader(cfg["input_path"], "r")
        f_out = file_reader(cfg["output_path"])
        ds_in, ds_out = f_in[cfg["input_key"]], f_out[cfg["output_key"]]
        mask = None
        if cfg.get("mask_path"):
            from ..core.volume_views import load_mask

            mask = load_mask(cfg["mask_path"], cfg["mask_key"], cfg["shape"])

        # the per-block id budget must cover the halo-enlarged outer block:
        # labels are compacted over the full outer region so halo-only
        # segments keep valid global ids for the seed assignments
        outer_shape = (cfg["block_shape"] if halo is None else
                       [b + 2 * h for b, h in zip(cfg["block_shape"], halo)])
        offset_unit = int(np.prod(outer_shape))

        impl = cfg.get("impl", "auto")
        if impl == "auto":
            # the device sort pays off on the card; on the CPU device the
            # host C++ path is the faithful baseline
            impl = ("device" if (device.type == "cuda"
                                 and mask is None
                                 and not cfg.get("noise_level")
                                 and not cfg.get("randomize_strides"))
                    else "host")
        if impl not in ("host", "device"):
            raise ValueError(f"unknown impl {impl!r} (host, device, auto)")
        if impl == "device" and (mask is not None or cfg.get("noise_level")
                                 or cfg.get("randomize_strides")):
            raise ValueError("impl='device' takes no mask, noise or "
                             "randomized strides; use impl='host' or "
                             "'auto'")
        if impl == "device" and offset_unit >= (1 << 29):
            # the device edge stream packs partner indices into 29 bits
            # (ops/mws._sorted_edges_device); oversized outer blocks
            # route to the always-correct host path
            log_fn(f"outer block of {offset_unit} voxels exceeds the "
                   "2^29 packed-edge budget; using the host path")
            impl = "host"
        if impl == "device":
            return cls._process_device_sorted(job_config, log_fn, blocking,
                                              ds_in, ds_out, cfg, device)

        # normalization parity with the device-resident path (which
        # normalizes the WHOLE volume at once): float inputs need the
        # volume-global max — from run_impl's scan when impl='host' was
        # pinned, else one lazy chunked scan per job
        global_mx = cfg.get("global_max")
        if global_mx is None and not np.issubdtype(
                np.dtype(ds_in.dtype), np.integer):
            global_mx = _chunked_max(ds_in)

        for block_id in job_config["block_list"]:
            if halo is None:
                block = blocking.get_block(block_id)
                outer_bb = inner_bb = block.bb
                local_bb = tuple(slice(None) for _ in cfg["shape"])
            else:
                bh = blocking.get_block_with_halo(block_id, halo)
                outer_bb, inner_bb = bh.outer.bb, bh.inner.bb
                local_bb = bh.inner_local.bb
            bb_mask = None
            if mask is not None:
                bb_mask = np.asarray(mask[outer_bb]) > 0
                if not bb_mask.any():
                    log_fn(f"processed block {block_id}")
                    continue
            affs = normalize(ds_in[(slice(None),) + outer_bb],
                             mx=global_mx)
            if affs.sum() == 0:
                log_fn(f"processed block {block_id}")
                continue
            seeds = None
            if seeded:
                seeds = _mask_own_color(np.asarray(ds_out[outer_bb]),
                                        blocking, block_id, outer_bb,
                                        cfg["block_shape"])
            seg, seed_assignments = mutex_watershed_segmentation(
                affs, cfg["offsets"], strides=cfg.get("strides"),
                randomize_strides=cfg.get("randomize_strides", False),
                mask=bb_mask, noise_level=cfg.get("noise_level", 0.0),
                seed=block_id, seeds=seeds, return_seed_assignments=True,
                device=str(device))
            compact, nonzero = _compact_block(seg, block_id, offset_unit)
            ds_out[inner_bb] = compact[local_bb]
            if seeded and len(seed_assignments):
                # map the local segment column through compact+offset
                # (reference: two_pass_mws.py:282-292 filters to crop ids)
                seg_col = (np.searchsorted(
                    nonzero, seed_assignments[:, 0]).astype("uint64")
                    + np.uint64(block_id * offset_unit + 1))
                pairs = np.stack(
                    [seg_col, seed_assignments[:, 1].astype("uint64")], axis=1)
                _save_pairs(job_config["tmp_folder"], block_id, pairs)
            log_fn(f"processed block {block_id}")

    @classmethod
    def _process_device_sorted(cls, job_config, log_fn, blocking, ds_in,
                               ds_out, cfg, device):
        """Resident device-sort pipeline: the affinity volume uploads ONCE
        (kept on the device across the pass-1/pass-2 tasks of one
        workflow process), each block's grid edges are extracted from its outer
        window and sorted by descending priority on the device
        (ops/mws._sorted_edges_resident), and the host runs only the
        sequential union-find scan — on block i while the device sorts
        block i+1."""
        from ..core.runtime import stage, stage_bytes
        from ..ops.mws import (_sorted_edges_resident,
                               mutex_watershed_scan_sorted)

        halo = cfg["halo"]
        seeded = cfg["seeded"]
        offsets = [[int(o) for o in off] for off in cfg["offsets"]]
        strides = [int(s) for s in (cfg.get("strides") or [1, 1, 1])]
        key = (os.path.abspath(cfg["input_path"]), cfg["input_key"],
               str(device))
        # jobs of the threads target share one upload
        with _AFFS_DEV_LOCK:
            affs_dev = _AFFS_DEV_CACHE.get(key)
            if affs_dev is None:
                with stage("store-read"):
                    affs_host = normalize(ds_in[...])
                with stage("h2d-upload"):
                    affs_dev = torch.from_numpy(affs_host).to(device)
                stage_bytes("h2d-upload", affs_host.nbytes)
                _AFFS_DEV_CACHE.clear()   # one resident volume at a time
                _AFFS_DEV_CACHE[key] = affs_dev

        block_meta = {}
        for block_id in job_config["block_list"]:
            if halo is None:
                block = blocking.get_block(block_id)
                block_meta[block_id] = (
                    block.bb, block.bb,
                    tuple(slice(None) for _ in cfg["shape"]))
            else:
                bh = blocking.get_block_with_halo(block_id, halo)
                block_meta[block_id] = (bh.outer.bb, bh.inner.bb,
                                        bh.inner_local.bb)
        offset_unit = int(np.prod(
            cfg["block_shape"] if halo is None else
            [b + 2 * h for b, h in zip(cfg["block_shape"], halo)]))

        def submit(block_id):
            outer_bb = block_meta[block_id][0]
            seeds = None
            if seeded:
                with stage("store-read"):
                    seeds = np.asarray(ds_out[outer_bb])
                seeds = _mask_own_color(seeds, blocking, block_id, outer_bb,
                                        cfg["block_shape"])
            with stage("dispatch"):
                res = _SortedBlock(*_sorted_edges_resident(
                    affs_dev, [s.start for s in outer_bb],
                    [s.stop - s.start for s in outer_bb], offsets, strides,
                    seeds))
            return res, seeds

        def drain(block_id, res, seeds):
            outer_bb, inner_bb, local_bb = block_meta[block_id]
            shape_o = tuple(s.stop - s.start for s in outer_bb)
            # three separately-attributed phases: the wait for the device
            # sort (sync-execute), the edge-stream download (d2h-edges),
            # and the sequential host C++ union-find scan (host-scan)
            with stage("sync-execute"):
                res.wait_sorted()
            with stage("d2h-edges"):
                res.wait_copied()
                asum = float(res.asum)
                u = res.u.numpy()
                vp = res.vp.numpy()
            stage_bytes("d2h-edges", u.nbytes + vp.nbytes)
            if asum == 0.0:
                log_fn(f"processed block {block_id}")
                return
            with stage("host-scan"):
                seg = mutex_watershed_scan_sorted(u, vp, shape_o)
            compact, _ = _compact_block(seg, block_id, offset_unit)
            with stage("store-write"):
                ds_out[inner_bb] = compact[local_bb]
            stage_bytes("store-write", compact[local_bb].nbytes)
            if seeded and seeds is not None and (seeds != 0).any():
                sflat = seeds.reshape(-1)
                lflat = compact.reshape(-1)
                sel = sflat != 0
                pairs = np.unique(np.stack(
                    [lflat[sel], sflat[sel].astype("uint64")], axis=1),
                    axis=0)
                _save_pairs(job_config["tmp_folder"], block_id,
                            pairs[pairs[:, 0] != 0])
            log_fn(f"processed block {block_id}")

        pending = None
        for block_id in job_config["block_list"]:
            res, seeds = submit(block_id)
            if pending is not None:
                drain(*pending)
            pending = (block_id, res, seeds)
        if pending is not None:
            drain(*pending)


class MwsBlocks(MwsBlocksBase):
    """Single-pass blockwise MWS (reference: mws_blocks.py)."""

    task_name = "mws_blocks"


class MwsPass1(MwsBlocksBase):
    """Checkerboard color-0 blocks, plain MWS (two_pass_mws.py pass 0)."""

    task_name = "mws_pass1"
    pass_id = 0


class MwsPass2(MwsBlocksBase):
    """Checkerboard color-1 blocks, seeded by pass-1 halo labels
    (two_pass_mws.py pass 1)."""

    task_name = "mws_pass2"
    pass_id = 1
    seeded = True


class TwoPassAssignments(BlockTask):
    """Global union-find over the pass-2 (segment, seed) pairs -> sparse
    consecutive assignment table (reference: two_pass_assignments.py:90-150,
    with the intermediate RelabelWorkflow folded in: the table domain is the
    set of ids actually present, collected by FindUniques)."""

    task_name = "two_pass_assignments"
    global_task = True
    allow_retry = False

    def __init__(self, assignment_path: str, uniques_prefix: str, **kw):
        self.assignment_path = assignment_path
        self.uniques_prefix = uniques_prefix
        super().__init__(**kw)

    def run_impl(self):
        self.run_jobs(None, {
            "tmp_root": self.tmp_folder,
            "uniques_prefix": self.uniques_prefix,
            "assignment_path": self.assignment_path,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from .. import native

        cfg = job_config["config"]
        tmp = cfg["tmp_root"]
        uniques = []
        prefix = cfg["uniques_prefix"] + "_out_"
        for name in os.listdir(tmp):
            if name.startswith(prefix) and name.endswith(".npy"):
                uniques.append(np.load(os.path.join(tmp, name)))
        ids = (np.unique(np.concatenate(uniques)) if uniques
               else np.zeros(0, "uint64"))
        if ids.size == 0 or ids[0] != 0:
            ids = np.concatenate([np.zeros(1, "uint64"), ids])
        pair_arrays = [np.zeros((0, 2), "uint64")]
        for name in os.listdir(tmp):
            if (name.startswith("mws_two_pass_assignments_block_")
                    and name.endswith(".npy")):
                pair_arrays.append(np.load(os.path.join(tmp, name)))
        pairs = np.concatenate(pair_arrays, axis=0)
        # pairs may mention halo-only segment ids absent from the volume;
        # include them as union-find nodes so transitive merges survive
        domain = np.unique(np.concatenate([ids, pairs.ravel()]))
        compact_pairs = np.searchsorted(domain, pairs)
        roots = native.ufd_merge_pairs(len(domain), compact_pairs)
        # consecutive relabel over the ids present in the volume, 0 stays 0
        vol_roots = roots[np.searchsorted(domain, ids)]
        nz_roots = vol_roots[ids != 0]
        uniq_roots = np.unique(nz_roots)
        new_ids = np.zeros(len(ids), dtype="uint64")
        new_ids[ids != 0] = np.searchsorted(uniq_roots, nz_roots) + 1
        table = np.stack([ids, new_ids], axis=1)
        np.save(cfg["assignment_path"], table)
        log_fn(f"merged {len(pairs)} seed pairs over {len(ids)} ids -> "
               f"{len(uniq_roots)} segments")


class _MwsWorkflowBase(Task):
    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str, offsets: Sequence[Sequence[int]],
                 tmp_folder: str, config_dir: str, max_jobs: int = 1,
                 target: str = "gpu", halo: Optional[Sequence[int]] = None,
                 mask_path: str = "", mask_key: str = "",
                 dependency: Optional[Task] = None):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.offsets = offsets
        self.halo = None if halo is None else list(halo)
        self.mask_path = mask_path
        self.mask_key = mask_key
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def _common(self):
        return dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                    max_jobs=self.max_jobs, target=self.target)

    def _block_kw(self):
        return dict(input_path=self.input_path, input_key=self.input_key,
                    output_path=self.output_path, output_key=self.output_key,
                    offsets=self.offsets, halo=self.halo,
                    mask_path=self.mask_path, mask_key=self.mask_key)


class MwsWorkflow(_MwsWorkflowBase):
    """MwsBlocks -> RelabelWorkflow (reference: mws_workflow.py:12-56)."""

    def requires(self):
        t1 = MwsBlocks(dependency=self.dependency, **self._block_kw(),
                       **self._common())
        return RelabelWorkflow(
            input_path=self.output_path, input_key=self.output_key,
            identifier="mws_relabel", dependency=t1, **self._common())

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder,
                                       "write_mws_relabel.status"))


class TwoPassMwsWorkflow(_MwsWorkflowBase):
    """MwsPass1 -> MwsPass2 (seeded) -> FindUniques -> TwoPassAssignments ->
    Write (reference: mws_workflow.py:59-125)."""

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str, offsets: Sequence[Sequence[int]],
                 halo: Sequence[int], tmp_folder: str, config_dir: str,
                 max_jobs: int = 1, target: str = "gpu",
                 mask_path: str = "", mask_key: str = "",
                 dependency: Optional[Task] = None):
        super().__init__(input_path, input_key, output_path, output_key,
                         offsets, tmp_folder, config_dir, max_jobs=max_jobs,
                         target=target, halo=halo, mask_path=mask_path,
                         mask_key=mask_key, dependency=dependency)

    def requires(self):
        from .relabel import FindUniques

        kw = self._block_kw()
        t1 = MwsPass1(dependency=self.dependency, **kw, **self._common())
        t2 = MwsPass2(dependency=t1, **kw, **self._common())
        t3 = FindUniques(input_path=self.output_path,
                         input_key=self.output_key,
                         identifier="two_pass_mws", dependency=t2,
                         **self._common())
        assignment_path = os.path.join(self.tmp_folder,
                                       "two_pass_mws_assignments.npy")
        t4 = TwoPassAssignments(assignment_path=assignment_path,
                                uniques_prefix=t3.name_with_id,
                                dependency=t3, **self._common())
        return WriteAssignments(
            input_path=self.output_path, input_key=self.output_key,
            output_path=self.output_path, output_key=self.output_key,
            assignment_path=assignment_path, identifier="two_pass_mws",
            dependency=t4, **self._common())

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder,
                                       "write_two_pass_mws.status"))
