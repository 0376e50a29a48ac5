"""Distributed connected components over a thresholded map (BASELINE
config 2).

Port of cluster_tools_tpu/workflows/thresholded_components.py (the
reference's ``thresholded_components/`` package): per-block CC (+ max id)
-> prefix-sum offsets -> face merges -> global union-find -> relabel +
write.  Two per-block paths:

* ``BlockComponents`` — batches of ``batch_size`` blocks, thresholded and
  masked, labelled on the task's device by hooking CC over a leading
  batch axis (ops/components.py), relabelled consecutively per block on
  the host (reference: skimage.label per block,
  block_components.py:143-180);
* ``ResidentBlockComponents`` — the volume uploads once; each block's
  window is sliced on the device, thresholded, labelled, densely
  relabelled (presence + cumsum rank) and run-length coded, so only runs
  cross the link; the host decodes, stages the block in the fragment
  cache (BlockFaces and the final write then compose from memory) and
  writes it on a writer thread.  Its single job folds the per-block max
  ids into the offsets JSON inline.

The global pair merge uses scipy's sparse CC over the face-pair graph.
The device is the global config's ``"device"`` (default ``"cuda"``);
``target="mesh"`` runs ``MeshBlockComponents`` (workflows/mesh_blockwise.py):
rounds of one block per shard device with the offset scan and the
round-adjacent faces on the devices.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.blocking import Blocking, iterate_faces
from ..core.config import ConfigDir, write_config
from ..core.device import task_device
from ..core.runtime import BlockTask
from ..core.storage import file_reader
from ..core.workflow import FileTarget, Task
from .write import WriteAssignments


def _write_offsets(path: str, max_ids: np.ndarray) -> None:
    """Exclusive prefix offsets, empty-block list and total label count
    of per-block max ids (reference: merge_offsets.py:100-137)."""
    offsets = np.zeros(len(max_ids), dtype="uint64")
    np.cumsum(max_ids[:-1], out=offsets[1:])
    write_config(path, {"offsets": offsets.tolist(),
                        "empty_blocks": np.nonzero(max_ids == 0)[0].tolist(),
                        "n_labels": int(max_ids.sum())})


class BlockComponents(BlockTask):
    """Threshold + per-block connected components (reference:
    block_components.py).  Writes per-block labels (1..max_id consecutive
    within the block) and a per-job JSON of block max-ids."""

    task_name = "block_components"

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str, threshold: float,
                 threshold_mode: str = "greater",
                 mask_path: str = "", mask_key: str = "", **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.mask_path = mask_path
        self.mask_key = mask_key
        super().__init__(**kw)
        self.device = task_device(self.global_config)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"connectivity": 1, "batch_size": 8, "channel": None})
        return conf

    def run_impl(self):
        with file_reader(self.input_path, "r") as f:
            shape = list(f[self.input_key].shape)
        if self.task_config.get("channel") is not None:
            shape = shape[1:]
        block_shape = self.global_block_shape()[-len(shape):]
        with file_reader(self.output_path) as f:
            f.require_dataset(self.output_key, shape=shape, chunks=block_shape,
                              dtype="uint64")
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "threshold": self.threshold, "threshold_mode": self.threshold_mode,
            "mask_path": self.mask_path, "mask_key": self.mask_key,
            "shape": shape, "block_shape": block_shape,
            "device": self.device,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from ..core.device import resolve_device
        from ..ops.components import (connected_components_batched,
                                      threshold_volume)

        cfg = job_config["config"]
        device = resolve_device(cfg["device"])
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        block_list = job_config["block_list"]
        connectivity = int(cfg.get("connectivity", 1))
        batch_size = max(int(cfg.get("batch_size", 8)), 1)
        channel = cfg.get("channel")

        f_in = file_reader(cfg["input_path"], "r")
        f_out = file_reader(cfg["output_path"])
        ds_in, ds_out = f_in[cfg["input_key"]], f_out[cfg["output_key"]]
        mask = None
        if cfg.get("mask_path"):
            from ..core.volume_views import load_mask

            mask = load_mask(cfg["mask_path"], cfg["mask_key"], cfg["shape"])

        max_ids: Dict[int, int] = {}
        bs = tuple(cfg["block_shape"])
        for i in range(0, len(block_list), batch_size):
            batch_ids = block_list[i:i + batch_size]
            # border blocks are padded with background to the uniform
            # batch shape (background cannot bridge components)
            masks = torch.zeros((len(batch_ids),) + bs, dtype=torch.bool,
                                device=device)
            blocks = [blocking.get_block(bid) for bid in batch_ids]
            for j, block in enumerate(blocks):
                bb = block.bb
                if channel is not None:
                    data = ds_in[(slice(channel, channel + 1),) + bb][0]
                else:
                    data = ds_in[bb]
                m = threshold_volume(torch.from_numpy(data).to(device),
                                     cfg["threshold"], cfg["threshold_mode"])
                if mask is not None:
                    m &= torch.from_numpy(mask[bb] > 0).to(device)
                masks[(j,) + tuple(slice(0, s) for s in m.shape)] = m
            labels = connected_components_batched(
                masks, connectivity=connectivity).cpu().numpy()
            for bid, block, lab in zip(batch_ids, blocks, labels):
                lab = lab[tuple(slice(0, s) for s in block.shape)]
                # consecutive within the block so offsets stay dense
                uniques = np.unique(lab)
                nonzero = uniques[uniques > 0]
                out = np.searchsorted(nonzero, lab).astype("uint64") + 1
                out[lab == 0] = 0
                ds_out[block.bb] = out
                max_ids[bid] = int(nonzero.size)
                log_fn(f"processed block {bid}")

        path = os.path.join(job_config["tmp_folder"],
                            f"block_components_max_ids_job_{job_id}.json")
        write_config(path, max_ids)


def resident_components(vol: torch.Tensor, origin, extent, block_shape,
                        threshold: float, mode: str, connectivity: int,
                        rle_cap: int):
    """One block of the resident padded volume ``vol``: its window at
    ``origin`` thresholded, zeroed past the REAL clipped ``extent``,
    labelled, densely relabelled 1..k in linear-index order of the
    components' roots and run-length coded.  Returns ``(k, dense int32
    block, packed int64[rle_cap], n_runs, rle_ok, bodies)``; ``k`` is a
    0-d tensor on the device."""
    from ..core.runtime import stage, stage_add
    from ..ops.components import connected_components, threshold_volume
    from ..ops.sweep import rle_encode_packed

    bs = tuple(block_shape)
    n_block = int(np.prod(bs))
    dev = vol.device
    with stage("dispatch"):
        x = vol[tuple(slice(o, o + b) for o, b in zip(origin, bs))]
        m = threshold_volume(x, threshold, mode)
        # clipped border blocks: zero the padded remainder so phantom
        # components never enter the labeling
        for d in range(len(bs)):
            if extent[d] < bs[d]:
                sl = [slice(None)] * len(bs)
                sl[d] = slice(int(extent[d]), None)
                m[tuple(sl)] = False
    with stage("device-cc"):
        lab, bodies = connected_components(m, connectivity=connectivity,
                                           return_bodies=True)
    stage_add("cc-bodies", 0.0, bodies)
    with stage("device-rle"):
        flat = lab.reshape(-1).long()
        pres = torch.zeros(n_block + 2, dtype=torch.int32, device=dev)
        pres.index_fill_(0, flat, 1)
        pres[0] = 0
        rank = torch.cumsum(pres, 0, dtype=torch.int32)
        dense = torch.where(flat > 0, rank[flat], 0).to(torch.int32)
        packed, n_rle, rle_ok = rle_encode_packed(dense, rle_cap)
    return rank[-1], dense.reshape(bs), packed, n_rle, rle_ok, bodies


class ResidentBlockComponents(BlockTask):
    """Config-2 fast path: threshold + per-block CC against a
    DEVICE-RESIDENT volume (see the module docstring).  Labels are
    block-local (1..k, offsets applied by BlockFaces/Write exactly as for
    BlockComponents), so the chain's semantics are unchanged (reference:
    block_components.py:143-180 + merge_offsets.py:100-137)."""

    task_name = "block_components"

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str, threshold: float, offsets_path: str,
                 threshold_mode: str = "greater", **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.offsets_path = offsets_path
        super().__init__(**kw)
        self.device = task_device(self.global_config)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"connectivity": 1, "rle_cap": 1 << 20,
                     "stream_window": 3})
        return conf

    def run_impl(self):
        with file_reader(self.input_path, "r") as f:
            shape = list(f[self.input_key].shape)
        block_shape = self.global_block_shape()[-len(shape):]
        with file_reader(self.output_path) as f:
            f.require_dataset(self.output_key, shape=shape,
                              chunks=block_shape, dtype="uint64")
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "threshold": self.threshold,
            "threshold_mode": self.threshold_mode,
            "offsets_path": self.offsets_path,
            "shape": shape, "block_shape": block_shape,
            "device": self.device,
        }, n_jobs=1)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from concurrent.futures import ThreadPoolExecutor

        from ..core.device import resolve_device
        from ..core.runtime import (stage, stage_add, stage_bytes,
                                    stream_window)
        from ..ops.sweep import rle_decode_packed
        from .fused_pipeline import _Download, _fragment_cache_put

        cfg = job_config["config"]
        device = resolve_device(cfg["device"])
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        connectivity = int(cfg.get("connectivity", 1))
        rle_cap = int(cfg.get("rle_cap", 1 << 20))
        bs = tuple(cfg["block_shape"])
        n_block = int(np.prod(bs))

        f_in = file_reader(cfg["input_path"], "r")
        f_out = file_reader(cfg["output_path"])
        ds_in, ds_out = f_in[cfg["input_key"]], f_out[cfg["output_key"]]

        with stage("store-read"):
            vol = np.asarray(ds_in[...])
        stage_bytes("store-read", vol.nbytes)
        # grid-aligned zero padding, so every block slices a full window;
        # the extent mask zeroes the pad before labeling
        gshape = [-(-s // b) * b for s, b in zip(cfg["shape"], bs)]
        if gshape != list(vol.shape):
            volp = np.zeros(gshape, vol.dtype)
            volp[tuple(slice(0, s) for s in vol.shape)] = vol
        else:
            volp = vol
        with stage("h2d-upload"):
            vol_dev = torch.from_numpy(np.ascontiguousarray(volp)).to(device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        stage_bytes("h2d-upload", volp.nbytes)
        del volp, vol

        max_ids: Dict[int, int] = {}
        write_futures = []

        def _write(bb, arr):
            t0 = time.perf_counter()
            ds_out[bb] = arr
            stage_add("store-write", time.perf_counter() - t0)
            stage_bytes("store-write", arr.nbytes)

        cache_key = (os.path.abspath(cfg["output_path"]),
                     cfg["output_key"])

        def submit(bid):
            block = blocking.get_block(bid)
            extent = [e - b for b, e in zip(block.begin, block.end)]
            k, dense, packed, n_rle, rle_ok, _ = resident_components(
                vol_dev, block.begin, extent, bs, float(cfg["threshold"]),
                cfg["threshold_mode"], connectivity, rle_cap)
            # the count and the run-length stream go to pinned host
            # buffers at once; the dense block stays on the device
            res = _Download(k.reshape(1).to(torch.int64), packed)
            return bid, res, dense, n_rle, rle_ok

        def drain(entry):
            bid, res, dense, n_rle, rle_ok = entry
            block = blocking.get_block(bid)
            real = tuple(slice(0, e - b) for b, e in zip(block.begin,
                                                         block.end))
            with stage("sync-execute"):
                k_np, packed = res.wait()
            k_i = int(k_np[0])
            if rle_ok:
                with stage("d2h-rle"):
                    packed = packed[:n_rle]
                    dense_np = rle_decode_packed(
                        packed, n_rle, n_block).reshape(bs)
                stage_bytes("d2h-rle", packed.nbytes)
            else:
                with stage("d2h-dense"):
                    dense_np = dense.cpu().numpy()
                stage_bytes("d2h-dense", dense_np.nbytes)
            local = dense_np[real]
            local = local.astype("uint16" if k_i < 65536 else "uint32")
            _fragment_cache_put(cache_key + (bid,), local, 0, block.bb)
            write_futures.append(
                writer.submit(_write, block.bb, local.astype("uint64")))
            max_ids[bid] = k_i
            log_fn(f"processed block {bid}")

        with ThreadPoolExecutor(1) as writer:
            for _ in stream_window(list(job_config["block_list"]),
                                   submit, drain,
                                   window=int(cfg.get("stream_window", 3))):
                pass
            for fut in write_futures:
                fut.result()

        # inline MergeOffsets: this single job saw every block
        ids = np.zeros(blocking.n_blocks, dtype="uint64")
        for bid, mx in max_ids.items():
            ids[bid] = mx
        _write_offsets(cfg["offsets_path"], ids)


class MergeOffsets(BlockTask):
    """Global job: per-block max ids -> exclusive prefix offsets, empty-block
    list, total label count (reference: merge_offsets.py:100-137)."""

    task_name = "merge_offsets"
    global_task = True
    allow_retry = False

    def __init__(self, n_blocks: int, offsets_path: str, **kw):
        self.n_blocks = n_blocks
        self.offsets_path = offsets_path
        super().__init__(**kw)

    def run_impl(self):
        self.run_jobs(None, {
            "tmp_root": self.tmp_folder, "n_blocks": self.n_blocks,
            "offsets_path": self.offsets_path,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        tmp = cfg["tmp_root"]
        max_ids = np.zeros(cfg["n_blocks"], dtype="uint64")
        for name in os.listdir(tmp):
            if (name.startswith("block_components_max_ids_job_")
                    and name.endswith(".json")):
                with open(os.path.join(tmp, name)) as f:
                    for bid, mx in json.load(f).items():
                        max_ids[int(bid)] = mx
        _write_offsets(cfg["offsets_path"], max_ids)
        log_fn(f"n_labels: {int(max_ids.sum())}, empty blocks: "
               f"{int((max_ids == 0).sum())}")


class BlockFaces(BlockTask):
    """Per-block face scan: equal-position voxel pairs across each lower face
    whose labels are both foreground become merge requests
    (label_a + offset_a, label_b + offset_b) (reference: block_faces.py:87-137).
    Face planes come from the resident pass's fragment cache when this
    process staged them, else from the store."""

    task_name = "block_faces"

    def __init__(self, path: str, key: str, offsets_path: str,
                 skip_covered: bool = False, **kw):
        self.path = path
        self.key = key
        self.offsets_path = offsets_path
        #: skip faces the mesh phase already merged on the device (their
        #: block pairs are listed as ``covered_faces`` in the offsets JSON)
        self.skip_covered = skip_covered
        super().__init__(**kw)

    def run_impl(self):
        with file_reader(self.path, "r") as f:
            shape = list(f[self.key].shape)
        block_shape = self.global_block_shape()[-len(shape):]
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "path": self.path, "key": self.key,
            "offsets_path": self.offsets_path,
            "skip_covered": self.skip_covered,
            "shape": shape, "block_shape": block_shape,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from .fused_pipeline import fragment_cache_get

        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        with open(cfg["offsets_path"]) as f:
            off_data = json.load(f)
        offsets = np.asarray(off_data["offsets"], dtype="uint64")
        covered = (set(map(tuple, off_data.get("covered_faces", [])))
                   if cfg.get("skip_covered") else set())
        ndim = blocking.ndim
        ds = file_reader(cfg["path"], "r")[cfg["key"]]

        def face_plane(bb, owner_bid):
            """One face plane from the in-RAM staging, or None."""
            ent = fragment_cache_get(cfg["path"], cfg["key"], owner_bid,
                                     expect_bb=blocking.get_block(
                                         owner_bid).bb)
            if ent is None:
                return None
            local, off0, obb = ent
            rel = tuple(slice(s.start - o.start, s.stop - o.start)
                        for s, o in zip(bb, obb))
            out = local[rel].astype("uint64")
            if off0:
                out[out > 0] += np.uint64(off0)
            return out.ravel()

        def plane_bb(outer_bb, face_sl):
            return tuple(
                slice(o.start + (f_.start or 0),
                      o.start + (f_.stop if f_.stop is not None
                                 else (o.stop - o.start)))
                for o, f_ in zip(outer_bb, face_sl))

        pairs: List[np.ndarray] = []
        for block_id in job_config["block_list"]:
            for face in iterate_faces(blocking, block_id, halo=[1] * ndim):
                if (face.block_a, face.block_b) in covered:
                    continue
                la = face_plane(plane_bb(face.outer_bb, face.face_a),
                                face.block_a)
                lb = face_plane(plane_bb(face.outer_bb, face.face_b),
                                face.block_b)
                if la is None or lb is None:
                    region = ds[face.outer_bb]
                    la = region[face.face_a].ravel().astype("uint64")
                    lb = region[face.face_b].ravel().astype("uint64")
                fg = (la != 0) & (lb != 0)
                if not fg.any():
                    continue
                pa = la[fg] + offsets[face.block_a]
                pb = lb[fg] + offsets[face.block_b]
                pairs.append(np.unique(np.stack([pa, pb], axis=1), axis=0))
            log_fn(f"processed block {block_id}")
        out = (np.concatenate(pairs, axis=0) if pairs
               else np.zeros((0, 2), dtype="uint64"))
        np.save(os.path.join(job_config["tmp_folder"],
                             f"block_faces_assignments_job_{job_id}.npy"), out)


class MergeAssignments(BlockTask):
    """Global union-find over all face pairs -> consecutive assignment table
    (reference: merge_assignments.py:95-147, boost_ufd + relabelConsecutive),
    as scipy's sparse-graph CC over the label-id graph."""

    task_name = "merge_assignments"
    global_task = True
    allow_retry = False

    def __init__(self, offsets_path: str, assignment_path: str, **kw):
        self.offsets_path = offsets_path
        self.assignment_path = assignment_path
        super().__init__(**kw)

    def run_impl(self):
        self.run_jobs(None, {
            "tmp_root": self.tmp_folder,
            "offsets_path": self.offsets_path,
            "assignment_path": self.assignment_path,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components as sparse_cc

        cfg = job_config["config"]
        with open(cfg["offsets_path"]) as f:
            n_labels = json.load(f)["n_labels"]
        pair_arrays = [np.load(os.path.join(cfg["tmp_root"], name))
                       for name in os.listdir(cfg["tmp_root"])
                       if name.startswith("block_faces_assignments_job_")
                       and name.endswith(".npy")]
        pairs = (np.concatenate(pair_arrays, axis=0) if pair_arrays
                 else np.zeros((0, 2), dtype="uint64"))
        n_nodes = n_labels + 1  # ids are 1-based; 0 is background
        graph = coo_matrix(
            (np.ones(len(pairs), dtype=bool),
             (pairs[:, 0].astype("int64"), pairs[:, 1].astype("int64"))),
            shape=(n_nodes, n_nodes))
        _, roots = sparse_cc(graph, directed=False)
        # consecutive relabel of the foreground roots; no pair ever
        # touches id 0, so background stays its own component
        fg_roots = roots[1:].astype("uint64")
        uniques = np.unique(fg_roots)
        table = np.zeros(n_nodes, dtype="uint64")
        table[1:] = np.searchsorted(uniques, fg_roots) + 1
        np.save(cfg["assignment_path"], table)
        log_fn(f"merged {len(pairs)} pairs over {n_labels} labels -> "
               f"{len(uniques)} components")


class ThresholdedComponentsWorkflow(Task):
    """Chain: BlockComponents -> MergeOffsets -> BlockFaces ->
    MergeAssignments -> Write (reference:
    thresholded_components_workflow.py:17-103), or the resident pass
    (offsets inline) -> BlockFaces -> MergeAssignments -> Write.

    The resident pass runs for ``target="gpu"`` without a mask when the
    device is ``"cuda"`` (``CTT_FORCE_RESIDENT=1`` takes it on the CPU
    too); ``target="mesh"`` without a mask runs MeshBlockComponents
    (rounds of one block per shard device, workflows/mesh_blockwise.py)
    -> BlockFaces skipping the device-covered faces; every other case runs
    the per-block path on the config's device."""

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str, threshold: float, tmp_folder: str,
                 config_dir: str, max_jobs: int = 1, target: str = "gpu",
                 threshold_mode: str = "greater", mask_path: str = "",
                 mask_key: str = "", assignment_key: str = "assignments",
                 dependency: Optional[Task] = None):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.threshold = threshold
        self.threshold_mode = threshold_mode
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

    def requires(self):
        offsets_path = os.path.join(self.tmp_folder, "cc_offsets.json")
        assignment_path = os.path.join(self.tmp_folder, "cc_assignments.npy")
        with file_reader(self.input_path, "r") as f:
            shape = list(f[self.input_key].shape)
        gconf = ConfigDir(self.config_dir).global_config()
        block_shape = gconf["block_shape"]
        n_blocks = Blocking(shape, block_shape[-len(shape):]).n_blocks
        device = task_device(gconf)

        resident = (self.target == "gpu" and not self.mask_path
                    and (device.startswith("cuda")
                         or os.environ.get("CTT_FORCE_RESIDENT") == "1"))
        skip_covered = False
        if self.target == "mesh" and not self.mask_path:
            # mesh phase: per-block CC + offset scan + the round-adjacent
            # face exchange in rounds over the shard devices
            # (workflows/mesh_blockwise.py); the other faces go through
            # the host scan with the device-covered pairs skipped
            from .mesh_blockwise import MeshBlockComponents

            faces_dep = MeshBlockComponents(
                input_path=self.input_path, input_key=self.input_key,
                output_path=self.output_path, output_key=self.output_key,
                threshold=self.threshold,
                threshold_mode=self.threshold_mode,
                offsets_path=offsets_path,
                dependency=self.dependency, **self._common())
            skip_covered = True
        elif resident:
            faces_dep = ResidentBlockComponents(
                input_path=self.input_path, input_key=self.input_key,
                output_path=self.output_path, output_key=self.output_key,
                threshold=self.threshold,
                threshold_mode=self.threshold_mode,
                offsets_path=offsets_path,
                dependency=self.dependency, **self._common())
        else:
            t1 = BlockComponents(
                input_path=self.input_path, input_key=self.input_key,
                output_path=self.output_path, output_key=self.output_key,
                threshold=self.threshold, threshold_mode=self.threshold_mode,
                mask_path=self.mask_path, mask_key=self.mask_key,
                dependency=self.dependency, **self._common())
            faces_dep = MergeOffsets(n_blocks=n_blocks,
                                     offsets_path=offsets_path,
                                     dependency=t1, **self._common())
        t3 = BlockFaces(path=self.output_path, key=self.output_key,
                        offsets_path=offsets_path, skip_covered=skip_covered,
                        dependency=faces_dep, **self._common())
        t4 = MergeAssignments(offsets_path=offsets_path,
                              assignment_path=assignment_path,
                              dependency=t3, **self._common())
        return WriteAssignments(
            input_path=self.output_path, input_key=self.output_key,
            output_path=self.output_path, output_key=self.output_key,
            assignment_path=assignment_path, offsets_path=offsets_path,
            identifier="cc", dependency=t4, **self._common())

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder, "write_cc.status"))
