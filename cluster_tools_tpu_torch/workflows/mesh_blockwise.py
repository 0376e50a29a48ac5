"""Mesh execution of blockwise connected components: one outer block per
shard device.

Port of cluster_tools_tpu/workflows/mesh_blockwise.py, the ``target="mesh"``
phase of ``ThresholdedComponentsWorkflow`` (the reference's
one-batch-job-per-block fan-out, cluster_tasks.py:447-490):

* per ROUND, up to ``n_dev`` consecutive blocks go one per shard device
  and each runs the per-block CC there (:func:`_cc_round`; the last round
  uses only as many shards as it has blocks);
* the per-block label counts become global id offsets with an exclusive
  scan on the first shard's device (merge_offsets.py:100-137's cumsum);
* each block's last plane along the fastest axis is sent to the next
  shard (a real copy) and the round-adjacent face pairs are emitted from
  it (block_faces.py:87-137); faces the round does not cover (other axes,
  round boundaries) go through the host face scan, which skips the
  covered ones (``BlockFaces(skip_covered=True)``).

The global union-find and the relabel + write are the host tasks every
target runs, and the per-block CC is the same as the per-block path's, so
the segmentation is bit-identical to the other targets.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np
import torch

from ..core.blocking import Blocking
from ..core.config import write_config
from ..core.device import task_device
from ..core.runtime import BlockTask
from ..core.storage import file_reader


def _cc_round(masks: List[torch.Tensor], connectivity: int):
    """One round: ``masks[j]`` is shard j's block mask on its device.
    Returns per-shard ``(labels, count)`` plus the exclusive offsets of
    the counts (on the first shard's device) and, per shard, the previous
    shard's last plane along the fastest axis received as a real copy
    (shard 0 receives the last shard's, unused) and its own first
    plane."""
    from ..ops.components import connected_components
    from ..parallel.mesh import send

    labels, counts = [], []
    for m in masks:
        lab = connected_components(m, connectivity=connectivity)
        flat = lab.reshape(-1)
        idx = torch.arange(flat.shape[0], dtype=flat.dtype,
                           device=flat.device)
        labels.append(lab)
        counts.append((flat == idx + 1).sum().to(torch.int64))
    dev0 = masks[0].device
    all_counts = torch.stack([send(c, dev0) for c in counts])
    offsets = torch.cumsum(all_counts, 0) - all_counts
    n = len(masks)
    prev_planes = [send(labels[(j - 1) % n][..., -1], labels[j].device)
                   for j in range(n)]
    first_planes = [lab[..., 0] for lab in labels]
    return labels, all_counts, offsets, prev_planes, first_planes


class MeshBlockComponents(BlockTask):
    """Mesh phase of ThresholdedComponentsWorkflow: per-block CC + offsets
    + round-covered face pairs in rounds over the shard devices (replaces
    BlockComponents + MergeOffsets and part of BlockFaces under
    ``target="mesh"``)."""

    task_name = "mesh_block_components"

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
        # n_devices stays only so one config directory reads the same in
        # both packages: the shards are the global config's (mesh_devices),
        # and n_devices must be unset or their count
        conf.update({"connectivity": 1, "n_devices": None})
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
        }, n_jobs=1)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from ..ops.components import threshold_volume
        from ..core.runtime import status_fields
        from ..parallel.mesh import blocks_mesh, config_devices

        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        block_list = list(job_config["block_list"])
        connectivity = int(cfg.get("connectivity", 1))
        mesh = blocks_mesh(devices=config_devices(
            job_config["global_config"]))
        devs = mesh.device_list
        n_dev = len(devs)
        if cfg.get("n_devices") and int(cfg["n_devices"]) != n_dev:
            raise ValueError(
                f"n_devices={cfg['n_devices']} differs from the {n_dev} "
                "shard devices: set the global config's mesh_devices "
                "instead")
        status_fields(log_fn, mesh_devices=mesh.size,
                      physical_devices=mesh.physical_devices)
        bs = tuple(cfg["block_shape"])
        x_axis = blocking.ndim - 1

        f_in = file_reader(cfg["input_path"], "r")
        f_out = file_reader(cfg["output_path"])
        ds_in, ds_out = f_in[cfg["input_key"]], f_out[cfg["output_key"]]

        max_ids = np.zeros(blocking.n_blocks, dtype="uint64")
        offsets = np.zeros(blocking.n_blocks, dtype="uint64")
        luts: Dict[int, np.ndarray] = {}
        pair_chunks: List[np.ndarray] = []
        covered_faces: List[List[int]] = []
        # raw (uncompacted) pair staging: (block_a, block_b, raw planes)
        staged: List[tuple] = []
        round_base = np.uint64(0)  # labels before this round (the round's
        #                            own scan orders blocks within it)

        for r0 in range(0, len(block_list), n_dev):
            round_ids = block_list[r0:r0 + n_dev]
            masks = []
            for j, bid in enumerate(round_ids):
                # the threshold on the host: a plain compare, equal to the
                # device threshold_volume; a border block is zero-padded to
                # the block shape
                data = np.asarray(ds_in[blocking.get_block(bid).bb])
                bin_mask = threshold_volume(
                    torch.from_numpy(data), cfg["threshold"],
                    cfg.get("threshold_mode", "greater")).numpy()
                m = np.zeros(bs, bool)
                m[tuple(slice(0, s) for s in bin_mask.shape)] = bin_mask
                masks.append(torch.from_numpy(m).to(devs[j]))

            labels_d, counts_d, offs_d, prev_d, first_d = _cc_round(
                masks, connectivity)
            labels = [t.cpu().numpy() for t in labels_d]
            counts = counts_d.cpu().numpy()
            offsets_dev = offs_d.cpu().numpy()
            prev_planes = [t.cpu().numpy() for t in prev_d]
            first_planes = [t.cpu().numpy() for t in first_d]

            for i, bid in enumerate(round_ids):
                block = blocking.get_block(bid)
                lab = labels[i][tuple(slice(0, s) for s in block.shape)]
                uniques = np.unique(lab)
                nonzero = uniques[uniques > 0]
                out = np.searchsorted(nonzero, lab).astype("uint64") + 1
                out[lab == 0] = 0
                ds_out[block.bb] = out
                max_ids[bid] = nonzero.size
                luts[bid] = nonzero
                # the device count must agree with the host compaction:
                # the device scan is the offsets' source of truth
                if int(counts[i]) != nonzero.size:
                    raise RuntimeError(
                        f"block {bid}: device label count {int(counts[i])}"
                        f" != host compaction {nonzero.size}")
                offsets[bid] = round_base + np.uint64(int(offsets_dev[i]))
                log_fn(f"processed block {bid}")
            round_base += np.uint64(int(counts.sum()))

            # round-covered faces: shard i holds block round_ids[i-1]'s last
            # x-plane; a pair is real when the two blocks are x-neighbours
            for i in range(1, len(round_ids)):
                a, b = round_ids[i - 1], round_ids[i]
                if blocking.neighbor_id(a, x_axis, +1) != b:
                    continue
                shape_a = blocking.get_block(a).shape
                shape_b = blocking.get_block(b).shape
                clip = tuple(slice(0, min(sa, sb)) for sa, sb in
                             zip(shape_a[:-1], shape_b[:-1]))
                pa = prev_planes[i][clip]
                pb = first_planes[i][clip]
                # the face exists only where block a is full-width in x
                if shape_a[-1] == bs[-1]:
                    staged.append((a, b, pa, pb))
                    covered_faces.append([int(a), int(b)])

        # cross-check: the device scans composed across rounds must equal
        # the reference cumsum (merge_offsets.py semantics)
        check = np.zeros(blocking.n_blocks, dtype="uint64")
        np.cumsum(max_ids[:-1], out=check[1:])
        processed = np.asarray(block_list)
        if not (offsets[processed] == check[processed]).all():
            bad = processed[offsets[processed] != check[processed]][:5]
            raise RuntimeError(
                "device offset scan diverged from the reference cumsum "
                f"at blocks {bad.tolist()}")

        for a, b, pa, pb in staged:
            fg = (pa > 0) & (pb > 0)
            if not fg.any():
                continue
            # raw root labels -> compacted block-local ids
            ca = np.searchsorted(luts[a], pa[fg]).astype("uint64") + 1
            cb = np.searchsorted(luts[b], pb[fg]).astype("uint64") + 1
            pairs = np.stack([ca + offsets[a], cb + offsets[b]], axis=1)
            pair_chunks.append(np.unique(pairs, axis=0))

        pairs_out = (np.concatenate(pair_chunks, axis=0) if pair_chunks
                     else np.zeros((0, 2), "uint64"))
        np.save(os.path.join(job_config["tmp_folder"],
                             "block_faces_assignments_job_mesh.npy"),
                pairs_out)

        empty_blocks = np.nonzero(max_ids == 0)[0].tolist()
        write_config(cfg["offsets_path"],
                     {"offsets": offsets.tolist(),
                      "empty_blocks": empty_blocks,
                      "n_labels": int(max_ids.sum()),
                      "covered_faces": covered_faces})
        log_fn(f"mesh CC: {len(block_list)} blocks over {n_dev} shards, "
               f"{int(max_ids.sum())} labels, "
               f"{len(covered_faces)} faces on device")
