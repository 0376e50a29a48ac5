#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernel and C++ solvers from the checkout's
sources, then runs eighteen phases, each of which must pass:

1. the build;
2. the min-plus EDT kernel against its plain PyTorch version (in place
   along each axis of one outer block of the main path, the whole EDT of
   that block, per-slice, all-BIG and all-zero volumes, ragged shapes and
   other spacings), timed there;
3. the fused multicut chain on a small volume on the card and on the CPU;
4. the fused chain at full size — ``MulticutSegmentationWorkflow(
   fused=True, target="gpu")`` on one CREMI-sample-sized synthetic volume,
   ``(125, 1250, 1250)`` uint8, blocks ``[50, 512, 512]`` — checked against
   the generator's ground truth, with the kernel's launches counted;
5. the split chain (``WatershedWorkflow`` ->
   ``MulticutSegmentationWorkflow(fused=False)``) on a small volume on the
   card and on the CPU, in four watershed configurations (default,
   ``two_pass``, ``pixel_pitch`` + ``apply_dt_2d``, ``pixel_pitch`` with a
   mask);
6. the split chain at full size on phase 4's volume, checked against the
   ground truth, its fragments held to the same partition as phase 4's
   fused fragments, and its kernel launches counted (3 per block, plus 3
   per block the watershed redid after a capacity overflow);
7. the affinity path, card against CPU on small volumes: (a) the
   default-width U-Net (weights from seed 0, written in the JAX
   package's checkpoint format) in float32 and bfloat16; (b)
   ``InferenceTask`` on config 5's ``(32, 256, 256)`` volume; (c)
   ``MwsWorkflow`` and ``TwoPassMwsWorkflow`` on one stored 12-channel
   uint8 affinity volume, the card and the CPU (both block paths) giving
   identical labels; (d) config 5's chain ``InferenceTask`` ->
   ``MwsWorkflow`` on the card;
8. the affinity path at full size: (a) ``InferenceTask`` with the
   default-width U-Net on phase 4's volume, with the forward pass timed
   against its bound; (b) ``TwoPassMwsWorkflow`` at config 3's width
   and block shape (its depth cut to 16), checked against the ground
   truth.  This path launches no kernel of the port (no Pallas kernel
   lies on it in the JAX package);
9. connected components, stitching and evaluation, card against CPU on
   small volumes: (a) hooking connected components (single, batched
   with ragged blocks, the worst-case snake) and ``count_overlaps``,
   identical, and one config-2 block timed at several convergence-check
   intervals; (b) ``ThresholdedComponentsWorkflow`` on config 2's recipe
   on the resident path, the per-block path and the per-block path with
   a mask, identical labels and ``scipy.ndimage.label``'s partition; (c)
   ``StitchingWorkflow``, ``SimpleStitchingWorkflow`` (its
   ``StitchingAssignmentsWorkflow``), ``NodeLabelWorkflow`` and
   ``EvaluationWorkflow``, identical outputs;
10. at full size: (a) BASELINE config 2, ``ThresholdedComponentsWorkflow``
   (the resident path) on its recipe at ``(125, 1250, 1250)`` float32 in
   ``[32, 256, 256]`` blocks, held to ``scipy.ndimage.label``'s partition;
   (b) ``EvaluationWorkflow`` of phase 6's segmentation against phase 4's
   ground truth, held to phase 6's whole-volume scores; (c)
   ``StitchingWorkflow`` on phase 4's ground truth relabelled per block,
   card against CPU, held to the adapted Rand gate.  Phases 9-10 launch
   no kernel of the port;
11. the fused task's other executions and the split watershed's options,
   card against CPU on ``(32, 128, 128)`` volumes: (a) the fused chain with
   ``ws_method`` ``hybrid`` and ``legacy`` and on a 4-d (channel) store,
   which takes ``legacy``; (b) ``WatershedWorkflow`` with ``apply_ws_2d``,
   ``non_maximum_suppression``, ``ws_algorithm: "flood"`` (single pass and
   ``two_pass``, on a smaller volume), ``impl: "host"`` and
   ``agglomeration=True``, and ``WatershedFromSeedsTask``; (c)
   ``LiftedMulticutSegmentationWorkflow`` (the ground truth folded into
   classes as the lifted prior) and ``AgglomerativeClusteringWorkflow``
   over the same fragments; each held to the VOI gate;
12. at full block width on a two-block crop of phase 4's volume, (a)
   and (b) on its first block: (a) the fused chain with ``hybrid`` and
   ``legacy``, held to the CREMI gate, their VOI to phase 4's fragments
   and segmentation logged, the kernel's launches counted; (b) the
   watershed's ``apply_ws_2d``, ``flood`` and ``non_maximum_suppression``
   options and the block-local agglomeration, scored against the ground
   truth, launches counted;
   (c) ``LiftedMulticutSegmentationWorkflow`` and
   ``AgglomerativeClusteringWorkflow`` over phase 4's fragments on that
   crop, scored against the ground truth;
13. serving: (a) ``FusedROIPipeline`` on ``(32, 128, 128)``, card
   against CPU, default config and ``sigma_weights: 0``, identical; (b)
   the min-plus kernel against its plain version on the serving outer
   block ``(58, 320, 320)`` (each axis in place and the whole EDT), then
   ``loadgen.run_threaded`` drives ``ResidentSegmentationServer`` over
   ``FusedROIPipeline((50, 512, 512), block_shape=(50, 256, 256))`` on
   the card with 8 open-loop requests from 4 tenants (crops of phase 4's
   volume): every request done, warm, 4 ``sync-execute`` each, CREMI
   under its gate, 96 kernel launches, the metrics snapshot lint-clean;
   (c) the edit lane beside it: the multicut problem of phase 12's crop
   over phase 4's fragments, 3 merges and 3 splits through
   ``EditPipeline`` while other tenants' bulk requests queue, each
   edit's incremental result equal to the from-scratch solve, only the
   touched output blocks rewritten, every edit ahead of the queued bulk
   requests;
14. filter banks and the workflows that use them: the min-plus kernel
   against its plain version on the object fit's outer block of a full
   block with the default ``erode_by`` (``(74, 536, 536)``: each axis in
   place and the whole EDT, bitwise), its per-slice form and the signed
   distance transform of the main path's outer block; (a) card against
   CPU on ``(32, 128, 128)``: every filter at three scales, the min and
   max box filters, every downsampling sampler, the linear resize, both
   affinity functions, then the split chain with filter-bank edge
   features, ``ImageFilterTask``, ``SmoothedGradients``,
   ``InsertAffinities``, ``UpscaleTask``, ``ScaleToBoundariesTask`` (3-d
   and per slice), ``DownscalingWorkflow`` and the six post-processing
   workflows, labels identical and floats within the tests' tolerances;
   (b) at full block width on phase 12's crop: the split chain with 6
   filter-bank responses (55 feature columns) under the CREMI gate,
   ``ImageFilterTask`` with the default features, ``ScaleToBoundariesTask``
   fitting the 6 largest ground-truth bodies, downsampled, back to the
   boundaries (adapted Rand no worse than the upsampled input's) and the
   filling ``SizeFilterWorkflow`` over phase 4's fragments, with the
   kernel's launches counted; (c) ``CopyVolumeTask`` and
   ``DownscalingWorkflow`` on phase 4's whole volume, s1 equal to the
   numpy window mean;
15. the tools run after a segmentation and the sweep ops, which launch no
   kernel of the port: (a) card against CPU on ``(16, 128, 128)``:
   ``sweep_watershed_impl`` (plain, masked, with a size filter),
   ``sweep_watershed``, ``sweep_cc_impl``, ``compact_ids``,
   ``rle_encode``/``rle_decode`` and ``PainteraConversionWorkflow``,
   identical; (b) the sweep ops on the main path's outer block of phase
   4's boundary map, ``(58, 576, 576)``: the watershed at its default
   round cap and at its wrapper's (48: converged, its seeds kept, the
   flood's labels on > 97 % of the foreground), the
   connected components scipy's partition, a block of phase 4's fragments
   run-length coded and back, each timed; (c) on phase 12's crop:
   ``MorphologyWorkflow`` with ``RegionCenters`` (the table equal to a
   numpy oracle, every center inside its object), ``MeshWorkflow`` and
   ``SkeletonWorkflow`` of the 4 largest bodies (every mesh closed, every
   skeleton voxel inside its object) with ``SkeletonEvaluation``,
   ``LabelMultisetWorkflow`` (counts equal to the windows' voxels, one
   block equal to a numpy brute force), ``DecompositionWorkflow`` over
   phase 13c's problem under the CREMI gate, ``CheckSubGraphs`` reporting
   no violation, ``CheckWsWorkflow`` on phase 4's fragments (listing
   exactly the fragments scipy finds disconnected), ``BlocksFromMask``
   and ``MinFilterMask`` equal to numpy;
   (d) ``PainteraConversionWorkflow`` of phase 4's fragments on phase
   12's crop with phase 13c's multicut table, then ``BigcatWorkflow`` to
   N5: s1, the label-to-block lookup of 16 ids and the fragment-segment
   pairs equal to numpy's;
16. the storage formats the port writes and reads without h5py,
   tensorstore or numcodecs (the card's machine has none of them): (a)
   phase 12's crop written by the port's HDF5 writer (``crop.h5``,
   uint8, chunks ``[25, 256, 256]``, gzip), the fused chain
   (``MulticutSegmentationWorkflow(fused=True)``, default execution) run
   ``.h5`` in and ``.h5`` out and again on the crop's N5 store, the
   fragments and the segmentation identical, 3 kernel launches per block
   per run; (b) the crop's raw data (uint8) and phase 4's fragments on it
   (uint64) written to zarr with ``compression="blosc"`` and read back
   identical, compressed bytes and write and read MB/s beside gzip's; (c)
   ``WriteCarving`` of phase 13c's problem through the port's HDF5
   writer, read back by its reader equal to what the task computed; (d)
   a ``(50, 256, 256)`` corner of the crop as raw Knossos cubes (128^3,
   zero-padded) read through ``file_reader(".knossos")`` equal to the
   crop; (e) the formats other tools write, which the port reads with
   its own decoders: every fixture of ``tests/data/torch_formats/``
   (tensorstore's zarr and N5 with blosc Zstd, Snappy and the bitshuffle,
   zarr ``zstd``, ``bz2`` and F order, N5 ``bzip2``, ``xz`` and
   ``zstd``; h5py's ``libver="latest"`` HDF5 with every chunk index,
   dense links and attributes, LZF, scale-offset, compound types and
   soft links) read through ``file_reader`` identical to the array
   ``make_fixtures.expected`` regenerates, each decoder's MB/s on the
   fixtures' chunks; then the fused chain on the ``(32, 96, 96)``
   boundary map held in zarr (F order, blosc Zstd, bitshuffle), in
   ``libver="latest"`` HDF5 (LZF) and in N5 (raw, written here): the
   fragments and the segmentation identical, 3 kernel launches per
   block per run.  The random-forest workflows (``LearningWorkflow``,
   ``EdgeCostsWorkflow(rf_path=...)``) need sklearn, which the card's
   machine lacks: the CPU tests hold them;
17. the multi-device paths with 4 shards on the one card (the global
   config's ``mesh_devices``): (a) ``halo_exchange`` (constant and
   reflect) and a ``sharded_stencil`` Gaussian over a ``(64, 256, 256)``
   float32 volume, bitwise equal to the dense versions; (b) the
   mesh-resident program on a ``(64, 256, 256)`` uint8 crop of phase 4's
   volume, card against CPU; (c) the fused chain with ``mesh_resident:
   true`` on phase 4's volume (slabs ``[32, 1250, 1250]``) under the CREMI
   gate, its VOI against the ground truth within 0.01 of phase 4's, one
   ``sync-execute``, 12 kernel launches; (d) on phase 12's crop, the
   fused chain and the split chain's watershed under ``target="mesh"``
   bitwise equal to ``target="gpu"``; (e) ``ThresholdedComponentsWorkflow(
   target="mesh")`` on a crop of phase 10a's input equal to
   ``target="gpu"`` and to scipy's partition; (f) ``predict_sharded`` of 4
   outer ``(60, 544, 544)`` blocks within 2e-5 of the per-block forwards;
   (g) two processes splitting a ``BlockTask`` through the runtime's
   multi-process path, with a gloo ``all_reduce``;
18. training and the parallel primitives, which launch no kernel of the
   port: (a) a float32 ``(4, 8)`` U-Net's loss and every gradient card
   against CPU, and ``shard_train_step`` over 8 shards ``(2, 2, 2)`` on the
   card against the unsharded step; (b) ``create_unet()`` trained 10 steps
   on two ``(32, 256, 256)`` crops of phase 4's volume against their 12
   ``DEFAULT_OFFSETS`` affinities (the loss falls; ms per step, peak
   memory, the profile of one step with GroupNorm's share), then 3 steps of
   ``shard_train_step`` over 8 shards from the same start, the losses
   within 2e-2 of the unsharded ones; (c) the sharded state after step 1
   saved and restored bitwise, the next loss equal; (d)
   ``pipeline_apply``, ``moe_apply`` (two capacities) and
   ``ring_attention`` (float32 and bfloat16, causal and not) over 4 shards,
   each against its dense version on the card and timed beside it; (e)
   the JAX package's own orbax train states (``tests/data/
   torch_train_states/``: its ``save_train_state`` after one JAX step,
   unsharded and from its 8-device mesh) restored without orbax onto the
   card, whole and onto 8 shards ``(2, 2, 2)``, bitwise equal to the
   restore onto the CPU, then one step from each: the float32 loss within
   1e-5 (18a's gate of the card against the CPU) of the JAX package's
   float32 loss, the bfloat16 loss within 2e-2 of the JAX package's own
   (bfloat16) loss, both as the fixture records them.

The last stdout line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: the main path's volume (one CREMI sample) and block shape
FULL_SHAPE = (125, 1250, 1250)
BLOCK = [50, 512, 512]
#: the small card-vs-CPU volume
SMALL_SHAPE = (32, 256, 256)
SMALL_BLOCK = [32, 128, 128]
#: H100 SXM HBM rate (NVIDIA data sheet)
PEAK_BYTES = 3.35e12
#: the repo's standing VOI gate (BASELINE.md "Measurement semantics")
VOI_GATE = 0.01
#: a broken chain scores far above this on the synthetic volume
CREMI_GATE = 0.2


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def build_all() -> float:
    """Build the CUDA kernel (nvcc) and the C++ solvers (g++) in parallel."""
    from cluster_tools_tpu_torch import native
    from cluster_tools_tpu_torch.ops import edt

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(edt.build_kernel), pool.submit(native.load)]
        for f in futs:
            f.result()
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase 2: kernel against plain
# ---------------------------------------------------------------------------

def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _scanlines(m: int, n: int, seed: int, device):
    """EDT-like scanlines: zeros (background), BIG (foreground not yet
    reached) and squared distances from an earlier axis."""
    import torch

    from cluster_tools_tpu_torch.ops.edt import BIG

    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((m, n), generator=g, device=device)
    d = torch.randint(0, 40, (m, n), generator=g, device=device)
    f = (d * d).to(torch.float32)
    f = torch.where(u < 0.2, 0.0, f)
    return torch.where(u > 0.7, BIG, f).contiguous()


def bytes_bound_ms(nbytes: float) -> float:
    """Least time the card takes to move ``nbytes`` through HBM: the
    envelope's ~20 instructions per element are far below the bytes."""
    return nbytes / PEAK_BYTES * 1e3


def _compare(name: str, got, want, exact: bool = True) -> float:
    """Bitwise where ``exact`` (integer squared distances: unit spacing,
    or s^2 an integer), else rtol 1e-6; logs and returns the max abs
    error."""
    import torch

    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if exact:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel != plain (max abs err "
                                 f"{err})")
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
    log("kernel-vs-plain " + json.dumps({
        "name": name, "shape": list(got.shape), "exact": exact,
        "bitwise": bool(torch.equal(got, want)), "max_abs_err": err}))
    return err


def _plain_axis(x, axis: int):
    """The plain version along ``axis``, over a transposed copy."""
    import torch

    from cluster_tools_tpu_torch.ops.edt import minplus_plain

    xm = torch.movedim(x, axis, -1).contiguous()
    out = minplus_plain(xm.reshape(-1, xm.shape[-1]))
    return torch.movedim(out.reshape(xm.shape), -1, axis)


def block_mask(outer, device="cuda"):
    """The fused chain's EDT mask of one outer block of the main path's
    synthetic volume (seed 0, uint8, threshold 0.25)."""
    import torch

    from cluster_tools_tpu_torch.utils.synthetic import (as_uint8,
                                                         synthetic_instance)

    _, bnd = synthetic_instance(tuple(outer), seed=0)
    u8 = torch.from_numpy(as_uint8(bnd)).to(device)
    return u8.to(torch.float32) * (1.0 / 255.0) < 0.25


def block_vs_plain(outer, device="cuda"):
    """The CUDA min-plus kernel against its plain PyTorch version on one
    outer block of a path, bitwise: in place along each axis, on the
    inputs its EDT gives each axis, and as the whole EDT of the block
    (three launches: the first reads the mask, the last writes the
    sqrt).  Each is timed (median of CUDA-event timings); returns (the
    axis rows, the max abs error, the mask)."""
    import torch

    from cluster_tools_tpu_torch.ops import edt

    timed = []
    max_err = 0.0
    fg = block_mask(outer, device)
    x = torch.where(fg, edt.BIG, 0.0).to(torch.float32)
    for ax, name in enumerate("zyx"):
        got = edt.minplus_axis_cuda(x, ax)
        max_err = max(max_err, _compare(f"block {name} in place", got,
                                        _plain_axis(x, ax)))
        flat = torch.movedim(x, ax, -1).contiguous().reshape(-1, x.shape[ax])
        row = {"name": name, "shape": list(x.shape), "axis": ax,
               "ms": _time_ms(lambda: edt.minplus_axis_cuda(x, ax), reps=20),
               "plain_ms": _time_ms(lambda: edt.minplus_plain(flat), reps=3,
                                    warmup=1),
               # f read once, out written once
               "bound_ms": bytes_bound_ms(8.0 * x.numel())}
        timed.append(row)
        log(f"kernel-timed {json.dumps(row)}")
        x = got
    got = edt.distance_transform_edt(fg)
    max_err = max(max_err, _compare(
        "block EDT", got, edt.distance_transform_edt_plain(fg)))
    # mask read (1 byte), two float32 intermediates written and read,
    # the distances written
    whole = {"name": "block EDT", "shape": list(fg.shape),
             "ms": _time_ms(lambda: edt.distance_transform_edt(fg), reps=20),
             "plain_ms": _time_ms(lambda: edt.distance_transform_edt_plain(
                 fg), reps=3, warmup=1),
             "bound_ms": bytes_bound_ms(21.0 * fg.numel())}
    log(f"kernel-timed {json.dumps(whole)}")
    return timed, max_err, fg


def kernel_vs_plain(outer, device="cuda"):
    """The CUDA min-plus kernel against its plain PyTorch version on the
    card: bitwise at unit spacing, rtol 1e-6 at other spacings, on one
    outer block of the main path (``block_vs_plain``), per slice, on
    constant, ragged and anisotropic volumes and on ragged rows."""
    import torch

    from cluster_tools_tpu_torch.ops import edt

    timed, max_err, fg = block_vs_plain(outer, device)
    checks = [("per-slice axes=(1,2)", fg, (1, 2), None, True),
              ("all-BIG volume", torch.ones_like(fg), None, None, True),
              ("all-zero volume", torch.zeros_like(fg), None, None, True),
              ("ragged volume", torch.rand((7, 45, 33), device=device) > 0.3,
               None, None, True),
              ("anisotropic s=0.7", fg[:16], None, (0.7, 0.7, 0.7), False),
              ("anisotropic (10,1,1)", fg[:16], None, (10.0, 1.0, 1.0),
               True)]
    for name, mask, axes, sampling, exact in checks:
        got = edt.distance_transform_edt(mask, sampling=sampling, axes=axes)
        want = edt.distance_transform_edt_plain(mask, sampling=sampling,
                                                axes=axes)
        max_err = max(max_err, _compare(name, got, want, exact))
    for i, (name, m, n, s) in enumerate([("ragged n=37", 1000, 37, 1.0),
                                         ("ragged n=130", 777, 130, 1.0),
                                         ("ragged m", 12345, 100, 1.0),
                                         ("rows s=0.7", 5000, 200, 0.7)]):
        f = _scanlines(m, n, seed=i, device=device)
        max_err = max(max_err, _compare(name, edt.minplus_cuda(f, s),
                                        edt.minplus_plain(f, s), s == 1.0))
    v = _scanlines(7 * 45, 33, seed=9, device=device).reshape(7, 45, 33)
    for ax in range(3):
        max_err = max(max_err, _compare(
            f"ragged in place axis {ax}", edt.minplus_axis_cuda(v, ax),
            _plain_axis(v, ax)))
    return timed, max_err


# ---------------------------------------------------------------------------
# phases 3 and 4: the workflow
# ---------------------------------------------------------------------------

def write_volume(path: str, data: np.ndarray, block) -> None:
    """``data`` as ``bmap`` in ``block`` chunks (a 4-d channel volume in
    chunks of all its channels)."""
    from cluster_tools_tpu_torch.core.storage import file_reader

    chunks = list(block) if data.ndim == 3 else [data.shape[0]] + list(block)
    with file_reader(path) as f:
        ds = f.require_dataset("bmap", shape=data.shape, chunks=chunks,
                               dtype=data.dtype)
        ds[:] = data


def read_status(tmp: str):
    """Status JSONs of the tasks that ran in ``tmp``, by task (a plain
    task's status file is empty)."""
    status = {}
    for name in sorted(os.listdir(tmp)):
        if name.endswith(".status") and \
                os.path.getsize(os.path.join(tmp, name)):
            with open(os.path.join(tmp, name)) as fh:
                st = json.load(fh)
            status[st.get("task", name[:-len(".status")])] = st
    return status


def timed_build(wf, device: str) -> float:
    import torch

    import cluster_tools_tpu_torch as ctp

    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctp.build([wf], raise_on_failure=True)
    if device == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def _build(wf, tmp: str, store: str, ws_key: str, seg_key: str,
           device: str):
    """Build ``wf`` timed; returns (wall s, fragments, segmentation,
    status JSONs by task)."""
    from cluster_tools_tpu_torch.core.storage import file_reader

    wall = timed_build(wf, device)
    with file_reader(store, "r") as f:
        ws, seg = f[ws_key][:], f[seg_key][:]
    return wall, ws, seg, read_status(tmp)


def run_workflow(workdir: str, store: str, block, device: str,
                 task_cfg=None, tag: str = "", target: str = "gpu",
                 mesh_devices: int = 0):
    """``MulticutSegmentationWorkflow(fused=True, target=target)`` with the
    fused task config ``task_cfg`` (default config if None) on ``device``
    (``mesh_devices`` shards for the mesh paths), writing ``ws<tag>`` /
    ``seg<tag>``; returns (wall s, fragments, segmentation, status JSONs
    by task)."""
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir

    cfg_dir = os.path.join(workdir, f"configs{tag}")
    ConfigDir(cfg_dir).write_global_config({"block_shape": list(block),
                                            "device": device,
                                            "mesh_devices": mesh_devices})
    ConfigDir(cfg_dir).write_task_config("fused_segmentation",
                                         task_cfg or {})
    tmp = os.path.join(workdir, f"tmp{tag}")
    wf = ctp.MulticutSegmentationWorkflow(
        input_path=store, input_key="bmap", ws_path=store, ws_key=f"ws{tag}",
        problem_path=os.path.join(workdir, f"problem{tag}.n5"),
        output_path=store, output_key=f"seg{tag}", tmp_folder=tmp,
        config_dir=cfg_dir, max_jobs=os.cpu_count() or 1, target=target,
        n_scales=1, fused=True)
    return _build(wf, tmp, store, f"ws{tag}", f"seg{tag}", device)


def run_split_workflow(workdir: str, store: str, block, device: str,
                       ws_cfg=None, two_pass: bool = False,
                       mask_key: str = ""):
    """The split chain, ``WatershedWorkflow`` ->
    ``MulticutSegmentationWorkflow(fused=False, target="gpu")``, with the
    watershed task config ``ws_cfg`` (default config if None) on
    ``device``, writing ``ws_split`` / ``seg_split`` into ``store``;
    returns (wall s, fragments, segmentation, status JSONs by task)."""
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir

    cfg_dir = os.path.join(workdir, "configs_split")
    ConfigDir(cfg_dir).write_global_config({"block_shape": list(block),
                                            "device": device})
    for name in ("watershed", "watershed_pass1", "watershed_pass2"):
        ConfigDir(cfg_dir).write_task_config(name, ws_cfg or {})
    tmp = os.path.join(workdir, "tmp_split")
    common = dict(tmp_folder=tmp, config_dir=cfg_dir,
                  max_jobs=os.cpu_count() or 1, target="gpu")
    ws = ctp.WatershedWorkflow(
        input_path=store, input_key="bmap", output_path=store,
        output_key="ws_split", two_pass=two_pass,
        mask_path=store if mask_key else "", mask_key=mask_key, **common)
    wf = ctp.MulticutSegmentationWorkflow(
        input_path=store, input_key="bmap", ws_path=store,
        ws_key="ws_split",
        problem_path=os.path.join(workdir, "problem_split.n5"),
        output_path=store, output_key="seg_split", n_scales=1, fused=False,
        dependency=ws, **common)
    return _build(wf, tmp, store, "ws_split", "seg_split", device)


def contingency(a: np.ndarray, b: np.ndarray):
    """The port's ``ContingencyTable`` of two label volumes, its (a, b)
    pairs counted on the card (one int64 key per voxel, ``torch.unique``)
    when both fit 31 bits, else on the host in chunks."""
    import torch

    from cluster_tools_tpu_torch.utils.validation import ContingencyTable

    if a.shape != b.shape:
        raise ValueError("segmentations must have the same size")
    if int(a.max()) >= 2 ** 31 or int(b.max()) >= 2 ** 31:
        return ContingencyTable.from_arrays_chunked(a, b)
    keys = []
    for z0, z1 in _slabs(a.shape[0]):
        ta, tb = (torch.from_numpy(np.ascontiguousarray(x[z0:z1]).astype(
            "int64")).to("cuda") for x in (a, b))
        keys.append((ta << 32 | tb).reshape(-1))
    uniq, counts = torch.unique(torch.cat(keys), return_counts=True)
    uniq = uniq.cpu().numpy().astype("uint64")
    p_ids = np.stack([uniq >> np.uint64(32), uniq & np.uint64(0xFFFFFFFF)],
                     axis=1)
    return ContingencyTable(p_ids, counts.cpu().numpy().astype("float64"))


def scores(seg: np.ndarray, gt: np.ndarray):
    from cluster_tools_tpu_torch.utils.validation import \
        cremi_score_from_table

    vis, vim, are, cs = cremi_score_from_table(contingency(gt, seg))
    return {"voi_split": vis, "voi_merge": vim, "rand_error": are,
            "cremi": cs}


def voi(a: np.ndarray, b: np.ndarray) -> float:
    from cluster_tools_tpu_torch.utils.validation import compute_vi_scores

    return float(sum(compute_vi_scores(contingency(b, a))))


def card_vs_cpu(root: str, shape, block):
    """The chain on the card and on the CPU (plain versions) on one small
    volume: fragments and segmentations within the VOI gate."""
    from cluster_tools_tpu_torch.utils.synthetic import (as_uint8,
                                                         synthetic_instance)

    _, bnd = synthetic_instance(shape, seed=1)
    data = as_uint8(bnd)
    out = {}
    for device in ("cuda", "cpu"):
        wd = os.path.join(root, f"small_{device}")
        store = os.path.join(wd, "data.n5")
        write_volume(store, data, block)
        wall, ws, seg, _ = run_workflow(wd, store, block, device)
        out[device] = (ws, seg)
        log(f"small-volume {device}: shape {list(shape)} wall_s {wall}")
    v_ws = voi(out["cuda"][0], out["cpu"][0])
    v_seg = voi(out["cuda"][1], out["cpu"][1])
    log(f"small-volume card-vs-cpu VOI: fragments {v_ws} "
        f"segmentation {v_seg} (gate {VOI_GATE})")
    if not (v_ws <= VOI_GATE and v_seg <= VOI_GATE):
        raise AssertionError("card and CPU chains disagree beyond the gate")
    return v_ws, v_seg


#: phase 5's watershed configurations: (name, task config, two_pass, mask)
SPLIT_CONFIGS = [
    ("default", {}, False, False),
    ("two_pass", {}, True, False),
    ("pixel_pitch+apply_dt_2d", {"pixel_pitch": [2, 1, 1],
                                 "apply_dt_2d": True}, False, False),
    ("pixel_pitch+mask", {"pixel_pitch": [2, 1, 1]}, False, True),
]


def split_card_vs_cpu(root: str, shape, block):
    """The split chain on the card and on the CPU on one small volume, in
    each of SPLIT_CONFIGS: fragments and segmentations within the VOI
    gate."""
    from cluster_tools_tpu_torch.core.storage import file_reader
    from cluster_tools_tpu_torch.utils.synthetic import (as_uint8,
                                                         synthetic_instance)

    _, bnd = synthetic_instance(shape, seed=1)
    data = as_uint8(bnd)
    mask = np.ones(shape, "uint8")
    mask[:, :, :shape[2] // 5] = 0
    mask[shape[0] // 2:, shape[1] // 2:, shape[2] // 2:] = 0
    results = {}
    for name, ws_cfg, two_pass, masked in SPLIT_CONFIGS:
        out = {}
        for device in ("cuda", "cpu"):
            wd = os.path.join(root, f"split_{name}_{device}")
            store = os.path.join(wd, "data.n5")
            write_volume(store, data, block)
            if masked:
                with file_reader(store) as f:
                    f.require_dataset("mask", shape=shape, chunks=block,
                                      dtype="uint8")[:] = mask
            wall, ws, seg, _ = run_split_workflow(
                wd, store, block, device, ws_cfg, two_pass,
                mask_key="mask" if masked else "")
            out[device] = (ws, seg)
            log(f"split-small {name} {device}: shape {list(shape)} "
                f"wall_s {wall}")
        v_ws = voi(out["cuda"][0], out["cpu"][0])
        v_seg = voi(out["cuda"][1], out["cpu"][1])
        identical = bool(np.array_equal(out["cuda"][0], out["cpu"][0]))
        log(f"split-small {name} card-vs-cpu VOI: fragments {v_ws} "
            f"segmentation {v_seg} identical_fragments {identical} "
            f"(gate {VOI_GATE})")
        if masked and out["cuda"][0][mask == 0].any():
            raise AssertionError(f"split-small {name}: fragments in the "
                                 "masked-out region")
        if not (v_ws <= VOI_GATE and v_seg <= VOI_GATE):
            raise AssertionError(f"split-small {name}: card and CPU "
                                 "chains disagree beyond the gate")
        results[name] = (v_ws, v_seg)
    return results


def _slabs(n: int, step: int = 25):
    return [(z, min(z + step, n)) for z in range(0, n, step)]


def same_partition(a, b) -> bool:
    """True when two label volumes (arrays or datasets) describe the same
    partition with the same background: every id of one meets exactly one
    id of the other (their contingency table, counted on the card, pairs
    the ids one to one), and 0 meets only 0."""
    t = contingency(np.asarray(a[:]), np.asarray(b[:]))
    zero = (t.p_ids[:, 0] == 0) | (t.p_ids[:, 1] == 0)
    return len(t.p_ids) == len(t.a_ids) == len(t.b_ids) and \
        bool((t.p_ids[zero] == 0).all())


def split_path(root: str, shape, block, gt):
    """The split chain at full block width on phase 4's volume (its store
    still on disk); returns the run's record."""
    import torch

    from cluster_tools_tpu_torch import kernels
    from cluster_tools_tpu_torch.core.blocking import Blocking

    wd = os.path.join(root, "main")
    store = os.path.join(wd, "data.n5")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    wall, ws, seg, status = run_split_workflow(wd, store, block, "cuda")
    launches = kernels.counts()
    peak = torch.cuda.max_memory_allocated()
    n_blocks = Blocking(list(shape), list(block)).n_blocks
    nvox = int(np.prod(shape))
    log(f"split-path wall_s {wall} voxels_per_s {nvox / wall} "
        f"n_blocks {n_blocks} peak_device_bytes {peak}")
    for task, st in status.items():
        log(f"split-path task {task} wall_s {st.get('wall_time')} "
            f"stages {json.dumps(st.get('stages', {}))} "
            f"stage_counts {json.dumps(st.get('stage_counts', {}))}")
    sc = scores(seg, gt)
    n_frag = int(ws.max())
    log(f"split-path quality {json.dumps(sc)} n_fragments {n_frag} "
        f"n_segments {len(np.unique(seg))}")
    del ws, seg
    if not np.isfinite(list(sc.values())).all() or \
            sc["cremi"] > CREMI_GATE:
        raise AssertionError(f"split segmentation quality out of bounds: "
                             f"{sc}")
    t0 = time.perf_counter()
    from cluster_tools_tpu_torch.core.storage import file_reader

    with file_reader(store, "r") as f:
        same = same_partition(f["ws_split"], f["ws"])
    log(f"split-path fragments same partition as fused: {same} "
        f"(check_s {time.perf_counter() - t0})")
    if not same:
        raise AssertionError("split and fused fragments are not the same "
                             "partition")
    redo = status.get("watershed", {}).get("stage_counts", {}).get(
        "device-ws-redo", 0)
    edt_calls = launches["minplus"]
    log(f"split-path minplus launches {edt_calls} blocks {n_blocks} "
        f"ws-redo {redo}")
    if edt_calls != 3 * n_blocks + 3 * redo:
        raise AssertionError(f"min-plus kernel launched {edt_calls} times "
                             f"for {n_blocks} blocks and {redo} redos")
    return {"wall_s": wall, "launches": launches, "n_blocks": n_blocks,
            "peak_device_bytes": peak, "quality": sc}


def main_path(root: str, shape, block):
    """The main path at full block width; returns the run's record and
    the ground truth."""
    import torch

    from cluster_tools_tpu_torch import kernels
    from cluster_tools_tpu_torch.core.blocking import Blocking
    from cluster_tools_tpu_torch.utils.synthetic import (as_uint8,
                                                         synthetic_instance)

    t0 = time.perf_counter()
    gt, bnd = synthetic_instance(shape, seed=0)
    data = as_uint8(bnd)
    del bnd
    wd = os.path.join(root, "main")
    store = os.path.join(wd, "data.n5")
    write_volume(store, data, block)
    log(f"main-path setup_s {time.perf_counter() - t0} shape {list(shape)} "
        f"block {list(block)}")

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    wall, ws, seg, status = run_workflow(wd, store, block, "cuda")
    launches = kernels.counts()
    peak = torch.cuda.max_memory_allocated()
    n_blocks = Blocking(list(shape), list(block)).n_blocks
    nvox = int(np.prod(shape))
    log(f"main-path wall_s {wall} voxels_per_s {nvox / wall} "
        f"n_blocks {n_blocks} peak_device_bytes {peak}")
    for task, st in status.items():
        log(f"main-path task {task} wall_s {st.get('wall_time')} "
            f"stages {json.dumps(st.get('stages', {}))} "
            f"stage_counts {json.dumps(st.get('stage_counts', {}))}")
    sc = scores(seg, gt)
    log(f"main-path quality {json.dumps(sc)} n_fragments {int(ws.max())} "
        f"n_segments {len(np.unique(seg))}")
    if not np.isfinite(list(sc.values())).all() or \
            sc["cremi"] > CREMI_GATE:
        raise AssertionError(f"segmentation quality out of bounds: {sc}")
    fused = status.get("fused_segmentation", {}).get("stage_counts", {})
    redone = fused.get("cap-retry", 0) + fused.get("host-fallback", 0)
    edt_calls = launches["minplus"]
    log(f"main-path minplus launches {edt_calls} blocks {n_blocks} "
        f"cap-retry {fused.get('cap-retry', 0)} "
        f"host-fallback {fused.get('host-fallback', 0)}")
    if edt_calls < 3 * n_blocks or (redone == 0 and
                                    edt_calls != 3 * n_blocks):
        raise AssertionError(f"min-plus kernel launched {edt_calls} times "
                             f"for {n_blocks} blocks")
    return {"wall_s": wall, "launches": launches, "n_blocks": n_blocks,
            "peak_device_bytes": peak, "quality": sc}, gt


# ---------------------------------------------------------------------------
# phases 7 and 8: the affinity path (U-Net inference, mutex watershed)
# ---------------------------------------------------------------------------

#: config 5's volume and geometry (the JAX package's bench_configs.py)
INF_SHAPE = (32, 256, 256)
INF_BLOCK = [16, 128, 128]
AFF_HALO = [4, 16, 16]
#: phase 7's mutex-watershed volume and phase 8's: config 3's width and
#: block shape, its depth cut from 64 to 32 and then to 16 (one layer of
#: blocks, clipped to the volume) to keep the script inside its time limit
MWS_SMALL_SHAPE = (32, 128, 128)
MWS_SMALL_BLOCK = [32, 64, 64]
MWS_SHAPE = (16, 512, 512)
MWS_BLOCK = [32, 256, 256]
#: card against CPU: the float32 U-Net (TF32 off) sums in other orders;
#: the bfloat16 one rounds after sums in other orders (the CPU's own
#: bfloat16 against float32 difference at this width is ~8e-3 / 8e-4)
UNET_F32_ATOL = 1e-4
UNET_BF16_ATOL, UNET_BF16_MEAN = 3e-2, 3e-3
#: InferenceTask card against CPU, uint8 steps and share of voxels
U8_STEPS, U8_SHARE = 8, 0.35
#: the JAX bench's MWS gate (bench_configs.py:332)
RAND_GATE = 0.1
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
PEAK_BF16 = 989e12
UNET_CONFIG = {"out_channels": 12, "features": [16, 32, 64, 128],
               "anisotropic": True}


def affs_from_gt(gt: np.ndarray, offsets, seed: int = 0) -> np.ndarray:
    """uint8 affinities of a ground truth (the JAX bench's recipe,
    bench_configs.py:68-79): 0.9 inside a segment, 0.05 across, uniform
    noise of +-0.05, clipped, requantized as InferenceTask writes them."""
    from cluster_tools_tpu_torch.ops.mws import _offset_slices

    rng = np.random.RandomState(seed)
    affs = np.full((len(offsets),) + gt.shape, 0.05, dtype="float32")
    for c, off in enumerate(offsets):
        sl_a, sl_b = _offset_slices(off, gt.shape)
        affs[c][sl_a] = np.where(gt[sl_a] == gt[sl_b], 0.9, 0.05)
        affs[c] += (rng.rand(*gt.shape).astype("float32") - 0.5) * 0.1
    return np.round(np.clip(affs, 0.0, 1.0) * 255).astype("uint8")


def write_dataset(path: str, key: str, data: np.ndarray, chunks) -> None:
    from cluster_tools_tpu_torch.core.storage import file_reader

    with file_reader(path) as f:
        f.require_dataset(key, shape=data.shape, chunks=list(chunks),
                          dtype=data.dtype)[:] = data


def read_dataset(path: str, key: str, bb=None) -> np.ndarray:
    """A dataset, or its box ``bb``."""
    from cluster_tools_tpu_torch.core.storage import file_reader

    with file_reader(path, "r") as f:
        return f[key][bb if bb is not None else slice(None)]


def unet_cost(model, shape):
    """(FLOP, bytes) of one forward pass of ``model`` on one padded
    block of ``shape``: the multiply-adds of every convolution, and the
    least traffic of a layer-by-layer execution — each conv + GroupNorm +
    GELU layer, max-pool, up-convolution and concatenation reads its
    bfloat16 inputs once and writes its output once; the float32 input
    read once, the float32 output written once."""
    v = int(np.prod(shape))
    cin = model.encoders[0].convs[0].in_channels
    flop, nbytes = 0.0, 4.0 * v * cin
    feats = list(model.features)
    vols = [v]
    for s in model.scale_factors:
        vols.append(vols[-1] // int(np.prod(s)))

    def block(c_in, f, vol):
        return (2.0 * 27 * (c_in * f + f * f) * vol,
                2.0 * (c_in + 2 * f + f) * vol)

    c = cin
    for lv, f in enumerate(feats[:-1]):
        fl, by = block(c, f, vols[lv])
        flop, nbytes = flop + fl, nbytes + by
        nbytes += 2.0 * f * (vols[lv] + vols[lv + 1])  # max-pool
        c = f
    fl, by = block(c, feats[-1], vols[-1])
    flop, nbytes = flop + fl, nbytes + by
    for lv in reversed(range(len(feats) - 1)):
        f_in, f = feats[lv + 1], feats[lv]
        flop += 2.0 * f_in * f * vols[lv]            # up-convolution
        nbytes += 2.0 * (f_in * vols[lv + 1] + f * vols[lv])
        nbytes += 2.0 * (2 * f + 2 * f) * vols[lv]  # concatenation
        fl, by = block(2 * f, f, vols[lv])
        flop, nbytes = flop + fl, nbytes + by
    n_out = model.head.out_channels
    flop += 2.0 * feats[0] * n_out * v
    nbytes += 2.0 * feats[0] * v + 4.0 * n_out * v
    return flop, nbytes


def make_checkpoint(root: str) -> str:
    """The default-width U-Net with weights made from seed 0, written in
    the JAX package's checkpoint format by the port."""
    import torch

    from cluster_tools_tpu_torch.models.checkpoint import save_checkpoint
    from cluster_tools_tpu_torch.models.unet import create_unet

    torch.manual_seed(0)
    model = create_unet(**UNET_CONFIG)
    path = os.path.join(root, "unet_ckpt")
    save_checkpoint(path, UNET_CONFIG, model.state_dict())
    return path


def unet_card_vs_cpu(ckpt: str, raw: np.ndarray):
    """Phase 7a: the default-width U-Net forward on the card and on the
    CPU, float32 and bfloat16, on one standardized padded block of
    config 5's geometry."""
    import torch

    from cluster_tools_tpu_torch.models.checkpoint import load_checkpoint

    outer = [b + 2 * h for b, h in zip(INF_BLOCK, AFF_HALO)]
    x = torch.from_numpy(raw[:outer[0], :outer[1], :outer[2]].astype(
        "float32"))
    x = ((x - x.mean()) / x.std(correction=0))[None, None]
    out = {}
    for dtype, atol, mean_tol in ((torch.float32, UNET_F32_ATOL, None),
                                  (torch.bfloat16, UNET_BF16_ATOL,
                                   UNET_BF16_MEAN)):
        preds = {}
        for tag, dev in (("card", "cuda"), ("cpu", "cpu")):
            model, _ = load_checkpoint(ckpt, dtype=dtype)
            model = model.to(dev)
            with torch.no_grad():
                preds[tag] = model(x.to(dev)).cpu()
        err = (preds["card"] - preds["cpu"]).abs()
        rec = {"dtype": str(dtype), "shape": list(x.shape),
               "max_abs_err": float(err.max()),
               "mean_abs_err": float(err.mean()), "atol": atol,
               "mean_tol": mean_tol}
        log(f"unet-card-vs-cpu {json.dumps(rec)}")
        if not (torch.isfinite(preds["card"]).all()
                and rec["max_abs_err"] <= atol
                and (mean_tol is None or rec["mean_abs_err"] <= mean_tol)):
            raise AssertionError(f"U-Net card and CPU disagree: {rec}")
        out[str(dtype)] = rec
    return out


def run_inference(workdir: str, store: str, raw_key: str, out_key: str,
                  ckpt: str, block, device: str):
    """``InferenceTask`` (12 uint8 channels) on ``device``; returns (wall
    s, status JSON)."""
    import torch

    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir

    cfg_dir = os.path.join(workdir, "configs")
    ConfigDir(cfg_dir).write_global_config({"block_shape": list(block),
                                            "device": device})
    # four reader and writer threads: the uint8 requantization of the
    # 12-channel float32 predictions runs on the host
    ConfigDir(cfg_dir).write_task_config("inference",
                                         {"threads_per_job": 4})
    tmp = os.path.join(workdir, "tmp")
    task = ctp.InferenceTask(
        input_path=store, input_key=raw_key, output_path=store,
        output_key={out_key: [0, UNET_CONFIG["out_channels"]]},
        checkpoint_path=ckpt, halo=AFF_HALO, tmp_folder=tmp,
        config_dir=cfg_dir, max_jobs=1, target="gpu")
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctp.build([task], raise_on_failure=True)
    wall = time.perf_counter() - t0
    with open(os.path.join(tmp, "inference.status")) as fh:
        return wall, json.load(fh)


def inference_card_vs_cpu(root: str, ckpt: str, raw: np.ndarray):
    """Phase 7b: ``InferenceTask`` on config 5's volume on the card and on
    the CPU; the uint8 outputs differ by at most U8_STEPS steps on at
    most U8_SHARE of the voxels."""
    store = os.path.join(root, "inf_small", "data.n5")
    write_dataset(store, "raw", raw, INF_BLOCK)
    for tag, dev in (("card", "cuda"), ("cpu", "cpu")):
        wall, _ = run_inference(os.path.join(root, "inf_small", tag), store,
                                "raw", f"affs_{tag}", ckpt, INF_BLOCK, dev)
        log(f"inference-small {tag}: shape {list(INF_SHAPE)} wall_s {wall}")
    a = read_dataset(store, "affs_card").astype("int16")
    b = read_dataset(store, "affs_cpu").astype("int16")
    steps = np.abs(a - b)
    rec = {"max_steps": int(steps.max()),
           "share_differing": float((steps > 0).mean()),
           "mean_value": float(a.mean()), "bound_steps": U8_STEPS,
           "bound_share": U8_SHARE}
    log(f"inference-small card-vs-cpu {json.dumps(rec)}")
    if a.shape != (UNET_CONFIG["out_channels"],) + INF_SHAPE or \
            rec["max_steps"] > U8_STEPS or \
            rec["share_differing"] > U8_SHARE:
        raise AssertionError(f"InferenceTask card and CPU disagree: {rec}")
    return store, rec


def run_mws(workdir: str, store: str, in_key: str, out_key: str, block,
            device: str, two_pass: bool, impl: str = "auto", halo=None):
    """``MwsWorkflow`` (or ``TwoPassMwsWorkflow``) over DEFAULT_OFFSETS on
    ``device`` with the task config's ``impl``, target ``threads`` (the
    jobs' host scans overlap); returns (wall s, labels, status JSONs by
    task)."""
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir
    from cluster_tools_tpu_torch.models.unet import DEFAULT_OFFSETS

    cfg_dir = os.path.join(workdir, "configs")
    ConfigDir(cfg_dir).write_global_config({"block_shape": list(block),
                                            "device": device})
    for name in ("mws_blocks", "mws_pass1", "mws_pass2"):
        ConfigDir(cfg_dir).write_task_config(name, {"impl": impl})
    tmp = os.path.join(workdir, "tmp")
    wf_cls = ctp.TwoPassMwsWorkflow if two_pass else ctp.MwsWorkflow
    wf = wf_cls(input_path=store, input_key=in_key, output_path=store,
                output_key=out_key,
                offsets=[list(o) for o in DEFAULT_OFFSETS], halo=halo,
                tmp_folder=tmp, config_dir=cfg_dir,
                max_jobs=os.cpu_count() or 1, target="threads")
    wall = timed_build(wf, device)
    return wall, read_dataset(store, out_key), read_status(tmp)


def mws_card_vs_cpu(root: str):
    """Phase 7c: ``MwsWorkflow`` and ``TwoPassMwsWorkflow`` on one stored
    12-channel uint8 affinity volume: the card (impl auto, the
    device-sorted path) and the CPU (impl host, and impl device) write
    identical uint64 labels."""
    from cluster_tools_tpu_torch.models.unet import DEFAULT_OFFSETS
    from cluster_tools_tpu_torch.utils.synthetic import synthetic_instance

    gt, _ = synthetic_instance(MWS_SMALL_SHAPE, seed=2)
    store = os.path.join(root, "mws_small", "data.n5")
    write_dataset(store, "affs", affs_from_gt(gt, DEFAULT_OFFSETS),
                  [1] + MWS_SMALL_BLOCK)
    out = {}
    for two_pass in (False, True):
        name = "two_pass" if two_pass else "single"
        labels = {}
        for where, dev, impl in (("card", "cuda", "auto"),
                                 ("cpu", "cpu", "host"),
                                 ("cpu", "cpu", "device")):
            tag = f"{name}_{where}_{impl}"
            wall, labels[tag], _ = run_mws(
                os.path.join(root, "mws_small", tag), store, "affs",
                f"seg_{tag}", MWS_SMALL_BLOCK, dev, two_pass, impl,
                halo=AFF_HALO)
            log(f"mws-small {tag}: shape {list(MWS_SMALL_SHAPE)} "
                f"wall_s {wall} n_segments {int(labels[tag].max())}")
        ref = labels[f"{name}_card_auto"]
        same = {tag: bool(np.array_equal(lab, ref))
                for tag, lab in labels.items()}
        sc = scores(ref, gt)
        log(f"mws-small {name} identical {json.dumps(same)} "
            f"quality {json.dumps(sc)}")
        if not all(same.values()) or ref.min() < 1:
            raise AssertionError(f"mws-small {name}: card and CPU labels "
                                 f"differ: {same}")
        out[name] = {"identical": same, "quality": sc}
    return out


def config5_chain(root: str, store: str, ckpt: str):
    """Phase 7d: BASELINE config 5 on the card, ``InferenceTask`` ->
    ``MwsWorkflow`` over the U-Net's 12 channels (config 5's geometry,
    the MWS without halo)."""
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir
    from cluster_tools_tpu_torch.models.unet import DEFAULT_OFFSETS

    wd = os.path.join(root, "config5")
    cfg_dir = os.path.join(wd, "configs")
    ConfigDir(cfg_dir).write_global_config({"block_shape": INF_BLOCK,
                                            "device": "cuda"})
    common = dict(tmp_folder=os.path.join(wd, "tmp"), config_dir=cfg_dir,
                  max_jobs=1, target="gpu")
    inf = ctp.InferenceTask(
        input_path=store, input_key="raw", output_path=store,
        output_key={"affs_chain": [0, UNET_CONFIG["out_channels"]]},
        checkpoint_path=ckpt, halo=AFF_HALO, **common)
    mws = ctp.MwsWorkflow(
        input_path=store, input_key="affs_chain", output_path=store,
        output_key="seg_chain", offsets=[list(o) for o in DEFAULT_OFFSETS],
        dependency=inf, **common)
    t0 = time.perf_counter()
    ctp.build([mws], raise_on_failure=True)
    wall = time.perf_counter() - t0
    seg = read_dataset(store, "seg_chain")
    n = int(seg.max())
    log(f"config5-chain wall_s {wall} shape {list(seg.shape)} "
        f"n_segments {n}")
    if seg.shape != INF_SHAPE or seg.min() < 1 or \
            len(np.unique(seg)) != n:
        raise AssertionError("config 5 chain: labels not defined on every "
                             "voxel or not consecutive")
    return {"wall_s": wall, "n_segments": n}


def time_forward(ckpt: str, outer):
    """Median CUDA-event time of one default bfloat16 forward pass on an
    outer block reflect-padded to the U-Net's divisor, and its FLOP /
    bytes bounds."""
    import torch

    from cluster_tools_tpu_torch.models.checkpoint import load_checkpoint

    model, _ = load_checkpoint(ckpt)
    model = model.cuda()
    padded = [-(-o // d) * d for o, d in zip(outer, model.min_divisor())]
    x = torch.randn((1, 1) + tuple(padded), device="cuda")
    with torch.no_grad():
        ms = _time_ms(lambda: model(x), reps=5)
        # where the forward's device time goes, by kernel
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    total = sum(e.device_time_total for e in rows) or 1.0
    top = [{"kernel": e.key[:60], "calls": e.count,
            "ms": e.device_time_total / 1e3,
            "share": e.device_time_total / total} for e in rows[:6]]
    flop, nbytes = unet_cost(model, padded)
    return {"padded_block": list(padded), "ms": ms, "flop": flop,
            "bytes": nbytes, "flop_bound_ms": flop / PEAK_BF16 * 1e3,
            "bytes_bound_ms": bytes_bound_ms(nbytes),
            "profile_device_ms": total / 1e3, "profile_top": top}


def inference_path(root: str, ckpt: str):
    """Phase 8a: ``InferenceTask`` with the default-width U-Net on phase
    4's ``(125, 1250, 1250)`` uint8 volume (its store still on disk),
    blocks ``[50, 512, 512]``; the outer block ``(58, 544, 544)`` is
    reflect-padded to ``(60, 544, 544)``."""
    import torch

    from cluster_tools_tpu_torch import kernels
    from cluster_tools_tpu_torch.core.blocking import Blocking

    store = os.path.join(root, "main", "data.n5")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    wall, status = run_inference(os.path.join(root, "inf_main"), store,
                                 "bmap", "affs_unet", ckpt, BLOCK, "cuda")
    launches = kernels.counts()
    peak = torch.cuda.max_memory_allocated()
    n_blocks = Blocking(list(FULL_SHAPE), list(BLOCK)).n_blocks
    nvox = int(np.prod(FULL_SHAPE))
    log(f"inference-path wall_s {wall} voxels_per_s {nvox / wall} "
        f"n_blocks {n_blocks} peak_device_bytes {peak} "
        f"kernel_launches {json.dumps(launches)}")
    log(f"inference-path stages {json.dumps(status.get('stages', {}))} "
        f"stage_counts {json.dumps(status.get('stage_counts', {}))}")
    from cluster_tools_tpu_torch.core.storage import file_reader

    with file_reader(store, "r") as f:
        ds = f["affs_unet"]
        mid = FULL_SHAPE[0] // 2
        sample = ds[:, mid:mid + 2]
    if ds.shape != (UNET_CONFIG["out_channels"],) + FULL_SHAPE or \
            sample.max() == sample.min():
        raise AssertionError("inference path: degenerate affinities")
    fwd = time_forward(ckpt, [b + 2 * h for b, h in zip(BLOCK, AFF_HALO)])
    log(f"inference-path forward {json.dumps(fwd)}")
    return {"wall_s": wall, "n_blocks": n_blocks, "peak_device_bytes": peak,
            "forward": fwd}


def mws_path(root: str, gt: np.ndarray):
    """Phase 8b: ``TwoPassMwsWorkflow`` at the JAX package's config-3
    width on the card: 12-channel uint8 affinities of a ``MWS_SHAPE`` crop
    of phase 4's ground truth, config 3's blocks ``MWS_BLOCK`` (clipped
    to the crop's depth), halo ``[4, 16, 16]``.  The crop is a cut of
    depth (config 3 has 64 slices; 32 until the script's time limit took
    it to 16): the sequential host union-find scan over the edges of each
    block sets its time."""
    import torch

    from cluster_tools_tpu_torch import kernels
    from cluster_tools_tpu_torch.core.blocking import Blocking
    from cluster_tools_tpu_torch.models.unet import DEFAULT_OFFSETS

    crop = np.ascontiguousarray(gt[:MWS_SHAPE[0], :MWS_SHAPE[1],
                                   :MWS_SHAPE[2]])
    store = os.path.join(root, "mws_main", "data.n5")
    t0 = time.perf_counter()
    write_dataset(store, "affs", affs_from_gt(crop, DEFAULT_OFFSETS),
                  [1] + MWS_BLOCK)
    log(f"mws-path setup_s {time.perf_counter() - t0} "
        f"n_cells {len(np.unique(crop))}")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    wall, seg, status = run_mws(os.path.join(root, "mws_main"), store,
                                "affs", "seg", MWS_BLOCK, "cuda", True,
                                halo=AFF_HALO)
    launches = kernels.counts()
    peak = torch.cuda.max_memory_allocated()
    blocking = Blocking(list(MWS_SHAPE), MWS_BLOCK)
    edges = []
    for b in range(blocking.n_blocks):
        outer = blocking.get_block_with_halo(b, AFF_HALO).outer
        shp = [e - s for s, e in zip(outer.begin, outer.end)]
        edges.append(sum(int(np.prod([max(s - abs(o), 0)
                                      for s, o in zip(shp, off)]))
                         for off in DEFAULT_OFFSETS))
    nvox = int(np.prod(MWS_SHAPE))
    log(f"mws-path wall_s {wall} voxels_per_s {nvox / wall} "
        f"n_blocks {blocking.n_blocks} edges_per_block {edges} "
        f"peak_device_bytes {peak} kernel_launches {json.dumps(launches)}")
    for task, st in status.items():
        log(f"mws-path task {task} wall_s {st.get('wall_time')} "
            f"stages {json.dumps(st.get('stages', {}))} "
            f"stage_counts {json.dumps(st.get('stage_counts', {}))}")
    sc = scores(seg, crop)
    log(f"mws-path quality {json.dumps(sc)} n_segments {int(seg.max())} "
        f"(gate: adapted Rand error < {RAND_GATE})")
    if not np.isfinite(list(sc.values())).all() or \
            sc["rand_error"] >= RAND_GATE:
        raise AssertionError(f"MWS quality out of bounds: {sc}")
    return {"wall_s": wall, "peak_device_bytes": peak, "quality": sc,
            "edges_per_block": edges}


# ---------------------------------------------------------------------------
# phases 9 and 10: connected components (BASELINE config 2), stitching,
# node labels and evaluation
# ---------------------------------------------------------------------------

#: config 2's block shape and threshold (bench_configs.py:208-237)
CC_BLOCK = [32, 256, 256]
CC_THRESHOLD = 0.6
#: the smoothing of config 2's random field (bench_configs.py:44-53)
CC_SIGMA = 4.0
#: chunks of phase 10c's per-block relabelled volume: a face reads two
#: planes, so thin chunks keep the reads near the planes
STITCH_CHUNKS = [10, 128, 128]
#: phase 10c's gate (tests/test_stitching.py: adapted Rand error)
STITCH_RAND_GATE = 0.05
#: phase 10b: blockwise evaluation against the whole-volume scores
SCORE_TOL = 1e-9
#: hooking convergence-check intervals timed in phase 9a
CHECK_INTERVALS = (1, 2, 4, 8)


def blob_volume(shape, seed: int = 0, device: str = "cuda") -> np.ndarray:
    """Config 2's input (bench_configs.py:44-53): a uniform random field
    (numpy, ``seed``) smoothed with sigma 4 — here by the port's separable
    float32 Gaussian on ``device`` — and normalized to [0, 1], float32."""
    import torch

    from cluster_tools_tpu_torch.ops.filters import gaussian

    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.rand(*shape).astype("float32")).to(device)
    x = gaussian(x, CC_SIGMA)
    lo, hi = float(x.min()), float(x.max())
    return ((x - lo) / max(hi - lo, 1e-6)).cpu().numpy()


def config_dir(workdir: str, block, device: str, task_configs=None,
               mesh_devices: int = 0) -> str:
    from cluster_tools_tpu_torch.core.config import ConfigDir

    cfg = os.path.join(workdir, "configs")
    ConfigDir(cfg).write_global_config({"block_shape": list(block),
                                        "device": device,
                                        "mesh_devices": mesh_devices})
    for name, conf in (task_configs or {}).items():
        ConfigDir(cfg).write_task_config(name, conf)
    return cfg


def run_cc(workdir: str, store: str, in_key: str, out_key: str, block,
           device: str, target: str, mask_key: str = "",
           mesh_devices: int = 0):
    """``ThresholdedComponentsWorkflow`` at config 2's threshold on
    ``device``; returns (wall s, labels, maxId, status JSONs by task)."""
    import cluster_tools_tpu_torch as ctp

    tmp = os.path.join(workdir, "tmp")
    wf = ctp.ThresholdedComponentsWorkflow(
        input_path=store, input_key=in_key, output_path=store,
        output_key=out_key, threshold=CC_THRESHOLD, tmp_folder=tmp,
        config_dir=config_dir(workdir, block, device,
                              mesh_devices=mesh_devices),
        max_jobs=os.cpu_count() or 1, target=target,
        mask_path=store if mask_key else "", mask_key=mask_key)
    wall = timed_build(wf, device)
    with ctp.file_reader(store, "r") as f:
        labels, max_id = f[out_key][:], int(f[out_key].attrs["maxId"])
    return wall, labels, max_id, read_status(tmp)


def snake(n: int) -> np.ndarray:
    """A one-voxel-wide serpentine over an ``n x n`` plane: one component
    whose graph diameter is about half the voxel count."""
    mask = np.zeros((n, n), bool)
    mask[::2, :] = True
    mask[1::4, -1] = True
    mask[3::4, 0] = True
    return mask


def ops_card_vs_cpu(vol: np.ndarray):
    """Phase 9a: hooking connected components (single and batched, with
    ragged blocks) and ``count_overlaps`` on the card and on the CPU,
    identical; one block of config 2 timed at several convergence-check
    intervals."""
    import torch

    from cluster_tools_tpu_torch.ops import components as cc
    from cluster_tools_tpu_torch.ops.overlaps import count_overlaps

    block = vol[:CC_BLOCK[0], :CC_BLOCK[1], :CC_BLOCK[2]]
    masks = {"config2 block c1": (block > CC_THRESHOLD, 1),
             "config2 block c3": (block > CC_THRESHOLD, 3),
             "config2 block less c1": (block < 0.45, 1),
             "snake 255": (snake(255), 1)}
    for name, (m, conn) in masks.items():
        out = {}
        for dev in ("cuda", "cpu"):
            out[dev], bodies = cc.connected_components(
                torch.from_numpy(m).to(dev), conn, return_bodies=True)
        same = torch.equal(out["cuda"].cpu(), out["cpu"])
        log(f"cc-ops {name}: shape {list(m.shape)} bodies {bodies} "
            f"n_components {len(torch.unique(out['cpu'])) - 1} "
            f"identical {same}")
        if not same:
            raise AssertionError(f"hooking CC {name}: card != CPU")
    ragged = np.zeros((4, 16, 64, 64), bool)
    for i, ext in enumerate([(16, 64, 64), (16, 20, 64), (5, 64, 64),
                             (5, 20, 9)]):
        sl = (i,) + tuple(slice(0, e) for e in ext)
        ragged[sl] = vol[:ext[0], :ext[1], :ext[2]] > CC_THRESHOLD
    got = cc.connected_components_batched(torch.from_numpy(ragged).cuda())
    want = cc.connected_components_batched(torch.from_numpy(ragged))
    if not torch.equal(got.cpu(), want):
        raise AssertionError("batched hooking CC: card != CPU")
    a = (block * 40).astype("uint64") + np.uint64(2 ** 33)
    b = cc.connected_components(torch.from_numpy(
        block > CC_THRESHOLD)).numpy().astype("uint64")
    for x, y in zip(count_overlaps(a, b, "cuda"),
                    count_overlaps(a, b, "cpu")):
        if not np.array_equal(x, y):
            raise AssertionError("count_overlaps: card != CPU")
    log("cc-ops batched (ragged) and count_overlaps: card == CPU")

    m = torch.from_numpy(block > CC_THRESHOLD).cuda()
    default = cc.HOOK_CHECK_EVERY
    rows = []
    try:
        for every in CHECK_INTERVALS:
            cc.HOOK_CHECK_EVERY = every
            ms = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, bodies = cc.connected_components(m, return_bodies=True)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            rows.append({"check_every": every, "bodies": bodies,
                         "ms": float(np.median(ms))})
    finally:
        cc.HOOK_CHECK_EVERY = default
    log(f"cc-ops check interval on one {CC_BLOCK} block "
        f"{json.dumps(rows)} (default {default})")
    return rows


def cc_card_vs_cpu(root: str, vol: np.ndarray, shape, block):
    """Phase 9b: ``ThresholdedComponentsWorkflow`` on config 2's recipe
    on the resident path (target ``gpu``; on the CPU through
    ``CTT_FORCE_RESIDENT=1``), the per-block path (target ``threads``) and
    the per-block path with a mask, on the card and on the CPU: the same
    labels, and the partition of ``scipy.ndimage.label``."""
    from scipy import ndimage

    wd = os.path.join(root, "cc_small")
    store = os.path.join(wd, "data.n5")
    write_dataset(store, "raw", vol, block)
    mask = np.ones(shape, "uint8")
    mask[:, :, :shape[2] // 5] = 0
    mask[shape[0] // 2:, shape[1] // 2:, shape[2] // 2:] = 0
    write_dataset(store, "mask", mask, block)
    out = {}
    for path, target, masked in (("resident", "gpu", False),
                                 ("per_block", "threads", False),
                                 ("per_block_mask", "gpu", True)):
        ref, n = ndimage.label((vol > CC_THRESHOLD) & (mask > 0) if masked
                               else vol > CC_THRESHOLD)
        labels = {}
        for dev in ("cuda", "cpu"):
            tag = f"{path}_{dev}"
            forced = path == "resident" and dev == "cpu"
            os.environ["CTT_FORCE_RESIDENT"] = "1" if forced else "0"
            try:
                wall, labels[dev], max_id, status = run_cc(
                    os.path.join(wd, tag), store, "raw", f"cc_{tag}", block,
                    dev, target, "mask" if masked else "")
            finally:
                os.environ.pop("CTT_FORCE_RESIDENT", None)
            resident = "merge_offsets" not in status
            log(f"cc-small {tag}: shape {list(shape)} wall_s {wall} "
                f"maxId {max_id} resident {resident} cc_bodies "
                f"{status['block_components']['stage_counts'].get('cc-bodies')}")
            if max_id != n or resident != (path == "resident"):
                raise AssertionError(f"cc-small {tag}: maxId {max_id}, "
                                     f"scipy {n}, resident {resident}")
        same = bool(np.array_equal(labels["cuda"], labels["cpu"]))
        part = same_partition(labels["cuda"], ref)
        log(f"cc-small {path}: card == CPU {same}, partition == scipy "
            f"{part}, n_components {n}")
        if not (same and part):
            raise AssertionError(f"cc-small {path}: labels differ")
        out[path] = n
    return out


def split_per_block(gt: np.ndarray, block, device: str = "cuda"):
    """``gt`` relabelled per block (every block its own consecutive ids,
    the recipe of tests/test_stitching.py:14-35), on ``device``."""
    import torch

    from cluster_tools_tpu_torch.core.blocking import Blocking

    blocking = Blocking(list(gt.shape), list(block))
    split = np.zeros(gt.shape, "uint64")
    offset = 0
    for bid in range(blocking.n_blocks):
        bb = blocking.get_block(bid).bb
        uniq, inv = torch.unique(torch.from_numpy(
            gt[bb].astype("int64")).to(device), return_inverse=True)
        split[bb] = (inv + 1 + offset).cpu().numpy()
        offset += len(uniq)
    return split


def stitch_eval_card_vs_cpu(root: str, gt: np.ndarray, bnd: np.ndarray,
                            block):
    """Phase 9c: ``StitchingWorkflow``, ``SimpleStitchingWorkflow`` (its
    ``StitchingAssignmentsWorkflow`` over a feature-only problem),
    ``NodeLabelWorkflow`` and ``EvaluationWorkflow`` on the card and on
    the CPU: identical outputs."""
    import cluster_tools_tpu_torch as ctp

    wd = os.path.join(root, "stitch_small")
    store = os.path.join(wd, "data.n5")
    split = split_per_block(gt, block)
    write_dataset(store, "split", split, block)
    write_dataset(store, "gt", gt, block)
    write_dataset(store, "bnd", bnd, block)
    with ctp.file_reader(store) as f:
        f["split"].attrs["maxId"] = int(split.max())
    out = {}
    for dev in ("cuda", "cpu"):
        w = os.path.join(wd, dev)
        common = dict(tmp_folder=os.path.join(w, "tmp"),
                      config_dir=config_dir(w, block, dev, {
                          "stitch_faces": {"overlap_threshold": 0.5}}),
                      max_jobs=os.cpu_count() or 1, target="gpu")
        stitch = ctp.StitchingWorkflow(
            labels_path=store, labels_key="split", output_path=store,
            output_key=f"stitched_{dev}", **common)
        problem = os.path.join(w, "problem.n5")
        simple = ctp.SimpleStitchingWorkflow(
            input_path=store, input_key="bnd", ws_path=store,
            ws_key="split", problem_path=problem, output_path=store,
            output_key=f"simple_{dev}", dependency=stitch, **common)
        nodes = ctp.NodeLabelWorkflow(
            ws_path=store, ws_key="split", input_path=store,
            input_key="gt", output_path=store, output_key=f"nodes_{dev}",
            dependency=simple, **common)
        scores_path = os.path.join(w, "scores.json")
        ev = ctp.EvaluationWorkflow(
            seg_path=store, seg_key=f"stitched_{dev}", gt_path=store,
            gt_key="gt", out_path=scores_path, compute_object_vi=True,
            dependency=nodes, **common)
        wall = timed_build(ev, dev)
        with ctp.file_reader(store, "r") as f:
            vols = [f[f"{k}_{dev}"][:] for k in ("stitched", "simple",
                                                 "nodes")]
        with ctp.file_reader(problem, "r") as f:
            vols.append(f["stitch_assignments"][:])
        with open(scores_path) as fh:
            out[dev] = (vols, json.load(fh))
        log(f"stitch-small {dev}: wall_s {wall} n_stitched "
            f"{len(np.unique(vols[0]))} n_simple {len(np.unique(vols[1]))} "
            f"scores {json.dumps({k: v for k, v in out[dev][1].items() if k != 'object-vi'})}")
    same = [bool(np.array_equal(a, b))
            for a, b in zip(out["cuda"][0], out["cpu"][0])]
    same.append(out["cuda"][1] == out["cpu"][1])
    log(f"stitch-small card == CPU (stitched, simple, node labels, "
        f"simple assignments, scores): {same}")
    if not all(same):
        raise AssertionError("stitching / evaluation: card != CPU")
    return same


def cc_path(root: str):
    """Phase 10a: BASELINE config 2 at the size of one CREMI sample —
    ``ThresholdedComponentsWorkflow(target="gpu")`` (the resident path) on
    config 2's recipe at ``(125, 1250, 1250)`` float32, blocks ``[32, 256,
    256]`` (100 blocks), threshold 0.6; the partition held to
    ``scipy.ndimage.label``'s."""
    import torch

    from cluster_tools_tpu_torch import kernels
    from cluster_tools_tpu_torch.core.blocking import Blocking
    from scipy import ndimage

    t0 = time.perf_counter()
    vol = blob_volume(FULL_SHAPE, seed=0)
    wd = os.path.join(root, "cc_main")
    store = os.path.join(wd, "data.n5")
    write_dataset(store, "raw", vol, CC_BLOCK)
    log(f"cc-path setup_s {time.perf_counter() - t0} shape "
        f"{list(FULL_SHAPE)} block {CC_BLOCK}")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    wall, labels, max_id, status = run_cc(wd, store, "raw", "cc", CC_BLOCK,
                                          "cuda", "gpu")
    launches = kernels.counts()
    peak = torch.cuda.max_memory_allocated()
    n_blocks = Blocking(list(FULL_SHAPE), CC_BLOCK).n_blocks
    nvox = int(np.prod(FULL_SHAPE))
    log(f"cc-path wall_s {wall} voxels_per_s {nvox / wall} n_blocks "
        f"{n_blocks} n_components {max_id} peak_device_bytes {peak} "
        f"kernel_launches {json.dumps(launches)}")
    for task, st in status.items():
        log(f"cc-path task {task} wall_s {st.get('wall_time')} "
            f"stages {json.dumps(st.get('stages', {}))} "
            f"stage_counts {json.dumps(st.get('stage_counts', {}))}")
    t0 = time.perf_counter()
    ref, n = ndimage.label(vol > CC_THRESHOLD)
    del vol
    part = same_partition(labels, ref)
    log(f"cc-path partition == scipy {part} n_scipy {n} "
        f"(check_s {time.perf_counter() - t0})")
    if "merge_offsets" in status or max_id != n or not part:
        raise AssertionError("cc path: not the resident path, or the "
                             "partition differs from scipy's")
    return {"wall_s": wall, "n_components": max_id,
            "peak_device_bytes": peak}


def eval_path(root: str, gt: np.ndarray, split_quality):
    """Phase 10b: ``EvaluationWorkflow`` of phase 6's segmentation against
    phase 4's ground truth (the main store, blocks ``[50, 512, 512]``,
    target ``threads``: the jobs' host densification overlaps), held to
    the scores phase 6 computed on the whole volumes."""
    import cluster_tools_tpu_torch as ctp

    store = os.path.join(root, "main", "data.n5")
    write_dataset(store, "gt", gt, BLOCK)
    wd = os.path.join(root, "eval_main")
    out_path = os.path.join(wd, "scores.json")
    wf = ctp.EvaluationWorkflow(
        seg_path=store, seg_key="seg_split", gt_path=store, gt_key="gt",
        out_path=out_path, tmp_folder=os.path.join(wd, "tmp"),
        config_dir=config_dir(wd, BLOCK, "cuda"),
        max_jobs=os.cpu_count() or 1, target="threads")
    wall = timed_build(wf, "cuda")
    with open(out_path) as fh:
        got = json.load(fh)
    status = read_status(os.path.join(wd, "tmp"))
    log(f"eval-path wall_s {wall} scores {json.dumps(got)}")
    for task, st in status.items():
        log(f"eval-path task {task} wall_s {st.get('wall_time')} "
            f"stages {json.dumps(st.get('stages', {}))}")
    pairs = {"voi_split": "vi-split", "voi_merge": "vi-merge",
             "rand_error": "adapted-rand-error", "cremi": "cremi-score"}
    diffs = {k: abs(got[v] - split_quality[k]) for k, v in pairs.items()}
    log(f"eval-path against phase 6's scores: {json.dumps(diffs)} "
        f"(gate {SCORE_TOL})")
    if not all(d <= SCORE_TOL for d in diffs.values()):
        raise AssertionError(f"blockwise evaluation differs: {diffs}")
    return {"wall_s": wall, "diffs": diffs}


def stitch_path(root: str, gt: np.ndarray):
    """Phase 10c: ``StitchingWorkflow`` (overlap threshold 0.5) on phase
    4's ground truth relabelled per block of ``[50, 512, 512]``, on the
    card and on the CPU: identical labels, and an adapted Rand error
    below 0.05 (the JAX package's test gate).  The ground-truth cells
    that one stitched id covers are counted, not gated: the JAX package's
    mutual-best-overlap rule merges two cells whose slivers meet across a
    face (``tests/test_torch_stitching.py``
    ``::test_false_merges_are_the_reference_rule``)."""
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.utils.validation import \
        cremi_score_from_table

    t0 = time.perf_counter()
    wd = os.path.join(root, "stitch_main")
    store = os.path.join(wd, "data.n5")
    split = split_per_block(gt, BLOCK)
    write_dataset(store, "split", split, STITCH_CHUNKS)
    n_split = int(split.max())
    with ctp.file_reader(store) as f:
        f["split"].attrs["maxId"] = n_split
    del split
    log(f"stitch-path setup_s {time.perf_counter() - t0} n_split {n_split}")
    out, walls = {}, {}
    for dev in ("cuda", "cpu"):
        w = os.path.join(wd, dev)
        tmp = os.path.join(w, "tmp")
        wf = ctp.StitchingWorkflow(
            labels_path=store, labels_key="split", output_path=store,
            output_key=f"stitched_{dev}", tmp_folder=tmp,
            config_dir=config_dir(w, BLOCK, dev, {
                "stitch_faces": {"overlap_threshold": 0.5}}),
            max_jobs=os.cpu_count() or 1, target="gpu")
        walls[dev] = timed_build(wf, dev)
        with ctp.file_reader(store, "r") as f:
            out[dev] = f[f"stitched_{dev}"][:]
        for task, st in read_status(tmp).items():
            log(f"stitch-path {dev} task {task} wall_s "
                f"{st.get('wall_time')} stages "
                f"{json.dumps(st.get('stages', {}))}")
    identical = bool(np.array_equal(out["cuda"], out["cpu"]))
    table = contingency(gt, out["cuda"])
    vis, vim, are, cremi = cremi_score_from_table(table)
    _, n_cells = np.unique(table.p_ids[:, 1], return_counts=True)
    quality = {"voi_split": vis, "voi_merge": vim, "rand_error": are,
               "cremi": cremi}
    wall, wall_cpu = walls["cuda"], walls["cpu"]
    log(f"stitch-path wall_s {wall} (cpu {wall_cpu}) "
        f"card == CPU {identical} n_stitched {len(table.b_ids)} n_cells "
        f"{len(table.a_ids)} ids_covering_several_cells "
        f"{int((n_cells > 1).sum())} quality {json.dumps(quality)} "
        f"(gate: adapted Rand error < {STITCH_RAND_GATE})")
    if not identical or are >= STITCH_RAND_GATE:
        raise AssertionError("stitching path: card != CPU or adapted Rand "
                             f"error {are} out of bounds")
    return {"wall_s": wall, "rand_error": are}


# ---------------------------------------------------------------------------
# phases 11 and 12: the fused task's other executions, the split
# watershed's options, the lifted multicut and agglomerative clustering
# ---------------------------------------------------------------------------

#: phase 11a's fused executions: (name, fused task config, channel store)
VARIANT_CONFIGS = [
    ("hybrid", {"ws_method": "hybrid"}, False),
    ("legacy", {"ws_method": "legacy"}, False),
    # a 4-d store takes the legacy path under the default ws_method
    ("legacy-4d", {}, True),
]
#: phase 11b's watershed options: (name, watershed task config, two_pass,
#: agglomeration)
WS_OPTIONS = [
    ("apply_ws_2d", {"apply_ws_2d": True}, False, False),
    ("nms", {"non_maximum_suppression": True}, False, False),
    ("flood", {"ws_algorithm": "flood"}, False, False),
    ("flood-two_pass", {"ws_algorithm": "flood"}, True, False),
    ("host", {"impl": "host"}, False, False),
    ("agglomeration", {}, False, True),
]
#: phase 11's card-vs-CPU volume and blocks (four blocks, a quarter of
#: SMALL_SHAPE: the CPU sides dominate the phase)
P11_SHAPE = (32, 128, 128)
P11_BLOCK = [32, 64, 64]
#: the flood's card-vs-CPU volume: its hundreds of stencil bodies per
#: block take tens of seconds per block on the host
FLOOD_SHAPE = (16, 128, 128)
FLOOD_BLOCK = [16, 64, 64]
#: phase 12's crop of phase 4's volume: two blocks (the script's time
#: limit: four through PR 8; ``legacy`` redoes every block, ~6-10 s each)
CROP = (50, 512, 1024)
#: phases 12a/12b's volume: the crop's first block (two blocks before
#: phase 17 came, cut for the time limit, PERF.md section 4)
CROP1 = (50, 512, 512)
#: phases 11c/12c: the lifted prior is the ground truth folded into
#: N_CLASSES semantic classes; lifted edges reach LIFTED_DEPTH hops
N_CLASSES = 8
LIFTED_DEPTH = 2
AGGLO_THRESHOLD = 0.5


def gate_card_vs_cpu(name: str, card: np.ndarray, cpu: np.ndarray) -> float:
    """Card and CPU labels within the VOI gate (identity logged)."""
    v = voi(card, cpu)
    same = bool(np.array_equal(card, cpu))
    log(f"{name} card-vs-cpu VOI {v} identical {same} (gate {VOI_GATE})")
    if not v <= VOI_GATE:
        raise AssertionError(f"{name}: card and CPU disagree beyond the "
                             "gate")
    return v


def run_ws(workdir: str, store: str, block, device: str, ws_cfg,
           two_pass: bool = False, agglomeration: bool = False,
           tag: str = "", target: str = "gpu", mesh_devices: int = 0):
    """``WatershedWorkflow`` (target ``target``) with the watershed task
    config ``ws_cfg`` on ``device``, writing ``ws<tag>``; returns (wall s,
    fragments, status JSONs by task)."""
    import cluster_tools_tpu_torch as ctp

    cfg = config_dir(os.path.join(workdir, f"ws{tag}"), block, device,
                     {n: ws_cfg for n in ("watershed", "watershed_pass1",
                                          "watershed_pass2")},
                     mesh_devices=mesh_devices)
    tmp = os.path.join(workdir, f"tmp_ws{tag}")
    wf = ctp.WatershedWorkflow(
        input_path=store, input_key="bmap", output_path=store,
        output_key=f"ws{tag}", two_pass=two_pass,
        agglomeration=agglomeration, tmp_folder=tmp, config_dir=cfg,
        max_jobs=os.cpu_count() or 1, target=target)
    wall = timed_build(wf, device)
    return wall, read_dataset(store, f"ws{tag}"), read_status(tmp)


def seeds_from_gt(gt: np.ndarray, data: np.ndarray) -> np.ndarray:
    """A sparse seed volume: the ground-truth id (offset by 1000) on a
    grid of voxels away from the boundaries."""
    grid = np.zeros(gt.shape, bool)
    grid[2::4, 8::16, 8::16] = True
    return np.where(grid & (data < 64), gt.astype("uint64") + 1000, 0)


def run_from_seeds(workdir: str, store: str, block, device: str):
    import cluster_tools_tpu_torch as ctp

    tmp = os.path.join(workdir, "tmp_seeds")
    task = ctp.WatershedFromSeedsTask(
        input_path=store, input_key="bmap", seeds_path=store,
        seeds_key="seeds", output_path=store, output_key="ws_seeds",
        tmp_folder=tmp, config_dir=config_dir(os.path.join(workdir, "sd"),
                                              block, device),
        max_jobs=os.cpu_count() or 1, target="gpu")
    wall = timed_build(task, device)
    return wall, read_dataset(store, "ws_seeds")


def run_lifted_agglo(workdir: str, store: str, block, device: str,
                     which: str, tag: str = ""):
    """``LiftedMulticutSegmentationWorkflow`` (prior ``classes``) or
    ``AgglomerativeClusteringWorkflow`` over the fragments ``frags`` of
    ``store`` on ``device``, writing ``seg_<which><tag>``; returns (wall s,
    segmentation)."""
    import cluster_tools_tpu_torch as ctp

    name = f"{which}{tag}"
    common = dict(
        input_path=store, input_key="bmap", ws_path=store, ws_key="frags",
        problem_path=os.path.join(workdir, f"problem_{name}.n5"),
        output_path=store, output_key=f"seg_{name}",
        tmp_folder=os.path.join(workdir, f"tmp_{name}"),
        config_dir=config_dir(os.path.join(workdir, name), block, device),
        max_jobs=os.cpu_count() or 1, target="gpu")
    if which == "lifted":
        wf = ctp.LiftedMulticutSegmentationWorkflow(
            labels_path=store, labels_key="classes", lifted_prefix="cls",
            nh_graph_depth=LIFTED_DEPTH, **common)
    else:
        wf = ctp.AgglomerativeClusteringWorkflow(threshold=AGGLO_THRESHOLD,
                                                 **common)
    wall = timed_build(wf, device)
    return wall, read_dataset(store, f"seg_{name}")


def write_fragments(store: str, frags: np.ndarray, gt: np.ndarray,
                    block) -> None:
    """Consecutive fragments (``frags``, with maxId) and the lifted prior
    (``classes``: the ground truth folded into N_CLASSES classes)."""
    _, inv = np.unique(frags, return_inverse=True)
    frags = (inv.reshape(frags.shape) + 1).astype("uint64")
    write_dataset(store, "frags", frags, block)
    from cluster_tools_tpu_torch.core.storage import file_reader

    with file_reader(store) as f:
        f["frags"].attrs["maxId"] = int(frags.max())
    write_dataset(store, "classes", (gt.astype("uint64") % N_CLASSES) + 1,
                  block)


def variants_card_vs_cpu(root: str, data: np.ndarray, block):
    """Phase 11a: the fused chain with ws_method ``hybrid`` and ``legacy``
    and on a 4-d store (which takes ``legacy``), card against CPU."""
    for name, cfg, channels in VARIANT_CONFIGS:
        vol = np.stack([data, data]) if channels else data
        out = {}
        for device in ("cuda", "cpu"):
            wd = os.path.join(root, f"variant_{name}_{device}")
            store = os.path.join(wd, "data.n5")
            write_volume(store, vol, block)
            wall, ws, seg, status = run_workflow(wd, store, block, device,
                                                 cfg)
            counts = status["fused_segmentation"]["stage_counts"]
            log(f"variant-small {name} {device}: shape {list(vol.shape)} "
                f"wall_s {wall} stage_counts {json.dumps(counts)}")
            if "h2d-upload" in counts:
                raise AssertionError(f"{name}: the resident path ran")
            out[device] = (ws, seg)
        gate_card_vs_cpu(f"variant-small {name} fragments", *[
            out[d][0] for d in ("cuda", "cpu")])
        gate_card_vs_cpu(f"variant-small {name} segmentation", *[
            out[d][1] for d in ("cuda", "cpu")])


def ws_options_card_vs_cpu(root: str, data: np.ndarray, gt: np.ndarray,
                           flood_data: np.ndarray):
    """Phase 11b: ``WatershedWorkflow`` with each of WS_OPTIONS (the flood
    on FLOOD_SHAPE) and ``WatershedFromSeedsTask``, card against CPU."""
    for name, ws_cfg, two_pass, agglo in WS_OPTIONS:
        flood = ws_cfg.get("ws_algorithm") == "flood"
        vol, block = ((flood_data, FLOOD_BLOCK) if flood
                      else (data, P11_BLOCK))
        out = {}
        for device in ("cuda", "cpu"):
            wd = os.path.join(root, f"wsopt_{name}_{device}")
            store = os.path.join(wd, "data.n5")
            write_volume(store, vol, block)
            wall, ws, _ = run_ws(wd, store, block, device, ws_cfg, two_pass,
                                 agglo)
            log(f"ws-small {name} {device}: shape {list(vol.shape)} "
                f"wall_s {wall} n_fragments {int(ws.max())}")
            out[device] = ws
        gate_card_vs_cpu(f"ws-small {name}", out["cuda"], out["cpu"])
    out = {}
    seeds = seeds_from_gt(gt, data)
    for device in ("cuda", "cpu"):
        wd = os.path.join(root, f"seeds_{device}")
        store = os.path.join(wd, "data.n5")
        write_volume(store, data, P11_BLOCK)
        write_dataset(store, "seeds", seeds, P11_BLOCK)
        wall, ws = run_from_seeds(wd, store, P11_BLOCK, device)
        log(f"ws-small from_seeds {device}: wall_s {wall} "
            f"n_ids {len(np.unique(ws))}")
        if not set(np.unique(ws)) <= set(np.unique(seeds)):
            raise AssertionError("WatershedFromSeedsTask made new ids")
        out[device] = ws
    gate_card_vs_cpu("ws-small from_seeds", out["cuda"], out["cpu"])


def lifted_agglo_card_vs_cpu(root: str, data: np.ndarray, gt: np.ndarray):
    """Phase 11c: ``LiftedMulticutSegmentationWorkflow`` and
    ``AgglomerativeClusteringWorkflow`` over the same fragments (the
    default watershed on the card), card against CPU."""
    wd = os.path.join(root, "lifted_small")
    store = os.path.join(wd, "data.n5")
    write_volume(store, data, P11_BLOCK)
    _, frags, _ = run_ws(wd, store, P11_BLOCK, "cuda", {})
    write_fragments(store, frags, gt, P11_BLOCK)
    for which in ("lifted", "agglo"):
        out = {}
        for device in ("cuda", "cpu"):
            wall, seg = run_lifted_agglo(wd, store, P11_BLOCK, device,
                                         which, tag=f"_{device}")
            log(f"{which}-small {device}: wall_s {wall} n_segments "
                f"{len(np.unique(seg))} quality {json.dumps(scores(seg, gt))}")
            out[device] = seg
        gate_card_vs_cpu(f"{which}-small", out["cuda"], out["cpu"])


def write_crop(root: str, block, gt: np.ndarray, crop=None,
               name: str = "crop"):
    """Phase 12's volume: the ``crop`` (default CROP) of phase 4's input
    (its store still on disk) in a store of its own; returns the store and
    the ground truth there."""
    box = tuple(slice(0, c) for c in (crop or CROP))
    store = os.path.join(root, name, "data.n5")
    write_volume(store, read_dataset(os.path.join(root, "main", "data.n5"),
                                     "bmap", box), block)
    return store, np.ascontiguousarray(gt[box])


def variants_path(root: str, store: str, block, gt_c: np.ndarray):
    """Phase 12a: the fused chain with ws_method ``hybrid`` and ``legacy``
    on a crop (the first block of phase 12's crop, CROP1): CREMI under its
    gate, the VOI to phase 4's outputs there logged, the kernel's launches
    counted (3 per block, plus 3 per legacy redo); returns launches by
    method."""
    import torch

    from cluster_tools_tpu_torch import kernels
    from cluster_tools_tpu_torch.core.blocking import Blocking

    crop = gt_c.shape
    main = os.path.join(root, "main", "data.n5")
    box = tuple(slice(0, c) for c in crop)
    n_blocks = Blocking(list(crop), list(block)).n_blocks
    launches = {}
    for method in ("hybrid", "legacy"):
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        wall, ws, seg, status = run_workflow(
            os.path.dirname(store), store, block, "cuda",
            {"ws_method": method}, tag=f"_{method}")
        edt_calls = kernels.counts()["minplus"]
        peak = torch.cuda.max_memory_allocated()
        log(f"variant-path {method} shape {list(crop)} wall_s {wall} "
            f"voxels_per_s {int(np.prod(crop)) / wall} n_blocks {n_blocks} "
            f"peak_device_bytes {peak}")
        for task, st in status.items():
            log(f"variant-path {method} task {task} wall_s "
                f"{st.get('wall_time')} stages "
                f"{json.dumps(st.get('stages', {}))} stage_counts "
                f"{json.dumps(st.get('stage_counts', {}))}")
        sc = scores(seg, gt_c)
        # against phase 4's ``device`` method: another watershed (the
        # host flood on uint8 levels; the full-resolution basins) makes
        # other fragments, so the VOIs are logged and the quality gated
        v_ws = voi(ws, read_dataset(main, "ws", box))
        v_seg = voi(seg, read_dataset(main, "seg", box))
        redo = status["fused_segmentation"]["stage_counts"].get(
            "device-ws-redo", 0)
        log(f"variant-path {method} quality {json.dumps(sc)} "
            f"vs-device VOI fragments {v_ws} segmentation {v_seg} "
            f"minplus launches {edt_calls} ws-redo {redo}")
        if edt_calls != 3 * n_blocks + 3 * redo:
            raise AssertionError(f"{method}: min-plus kernel launched "
                                 f"{edt_calls} times for {n_blocks} blocks "
                                 f"and {redo} redos")
        if not (np.isfinite(list(sc.values())).all()
                and sc["cremi"] <= CREMI_GATE and ws.shape == crop):
            raise AssertionError(f"{method}: segmentation quality out of "
                                 f"bounds: {sc}")
        launches[method] = edt_calls
    return launches


def crop_paths(root: str, store: str, block, gt_c: np.ndarray,
               ws_store: str, ws_gt: np.ndarray):
    """Phase 12b on ``ws_store`` (CROP1, the first block of phase 12's
    crop): the split watershed's ``apply_ws_2d``, ``flood`` and
    ``non_maximum_suppression`` options and the block-local agglomeration;
    then phase 12c on the crop (CROP, two blocks of ``block``): the lifted
    multicut and agglomerative clustering segmentations over phase 4's
    fragments there; returns the kernel launches by option."""
    from cluster_tools_tpu_torch import kernels
    from cluster_tools_tpu_torch.core.blocking import Blocking

    crop = tuple(slice(0, c) for c in CROP)
    main = os.path.join(root, "main", "data.n5")
    wd = os.path.dirname(ws_store)
    nvox = int(np.prod(ws_gt.shape))
    n_blocks = Blocking(list(ws_gt.shape), list(block)).n_blocks
    expect = {"apply_ws_2d": 2 * n_blocks, "flood": 3 * n_blocks,
              "nms": 3 * n_blocks, "agglomeration": 3 * n_blocks}
    launches = {}
    for name, ws_cfg, _, agglo in WS_OPTIONS:
        if name not in expect:
            continue
        kernels.reset_counts()
        wall, ws, status = run_ws(wd, ws_store, block, "cuda", ws_cfg,
                                  agglomeration=agglo, tag=f"_{name}")
        edt_calls = kernels.counts()["minplus"]
        redo = status.get("watershed", {}).get("stage_counts", {}).get(
            "device-ws-redo", 0)
        sc = scores(ws, ws_gt)
        log(f"crop-ws {name} wall_s {wall} voxels_per_s "
            f"{nvox / wall} n_blocks {n_blocks} n_fragments "
            f"{int(ws.max())} minplus launches {edt_calls} ws-redo {redo} "
            f"quality {json.dumps(sc)}")
        for task, st in status.items():
            log(f"crop-ws {name} task {task} wall_s {st.get('wall_time')} "
                f"stages {json.dumps(st.get('stages', {}))}")
        if edt_calls != expect[name] + 3 * redo:
            raise AssertionError(f"crop-ws {name}: min-plus kernel launched "
                                 f"{edt_calls} times")
        if not np.isfinite(list(sc.values())).all() or \
                ws.shape != ws_gt.shape:
            raise AssertionError(f"crop-ws {name}: bad fragments")
        launches[name] = edt_calls
    write_fragments(store, read_dataset(main, "ws", crop), gt_c, block)
    kernels.reset_counts()
    for which in ("lifted", "agglo"):
        wall, seg = run_lifted_agglo(os.path.dirname(store), store, block,
                                     "cuda", which)
        sc = scores(seg, gt_c)
        log(f"crop-{which} wall_s {wall} n_segments {len(np.unique(seg))} "
            f"quality {json.dumps(sc)}")
        if not np.isfinite(list(sc.values())).all() or seg.shape != CROP:
            raise AssertionError(f"crop-{which}: bad segmentation")
    if kernels.counts()["minplus"] != 0:
        raise AssertionError("phase 12c launched the min-plus kernel")
    return launches


# ---------------------------------------------------------------------------
# phase 13: serving — the resident server over the fused ROI pipeline, its
# load harness and SLO engine, and the proofreading edit lane
# ---------------------------------------------------------------------------

#: 13a's card-vs-CPU ROI and geometry
SERVE_SMALL = (32, 128, 128)
SERVE_SMALL_GEOM = {"block_shape": (16, 64, 64), "halo": (2, 8, 8)}
#: 13b's canonical ROI: four blocks of the main path's depth
SERVE_ROI = (50, 512, 512)
SERVE_GEOM = {"block_shape": (50, 256, 256), "halo": (4, 32, 32)}
#: 13b's open-loop load: 8 requests from 4 tenants at 1 request/s
SERVE_LOAD = {"seed": 7, "rate_hz": 1.0, "n_requests": 8, "n_tenants": 4}
#: 13c: merges and splits mined from the crop's problem, and the bulk
#: requests queued from other tenants while they arrive
EDIT_MERGES = 3
EDIT_SPLITS = 3
EDIT_BULK_TENANTS = ("bulk-a", "bulk-b", "bulk-c")
EDIT_BULK_PER_TENANT = 2


def _pipeline_class():
    """The port's ``FusedROIPipeline`` with CUDA events around each block
    call (the card's busy share) and each request's segmentation kept by
    the index of its crop (its score against the ground truth)."""
    import torch

    from cluster_tools_tpu_torch.core.server import FusedROIPipeline

    class Pipeline(FusedROIPipeline):
        def __init__(self, *args, crops=(), **kw):
            super().__init__(*args, **kw)
            self.crop_index = {id(c): i for i, c in enumerate(crops)}
            self.events = []
            self.results = {}

        def prepare(self, volume):
            ctx = super().prepare(volume)
            ctx["crop"] = self.crop_index.get(id(volume))
            return ctx

        def run_block(self, ctx, bid):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = super().run_block(ctx, bid)
            end.record()
            self.events.append((start, end))
            return out

        def finalize(self, ctx, block_results):
            res = super().finalize(ctx, block_results)
            self.results[ctx["crop"]] = res["segmentation"]
            return res

    return Pipeline


def _run_roi(pipe, vol):
    ctx = pipe.prepare(vol)
    blocks = [pipe.run_block(ctx, bid) for bid in range(pipe.n_blocks)]
    return blocks, pipe.finalize(ctx, blocks)


def serve_card_vs_cpu():
    """Phase 13a: ``FusedROIPipeline`` (no server) on the card and on the
    CPU, default config and ``sigma_weights: 0``: identical fragment
    counts, dense labels, edge lists and segmentation, features within
    1e-6; returns the kernel's launches (3 per block on the card)."""
    from cluster_tools_tpu_torch import kernels
    from cluster_tools_tpu_torch.core.server import FusedROIPipeline
    from cluster_tools_tpu_torch.utils.synthetic import (as_uint8,
                                                         synthetic_instance)

    vol = as_uint8(synthetic_instance(SERVE_SMALL, seed=5)[1])
    kernels.reset_counts()
    n_blocks = 0
    for name, cfg in (("default", {}), ("sigma_weights-0",
                                        {"sigma_weights": 0.0})):
        runs = {}
        for device in ("cuda", "cpu"):
            pipe = FusedROIPipeline(SERVE_SMALL, config=cfg, device=device,
                                    **SERVE_SMALL_GEOM)
            t0 = time.perf_counter()
            runs[device] = _run_roi(pipe, vol)
            log(f"serve-small {name} {device} wall_s "
                f"{time.perf_counter() - t0}")
        n_blocks += pipe.n_blocks
        (cb, cres), (hb, hres) = runs["cuda"], runs["cpu"]
        feat_err = 0.0
        for bid, (c, h) in enumerate(zip(cb, hb)):
            if c[0] != h[0] or not np.array_equal(c[1], h[1]) or \
                    not np.array_equal(c[2], h[2]):
                raise AssertionError(f"serve-small {name} block {bid}: "
                                     "card != CPU fragments or edges")
            feat_err = max(feat_err, float(np.abs(c[3] - h[3]).max())
                           if len(c[3]) else 0.0)
        if feat_err > 1e-6 or not np.array_equal(cres["segmentation"],
                                                 hres["segmentation"]):
            raise AssertionError(f"serve-small {name}: card != CPU "
                                 f"(features max abs err {feat_err})")
        log(f"serve-small {name} card == CPU: n_fragments "
            f"{cres['n_fragments']} n_segments {cres['n_segments']} "
            f"n_edges {cres['n_edges']} feats max abs err {feat_err}")
    launches = kernels.counts()["minplus"]
    if launches != 3 * n_blocks:
        raise AssertionError(f"phase 13a: min-plus kernel launched "
                             f"{launches} times for {n_blocks} card blocks")
    return launches


def serve_crops(root: str, gt: np.ndarray, n: int):
    """``n`` ROI crops of phase 4's volume at seeded offsets, and the
    ground truth there."""
    rng = np.random.RandomState(SERVE_LOAD["seed"])
    main = os.path.join(root, "main", "data.n5")
    crops, gts = [], []
    for _ in range(n):
        off = [int(rng.randint(0, s - r + 1))
               for s, r in zip(FULL_SHAPE, SERVE_ROI)]
        box = tuple(slice(o, o + r) for o, r in zip(off, SERVE_ROI))
        crops.append(np.ascontiguousarray(read_dataset(main, "bmap", box)))
        gts.append(gt[box])
    return crops, gts


def _request_rows(workdir: str):
    rows = []
    for name in sorted(os.listdir(workdir)):
        if name.startswith("request_") and name.endswith(".status"):
            with open(os.path.join(workdir, name)) as fh:
                rows.append(json.load(fh))
    return rows


def serve_path(root: str, crops, gts):
    """Phase 13b: the min-plus kernel against its plain version on the
    serving outer block, then ``loadgen.run_threaded`` drives the port's
    resident server over ``FusedROIPipeline`` on the card at SERVE_ROI;
    every request done, warm (no compile, no load from ``_build/``), one
    ``sync-execute`` per block and CREMI under its gate, 3 launches per
    block, the metrics snapshot lint-clean; returns (launches, the
    kernel's max abs error, the pipeline)."""
    import torch

    from cluster_tools_tpu_torch import kernels
    from cluster_tools_tpu_torch.core import loadgen, slo, telemetry

    spec = loadgen.LoadSpec(**SERVE_LOAD)
    schedule = loadgen.generate_schedule(spec)
    by_arrival = {a.t: crops[i] for i, a in enumerate(schedule)}
    pipe = _pipeline_class()(SERVE_ROI, crops=crops, **SERVE_GEOM)
    _, max_err, _ = block_vs_plain(pipe.outer_shape)
    log(f"serve-kernel outer block {list(pipe.outer_shape)} kernel == plain"
        f", max abs err {max_err}")
    t0 = time.perf_counter()
    pipe.ensure_compiled()
    log(f"serve warm-up ensure_compiled_s {time.perf_counter() - t0}")
    pipe.events.clear()
    workdir = os.path.join(root, "serve")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    row = loadgen.run_threaded(
        spec, workdir, pipeline=pipe, slo_engine=slo.SLOEngine(),
        volume_fn=lambda a: by_arrival[a.t], drain_timeout=600.0)
    torch.cuda.synchronize()
    launches = kernels.counts()["minplus"]
    peak = torch.cuda.max_memory_allocated()
    # CUDA events around whole run_block calls: the card's busy time
    # plus the stream's idle gaps while the host dispatches, so an upper
    # bound on the busy share
    block_call_ms = sum(s.elapsed_time(e) for s, e in pipe.events)
    statuses = _request_rows(workdir)
    wall = row["wall_s"]
    lat = np.asarray([st["wall_time"] for st in statuses])
    stages = {}
    for st in statuses:
        for k, v in st["stages"].items():
            stages[k] = stages.get(k, 0.0) + v
    nvox = len(statuses) * int(np.prod(SERVE_ROI))
    log(f"serve-load wall_s {wall} served {row['served']} failed "
        f"{row['failed']} drained {row['drained']} requests_per_s "
        f"{len(statuses) / wall} voxels_per_s {nvox / wall} latency_s p50 "
        f"{np.percentile(lat, 50)} p95 {np.percentile(lat, 95)} max "
        f"{lat.max()} peak_device_bytes {peak} block_call_ms "
        f"{block_call_ms} block_call_share {block_call_ms / 1e3 / wall} "
        f"block_calls "
        f"{len(pipe.events)} minplus launches {launches}")
    log(f"serve-load stage_sums_s {json.dumps(stages)}")
    log(f"serve-load lanes {json.dumps(row['lanes'])} slo_overload "
        f"{row['slo']['overload']}")
    n_blocks = pipe.n_blocks
    for st in statuses:
        log(f"serve-request {st['request']} lane {st['lane']} state "
            f"{st['state']} wall_time {st['wall_time']} queue_wait_s "
            f"{st['queue_wait_s']} exec_cache {json.dumps(st['exec_cache'])}"
            f" stages {json.dumps(st['stages'])} n_fragments "
            f"{st.get('n_fragments')} n_segments {st.get('n_segments')}")
        if st["state"] != "done" or st["error"] is not None:
            raise AssertionError(f"request {st['request']}: {st['state']} "
                                 f"{st['error']}")
        # ``hits`` only records that the request resolved the libraries;
        # no compile and no load from ``_build/`` is what makes it warm
        if st["exec_cache"].get("compiles", 0) != 0 or \
                st["exec_cache"].get("disk_hits", 0) != 0 or \
                st["exec_cache"].get("hits", 0) < 1:
            raise AssertionError(f"request {st['request']} not warm: "
                                 f"{st['exec_cache']}")
        if st["stage_counts"].get("sync-execute") != n_blocks:
            raise AssertionError(f"request {st['request']}: stage counts "
                                 f"{st['stage_counts']}")
    if len(statuses) != spec.n_requests or row["served"] != \
            spec.n_requests or not row["drained"]:
        raise AssertionError(f"served {row['served']} of "
                             f"{spec.n_requests} requests")
    for i, seg in sorted(pipe.results.items()):
        sc = scores(seg, gts[i])
        log(f"serve-quality crop {i} {json.dumps(sc)}")
        if not np.isfinite(list(sc.values())).all() or \
                sc["cremi"] > CREMI_GATE:
            raise AssertionError(f"crop {i}: quality out of bounds {sc}")
    if sorted(pipe.results) != list(range(spec.n_requests)):
        raise AssertionError(f"scored crops {sorted(pipe.results)}")
    with open(os.path.join(workdir, "metrics.prom")) as fh:
        errors = telemetry.lint_prometheus(fh.read())
    if errors:
        raise AssertionError(f"metrics.prom lint: {errors[:5]}")
    if launches != 3 * n_blocks * spec.n_requests:
        raise AssertionError(f"phase 13b: min-plus kernel launched "
                             f"{launches} times")
    return launches, max_err, pipe


def _edit_pairs(session, table, n_pairs, same_segment):
    """Disjoint adjacent fragment pairs sharing a subproblem block, in
    the same (split) or different (merge) segments: a deterministic scan
    over the s0 edge list."""
    used, out = set(), []
    for u, v in session.base_uv:
        ou, ov = int(session.s0_nodes[u]), int(session.s0_nodes[v])
        if ou == 0 or ov == 0 or ou in used or ov in used:
            continue
        if bool(table[ou] == table[ov]) != same_segment:
            continue
        if not session.affected_blocks([ou, ov]):
            continue
        out.append((ou, ov))
        used.update((ou, ov))
        if len(out) == n_pairs:
            break
    return out


def edit_lane(root: str, store: str, pipe, crops):
    """Phase 13c: the multicut problem of phase 12's crop over phase 4's
    fragments (``n_scales=1``), an ``EditPipeline`` on the ``edit`` lane
    of a server whose default pipeline is 13b's; 3 merges and 3 splits
    from their own tenant while other tenants' bulk requests queue.  Each
    edit's incremental result equals the from-scratch solve, only the
    touched output blocks change, every edit finishes before the bulk
    requests still queued when it arrived; returns the kernel's launches
    (the bulk requests': the edits run on the host)."""
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch import kernels
    from cluster_tools_tpu_torch.core.blocking import Blocking
    from cluster_tools_tpu_torch.core.server import \
        ResidentSegmentationServer
    from cluster_tools_tpu_torch.edits import (EditLog, EditPipeline,
                                               EditSession, stable_relabel)

    wd = os.path.join(root, "edits")
    tmp = os.path.join(wd, "tmp")
    problem = os.path.join(wd, "problem.n5")
    wf = ctp.MulticutSegmentationWorkflow(
        input_path=store, input_key="bmap", ws_path=store, ws_key="frags",
        problem_path=problem, output_path=store, output_key="seg_edit",
        tmp_folder=tmp, config_dir=config_dir(wd, BLOCK, "cuda"),
        max_jobs=os.cpu_count() or 1, target="gpu", n_scales=1,
        fused=False)
    wall = timed_build(wf, "cuda")
    assignments = os.path.join(tmp, "multicut_assignments.npy")
    frags = read_dataset(store, "frags")
    seg_before = read_dataset(store, "seg_edit")
    table0 = np.load(assignments)
    session = EditSession(problem)
    log(f"edit-problem wall_s {wall} n_nodes {session.n_nodes} n_edges "
        f"{len(session.base_uv)} n_subproblems {session.blocking.n_blocks}")
    stream = ([("merge", p) for p in _edit_pairs(session, table0,
                                                 EDIT_MERGES, False)]
              + [("split", p) for p in _edit_pairs(session, table0,
                                                   EDIT_SPLITS, True)])
    if len(stream) != EDIT_MERGES + EDIT_SPLITS:
        raise AssertionError(f"mined {len(stream)} edits")

    tables = []

    class Lane(EditPipeline):
        """The edit lane, keeping the lookup table each edit left."""

        def finalize(self, ctx, block_results):
            res = super().finalize(ctx, block_results)
            tables.append(np.load(self.assignment_path))
            return res

    elog = EditLog(os.path.join(wd, "edits.jsonl"))
    lane = Lane(session, elog, assignments, ws_path=store, ws_key="frags",
                output_path=store, output_key="seg_edit")
    kernels.reset_counts()
    srv = ResidentSegmentationServer(os.path.join(wd, "srv"), pipe,
                                     lane_pipelines={"edit": lane})
    bulk = [srv.submit(t, crops[(i * len(EDIT_BULK_TENANTS) + j)
                                % len(crops)])
            for i in range(EDIT_BULK_PER_TENANT)
            for j, t in enumerate(EDIT_BULK_TENANTS)]
    srv.start()
    try:
        # edits arrive once the first bulk request is on the card
        deadline = time.monotonic() + 60.0
        while bulk[0]._request.started_at is None:
            if time.monotonic() > deadline:
                raise AssertionError("phase 13c: first bulk request never "
                                     "started")
            time.sleep(0.01)
        edits = [srv.submit("proofreader", {"op": op, "fragments": list(p)},
                            lane="edit") for op, p in stream]
        if not srv.drain(timeout=600):
            raise AssertionError("phase 13c: server did not drain")
    finally:
        srv.shutdown(drain=False)
    launches = kernels.counts()["minplus"]
    results = [h.result(0) for h in edits]
    for h in bulk:
        h.result(0)
    for h, res in zip(edits, results):
        # the handle exposes no timestamps: they are on its request
        r = h._request
        # bulk requests not yet claimed when the edit arrived
        queued = [b._request for b in bulk
                  if b._request.started_at > r.submitted_at]
        overtaken = [q.req_id for q in queued
                     if q.finished_at < r.finished_at]
        log(f"edit {res['op']} {res['fragments']} round_trip_s "
            f"{res['round_trip_s']} latency_s "
            f"{r.finished_at - r.submitted_at} queue_wait_s "
            f"{r.started_at - r.submitted_at} affected "
            f"{res['affected_blocks']} touched {res['touched_blocks']} "
            f"changed_fragments {res['changed_fragments']} "
            f"bulk_queued_at_arrival {len(queued)}")
        if overtaken:
            raise AssertionError(f"edit {r.req_id} finished after queued "
                                 f"bulk requests {overtaken}")
    # incremental == scratch after every edit: a fresh session replays
    # the first i edits and solves every subproblem cold
    records = elog.records()
    nodes = session.s0_nodes.astype("int64")
    prev = table0
    for i, table in enumerate(tables):
        scratch = EditSession(problem)
        for rec in records[:i + 1]:
            scratch.apply_edit(rec)
        want = stable_relabel(prev, nodes, scratch.solve(incremental=False))
        if not np.array_equal(table, want):
            raise AssertionError(f"edit {i}: incremental != scratch")
        prev = table
    log(f"edit incremental == scratch for {len(tables)} edits; counters "
        f"{json.dumps(session.counters)}")
    seg_after = read_dataset(store, "seg_edit")
    touched = sorted({b for res in results for b in res["touched_blocks"]})
    blocking = Blocking(list(frags.shape), list(BLOCK))
    for bid in range(blocking.n_blocks):
        bb = blocking.get_block(bid).bb
        if bid in touched:
            ok = np.array_equal(seg_after[bb], prev[frags[bb]])
        else:
            ok = np.array_equal(seg_after[bb], seg_before[bb])
        if not ok:
            raise AssertionError(f"phase 13c: output block {bid} wrong")
    if not np.array_equal(seg_after, prev[frags]):
        raise AssertionError("phase 13c: output != patched table")
    log(f"edit output blocks rewritten {touched} of {blocking.n_blocks}; "
        f"bulk minplus launches {launches}")
    if launches != 3 * pipe.n_blocks * len(bulk):
        raise AssertionError(f"phase 13c: min-plus kernel launched "
                             f"{launches} times for {len(bulk)} bulk "
                             "requests")
    return launches


# ---------------------------------------------------------------------------
# phase 14: filter banks and the workflows that use them — filter-bank
# edge features, pixel features, pyramids, the object fit, post-processing
# ---------------------------------------------------------------------------

#: 14a's card-vs-CPU volume and blocks (phase 11's)
P14_SHAPE = (32, 128, 128)
P14_BLOCK = [32, 64, 64]
#: 14a's filter scales (the pixel features' DEFAULT_FEATURES scales)
P14_SIGMAS = (0.7, 1.6, 3.5)
FILTER_NAMES = ("gaussianSmoothing", "gaussianGradientMagnitude",
                "laplacianOfGaussian")
#: the split chain's filter bank in 14a and 14b: 6 responses, 55 columns
FILTER_BANK = {"filters": list(FILTER_NAMES), "sigmas": [1.6, 3.5]}
#: the tests' tolerances: filter responses on [0, 1] data, the linear
#: resize (tests/test_torch_filters.py, tests/test_torch_downscaling.py)
FILTER_RTOL, FILTER_ATOL = 1e-4, 1e-5
RESIZE_ATOL = 1e-6
#: the object fit: 14a erodes by 4 (its CPU side's time), 14b by the task
#: default 12 and fits the FIT_BODIES largest ground-truth bodies
P14_ERODE = 4
FIT_ERODE = 12
FIT_BODIES = 6
#: the size filters' thresholds (voxels) in 14a and 14b
P14_SIZE_THRESHOLD = 200
SIZE_THRESHOLD = 1000
#: 14c's pyramid of phase 4's volume
PYRAMID = [[1, 2, 2], [1, 2, 2], [2, 2, 2]]
#: the two sides of 14a's comparisons: (work directory, device)
SIDES = (("card", "cuda"), ("cpu", "cpu"))
#: 14a's affinity offsets (InsertAffinities, compute_affinities)
P14_OFFSETS = [[-1, 0, 0], [0, -1, 0], [0, 0, -1], [0, -4, 0], [-2, 0, -4]]


def check_close(name: str, card: np.ndarray, cpu: np.ndarray,
                rtol: float, atol: float) -> float:
    """Card and CPU floats within (rtol, atol); logs the max abs error."""
    err = float(np.abs(card.astype("float64") - cpu).max()) if card.size \
        else 0.0
    ok = card.shape == cpu.shape and np.allclose(card, cpu, rtol=rtol,
                                                 atol=atol)
    log(f"{name} card-vs-cpu max_abs_err {err} identical "
        f"{bool(np.array_equal(card, cpu))} (rtol {rtol}, atol {atol})")
    if not ok:
        raise AssertionError(f"{name}: card and CPU disagree")
    return err


def check_same(name: str, card: np.ndarray, cpu: np.ndarray) -> None:
    same = card.shape == cpu.shape and bool(np.array_equal(card, cpu))
    log(f"{name} card-vs-cpu identical {same}")
    if not same:
        raise AssertionError(f"{name}: card and CPU labels differ")


def fit_bodies(gt: np.ndarray, n: int) -> np.ndarray:
    """The ``n`` largest ground-truth bodies, every other voxel 0."""
    ids, counts = np.unique(gt, return_counts=True)
    counts[ids == 0] = 0
    keep = ids[np.argsort(counts)[::-1][:n]]
    return np.where(np.isin(gt, keep), gt, 0).astype("uint64")


def surface_boundary_mean(labels: np.ndarray, hmap: np.ndarray):
    """Mean of ``hmap`` over the objects' surface voxels (a nonzero voxel
    with an axis neighbor of another label) and their count: how well the
    objects' boundaries lie on the boundary map."""
    surface = np.zeros(labels.shape, bool)
    for ax in range(labels.ndim):
        lo, hi = [slice(None)] * labels.ndim, [slice(None)] * labels.ndim
        lo[ax], hi[ax] = slice(0, -1), slice(1, None)
        differ = labels[tuple(lo)] != labels[tuple(hi)]
        surface[tuple(lo)] |= differ
        surface[tuple(hi)] |= differ
    surface &= labels != 0
    return float(hmap[surface].mean()), int(surface.sum())


def filter_ops_card_vs_cpu(data: np.ndarray, gt: np.ndarray):
    """Phase 14a, the ops: every filter at three scales, the min and max
    box filters, the signed distance transform, every downsampling
    sampler, the linear upsampling and both affinity functions, card
    against CPU."""
    import torch

    from cluster_tools_tpu_torch.ops.edt import signed_distance_transform
    from cluster_tools_tpu_torch.ops.filters import apply_filter, rank_pool
    from cluster_tools_tpu_torch.workflows.affinities import (
        compute_affinities, embedding_distance_affinities)
    from cluster_tools_tpu_torch.workflows.downscaling import (downsample,
                                                               upsample)

    x = data.astype("float32") / 255.0
    xs = {"cuda": torch.from_numpy(x).to("cuda"), "cpu": torch.from_numpy(x)}
    for fn in FILTER_NAMES:
        for s in P14_SIGMAS:
            out = {d: apply_filter(t, fn, s).cpu().numpy()
                   for d, t in xs.items()}
            check_close(f"{fn} sigma {s}", out["cuda"], out["cpu"],
                        FILTER_RTOL, FILTER_ATOL)
    for mode in ("min", "max"):
        for size in (3, (1, 5, 5)):
            check_same(f"rank_pool {mode} {size}",
                       *(rank_pool(xs[d], size, mode).cpu().numpy()
                         for d in ("cuda", "cpu")))
    mask = data < 64
    check_same("signed_distance_transform", *(
        signed_distance_transform(torch.from_numpy(mask).to(d)).cpu()
        .numpy() for d in ("cuda", "cpu")))
    for sampler in ("mean", "max", "min", "nearest", "majority"):
        for vol, tag in ((data, "uint8"), (gt.astype("uint64"), "labels")):
            check_same(f"downsample {sampler} {tag}", *(
                downsample(vol, [1, 2, 2], sampler, device=d)
                for d in ("cuda", "cpu")))
    for factor in ([1, 2, 2], [2, 2, 2]):
        check_close(f"downsample interpolate {factor}", *(
            downsample(x, factor, "interpolate", device=d)
            for d in ("cuda", "cpu")), rtol=0.0, atol=RESIZE_ATOL)
        check_close(f"upsample interpolate {factor}", *(
            upsample(x[:, :64, :64], factor, "interpolate", device=d)
            for d in ("cuda", "cpu")), rtol=0.0, atol=RESIZE_ATOL)
    check_same("compute_affinities", *(compute_affinities(gt, P14_OFFSETS,
                                                          d)
                                       for d in ("cuda", "cpu")))
    emb = np.stack([x, 1.0 - x, x * x])
    for norm in ("l2", "cosine"):
        check_close(f"embedding_distance_affinities {norm}", *(
            embedding_distance_affinities(emb, P14_OFFSETS, norm, d)
            for d in ("cuda", "cpu")), rtol=1e-5, atol=1e-6)


def run_filter_chain(workdir: str, store: str, block, device: str,
                     tag: str = ""):
    """The split chain, ``WatershedWorkflow`` ->
    ``MulticutSegmentationWorkflow(fused=False)``, with the filter-bank
    edge features of FILTER_BANK on ``device``, writing ``ws_fb<tag>`` /
    ``seg_fb<tag>``; returns (wall s, fragments, segmentation, features,
    problem path, assignments, status JSONs by task)."""
    import cluster_tools_tpu_torch as ctp

    cfg = config_dir(os.path.join(workdir, f"fb{tag}"), block, device,
                     {"block_edge_features": FILTER_BANK})
    tmp = os.path.join(workdir, f"tmp_fb{tag}")
    common = dict(tmp_folder=tmp, config_dir=cfg,
                  max_jobs=os.cpu_count() or 1, target="gpu")
    problem = os.path.join(workdir, f"problem_fb{tag}.n5")
    ws = ctp.WatershedWorkflow(input_path=store, input_key="bmap",
                               output_path=store, output_key=f"ws_fb{tag}",
                               **common)
    wf = ctp.MulticutSegmentationWorkflow(
        input_path=store, input_key="bmap", ws_path=store,
        ws_key=f"ws_fb{tag}", problem_path=problem, output_path=store,
        output_key=f"seg_fb{tag}", n_scales=1, fused=False, dependency=ws,
        **common)
    wall = timed_build(wf, device)
    return (wall, read_dataset(store, f"ws_fb{tag}"),
            read_dataset(store, f"seg_fb{tag}"),
            read_dataset(problem, "features"), problem,
            np.load(os.path.join(tmp, "multicut_assignments.npy")),
            read_status(tmp))


def filter_tasks(workdir: str, store: str, block, device: str):
    """``ImageFilterTask`` (DEFAULT_FEATURES), ``SmoothedGradients``,
    ``InsertAffinities``, ``UpscaleTask`` (linear) and
    ``ScaleToBoundariesTask`` (3-d and per slice, erode_by P14_ERODE)
    over the inputs of ``store`` on ``device``; returns {name: (wall s,
    output, minplus launches)}."""
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch import kernels

    cfg = config_dir(os.path.join(workdir, "tasks"), block, device,
                     {"upscaling": {"sampler": "interpolate"}})
    common = dict(config_dir=cfg, max_jobs=os.cpu_count() or 1,
                  target="gpu")
    def tmp(name):
        return dict(tmp_folder=os.path.join(workdir, f"tmp_{name}"))

    tasks = {
        "image_filter": (ctp.ImageFilterTask(
            input_path=store, input_key="raw", output_path=store,
            output_key="feats", **tmp("image_filter"), **common), "feats"),
        "smoothed_gradients": (ctp.SmoothedGradients(
            input_path=store, input_key="raw", output_path=store,
            output_key="grad", sigma=2.0, **tmp("gradients"), **common),
            "grad"),
        "insert_affinities": (ctp.InsertAffinities(
            input_path=store, input_key="affs", objects_path=store,
            objects_key="objs", output_path=store, output_key="affs_ins",
            offsets=P14_OFFSETS, **tmp("insert"), **common), "affs_ins"),
        "upscale": (ctp.UpscaleTask(
            input_path=store, input_key="raw_lr", output_path=store,
            output_key="raw_up", scale_factor=[1, 2, 2],
            **tmp("upscale"), **common), "raw_up"),
    }
    for mode in ("3d", "2d"):
        cfg_m = config_dir(os.path.join(workdir, f"fit_{mode}"), block,
                           device, {"scale_to_boundaries": {
                               "erode_by": P14_ERODE,
                               "erode_3d": mode == "3d"}})
        tasks[f"scale_to_boundaries_{mode}"] = (ctp.ScaleToBoundariesTask(
            input_path=store, input_key="objs_lr", output_path=store,
            output_key=f"fitted_{mode}", boundaries_path=store,
            boundaries_key="bmap", tmp_folder=os.path.join(
                workdir, f"tmp_fit_{mode}"), config_dir=cfg_m,
            max_jobs=common["max_jobs"], target="gpu"), f"fitted_{mode}")
    out = {}
    for name, (task, key) in tasks.items():
        kernels.reset_counts()
        wall = timed_build(task, device)
        out[name] = (wall, read_dataset(store, key),
                     kernels.counts()["minplus"])
    return out


def run_postprocess(workdir: str, store: str, problem: str, block,
                    device: str, size_threshold: int):
    """The six post-processing workflows over a split chain's outputs in
    ``store`` (``frags``, ``seg``, ``assignments``, ``classes``, ``bmap``)
    and ``problem`` (``s0/graph``, ``features``) on ``device``; returns
    {name: (wall s, output labels)}."""
    import cluster_tools_tpu_torch as ctp

    cfg = config_dir(os.path.join(workdir, "pp"), block, device)
    common = dict(config_dir=cfg, max_jobs=os.cpu_count() or 1,
                  target="gpu")

    def tmp(name):
        return dict(tmp_folder=os.path.join(workdir, f"tmp_pp_{name}"))

    graph = dict(graph_key="s0/graph")
    wfs = {
        "size_filter": (ctp.SizeFilterWorkflow(
            input_path=store, input_key="frags", output_path=store,
            output_key="pp_size", size_threshold=size_threshold,
            hmap_path=store, hmap_key="bmap", **tmp("size"), **common),
            store, "pp_size"),
        "filter_labels": (ctp.FilterLabelsWorkflow(
            input_path=store, input_key="seg", label_path=store,
            label_key="classes", node_label_path=store,
            node_label_key="pp_node_labels", output_path=store,
            output_key="pp_labels", filter_labels=[1, 2],
            **tmp("labels"), **common), store, "pp_labels"),
        "filter_by_threshold": (ctp.FilterByThresholdWorkflow(
            input_path=store, input_key="bmap", seg_in_path=store,
            seg_in_key="seg", seg_out_path=store, seg_out_key="pp_thresh",
            threshold=0.3, **tmp("thresh"), **common), store, "pp_thresh"),
        "graph_cc": (ctp.ConnectedComponentsWorkflow(
            problem_path=problem, assignment_path=store,
            assignment_key="assignments", output_path=store,
            assignment_out_key="pp_cc_assignments", path=store,
            fragments_key="frags", output_key="pp_cc", **graph,
            **tmp("cc"), **common), store, "pp_cc"),
        "orphans": (ctp.FilterOrphansWorkflow(
            graph_path=problem, path=store, segmentation_key="frags",
            assignment_key="assignments", output_path=store,
            assignment_out_key="pp_orphan_assignments",
            output_key="pp_orphans", **graph, **tmp("orphans"), **common),
            store, "pp_orphans"),
        "size_graph_watershed": (ctp.SizeFilterAndGraphWatershedWorkflow(
            problem_path=problem, features_key="features", path=store,
            segmentation_key="seg", assignment_key="assignments",
            size_threshold=size_threshold, output_path=store,
            assignment_out_key="pp_gws_assignments", fragments_key="frags",
            output_key="pp_gws", **graph, **tmp("gws"), **common),
            store, "pp_gws"),
    }
    out = {}
    for name, (wf, path, key) in wfs.items():
        out[name] = (timed_build(wf, device), read_dataset(path, key))
    return out


def write_postprocess_inputs(store: str, data, frags, seg, assignments,
                             gt, block) -> None:
    """A store of the post-processing inputs: the boundary map, the
    fragments and segmentation (with maxId), the assignment table and the
    ground truth folded into N_CLASSES classes."""
    from cluster_tools_tpu_torch.core.storage import file_reader

    write_dataset(store, "bmap", data, block)
    write_dataset(store, "frags", frags, block)
    write_dataset(store, "seg", seg, block)
    write_dataset(store, "classes", (gt.astype("uint64") % N_CLASSES) + 1,
                  block)
    with file_reader(store) as f:
        f["frags"].attrs["maxId"] = int(frags.max())
        f["seg"].attrs["maxId"] = int(seg.max())
        f.require_dataset("assignments", data=assignments.astype("uint64"),
                          chunks=(len(assignments),))


def filter_workflows_card_vs_cpu(root: str, data: np.ndarray,
                                 gt: np.ndarray):
    """Phase 14a, the workflows on P14_SHAPE, card against CPU: the split
    chain with filter-bank edge features (identical fragments and
    segmentation, features within the tolerance), the pixel features,
    smoothed gradients, inserted affinities, the linear upscaling, the
    object fit in 3-d and per slice (identical labels, minplus launches 3
    and 2 per block with objects), ``DownscalingWorkflow`` and the six
    post-processing workflows over the card's chain; returns the card's
    minplus launches."""
    from cluster_tools_tpu_torch.core.blocking import Blocking
    from cluster_tools_tpu_torch.core.volume_views import InterpolatedVolume
    from cluster_tools_tpu_torch.workflows.affinities import \
        compute_affinities
    from cluster_tools_tpu_torch.workflows.downscaling import (downsample,
                                                               upsample)
    from cluster_tools_tpu_torch import kernels

    raw = data.astype("float32") / 255.0
    bodies = fit_bodies(gt, 4)
    objs_lr = downsample(bodies, [1, 2, 2], "nearest", device="cpu")
    affs = np.random.RandomState(0).rand(5, *data.shape).astype("float32")
    objs = np.where(np.isin(gt, np.unique(bodies)[1:3]), gt, 0)
    chain, tasks, pyr = {}, {}, {}
    launches = 0
    for side, device in SIDES:
        wd = os.path.join(root, "p14a", side)
        store = os.path.join(wd, "data.n5")
        write_volume(store, data, P14_BLOCK)
        for key, vol in (("raw", raw), ("affs", affs), ("objs", objs),
                         ("objs_lr", objs_lr),
                         ("raw_lr", raw[:, ::2, ::2].copy())):
            write_dataset(store, key, vol, ([vol.shape[0]] if vol.ndim == 4
                                            else []) + P14_BLOCK)
        kernels.reset_counts()
        chain[side] = run_filter_chain(wd, store, P14_BLOCK, device)
        if side == "card":
            launches += kernels.counts()["minplus"]
        tasks[side] = filter_tasks(wd, store, P14_BLOCK, device)
        if side == "card":
            launches += sum(v[2] for v in tasks[side].values())
        import cluster_tools_tpu_torch as ctp

        cfg = config_dir(os.path.join(wd, "pyr"), P14_BLOCK, device)
        write_dataset(store, "pyr/s0", data, P14_BLOCK)
        timed_build(ctp.DownscalingWorkflow(
            input_path=store, input_key="pyr/s0",
            scale_factors=[[1, 2, 2], [2, 2, 2]], output_key_prefix="pyr",
            tmp_folder=os.path.join(wd, "tmp_pyr"), config_dir=cfg,
            max_jobs=os.cpu_count() or 1), device)
        pyr[side] = [read_dataset(store, f"pyr/s{i}") for i in (1, 2)]
    n_resp = len(FILTER_BANK["filters"]) * len(FILTER_BANK["sigmas"])
    card, cpu = chain["card"], chain["cpu"]
    log(f"p14a filter-chain wall_s card {card[0]} cpu {cpu[0]} "
        f"feature_columns {card[3].shape[1]} edges {card[3].shape[0]}")
    if card[3].shape[1] != 9 * n_resp + 1:
        raise AssertionError("filter-bank features: wrong column count")
    check_same("filter-chain fragments", card[1], cpu[1])
    check_close("filter-chain features", card[3], cpu[3], FILTER_RTOL,
                FILTER_ATOL)
    check_same("filter-chain segmentation", card[2], cpu[2])
    for name in tasks["card"]:
        (wc, c, lc), (wh, h, _) = tasks["card"][name], tasks["cpu"][name]
        log(f"p14a {name} wall_s card {wc} cpu {wh} minplus launches {lc}")
        if c.dtype.kind == "f":
            check_close(name, c, h, FILTER_RTOL,
                        RESIZE_ATOL if name == "upscale" else FILTER_ATOL)
        else:
            check_same(name, c, h)
    # the oracles: the inserted affinities are the prediction's or more,
    # and 1 between two voxels of one object; the fit keeps the objects'
    # ids
    ins = tasks["card"]["insert_affinities"][1]
    inside = compute_affinities(objs, P14_OFFSETS, device="cpu") == 1
    if not (ins >= affs).all() or not (ins[inside] == 1).all():
        raise AssertionError("insert_affinities: wrong affinities")
    for mode, per_block in (("3d", 3), ("2d", 2)):
        fitted = tasks["card"][f"scale_to_boundaries_{mode}"][1]
        if not set(np.unique(fitted).tolist()) <= set(
                np.unique(bodies).tolist()):
            raise AssertionError(f"fit {mode}: ids not the objects'")
        blocking = Blocking(list(data.shape), P14_BLOCK)
        halo = [P14_ERODE] * 3 if mode == "3d" else [0, P14_ERODE,
                                                     P14_ERODE]
        view = InterpolatedVolume(objs_lr, data.shape)
        with_objs = sum(bool(view[blocking.get_block_with_halo(
            b, halo).outer.bb].any()) for b in range(blocking.n_blocks))
        got = tasks["card"][f"scale_to_boundaries_{mode}"][2]
        log(f"p14a fit {mode}: {with_objs} blocks with objects, minplus "
            f"launches {got}")
        if got != per_block * with_objs:
            raise AssertionError(f"fit {mode}: {got} min-plus launches for "
                                 f"{with_objs} blocks with objects")
    up = upsample(raw[:, ::2, ::2].copy(), [1, 2, 2], "interpolate",
                  device="cpu")
    check_close("upscale vs whole-volume resize",
                tasks["card"]["upscale"][1], up, 0.0, 1e-5)
    for i in range(2):
        check_same(f"pyramid s{i + 1}", pyr["card"][i], pyr["cpu"][i])
    # the post-processing workflows over the card's chain, card vs CPU
    _, frags, seg, _, problem, assignments, _ = card
    pp = {}
    for side, device in SIDES:
        wd = os.path.join(root, "p14a", f"pp_{side}")
        store = os.path.join(wd, "data.n5")
        write_postprocess_inputs(store, data, frags, seg, assignments, gt,
                                 P14_BLOCK)
        kernels.reset_counts()
        pp[side] = run_postprocess(wd, store, problem, P14_BLOCK, device,
                                   P14_SIZE_THRESHOLD)
        if side == "card" and kernels.counts()["minplus"]:
            raise AssertionError("post-processing launched the min-plus "
                                 "kernel")
    for name in pp["card"]:
        log(f"p14a {name} wall_s card {pp['card'][name][0]} cpu "
            f"{pp['cpu'][name][0]} n_labels "
            f"{len(np.unique(pp['card'][name][1]))}")
        check_same(name, pp["card"][name][1], pp["cpu"][name][1])
    if (pp["card"]["size_filter"][1] == 0).any():
        raise AssertionError("size filter left holes")
    return launches


def fit_kernel_vs_plain(outer_main):
    """Phase 14, the kernel against its plain version at the new shapes:
    the object fit's outer block of a full ``[50, 512, 512]`` block with
    the default erode_by (``(74, 536, 536)``; each axis in place and the
    whole EDT, bitwise, timed), its per-slice form (``axes=(1, 2)``) and
    the signed distance transform of the main path's outer block."""
    import torch

    from cluster_tools_tpu_torch.ops import edt

    outer = [b + 2 * FIT_ERODE for b in BLOCK]
    timed, max_err, fg = block_vs_plain(outer)
    max_err = max(max_err, _compare(
        "fit outer block per-slice axes=(1,2)",
        edt.distance_transform_edt(fg, axes=(1, 2)),
        edt.distance_transform_edt_plain(fg, axes=(1, 2))))
    fg_main = block_mask(outer_main)
    want = edt.distance_transform_edt_plain(fg_main) - \
        edt.distance_transform_edt_plain(torch.logical_not(fg_main))
    max_err = max(max_err, _compare(
        "signed_distance_transform main outer block",
        edt.signed_distance_transform(fg_main), want))
    return timed, max_err


def crop_filter_paths(root: str, store: str, block, gt_c: np.ndarray):
    """Phase 14b at full block width on phase 12's crop: the split chain
    with filter-bank edge features (CREMI gate, minplus 3 per block plus
    3 per redo), ``ImageFilterTask`` with DEFAULT_FEATURES (a box across a
    block face held to the whole-volume features on the CPU), the object
    fit of the FIT_BODIES largest bodies (their surfaces on the boundary
    map at least as well as the nearest-upsampled input's, the adapted
    Rand errors logged; minplus 3 per block with objects) and the filling
    size filter over phase 4's fragments; returns the launches by path."""
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch import kernels
    from cluster_tools_tpu_torch.core.blocking import Blocking
    from cluster_tools_tpu_torch.core.volume_views import InterpolatedVolume
    from cluster_tools_tpu_torch.utils.validation import compute_rand_scores
    from cluster_tools_tpu_torch.workflows.downscaling import (downsample,
                                                               upsample)
    from cluster_tools_tpu_torch.workflows.pixel_classification import (
        DEFAULT_FEATURES, _filter_halo, compute_feature_stack)

    wd = os.path.dirname(store)
    nvox = int(np.prod(CROP))
    blocking = Blocking(list(CROP), list(block))
    launches = {}
    # the split chain with filter-bank features
    kernels.reset_counts()
    wall, ws, seg, feats, _, _, status = run_filter_chain(wd, store, block,
                                                          "cuda", tag="_14b")
    calls = kernels.counts()["minplus"]
    redo = status.get("watershed", {}).get("stage_counts", {}).get(
        "device-ws-redo", 0)
    sc = scores(seg, gt_c)
    log(f"crop-filter-chain wall_s {wall} voxels_per_s {nvox / wall} "
        f"feature_columns {feats.shape[1]} edges {feats.shape[0]} "
        f"minplus launches {calls} ws-redo {redo} quality {json.dumps(sc)}")
    for task, st in status.items():
        log(f"crop-filter-chain task {task} wall_s {st.get('wall_time')} "
            f"stages {json.dumps(st.get('stages', {}))}")
    if not (np.isfinite(list(sc.values())).all()
            and sc["cremi"] <= CREMI_GATE and feats.shape[1] == 55
            and np.isfinite(feats).all()):
        raise AssertionError(f"crop filter chain out of bounds: {sc}")
    if calls != 3 * blocking.n_blocks + 3 * redo:
        raise AssertionError(f"crop filter chain: {calls} min-plus "
                             "launches")
    launches["split-filter-bank"] = calls
    del ws, seg
    # the pixel features
    kernels.reset_counts()
    cfg = config_dir(os.path.join(wd, "feats14"), block, "cuda")
    wall = timed_build(ctp.ImageFilterTask(
        input_path=store, input_key="bmap", output_path=store,
        output_key="feats14", tmp_folder=os.path.join(wd, "tmp_feats14"),
        config_dir=cfg, max_jobs=os.cpu_count() or 1, target="gpu"), "cuda")
    nbytes = len(DEFAULT_FEATURES) * nvox * 4
    log(f"crop-image-filter wall_s {wall} voxels_per_s {nvox / wall} "
        f"output_bytes {nbytes} minplus launches "
        f"{kernels.counts()['minplus']}")
    halo = _filter_halo(DEFAULT_FEATURES)
    # a box across the crop's block faces (and to the volume's edge where
    # an axis holds one block)
    box = (slice(CROP[0] // 5, CROP[0] * 4 // 5),) + tuple(
        slice(max(b - 32, 0), min(b + 32, n))
        for b, n in zip(block[1:], CROP[1:]))
    obox = tuple(slice(max(s.start - halo, 0), min(s.stop + halo, n))
                 for s, n in zip(box, CROP))
    ref = compute_feature_stack(read_dataset(store, "bmap", obox),
                                DEFAULT_FEATURES, device="cpu")
    local = tuple(slice(s.start - o.start, s.stop - o.start)
                  for s, o in zip(box, obox))
    got = read_dataset(store, "feats14", (slice(None),) + box)
    check_close("crop-image-filter box across a block face vs CPU", got,
                ref[(slice(None),) + local], FILTER_RTOL, 1e-3)
    # the object fit
    bodies = fit_bodies(gt_c, FIT_BODIES)
    objs_lr = downsample(bodies, [1, 2, 2], "nearest", device="cpu")
    write_dataset(store, "objs_lr14", objs_lr, [50, 256, 256])
    kernels.reset_counts()
    cfg = config_dir(os.path.join(wd, "fit14"), block, "cuda")
    wall = timed_build(ctp.ScaleToBoundariesTask(
        input_path=store, input_key="objs_lr14", output_path=store,
        output_key="fitted14", boundaries_path=store, boundaries_key="bmap",
        tmp_folder=os.path.join(wd, "tmp_fit14"), config_dir=cfg,
        max_jobs=os.cpu_count() or 1, target="gpu"), "cuda")
    calls = kernels.counts()["minplus"]
    fitted = read_dataset(store, "fitted14")
    view = InterpolatedVolume(objs_lr, CROP)
    with_objs = sum(bool(view[blocking.get_block_with_halo(
        b, [FIT_ERODE] * 3).outer.bb].any())
        for b in range(blocking.n_blocks))
    upsampled = upsample(objs_lr, [1, 2, 2], device="cpu")
    are_fit = compute_rand_scores(contingency(bodies, fitted))[0]
    are_in = compute_rand_scores(contingency(bodies, upsampled))[0]
    bmap = read_dataset(store, "bmap").astype("float32")
    snap = {name: surface_boundary_mean(lab, bmap) for name, lab in (
        ("bodies", bodies), ("fitted", fitted), ("upsampled", upsampled))}
    log(f"crop-fit wall_s {wall} bodies {FIT_BODIES} erode_by {FIT_ERODE} "
        f"adapted_rand fitted {are_fit} nearest-upsampled {are_in} "
        f"surface boundary mean (voxels) {json.dumps(snap)} "
        f"blocks_with_objects {with_objs} minplus launches {calls}")
    # the fit moves the objects' surfaces onto the boundary map; where a
    # background cell keeps no seed after the erosion, an object absorbs
    # it (the JAX package's fit does the same), so the adapted Rand error
    # against the bodies is logged, not gated
    if not snap["fitted"][0] >= snap["upsampled"][0]:
        raise AssertionError("crop-fit: the fit does not move the objects "
                             "onto the boundaries")
    if not set(np.unique(fitted).tolist()) <= set(np.unique(bodies).tolist()):
        raise AssertionError("crop-fit: ids not the bodies'")
    if calls != 3 * with_objs:
        raise AssertionError(f"crop-fit: {calls} min-plus launches for "
                             f"{with_objs} blocks with objects")
    launches["scale-to-boundaries"] = calls
    # the filling size filter over phase 4's fragments (``frags``)
    kernels.reset_counts()
    cfg = config_dir(os.path.join(wd, "size14"), block, "cuda")
    tmp = os.path.join(wd, "tmp_size14")
    wall = timed_build(ctp.SizeFilterWorkflow(
        input_path=store, input_key="frags", output_path=store,
        output_key="size14", size_threshold=SIZE_THRESHOLD,
        hmap_path=store, hmap_key="bmap", relabel=False, tmp_folder=tmp,
        config_dir=cfg, max_jobs=os.cpu_count() or 1), "cuda")
    frags = read_dataset(store, "frags")
    out = read_dataset(store, "size14")
    discard = np.load(os.path.join(tmp, "size_filter_discard.npy"))
    holes = int(((out == 0) & (frags != 0)).sum())
    survived = int(np.isin(out, discard).sum())
    log(f"crop-size-filter wall_s {wall} threshold {SIZE_THRESHOLD} "
        f"discarded {len(discard)} of {len(np.unique(frags))} holes {holes} "
        f"discarded_voxels_left {survived} minplus launches "
        f"{kernels.counts()['minplus']}")
    if holes or survived or not len(discard):
        raise AssertionError("crop-size-filter: holes or discarded ids left")
    return launches


def pyramid_path(root: str):
    """Phase 14c: ``CopyVolumeTask`` of phase 4's volume into a Paintera
    group, then ``DownscalingWorkflow`` (PYRAMID, ``mean``, Paintera
    metadata) on the card; s1 must equal the numpy window mean exactly."""
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch import kernels
    from cluster_tools_tpu_torch.core.storage import file_reader

    main = os.path.join(root, "main", "data.n5")
    wd = os.path.join(root, "pyramid")
    store = os.path.join(wd, "data.n5")
    cfg = config_dir(wd, BLOCK, "cuda")
    common = dict(tmp_folder=os.path.join(wd, "tmp"), config_dir=cfg,
                  max_jobs=os.cpu_count() or 1, target="gpu")
    kernels.reset_counts()
    copy = ctp.CopyVolumeTask(input_path=main, input_key="bmap",
                              output_path=store, output_key="raw/s0",
                              **common)
    t0 = time.perf_counter()
    ctp.build([copy], raise_on_failure=True)
    copy_s = time.perf_counter() - t0
    wf = ctp.DownscalingWorkflow(
        input_path=store, input_key="raw/s0", scale_factors=PYRAMID,
        output_key_prefix="raw",
        metadata_dict={"resolution": [40.0, 4.0, 4.0]}, **common)
    wall = timed_build(wf, "cuda")
    nvox = int(np.prod(FULL_SHAPE))
    with file_reader(store, "r") as f:
        shapes = [list(f[f"raw/s{i}"].shape) for i in range(4)]
        factors = [f[f"raw/s{i}"].attrs.get("downsamplingFactors")
                   for i in (1, 2, 3)]
        multiscale = f["raw"].attrs.get("multiScale")
    log(f"pyramid copy_s {copy_s} wall_s {wall} input_voxels_per_s "
        f"{nvox / wall} shapes {shapes} downsamplingFactors {factors} "
        f"minplus launches {kernels.counts()['minplus']}")
    data = read_dataset(main, "bmap")
    want = np.round(data.reshape(FULL_SHAPE[0], FULL_SHAPE[1] // 2, 2,
                                 FULL_SHAPE[2] // 2, 2).mean(
        axis=(2, 4))).astype("uint8")
    s1 = read_dataset(store, "raw/s1")
    same = bool(np.array_equal(s1, want))
    log(f"pyramid s1 == numpy window mean: {same}")
    if not same or factors != [[2, 2, 1], [4, 4, 1], [8, 8, 2]] \
            or multiscale is not True:
        raise AssertionError("pyramid: s1 or its metadata is wrong")
    want_shapes = [list(FULL_SHAPE)]
    for factor in PYRAMID:
        want_shapes.append([-(-s // f) for s, f in zip(want_shapes[-1],
                                                       factor)])
    if shapes != want_shapes:
        raise AssertionError(f"pyramid: shapes {shapes}")


# ---------------------------------------------------------------------------
# phase 15: the tools run after a segmentation, masking, decomposition,
# debugging, and the sweep ops
# ---------------------------------------------------------------------------

#: 15a's card-vs-CPU volume (cut from 32 deep for the script's time
#: limit: its CPU side took up to 77 s, PERF.md section 4)
P15_SHAPE = (16, 128, 128)
P15_BLOCK = [16, 64, 64]
#: 15a's size filter of the sweep watershed (voxels)
P15_MIN_SIZE = 50
#: 15b: the sweep watershed agrees with the flood on this share of the
#: foreground interior (tests/test_sweep.py's gate)
SWEEP_AGREE_GATE = 0.97
#: 15b: the round cap of the JAX package's wrapper, ``sweep_watershed``
SWEEP_WRAPPER_ROUNDS = 48
#: 15c: meshes and skeletons of the MESH_BODIES largest bodies (cut from
#: 16, then from 8 when phase 17 came, for the script's time limit,
#: PERF.md section 4)
MESH_BODIES = 4
#: 15c: the chunks of the label volumes the per-object tasks read (each
#: object reads the chunks its bounding box touches)
LABEL_CHUNKS = [25, 128, 128]
#: 15c: the minimum filter over the mask of the largest bodies
MINFILTER_SHAPE = [3, 9, 9]
#: 15c: the block shape of the block list cut from that mask
MASK_BLOCKS = [25, 128, 128]
#: 15d: ids whose label-to-block lookup at s0 is held to numpy
LOOKUP_SAMPLES = 16
#: the host workflows' executor in 15c-d (the jobs' numpy releases the
#: GIL in its sorts); the conversion's label pyramid runs on the card
HOST_TARGET = "threads"
#: morphology centers of mass: the blockwise merge sums per-block means,
#: so they equal the whole-crop oracle to rounding
COM_RTOL = 1e-9


def height_and_seeds(bnd: np.ndarray):
    """tests/test_sweep.py's ``_height_and_seeds``: uint8 heights (the
    smoothed boundaries plus the inverted distance to them), seeds at the
    maxima of the smoothed distance transform, and the foreground."""
    from scipy import ndimage

    fg = bnd < 0.4
    dt = ndimage.distance_transform_edt(fg)
    height = (0.8 * ndimage.gaussian_filter(bnd, 2.0)
              + 0.2 * (1 - dt / max(dt.max(), 1e-6)))
    dts = ndimage.gaussian_filter(dt, 2.0)
    mx = (dts == ndimage.maximum_filter(dts, size=5)) & fg
    seeds, _ = ndimage.label(mx)
    hq = np.clip(np.round(height * 255), 0, 255).astype("uint8")
    return hq, seeds.astype("int32"), fg


def run_sweep_ops(bnd: np.ndarray, device: str):
    """Every sweep op on one device; returns outputs as numpy, flags and
    counts alongside."""
    import torch

    from cluster_tools_tpu_torch.ops import sweep

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    hq, seeds, fg = height_and_seeds(bnd)
    mask = bnd < 0.6
    k_cap = int(seeds.max()) + 1
    out = {}
    for name, m, kw in (("ws", None, {}), ("ws-mask", t(mask), {}),
                        ("ws-min-size", None, {"min_size": P15_MIN_SIZE,
                                               "k_cap": k_cap})):
        stats = {}
        lab, conv = sweep.sweep_watershed_impl(t(hq), t(seeds), m,
                                               stats=stats, **kw)
        out[name] = (lab.cpu().numpy(), conv, stats)
    ids = np.where(seeds > 0, seeds * 7 + 3, 0).astype("int32")
    out["wrapper"] = (sweep.sweep_watershed(
        t(bnd), t(ids), min_size=P15_MIN_SIZE).cpu().numpy(), True, {})
    stats = {}
    lab, conv = sweep.sweep_cc_impl(t(fg), stats=stats)
    out["cc"] = (lab.cpu().numpy(), conv, stats)
    dense, k = sweep.compact_ids(t(out["ws"][0] * 5), 5 * k_cap + 1)
    out["compact"] = (dense.cpu().numpy(), int(k), {})
    flat = t(out["ws"][0].reshape(-1))
    starts, values, n, ok = sweep.rle_encode(flat, int(flat.numel()))
    out["rle"] = (sweep.rle_decode(starts.cpu().numpy()[:n],
                                   values.cpu().numpy()[:n], flat.numel()),
                  ok, {"n_runs": n})
    return out, (hq, seeds, fg)


def run_paintera(workdir: str, store: str, frags_key: str, assignments,
                 block, device: str, target: str):
    """``PainteraConversionWorkflow`` of ``store:frags_key`` into its own
    container on ``device``; returns (wall s, its path, status JSONs)."""
    import cluster_tools_tpu_torch as ctp

    out = os.path.join(workdir, "paintera.n5")
    tmp = os.path.join(workdir, "tmp")
    wf = ctp.PainteraConversionWorkflow(
        input_path=store, input_key=frags_key, path=out,
        label_group="labels", scale_factors=PYRAMID,
        assignment_path=assignments, tmp_folder=tmp,
        config_dir=config_dir(workdir, block, device),
        max_jobs=os.cpu_count() or 1, target=target,
        resolution=(40.0, 4.0, 4.0))
    wall = timed_build(wf, device)
    return wall, out, read_status(tmp)


def read_paintera(out: str, n_scales: int):
    """The group's label pyramid, unique labels, lookup, pairs and
    attributes."""
    from cluster_tools_tpu_torch.core.storage import (VarlenDataset,
                                                      file_reader)

    def chunks(key):
        ds = VarlenDataset(os.path.join(out, key), mode="r")
        return {cid: ds.read_chunk(cid) for cid in ds.chunk_ids()}

    res = {}
    with file_reader(out, "r") as f:
        for s in range(n_scales + 1):
            res[f"data/s{s}"] = f[f"labels/data/s{s}"][:]
        res["pairs"] = f["labels/fragment-segment-assignment"][:]
        res["attrs"] = {k: f["labels"].attrs[k]
                        for k in ("painteraData", "maxId")}
    for s in range(n_scales + 1):
        res[f"uniques/s{s}"] = chunks(f"labels/unique-labels/s{s}")
        res[f"lookup/s{s}"] = chunks(f"labels/label-to-block-mapping/s{s}")
    return res


def same_outputs(name: str, card, cpu) -> None:
    """Card and CPU outputs (arrays, dicts of arrays, flags) identical."""
    if isinstance(card, dict):
        if card.keys() != cpu.keys():
            raise AssertionError(f"{name}: card and CPU keys differ")
        for k in card:
            same_outputs(f"{name}[{k}]", card[k], cpu[k])
        return
    if isinstance(card, tuple):
        for i, (a, b) in enumerate(zip(card, cpu)):
            same_outputs(f"{name}[{i}]", a, b)
        return
    if isinstance(card, np.ndarray):
        if card.shape != cpu.shape or card.dtype != cpu.dtype or \
                not np.array_equal(card, cpu):
            raise AssertionError(f"{name}: card and CPU differ")
    elif card != cpu:
        raise AssertionError(f"{name}: card {card} != CPU {cpu}")


def sweep_card_vs_cpu(root: str, gt: np.ndarray, bnd: np.ndarray):
    """Phase 15a: every sweep op, then ``PainteraConversionWorkflow``
    (its label pyramid on the device), card against CPU on P15_SHAPE; all
    outputs identical."""
    from scipy import ndimage

    outs = {}
    for side, device in SIDES:
        t0 = time.perf_counter()
        outs[side], (hq, seeds, fg) = run_sweep_ops(bnd, device)
        log(f"sweep-ops {side} wall_s {time.perf_counter() - t0} rounds "
            + json.dumps({k: v[2] for k, v in outs[side].items()}))
    for name in outs["card"]:
        same_outputs(f"sweep {name}", outs["card"][name][:2],
                     outs["cpu"][name][:2])
    log(f"sweep-ops card-vs-cpu identical: {sorted(outs['card'])}")
    card = outs["card"]
    ws = card["ws"][0]
    ref, n_ref = ndimage.label(fg)
    if not (card["ws"][1] and card["ws-mask"][1] and card["ws-min-size"][1]
            and card["cc"][1] and card["rle"][1]):
        raise AssertionError("sweep ops: not converged or RLE overflow")
    if not ((ws[seeds > 0] == seeds[seeds > 0]).all() and (ws > 0).all()
            and same_partition(card["cc"][0], ref)
            and np.array_equal(card["rle"][0], ws.reshape(-1))):
        raise AssertionError("sweep ops: seeds, partition or RLE wrong")
    # the conversion, card against CPU
    store = os.path.join(root, "p15", "data.n5")
    frags = gt.astype("uint64")
    write_labels(store, "frags", frags, P15_BLOCK)
    table = os.path.join(root, "p15", "assignments.npy")
    np.save(table, (np.arange(int(frags.max()) + 1) // 3).astype("uint64"))
    res = {}
    for side, device in SIDES:
        wall, out, _ = run_paintera(os.path.join(root, "p15", side), store,
                                    "frags", table, P15_BLOCK, device,
                                    HOST_TARGET)
        res[side] = read_paintera(out, len(PYRAMID))
        log(f"paintera-small {side} wall_s {wall}")
    same_outputs("paintera-small", res["card"], res["cpu"])
    log("paintera-small card-vs-cpu identical: pyramid, unique labels, "
        "lookup, pairs, attributes")


def write_labels(store: str, key: str, labels: np.ndarray, chunks) -> None:
    """A label volume with its maxId attribute."""
    from cluster_tools_tpu_torch.core.storage import file_reader

    write_dataset(store, key, labels, chunks)
    with file_reader(store) as f:
        f[key].attrs["maxId"] = int(labels.max())


def sweep_full(root: str):
    """Phase 15b: the sweep ops on the main path's outer block of phase
    4's boundary map: ``sweep_watershed_impl`` at its default round cap,
    then at the JAX wrapper's (converged there, seeds kept, the flood's
    labels on > SWEEP_AGREE_GATE of the foreground), ``sweep_cc_impl``
    (scipy's partition), ``rle_encode``
    round trip of a block of phase 4's fragments; ms per call from CUDA
    events, rounds and peak device memory logged."""
    import torch
    from scipy import ndimage

    from cluster_tools_tpu_torch import native
    from cluster_tools_tpu_torch.ops import sweep

    main = os.path.join(root, "main", "data.n5")
    outer = [b + 2 * h for b, h in zip(BLOCK, (4, 32, 32))]
    t0 = time.perf_counter()
    bnd = read_dataset(main, "bmap", tuple(slice(0, o) for o in outer))
    hq, seeds, fg = height_and_seeds(bnd.astype("float32") / 255.0)
    nvox = int(np.prod(outer))
    log(f"sweep-full setup_s {time.perf_counter() - t0} shape {outer} "
        f"seeds {int(seeds.max())} foreground {float(fg.mean())}")

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        res = fn()
        end.record()
        end.synchronize()
        return res, start.elapsed_time(end)

    h_t = torch.from_numpy(hq).cuda()
    s_t = torch.from_numpy(seeds).cuda()
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    # the function's default round cap, twice (the second call warm), then
    # the cap of the JAX package's own wrapper (sweep_watershed, 48)
    for cap in (None, None, SWEEP_WRAPPER_ROUNDS):
        stats = {}
        kw = {} if cap is None else {"max_rounds": cap}
        (lab, conv), ms = timed(lambda: sweep.sweep_watershed_impl(
            h_t, s_t, None, stats=stats, **kw))
        runs.setdefault(cap or "default", []).append(
            {"ms": ms, "rounds": stats["rounds"], "converged": conv})
    peak = torch.cuda.max_memory_allocated()
    lab = lab.cpu().numpy()
    flood = native.seeded_watershed_u8(hq, seeds.astype("int64"))
    agree = float((lab[fg] == flood[fg]).mean())
    kept = bool((lab[seeds > 0] == seeds[seeds > 0]).all())
    rounds = runs[SWEEP_WRAPPER_ROUNDS][0]["rounds"]
    # the prediction's traffic: six int64 fields, ~2n element reads and
    # writes per directional scan, six scans per round
    model_bytes = 6 * 8 * 2 * 2 * nvox * 6 * rounds
    ms = runs[SWEEP_WRAPPER_ROUNDS][0]["ms"]
    log(f"sweep-full watershed {json.dumps(runs)} seeds_kept {kept} "
        f"flood_agreement {agree} (gate > {SWEEP_AGREE_GATE}) "
        f"peak_device_bytes {peak} voxels_per_s {nvox / (ms / 1e3)} "
        f"ms_per_round {ms / rounds} model_bytes {model_bytes} "
        f"model_bytes_ms {bytes_bound_ms(model_bytes)}")
    # the default cap of 24 rounds stops short of the fixpoint on a full
    # block (ROADMAP C); the wrapper's cap must reach it
    if not (runs[SWEEP_WRAPPER_ROUNDS][0]["converged"] and kept
            and agree > SWEEP_AGREE_GATE):
        raise AssertionError("sweep-full watershed out of bounds")
    cc_stats = {}
    (cc, cc_conv), cc_ms = timed(lambda: sweep.sweep_cc_impl(
        torch.from_numpy(fg).cuda(), stats=cc_stats))
    ref, n_ref = ndimage.label(fg)
    same = same_partition(cc.cpu().numpy(), ref)
    log(f"sweep-full cc ms {cc_ms} rounds {cc_stats['rounds']} converged "
        f"{cc_conv} components {n_ref} scipy_partition {same}")
    if not (cc_conv and same):
        raise AssertionError("sweep-full cc: not scipy's partition")
    frags = read_dataset(main, "ws", tuple(slice(0, b) for b in BLOCK))
    flat = torch.from_numpy(frags.astype("int64").reshape(-1)).cuda()
    (starts, values, n, ok), rle_ms = timed(
        lambda: sweep.rle_encode(flat, int(flat.numel())))
    dec = sweep.rle_decode(starts.cpu().numpy()[:n], values.cpu().numpy()[:n],
                           flat.numel())
    same = ok and bool(np.array_equal(dec, frags.reshape(-1)))
    log(f"sweep-full rle ms {rle_ms} runs {n} voxels {flat.numel()} "
        f"round_trip {same}")
    if not same:
        raise AssertionError("sweep-full rle: round trip differs")
    return {"watershed": runs, "cc_ms": cc_ms, "rle_ms": rle_ms,
            "peak_device_bytes": peak}


def morphology_oracle(gt: np.ndarray):
    """Whole-crop sizes, centers of mass and bounding boxes (ids 1..max;
    scipy's ``find_objects`` for the boxes, voxel counts and coordinate
    sums for the rest)."""
    from scipy import ndimage

    flat = gt.reshape(-1).astype("int64")
    sizes = np.bincount(flat)
    ids = np.flatnonzero(sizes)
    if ids[0] == 0:
        raise ValueError("the oracle expects no background label")
    com = np.zeros((len(ids), 3))
    for ax, n in enumerate(gt.shape):
        shape = [1, 1, 1]
        shape[ax] = n
        coord = np.broadcast_to(np.arange(n).reshape(shape), gt.shape)
        com[:, ax] = np.bincount(flat, weights=coord.reshape(-1))[ids] \
            / sizes[ids]
    boxes = ndimage.find_objects(gt.astype("int64"))
    lo = np.array([[sl.start for sl in boxes[i - 1]] for i in ids])
    hi = np.array([[sl.stop - 1 for sl in boxes[i - 1]] for i in ids])
    return ids, sizes[ids], com, lo, hi


def disconnected_ids(labels: np.ndarray):
    """Ids whose voxels form more than one 26-connected component."""
    from scipy import ndimage

    out = []
    for i, sl in enumerate(ndimage.find_objects(labels.astype("int64")),
                           start=1):
        if sl is not None and ndimage.label(
                labels[sl] == i, np.ones((3, 3, 3), bool))[1] != 1:
            out.append(i)
    return out


def closed_mesh(faces: np.ndarray) -> bool:
    """Every edge belongs to exactly two faces (tests/test_utils.py)."""
    edges = np.sort(np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    return len(faces) > 0 and bool((counts == 2).all())


def multiset_window_sizes(shape, factor, block_bb):
    """Fine voxels in each coarse voxel's window of a coarse block."""
    per_axis = []
    for n, f, sl in zip(shape, factor, block_bb):
        start = np.arange(sl.start, sl.stop) * f
        per_axis.append(np.minimum(start + f, n) - start)
    return np.einsum("i,j,k->ijk", *per_axis).reshape(-1)


def crop_post_workflows(root: str, crop_store: str, gt_c: np.ndarray):
    """Phase 15c at full block width on phase 12's crop: morphology with
    region centers, meshes and skeletons of the MESH_BODIES largest
    bodies with their evaluation, the multiset pyramid, the decomposition
    multicut and the debugging checks over phase 13c's problem of phase
    4's fragments, and masking; each against its numpy oracle or gate."""
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.blocking import Blocking
    from cluster_tools_tpu_torch.core.storage import (VarlenDataset,
                                                      file_reader)
    from cluster_tools_tpu_torch.workflows.debugging import CheckWsWorkflow
    from cluster_tools_tpu_torch.workflows.label_multisets import \
        load_multiset_block
    from cluster_tools_tpu_torch.workflows.meshes import load_mesh
    from cluster_tools_tpu_torch.workflows.morphology import RegionCenters
    from cluster_tools_tpu_torch.workflows.skeletons import (
        SkeletonEvaluation, load_skeleton)
    from scipy.ndimage import minimum_filter

    wd = os.path.join(root, "post")
    store = os.path.join(wd, "data.n5")
    gt = gt_c.astype("uint64")
    frags = read_dataset(crop_store, "frags")
    write_labels(store, "gt", gt, LABEL_CHUNKS)
    write_labels(store, "frags", frags, LABEL_CHUNKS)
    cfg = config_dir(wd, BLOCK, "cuda", {"region_centers":
                                         {"id_chunk_size": 100}})
    n = os.cpu_count() or 1

    def common(tag):
        return dict(tmp_folder=os.path.join(wd, f"tmp_{tag}"),
                    config_dir=cfg, max_jobs=n, target=HOST_TARGET)

    walls = {}
    n_labels = int(gt.max()) + 1
    # morphology and region centers
    morpho = ctp.MorphologyWorkflow(
        input_path=store, input_key="gt", output_path=store,
        output_key="morphology", **common("morphology"))
    walls["morphology"] = timed_build(morpho, "cpu")
    walls["region_centers"] = timed_build(RegionCenters(
        input_path=store, input_key="gt", morphology_path=store,
        morphology_key="morphology", output_path=store,
        output_key="centers", n_labels=n_labels, **common("centers")),
        "cpu")
    table = read_dataset(store, "morphology")
    centers = read_dataset(store, "centers").astype("int64")
    ids, sizes, com, lo, hi = morphology_oracle(gt)
    rows = table[ids.astype("int64")]
    ok_table = (np.array_equal(rows[:, 0], ids) and
                np.array_equal(rows[:, 1], sizes) and
                np.array_equal(rows[:, 5:8], lo) and
                np.array_equal(rows[:, 8:11], hi) and
                np.allclose(rows[:, 2:5], com, rtol=COM_RTOL, atol=0) and
                not table[np.setdiff1d(np.arange(n_labels), ids), 1].any())
    inside = bool((gt[tuple(centers[ids.astype("int64")].T)] == ids).all())
    log(f"post-morphology wall_s {walls['morphology']} region_centers "
        f"wall_s {walls['region_centers']} labels {len(ids)} table == "
        f"numpy oracle {ok_table} (centers of mass rtol {COM_RTOL}) "
        f"centers inside {inside}")
    if not (ok_table and inside):
        raise AssertionError("post-morphology: table or centers wrong")
    # meshes and skeletons of the largest bodies
    threshold = int(np.sort(sizes)[::-1][MESH_BODIES - 1])
    config_dir(wd, BLOCK, "cuda", {
        "region_centers": {"id_chunk_size": 100},
        "compute_meshes": {"size_threshold": threshold},
        "skeletonize": {"size_threshold": threshold}})
    big = ids[sizes >= threshold]
    for name, cls in (("meshes", ctp.MeshWorkflow),
                      ("skeletons", ctp.SkeletonWorkflow)):
        walls[name] = timed_build(cls(
            input_path=store, input_key="gt", output_path=store,
            output_key=name, morphology_key=f"morphology_{name}",
            **common(name)), "cpu")
    meshes = {int(i): load_mesh(store, "meshes", int(i)) for i in big}
    closed = all(m is not None and closed_mesh(m[1])
                 for m in meshes.values())
    n_verts = sum(len(m[0]) for m in meshes.values() if m is not None)
    skels = {int(i): load_skeleton(store, "skeletons", int(i)) for i in big}
    in_obj = all(s is not None and len(s) and
                 bool((gt[tuple(s.T.astype("int64"))] == i).all())
                 for i, s in skels.items())
    eval_json = os.path.join(wd, "skeleton_eval.json")
    walls["skeleton_evaluation"] = timed_build(SkeletonEvaluation(
        skeleton_path=store, skeleton_key="skeletons", seg_path=store,
        seg_key="gt", n_labels=n_labels, output_path=eval_json,
        **common("skel_eval")), "cpu")
    with open(eval_json) as fh:
        ev = json.load(fh)
    log(f"post-meshes wall_s {walls['meshes']} bodies {len(big)} "
        f"size_threshold {threshold} vertices {n_verts} all closed {closed}; "
        f"skeletons wall_s {walls['skeletons']} voxels "
        f"{sum(len(s) for s in skels.values() if s is not None)} all inside "
        f"{in_obj}; evaluation wall_s {walls['skeleton_evaluation']} "
        f"mean_correctness {ev['mean_correctness']} n_skeletons "
        f"{ev['n_skeletons']} false_merges {ev['n_false_merges']}")
    if not (len(meshes) == len(skels) >= MESH_BODIES and closed and in_obj
            and ev["n_skeletons"] == len(big)
            and ev["mean_correctness"] == 1.0
            and ev["n_false_merges"] == 0):
        raise AssertionError("post-meshes/skeletons out of bounds")
    # the label multiset pyramid
    walls["multisets"] = timed_build(ctp.LabelMultisetWorkflow(
        input_path=store, input_key="gt", output_path=store,
        output_prefix="multisets", scale_factors=PYRAMID,
        **common("multisets")), "cpu")
    cum = [1, 1, 1]
    sums_ok = True
    n_entries = 0
    for s, factor in enumerate(PYRAMID, start=1):
        cum = [c * f for c, f in zip(cum, factor)]
        key = f"multisets/s{s}"
        attrs = VarlenDataset(os.path.join(store, key), mode="r").attrs
        shape, bs = attrs["multisetShape"], attrs["blockShape"]
        blocking = Blocking(shape, bs)
        for b in range(blocking.n_blocks):
            offsets, mids, counts = load_multiset_block(store, key, b)
            n_entries += len(mids)
            got = np.add.reduceat(counts, offsets[:-1]) \
                if len(counts) else np.zeros(0, "int64")
            want = multiset_window_sizes(gt.shape, cum,
                                         blocking.get_block(b).bb)
            sums_ok &= bool(np.array_equal(got, want))
    # block 0 of s1 against a numpy brute force over its fine window: the
    # window's samples side by side, sorted, counted run by run
    attrs = VarlenDataset(os.path.join(store, "multisets/s1"),
                          mode="r").attrs
    bb = Blocking(attrs["multisetShape"], attrs["blockShape"]).get_block(0).bb
    f1 = PYRAMID[0]
    coarse = [b.stop - b.start for b in bb]
    fine = gt[tuple(slice(b.start * f, b.stop * f) for b, f in zip(bb, f1))]
    if list(fine.shape) != [c * f for c, f in zip(coarse, f1)]:
        raise ValueError("the brute force expects whole windows")
    win = fine.reshape(coarse[0], f1[0], coarse[1], f1[1], coarse[2], f1[2])
    win = np.sort(win.transpose(0, 2, 4, 1, 3, 5).reshape(
        -1, int(np.prod(f1))), axis=1)
    first = np.ones(win.shape, bool)
    first[:, 1:] = win[:, 1:] != win[:, :-1]
    starts = np.flatnonzero(first.reshape(-1))
    want_counts = np.diff(np.append(starts, win.size))
    want_off = np.concatenate([[0], np.cumsum(first.sum(axis=1))])
    got_off, got_ids, got_counts = load_multiset_block(store, "multisets/s1",
                                                       0)
    brute = (np.array_equal(got_off, want_off) and
             np.array_equal(got_ids, win.reshape(-1)[starts]) and
             np.array_equal(got_counts, want_counts))
    log(f"post-multisets wall_s {walls['multisets']} levels {len(PYRAMID)} "
        f"entries {n_entries} counts == window voxels {sums_ok} s1 block 0 "
        f"== numpy brute force {brute}")
    if not (sums_ok and brute):
        raise AssertionError("post-multisets: counts or multisets wrong")
    # the decomposition multicut and the debugging checks over phase
    # 13c's problem of phase 4's fragments on the crop
    problem = os.path.join(root, "edits", "problem.n5")
    walls["decomposition"] = timed_build(ctp.DecompositionWorkflow(
        problem_path=problem, ws_path=crop_store, ws_key="frags",
        output_path=store, output_key="seg_decomposition",
        **common("decomposition")), "cpu")
    sc = scores(read_dataset(store, "seg_decomposition"), gt_c)
    with file_reader(problem, "r") as f:
        n_comp = int(f["decomposition/labeling"][:].max()) + 1
    log(f"post-decomposition wall_s {walls['decomposition']} components "
        f"{n_comp} quality {json.dumps(sc)}")
    if not (np.isfinite(list(sc.values())).all() and
            sc["cremi"] <= CREMI_GATE):
        raise AssertionError(f"post-decomposition quality: {sc}")
    walls["check_sub_graphs"] = timed_build(ctp.CheckSubGraphs(
        ws_path=crop_store, ws_key="frags", graph_path=problem,
        **common("check_sub_graphs")), "cpu")
    with open(os.path.join(wd, "tmp_check_sub_graphs",
                           "check_sub_graphs_failed.json")) as fh:
        failed = json.load(fh)
    violations_json = os.path.join(wd, "ws_violations.json")
    walls["check_ws"] = timed_build(CheckWsWorkflow(
        ws_path=store, ws_key="frags",
        debug_path=os.path.join(wd, "debug.n5"),
        output_path=violations_json, **common("check_ws")).task(), "cpu")
    with open(violations_json) as fh:
        violations = json.load(fh)
    want = disconnected_ids(frags)
    log(f"post-debugging check_sub_graphs wall_s "
        f"{walls['check_sub_graphs']} failed blocks {failed}; check_ws "
        f"wall_s {walls['check_ws']} disconnected fragments "
        f"{len(violations)} of {int(frags.max())}, "
        f"== scipy {violations == want}: {violations[:20]}")
    # the fused chain's fragments include pieces split from their body
    # (its coarse watershed and size filter, as in the JAX package), so
    # the check must list exactly those scipy finds
    if failed or violations != want:
        raise AssertionError("post-debugging: sub-graph violations, or the "
                             "component check differs from scipy")
    # masking: the block list of the largest bodies' mask, its minimum
    # filter
    mask = np.isin(gt, big).astype("uint8")
    write_dataset(store, "mask", mask, LABEL_CHUNKS)
    blocks_json = os.path.join(wd, "mask_blocks.json")
    walls["blocks_from_mask"] = timed_build(ctp.BlocksFromMask(
        mask_path=store, mask_key="mask", shape=gt.shape,
        block_shape=MASK_BLOCKS, output_path=blocks_json,
        tmp_folder=os.path.join(wd, "tmp_mask")), "cpu")
    with open(blocks_json) as fh:
        block_list = json.load(fh)
    blocking = Blocking(list(gt.shape), MASK_BLOCKS)
    want = [b for b in range(blocking.n_blocks)
            if mask[blocking.get_block(b).bb].any()]
    walls["minfilter"] = timed_build(ctp.MinFilterMask(
        input_path=store, input_key="mask", output_path=store,
        output_key="mask_min", filter_shape=MINFILTER_SHAPE,
        **common("minfilter")), "cpu")
    min_ok = bool(np.array_equal(read_dataset(store, "mask_min"),
                                 minimum_filter(mask, size=MINFILTER_SHAPE)))
    log(f"post-masking blocks_from_mask wall_s {walls['blocks_from_mask']} "
        f"blocks {len(block_list)} of {blocking.n_blocks} == numpy "
        f"{block_list == want}; minfilter wall_s {walls['minfilter']} == "
        f"scipy {min_ok}")
    if block_list != want or not min_ok:
        raise AssertionError("post-masking: block list or filter wrong")
    log(f"post walls {json.dumps(walls)}")
    return walls


def paintera_path(root: str, store: str, key: str, table_path: str):
    """Phase 15d: ``PainteraConversionWorkflow`` of the fragments
    ``store:key`` with their assignment table (the label pyramid on the
    card), then ``BigcatWorkflow`` to N5; s1 equal to the fragments
    sampled at the window centers, the lookup of LOOKUP_SAMPLES ids at s0
    equal to the blocks numpy finds them in, the pairs equal to the
    table's, the BigCat export equal to both."""
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.blocking import Blocking
    from cluster_tools_tpu_torch.core.storage import file_reader
    from cluster_tools_tpu_torch.workflows.paintera import label_to_blocks

    wd = os.path.join(root, "paintera")
    wall, out, status = run_paintera(wd, store, key, table_path, BLOCK,
                                     "cuda", HOST_TARGET)
    frags = read_dataset(store, key)
    log(f"paintera wall_s {wall} shape {list(frags.shape)} voxels_per_s "
        f"{frags.size / wall}")
    for task, st in status.items():
        log(f"paintera task {task} wall_s {st.get('wall_time')}")
    f1 = PYRAMID[0]
    centers = [np.minimum(np.arange(-(-n // f)) * f + f // 2, n - 1)
               for n, f in zip(frags.shape, f1)]
    s1 = read_dataset(out, "labels/data/s1")
    s1_ok = bool(np.array_equal(s1, frags[np.ix_(*centers)]))
    rng = np.random.RandomState(15)
    ids = np.unique(frags[::5, ::50, ::50])
    ids = ids[ids != 0]
    sample = rng.choice(ids, size=min(LOOKUP_SAMPLES, len(ids)),
                        replace=False)
    blocking = Blocking(list(frags.shape), BLOCK)
    where = {int(i): [] for i in sample}
    for b in range(blocking.n_blocks):
        sub = frags[blocking.get_block(b).bb]
        for i in np.unique(sub[np.isin(sub, sample)]):
            where[int(i)].append(b)
    lookup_ok = all(np.array_equal(np.sort(label_to_blocks(
        out, "labels/label-to-block-mapping/s0", i)), blocks)
        for i, blocks in where.items())
    table = np.load(table_path)
    frag_ids = np.arange(len(table), dtype="uint64")
    keep = frag_ids != 0
    want_pairs = np.stack([frag_ids[keep],
                           table[keep] + np.uint64(len(table))])
    with file_reader(out, "r") as f:
        pairs = f["labels/fragment-segment-assignment"][:]
        max_id = f["labels"].attrs["maxId"]
    pairs_ok = bool(np.array_equal(pairs, want_pairs))
    log(f"paintera s1 == window-center samples {s1_ok}; lookup of "
        f"{len(sample)} ids at s0 == numpy {lookup_ok}; pairs == table "
        f"{pairs_ok} ({pairs.shape[1]} fragments, maxId {max_id})")
    if not (s1_ok and lookup_ok and pairs_ok):
        raise AssertionError("paintera: pyramid, lookup or pairs wrong")
    del s1
    bigcat = os.path.join(wd, "bigcat.n5")
    tmp = os.path.join(wd, "tmp_bigcat")
    bc_wall = timed_build(ctp.BigcatWorkflow(
        input_path=store, input_key=key, output_path=bigcat,
        assignment_path=table_path, assignment_key=None, tmp_folder=tmp,
        config_dir=config_dir(os.path.join(wd, "bigcat"), BLOCK, "cuda"),
        max_jobs=os.cpu_count() or 1, target="gpu",
        resolution=(40.0, 4.0, 4.0)), "cuda")
    with file_reader(bigcat, "r") as f:
        lut = f["fragment_segment_lut"][:]
        next_id = f.attrs["next_id"]
        same = bool(np.array_equal(f["volumes/labels/fragments"][:], frags))
    bc_ok = same and np.array_equal(lut, want_pairs) and \
        next_id == int(want_pairs.max()) + 1
    log(f"bigcat wall_s {bc_wall} fragments == input {same} lut == "
        f"pairs {bool(np.array_equal(lut, want_pairs))} next_id {next_id}")
    if not bc_ok:
        raise AssertionError("bigcat: export differs")
    return {"paintera_s": wall, "bigcat_s": bc_wall}


# ---------------------------------------------------------------------------
# phase 16: the port's own storage formats — HDF5, blosc, Knossos — and
# the carving export, on the card's machine (no h5py, tensorstore,
# numcodecs)
# ---------------------------------------------------------------------------

#: 16a's HDF5 chunks of the crop's raw data
H5_CHUNKS = [25, 256, 256]
#: 16b's zarr chunks
ZARR_CHUNKS = [25, 256, 256]
#: 16d's corner of the crop, in Knossos cubes of 128^3
KNOSSOS_CORNER = (50, 256, 256)
#: 16e's fixtures (written by tensorstore and h5py, their arrays
#: regenerated by ``make_fixtures.expected``), and the fused chain's
#: blocks on their ``(32, 96, 96)`` boundary map
FORMATS_DIR = os.path.join("tests", "data", "torch_formats")
FORMATS_BLOCK = [32, 48, 48]
#: 16e decodes each fixture's chunks for at least this long for its rate
DECODE_S = 0.1


def h5_fused_path(root: str, crop_store: str):
    """Phase 16a: the crop in ``crop.h5`` (the port's HDF5 writer), the
    fused chain ``.h5`` in and out, then on the crop's N5 store; the
    fragments and segmentations identical, 3 launches per block per run.
    Returns the launches of both runs."""
    from cluster_tools_tpu_torch import kernels
    from cluster_tools_tpu_torch.core.blocking import Blocking
    from cluster_tools_tpu_torch.core.storage import file_reader

    data = read_dataset(crop_store, "bmap")
    wd = os.path.join(root, "h5")
    os.makedirs(wd)
    h5 = os.path.join(wd, "crop.h5")
    t0 = time.perf_counter()
    with file_reader(h5) as f:
        f.require_dataset("bmap", shape=data.shape, chunks=H5_CHUNKS,
                          dtype=data.dtype, compression="gzip")[:] = data
    write_s = time.perf_counter() - t0
    n_blocks = Blocking(list(CROP), list(BLOCK)).n_blocks
    out, launches = {}, 0
    for name, store, workdir in (("h5", h5, wd),
                                 ("n5", crop_store,
                                  os.path.dirname(crop_store))):
        kernels.reset_counts()
        wall, ws, seg, _ = run_workflow(workdir, store, BLOCK, "cuda",
                                        tag="_16a")
        calls = kernels.counts()["minplus"]
        launches += calls
        out[name] = (ws, seg)
        log(f"h5-fused {name} wall_s {wall} voxels_per_s "
            f"{data.size / wall} minplus launches {calls} n_fragments "
            f"{int(ws.max())} n_segments {len(np.unique(seg))}")
        if calls != 3 * n_blocks:
            raise AssertionError(f"16a {name}: min-plus kernel launched "
                                 f"{calls} times for {n_blocks} blocks")
    same_ws = bool(np.array_equal(out["h5"][0], out["n5"][0]))
    same_seg = bool(np.array_equal(out["h5"][1], out["n5"][1]))
    log(f"h5-fused crop.h5 bytes {os.path.getsize(h5)} write_s {write_s} "
        f"fragments h5 == n5 {same_ws} segmentation h5 == n5 {same_seg}")
    if not (same_ws and same_seg and out["h5"][0].shape == CROP):
        raise AssertionError("16a: the .h5 chain differs from the N5 chain")
    return launches


def blosc_path(root: str, crop_store: str):
    """Phase 16b: the crop's raw data and fragments through blosc zarr
    and, for comparison, zlib zarr; each read back identical.  Returns
    the rates by array and compressor."""
    from cluster_tools_tpu_torch.core.storage import file_reader

    rates = {}
    for key in ("bmap", "frags"):
        data = read_dataset(crop_store, key)
        for comp in ("blosc", "gzip"):
            path = os.path.join(root, "blosc", f"{key}_{comp}.zarr")
            t0 = time.perf_counter()
            with file_reader(path) as f:
                f.require_dataset(key, shape=data.shape, chunks=ZARR_CHUNKS,
                                  dtype=data.dtype, compression=comp)[:] = \
                    data
            t1 = time.perf_counter()
            back = read_dataset(path, key)
            t2 = time.perf_counter()
            nbytes = sum(os.path.getsize(os.path.join(dp, n))
                         for dp, _, names in os.walk(os.path.join(path, key))
                         for n in names if not n.startswith("."))
            same = bool(np.array_equal(back, data))
            mb = data.nbytes / 1e6
            rates[f"{key}-{comp}"] = {
                "bytes": data.nbytes, "compressed_bytes": nbytes,
                "write_mb_s": mb / (t1 - t0), "read_mb_s": mb / (t2 - t1)}
            log(f"blosc-zarr {key} {data.dtype} {comp} "
                f"{json.dumps(rates[f'{key}-{comp}'])} identical {same}")
            if not same:
                raise AssertionError(f"16b: {key} through {comp} differs")
            del back
    return rates


def carving_path(root: str, crop_store: str):
    """Phase 16c: ``WriteCarving`` of phase 13c's problem through the
    port's HDF5 writer, read back by its reader: the serialization, the
    weights, ``numNodes`` and every metadata dataset equal to what the
    task computed."""
    from cluster_tools_tpu_torch.core import hdf5
    from cluster_tools_tpu_torch.core.graph import load_graph
    from cluster_tools_tpu_torch.workflows.pixel_classification import \
        WriteCarving

    problem = os.path.join(root, "edits", "problem.n5")
    wd = os.path.join(root, "carving")
    os.makedirs(wd)
    out = os.path.join(wd, "carving.ilp")
    wall = timed_build(WriteCarving(
        graph_path=problem, graph_key="s0/graph", features_path=problem,
        features_key="features", output_path=out, raw_path=crop_store,
        raw_key="bmap", uid="chip-smoke", tmp_folder=os.path.join(wd, "tmp")),
        "cpu")
    _, edges, _ = load_graph(problem, "s0/graph")
    uv = edges.astype("uint32")
    max_id = int(uv.max())
    want_graph = WriteCarving.serialize_graph(uv, max_id)
    weights = read_dataset(problem, "features")[:, 0] * 255.0
    meta = {"Input Data/Role Names": [b"Raw Data", b"Overlay"],
            "Input Data/StorageVersion": b"0.2",
            "Input Data/infos/lane0000/Raw Data/allowLabels": True,
            "Input Data/infos/lane0000/Raw Data/axisorder": b"zyx",
            "Input Data/infos/lane0000/Raw Data/fromstack": False,
            "Input Data/infos/lane0000/Raw Data/datasetId": b"chip-smoke",
            "Input Data/infos/lane0000/Raw Data/display_mode": b"default",
            "Input Data/infos/lane0000/Raw Data/filePath":
                os.path.join(crop_store, "bmap").encode(),
            "Input Data/infos/lane0000/Raw Data/location": b"FileSystem",
            "Input Data/infos/lane0000/Raw Data/nickname": b"Input",
            "workflowName": b"Carving", "ilastikVersion": b"1.3.0b2",
            "currentApplet": 2, "preprocessing/StorageVersion": b"0.1",
            "preprocessing/filter": 3, "preprocessing/sigma": 1.0,
            "preprocessing/invert_watershed_source": False,
            "preprocessing/watershed_source": b"filtered",
            "carving/StorageVersion": b"0.1"}
    with hdf5.File(out, "r") as f:
        g = f["preprocessing/graph"]
        graph_ok = bool(np.array_equal(g["graph"][()], want_graph))
        weights_ok = bool(np.array_equal(g["edgeWeights"][()], weights))
        nodes_ok = int(g.attrs["numNodes"]) == max_id + 1 and all(
            g[k].shape == (max_id + 1,) and not g[k][()].any()
            for k in ("nodeSeeds", "resultSegmentation"))
        bad = [k for k, v in meta.items()
               if np.asarray(f[k][()]).tolist() != np.asarray(v).tolist()]
        groups_ok = "carving/objects" in f and "Input Data/local_data" in f
    log(f"carving wall_s {wall} bytes {os.path.getsize(out)} nodes "
        f"{max_id + 1} edges {len(uv)} graph {graph_ok} weights "
        f"{weights_ok} numNodes/seeds {nodes_ok} metadata mismatches {bad} "
        f"groups {groups_ok}")
    if not (graph_ok and weights_ok and nodes_ok and groups_ok) or bad:
        raise AssertionError("16c: the carving project differs")


def knossos_path(root: str, crop_store: str):
    """Phase 16d: a corner of the crop as raw Knossos cubes (zero-padded
    to whole cubes), read through ``file_reader(".knossos")``."""
    from cluster_tools_tpu_torch.core.storage import file_reader

    corner = read_dataset(crop_store, "bmap",
                          tuple(slice(0, c) for c in KNOSSOS_CORNER))
    bs = 128
    grid = [-(-c // bs) for c in KNOSSOS_CORNER]
    padded = np.zeros([g * bs for g in grid], "uint8")
    padded[tuple(slice(0, c) for c in KNOSSOS_CORNER)] = corner
    mag = os.path.join(root, "crop.knossos", "mag1")
    for gz in range(grid[0]):
        for gy in range(grid[1]):
            for gx in range(grid[2]):
                d = os.path.join(mag, f"x{gx:04d}", f"y{gy:04d}",
                                 f"z{gz:04d}")
                os.makedirs(d)
                cube = padded[gz * bs:(gz + 1) * bs, gy * bs:(gy + 1) * bs,
                              gx * bs:(gx + 1) * bs]
                cube.tofile(os.path.join(
                    d, f"crop_mag1_x{gx:04d}_y{gy:04d}_z{gz:04d}.raw"))
    t0 = time.perf_counter()
    with file_reader(os.path.dirname(mag), "r") as f:
        ds = f["mag1"]
        got = ds[tuple(slice(0, c) for c in KNOSSOS_CORNER)]
        pad = ds[KNOSSOS_CORNER[0]:, :, :]
        shape = ds.shape
    read_s = time.perf_counter() - t0
    ok = bool(np.array_equal(got, corner)) and not pad.any()
    log(f"knossos cubes {int(np.prod(grid))} shape {list(shape)} read_s "
        f"{read_s} corner == crop {ok}")
    if not ok or shape != tuple(g * bs for g in grid):
        raise AssertionError("16d: the Knossos read differs")


def _chunk_decoders(ds):
    """A function decoding every stored chunk of a dataset the port's
    ``file_reader`` opened (zarr and N5: the chunk files' bytes held in
    memory; HDF5: its chunk index's entries), and their plain bytes; None
    for an HDF5 dataset that is not chunked."""
    from itertools import product

    from cluster_tools_tpu_torch.core.storage import _H5Dataset

    if isinstance(ds, _H5Dataset):
        inner = ds._ds
        if inner.chunks is None:
            return None
        entries = list(inner._obj.index().items())
        nbytes = len(entries) * int(np.prod(inner.chunks)) * \
            inner.dtype.itemsize

        def decode():
            for pos, entry in entries:
                inner._decode_chunk(entry, pos)
        return decode, nbytes
    grid = [range(-(-s // c)) for s, c in zip(ds.shape, ds.chunks)]
    raws = []
    for cid in product(*grid):
        with open(ds._chunk_file(cid), "rb") as fh:
            raws.append(fh.read())
    nbytes = len(raws) * int(np.prod(ds.chunks)) * ds.dtype.itemsize

    def decode():
        for raw in raws:
            ds._codec.decode(raw)
    return decode, nbytes


def run_chain_into(workdir: str, in_path: str, out_store: str, block,
                   device: str, tag: str):
    """The fused chain (default execution) reading ``bmap`` of
    ``in_path`` and writing ``ws``/``seg`` into ``out_store``; returns
    (wall s, fragments, segmentation)."""
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir

    cfg_dir = os.path.join(workdir, f"configs{tag}")
    ConfigDir(cfg_dir).write_global_config({"block_shape": list(block),
                                            "device": device})
    ConfigDir(cfg_dir).write_task_config("fused_segmentation", {})
    tmp = os.path.join(workdir, f"tmp{tag}")
    wf = ctp.MulticutSegmentationWorkflow(
        input_path=in_path, input_key="bmap", ws_path=out_store,
        ws_key="ws", problem_path=os.path.join(workdir, f"problem{tag}.n5"),
        output_path=out_store, output_key="seg", tmp_folder=tmp,
        config_dir=cfg_dir, max_jobs=os.cpu_count() or 1, target="gpu",
        n_scales=1, fused=True)
    wall, ws, seg, _ = _build(wf, tmp, out_store, "ws", "seg", device)
    return wall, ws, seg


def formats_path(root: str, repo: str, device: str = "cuda"):
    """Phase 16e: every fixture of ``tests/data/torch_formats/`` read
    through the port identical to its regenerated array, each decoder's
    MB/s on the fixtures' chunks, then the fused chain on the boundary
    map from zarr (F order, blosc Zstd, bitshuffle), from
    ``libver="latest"`` HDF5 (LZF) and from N5 (raw, written here), all
    three identical with 3 kernel launches per block.  Returns (the
    chain's launches, MB/s by decoder)."""
    import importlib.util

    from cluster_tools_tpu_torch import kernels
    from cluster_tools_tpu_torch.core.blocking import Blocking
    from cluster_tools_tpu_torch.core.storage import file_reader

    src = os.path.join(repo, FORMATS_DIR)
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(src, "make_fixtures.py"))
    mf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mf)
    wd = os.path.join(root, "formats")
    # a copy: nothing is written into the checkout
    shutil.copytree(src, wd, ignore=shutil.ignore_patterns("__pycache__",
                                                           "*.py"))
    rates = {}
    for container, key, name, codec in mf.CASES:
        want = mf.expected(name)
        with file_reader(os.path.join(wd, container), "r") as f:
            ds = f[key]
            got = ds[...]
            if not (got.dtype == want.dtype and got.shape == want.shape
                    and got.tobytes() == want.tobytes()):
                raise AssertionError(f"16e: {container}/{key} differs from "
                                     f"its regenerated {name}")
            job = _chunk_decoders(ds)
            if job is None:
                continue
            decode, nbytes = job
            n, t0 = 0, time.perf_counter()
            while n == 0 or time.perf_counter() - t0 < DECODE_S:
                decode()
                n += 1
            acc = rates.setdefault(codec, [0, 0.0])
            acc[0] += n * nbytes
            acc[1] += time.perf_counter() - t0
    mb_s = {c: b / 1e6 / s for c, (b, s) in sorted(rates.items())}
    log(f"formats fixtures {len(mf.CASES)} identical True decode_mb_s "
        f"{json.dumps(mb_s)}")
    bmap = mf.expected("bmap")
    n5 = os.path.join(wd, "bmap.n5")
    with file_reader(n5) as f:
        f.require_dataset("bmap", shape=bmap.shape, chunks=FORMATS_BLOCK,
                          dtype=bmap.dtype)[:] = bmap
    n_blocks = Blocking(list(bmap.shape), FORMATS_BLOCK).n_blocks
    out, launches = {}, 0
    for name, store in (("zarr", os.path.join(wd, "bmap.zarr")),
                        ("h5", os.path.join(wd, "bmap.h5")), ("n5", n5)):
        kernels.reset_counts()
        wall, ws, seg = run_chain_into(
            os.path.join(wd, f"run_{name}"), store,
            os.path.join(wd, f"out_{name}.n5"), FORMATS_BLOCK, device,
            f"_16e_{name}")
        calls = kernels.counts()["minplus"]
        launches += calls
        out[name] = (ws, seg)
        log(f"formats-fused {name} wall_s {wall} minplus launches {calls} "
            f"n_fragments {int(ws.max())} n_segments {len(np.unique(seg))}")
        if device == "cuda" and calls != 3 * n_blocks:
            raise AssertionError(f"16e {name}: min-plus kernel launched "
                                 f"{calls} times for {n_blocks} blocks")
    same = all(np.array_equal(out[k][i], out["n5"][i])
               for k in ("zarr", "h5") for i in (0, 1))
    log(f"formats-fused fragments and segmentation zarr == h5 == n5 {same}")
    if not same or out["n5"][0].shape != bmap.shape or \
            int(out["n5"][0].max()) < 2:
        raise AssertionError("16e: the chain's runs differ")
    return launches, mb_s


# ---------------------------------------------------------------------------
# phase 17: multi-device — MESH_SHARDS shards on the one card
# ---------------------------------------------------------------------------

#: shards of phase 17's meshes, all on cuda:0 (the global config's
#: ``mesh_devices``): the halo ring, the offset scan and the face exchange
#: run on the card although it is one card
MESH_SHARDS = 4
#: phase 17a/b's volume
P17_SHAPE = (64, 256, 256)
P17_HALO = 3
P17_SIGMA = 2.0
#: phase 17e's crop of phase 10a's input, in config 2's blocks (8 blocks:
#: two rounds of 4)
P17_CC_CROP = (64, 512, 512)
#: phase 17f: outer blocks of phase 8a's geometry and the gate against the
#: per-block forwards
P17_INF_OUTER = (60, 544, 544)
SHARDED_ATOL = 2e-5
#: phase 17g's two processes' script
MP_DRIVER = """
import json, os, sys
sys.path.insert(0, {repo!r})

from cluster_tools_tpu_torch.core.blocking import Blocking
from cluster_tools_tpu_torch.core.runtime import BlockTask
from cluster_tools_tpu_torch.core.storage import file_reader


class CardFillTask(BlockTask):
    '''Writes 2 * vol + block id per block, computed on the card.'''

    task_name = "card_fill"

    def __init__(self, path, **kw):
        self.path = path
        super().__init__(**kw)

    def run_impl(self):
        with file_reader(self.path, "r") as f:
            shape = list(f["vol"].shape)
        bs = self.global_block_shape()
        with file_reader(self.path) as f:
            f.require_dataset("out", shape=shape, chunks=bs,
                              dtype="float32")
        self.run_jobs(self.blocks_in_volume(shape, bs),
                      {{"path": self.path, "shape": shape,
                        "block_shape": bs}})

    @classmethod
    def process_job(cls, job_id, job_config, log_fn):
        import torch

        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        f = file_reader(cfg["path"])
        for bid in job_config["block_list"]:
            bb = blocking.get_block(bid).bb
            x = torch.from_numpy(f["vol"][bb]).to("cuda")
            f["out"][bb] = (x * 2.0 + float(bid)).cpu().numpy()
            log_fn(f"processed block {{bid}}")


if __name__ == "__main__":
    import torch
    import torch.distributed as dist
    from cluster_tools_tpu_torch.core.workflow import build
    from cluster_tools_tpu_torch.parallel import multihost as mh

    pid = int(sys.argv[1])
    mh.init_distributed(coordinator_address="127.0.0.1:{port}",
                        num_processes=2, process_id=pid)
    task = CardFillTask(path={path!r}, tmp_folder={tmp!r},
                        config_dir={cfg!r}, max_jobs=2, target="gpu")
    assert build([task], raise_on_failure=True)
    x = torch.arange(4, dtype=torch.float32) + 10 * pid
    dist.all_reduce(x)
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps({{"pid": pid, "all_reduce": x.tolist(),
                      "device": torch.cuda.get_device_name(0)}}))
"""


def _mesh(axis: str, device: str = "cuda"):
    from cluster_tools_tpu_torch.parallel import mesh as pm

    return pm.single_axis_mesh(axis, MESH_SHARDS,
                               devices=pm.shard_devices(device,
                                                        MESH_SHARDS))


def mesh_stencil_card():
    """Phase 17a: ``halo_exchange`` (constant and reflect) over 4 shards
    of a ``P17_SHAPE`` float32 volume, bitwise equal to the dense volume
    padded and cut with overlaps, and a ``sharded_stencil`` Gaussian
    bitwise equal to the dense Gaussian away from the volume ends (where
    the stencil's own padding differs)."""
    import torch

    from cluster_tools_tpu_torch.ops.filters import _gaussian_kernel, \
        gaussian
    from cluster_tools_tpu_torch.parallel import mesh as pm
    from cluster_tools_tpu_torch.parallel import stencil as ps

    mesh = _mesh("space")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    x = torch.rand(P17_SHAPE, device="cuda", generator=gen)
    shards = pm.shard(x, mesh, pm.Placement(("space",)))
    step, h = P17_SHAPE[0] // MESH_SHARDS, P17_HALO
    rec = {"mesh": mesh.describe()}
    ok = mesh.physical_devices == 1 and all(
        s.device.type == "cuda" for s in shards)
    for mode in ("constant", "reflect"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grown = ps.halo_exchange(shards, h, 0, fill=-1.0, mode=mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if mode == "reflect":
            xp = torch.cat([x[1:h + 1].flip(0), x, x[-h - 1:-1].flip(0)])
        else:
            pad = torch.full((h,) + P17_SHAPE[1:], -1.0, device="cuda")
            xp = torch.cat([pad, x, pad])
        same = all(torch.equal(g, xp[i * step:i * step + step + 2 * h])
                   for i, g in enumerate(grown))
        # the grown shards own their storage: no shard aliases another
        ptrs = {g.data_ptr() for g in grown} | {s.data_ptr() for s in shards}
        rec[mode] = {"wall_s": wall, "bitwise": same,
                     "distinct_storage": len(ptrs) == 2 * MESH_SHARDS}
        ok = ok and same and len(ptrs) == 2 * MESH_SHARDS
    r = _gaussian_kernel(P17_SIGMA).shape[0] // 2
    fn = ps.sharded_stencil(lambda a: gaussian(a, P17_SIGMA), mesh, halo=r,
                            axis=0, mesh_axis="space", mode="reflect")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = fn(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = gaussian(x, P17_SIGMA)
    same = torch.equal(got[r:-r], want[r:-r])
    rec["gaussian"] = {"sigma": P17_SIGMA, "halo": r, "wall_s": wall,
                       "bitwise_interior": same}
    log(f"mesh-stencil shape {list(P17_SHAPE)} {json.dumps(rec)}")
    if not (ok and same):
        raise AssertionError(f"mesh stencil on the card: {rec}")


def mesh_program_card_vs_cpu(root: str):
    """Phase 17b: the mesh-resident program on a ``P17_SHAPE`` uint8 crop
    of phase 4's volume, 4 shards on the card against 4 on the CPU:
    labels, meta and edge tables identical, features identical but for
    the mean and variance (rtol 1e-6: the float32 ``hist @ levels``
    product sums in another order); 3 kernel launches per shard on the
    card, none on the CPU.  Returns the card's launches."""
    import torch

    from cluster_tools_tpu_torch import kernels
    from cluster_tools_tpu_torch.parallel import mesh as pm
    from cluster_tools_tpu_torch.workflows import fused_pipeline as fp

    box = tuple(slice(0, c) for c in P17_SHAPE)
    data = read_dataset(os.path.join(root, "main", "data.n5"), "bmap", box)
    cfg = fp.FusedSegmentationBlocks.default_task_config()
    # the fused task's defaults, as the mesh-resident driver sets them
    params = fp.mesh_params(cfg, P17_SHAPE, MESH_SHARDS, cfg["halo"], True,
                            cfg["e_max"], 1)
    out, launches, walls = {}, {}, {}
    for dev in ("cuda", "cpu"):
        mesh = _mesh("shard", dev)
        slabs = pm.shard(torch.from_numpy(np.ascontiguousarray(data)), mesh,
                         pm.Placement(("shard",)))
        kernels.reset_counts()
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        labs, metas, uvs, fts = fp.mesh_resident_program(slabs, params)
        meta = torch.stack([m.cpu() for m in metas]).numpy()
        walls[dev] = time.perf_counter() - t0
        launches[dev] = kernels.counts()["minplus"]
        out[dev] = (torch.cat([t.cpu() for t in labs]).numpy(), meta,
                    [u.cpu().numpy()[:meta[s, 1]] for s, u in enumerate(uvs)],
                    [f.cpu().numpy()[:meta[s, 1]] for s, f in enumerate(fts)])
    (lc, mc, uc, fc), (lp, mp, up, fpp) = out["cuda"], out["cpu"]
    same_uv = all(np.array_equal(a, b) for a, b in zip(uc, up))
    same_q = all(np.array_equal(a[:, 2:], b[:, 2:]) for a, b in zip(fc, fpp))
    err_mv = max((float(np.abs(a[:, :2] - b[:, :2]).max()) if len(a) else 0.0)
                 for a, b in zip(fc, fpp))
    close_mv = all(np.allclose(a[:, :2], b[:, :2], rtol=1e-6, atol=1e-7)
                   for a, b in zip(fc, fpp))
    rec = {"labels": bool(np.array_equal(lc, lp)),
           "meta": bool(np.array_equal(mc, mp)), "uv": same_uv,
           "feats_cols_2_on": same_q, "feats_identical": all(
               np.array_equal(a, b) for a, b in zip(fc, fpp)),
           "mean_var_max_abs_err": err_mv, "n_fragments": int(mc[:, 0].sum()),
           "n_edges": int(mc[:, 1].sum()), "launches": launches,
           "wall_s": walls}
    log(f"mesh-program card-vs-cpu shape {list(P17_SHAPE)} "
        f"{json.dumps(rec)}")
    if not (rec["labels"] and rec["meta"] and same_uv and same_q
            and close_mv and mc[:, 4].all() and launches["cpu"] == 0
            and launches["cuda"] == 3 * MESH_SHARDS):
        raise AssertionError(f"mesh program card and CPU disagree: {rec}")
    return launches["cuda"]


def _job_log_line(tmp: str, task: str, needle: str) -> str:
    path = os.path.join(tmp, "logs", f"{task}_0.log")
    with open(path) as f:
        for line in f:
            if needle in line:
                return line.strip()
    return ""


def mesh_resident_path(root: str, block, gt: np.ndarray, block_quality):
    """Phase 17c: the fused chain with ``mesh_resident: true`` and 4
    shards on phase 4's volume (slabs ``[32, 1250, 1250]``): CREMI under
    its gate, VOI against the ground truth within VOI_GATE of phase 4's
    blockwise run, ONE ``sync-execute``, 3 kernel launches per shard.
    Returns the launches."""
    import torch

    from cluster_tools_tpu_torch import kernels

    wd = os.path.join(root, "main")
    store = os.path.join(wd, "data.n5")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    wall, ws, seg, status = run_workflow(
        wd, store, block, "cuda",
        {"mesh_resident": True, "mesh_shards": MESH_SHARDS}, tag="_mesh",
        mesh_devices=MESH_SHARDS)
    launches = kernels.counts()["minplus"]
    peak = torch.cuda.max_memory_allocated()
    fused = status["fused_segmentation"]
    caps = _job_log_line(os.path.join(wd, "tmp_mesh"), "fused_segmentation",
                         "capacities")
    log(f"mesh-resident shape {list(FULL_SHAPE)} slabs "
        f"{fused.get('n_blocks')} wall_s {wall} "
        f"voxels_per_s {int(np.prod(FULL_SHAPE)) / wall} "
        f"peak_device_bytes {peak} mesh_devices {fused.get('mesh_devices')} "
        f"physical_devices {fused.get('physical_devices')} {caps}")
    for task, st in status.items():
        log(f"mesh-resident task {task} wall_s {st.get('wall_time')} "
            f"stages {json.dumps(st.get('stages', {}))} "
            f"stage_counts {json.dumps(st.get('stage_counts', {}))}")
    sc = scores(seg, gt)
    v_mesh = sc["voi_split"] + sc["voi_merge"]
    v_block = block_quality["voi_split"] + block_quality["voi_merge"]
    syncs = fused["stage_counts"].get("sync-execute")
    log(f"mesh-resident quality {json.dumps(sc)} n_fragments "
        f"{int(ws.max())} VOI {v_mesh} blockwise VOI {v_block} "
        f"(gate {VOI_GATE}) sync-execute {syncs} minplus launches "
        f"{launches}")
    if not (np.isfinite(list(sc.values())).all()
            and sc["cremi"] <= CREMI_GATE
            and abs(v_mesh - v_block) <= VOI_GATE):
        raise AssertionError(f"mesh-resident quality out of bounds: {sc}")
    if syncs != 1 or launches != 3 * MESH_SHARDS or \
            fused.get("mesh_devices") != MESH_SHARDS or \
            fused.get("physical_devices") != 1:
        raise AssertionError(f"mesh-resident dispatch: sync-execute {syncs}"
                             f" launches {launches} status {fused}")
    return launches


def mesh_target_crop(root: str, crop_store: str, block):
    """Phase 17d: on phase 12's two-block crop, the fused chain and the
    split chain's watershed under ``target="mesh"`` (block i on shard i mod
    4), bitwise equal to the same chains
    under ``target="gpu"``; returns the kernel launches by run."""
    from cluster_tools_tpu_torch import kernels
    from cluster_tools_tpu_torch.core.blocking import Blocking

    wd = os.path.dirname(crop_store)
    n_blocks = Blocking(list(CROP), list(block)).n_blocks
    launches, frags, walls = {}, {}, {}
    for target in ("gpu", "mesh"):
        kernels.reset_counts()
        walls[f"fused-{target}"], ws, seg, st = run_workflow(
            wd, crop_store, block, "cuda", tag=f"_17{target}",
            target=target, mesh_devices=MESH_SHARDS)
        launches[f"fused-{target}"] = kernels.counts()["minplus"]
        frags[f"fused-{target}"] = (ws, seg)
        kernels.reset_counts()
        walls[f"ws-{target}"], w, _ = run_ws(
            wd, crop_store, block, "cuda", {}, tag=f"_17ws{target}",
            target=target, mesh_devices=MESH_SHARDS)
        launches[f"ws-{target}"] = kernels.counts()["minplus"]
        frags[f"ws-{target}"] = (w,)
    same = {k: all(np.array_equal(a, b) for a, b in
                   zip(frags[f"{k}-mesh"], frags[f"{k}-gpu"]))
            for k in ("fused", "ws")}
    log(f"mesh-target crop {list(CROP)} blocks {n_blocks} "
        f"bitwise {json.dumps(same)} walls {json.dumps(walls)} "
        f"minplus launches {json.dumps(launches)}")
    # three EDT launches per block on either target: no shard runs
    # anything but its own blocks
    expect = {k: 3 * n_blocks for k in launches}
    if not all(same.values()) or launches != expect:
        raise AssertionError(f"mesh target: bitwise {same} launches "
                             f"{launches} (expected {expect})")
    return launches


def mesh_cc_crop(root: str):
    """Phase 17e: ``ThresholdedComponentsWorkflow(target="mesh")`` on a
    ``P17_CC_CROP`` crop of phase 10a's input (two rounds of 4 blocks):
    the ``gpu`` run's labels, scipy's partition, faces merged on the
    card."""
    from scipy import ndimage

    box = tuple(slice(0, c) for c in P17_CC_CROP)
    vol = read_dataset(os.path.join(root, "cc_main", "data.n5"), "raw", box)
    wd = os.path.join(root, "cc_mesh")
    store = os.path.join(wd, "data.n5")
    write_dataset(store, "raw", vol, CC_BLOCK)
    out, walls = {}, {}
    for target in ("gpu", "mesh"):
        walls[target], out[target], _, status = run_cc(
            os.path.join(wd, target), store, "raw", f"cc_{target}", CC_BLOCK,
            "cuda", target, mesh_devices=MESH_SHARDS)
        if target == "mesh":
            st = status["mesh_block_components"]
            with open(os.path.join(wd, target, "tmp", "cc_offsets.json")) \
                    as f:
                covered = len(json.load(f)["covered_faces"])
    ref, n = ndimage.label(vol > CC_THRESHOLD)
    rec = {"identical": bool(np.array_equal(out["mesh"], out["gpu"])),
           "scipy_partition": same_partition(out["mesh"], ref),
           "n_components": int(out["mesh"].max()), "n_scipy": int(n),
           "covered_faces": covered, "mesh_devices": st.get("mesh_devices"),
           "physical_devices": st.get("physical_devices"), "walls": walls}
    log(f"mesh-cc crop {list(P17_CC_CROP)} {json.dumps(rec)}")
    if not (rec["identical"] and rec["scipy_partition"] and covered > 0
            and rec["mesh_devices"] == MESH_SHARDS):
        raise AssertionError(f"mesh CC: {rec}")


def sharded_inference(root: str, ckpt: str):
    """Phase 17f: ``predict_sharded`` of 4 outer ``P17_INF_OUTER`` blocks of
    phase 4's volume with the default-width U-Net over 4 shards on the
    card, within SHARDED_ATOL of the per-block forwards of
    ``InferenceTask``'s predictor."""
    import torch

    from cluster_tools_tpu_torch.parallel.mesh import shard_devices
    from cluster_tools_tpu_torch.workflows.inference import (make_predictor,
                                                             predict_sharded)

    main = os.path.join(root, "main", "data.n5")
    d, h, w = P17_INF_OUTER
    vol = np.stack([read_dataset(main, "bmap", (slice(0, d),
                                                slice(y, y + h),
                                                slice(x, x + w)))
                    for y in (0, h) for x in (0, w)])
    devs = shard_devices("cuda", MESH_SHARDS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = predict_sharded(ckpt, vol, devices=devs)
    wall = time.perf_counter() - t0
    pred = make_predictor(ckpt, P17_INF_OUTER, (0, 0, 0), device="cuda")
    t0 = time.perf_counter()
    want = np.stack([pred(b) for b in vol])
    wall_pb = time.perf_counter() - t0
    err = float(np.abs(got - want).max())
    log(f"sharded-inference blocks {len(vol)} outer {list(P17_INF_OUTER)} "
        f"wall_s {wall} per-block wall_s {wall_pb} max_abs_err {err} "
        f"(gate {SHARDED_ATOL})")
    if got.shape != want.shape or not np.isfinite(got).all() or \
            err > SHARDED_ATOL:
        raise AssertionError(f"predict_sharded differs from the per-block "
                             f"forwards by {err}")


def two_process_run(root: str):
    """Phase 17g: two processes on the card's machine — a ``BlockTask``
    (each block ``2 * vol + id`` computed on the card) split between them
    through the runtime's multi-process path, and a gloo ``all_reduce``
    over ``torch.distributed`` at ``tcp://127.0.0.1``."""
    import socket

    from cluster_tools_tpu_torch.core.blocking import Blocking
    from cluster_tools_tpu_torch.core.config import ConfigDir

    wd = os.path.join(root, "multiprocess")
    os.makedirs(wd)
    store = os.path.join(wd, "data.n5")
    shape, bs = (64, 256, 256), [32, 128, 128]
    vol = np.random.RandomState(17).rand(*shape).astype("float32")
    write_dataset(store, "vol", vol, bs)
    cfg = os.path.join(wd, "configs")
    ConfigDir(cfg).write_global_config({"block_shape": bs,
                                        "device": "cuda"})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = os.path.join(wd, "driver.py")
    tmp = os.path.join(wd, "tmp")
    with open(script, "w") as f:
        f.write(MP_DRIVER.format(repo=os.path.dirname(
            os.path.abspath(__file__)), port=port, path=store, tmp=tmp,
            cfg=cfg))
    env = {k: v for k, v in os.environ.items()
           if k not in ("CTT_PROCESS_COUNT", "CTT_PROCESS_ID")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, script, str(pid)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for pid in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    wall = time.perf_counter() - t0
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"process failed:\n{o[-3000:]}")
    res = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    out = read_dataset(store, "out")
    blocking = Blocking(list(shape), bs)
    want = np.empty_like(vol)
    for bid in range(blocking.n_blocks):
        bb = blocking.get_block(bid).bb
        want[bb] = vol[bb] * 2.0 + float(bid)
    per_job = []
    for job in (0, 1):
        with open(os.path.join(tmp, "logs", f"card_fill_{job}.log")) as f:
            per_job.append(f.read().count("processed block"))
    with open(os.path.join(tmp, "card_fill.status")) as f:
        st = json.load(f)
    rec = {"wall_s": wall, "blocks_per_process": per_job,
           "all_reduce": [r["all_reduce"] for r in res],
           "identical": bool(np.array_equal(out, want)),
           "status_process_count": st.get("process_count")}
    log(f"two-process {json.dumps(rec)}")
    if not (rec["identical"] and all(c > 0 for c in per_job)
            and sum(per_job) == blocking.n_blocks
            and all(r["all_reduce"] == [10.0, 12.0, 14.0, 16.0] for r in res)
            and rec["status_process_count"] == 2):
        raise AssertionError(f"two-process run: {rec}")


def mesh_paths(root: str, block, gt: np.ndarray, block_quality,
               crop_store: str, ckpt: str):
    """Phase 17: the multi-device paths with MESH_SHARDS shards on the one
    card; returns the kernel launches by part."""
    log(f"phase 17: {MESH_SHARDS} shards on 1 card")
    launches = {}
    _phase("17a", mesh_stencil_card)
    launches["17b"] = _phase("17b", mesh_program_card_vs_cpu, root)
    launches["17c"] = _phase("17c", mesh_resident_path, root, block, gt,
                             block_quality)
    launches.update({f"17d-{k}": v for k, v in _phase(
        "17d", mesh_target_crop, root, crop_store, block).items()})
    _phase("17e", mesh_cc_crop, root)
    _phase("17f", sharded_inference, root, ckpt)
    _phase("17g", two_process_run, root)
    return launches


# ---------------------------------------------------------------------------
# phase 18: training and the parallel primitives
# ---------------------------------------------------------------------------

#: 18a: the small float32 U-Net and batch (B, D, H, W), card against CPU
P18_FEATURES = (4, 8)
P18_SMALL = (2, 8, 32, 32)
#: 18b: the full-width batch, crops of phase 4's volume
P18_CROP = (32, 256, 256)
P18_CORNERS = ((0, 0, 0), (32, 256, 256))
P18_STEPS = 10
P18_SHARDED_STEPS = 3
P18_MESH = 8
#: float32 card against CPU, and sharded against unsharded: gradients
TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL = 1e-4, 1e-6
#: float32 sharded loss against unsharded
SHARD_LOSS_RTOL = 1e-5
#: bfloat16 sharded losses against unsharded (the CPU tests' bfloat16
#: loss gate)
SHARD_BF16_RTOL = 2e-2
#: the loss of the step after a restore
RESTORE_RTOL = 1e-6
#: 18e: the JAX package's orbax train states (its float32 losses held to
#: SHARD_LOSS_RTOL, 18a's gate of the card against the CPU; its
#: bfloat16 losses to SHARD_BF16_RTOL)
TRAIN_STATES_DIR = os.path.join("tests", "data", "torch_train_states")
#: 18d: the primitives on 4 shards
P18_SHARDS = 4
PIPE_D, PIPE_MICRO, PIPE_ROWS = 1024, 16, 512
MOE_TOKENS, MOE_D = 8192, 1024
RING_T, RING_H, RING_D = 8192, 8, 64
PRIM_RTOL, PRIM_ATOL = 2e-4, 1e-5
RING_BF16_ATOL = 1e-2


def _adamw_gate(name, got, want, grads, lr=1e-3):
    """Parameters after one step from two computations of the gradient:
    within 2 lr everywhere (a first Adam step moves each element by about
    lr sign(g)), within 1e-7 where |g| > 1e-6."""
    worst, worst_big = 0.0, 0.0
    for k in want:
        d = (got[k].float().cpu() - want[k].float().cpu()).abs()
        big = grads[k].abs().cpu() > 1e-6
        worst = max(worst, float(d.max()))
        if big.any():
            worst_big = max(worst_big, float(d[big].max()))
    if worst > 2 * lr * (1 + 1e-3) or worst_big > 1e-7:
        raise AssertionError(f"{name}: parameters after one step differ by "
                             f"{worst} (|g| > 1e-6: {worst_big})")
    return worst, worst_big


def _whole_grads(state, grads):
    from cluster_tools_tpu_torch.models import train as T
    from cluster_tools_tpu_torch.parallel import mesh as pm

    out = {}
    for name, shards in state.params.items():
        pl = state.placements[name]
        owner = T._masters(state.mesh, pl, shards[0].ndim)
        out[name] = pm.unshard([grads[(name, o)] for o in owner],
                               state.mesh, pl)
    return out


def _grad_err(a, b):
    """Max abs error and the worst excess over rtol/atol."""
    err, excess = 0.0, 0.0
    for k in b:
        d = (a[k].cpu() - b[k].cpu()).abs()
        lim = TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL * b[k].cpu().abs()
        err = max(err, float(d.max()))
        excess = max(excess, float((d - lim).max()))
    return err, excess


def _mesh8(device="cuda"):
    from cluster_tools_tpu_torch.parallel import mesh as pm

    return pm.make_mesh(devices=pm.shard_devices(device, P18_MESH))


def train_card_vs_cpu():
    """Phase 18a: a float32 U-Net (features P18_FEATURES) on P18_SMALL:
    the loss and every gradient card against CPU from one state; then
    ``shard_train_step`` over 8 shards (2, 2, 2) on the card against the
    unsharded step on the card."""
    import torch

    from cluster_tools_tpu_torch.models import train as T
    from cluster_tools_tpu_torch.models.unet import create_unet
    from cluster_tools_tpu_torch.parallel import mesh as pm

    b, d, h, w = P18_SMALL
    model = create_unet(out_channels=3, features=P18_FEATURES,
                        anisotropic=False, dtype=torch.float32)
    state = T.init_state(model, (b, 1, d, h, w),
                         generator=torch.Generator().manual_seed(0),
                         device="cpu")
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(b, 1, d, h, w).astype("float32"))
    y = torch.from_numpy((rng.rand(b, 3, d, h, w) > 0.5).astype("float32"))
    loss_cpu, g_cpu = T.loss_and_grads(model, state.params, x, y)
    card = {k: v.cuda() for k, v in state.params.items()}
    loss_card, g_card = T.loss_and_grads(model, card, x.cuda(), y.cuda())
    err, excess = _grad_err(g_card, g_cpu)
    rec = {"loss_card": float(loss_card), "loss_cpu": float(loss_cpu),
           "loss_rel_err": abs(float(loss_card) / float(loss_cpu) - 1),
           "grad_max_abs_err": err, "rtol": TRAIN_GRAD_RTOL,
           "atol": TRAIN_GRAD_ATOL}
    log(f"train-card-vs-cpu {json.dumps(rec)}")
    if excess > 0 or rec["loss_rel_err"] > SHARD_LOSS_RTOL:
        raise AssertionError(f"training card and CPU disagree: {rec}")
    mesh = _mesh8()
    cstate = state.replace(params=card,
                           opt_state=T.make_optimizer().init(card))
    step, sstate, pl = T.shard_train_step(model, cstate, mesh)
    xs = pm.shard(x.cuda(), mesh, pl)
    ys = pm.shard(y.cuda(), mesh, pl)
    sloss, sgrads = T.sharded_loss_and_grads(model, sstate, xs, ys)
    err, excess = _grad_err(_whole_grads(sstate, sgrads), g_card)
    s1, l1 = step(sstate, xs, ys)
    u1, lu = T.make_train_step(model)(cstate, x.cuda(), y.cuda())
    gate = _adamw_gate("18a sharded", T.unplace_state(s1).params,
                       u1.params, g_card)
    split = sorted(k for k, p in sstate.placements.items()
                   if "model" in p.spec)
    rec = {"mesh": mesh.shape, "physical_devices": mesh.physical_devices,
           "model_split_tensors": len(split), "loss": float(sloss),
           "loss_unsharded": float(loss_card),
           "loss_rel_err": abs(float(sloss) / float(loss_card) - 1),
           "grad_max_abs_err": err, "step_loss": float(l1),
           "step_loss_unsharded": float(lu),
           "params_after_step_max_abs_err": gate[0],
           "params_after_step_err_where_grad_gt_1e-6": gate[1]}
    log(f"train-sharded-vs-unsharded-small {json.dumps(rec)}")
    if excess > 0 or rec["loss_rel_err"] > SHARD_LOSS_RTOL or not split:
        raise AssertionError(f"sharded step differs from the unsharded "
                             f"step: {rec}")
    return rec


def training_batch(root: str, gt: np.ndarray):
    """Two P18_CROP crops of phase 4's boundary map (standardized per
    crop) and the 12 DEFAULT_OFFSETS affinities of their ground truth,
    channels first on the card."""
    import torch

    from cluster_tools_tpu_torch.models.unet import DEFAULT_OFFSETS
    from cluster_tools_tpu_torch.workflows.affinities import \
        compute_affinities

    main = os.path.join(root, "main", "data.n5")
    xs, ys = [], []
    for z, yy, xx in P18_CORNERS:
        bb = tuple(slice(o, o + s) for o, s in zip((z, yy, xx), P18_CROP))
        raw = torch.from_numpy(read_dataset(main, "bmap", bb).astype(
            "float32"))
        xs.append(((raw - raw.mean()) / raw.std(correction=0))[None])
        ys.append(torch.from_numpy(compute_affinities(
            gt[bb], DEFAULT_OFFSETS, device="cuda")))
    return torch.stack(xs).cuda(), torch.stack(ys).cuda()


def _gn_share(prof):
    """GroupNorm's share of a profiled step's device time: the inclusive
    device time of ``aten::native_group_norm`` and its backward over the
    sum of every kernel's time; and the top kernels."""
    from torch.autograd import DeviceType

    rows = prof.key_averages()
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA]
    total = sum(e.device_time_total for e in kernels) or 1.0
    ops = {e.key: e.device_time_total for e in rows
           if e.key in ("aten::native_group_norm",
                        "aten::native_group_norm_backward")}
    named = sum(e.device_time_total for e in kernels
                if any(s in e.key for s in (
                    "GroupNorm", "RowwiseMoments", "ComputeFusedParams",
                    "ComputeInternalGradients",
                    "ComputeBackwardFusedParams", "GammaBeta")))
    top = [{"kernel": e.key[:70], "calls": e.count,
            "ms": e.device_time_total / 1e3,
            "share": e.device_time_total / total}
           for e in sorted(kernels, key=lambda e: -e.device_time_total)[:8]]
    # which operator (and input shapes) spends the device time
    ops_by_shape = [e for e in prof.key_averages(group_by_input_shape=True)
                    if e.device_type != DeviceType.CUDA
                    and e.key.startswith("aten::")
                    and e.key not in ("aten::convolution",
                                      "aten::_convolution")]
    top_ops = [{"op": e.key, "shapes": str(e.input_shapes)[:120],
                "calls": e.count, "ms": e.device_time_total / 1e3,
                "share": e.device_time_total / total}
               for e in sorted(ops_by_shape,
                               key=lambda e: -e.device_time_total)[:6]]
    return {"device_ms": total / 1e3, "top_ops": top_ops,
            "group_norm_fwd_ms": ops.get("aten::native_group_norm", 0) / 1e3,
            "group_norm_bwd_ms": ops.get("aten::native_group_norm_backward",
                                         0) / 1e3,
            "group_norm_share": sum(ops.values()) / total,
            "group_norm_kernels_share_by_name": named / total,
            "top": top}


def _timed_steps(step, state, x, y, n):
    """n steps; the losses (as floats) and each step's CUDA-event ms."""
    import torch

    losses, ms, states = [], [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = step(state, x, y)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(loss))
        states.append(state)
    return losses, ms, states


def train_full(root: str, gt: np.ndarray):
    """Phase 18b: ``create_unet()`` (features (16, 32, 64, 128), 12
    outputs, anisotropic, bfloat16 compute) trained P18_STEPS steps on a
    batch of two P18_CROP crops of phase 4's volume: the loss falls, ms
    per step after the first, peak memory, the profile of one step; then
    P18_SHARDED_STEPS steps of ``shard_train_step`` over 8 shards on the
    card from the same start, the losses within SHARD_BF16_RTOL of the
    unsharded ones.  Returns the sharded states and the batch for 18c."""
    import torch

    from cluster_tools_tpu_torch.models import train as T
    from cluster_tools_tpu_torch.models.unet import create_unet

    x, y = training_batch(root, gt)
    model = create_unet()
    start = T.init_state(model, tuple(x.shape),
                         generator=torch.Generator().manual_seed(0),
                         device=str(x.device))
    n_params = sum(v.numel() for v in start.params.values())
    step = T.make_train_step(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, states = _timed_steps(step, start, x, y, P18_STEPS)
    peak = torch.cuda.max_memory_allocated()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA],
            record_shapes=True) as prof:
        step(states[-1], x, y)
        torch.cuda.synchronize()
    prof_rec = _gn_share(prof)
    del states, prof
    rec = {"batch": list(x.shape), "params": n_params, "losses": losses,
           "ms_per_step": float(np.median(ms[1:])), "ms_steps": ms,
           "first_step_ms": ms[0], "peak_device_bytes": peak,
           "profile": prof_rec}
    log(f"train-full {json.dumps(rec)}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"full-width training did not learn: {losses}")
    mesh = _mesh8()
    sstep, sstate, _ = T.shard_train_step(model, start, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    slosses, sms, sstates = _timed_steps(sstep, sstate, x, y,
                                         P18_SHARDED_STEPS)
    speak = torch.cuda.max_memory_allocated()
    rel = [abs(a / b - 1) for a, b in zip(slosses, losses)]
    srec = {"mesh": mesh.shape, "physical_devices": mesh.physical_devices,
            "losses": slosses, "unsharded_losses": losses[:len(slosses)],
            "loss_rel_err": rel, "rtol": SHARD_BF16_RTOL,
            "ms_per_step": float(np.median(sms[1:])), "ms_steps": sms,
            "peak_device_bytes": speak}
    log(f"train-full-sharded {json.dumps(srec)}")
    if max(rel) > SHARD_BF16_RTOL:
        raise AssertionError(f"sharded full-width losses differ: {srec}")
    return {"model": model, "step": sstep, "start": sstate,
            "after_1": sstates[0], "loss_2": slosses[1], "x": x, "y": y,
            "unsharded": rec, "sharded": srec}


def train_state_round_trip(root: str, run):
    """Phase 18c: the sharded full-width state after step 1 saved and
    restored onto its placements: params and both moments bitwise, the
    step and count equal; the next step from the restored state gives
    18b's second loss within RESTORE_RTOL."""
    import torch

    from cluster_tools_tpu_torch.models.checkpoint import (
        restore_train_state, save_train_state)

    path = os.path.join(root, "train_state")
    s1 = run["after_1"]
    t0 = time.perf_counter()
    save_train_state(path, s1)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = restore_train_state(path, run["start"])
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same = all(torch.equal(a, b)
               for tree_a, tree_b in ((s1.params, back.params),
                                      (s1.opt_state.mu, back.opt_state.mu),
                                      (s1.opt_state.nu, back.opt_state.nu))
               for k in tree_a for a, b in zip(tree_a[k], tree_b[k]))
    _, loss = run["step"](back, run["x"], run["y"])
    rec = {"bitwise": same, "step": back.step, "count":
           back.opt_state.count, "loss_after_restore": float(loss),
           "loss_without": run["loss_2"], "rel_err":
           abs(float(loss) / run["loss_2"] - 1), "save_s": save_s,
           "restore_s": restore_s, "bytes": sum(
               os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))}
    log(f"train-state-round-trip {json.dumps(rec)}")
    if not same or back.step != s1.step or \
            back.opt_state.count != s1.opt_state.count or \
            rec["rel_err"] > RESTORE_RTOL:
        raise AssertionError(f"train-state round trip: {rec}")
    return rec


def _check(name, got, want, rtol, atol, ms, dense_ms, **extra):
    import torch

    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ok = torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
    rec = {"name": name, "ms": ms, "dense_ms": dense_ms,
           "max_abs_err": err, "rtol": rtol, "atol": atol, **extra}
    log(f"primitive {json.dumps(rec)}")
    if not ok or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name} differs from its dense version: "
                             f"{rec}")
    return rec


def primitives_card():
    """Phase 18d: ``pipeline_apply`` (4 stages of tanh(a @ W + b)),
    ``moe_apply`` (4 experts of x @ W, the default capacity and a quarter
    of it) and ``ring_attention`` (float32 and bfloat16, causal and not)
    over P18_SHARDS shards on the card, each against its dense version on
    the card and timed beside it."""
    import torch

    from cluster_tools_tpu_torch.parallel import (experts, make_expert_mesh,
                                                  make_pipe_mesh,
                                                  make_seq_mesh, moe_apply,
                                                  pipeline_apply,
                                                  ring_attention,
                                                  stack_stage_params)
    from cluster_tools_tpu_torch.parallel.mesh import shard_devices

    devs = shard_devices("cuda", P18_SHARDS)
    g = torch.Generator(device="cuda").manual_seed(18)
    recs = []

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    per = [{"w": randn(PIPE_D, PIPE_D, scale=PIPE_D ** -0.5),
            "b": randn(PIPE_D, scale=0.1)} for _ in range(P18_SHARDS)]
    params = stack_stage_params(per)
    x = randn(PIPE_MICRO, PIPE_ROWS, PIPE_D)
    mesh = make_pipe_mesh(P18_SHARDS, devices=devs)

    def layer(p, a):
        return torch.tanh(a @ p["w"] + p["b"])

    def dense_pipe():
        a = x
        for p in per:
            a = layer(p, a)
        return a

    def pipe():
        return pipeline_apply(layer, params, x, mesh)

    recs.append(_check("pipeline_apply", pipe(), dense_pipe(), PRIM_RTOL,
                       PRIM_ATOL, _time_ms(pipe, 3, 1),
                       _time_ms(dense_pipe, 3, 1),
                       stages=P18_SHARDS, microbatches=PIPE_MICRO))
    tokens = randn(MOE_TOKENS, MOE_D)
    logits = randn(MOE_TOKENS, P18_SHARDS)
    w = randn(P18_SHARDS, MOE_D, MOE_D, scale=MOE_D ** -0.5)
    emesh = make_expert_mesh(P18_SHARDS, devices=devs)
    t_local = MOE_TOKENS // P18_SHARDS
    default_cap = -(-t_local // P18_SHARDS)
    for cap in (default_cap, default_cap // 4):
        def moe(cap=cap):
            return moe_apply(lambda p, a: a @ p["w"], {"w": w}, logits,
                             tokens, emesh, capacity=cap)

        def dense(cap=cap):
            out = tokens.clone()
            for j in range(P18_SHARDS):
                sl = slice(j * t_local, (j + 1) * t_local)
                choice, _, keep, gate = experts.route(logits[sl], cap)
                xl = tokens[sl]
                for e in range(P18_SHARDS):
                    rows = (choice == e) & keep
                    gl = gate[rows][:, None]
                    out[sl][rows] = gl * (xl[rows] @ w[e]) \
                        + (1.0 - gl) * xl[rows]
            return out

        kept = sum(int(experts.route(logits[j * t_local:(j + 1) * t_local],
                                     cap)[2].sum())
                   for j in range(P18_SHARDS))
        recs.append(_check(f"moe_apply cap {cap}", moe(), dense(),
                           PRIM_RTOL, PRIM_ATOL, _time_ms(moe, 3, 1),
                           _time_ms(dense, 3, 1), capacity=cap,
                           tokens=MOE_TOKENS, routed=kept,
                           overflow=MOE_TOKENS - kept))
    smesh = make_seq_mesh(P18_SHARDS, devices=devs)
    for dtype, atol in ((torch.float32, PRIM_ATOL),
                        (torch.bfloat16, RING_BF16_ATOL)):
        q, k, v = (randn(RING_T, RING_H, RING_D).to(dtype)
                   for _ in range(3))
        for causal in (False, True):
            def ring(causal=causal, q=q, k=k, v=v):
                return ring_attention(q, k, v, smesh, causal=causal)

            def dense(causal=causal, q=q, k=k, v=v):
                s = torch.einsum("thd,shd->hts", q.float(), k.float()) \
                    / float(np.sqrt(RING_D))
                if causal:
                    tri = torch.ones(RING_T, RING_T, dtype=torch.bool,
                                     device="cuda").tril()
                    s = s.masked_fill(~tri[None], float("-inf"))
                return torch.einsum("hts,shd->thd", torch.softmax(s, -1),
                                    v.float()).to(dtype)

            recs.append(_check(
                f"ring_attention {str(dtype)[6:]} "
                f"{'causal' if causal else 'full'}", ring(), dense(),
                PRIM_RTOL if dtype == torch.float32 else 1e-2, atol,
                _time_ms(ring, 3, 1), _time_ms(dense, 3, 1),
                T=RING_T, H=RING_H, D=RING_D))
    return recs


def orbax_restore_path(repo: str, device: str = "cuda"):
    """Phase 18e: each fixture of TRAIN_STATES_DIR (the JAX package's
    orbax ``save_train_state`` after one JAX step, unsharded and from its
    8-device mesh) restored by the port's ``restore_train_state`` onto
    ``device``, whole and onto 18a's (2, 2, 2) mesh of 8 shards, every
    tensor on ``device`` and bitwise equal to the restore onto the CPU;
    one step from each restored state on the batch the fixture records:
    the float32 loss within SHARD_LOSS_RTOL of the JAX package's float32
    loss, the bfloat16 loss within SHARD_BF16_RTOL of the JAX package's
    own.  Expected under 10 s on the card."""
    import torch

    from cluster_tools_tpu_torch.models import train as T
    from cluster_tools_tpu_torch.models.checkpoint import \
        restore_train_state
    from cluster_tools_tpu_torch.models.unet import create_unet
    from cluster_tools_tpu_torch.parallel import mesh as pm

    recs = []
    for name in ("unsharded", "sharded"):
        path = os.path.join(repo, TRAIN_STATES_DIR, name)
        with open(path + ".json") as f:
            meta = json.load(f)
        b, d, h, w = meta["batch"]["shape"]
        x = np.random.RandomState(meta["batch"]["x_seed"]).rand(
            b, d, h, w, 1).astype("float32")
        y = (np.random.RandomState(meta["batch"]["y_seed"]).rand(
            b, d, h, w, 3) > 0.5).astype("float32")
        x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
        y = torch.from_numpy(np.ascontiguousarray(np.moveaxis(y, -1, 1)))
        cpu = None
        for layout in ("whole", "mesh8"):
            for dtype, key, rtol in (
                    (torch.float32, "next_loss_float32", SHARD_LOSS_RTOL),
                    (torch.bfloat16, "next_loss", SHARD_BF16_RTOL)):
                model = create_unet(**meta["model"], dtype=dtype)
                abstract = T.init_state(model, (1, 1, d, h, w),
                                        device=device)
                if layout == "mesh8":
                    _, abstract, pl = T.shard_train_step(
                        model, abstract, _mesh8(device))
                t0 = time.perf_counter()
                state = restore_train_state(path, abstract)
                if device == "cuda":
                    torch.cuda.synchronize()
                restore_s = time.perf_counter() - t0
                whole = T.unplace_state(state, torch.device("cpu"))
                if cpu is None:
                    cpu = restore_train_state(path, T.init_state(
                        model, (1, 1, d, h, w), device="cpu"))
                tensors = [t for tree in (state.params, state.opt_state.mu,
                                          state.opt_state.nu)
                           for v in tree.values()
                           for t in (v if state.sharded else [v])]
                on_device = all(t.device.type == device for t in tensors)
                same = all(torch.equal(a[k].cpu(), b_[k]) for a, b_ in (
                    (whole.params, cpu.params),
                    (whole.opt_state.mu, cpu.opt_state.mu),
                    (whole.opt_state.nu, cpu.opt_state.nu)) for k in b_)
                t0 = time.perf_counter()
                if layout == "mesh8":
                    s2, loss = T.make_sharded_step(model)(
                        state, pm.shard(x.to(device), state.mesh, pl),
                        pm.shard(y.to(device), state.mesh, pl))
                else:
                    s2, loss = T.make_train_step(model)(
                        state, x.to(device), y.to(device))
                loss = float(loss)
                step_s = time.perf_counter() - t0
                rec = {"fixture": name, "layout": layout,
                       "dtype": str(dtype).split(".")[-1],
                       "shards": len(tensors) // (3 * len(state.params)),
                       "on_device": on_device, "equal_to_cpu_restore": same,
                       "step": s2.step, "count": s2.opt_state.count,
                       "loss": loss, "jax_loss": meta[key],
                       "rel_err": abs(loss / meta[key] - 1), "rtol": rtol,
                       "restore_s": restore_s, "step_s": step_s}
                log(f"orbax-restore {json.dumps(rec)}")
                if not (on_device and same and s2.step == 2 and
                        s2.opt_state.count == 2 and np.isfinite(loss)) \
                        or rec["rel_err"] > rtol:
                    raise AssertionError(f"18e: the JAX package's train "
                                         f"state {name}: {rec}")
                recs.append(rec)
    return recs


def training_paths(root: str, gt: np.ndarray, repo: str):
    """Phase 18: training and the parallel primitives on the card (no
    kernel of the port lies on them)."""
    log(f"phase 18: training ({P18_MESH} shards on 1 card for the "
        f"sharded step) and the primitives ({P18_SHARDS} shards)")
    _phase("18a", train_card_vs_cpu)
    run = _phase("18b", train_full, root, gt)
    _phase("18c", train_state_round_trip, root, run)
    del run
    _phase("18d", primitives_card)
    _phase("18e", orbax_restore_path, repo)


def _phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {name} elapsed_s {time.perf_counter() - t0}")
    return out


def main() -> int:
    started = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        from cluster_tools_tpu_torch import kernels
    except ImportError:
        print("chip_smoke: run from a checkout of the repository "
              "(cluster_tools_tpu_torch not found)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    info = gpu_info()
    log(info)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"build_s {build_all()}")

    # the main path's EDT runs on the outer block (58, 576, 576)
    outer = [b + 2 * h for b, h in zip(BLOCK, (4, 32, 32))]
    timed, max_err = kernel_vs_plain(outer)

    # scratch space inside the checkout (listed in .gitignore)
    root = os.path.join(repo, "_smoke_work")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    phase = _phase

    try:
        from cluster_tools_tpu_torch.utils.synthetic import (
            as_uint8, synthetic_instance)

        phase("3", card_vs_cpu, root, SMALL_SHAPE, SMALL_BLOCK)
        record, gt = phase("4", main_path, root, FULL_SHAPE, BLOCK)
        phase("5", split_card_vs_cpu, root, SMALL_SHAPE, SMALL_BLOCK)
        split = phase("6", split_path, root, FULL_SHAPE, BLOCK, gt)
        ckpt = make_checkpoint(root)
        raw = as_uint8(synthetic_instance(INF_SHAPE, seed=3)[1])
        phase("7a", unet_card_vs_cpu, ckpt, raw)
        inf_store, _ = phase("7b", inference_card_vs_cpu, root, ckpt, raw)
        phase("7c", mws_card_vs_cpu, root)
        phase("7d", config5_chain, root, inf_store, ckpt)
        phase("8a", inference_path, root, ckpt)
        phase("8b", mws_path, root, gt)
        # phases 9-10 lie on no kernel of the port
        kernels.reset_counts()
        small = blob_volume(SMALL_SHAPE, seed=1)
        phase("9a", ops_card_vs_cpu, small)
        phase("9b", cc_card_vs_cpu, root, small, SMALL_SHAPE, SMALL_BLOCK)
        gt_small, bnd_small = synthetic_instance(SMALL_SHAPE, seed=2)
        phase("9c", stitch_eval_card_vs_cpu, root, gt_small, bnd_small,
              SMALL_BLOCK)
        phase("10a", cc_path, root)
        phase("10b", eval_path, root, gt, split["quality"])
        phase("10c", stitch_path, root, gt)
        late = kernels.counts()
        log(f"phases 9-10 kernel launches {json.dumps(late)}")
        if late["minplus"] != 0:
            raise AssertionError("phases 9-10 launched the min-plus kernel")
        # phases 11-12: the fused task's other executions, the split
        # watershed's options, the lifted and agglomerative segmentations
        gt11, bnd11 = synthetic_instance(P11_SHAPE, seed=1)
        data11 = as_uint8(bnd11)
        phase("11a", variants_card_vs_cpu, root, data11, P11_BLOCK)
        phase("11b", ws_options_card_vs_cpu, root, data11, gt11,
              as_uint8(synthetic_instance(FLOOD_SHAPE, seed=4)[1]))
        phase("11c", lifted_agglo_card_vs_cpu, root, data11, gt11)
        crop_store, gt_crop = write_crop(root, BLOCK, gt)
        # the fused chain's other executions and the watershed's options
        # on the crop's first block (PERF.md section 4: cut for the time
        # limit when phase 17 came)
        crop1_store, gt_crop1 = write_crop(root, BLOCK, gt, CROP1, "crop1")
        variant_launches = phase("12a", variants_path, root, crop1_store,
                                 BLOCK, gt_crop1)
        crop_launches = phase("12bc", crop_paths, root, crop_store, BLOCK,
                              gt_crop, crop1_store, gt_crop1)
        # phase 13: serving on the card, then the edit lane beside it
        serve_launches = {"13a": phase("13a", serve_card_vs_cpu)}
        crops, crop_gts = serve_crops(root, gt, SERVE_LOAD["n_requests"])
        serve_launches["13b"], serve_err, serve_pipe = phase(
            "13b", serve_path, root, crops, crop_gts)
        max_err = max(max_err, serve_err)
        serve_launches["13c"] = phase("13c", edit_lane, root, crop_store,
                                      serve_pipe, crops)
        # phase 14: filter banks and the workflows that use them
        fit_timed, fit_err = phase("14-kernel", fit_kernel_vs_plain, outer)
        max_err = max(max_err, fit_err)
        gt14, bnd14 = synthetic_instance(P14_SHAPE, seed=5)
        data14 = as_uint8(bnd14)
        phase("14a-ops", filter_ops_card_vs_cpu, data14, gt14)
        filter_launches = {"14a": phase("14a", filter_workflows_card_vs_cpu,
                                        root, data14, gt14)}
        filter_launches.update({
            f"14b-{k}": v for k, v in phase(
                "14b", crop_filter_paths, root, crop_store, BLOCK,
                gt_crop).items()})
        phase("14c", pyramid_path, root)
        # phase 15: the tools run after a segmentation, masking,
        # decomposition, debugging and the sweep ops lie on no kernel of
        # the port
        kernels.reset_counts()
        gt15, bnd15 = synthetic_instance(P15_SHAPE, seed=6)
        phase("15a", sweep_card_vs_cpu, root, gt15, bnd15)
        phase("15b", sweep_full, root)
        phase("15c", crop_post_workflows, root, crop_store, gt_crop)
        # the conversion of phase 12's crop of phase 4's fragments with
        # phase 13c's (edited) multicut table: on the whole volume the
        # script passed 950 s (PERF.md section 4)
        phase("15d", paintera_path, root, crop_store, "frags",
              os.path.join(root, "edits", "tmp", "multicut_assignments.npy"))
        late = kernels.counts()
        log(f"phase 15 kernel launches {json.dumps(late)}")
        if late["minplus"] != 0:
            raise AssertionError("phase 15 launched the min-plus kernel")
        # phase 16: the port's own storage formats and the carving export
        h5_launches = phase("16a", h5_fused_path, root, crop_store)
        kernels.reset_counts()
        phase("16b", blosc_path, root, crop_store)
        phase("16c", carving_path, root, crop_store)
        phase("16d", knossos_path, root, crop_store)
        if kernels.counts()["minplus"] != 0:
            raise AssertionError("phases 16b-d launched the min-plus kernel")
        formats_launches, _ = phase("16e", formats_path, root, repo)
        # phase 17: the multi-device paths, 4 shards on the one card
        mesh_launches = mesh_paths(root, BLOCK, gt, record["quality"],
                                   crop_store, ckpt)
        # phase 18: training and the parallel primitives lie on no kernel
        # of the port
        kernels.reset_counts()
        training_paths(root, gt, repo)
        if kernels.counts()["minplus"] != 0:
            raise AssertionError("phase 18 launched the min-plus kernel")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    k = kernels.KERNELS["minplus"]
    by_phase = {"4": record["launches"][k.name],
                "6": split["launches"][k.name],
                **{f"12a-{m}": n for m, n in variant_launches.items()},
                **{f"12b-{m}": n for m, n in crop_launches.items()},
                **serve_launches, **filter_launches, "15": late["minplus"],
                "16a": h5_launches, "16e": formats_launches,
                **mesh_launches}
    line = {"kernels": [{
        "name": k.name, "route": k.route, "source": k.source,
        "replaces": k.replaces,
        # the main paths' runs: the fused chain, the split chain, the fused
        # chain's hybrid and legacy executions, the watershed's options,
        # the ROI pipeline card against CPU and on the resident server, the
        # filter-bank chain and the object fit, the fused chain on HDF5 and
        # on the other tools' formats, the mesh program, the mesh-resident chain and the mesh rounds
        "launches": sum(by_phase.values()),
        "launches_by_phase": by_phase,
        "max_abs_err": max_err,
        # one EDT of the main path: the three axis products of a block
        "ms": sum(r["ms"] for r in timed),
        "plain_ms": sum(r["plain_ms"] for r in timed),
        "bound_ms": sum(r["bound_ms"] for r in timed),
        "bound_by": "bytes", "library_ms": None}]}
    log("kernel-timed fit outer block " + json.dumps({
        "shape": fit_timed[0]["shape"],
        "ms": sum(r["ms"] for r in fit_timed),
        "plain_ms": sum(r["plain_ms"] for r in fit_timed),
        "bound_ms": sum(r["bound_ms"] for r in fit_timed)}))
    log(f"script elapsed_s {time.perf_counter() - started}")
    log(info)
    log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
