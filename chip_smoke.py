#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernel and C++ solvers from the checkout's
sources, then runs six phases, each of which must pass:

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
   per block the watershed redid after a capacity overflow).

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
SMALL_SHAPE = (64, 256, 256)
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


def kernel_vs_plain(outer, device="cuda"):
    """The CUDA min-plus kernel against its plain PyTorch version on the
    card: bitwise at unit spacing, rtol 1e-6 at other spacings.  Timed
    (median of CUDA-event timings) in place along each axis of one outer
    block of the main path, on the inputs its EDT gives each axis, and as
    the whole EDT of the block (three launches: the first reads the mask,
    the last writes the sqrt)."""
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
    from cluster_tools_tpu_torch.core.storage import file_reader

    with file_reader(path) as f:
        ds = f.require_dataset("bmap", shape=data.shape, chunks=block,
                               dtype=data.dtype)
        ds[:] = data


def _build(wf, tmp: str, store: str, ws_key: str, seg_key: str,
           device: str):
    """Build ``wf`` timed; returns (wall s, fragments, segmentation,
    status JSONs by task)."""
    import torch

    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.storage import file_reader

    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctp.build([wf], raise_on_failure=True)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with file_reader(store, "r") as f:
        ws, seg = f[ws_key][:], f[seg_key][:]
    status = {}
    for name in sorted(os.listdir(tmp)):
        if name.endswith(".status"):
            with open(os.path.join(tmp, name)) as fh:
                st = json.load(fh)
            status[st.get("task", name)] = st
    return wall, ws, seg, status


def run_workflow(workdir: str, store: str, block, device: str):
    """``MulticutSegmentationWorkflow(fused=True, target="gpu")`` with the
    default fused task config on ``device``; returns (wall s, fragments,
    segmentation, status JSONs by task)."""
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir

    cfg_dir = os.path.join(workdir, "configs")
    ConfigDir(cfg_dir).write_global_config({"block_shape": list(block),
                                            "device": device})
    tmp = os.path.join(workdir, "tmp")
    wf = ctp.MulticutSegmentationWorkflow(
        input_path=store, input_key="bmap", ws_path=store, ws_key="ws",
        problem_path=os.path.join(workdir, "problem.n5"), output_path=store,
        output_key="seg", tmp_folder=tmp, config_dir=cfg_dir,
        max_jobs=os.cpu_count() or 1, target="gpu", n_scales=1, fused=True)
    return _build(wf, tmp, store, "ws", "seg", device)


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


def scores(seg: np.ndarray, gt: np.ndarray):
    from cluster_tools_tpu_torch.utils.validation import (
        ContingencyTable, cremi_score_from_table)

    table = ContingencyTable.from_arrays_chunked(gt, seg)
    vis, vim, are, cs = cremi_score_from_table(table)
    return {"voi_split": vis, "voi_merge": vim, "rand_error": are,
            "cremi": cs}


def voi(a: np.ndarray, b: np.ndarray) -> float:
    from cluster_tools_tpu_torch.utils.validation import (
        ContingencyTable, compute_vi_scores)

    return float(sum(compute_vi_scores(
        ContingencyTable.from_arrays_chunked(b, a))))


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


def same_partition(store: str, key_a: str, key_b: str) -> bool:
    """True when two fragment volumes of ``store`` describe the same
    partition: the voxelwise id maps a -> b and b -> a are both functions
    (checked in z-slabs)."""
    from cluster_tools_tpu_torch.core.storage import file_reader

    with file_reader(store, "r") as f:
        da, db = f[key_a], f[key_b]
        n = da.shape[0]
        slabs = [(z, min(z + 25, n)) for z in range(0, n, 25)]
        max_a = max_b = 0
        for z0, z1 in slabs:
            max_a = max(max_a, int(da[z0:z1].max()))
            max_b = max(max_b, int(db[z0:z1].max()))
        ab = np.full(max_a + 1, -1, "int64")
        ba = np.full(max_b + 1, -1, "int64")
        for z0, z1 in slabs:
            a = da[z0:z1].ravel().astype("int64")
            b = db[z0:z1].ravel().astype("int64")
            for lut, x, y in ((ab, a, b), (ba, b, a)):
                new = lut[x] < 0
                lut[x[new]] = y[new]
                if (lut[x] != y).any():
                    return False
    return True


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
    same = same_partition(store, "ws_split", "ws")
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


def main() -> int:
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
    try:
        card_vs_cpu(root, SMALL_SHAPE, SMALL_BLOCK)
        record, gt = main_path(root, FULL_SHAPE, BLOCK)
        split_card_vs_cpu(root, SMALL_SHAPE, SMALL_BLOCK)
        split = split_path(root, FULL_SHAPE, BLOCK, gt)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    k = kernels.KERNELS["minplus"]
    line = {"kernels": [{
        "name": k.name, "route": k.route, "source": k.source,
        "replaces": k.replaces,
        # the main paths' runs: the fused chain and the split chain
        "launches": record["launches"][k.name] + split["launches"][k.name],
        "max_abs_err": max_err,
        # one EDT of the main path: the three axis products of a block
        "ms": sum(r["ms"] for r in timed),
        "plain_ms": sum(r["plain_ms"] for r in timed),
        "bound_ms": sum(r["bound_ms"] for r in timed),
        "bound_by": "bytes", "library_ms": None}]}
    log(info)
    log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
