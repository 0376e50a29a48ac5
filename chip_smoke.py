#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernel and C++ solvers from the checkout's
sources, holds the min-plus EDT kernel against its plain PyTorch version
at the shapes of the main path, runs the fused multicut chain on a small
volume on the card and on the CPU and compares them, then drives the main
path — ``MulticutSegmentationWorkflow(fused=True, target="gpu")`` on one
CREMI-sample-sized synthetic volume, ``(125, 1250, 1250)`` uint8, blocks
``[50, 512, 512]`` — and checks the segmentation against the generator's
ground truth.  Every phase must pass; the last stdout line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
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
#: H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM
PEAK_FP32_OPS = 67e12
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


def minplus_bound_ms(m: int, n: int) -> float:
    """Least time of one min-plus product on the card: 2*m*n^2 fp32
    operations (add, min) against the fp32 peak, or 8*m*n bytes against
    HBM, whichever is larger."""
    return max(2.0 * m * n * n / PEAK_FP32_OPS,
               8.0 * m * n / PEAK_BYTES) * 1e3


def kernel_vs_plain(main_shapes, device="cuda"):
    """The CUDA min-plus kernel against its plain PyTorch version on the
    card.  Bitwise at unit spacing, rtol 1e-6 at anisotropic spacing;
    timed (median of CUDA-event timings) at the main path's shapes."""
    import torch

    from cluster_tools_tpu_torch.ops.edt import minplus_cuda, minplus_plain

    rows = []
    max_err = 0.0
    checks = [(name, m, n, 1.0, True) for name, (m, n) in main_shapes]
    checks += [("ragged n=37", 1000, 37, 1.0, False),
               ("ragged n=130", 777, 130, 1.0, False),
               ("ragged m", 12345, 100, 1.0, False),
               ("anisotropic s=0.7", 5000, 200, 0.7, False)]
    for i, (name, m, n, s, timed) in enumerate(checks):
        f = _scanlines(m, n, seed=i, device=device)
        got = minplus_cuda(f, s)
        want = minplus_plain(f, s)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        if s == 1.0:
            if not torch.equal(got, want):
                raise AssertionError(f"{name} {m}x{n}: kernel != plain "
                                     f"(max abs err {err})")
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
        row = {"name": name, "m": m, "n": n, "spacing": s,
               "bitwise": bool(torch.equal(got, want)), "max_abs_err": err}
        if timed:
            row["ms"] = _time_ms(lambda: minplus_cuda(f, s), reps=20)
            row["plain_ms"] = _time_ms(lambda: minplus_plain(f, s), reps=3,
                                       warmup=1)
            row["bound_ms"] = minplus_bound_ms(m, n)
        rows.append(row)
        log(f"kernel-vs-plain {json.dumps(row)}")
    return rows, max_err


# ---------------------------------------------------------------------------
# phases 3 and 4: the workflow
# ---------------------------------------------------------------------------

def write_volume(path: str, data: np.ndarray, block) -> None:
    from cluster_tools_tpu_torch.core.storage import file_reader

    with file_reader(path) as f:
        ds = f.require_dataset("bmap", shape=data.shape, chunks=block,
                               dtype=data.dtype)
        ds[:] = data


def run_workflow(workdir: str, store: str, block, device: str):
    """``MulticutSegmentationWorkflow(fused=True, target="gpu")`` with the
    default fused task config on ``device``; returns (wall s, fragments,
    segmentation, status JSONs by task)."""
    import torch

    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir
    from cluster_tools_tpu_torch.core.storage import file_reader

    cfg_dir = os.path.join(workdir, "configs")
    ConfigDir(cfg_dir).write_global_config({"block_shape": list(block),
                                            "device": device})
    tmp = os.path.join(workdir, "tmp")
    wf = ctp.MulticutSegmentationWorkflow(
        input_path=store, input_key="bmap", ws_path=store, ws_key="ws",
        problem_path=os.path.join(workdir, "problem.n5"), output_path=store,
        output_key="seg", tmp_folder=tmp, config_dir=cfg_dir,
        max_jobs=os.cpu_count() or 1, target="gpu", n_scales=1, fused=True)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctp.build([wf], raise_on_failure=True)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with file_reader(store, "r") as f:
        ws, seg = f["ws"][:], f["seg"][:]
    status = {}
    for name in sorted(os.listdir(tmp)):
        if name.endswith(".status"):
            with open(os.path.join(tmp, name)) as fh:
                st = json.load(fh)
            status[st.get("task", name)] = st
    return wall, ws, seg, status


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


def main_path(root: str, shape, block):
    """The main path at full block width; returns the run's record."""
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
            "peak_device_bytes": peak, "quality": sc}


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

    # the main path's min-plus shapes: the outer block (58, 576, 576) is
    # one scanline set per axis, z then y then x
    outer = [b + 2 * h for b, h in zip(BLOCK, (4, 32, 32))]
    nz, ny, nx = outer
    main_shapes = [("z", (ny * nx, nz)), ("y", (nz * nx, ny)),
                   ("x", (nz * ny, nx))]
    rows, max_err = kernel_vs_plain(main_shapes)

    # scratch space inside the checkout (listed in .gitignore)
    root = os.path.join(repo, "_smoke_work")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        card_vs_cpu(root, SMALL_SHAPE, SMALL_BLOCK)
        record = main_path(root, FULL_SHAPE, BLOCK)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    timed = [r for r in rows if "ms" in r]
    k = kernels.KERNELS["minplus"]
    line = {"kernels": [{
        "name": k.name, "route": k.route, "source": k.source,
        "replaces": k.replaces, "launches": record["launches"][k.name],
        "max_abs_err": max_err,
        # one EDT of the main path: the three axis products of a block
        "ms": sum(r["ms"] for r in timed),
        "plain_ms": sum(r["plain_ms"] for r in timed),
        "bound_ms": sum(r["bound_ms"] for r in timed),
        "bound_by": "operations", "library_ms": None}]}
    log(info)
    log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
