"""Driver of the fused multicut chain: ``MulticutSegmentationWorkflow(
fused=True, target="gpu", n_scales=1)`` store to store on one volume, as
back-to-back jobs.

Set-up makes the uint8 boundary volume on the device from the seed, writes
it as an N5 gzip store, and runs one job on the cell's warm-up volume (the
first ``warmup_depth`` planes), which builds the CUDA kernel and the C++
solvers into the port's build folder on a checkout's first run.  The
window runs whole-volume jobs, each into a store of its own, until
``--seconds`` have passed; the last job runs to its end.
``volume_mvox_per_s`` is every finished volume's voxels over the time from
the first job's start to the last job's end.  The traced run profiles one
job with the port's telemetry on.

After the window the outputs are read back from the stores and judged
against the plain references of ``portbench/refs``: every job's
fragments and segmentation must equal the last job's byte for byte (a
job that differs is judged on its own), and the last job's fragments are
compared block by block with the reference watershed, its graph,
features and costs with the reference's from those fragments, and its
segmentation by the largest merge gain left between two segments and by
its multicut objective against the plain solver's on the same costs.

``controls`` gives the readings that the limits were set from: the
program's, the control's (the reference in bfloat16 in the program's
place) and two planted faults' (every fragment in one segment; the solver
without its node moves).
"""

from __future__ import annotations

import math
import os
import sys
import time
import traceback

import numpy as np

STORE_KEYS = ("ws", "seg")


def _sync(dev: str) -> None:
    import torch

    if dev == "cuda":
        torch.cuda.synchronize()


class _Chain:
    """Builds and runs one job of the chain on a store."""

    def __init__(self, tmp, cfg, traffic, dev, tasks=None):
        from cluster_tools_tpu_torch.core.config import ConfigDir

        self.tmp = tmp
        os.makedirs(tmp, exist_ok=True)
        self.traffic = traffic
        self.dev = dev
        self.cfg_dir = os.path.join(tmp, "configs")
        cd = ConfigDir(self.cfg_dir)
        cd.write_global_config({"block_shape": list(cfg["block_shape"]),
                                "device": dev})
        cd.write_task_config("fused_segmentation",
                             dict(cfg["fused_segmentation"]))
        for name, conf in (tasks or {}).items():
            cd.write_task_config(name, conf)
        self.n = 0

    def job(self, store: str):
        import cluster_tools_tpu_torch as ctp

        root = os.path.join(self.tmp, f"job{self.n}")
        self.n += 1
        out = os.path.join(root, "out.n5")
        wf = ctp.MulticutSegmentationWorkflow(
            input_path=store, input_key="bmap", ws_path=out, ws_key="ws",
            problem_path=os.path.join(root, "problem.n5"),
            output_path=out, output_key="seg",
            tmp_folder=os.path.join(root, "tmp"), config_dir=self.cfg_dir,
            max_jobs=int(self.traffic["max_jobs"]), target="gpu",
            n_scales=1, fused=True)
        _sync(self.dev)
        t0 = time.perf_counter()
        ctp.build([wf], raise_on_failure=True)
        _sync(self.dev)
        return root, t0, time.perf_counter()


def _status(root: str):
    import json

    tmp = os.path.join(root, "tmp")
    out = []
    for name in sorted(os.listdir(tmp)):
        p = os.path.join(tmp, name)
        if name.endswith(".status") and os.path.getsize(p):
            with open(p) as f:
                out.append(json.load(f))
    return out


def _same_outputs(a: str, b: str) -> bool:
    from portbench.refs import n5

    for key in STORE_KEYS:
        pa, pb = os.path.join(a, "out.n5"), os.path.join(b, "out.n5")
        fa, fb = n5.chunk_files(pa, key), n5.chunk_files(pb, key)
        if fa != fb:
            return False
        for f in fa:
            with open(os.path.join(pa, key, f), "rb") as x, \
                    open(os.path.join(pb, key, f), "rb") as y:
                if x.read() != y.read():
                    return False
    return True


def judge(root: str, bmap, cfg, seg=None):
    """The numbers that judge one job's outputs (see the module doc);
    ``seg`` in place of the job's segmentation plants a fault."""
    import torch

    from portbench.refs import fragments, multicut, n5

    dev = bmap.device
    out = os.path.join(root, "out.n5")
    prob = os.path.join(root, "problem.n5")
    ws = torch.from_numpy(n5.read_array(out, "ws").astype("int64")).to(dev)
    block = list(cfg["block_shape"])
    halo = list(cfg["fused_segmentation"]["halo"])
    params = dict(cfg["fused_segmentation"])
    shape = tuple(bmap.shape)
    volp = fragments.padded_volume(bmap, block, halo)
    outer = [b + 2 * h for b, h in zip(block, halo)]
    excess, ids = 0, []
    for bi in np.ndindex(*[-(-s // b) for s, b in zip(shape, block)]):
        begin = [g * b for g, b in zip(bi, block)]
        end = [min(o + b, s) for o, b, s in zip(begin, block, shape)]
        x = volp[tuple(slice(o, o + s) for o, s in zip(begin, outer))]
        ref, ok = fragments.block_fragments(x, params)
        inner = ref[tuple(slice(h, h + e - o) for h, o, e in
                          zip(halo, begin, end))]
        got = ws[tuple(slice(o, e) for o, e in zip(begin, end))]
        excess += fragments.pair_excess(got, inner) + (0 if ok else 1)
        ids.append(torch.unique(got))
        del ref, x
    allids = torch.cat(ids)
    # a fragment id in two blocks
    excess += int(allids.numel() - torch.unique(allids).numel())
    del volp
    if seg is None:
        seg = torch.from_numpy(
            n5.read_array(out, "seg").astype("int64")).to(dev)
    uv = n5.read_array(prob, "s0/graph/edges").astype("int64")
    feats = n5.read_array(prob, "features")
    costs = n5.read_array(prob, "s0/costs")
    res = multicut.check_problem(ws, bmap, seg, uv, feats, costs)
    res["ws_pair_excess"] = float(excess)
    return res


def run(ctx):
    import torch

    t_start = time.perf_counter()
    from cluster_tools_tpu_torch.core import telemetry
    from cluster_tools_tpu_torch.workflows import fused_pipeline

    from portbench.reduce import written_bytes
    from portbench.refs import n5, volume

    cfg, traffic, dev = ctx.config, ctx.workload["traffic"], ctx.device
    shape = tuple(cfg["shape"])
    block = list(cfg["block_shape"])
    io0 = written_bytes()
    split = {"cpu_count": os.cpu_count()}
    t = time.perf_counter()
    _, bmap = volume.synthetic_volume(shape, ctx.seed, dev,
                                      want_labels=False)
    host = bmap.cpu().numpy()
    split["data_s"] = time.perf_counter() - t
    t = time.perf_counter()
    store = os.path.join(ctx.tmp, "input.n5")
    n5.write_array(store, "bmap", host, block)
    warm = os.path.join(ctx.tmp, "warmup.n5")
    n5.write_array(warm, "bmap", host[:int(traffic["warmup_depth"])], block)
    split["store_s"] = time.perf_counter() - t
    chain = _Chain(ctx.tmp, cfg, traffic, dev)
    jobs, failed, trace = [], 0, None
    try:
        t = time.perf_counter()
        chain.job(warm)
        split["warmup_s"] = time.perf_counter() - t
        setup_s = time.perf_counter() - t_start
        if ctx.trace:
            trace = _traced_job(ctx, chain, store, telemetry)
            jobs.append(trace.info.pop("job"))
        else:
            t0 = time.perf_counter()
            while True:
                jobs.append(chain.job(store))
                if time.perf_counter() - t0 >= ctx.seconds:
                    break
    except Exception:  # a failed job fails the run, reported below
        traceback.print_exc(file=sys.stderr)
        failed += 1
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    fused_pipeline.clear_caches()
    if dev == "cuda":
        torch.cuda.empty_cache()
    if trace is not None:
        trace.info["peak_bytes"] = peak

    t = time.perf_counter()
    nums = {}
    try:
        if jobs:
            last = jobs[-1][0]
            nums = judge(last, bmap, cfg)
            for root, _, _ in jobs[:-1]:
                if not _same_outputs(root, last):
                    other = judge(root, bmap, cfg)
                    nums = {k: max(v, other[k]) for k, v in nums.items()}
    except (OSError, KeyError, ValueError):
        # outputs that cannot be read back are wrong outputs: no readings
        traceback.print_exc(file=sys.stderr)
        nums = {}
    split["reference_s"] = time.perf_counter() - t
    split["written"] = {k: v - io0.get(k, 0)
                        for k, v in written_bytes().items()}
    split["task_s"] = [_task_walls(root) for root, _, _ in jobs]
    metrics = {}
    if jobs and not ctx.trace:
        elapsed = jobs[-1][2] - jobs[0][1]
        metrics["volume_mvox_per_s"] = len(jobs) * math.prod(shape) / \
            elapsed / 1e6
        metrics["setup_s"] = setup_s
        split["volumes"] = len(jobs)
        split["window_s"] = elapsed
        split["job_s"] = [b - a for _, a, b in jobs]
    return {"attempted": len(jobs) + failed, "failed": failed,
            "metrics": metrics, "memory_peak_bytes": peak,
            "readings": nums, "trace": trace,
            "info": {"setup_split": split}}


def _task_walls(root: str):
    """Each task's ``wall_time`` in one job's status JSONs, summed by
    task name: where a volume's seconds went."""
    walls = {}
    for st in _status(root):
        name = str(st.get("task", "?"))
        walls[name] = round(walls.get(name, 0.0)
                            + float(st.get("wall_time", 0.0)), 3)
    return walls


def _reference_control(ws, bmap, cfg):
    """The control's readings on one volume: the reference's fragments,
    features and costs in bfloat16, and the plain solver on the bfloat16
    costs with its sums in bfloat16, judged as the program's are."""
    import torch

    from portbench.refs import fragments, multicut

    block = list(cfg["block_shape"])
    halo = list(cfg["fused_segmentation"]["halo"])
    params = dict(cfg["fused_segmentation"])
    shape = tuple(bmap.shape)
    volp = fragments.padded_volume(bmap, block, halo)
    outer = [b + 2 * h for b, h in zip(block, halo)]
    excess = 0
    for bi in np.ndindex(*[-(-s // b) for s, b in zip(shape, block)]):
        begin = [g * b for g, b in zip(bi, block)]
        end = [min(o + b, s) for o, b, s in zip(begin, block, shape)]
        x = volp[tuple(slice(o, o + s) for o, s in zip(begin, outer))]
        sl = tuple(slice(h, h + e - o) for h, o, e in zip(halo, begin, end))
        ref, _ = fragments.block_fragments(x, params)
        low, _ = fragments.block_fragments(x, params, lowp=True)
        excess += fragments.pair_excess(low[sl], ref[sl])
    del volp
    uv, hist = multicut.rag_histograms(ws, bmap)
    f64 = multicut.features(hist)
    f16 = multicut.features(hist, lowp=True)
    c64 = multicut.costs(f64[:, 0])
    c16 = multicut.costs(f16[:, 0], lowp=True)
    lut = multicut.solved_lut(uv, c16, lowp=True)
    return {"ws_pair_excess": float(excess),
            "feature_err": multicut.feature_error(f16.cpu().numpy(), f64),
            "cost_err": multicut.feature_error(c16[:, None].cpu().numpy(),
                                               c64[:, None]),
            "seg_merge_gain": multicut.merge_gain(uv, c64, lut),
            "seg_objective_gap": multicut.objective_gap(uv, c64, lut)}


#: the solver tasks' setting that leaves out the node moves
NO_MOVES = {t: {"agglomerator": "greedy-additive"}
            for t in ("solve_subproblems", "solve_global")}


def controls(ctx, seeds, n_controls):
    """Per seed, at the cell's own size: the program's readings; for the
    first ``n_controls`` seeds also the control's, and those of every
    fragment merged into one segment and of the solver without its node
    moves.  Yields ``{"seed", "side", <reading>: value}``."""
    import shutil

    import torch

    from portbench.refs import n5, volume

    cfg, traffic, dev = ctx.config, ctx.workload["traffic"], ctx.device
    chain = _Chain(os.path.join(ctx.tmp, "program"), cfg, traffic, dev)
    no_moves = _Chain(os.path.join(ctx.tmp, "no_moves"), cfg, traffic, dev,
                      tasks=NO_MOVES)
    for i, seed in enumerate(seeds):
        _, bmap = volume.synthetic_volume(cfg["shape"], seed, dev,
                                          want_labels=False)
        store = os.path.join(ctx.tmp, f"in{i}.n5")
        n5.write_array(store, "bmap", bmap.cpu().numpy(), cfg["block_shape"])
        root, t0, t1 = chain.job(store)
        yield {"seed": seed, "side": "program", "job_s": t1 - t0,
               "task_s": _task_walls(root), **judge(root, bmap, cfg)}
        if i < n_controls:
            out = os.path.join(root, "out.n5")
            ws = torch.from_numpy(
                n5.read_array(out, "ws").astype("int64")).to(dev)
            t = time.perf_counter()
            ctl = _reference_control(ws, bmap, cfg)
            yield {"seed": seed, "side": "control",
                   "seconds": time.perf_counter() - t, **ctl}
            yield {"seed": seed, "side": "all_merged",
                   **judge(root, bmap, cfg, seg=torch.ones_like(ws))}
            del ws
            nm_root, _, _ = no_moves.job(store)
            yield {"seed": seed, "side": "no_node_moves",
                   "same_outputs": _same_outputs(nm_root, root),
                   **judge(nm_root, bmap, cfg)}
            shutil.rmtree(nm_root, ignore_errors=True)
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(store, ignore_errors=True)


def _traced_job(ctx, chain, store, telemetry):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.reduce import Trace, device_ops, marker_offset

    acts = [ProfilerActivity.CPU]
    if ctx.device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    telemetry.reset()
    telemetry.configure(enabled=True, ring_size=1 << 20)
    try:
        with profile(activities=acts) as prof:
            tp0 = time.perf_counter()
            with record_function("portbench.window"):
                job = chain.job(store)
            tp1 = time.perf_counter()
        spans = telemetry.spans_snapshot()
    finally:
        telemetry.reset()
    ops = device_ops(prof)
    w0 = marker_offset(prof, "portbench.window") or 0.0
    window = tp1 - tp0
    ops = [(n, a - w0, b - w0) for n, a, b in ops
           if b - w0 > 0 and a - w0 < window]
    cfg = ctx.config
    shape, block = cfg["shape"], cfg["block_shape"]
    halo = cfg["fused_segmentation"]["halo"]
    info = {"job": job, "volumes": 1, "voxels": math.prod(shape),
            "n_blocks": math.prod(-(-s // b) for s, b in zip(shape, block)),
            "outer_shape": [b + 2 * h for b, h in zip(block, halo)]}
    return Trace(cell=ctx.workload, config=cfg, window_s=window,
                 device_ops=ops,
                 spans=[(s.name, s.cat, s.t0 - tp0, s.t1 - tp0)
                        for s in spans],
                 status=_status(job[0]), info=info)
