#!/usr/bin/env python3
"""Where the device time of one block of the port's fused chain goes.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_profile.py [--roi]

It builds the port's CUDA kernel, makes one ``[50, 512, 512]`` block of
the synthetic benchmark volume (seed 0) with its ``[4, 32, 32]`` halo,
runs the whole per-block chain (``workflows/fused_pipeline.resident_block``,
the default fused task config) a few times, prints the wall seconds of
each run, then profiles one run with ``torch.profiler`` and prints the
device time by operator, the min-plus kernel's share and the
device-to-device copies' share.  With ``--roi`` the block is the resident
server's: ``[50, 256, 256]`` with the same halo and
``core.server.FusedROIPipeline``'s parameters.  With ``--trace PATH`` the
profiled run also records the port's telemetry spans (its ``dispatch``
and ``sync-execute`` stages inside a ``block`` span), writes the
profiler's Chrome trace to ``PATH`` and, beside it in
``PATH.merged.json``, one trace that holds the profiler's events and the
port's spans on the profiler's timeline
(``core.telemetry.export_chrome_trace(..., profiler_trace=PATH)``), and
prints how far the block span's start lies from the profiler's own range
around it.  Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--roi", action="store_true")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from cluster_tools_tpu_torch.core import telemetry
    from cluster_tools_tpu_torch.core.runtime import stage
    from cluster_tools_tpu_torch.ops.edt import build_kernel
    from cluster_tools_tpu_torch.utils.synthetic import (as_uint8,
                                                         synthetic_instance)
    from cluster_tools_tpu_torch.workflows.fused_pipeline import (
        FusedSegmentationBlocks, ResidentParams, resident_block)
    from cluster_tools_tpu_torch.workflows.watershed import reflect_indices

    info = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(info, flush=True)
    build_kernel()
    roi = args.roi
    block = (50, 256, 256) if roi else (50, 512, 512)
    halo = (4, 32, 32)
    _, bnd = synthetic_instance(block, seed=0)
    vol = as_uint8(bnd)
    padded = vol[np.ix_(*[reflect_indices(-h, b + h, b)
                          for h, b in zip(halo, block)])]
    dev = torch.from_numpy(np.ascontiguousarray(padded)).cuda()
    cfg = FusedSegmentationBlocks.default_task_config()
    p = ResidentParams(
        outer_shape=tuple(b + 2 * h for b, h in zip(block, halo)),
        halo=halo, is_u8=True, threshold=cfg["threshold"],
        sigma_seeds=cfg["sigma_seeds"], sigma_weights=cfg["sigma_weights"],
        alpha=cfg["alpha"], min_size=cfg["size_filter"], e_max=cfg["e_max"],
        rle_cap=cfg["rle_cap"], refine_rounds=cfg["refine_rounds"],
        pair_cap=cfg["pair_cap"], coarse_factor=cfg["coarse_factor"])
    if roi:
        from cluster_tools_tpu_torch.core.server import FusedROIPipeline

        p = FusedROIPipeline(block, block_shape=block, halo=halo)._params(
            True)
    print(f"block {list(block)} params {p}", flush=True)
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resident_block(dev, (0, 0, 0), block, p)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"block wall_s {json.dumps(walls)}", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    if args.trace:
        telemetry.configure(enabled=True)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("chip_profile.block"), \
                telemetry.span("block:0", cat="block", block=0):
            with stage("dispatch"):
                resident_block(dev, (0, 0, 0), block, p)
            with stage("sync-execute"):
                torch.cuda.synchronize()
    if args.trace:
        prof.export_chrome_trace(args.trace)
        merged = args.trace + ".merged.json"
        telemetry.export_chrome_trace(merged, profiler_trace=args.trace)
        with open(merged) as f:
            events = json.load(f)["traceEvents"]
        starts = {e.get("cat"): e["ts"] for e in events
                  if e.get("name") in ("chip_profile.block", "block:0")}
        print(f"merged trace {merged}: {len(events)} events; the block "
              f"span starts {starts['block'] - starts['user_annotation']}"
              " us after the profiler's range around it", flush=True)
    # device-side events only (kernels and copies): the operator rows
    # repeat their kernels' time
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages() if e.device_type == cuda]
    total = sum(e.self_device_time_total for e in events)
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in events), reverse=True)
    print(f"device time total_ms {total / 1e3}", flush=True)
    for us, count, key in rows[:20]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / total:5.1f}% "
              f"x{count:<5d} {key[:90]}", flush=True)
    mp = sum(us for us, _, key in rows if "minplus" in key)
    print(f"minplus kernel ms {mp / 1e3} share {mp / total}", flush=True)
    cp = sum(us for us, _, key in rows if "Memcpy DtoD" in key)
    print(f"device-to-device copies ms {cp / 1e3} share {cp / total}",
          flush=True)
    print(info, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
