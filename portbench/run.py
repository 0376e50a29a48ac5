"""Run one benchmark cell of the PyTorch/CUDA port once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is ``portbench/workloads/<cell>.json``: its configuration
(``portbench/configs/<config>.json``), its driver
(``portbench/drivers/<driver>.py``, functions ``run(ctx)`` and
``controls(ctx, seeds, n)``), its traffic parameters and the limits of
``correct``.  With ``--trace 0`` the last line of standard output holds
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
read by ``portbench/metrics/<metric>.py`` from a profiled window.
``correct`` is ``passes`` of the driver's readings against the cell's
limits.  Every number that decides it is printed beside its limit
as the last lines of standard error and under ``checks``, the last key of
the result.  Without a CUDA device, with fewer devices than the cell asks
for, without the port beside this folder, or if the JAX package or JAX was
loaded, the run exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PORT = "cluster_tools_tpu_torch"
#: top-level module names that may not be loaded when the result prints
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "cluster_tools_tpu")


class Context:
    """What a driver gets: the cell, its configuration, the run's
    arguments, the device, and a scratch directory under ``TMPDIR``."""

    def __init__(self, workload, config, args, device, tmp):
        self.workload = workload
        self.config = config
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(int(args.trace))
        self.device = device
        self.tmp = tmp


def load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, base: str = HERE):
    """(workload, config) of the cell ``name``."""
    wl = load_json(os.path.join(base, "workloads", f"{name}.json"))
    cfg = load_json(os.path.join(base, "configs", f"{wl['config']}.json"))
    return wl, cfg


def load_driver(name: str, base: str = HERE):
    path = os.path.join(base, "drivers", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_driver_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def passes(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """The one decision of ``correct``, for the cell's runs and for its
    controls: every compared number read, finite and within its limit."""
    return all(k in readings and math.isfinite(float(readings[k]))
               and float(readings[k]) <= lim for k, lim in limits.items())


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _set_caches() -> None:
    """Kernel and build caches at fixed paths inside the checkout."""
    cache = os.path.join(HERE, ".cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def _fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return 2


def _finite(v: float):
    """A number for JSON: an infinite or undefined reading as a large
    finite one."""
    v = float(v)
    return v if v == v and abs(v) != float("inf") else 1e300


def device_record(device: str, peak: int) -> Dict[str, Any]:
    import torch

    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def main(argv: Optional[List[str]] = None, *, device: Optional[str] = None,
         overrides: Optional[Dict[str, Any]] = None,
         bench: Optional[Dict[str, Any]] = None, base: str = HERE) -> int:
    """Run the cell; ``device``, ``overrides`` (merged into the workload's
    ``traffic`` and the configuration) and ``bench`` are for the tests,
    which drive a run on the CPU at a small size."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    try:
        workload, config = load_cell(args.workload, base)
    except FileNotFoundError as e:
        return _fail(f"unknown cell {args.workload!r}: {e}")
    if overrides:
        workload = {**workload, "traffic": {**workload["traffic"],
                                            **overrides.get("traffic", {})}}
        config = {**config, **overrides.get("config", {})}
    if bench is None:
        bpath = os.path.join(os.path.dirname(base), "BENCHMARK.json")
        bench = load_json(bpath) if os.path.exists(bpath) else {}
    if importlib.util.find_spec(PORT) is None and \
            not os.path.isdir(os.path.join(ROOT, PORT)):
        return _fail(f"the package {PORT} is not beside {HERE}")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    _set_caches()

    import torch

    if device is None:
        need = int(workload.get("chips", 1))
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < need:
            return _fail(f"cell {args.workload} needs {need} CUDA "
                         "device(s)")
        device = "cuda"
    torch.set_num_threads(min(torch.get_num_threads(), 8))
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        ctx = Context(workload, config, args, device, tmp)
        driver = load_driver(workload["driver"], base)
        res = driver.run(ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    bad = forbidden_modules()
    if bad:
        return _fail("loaded JAX or the JAX package: " + ", ".join(bad[:20]))

    limits = workload["limits"]
    readings = res["readings"]
    correct = res["failed"] == 0 and res["attempted"] > 0 and \
        passes(readings, limits)
    e2e = [m["name"] for m in bench.get("end_to_end", [])
           if args.workload in m.get("workloads", [args.workload])]
    from portbench.reduce import breakdown, per_layer
    line: Dict[str, Any] = {
        "correct": correct, "attempted": int(res["attempted"]),
        "failed": int(res["failed"]), "metrics": {},
        "device": device_record(device, res["memory_peak_bytes"])}
    if ctx.trace:
        tr = res["trace"]
        line["metrics"] = per_layer(bench, args.workload, e2e, tr)
        line["device"]["busy_s"] = tr.busy_s(0.0, tr.window_s)
        line["device"]["window_s"] = tr.window_s
        line["breakdown"] = breakdown(tr)
    else:
        units = {m["name"]: m["unit"] for m in bench.get("end_to_end", [])}
        line["metrics"] = {k: {"value": float(v), "unit": units.get(k, "")}
                           for k, v in res["metrics"].items()}
    for k, v in res.get("info", {}).items():
        print(f"portbench: {k} {json.dumps(v)}", file=sys.stderr)
    checks = {n: {"value": _finite(readings.get(n, float("inf"))),
                  "limit": lim} for n, lim in limits.items()}
    for n, c in checks.items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
