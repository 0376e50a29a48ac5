"""The readings the limits of ``correct`` are set from, on the chip.

    python3 portbench/controls.py --workload <cell> --seeds 1,2,3 \
        [--controls 3] [--out FILE]

It calls ``controls(ctx, seeds, n)`` of the cell's driver, which runs the
cell's timed path once per seed at the cell's own size and yields the
program's readings of every compared number (the lower readings), and,
for the first ``--controls`` seeds, the control's (the plain reference put
in the program's place and computed in the precision below the
configuration's) and those of the faults the driver plants.  Each record
is judged by ``run.passes`` against the cell's limits, the decision of a
benchmark run, and printed as one JSON line with its ``correct``: the
program's have to come out true, every other side's false.  The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def records(workload, config, device, tmp, seeds, n_controls):
    """The driver's control records, each with the run's ``correct``."""
    from portbench import run

    ctx = run.Context(workload, config,
                      argparse.Namespace(seed=seeds[0], seconds=0, trace=0),
                      device, tmp)
    driver = run.load_driver(workload["driver"])
    for rec in driver.controls(ctx, seeds, n_controls):
        yield {**rec, "correct": run.passes(rec, workload["limits"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    type=lambda s: [int(v) for v in s.split(",")])
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench.run import _set_caches, load_cell

    _set_caches()
    wl, cfg = load_cell(args.workload)
    tmp = tempfile.mkdtemp(prefix="portbench-controls-")
    out = open(args.out, "a") if args.out else None
    try:
        for rec in records(wl, cfg, args.device, tmp, args.seeds,
                           args.controls):
            rec = {k: (v if not isinstance(v, float) or math.isfinite(v)
                       else str(v)) for k, v in rec.items()}
            line = json.dumps({"workload": args.workload, **rec})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
