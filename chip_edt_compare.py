#!/usr/bin/env python3
"""The port's EDT kernel against the dense min-plus kernel it replaced, in
turns, on one CUDA card.

Run from the root of a checkout, with the dense kernel's source
(``cluster_tools_tpu_torch/csrc/minplus.cu`` as of commit 6b690799, which
exports ``ctt_minplus_rows``) unpacked into a directory ``.gitignore``
lists:

    mkdir -p _archive_check
    git show 6b690799:cluster_tools_tpu_torch/csrc/minplus.cu \
        > _archive_check/minplus_dense.cu
    python3 chip_edt_compare.py _archive_check/minplus_dense.cu

Both sources are built with the same nvcc command.  On the EDT mask of one
outer block of the main path (``(58, 576, 576)``, synthetic volume seed 0,
threshold 0.25) it times, per axis and for the whole EDT, the dense path
(a transposed contiguous copy, the dense kernel on its rows, the copy
back; float64 sqrt at the end) and the envelope path (the kernel in place;
three launches for the EDT), each as the median of CUDA-event timings, in
the order dense, envelope, envelope, dense; per axis it also times both
kernels alone on the same contiguous rows.  Every pair of outputs must be
bitwise equal.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_edt_compare: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import _time_ms, block_mask
    from cluster_tools_tpu_torch.core.build import build_shared
    from cluster_tools_tpu_torch.ops import edt

    info = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(info, flush=True)
    lib = ctypes.CDLL(build_shared("ctt_dense_minplus",
                                   [os.path.abspath(sys.argv[1])],
                                   edt.nvcc_command()))
    dense_rows = lib.ctt_minplus_rows
    dense_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                           ctypes.c_void_p]
    dense_rows.restype = ctypes.c_int
    edt.build_kernel()

    def dense(flat):
        out = torch.empty_like(flat)
        err = dense_rows(flat.data_ptr(), out.data_ptr(), flat.shape[0],
                         flat.shape[1], 1.0,
                         torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"dense kernel launch failed: {err}")
        return out

    def dense_axis(x, ax):
        xm = torch.movedim(x, ax, -1).contiguous()
        out = dense(xm.reshape(-1, xm.shape[-1]))
        return torch.movedim(out.reshape(xm.shape), -1, ax)

    def dense_edt(mask):
        dsq = torch.where(mask, edt.BIG, 0.0).to(torch.float32)
        for ax in range(mask.dim()):
            dsq = dense_axis(dsq, ax)
        return torch.sqrt(dsq.to(torch.float64)).to(torch.float32)

    def in_turns(name, old, new, reps=20):
        if not torch.equal(old(), new()):
            raise AssertionError(f"{name}: dense != envelope")
        times = {"dense": [], "envelope": []}
        for side in ("dense", "envelope", "envelope", "dense"):
            times[side].append(_time_ms(old if side == "dense" else new,
                                        reps=reps))
        row = {"name": name, **times}
        print(f"compare {json.dumps(row)}", flush=True)

    fg = block_mask([58, 576, 576])
    x = torch.where(fg, edt.BIG, 0.0).to(torch.float32)
    for ax, name in enumerate("zyx"):
        flat = torch.movedim(x, ax, -1).contiguous().reshape(-1, x.shape[ax])
        in_turns(f"{name} kernels on rows {list(flat.shape)}",
                 lambda: dense(flat), lambda: edt.minplus_cuda(flat))
        in_turns(f"{name} axis as the EDT runs it",
                 lambda: dense_axis(x, ax),
                 lambda: edt.minplus_axis_cuda(x, ax))
        x = edt.minplus_axis_cuda(x, ax)
    in_turns("block EDT", lambda: dense_edt(fg),
             lambda: edt.distance_transform_edt(fg))
    print(info, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
