"""Exact Euclidean distance transform on the card.

Port of cluster_tools_tpu/ops/edt.py (the replacement for vigra's
``distanceTransform``, the hottest kernel of the reference's watershed,
watershed/watershed.py:139-158 ``_apply_dt``).

The EDT is separable: with D²(x) the squared distance field, each axis applies
a min-plus ("tropical") product with the quadratic cost (i-j)²·s².  Each axis
is a dense min-plus product over scanlines, O(n) work per voxel, exact (the
minimum runs over every j).  On a CUDA tensor the product is the
hand-written kernel ``csrc/minplus.cu``; on a CPU tensor it is the plain
PyTorch version :func:`minplus_plain`, which repeats the kernel's float32
op sequence (cost = (d·d)·s² from integer d = i − j, then f + cost, then
the minimum) — so the two agree bitwise at any spacing.  At unit spacing
both also agree bitwise with the JAX package (Pallas kernel and XLA path).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Optional, Sequence, Tuple

import torch

from .. import kernels
from ..core.build import build_shared

BIG = 1e10

#: elements of the (rows, i, j) broadcast the plain version holds at once
_PLAIN_TILE = {"cpu": 1 << 22, "cuda": 1 << 27}

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _load_kernel() -> ctypes.CDLL:
    """Build ``csrc/minplus.cu`` with nvcc at first use and bind it."""
    global _lib
    with _lib_lock:
        if _lib is None:
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-fmad=false", "-shared",
                   "-Xcompiler", "-fPIC"]
            lib = ctypes.CDLL(build_shared(
                "ctt_torch_minplus", [kernels.source_path("minplus")], cmd))
            fn = lib.ctt_minplus_rows
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def build_kernel() -> None:
    """Compile and load the CUDA kernel now (set-up, outside timed work)."""
    _load_kernel()


def _cost_table(n: int, spacing: float, device) -> torch.Tensor:
    """(i, j) costs ((i − j)·(i − j))·s² in float32, from integer i − j."""
    idx = torch.arange(n, device=device, dtype=torch.int32)
    d = (idx[:, None] - idx[None, :]).to(torch.float32)
    s2 = torch.tensor(float(spacing) ** 2, dtype=torch.float32,
                      device=device)
    return (d * d) * s2


def minplus_plain(flat: torch.Tensor, spacing: float = 1.0) -> torch.Tensor:
    """Plain PyTorch min-plus product, tiled over scanlines so no
    (m, n, n) broadcast is ever held."""
    m, n = flat.shape
    cost = _cost_table(n, spacing, flat.device)
    budget = _PLAIN_TILE.get(flat.device.type, 1 << 22)
    rows = max(budget // max(n * n, 1), 1)
    out = torch.empty_like(flat)
    for r0 in range(0, m, rows):
        t = flat[r0:r0 + rows]
        out[r0:r0 + rows] = torch.amin(t[:, None, :] + cost[None, :, :],
                                       dim=-1)
    return out


def minplus_cuda(flat: torch.Tensor, spacing: float = 1.0) -> torch.Tensor:
    """The CUDA kernel ``csrc/minplus.cu`` on a (m, n) float32 CUDA tensor,
    launched on the current stream.  Raises if it cannot build or launch."""
    if flat.device.type != "cuda":
        raise ValueError(f"minplus_cuda needs a CUDA tensor, got "
                         f"{flat.device}")
    if flat.dtype != torch.float32 or flat.dim() != 2 or \
            not flat.is_contiguous():
        raise ValueError("minplus_cuda needs a contiguous 2-d float32 "
                         f"tensor, got {flat.dtype} {tuple(flat.shape)}")
    m, n = flat.shape
    if n >= (1 << 24):
        raise ValueError(f"scanline length {n} too long for exact costs")
    out = torch.empty_like(flat)
    lib = _load_kernel()
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    err = lib.ctt_minplus_rows(flat.data_ptr(), out.data_ptr(), m, n,
                               float(spacing) ** 2, stream)
    if err != 0:
        raise RuntimeError(f"minplus kernel launch failed: CUDA error {err}")
    kernels.KERNELS["minplus"].launches += 1
    return out


def minplus(flat: torch.Tensor, spacing: float = 1.0) -> torch.Tensor:
    """out[m, i] = min_j flat[m, j] + ((i − j)·s)²: the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if flat.device.type == "cuda":
        return minplus_cuda(flat, spacing)
    if flat.device.type == "cpu":
        return minplus_plain(flat, spacing)
    raise ValueError(f"no min-plus implementation for {flat.device}")


def _minplus_axis(dsq: torch.Tensor, axis: int,
                  spacing: float) -> torch.Tensor:
    """One axis of the separable EDT (leading axes fold into scanlines)."""
    n = dsq.shape[axis]
    xm = torch.movedim(dsq, axis, -1).contiguous()
    lead = xm.shape[:-1]
    out = minplus(xm.reshape(-1, n), spacing)
    return torch.movedim(out.reshape(*lead, n), -1, axis)


def distance_transform_edt(mask: torch.Tensor,
                           sampling: Optional[Sequence[float]] = None,
                           axes: Optional[Tuple[int, ...]] = None
                           ) -> torch.Tensor:
    """Exact EDT of a boolean mask: distance of each foreground (True) voxel
    to the nearest background voxel (scipy.ndimage.distance_transform_edt
    convention).  ``sampling`` is the per-axis voxel pitch; ``axes``
    restricts the transform to a subset of axes (``axes=(1, 2)`` on a 3d
    stack is the per-slice 2d EDT).  One min-plus product per axis."""
    mask = mask.to(torch.bool)
    sampling = tuple(sampling) if sampling else (1.0,) * mask.dim()
    dsq = torch.where(mask, BIG, 0.0).to(torch.float32)
    for ax in axes if axes is not None else range(mask.dim()):
        dsq = _minplus_axis(dsq, ax, float(sampling[ax]))
    # float64 sqrt rounded to float32 is the correctly rounded float32
    # sqrt on every device (torch's vectorized float32 sqrt on the CPU is
    # not, in about 1 of 200 cases)
    return torch.sqrt(dsq.to(torch.float64)).to(torch.float32)
