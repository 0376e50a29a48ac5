"""Exact Euclidean distance transform on the card.

Port of cluster_tools_tpu/ops/edt.py (the replacement for vigra's
``distanceTransform``, the hottest kernel of the reference's watershed,
watershed/watershed.py:139-158 ``_apply_dt``).

The EDT is separable: with D²(x) the squared distance field, each axis applies
a min-plus ("tropical") product with the quadratic cost (i-j)²·s².  On a
CUDA tensor each axis is one launch of the hand-written kernel
``csrc/minplus.cu``: the exact lower envelope of parabolas per scanline,
O(n), walking the scanlines where they lie (no transposed copy); the first
axis reads the mask itself and the last writes the float32 sqrt.  On a CPU
tensor each axis is the plain PyTorch version :func:`minplus_plain`, a dense
min-plus product (the minimum runs over every j).  Both form each output as
the same float32 terms (cost = (d·d)·s² from integer d = i − j, then
f + cost), so they agree bitwise at unit spacing on squared distances and
within rtol 1e-6 at other spacings.  At unit spacing both also agree
bitwise with the JAX package (Pallas kernel and XLA path).
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import threading
from typing import Optional, Sequence, Tuple

import torch

from .. import kernels
from ..core.build import build_shared

BIG = 1e10

#: longest scanline the kernel takes: the envelope stacks of 32 scanlines
#: (2 bytes per element) and two warps' staging tiles must fit the 232,448
#: bytes of shared memory a block can have
MAX_SCANLINE = 3496

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


def nvcc_command() -> list:
    """The compile command of the package's CUDA sources (without the
    sources and ``-o``): ``sm_90a``, no FMA contraction."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-fmad=false", "-shared",
            "-Xcompiler", "-fPIC"]


def kernel_library() -> str:
    """The kernel library's path, built with nvcc at first use (each call
    resolves through ``core/build.py``'s counted cache)."""
    # ctt-lint: disable=metric-registry (a library's file name, not a metric)
    return build_shared("ctt_torch_minplus", [kernels.source_path("minplus")],
                        nvcc_command())


def _load_kernel() -> ctypes.CDLL:
    """Build ``csrc/minplus.cu`` with nvcc at first use and bind it."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(kernel_library())
            fn = lib.ctt_minplus_envelope
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
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


def minplus_axis_cuda(src: torch.Tensor, axis: int, spacing: float = 1.0,
                      sqrt: bool = False) -> torch.Tensor:
    """The CUDA kernel ``csrc/minplus.cu`` along ``axis`` of a contiguous
    float32 (or bool mask: True reads as BIG, False as 0) CUDA tensor, in
    place of its scanlines, launched on the current stream.  Returns a new
    float32 tensor of the squared distances, or of their sqrt when
    ``sqrt``.  Raises if it cannot build or launch."""
    if src.device.type != "cuda":
        raise ValueError(f"minplus_axis_cuda needs a CUDA tensor, got "
                         f"{src.device}")
    if src.dtype not in (torch.float32, torch.bool) or \
            not src.is_contiguous() or src.dim() == 0:
        raise ValueError("minplus_axis_cuda needs a contiguous float32 or "
                         f"bool tensor, got {src.dtype} {tuple(src.shape)}")
    if not -src.dim() <= axis < src.dim():
        raise ValueError(f"axis {axis} out of range for {src.dim()} dims")
    if not spacing > 0:
        raise ValueError(f"spacing must be positive, got {spacing}")
    axis %= src.dim()
    shape = tuple(src.shape)
    n = shape[axis]
    if n > MAX_SCANLINE:
        raise ValueError(f"scanline length {n} exceeds the kernel's "
                         f"{MAX_SCANLINE}")
    out = torch.empty(shape, dtype=torch.float32, device=src.device)
    if out.numel() == 0:
        return out
    lib = _load_kernel()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.ctt_minplus_envelope(
        src.data_ptr(), int(src.dtype == torch.bool), out.data_ptr(),
        math.prod(shape[:axis]), n, math.prod(shape[axis + 1:]),
        float(spacing) ** 2, int(sqrt), stream)
    if err != 0:
        raise RuntimeError(f"minplus kernel launch failed: CUDA error {err}")
    kernels.KERNELS["minplus"].launches += 1
    return out


def minplus_cuda(flat: torch.Tensor, spacing: float = 1.0) -> torch.Tensor:
    """The CUDA kernel on the rows of a (m, n) float32 CUDA tensor."""
    if flat.dim() != 2 or flat.dtype != torch.float32:
        raise ValueError("minplus_cuda needs a 2-d float32 tensor, got "
                         f"{flat.dtype} {tuple(flat.shape)}")
    return minplus_axis_cuda(flat, 1, spacing)


def minplus(flat: torch.Tensor, spacing: float = 1.0) -> torch.Tensor:
    """out[m, i] = min_j flat[m, j] + ((i − j)·s)²: the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if flat.device.type == "cuda":
        return minplus_cuda(flat, spacing)
    if flat.device.type == "cpu":
        return minplus_plain(flat, spacing)
    raise ValueError(f"no min-plus implementation for {flat.device}")


def _edt_args(mask, sampling, axes):
    mask = mask.to(torch.bool)
    sampling = tuple(sampling) if sampling else (1.0,) * mask.dim()
    axes = tuple(axes) if axes is not None else tuple(range(mask.dim()))
    return mask, sampling, axes


def distance_transform_edt_plain(mask: torch.Tensor,
                                 sampling: Optional[Sequence[float]] = None,
                                 axes: Optional[Tuple[int, ...]] = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version of :func:`distance_transform_edt` on any
    device: one dense min-plus product per axis over transposed copies."""
    mask, sampling, axes = _edt_args(mask, sampling, axes)
    dsq = torch.where(mask, BIG, 0.0).to(torch.float32)
    for ax in axes:
        n = dsq.shape[ax]
        xm = torch.movedim(dsq, ax, -1).contiguous()
        out = minplus_plain(xm.reshape(-1, n), float(sampling[ax]))
        dsq = torch.movedim(out.reshape(xm.shape), -1, ax)
    # float64 sqrt rounded to float32 is the correctly rounded float32
    # sqrt on every device (torch's vectorized float32 sqrt on the CPU is
    # not, in about 1 of 200 cases)
    return torch.sqrt(dsq.to(torch.float64)).to(torch.float32)


def distance_transform_edt(mask: torch.Tensor,
                           sampling: Optional[Sequence[float]] = None,
                           axes: Optional[Tuple[int, ...]] = None
                           ) -> torch.Tensor:
    """Exact EDT of a boolean mask: distance of each foreground (True) voxel
    to the nearest background voxel (scipy.ndimage.distance_transform_edt
    convention).  ``sampling`` is the per-axis voxel pitch; ``axes``
    restricts the transform to a subset of axes (``axes=(1, 2)`` on a 3d
    stack is the per-slice 2d EDT).  On a CUDA tensor one kernel launch per
    axis: the first reads the mask, the last writes the distances; on a
    CPU tensor the plain version."""
    mask, sampling, axes = _edt_args(mask, sampling, axes)
    if mask.device.type == "cpu":
        return distance_transform_edt_plain(mask, sampling, axes)
    if mask.device.type != "cuda":
        raise ValueError(f"no EDT implementation for {mask.device}")
    if not axes:
        raise ValueError("the kernel path needs at least one axis")
    x = mask.contiguous()
    for i, ax in enumerate(axes):
        x = minplus_axis_cuda(x, ax, float(sampling[ax]),
                              sqrt=i == len(axes) - 1)
    return x


def signed_distance_transform(mask: torch.Tensor,
                              sampling: Optional[Sequence[float]] = None
                              ) -> torch.Tensor:
    """Positive inside the mask, negative outside: two EDTs (on a CUDA
    tensor two kernel launches per axis)."""
    mask = mask.to(torch.bool)
    inner = distance_transform_edt(mask, sampling)
    outer = distance_transform_edt(torch.logical_not(mask), sampling)
    return inner - outer
