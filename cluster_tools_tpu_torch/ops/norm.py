"""GroupNorm followed by the tanh GELU: the U-Net ConvBlock's
normalisation (``models/unet.py``).

The JAX package runs flax's ``nn.GroupNorm`` in float32 on a float32 copy
of each convolution output, then ``nn.gelu`` (tanh approximation), then
casts to the compute dtype (cluster_tools_tpu/models/unet.py:51-53); XLA
fuses it.  Here :func:`group_norm_gelu` computes the same function:

* on a CPU tensor, the plain PyTorch version :func:`group_norm_gelu_plain`
  (``F.group_norm`` on a float32 copy, ``F.gelu``, the cast);
* on a CUDA tensor, the hand-written kernel pair ``csrc/groupnorm.cu``
  (forward, and under autograd the backward, as a
  ``torch.autograd.Function``): each (sample, channel) row is reduced in
  chunks over many thread blocks (:func:`chunk_plan`), the convolution
  output is read in its own dtype and the result written in it; the
  backward recomputes the GELU's input from the saved input and moments,
  so no float32 activation is kept.  It raises on what the kernels do not
  take; nothing falls back to the plain version.

Both form every value in float32; the kernels sum in another order, so
they agree with the plain version to rounding, not bitwise.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import kernels
from ..core.build import build_shared
from .edt import nvcc_command

#: threads of a chunk's block and values per vector load (csrc/groupnorm.cu
#: kThreads, kPack)
THREADS, PACK = 256, 8
#: a reduction's chunks per row: enough that the grid holds BLOCKS_PER_SM
#: blocks per SM, none longer than MAX_CHUNK values, none shorter than
#: MIN_CHUNK unless the row is
BLOCKS_PER_SM = 4
MAX_CHUNK = 32768
MIN_CHUNK = 4096

#: the kernels' dtype codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def group_norm_gelu_plain(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, groups: int, eps: float,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """GroupNorm in float32, then the tanh GELU, cast to ``out_dtype``."""
    return F.gelu(F.group_norm(x.float(), groups, weight, bias, eps),
                  approximate="tanh").to(out_dtype)


def chunk_plan(rows: int, row_len: int, sm_count: int) -> Tuple[int, int]:
    """``(length, chunks)``: the kernels cut each of ``rows`` rows of
    ``row_len`` values into ``chunks`` chunks of ``length`` values (the
    last one shorter), ``length`` a multiple of PACK, one block each."""
    fill = -(-BLOCKS_PER_SM * sm_count // rows)
    k = max(fill, -(-row_len // MAX_CHUNK))
    k = max(1, min(k, row_len // MIN_CHUNK))
    length = -(-row_len // k)
    length = -(-length // PACK) * PACK
    return length, -(-row_len // length)


def kernel_library() -> str:
    """The kernels' library, built with nvcc at first use."""
    # ctt-lint: disable=metric-registry (a library's file name, not a metric)
    return build_shared("ctt_torch_groupnorm",
                        [kernels.source_path("groupnorm_gelu")],
                        nvcc_command())


def _load_kernel() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(kernel_library())
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.ctt_groupnorm_gelu_fwd.argtypes = [
                p, p, i, p, p, p, p, p, ll, i, i, ll, ll, i,
                ctypes.c_float, p]
            lib.ctt_groupnorm_gelu_bwd.argtypes = [
                p, p, i, p, p, p, p, p, p, p, p, p, ll, i, i, ll, ll, i, p]
            lib.ctt_groupnorm_gelu_fwd.restype = i
            lib.ctt_groupnorm_gelu_bwd.restype = i
            _lib = lib
        return _lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _shape(x: torch.Tensor) -> Tuple[int, int, int]:
    """(N, C, S) of an (N, C, ...) tensor."""
    n, c = x.shape[:2]
    return n, c, x.numel() // max(n * c, 1)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           groups: int, out_dtype: torch.dtype) -> None:
    if x.dim() < 2 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError("group_norm_gelu on the card needs a contiguous "
                         "float32 or bfloat16 (N, C, ...) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if out_dtype != x.dtype:
        raise ValueError(f"group_norm_gelu on the card writes the input's "
                         f"dtype {x.dtype}, not {out_dtype}")
    c = x.shape[1]
    if groups <= 0 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,) or \
                t.device != x.device or not t.is_contiguous():
            raise ValueError(f"group_norm_gelu needs a contiguous float32 "
                             f"{name} of shape ({c},) on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _forward(x, weight, bias, groups, eps):
    """The forward kernels: y, and the groups' (mean, rstd)."""
    n, c, s = _shape(x)
    y = torch.empty_like(x)
    mean = torch.empty(n * groups, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if x.numel() == 0:
        return y, mean, rstd
    length, chunks = chunk_plan(n * c, s, _sm_count(x.device.index))
    part = torch.empty((n * c * chunks, 2), dtype=torch.float32,
                       device=x.device)
    lib = _load_kernel()
    with torch.cuda.device(x.device):
        err = lib.ctt_groupnorm_gelu_fwd(
            x.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], weight.data_ptr(),
            bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            part.data_ptr(), n, c, groups, s, length, chunks, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"groupnorm_gelu kernel launch failed: CUDA "
                           f"error {err}")
    kernels.KERNELS["groupnorm_gelu"].launches += 1
    return y, mean, rstd


def _backward(dy, x, weight, bias, mean, rstd, groups):
    """The backward kernels: dx (x's dtype), dweight and dbias (float32,
    summed over the batch)."""
    n, c, s = _shape(x)
    dx = torch.empty_like(x)
    dw = torch.zeros_like(weight)
    db = torch.zeros_like(bias)
    if x.numel() == 0:
        return dx, dw, db
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"group_norm_gelu's gradient is {dy.dtype} "
                         f"{tuple(dy.shape)}, its output {x.dtype} "
                         f"{tuple(x.shape)}")
    dy = dy.contiguous()
    length, chunks = chunk_plan(n * c, s, _sm_count(x.device.index))
    part = torch.empty((n * c * chunks, 2), dtype=torch.float32,
                       device=x.device)
    coef = torch.empty((n * groups, 2), dtype=torch.float32,
                       device=x.device)
    lib = _load_kernel()
    with torch.cuda.device(x.device):
        err = lib.ctt_groupnorm_gelu_bwd(
            dy.data_ptr(), x.data_ptr(), _DTYPES[x.dtype], weight.data_ptr(),
            bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), db.data_ptr(), part.data_ptr(),
            coef.data_ptr(), n, c, groups, s, length, chunks,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"groupnorm_gelu_bwd kernel launch failed: CUDA "
                           f"error {err}")
    kernels.KERNELS["groupnorm_gelu_bwd"].launches += 1
    return dx, dw, db


class _GroupNormGelu(torch.autograd.Function):
    """The kernel pair under autograd: saves the input (in its own
    dtype), the affine parameters and the groups' moments."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps):
        y, mean, rstd = _forward(x, weight, bias, groups, eps)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.groups = groups
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        dx, dw, db = _backward(dy, x, weight, bias, mean, rstd, ctx.groups)
        return dx, dw, db, None, None


def group_norm_gelu(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, groups: int, eps: float,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """``gelu_tanh(group_norm(x, groups, weight, bias, eps))`` computed in
    float32 and returned in ``out_dtype``: the plain version for a CPU
    tensor, the kernels for a CUDA tensor (raises on a dtype, layout or
    grouping they do not take)."""
    if x.device.type == "cpu":
        return group_norm_gelu_plain(x, weight, bias, groups, eps, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no group_norm_gelu implementation for {x.device}")
    _check(x, weight, bias, groups, out_dtype)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _GroupNormGelu.apply(x, weight, bias, groups, eps)
    return _forward(x, weight, bias, groups, eps)[0]
