"""GroupNorm followed by an activation: the U-Net ConvBlock's GroupNorm +
tanh GELU (``models/unet.py``) and Swin UNETR's InstanceNorm + LeakyReLU
and InstanceNorm alone (``models/swin_unetr.py``).

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

:func:`group_norm_act` generalises the pair: ``activation`` is one of
:data:`ACTIVATIONS` (``"gelu_tanh"``, ``"leaky_relu"`` with slope
:data:`LEAKY_SLOPE`, ``"none"``), ``weight=None`` and ``bias=None`` mean no
affine parameters, and ``groups`` equal to the channels is InstanceNorm.
The kernels take the activation as a compile-time parameter (the GELU
instance is the code above); ``kernels.py`` counts each activation's
forward and backward calls apart.  float16 inputs take the kernels too.
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
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the activations after the norm, and the kernels' codes for them
ACTIVATIONS = {"gelu_tanh": 0, "leaky_relu": 1, "none": 2}
#: the slope of ``"leaky_relu"`` below 0 (``F.leaky_relu``'s default)
LEAKY_SLOPE = 0.01

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _activate(z: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "gelu_tanh":
        return F.gelu(z, approximate="tanh")
    if activation == "leaky_relu":
        return F.leaky_relu(z, LEAKY_SLOPE)
    return z


def group_norm_act_plain(x: torch.Tensor, weight: Optional[torch.Tensor],
                         bias: Optional[torch.Tensor], groups: int,
                         eps: float, out_dtype: torch.dtype,
                         activation: str = "gelu_tanh") -> torch.Tensor:
    """GroupNorm in float32, then ``activation``, cast to ``out_dtype``.
    The ATen op ``F.group_norm`` calls, without its Python check that
    refuses groups of one value (an InstanceNorm of a single voxel, which
    the kernels normalize to 0)."""
    z = torch.group_norm(x.float(), groups, weight, bias, eps,
                         torch.backends.cudnn.enabled)
    return _activate(z, activation).to(out_dtype)


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
            lib.ctt_groupnorm_fwd.argtypes = [
                p, p, i, i, p, p, p, p, p, ll, i, i, ll, ll, i,
                ctypes.c_float, p]
            lib.ctt_groupnorm_bwd.argtypes = [
                p, p, i, i, p, p, p, p, p, p, p, p, p, ll, i, i, ll, ll, i,
                p]
            lib.ctt_groupnorm_fwd.restype = i
            lib.ctt_groupnorm_bwd.restype = i
            _lib = lib
        return _lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _shape(x: torch.Tensor) -> Tuple[int, int, int]:
    """(N, C, S) of an (N, C, ...) tensor."""
    n, c = x.shape[:2]
    return n, c, x.numel() // max(n * c, 1)


@functools.lru_cache(maxsize=None)
def _unit_affine(c: int, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale 1 and shift 0 of ``c`` channels: the kernels' affine step
    where the caller has none (read only; their gradients are dropped)."""
    return (torch.ones(c, dtype=torch.float32, device=device),
            torch.zeros(c, dtype=torch.float32, device=device))


def _check(x: torch.Tensor, weight: Optional[torch.Tensor],
           bias: Optional[torch.Tensor], groups: int,
           out_dtype: torch.dtype, activation: str = "gelu_tanh") -> None:
    if x.dim() < 2 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError("group_norm_gelu on the card needs a contiguous "
                         "float32, bfloat16 or float16 (N, C, ...) tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"no activation {activation!r}: one of "
                         f"{sorted(ACTIVATIONS)}")
    if (weight is None) != (bias is None):
        raise ValueError("group_norm_act takes a weight and a bias, or "
                         "neither")
    if out_dtype != x.dtype:
        raise ValueError(f"group_norm_gelu on the card writes the input's "
                         f"dtype {x.dtype}, not {out_dtype}")
    c = x.shape[1]
    if groups <= 0 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != (c,) or \
                t.device != x.device or not t.is_contiguous():
            raise ValueError(f"group_norm_gelu needs a contiguous float32 "
                             f"{name} of shape ({c},) on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _forward(x, weight, bias, groups, eps, activation="gelu_tanh"):
    """The forward kernels: y, and the groups' (mean, rstd)."""
    n, c, s = _shape(x)
    if weight is None:
        weight, bias = _unit_affine(c, x.device)
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
        err = lib.ctt_groupnorm_fwd(
            x.data_ptr(), y.data_ptr(), _DTYPES[x.dtype],
            ACTIVATIONS[activation], weight.data_ptr(),
            bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            part.data_ptr(), n, c, groups, s, length, chunks, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"groupnorm_{activation} kernel launch failed: "
                           f"CUDA error {err}")
    kernels.KERNELS[_COUNTER[activation]].launches += 1
    return y, mean, rstd


def _backward(dy, x, weight, bias, mean, rstd, groups,
              activation="gelu_tanh"):
    """The backward kernels: dx (x's dtype), dweight and dbias (float32,
    summed over the batch; computed against scale 1 and shift 0 where
    ``weight`` is None)."""
    n, c, s = _shape(x)
    if weight is None:
        weight, bias = _unit_affine(c, x.device)
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
        err = lib.ctt_groupnorm_bwd(
            dy.data_ptr(), x.data_ptr(), _DTYPES[x.dtype],
            ACTIVATIONS[activation], weight.data_ptr(),
            bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), db.data_ptr(), part.data_ptr(),
            coef.data_ptr(), n, c, groups, s, length, chunks,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"groupnorm_{activation}_bwd kernel launch "
                           f"failed: CUDA error {err}")
    kernels.KERNELS[_COUNTER[activation] + "_bwd"].launches += 1
    return dx, dw, db


#: the launch counter (``kernels.KERNELS``) of each activation's forward;
#: its backward's is the name + ``_bwd``
_COUNTER = {"gelu_tanh": "groupnorm_gelu",
            "leaky_relu": "groupnorm_leaky_relu", "none": "groupnorm_none"}


class _GroupNormAct(torch.autograd.Function):
    """The kernel pair under autograd: saves the input (in its own
    dtype), the affine parameters and the groups' moments."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, activation):
        y, mean, rstd = _forward(x, weight, bias, groups, eps, activation)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.groups = groups
        ctx.activation = activation
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        dx, dw, db = _backward(dy, x, weight, bias, mean, rstd, ctx.groups,
                               ctx.activation)
        if weight is None:
            dw = db = None
        return dx, dw, db, None, None, None


def group_norm_act(x: torch.Tensor, weight: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], groups: int, eps: float,
                   out_dtype: torch.dtype,
                   activation: str = "gelu_tanh") -> torch.Tensor:
    """``activation(group_norm(x, groups, weight, bias, eps))`` computed in
    float32 and returned in ``out_dtype``: the plain version for a CPU
    tensor, the kernels for a CUDA tensor (raises on a dtype, layout,
    grouping or activation they do not take).  ``weight`` and ``bias``
    None: no affine step; ``groups`` = channels: InstanceNorm."""
    if x.device.type == "cpu":
        if activation not in ACTIVATIONS:
            raise ValueError(f"no activation {activation!r}: one of "
                             f"{sorted(ACTIVATIONS)}")
        return group_norm_act_plain(x, weight, bias, groups, eps, out_dtype,
                                    activation)
    if x.device.type != "cuda":
        raise ValueError(f"no group_norm_gelu or group_norm_act "
                         f"implementation for {x.device}")
    _check(x, weight, bias, groups, out_dtype, activation)
    if torch.is_grad_enabled() and (
            x.requires_grad or (weight is not None and (
                weight.requires_grad or bias.requires_grad))):
        return _GroupNormAct.apply(x, weight, bias, groups, eps, activation)
    return _forward(x, weight, bias, groups, eps, activation)[0]


def group_norm_gelu(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, groups: int, eps: float,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """GroupNorm + tanh GELU, the U-Net ConvBlock's: :func:`group_norm_act`
    with ``"gelu_tanh"``."""
    return group_norm_act(x, weight, bias, groups, eps, out_dtype,
                          "gelu_tanh")


def group_norm_gelu_plain(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, groups: int, eps: float,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """GroupNorm in float32, then the tanh GELU, cast to ``out_dtype``."""
    return group_norm_act_plain(x, weight, bias, groups, eps, out_dtype)
