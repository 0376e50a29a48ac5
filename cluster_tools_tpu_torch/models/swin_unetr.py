"""Swin UNETR (Hatamizadeh et al., arXiv:2201.01266) for 3D affinities.

A Swin transformer encoder over 2x2x2 patches, four stages of pre-norm
blocks whose attention alternates between windows and cyclically shifted
windows, with a learned relative-position bias, and a residual
convolution decoder fed by five hidden states.  The JAX package has no such
model; this one follows MONAI's ``SwinUNETR`` (the papers' code) with
these equations:

* patch embedding: a 2x2x2 convolution, stride 2, with bias;
* stage i (C = feature_size * 2**i): ``depths[i]`` blocks of
  ``x + Attn(LN(x))`` then ``x + MLP(LN(x))`` (LayerNorm eps 1e-5; MLP
  Linear(C, 4C), exact GELU, Linear(4C, C)), then patch merging: the 8
  voxels of each 2x2x2 cell concatenated in :data:`MERGE_ORDER`,
  LayerNorm(8C), Linear(8C, 2C) without bias;
* attention: the normalized tokens padded at the high end of each axis to
  a multiple of the window, odd blocks rolled by ``-(window // 2)`` on each
  axis, cut into windows; per window ``softmax(q k^T / sqrt(d) + B[index]
  + mask) v`` with one Linear(C, 3C) for q, k and v, a ((2M - 1)^3, heads)
  bias table B indexed by the tokens' relative offset, and -100 between
  tokens of different regions of the shifted volume; then Linear(C, C),
  the windows put back, the roll undone, the padding cut.  Where an axis's
  extent is at most the window M, the window is that extent and the block
  does not shift along it;
* hidden states: the embedding and each stage's merged output through a
  LayerNorm without affine parameters;
* decoder: residual blocks (3x3x3 conv, InstanceNorm, LeakyReLU(0.01),
  3x3x3 conv, InstanceNorm; plus the input, through a 1x1x1 conv and an
  InstanceNorm where the width changes; then LeakyReLU(0.01)) on the raw
  input and on hidden states 0, 1, 2 and 4; five up-blocks (a 2x2x2
  transposed conv, stride 2, ``[up, skip]``, a residual block); a 1x1x1
  head with bias and the sigmoid.  Only the embedding and the head have
  biases; InstanceNorm has eps 1e-5 and no affine parameters.

Precision as the U-Net's: float32 parameters; convolutions, linears and the
attention's products in ``dtype`` (bfloat16 by default); LayerNorm and
InstanceNorm statistics, the softmax, the head and the sigmoid in float32.
The transformer's residual stream stays float32.  The window attention is
``F.scaled_dot_product_attention`` with the bias and the shift mask as one
additive mask, gathered once per block; the InstanceNorms are
:func:`~..ops.norm.group_norm_act` with one group per channel (the kernel
pair ``csrc/groupnorm.cu`` on the card).

Tensors are channels-first ``(B, C, D, H, W)`` in and out, as ``UNet3D``'s;
D, H and W must be multiples of :meth:`SwinUNETR.min_divisor`.  With the
port's telemetry on, the forward records ``torch.profiler`` ranges and
telemetry spans ``swin-forward`` (attrs: the windows attended and the
padded tokens), ``swin-embed``, ``swin-window-attn``, ``swin-mlp``,
``swin-merge`` and ``swin-decoder``.
"""

from __future__ import annotations

import functools
import itertools
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core import telemetry
from ..ops.norm import group_norm_act
from .unet import DEFAULT_OFFSETS, no_tf32

#: the order in which patch merging concatenates the voxels of a 2x2x2
#: cell: offsets (dz, dy, dx), dx fastest
MERGE_ORDER: Tuple[Tuple[int, int, int], ...] = tuple(
    itertools.product(range(2), repeat=3))
#: LayerNorm's and InstanceNorm's epsilon
LN_EPS = 1e-5
IN_EPS = 1e-5
#: the decoder's LeakyReLU slope
LEAKY_SLOPE = 0.01
#: added to the scores of token pairs from different shifted regions
MASK_VALUE = -100.0


class _Range:
    """A ``torch.profiler`` range and a telemetry span of one name."""

    __slots__ = ("rf", "sp")

    def __init__(self, name: str, attrs: Dict):
        self.rf = torch.profiler.record_function(name)
        self.sp = telemetry.span(name, **attrs)

    def __enter__(self):
        self.rf.__enter__()
        self.sp.__enter__()
        return self

    def __exit__(self, *exc):
        self.sp.__exit__(*exc)
        self.rf.__exit__(*exc)
        return False

    def annotate(self, **attrs):
        self.sp.annotate(**attrs)


def _range(name: str, **attrs):
    """A profiler range mirrored as a telemetry span while telemetry is
    on; off, telemetry's shared no-op span."""
    if not telemetry.enabled():
        return telemetry.span(name)
    return _Range(name, attrs)


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------

def window_and_shift(extent: Sequence[int], window: int, shifted: bool
                     ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Per axis, the block's window and shift: the extent and no shift
    where the extent is at most ``window``, else ``window`` and, for a
    shifted block, ``window // 2``."""
    win = tuple(min(int(e), window) for e in extent)
    shift = tuple(window // 2 if shifted and e > window else 0
                  for e in extent)
    return win, shift


def partition(x: torch.Tensor, win: Sequence[int]) -> torch.Tensor:
    """``(B, D, H, W, C)`` -> ``(B, nW, n, C)``: windows in (z, y, x)
    order, tokens in a window in (z, y, x) order."""
    b, d, h, w, c = x.shape
    x = x.view(b, d // win[0], win[0], h // win[1], win[1], w // win[2],
               win[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        b, -1, win[0] * win[1] * win[2], c)


def reverse(windows: torch.Tensor, win: Sequence[int],
            dims: Sequence[int]) -> torch.Tensor:
    """The inverse of :func:`partition` onto a volume of ``dims``."""
    b, c = windows.shape[0], windows.shape[-1]
    d, h, w = dims
    x = windows.view(b, d // win[0], h // win[1], w // win[2], win[0],
                     win[1], win[2], c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, c)


@functools.lru_cache(maxsize=None)
def relative_index(win: Tuple[int, ...], window: int,
                   device: str) -> torch.Tensor:
    """``(n * n,)`` rows of the ((2M - 1)^3, heads) bias table for the
    token pairs of a window of ``win``: the offset of token i from token
    j, each axis shifted by M - 1, in (z, y, x) order."""
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(w) for w in win], indexing="ij")).flatten(1)
    rel = coords[:, :, None] - coords[:, None, :] + (window - 1)
    side = 2 * window - 1
    idx = (rel[0] * side + rel[1]) * side + rel[2]
    return idx.reshape(-1).to(device)


@functools.lru_cache(maxsize=None)
def shift_mask(dims: Tuple[int, ...], win: Tuple[int, ...],
               shift: Tuple[int, ...], device: str,
               dtype: torch.dtype) -> torch.Tensor:
    """``(nW, n, n)``: 0 between tokens of one region of the rolled,
    padded volume of ``dims``, :data:`MASK_VALUE` across regions.  Along an
    axis with shift s > 0 the regions are [0, P - w), [P - w, P - s) and
    [P - s, P) (MONAI's ``compute_mask``); along an unshifted axis one."""
    ids = torch.zeros(dims, dtype=torch.int64)
    cuts = []
    for p, w, s in zip(dims, win, shift):
        edge = [0, p - w, p - s, p] if s else [0, p]
        cuts.append(list(zip(edge[:-1], edge[1:])))
    for k, (a, b_, c) in enumerate(itertools.product(*cuts)):
        ids[a[0]:a[1], b_[0]:b_[1], c[0]:c[1]] = k
    w_ids = partition(ids[None, ..., None], win)[0, ..., 0]  # (nW, n)
    differ = w_ids[:, None, :] != w_ids[:, :, None]
    mask = torch.zeros(differ.shape, dtype=torch.float32)
    mask[differ] = MASK_VALUE
    return mask.to(device=device, dtype=dtype)


def relative_bias(table: torch.Tensor, index: torch.Tensor,
                  n: int) -> torch.Tensor:
    """``(heads, n, n)`` float32: the table's rows for each token pair
    (contiguous: the fused attention kernels take a mask whose last
    dimension has stride 1)."""
    return table[index].view(n, n, -1).permute(2, 0, 1).contiguous()


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

def _linear(x: torch.Tensor, lin: nn.Linear, dtype) -> torch.Tensor:
    bias = lin.bias.to(dtype) if lin.bias is not None else None
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps)


class WindowAttention(nn.Module):
    """q, k, v, the bias table and the output projection of one block."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        if dim % heads:
            raise ValueError(f"{dim} channels do not split into {heads} "
                             "heads")
        self.heads = heads
        self.window = window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 3, heads))

    def forward(self, x: torch.Tensor, win, shift, dtype) -> torch.Tensor:
        """``x`` ``(B, D, H, W, C)`` normalized tokens, padded and rolled
        by the caller; returns the windows' outputs ``(B, nW, n, C)``."""
        b, c = x.shape[0], x.shape[-1]
        h = self.heads
        d = c // h
        dims = tuple(x.shape[1:4])
        windows = partition(x, win)
        n_win, n = windows.shape[1], windows.shape[2]
        qkv = _linear(windows, self.qkv, dtype)
        qkv = qkv.view(b, n_win, n, 3, h, d).permute(3, 0, 1, 4, 2, 5)
        dev = str(x.device)
        bias = relative_bias(self.relative_position_bias_table,
                             relative_index(tuple(win), self.window, dev),
                             n).to(dtype)
        if any(shift):
            # one mask per window and head: fold windows into the heads
            mask = bias[None] + shift_mask(dims, tuple(win), tuple(shift),
                                           dev, dtype)[:, None]
            q, k, v = (t.reshape(b, n_win * h, n, d) for t in qkv)
            mask = mask.reshape(1, n_win * h, n, n)
        else:
            # one mask for every window: fold windows into the batch
            q, k, v = (t.reshape(b * n_win, h, n, d) for t in qkv)
            mask = bias[None]
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                           scale=d ** -0.5)
        o = o.view(b, n_win, h, n, d).transpose(2, 3).reshape(b, n_win, n, c)
        return _linear(o, self.proj, dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        return _linear(F.gelu(_linear(x, self.fc1, dtype)), self.fc2, dtype)


class SwinBlock(nn.Module):
    """One pre-norm block: window attention (shifted on odd blocks), then
    the MLP, each added to the float32 residual stream."""

    def __init__(self, dim: int, heads: int, window: int, shifted: bool,
                 mlp_ratio: int = 4):
        super().__init__()
        self.window = window
        self.shifted = shifted
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, mlp_ratio * dim)

    def forward(self, x: torch.Tensor, dtype, stage: int,
                counts: List[int]) -> torch.Tensor:
        b, dims = x.shape[0], tuple(x.shape[1:4])
        win, shift = window_and_shift(dims, self.window, self.shifted)
        pads = [(-e) % w for e, w in zip(dims, win)]
        padded = tuple(e + p for e, p in zip(dims, pads))
        n_win = b * (padded[0] // win[0]) * (padded[1] // win[1]) * \
            (padded[2] // win[2])
        n_pad = b * (padded[0] * padded[1] * padded[2]
                     - dims[0] * dims[1] * dims[2])
        counts[0] += n_win
        counts[1] += n_pad
        with _range("swin-window-attn", stage=stage, shifted=any(shift),
                    windows=n_win, padded_tokens=n_pad):
            h = _layer_norm(x, self.norm1).to(dtype)
            if any(pads):
                h = F.pad(h, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
            if any(shift):
                h = torch.roll(h, tuple(-s for s in shift), (1, 2, 3))
            h = reverse(self.attn(h, win, shift, dtype), win, padded)
            if any(shift):
                h = torch.roll(h, shift, (1, 2, 3))
            h = h[:, :dims[0], :dims[1], :dims[2]]
            x = x + h.float()
        with _range("swin-mlp", stage=stage):
            x = x + self.mlp(_layer_norm(x, self.norm2), dtype).float()
        return x


class PatchMerging(nn.Module):
    """The 8 voxels of each 2x2x2 cell (:data:`MERGE_ORDER`), LayerNorm,
    Linear(8C, 2C) without bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(8 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in MERGE_ORDER],
                      dim=-1)
        return _linear(_layer_norm(x, self.norm), self.reduction,
                       dtype).float()


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, heads, window, shifted=j % 2 == 1)
            for j in range(depth)])
        self.merge = PatchMerging(dim)


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

def _conv(x: torch.Tensor, conv: nn.Conv3d, dtype) -> torch.Tensor:
    y = F.conv3d(x.to(dtype), conv.weight.to(dtype), None,
                 padding=conv.padding)
    # the norm kernels take (B, C, D, H, W) contiguous
    return y.contiguous() if y.is_cuda else y


def _instance_norm(x: torch.Tensor, activation: str) -> torch.Tensor:
    return group_norm_act(x, None, None, x.shape[1], IN_EPS, x.dtype,
                          activation)


class ResBlock(nn.Module):
    """MONAI's ``UnetResBlock``: conv, InstanceNorm + LeakyReLU, conv,
    InstanceNorm, plus the input (1x1x1 conv + InstanceNorm where the width
    changes), LeakyReLU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv3d(in_channels, out_channels, 3, padding=1,
                               bias=False)
        self.conv2 = nn.Conv3d(out_channels, out_channels, 3, padding=1,
                               bias=False)
        self.conv3 = nn.Conv3d(in_channels, out_channels, 1, bias=False) \
            if in_channels != out_channels else None

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        h = _instance_norm(_conv(x, self.conv1, dtype), "leaky_relu")
        h = _instance_norm(_conv(h, self.conv2, dtype), "none")
        res = x.to(dtype) if self.conv3 is None else \
            _instance_norm(_conv(x, self.conv3, dtype), "none")
        return F.leaky_relu(h + res, LEAKY_SLOPE)


class UpBlock(nn.Module):
    """A 2x2x2 transposed conv, stride 2, ``[up, skip]``, a residual
    block."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.up = nn.ConvTranspose3d(in_channels, out_channels, 2, stride=2,
                                     bias=False)
        self.block = ResBlock(2 * out_channels, out_channels)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                dtype) -> torch.Tensor:
        up = F.conv_transpose3d(x.to(dtype), self.up.weight.to(dtype), None,
                                stride=2)
        return self.block(torch.cat([up, skip.to(dtype)], dim=1), dtype)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class SwinUNETR(nn.Module):
    """Swin UNETR: input ``(B, in_channels, D, H, W)``, output ``(B,
    out_channels, D, H, W)`` float32 sigmoid probabilities."""

    def __init__(self, in_channels: int = 1,
                 out_channels: int = len(DEFAULT_OFFSETS),
                 feature_size: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        depths = tuple(int(v) for v in depths)
        num_heads = tuple(int(v) for v in num_heads)
        if len(depths) != 4 or len(num_heads) != 4:
            raise ValueError("Swin UNETR has four stages: one depth and one "
                             "head count per stage")
        self.in_channels = int(in_channels)
        self.out_channels = int(out_channels)
        self.feature_size = fs = int(feature_size)
        self.depths = depths
        self.num_heads = num_heads
        self.window_size = int(window_size)
        self.dtype = dtype
        self.patch_embed = nn.Conv3d(in_channels, fs, 2, stride=2)
        self.stages = nn.ModuleList([
            SwinStage(fs * 2 ** i, depths[i], num_heads[i], window_size)
            for i in range(4)])
        self.encoders = nn.ModuleList([
            ResBlock(in_channels, fs), ResBlock(fs, fs),
            ResBlock(2 * fs, 2 * fs), ResBlock(4 * fs, 4 * fs),
            ResBlock(16 * fs, 16 * fs)])
        self.decoders = nn.ModuleList([
            UpBlock(16 * fs, 8 * fs), UpBlock(8 * fs, 4 * fs),
            UpBlock(4 * fs, 2 * fs), UpBlock(2 * fs, fs), UpBlock(fs, fs)])
        self.head = nn.Conv3d(fs, out_channels, 1)

    def min_divisor(self) -> Tuple[int, int, int]:
        """The patch and four halvings: D, H, W must be multiples of 32."""
        return (32, 32, 32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        div = self.min_divisor()
        if x.dim() != 5 or any(s % d for s, d in zip(x.shape[2:], div)):
            raise ValueError(f"SwinUNETR takes (B, C, D, H, W) with D, H, W "
                             f"multiples of {div}, got {tuple(x.shape)}")
        with no_tf32():
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        counts = [0, 0]  # windows attended, padded tokens
        with _range("swin-forward") as top:
            with _range("swin-embed"):
                pe = self.patch_embed
                h = F.conv3d(x.to(dt), pe.weight.to(dt), None, stride=2) \
                    + pe.bias.to(dt).view(1, -1, 1, 1, 1)
                tokens = h.permute(0, 2, 3, 4, 1).float()
            hidden = [_hidden(tokens, dt)]
            for i, stage in enumerate(self.stages):
                for blk in stage.blocks:
                    tokens = blk(tokens, dt, i, counts)
                with _range("swin-merge", stage=i):
                    tokens = stage.merge(tokens, dt)
                hidden.append(_hidden(tokens, dt))
            with _range("swin-decoder"):
                enc = [blk(t, dt) for blk, t in
                       zip(self.encoders[:4], [x] + hidden[:3])]
                h = self.encoders[4](hidden[4], dt)
                for up, skip in zip(self.decoders,
                                    [hidden[3]] + enc[::-1]):
                    h = up(h, skip, dt)
                h = F.conv3d(h.float(), self.head.weight.float(),
                             self.head.bias.float())
                out = torch.sigmoid(h)
            top.annotate(windows=counts[0], padded_tokens=counts[1])
        return out


def _hidden(tokens: torch.Tensor, dtype) -> torch.Tensor:
    """A hidden state: LayerNorm without affine parameters, channels
    first, in ``dtype``."""
    h = F.layer_norm(tokens, tokens.shape[-1:], eps=LN_EPS)
    return h.permute(0, 4, 1, 2, 3).to(dtype).contiguous()


def create_swin_unetr(in_channels: int = 1,
                      out_channels: int = len(DEFAULT_OFFSETS),
                      feature_size: int = 48,
                      depths: Sequence[int] = (2, 2, 2, 2),
                      num_heads: Sequence[int] = (3, 6, 12, 24),
                      window_size: int = 7,
                      dtype: torch.dtype = torch.bfloat16) -> SwinUNETR:
    """Swin UNETR at the paper's widths by default (feature size 48,
    depths 2-2-2-2, heads 3-6-12-24, window 7, patch 2)."""
    return SwinUNETR(in_channels=in_channels, out_channels=out_channels,
                     feature_size=feature_size, depths=depths,
                     num_heads=num_heads, window_size=window_size,
                     dtype=dtype)
