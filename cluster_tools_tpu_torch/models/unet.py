"""3D U-Net for EM boundary / affinity prediction.

Port of cluster_tools_tpu/models/unet.py (a flax.linen module) as a
``torch.nn.Module`` that computes what the flax module computes, from the
same parameters (``models/checkpoint.py`` carries them over):

* 3x3x3 convolutions with zero ``SAME`` padding and 2x2x2 (or 1x2x2)
  up-convolutions, computed in ``dtype`` (bfloat16 by default): inputs,
  kernels and biases are cast to it where the flax module casts them, and
  the bias is added after the convolution, as flax does;
* GroupNorm (``min(8, features)`` groups, epsilon 1e-6) in float32, then
  the tanh approximation of GELU (flax ``nn.gelu``'s default);
* skips concatenated as ``[upsampled, skip]``; the final 1x1 convolution
  and the sigmoid in float32.

Parameters stay float32.  The module takes and returns channels-first
tensors ``(B, C, D, H, W)`` (the flax module is channels-last); float32
convolutions run without TF32 whatever the caller set.

The number of output channels defaults to the 12-channel long-range
affinity neighborhood of the mutex-watershed stack (``DEFAULT_OFFSETS``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

#: default long-range offset pattern (reference: mws default offsets — the
#: 12-channel neighborhood of mutex_watershed/mws_blocks.py)
DEFAULT_OFFSETS: Tuple[Tuple[int, int, int], ...] = (
    (-1, 0, 0), (0, -1, 0), (0, 0, -1),
    (-2, 0, 0), (0, -3, 0), (0, 0, -3),
    (-3, 0, 0), (0, -9, 0), (0, 0, -9),
    (-4, 0, 0), (0, -27, 0), (0, 0, -27),
)


def no_tf32():
    """A context in which cuDNN's float32 convolutions run in full float32
    (PyTorch lets them use TF32 by default); the caller's flags come back
    on exit."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def _bias(b: torch.Tensor, dtype) -> torch.Tensor:
    return b.to(dtype).view(1, -1, 1, 1, 1)


def _conv(x: torch.Tensor, conv: nn.Conv3d, dtype) -> torch.Tensor:
    """``conv`` in ``dtype``, the bias added after the convolution (flax
    ``nn.Conv(dtype=...)``)."""
    y = F.conv3d(x.to(dtype), conv.weight.to(dtype), None,
                 padding=conv.padding)
    return y + _bias(conv.bias, dtype)


class ConvBlock(nn.Module):
    """Two 3x3x3 convs with GroupNorm + GELU."""

    def __init__(self, in_channels: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleList([
            nn.Conv3d(in_channels, features, 3, padding=1),
            nn.Conv3d(features, features, 3, padding=1)])
        self.norms = nn.ModuleList([
            nn.GroupNorm(min(8, features), features, eps=1e-6)
            for _ in range(2)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, norm in zip(self.convs, self.norms):
            x = _conv(x, conv, self.dtype)
            # GroupNorm in float32 for stable statistics
            x = F.gelu(norm(x.to(torch.float32)), approximate="tanh")
            x = x.to(self.dtype)
        return x


class UNet3D(nn.Module):
    """3D U-Net: encoder/decoder with skip connections.

    Input ``(B, in_channels, D, H, W)``; output ``(B, out_channels, D, H,
    W)`` float32 (sigmoid probabilities when ``final_activation ==
    'sigmoid'``).  D, H, W must be multiples of :meth:`min_divisor`.
    """

    def __init__(self, in_channels: int = 1,
                 out_channels: int = len(DEFAULT_OFFSETS),
                 features: Sequence[int] = (16, 32, 64, 128),
                 scale_factors: Sequence[Tuple[int, int, int]] = (
                     (1, 2, 2), (2, 2, 2), (2, 2, 2)),
                 final_activation: str = "sigmoid",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        features = tuple(int(f) for f in features)
        self.features = features
        self.scale_factors = tuple(tuple(int(v) for v in s)
                                   for s in scale_factors)
        if len(self.scale_factors) != len(features) - 1:
            raise ValueError("one scale factor per level below the "
                             "bottleneck needed")
        self.final_activation = final_activation
        self.dtype = dtype
        chans = (in_channels,) + features[:-2]
        self.encoders = nn.ModuleList([
            ConvBlock(c, f, dtype) for c, f in zip(chans, features[:-1])])
        self.bottleneck = ConvBlock(features[-2], features[-1], dtype)
        levels = list(reversed(range(len(features) - 1)))
        # decoder order: deepest level first (flax ConvTranspose_0 /
        # the decoder ConvBlock right after the bottleneck)
        self.upsamplers = nn.ModuleList([
            nn.ConvTranspose3d(features[lv + 1], features[lv],
                               self.scale_factors[lv],
                               stride=self.scale_factors[lv])
            for lv in levels])
        self.decoders = nn.ModuleList([
            ConvBlock(2 * features[lv], features[lv], dtype)
            for lv in levels])
        self.head = nn.Conv3d(features[0], out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        skips = []
        for enc, s in zip(self.encoders, self.scale_factors):
            x = enc(x)
            skips.append(x)
            x = F.max_pool3d(x, kernel_size=s, stride=s)
        x = self.bottleneck(x)
        for up, dec in zip(self.upsamplers, self.decoders):
            x = F.conv_transpose3d(x.to(dt), up.weight.to(dt), None,
                                   stride=up.stride) + _bias(up.bias, dt)
            x = dec(torch.cat([x, skips.pop()], dim=1))
        x = _conv(x.to(torch.float32), self.head, torch.float32)
        if self.final_activation == "sigmoid":
            x = torch.sigmoid(x)
        return x

    def min_divisor(self) -> Tuple[int, int, int]:
        """Spatial dims must be divisible by the product of scale factors."""
        d = [1, 1, 1]
        for s in self.scale_factors:
            for i in range(3):
                d[i] *= s[i]
        return tuple(d)


def create_unet(out_channels: int = len(DEFAULT_OFFSETS),
                features: Sequence[int] = (16, 32, 64, 128),
                anisotropic: bool = True, in_channels: int = 1,
                dtype: torch.dtype = torch.bfloat16) -> UNet3D:
    """The U-Net of a checkpoint's ``model.json`` kwargs (the JAX
    package's ``create_unet``); ``in_channels`` is implicit there (flax
    infers it from the first input)."""
    n_levels = len(features) - 1
    if anisotropic:  # first level downsamples in-plane only (coarse EM z)
        scales = ((1, 2, 2),) + tuple((2, 2, 2) for _ in range(n_levels - 1))
    else:
        scales = tuple((2, 2, 2) for _ in range(n_levels))
    return UNet3D(in_channels=in_channels, out_channels=out_channels,
                  features=tuple(features), scale_factors=scales,
                  dtype=dtype)
