"""The yardstick's arithmetic: the H100's published peaks, the U-Net's
operations, and the EDT's least bytes.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W.
"""

from __future__ import annotations

import math
from typing import Sequence

#: bfloat16 dense tensor-core FLOP/s
PEAK_BF16_FLOPS = 989e12
#: HBM3 bytes/s
PEAK_HBM_BYTES = 3.35e12


def unet_forward_flop(shape: Sequence[int], features: Sequence[int], scales,
                      in_ch: int = 1, out_ch: int = 12) -> float:
    """FLOP of one forward pass of the U-Net on one crop of ``shape``:
    2 x the multiply-adds of every convolution, up-convolution and the
    head (a frozen copy of the repository's ``unet_cost`` count)."""
    v = int(math.prod(shape))
    vols = [v]
    for s in scales:
        vols.append(vols[-1] // int(math.prod(s)))

    def block(c_in, f, vol):
        return 2.0 * 27 * (c_in * f + f * f) * vol

    flop, c = 0.0, in_ch
    for lv, f in enumerate(features[:-1]):
        flop += block(c, f, vols[lv])
        c = f
    flop += block(c, features[-1], vols[-1])
    for lv in reversed(range(len(features) - 1)):
        f_in, f = features[lv + 1], features[lv]
        flop += 2.0 * f_in * f * vols[lv]
        flop += block(2 * f, f, vols[lv])
    flop += 2.0 * features[0] * out_ch * v
    return flop


def unet_step_flop(batch: int, shape: Sequence[int], features: Sequence[int],
                   scales) -> float:
    """A training step: forward + backward = 3 x the forward FLOP."""
    return 3.0 * batch * unet_forward_flop(shape, features, scales)


def edt_bytes(outer_shape: Sequence[int]) -> float:
    """Least bytes of one block's EDT: per axis, the float32 field read
    once and written once (8 B per voxel), 3 axes."""
    return 8.0 * math.prod(outer_shape) * len(outer_shape)
