"""The yardstick's arithmetic for Swin UNETR: the operations of a forward
pass and the least bytes of its InstanceNorms (the peaks are
``refs/cost.py``'s).

Operations are 2 x the multiply-adds of every convolution, transposed
convolution, linear layer and attention product; norms, softmax, GELU and
elementwise work are not counted.  Attention counts each unpadded token's
query against the n keys of its window (n = the window's tokens, padding
included), so the padding of the windows shows as lost utilisation.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple


def _arch(cfg):
    return (int(cfg["feature_size"]), [int(v) for v in cfg["depths"]],
            int(cfg["window_size"]), int(cfg["in_channels"]),
            int(cfg["out_channels"]))


def _res_flop(c_in: int, c_out: int, vol: float) -> float:
    """A residual block: two 3x3x3 convolutions, and the 1x1x1 one where
    the width changes."""
    macs = 27 * c_in * c_out + 27 * c_out * c_out
    if c_in != c_out:
        macs += c_in * c_out
    return 2.0 * macs * vol


def _decoder(fs: int, c_in: int):
    """(input width, output width, volume divisor) of the five residual
    blocks on the input and hidden states, then of the five up-blocks."""
    enc = [(c_in, fs, 1), (fs, fs, 8), (2 * fs, 2 * fs, 8 ** 2),
           (4 * fs, 4 * fs, 8 ** 3), (16 * fs, 16 * fs, 8 ** 5)]
    up = [(16 * fs, 8 * fs, 8 ** 4), (8 * fs, 4 * fs, 8 ** 3),
          (4 * fs, 2 * fs, 8 ** 2), (2 * fs, fs, 8), (fs, fs, 1)]
    return enc, up


def swin_forward_flop(shape: Sequence[int], cfg) -> float:
    """FLOP of one forward pass on one crop of ``shape`` (multiples of
    32)."""
    fs, depths, m, c_in, c_out = _arch(cfg)
    v = float(math.prod(shape))
    flop = 2.0 * c_in * 8 * fs * v / 8                       # patch embedding
    for i, depth in enumerate(depths):
        c = fs * 2 ** i
        ext = [s // 2 ** (i + 1) for s in shape]
        tokens = v / 8 ** (i + 1)
        n = math.prod(min(e, m) for e in ext)
        block = 2.0 * tokens * (3 * c * c + c * c + 8 * c * c) \
            + 2.0 * 2 * tokens * n * c
        flop += depth * block
        flop += 2.0 * (tokens / 8) * 8 * c * 2 * c             # merging
    enc, up = _decoder(fs, c_in)
    for a, b, div in enc:
        flop += _res_flop(a, b, v / div)
    for a, b, div in up:
        flop += 2.0 * a * b * v / div + _res_flop(2 * b, b, v / div)
    flop += 2.0 * fs * c_out * v                               # head
    return flop


def swin_step_flop(batch: int, shape: Sequence[int], cfg) -> float:
    """A training step: forward + backward = 3 x the forward FLOP."""
    return 3.0 * batch * swin_forward_flop(shape, cfg)


def instnorm_shapes(shape: Sequence[int], cfg) -> List[Tuple[int, int]]:
    """(channels, voxels) of every InstanceNorm of one crop's forward."""
    fs, _, _, c_in, _ = _arch(cfg)
    v = int(math.prod(shape))
    enc, up = _decoder(fs, c_in)
    out = []
    for a, b, div in enc + [(2 * b, b, div) for _, b, div in up]:
        out += [(b, v // div)] * (3 if a != b else 2)
    return out


def instnorm_step_bytes(batch: int, shape: Sequence[int], cfg,
                        itemsize: int = 2) -> float:
    """Least bytes of a step's InstanceNorms, forward and backward: 5
    accesses per value (x read and y written forward; x and dy read and dx
    written backward): 10 B per bfloat16 value.  (The pair reads x twice
    in each direction and dy twice backward, 16 B a value: what it moves
    beyond the least shows as lost share.)"""
    return 5.0 * itemsize * batch * sum(c * s for c, s in
                                        instnorm_shapes(shape, cfg))
