"""Run-length coding of dense block labels for the device-to-host copy.

Port of ``rle_encode_packed`` / ``rle_decode_packed`` from
cluster_tools_tpu/ops/sweep.py.  Label ids below 2^16 are encoded as ONE
stream of ``length << 16 | value`` words, runs force-split every
``RLE_STRIDE`` elements so lengths fit 16 bits.  The stream is computed in
int64 on the device (torch supports uint32 poorly on CUDA) and read as
uint32 on the host.
"""

from __future__ import annotations

import numpy as np
import torch

#: forced run break interval: lengths must fit 16 bits
RLE_STRIDE = 1 << 15


def rle_encode_packed(flat: torch.Tensor, cap: int):
    """Run-length encode a flat label tensor into ``cap`` packed words.
    Returns ``(packed int64[cap], n_runs, ok)``: words past ``n_runs`` are
    zero; ``ok`` is False on cap overflow or ids >= 2^16 (the caller then
    copies the dense labels instead)."""
    n = int(flat.shape[0])
    dev = flat.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    brk = torch.ones(n, dtype=torch.bool, device=dev)
    brk[1:] = flat[1:] != flat[:-1]
    brk |= (idx % RLE_STRIDE) == 0
    starts = torch.nonzero(brk).squeeze(1)
    n_runs = int(starts.shape[0])
    ok = n_runs <= cap and (n == 0 or int(flat.max()) < (1 << 16))
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    words = ((ends - starts) << 16) | (flat[starts].to(torch.int64) & 0xFFFF)
    packed = torch.zeros(cap, dtype=torch.int64, device=dev)
    packed[:min(n_runs, cap)] = words[:cap]
    return packed, n_runs, ok


def rle_decode_packed(packed: np.ndarray, n_runs: int,
                      total: int) -> np.ndarray:
    """Host-side inverse of :func:`rle_encode_packed`."""
    arr = np.asarray(packed[:n_runs]).astype(np.uint32)
    lengths = (arr >> 16).astype(np.int64)
    values = (arr & 0xFFFF).astype(np.uint16)
    out = np.repeat(values, lengths)
    if out.size != total:
        raise ValueError(f"RLE decode size {out.size} != {total}")
    return out
