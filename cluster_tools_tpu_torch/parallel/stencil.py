"""Sharded stencils: the halo exchange over a ring of shards.

Port of cluster_tools_tpu/parallel/stencil.py.  The JAX package grows each
shard inside ``shard_map`` with two ``ppermute``s; here the shards are a
list (one ring, in mesh order) and the exchange is an explicit ring of
copies: shard i receives the high ``halo`` slab of shard i-1 and the low
slab of shard i+1 (each a real copy on its own device, :func:`~.mesh.send`),
and the first and last shards pad their outer side — ``constant`` with
``fill``, or ``reflect`` excluding the border plane (numpy's reflect, the
blockwise readers' volume-level fold), which needs ``halo <= size - 1``.
There is no wrap.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Union

import numpy as np
import torch

from .mesh import Mesh, send


def _take(x: torch.Tensor, axis: int, sl: slice) -> torch.Tensor:
    idx = [slice(None)] * x.ndim
    idx[axis] = sl
    return x[tuple(idx)]


def grow_shard(shards: Sequence[torch.Tensor], i: int, halo: int,
               axis: int, fill: Any = 0, mode: str = "constant"
               ) -> torch.Tensor:
    """Shard ``i`` of a ring grown by ``halo`` on both ends of ``axis``:
    the previous shard's high slab and the next shard's low slab (real
    copies on shard i's device), the outer ends of the first and last
    shards padded (``constant`` with ``fill``, or ``reflect`` excluding
    the border plane)."""
    x = shards[i]
    if halo <= 0:
        return x
    n = len(shards)
    size = x.shape[axis]

    def pad(lo: bool) -> torch.Tensor:
        if mode == "reflect":
            if halo > size - 1:
                raise ValueError(f"reflect halo {halo} needs a shard of "
                                 f"more than {halo} planes, got {size}")
            sl = slice(1, halo + 1) if lo else slice(size - halo - 1,
                                                     size - 1)
            return torch.flip(_take(x, axis, sl), dims=(axis,))
        sl = slice(0, halo) if lo else slice(size - halo, size)
        return torch.full_like(_take(x, axis, sl), fill)

    if i == 0:
        lo = pad(True)
    else:
        prev = shards[i - 1]
        lo = send(_take(prev, axis, slice(prev.shape[axis] - halo, None)),
                  x.device)
    hi = pad(False) if i == n - 1 else send(
        _take(shards[i + 1], axis, slice(0, halo)), x.device)
    return torch.cat([lo, x, hi], dim=axis)


def halo_exchange(shards: Sequence[torch.Tensor], halo: int, axis: int,
                  fill: Any = 0, mode: str = "constant"
                  ) -> List[torch.Tensor]:
    """Grow every shard of a ring by ``halo`` on both ends of ``axis``
    with its neighbours' data (:func:`grow_shard`; ``mode``: ``constant``
    pads the outer ends with ``fill``, ``reflect`` mirrors them excluding
    the border plane, which needs ``halo <= size - 1``)."""
    shards = list(shards)
    return [grow_shard(shards, i, halo, axis, fill=fill, mode=mode)
            for i in range(len(shards))]


def crop_halo(x: Union[torch.Tensor, Sequence[torch.Tensor]], halo: int,
              axis: int):
    """Drop ``halo`` from both ends of ``axis`` (write the inner block);
    a list of shards is cropped shard by shard."""
    if not isinstance(x, torch.Tensor):
        return [crop_halo(s, halo, axis) for s in x]
    if halo <= 0:
        return x
    return _take(x, axis, slice(halo, x.shape[axis] - halo))


def sharded_stencil(fn: Callable[[torch.Tensor], torch.Tensor], mesh: Mesh,
                    halo: int, axis: int = 0, mesh_axis: str = "space",
                    fill: Any = 0, mode: str = "constant"):
    """Wrap a local stencil ``fn(block) -> block`` into a mesh-sharded op.

    The returned function takes the shards of a tensor split over
    ``mesh_axis`` on ``axis`` (one per mesh position, as
    :func:`~.mesh.shard` makes them; positions that differ only on other
    axes hold the same piece), runs the halo exchange along each ring of
    ``mesh_axis``, applies ``fn`` to every grown shard on its device and
    crops the halo back off.  Given a tensor instead, it shards it, runs
    the same and returns the joined result."""
    from .mesh import Placement, shard, unshard

    k = mesh.axis_names.index(mesh_axis)
    placement = Placement(tuple([None] * axis + [mesh_axis]))

    def on_shards(shards):
        shards = list(shards)
        shape = mesh.devices.shape
        out: List[torch.Tensor] = [None] * mesh.size  # type: ignore
        # every ring: the positions that share all coordinates but k
        pos = np.arange(mesh.size).reshape(shape)
        rings = np.moveaxis(pos, k, -1).reshape(-1, shape[k])
        for ring in rings:
            grown = halo_exchange([shards[i] for i in ring], halo, axis,
                                  fill=fill, mode=mode)
            for i, g in zip(ring, grown):
                out[i] = crop_halo(fn(g), halo, axis)
        return out

    def apply(x):
        if isinstance(x, torch.Tensor):
            return unshard(on_shards(shard(x, mesh, placement)), mesh,
                           placement, device=x.device)
        return on_shards(x)

    return apply
