"""Domain decomposition: blocking geometry over N-d volumes.

Re-specification of the reference's L1 layer (nifty.tools.blocking +
cluster_tools/utils/volume_utils.py:52-276 in the reference repo): block grids,
halos, ROI restriction, inter-block faces and checkerboard 2-colorings — as pure
Python/numpy geometry with no native dependency.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from itertools import product
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

Coord = Tuple[int, ...]
BB = Tuple[slice, ...]


@dataclass(frozen=True)
class Block:
    """A single block of a :class:`Blocking` grid (reference:
    nifty.tools.blocking block objects, used e.g. watershed/watershed.py:252-264).
    """

    begin: Coord
    end: Coord

    @property
    def shape(self) -> Coord:
        return tuple(e - b for b, e in zip(self.begin, self.end))

    @property
    def bb(self) -> BB:
        return tuple(slice(b, e) for b, e in zip(self.begin, self.end))


@dataclass(frozen=True)
class BlockWithHalo:
    """Outer (halo-expanded, clipped) block, inner block, and the inner block in
    outer-local coordinates (reference: blocking.getBlockWithHalo(...).outerBlock
    / innerBlock / innerBlockLocal)."""

    outer: Block
    inner: Block
    inner_local: Block


class Blocking:
    """Regular grid of blocks covering ``shape``.

    Block ids enumerate the grid in C (row-major) order.  Semantics match the
    reference's nifty.tools.blocking (58 call sites, SURVEY.md L1): the last
    block along an axis is clipped to the volume boundary.
    """

    def __init__(self, shape: Sequence[int], block_shape: Sequence[int]):
        if len(shape) != len(block_shape):
            raise ValueError(f"dim mismatch: {shape} vs {block_shape}")
        if any(s <= 0 for s in shape) or any(b <= 0 for b in block_shape):
            raise ValueError(f"non-positive extent: {shape}, {block_shape}")
        self.shape = tuple(int(s) for s in shape)
        self.block_shape = tuple(int(b) for b in block_shape)
        self.grid_shape = tuple(
            (s + b - 1) // b for s, b in zip(self.shape, self.block_shape)
        )
        self._strides = np.array(
            [int(np.prod(self.grid_shape[i + 1:])) for i in range(self.ndim)],
            dtype=np.int64,
        )

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def n_blocks(self) -> int:
        return int(np.prod(self.grid_shape))

    def block_grid_position(self, block_id: int) -> Coord:
        if not 0 <= block_id < self.n_blocks:
            raise IndexError(f"block {block_id} out of range [0, {self.n_blocks})")
        pos = []
        rem = block_id
        for st in self._strides:
            pos.append(int(rem // st))
            rem = rem % st
        return tuple(pos)

    def grid_position_to_id(self, pos: Sequence[int]) -> int:
        return int(np.dot(np.asarray(pos, dtype=np.int64), self._strides))

    def get_block(self, block_id: int) -> Block:
        pos = self.block_grid_position(block_id)
        begin = tuple(p * b for p, b in zip(pos, self.block_shape))
        end = tuple(
            min(beg + b, s)
            for beg, b, s in zip(begin, self.block_shape, self.shape)
        )
        return Block(begin, end)

    def get_block_with_halo(self, block_id: int, halo: Sequence[int]) -> BlockWithHalo:
        inner = self.get_block(block_id)
        outer_begin = tuple(max(b - h, 0) for b, h in zip(inner.begin, halo))
        outer_end = tuple(min(e + h, s) for e, h, s in zip(inner.end, halo, self.shape))
        outer = Block(outer_begin, outer_end)
        local = Block(
            tuple(ib - ob for ib, ob in zip(inner.begin, outer_begin)),
            tuple(ie - ob for ie, ob in zip(inner.end, outer_begin)),
        )
        return BlockWithHalo(outer=outer, inner=inner, inner_local=local)

    def neighbor_id(self, block_id: int, axis: int, direction: int) -> Optional[int]:
        """Id of the face-neighbor along ``axis`` (+1 / -1), or None at the border."""
        pos = list(self.block_grid_position(block_id))
        pos[axis] += direction
        if not 0 <= pos[axis] < self.grid_shape[axis]:
            return None
        return self.grid_position_to_id(pos)

    # -- block lists ------------------------------------------------------

    def blocks_in_roi(self, roi_begin: Sequence[int], roi_end: Sequence[int]) -> List[int]:
        """All block ids whose block intersects [roi_begin, roi_end) (reference:
        utils/volume_utils.py:52-88 blocks_in_volume with roi restriction)."""
        lo = [max(rb, 0) // b for rb, b in zip(roi_begin, self.block_shape)]
        hi = [
            min((re + b - 1) // b, g)
            for re, b, g in zip(roi_end, self.block_shape, self.grid_shape)
        ]
        ids = []
        for pos in product(*[range(l, h) for l, h in zip(lo, hi)]):
            ids.append(self.grid_position_to_id(pos))
        return ids

    def checkerboard(self) -> Tuple[List[int], List[int]]:
        """2-color the block grid for conflict-free two-pass updates (reference:
        utils/volume_utils.py:142-205 make_checkerboard_block_lists)."""
        colors: Tuple[List[int], List[int]] = ([], [])
        for bid in range(self.n_blocks):
            parity = sum(self.block_grid_position(bid)) % 2
            colors[parity].append(bid)
        return colors


def blocks_in_volume(
    shape: Sequence[int],
    block_shape: Sequence[int],
    roi_begin: Optional[Sequence[int]] = None,
    roi_end: Optional[Sequence[int]] = None,
    block_list_path: Optional[str] = None,
) -> List[int]:
    """List of block ids to process; semantics of the reference's
    blocks_in_volume (utils/volume_utils.py:52-88): full grid, optionally
    restricted to an ROI, optionally intersected with an explicit block-list
    file (as written by the masking component)."""
    blocking = Blocking(shape, block_shape)
    if (roi_begin is None) != (roi_end is None):
        raise ValueError("roi_begin and roi_end must be given together")
    if roi_begin is not None:
        roi_begin = [0 if rb is None else int(rb) for rb in roi_begin]
        roi_end = [
            s if re is None else min(int(re), s)
            for re, s in zip(roi_end, shape)
        ]
        block_ids = blocking.blocks_in_roi(roi_begin, roi_end)
    else:
        block_ids = list(range(blocking.n_blocks))

    if block_list_path is not None:
        if not os.path.exists(block_list_path):
            raise FileNotFoundError(
                f"block_list_path {block_list_path} is configured but does "
                "not exist — refusing to silently process all blocks")
        with open(block_list_path) as f:
            allowed = set(json.load(f))
        block_ids = [bid for bid in block_ids if bid in allowed]
    return block_ids


def block_to_bb(block: Block) -> BB:
    """Block -> numpy slice tuple (reference: utils/volume_utils.py:91)."""
    return block.bb


@dataclass(frozen=True)
class Face:
    """Overlap region between two axis-neighboring blocks (reference:
    utils/volume_utils.py:221-270 get_face / iterate_faces)."""

    block_a: int
    block_b: int
    axis: int
    #: bounding box of the face region, `2*halo` thick along `axis`
    outer_bb: BB
    #: the two halves of the face, in face-local coordinates
    face_a: BB
    face_b: BB


def iterate_faces(
    blocking: Blocking,
    block_id: int,
    halo: Sequence[int],
    return_only_lower: bool = True,
) -> Iterator[Face]:
    """Iterate the faces between ``block_id`` and its axis neighbors.

    For each axis where a neighbor exists, yields the bounding box that spans
    ``halo[axis]`` voxels into each of the two blocks, plus face-local slices
    selecting each half.  ``return_only_lower`` yields only faces to the
    lower-id (preceding) neighbor so each face is visited once globally —
    matching the reference's iterate_faces contract.
    """
    block = blocking.get_block(block_id)
    ndim = blocking.ndim
    for axis in range(ndim):
        directions = [-1] if return_only_lower else [-1, 1]
        for direction in directions:
            nid = blocking.neighbor_id(block_id, axis, direction)
            if nid is None:
                continue
            h = int(halo[axis])
            boundary = block.begin[axis] if direction == -1 else block.end[axis]
            # clip to the volume so thin border blocks don't overflow
            lo_edge = max(boundary - h, 0)
            hi_edge = min(boundary + h, blocking.shape[axis])
            lo_extent = boundary - lo_edge
            outer_bb = []
            for d in range(ndim):
                if d == axis:
                    outer_bb.append(slice(lo_edge, hi_edge))
                else:
                    outer_bb.append(slice(block.begin[d], block.end[d]))
            face_lo = tuple(
                slice(0, lo_extent) if d == axis else slice(None)
                for d in range(ndim)
            )
            face_hi = tuple(
                slice(lo_extent, hi_edge - lo_edge) if d == axis else slice(None)
                for d in range(ndim)
            )
            if direction == -1:
                yield Face(
                    block_a=nid, block_b=block_id, axis=axis,
                    outer_bb=tuple(outer_bb), face_a=face_lo, face_b=face_hi,
                )
            else:
                yield Face(
                    block_a=block_id, block_b=nid, axis=axis,
                    outer_bb=tuple(outer_bb), face_a=face_lo, face_b=face_hi,
                )
