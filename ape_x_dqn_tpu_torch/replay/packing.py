"""Byte-row packing and in-place ring writes for device replay.

Counterpart of ``ape_x_dqn_tpu/replay/packing.py`` (the cold-store
helpers wait for the tiers' slice). Pixel rows keep the JAX package's
128-byte padding, so a frame row is ``pad128(H*W)`` bytes in both
packages (7168 for 84x84, 28,288 for a flat 84x84x4 stack); on the H100
that also keeps every row 16-byte aligned for the gather kernel.

`PixelPacker` stores each large uint8 leaf of a flat transition (the
``obs`` and ``next_obs`` stacks) as ONE byte row: `encode` flattens and
zero-pads a block to rows before the ring write, and `decode` turns a
gathered ``[b, row]`` batch back into frames as a trim-and-reshape view.
Items are flat dicts, walked in sorted key order (the order
``jax.tree`` flattens a dict in), so leaf plans line up with the
original's.

Ring writes are contiguous blocks with SKIP-TO-HEAD wrap: a block that
would cross the ring boundary is written at slot 0 instead, and the
filled count grows as min(max(size, start + block), capacity) so
never-written tail slots are never counted as filled. Cursors are host
Python ints: only host calls advance them, so reading them costs no
device sync.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

LANE = 128


class ItemSpec(NamedTuple):
    """Shape and dtype of ONE item's leaf (the port's counterpart of
    ``jax.ShapeDtypeStruct``)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def torch_dtype(dtype) -> torch.dtype:
    """A numpy dtype (or anything numpy names) -> the torch dtype."""
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def pad128(n: int) -> int:
    """Round up to the 128-byte row tile."""
    return -(-int(n) // LANE) * LANE


def frame_mode(storage: str, obs_shape: tuple[int, ...]) -> bool:
    """The single-frame-storage predicate: frame mode applies to
    [H, W, stack] pixel observations under frame_ring storage
    (replay/frame_ring.py aliases it as `frame_ring_mode`)."""
    return storage == "frame_ring" and len(obs_shape) == 3


def ring_write_start(pos: int, block: int, capacity: int) -> int:
    """Start slot for a contiguous ring write (skip-to-head)."""
    if block > capacity:
        raise ValueError(f"block {block} exceeds capacity {capacity}")
    return pos if pos + block <= capacity else 0


def ring_write_size(size: int, start: int, block: int,
                    capacity: int) -> int:
    """Filled-slot count after a skip-to-head ring write."""
    return min(max(size, start + block), capacity)


def dus_rows(buf: torch.Tensor, block: torch.Tensor,
             start: int) -> torch.Tensor:
    """Write `block` into rows [start, start + len(block)) of `buf`, IN
    PLACE (the JAX version's dynamic_update_slice returns a new array).
    Returns `buf`."""
    buf[start:start + block.shape[0]].copy_(block)
    return buf


def packable(spec: ItemSpec) -> bool:
    """Pack uint8 pixel leaves big enough that row padding matters.
    Small leaves (scalars, action vectors) stay in their natural
    layout."""
    return (spec.dtype == torch.uint8 and len(spec.shape) >= 2
            and math.prod(spec.shape) >= 4096)


class PixelPacker:
    """Per-leaf codec: pixel frames <-> byte rows.

    Built from an item spec ({key: ItemSpec} for ONE item).
    `storage_spec` rewrites packable leaves to [pad128(nbytes)] uint8
    rows; `encode` flattens and zero-pads an incoming [*lead, ...] block
    to row form; `decode` restores a gathered [*lead, row] batch to the
    original frame shape as a view (trim and reshape copy nothing)."""

    def __init__(self, item_spec: dict[str, ItemSpec]):
        # per leaf: None | (orig_shape, nbytes, row)
        self._plan: dict[str, tuple | None] = {}
        for key in sorted(item_spec):
            leaf = item_spec[key]
            if packable(leaf):
                nbytes = math.prod(leaf.shape)
                self._plan[key] = (tuple(leaf.shape), nbytes, pad128(nbytes))
            else:
                self._plan[key] = None

    @property
    def packs_anything(self) -> bool:
        return any(p is not None for p in self._plan.values())

    def packed(self, key: str) -> bool:
        """True where the leaf is stored as byte rows."""
        return self._plan[key] is not None

    def storage_spec(self, item_spec: dict[str, ItemSpec]
                     ) -> dict[str, ItemSpec]:
        return {key: item_spec[key] if plan is None
                else ItemSpec((plan[2],), torch.uint8)
                for key, plan in self._plan.items()}

    def encode(self, items: dict) -> dict:
        """[*lead, *orig] leaves -> [*lead, row] byte rows (zero pad)."""
        out = {}
        for key, plan in self._plan.items():
            leaf = items[key]
            if plan is not None:
                shape, nbytes, row = plan
                lead = leaf.shape[:leaf.dim() - len(shape)]
                leaf = leaf.reshape(*lead, nbytes)
                if row != nbytes:
                    leaf = F.pad(leaf, (0, row - nbytes))
            out[key] = leaf
        return out

    def decode(self, items: dict) -> dict:
        """Gathered [*lead, row] byte rows -> [*lead, *orig] frames."""
        out = {}
        for key, plan in self._plan.items():
            leaf = items[key]
            if plan is not None:
                shape, nbytes, _ = plan
                leaf = leaf[..., :nbytes].reshape(*leaf.shape[:-1], *shape)
            out[key] = leaf
        return out


def make_packer(item_spec: dict[str, ItemSpec]
                ) -> tuple[PixelPacker | None, dict[str, ItemSpec]]:
    """-> (packer or None, storage spec): the one place the packing
    decision is made, shared by every flat replay class."""
    packer = PixelPacker(item_spec)
    if packer.packs_anything:
        return packer, packer.storage_spec(item_spec)
    return None, {k: item_spec[k] for k in sorted(item_spec)}
