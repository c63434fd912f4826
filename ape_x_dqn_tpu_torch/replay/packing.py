"""Byte-row sizing and in-place ring writes for device replay.

Counterpart of the ring-write helpers of ``ape_x_dqn_tpu/replay/
packing.py`` (the PixelPacker and the cold-store helpers wait for their
slices). Pixel rows keep the JAX package's 128-byte padding, so a frame
row is ``pad128(H*W)`` bytes in both packages (7168 for 84x84); on the
H100 that also keeps every row 16-byte aligned for the gather kernel.

Ring writes are contiguous blocks with SKIP-TO-HEAD wrap: a block that
would cross the ring boundary is written at slot 0 instead, and the
filled count grows as min(max(size, start + block), capacity) so
never-written tail slots are never counted as filled. Cursors are host
Python ints: only host calls advance them, so reading them costs no
device sync.
"""

from __future__ import annotations

import torch

LANE = 128


def pad128(n: int) -> int:
    """Round up to the 128-byte row tile."""
    return -(-int(n) // LANE) * LANE


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
