"""Byte-row packing and in-place ring writes for device replay.

Counterpart of ``ape_x_dqn_tpu/replay/packing.py``. Pixel rows keep the JAX package's
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

The cold-segment codec (`cold_plan`, `cold_pack`, `cold_unpack`) turns
one eviction region of the tiered cold store (replay/cold_store.py)
into one host byte string and back: host numpy and zlib, with the
XOR-delta rows of comm/native.py. Its bytes are the original's for the
same region.
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


def numpy_dtype(dtype) -> np.dtype:
    """A torch dtype, or anything numpy names -> the numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.zeros(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


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


def shard_rows(starts: torch.Tensor, n: int,
               rows_per_shard: int) -> torch.Tensor:
    """Rows [starts[d], starts[d] + n) of every shard d, as indices into
    the shard-major flat view [dp * rows_per_shard, ...] of a [dp,
    rows_per_shard, ...] buffer: [dp * n] int64, shard by shard."""
    dev = starts.device
    first = starts.long() + torch.arange(
        starts.shape[0], device=dev) * rows_per_shard
    return (first[:, None] + torch.arange(n, device=dev)).reshape(-1)


def dus_rows_per_shard(buf: torch.Tensor, block: torch.Tensor,
                       starts: torch.Tensor) -> None:
    """Per-shard ring write, IN PLACE: shard d of a [dp, rows, ...]
    buffer gets block[d] ([dp, b, ...]) at row starts[d] (a [dp] device
    tensor), through one `index_copy_` on the buffer's flat view for
    every shard (the original writes dp unrolled dynamic_update_slices).
    A lockstep add passes equal starts; the cold tier's directed add
    each shard's own."""
    dp, rows = buf.shape[:2]
    b = block.shape[1]
    buf.flatten(0, 1).index_copy_(
        0, shard_rows(starts, b, rows),
        block.reshape(dp * b, *block.shape[2:]).to(buf.device, buf.dtype))


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


# -- cold-segment serialization (replay/cold_store.py) ----------------------
#
# A cold segment is one eviction region (`n` staging units of the item
# spec plus their stored priorities) flattened to ONE host byte string:
# per leaf, XOR-delta rows (uint8 pixel leaves, through comm/native.py)
# and zlib deflate, framed with pack_records. A 1-byte mode prefix per
# leaf records what was applied, with a per-leaf never-inflate guard: a
# leaf that deflate would grow is stored raw (mode 0), so a payload can
# exceed its raw bytes only by the framing (9 bytes a leaf). Round trips
# are bitwise in every mode.

_COLD_RAW = 0        # leaf bytes verbatim
_COLD_DEFLATE = 1    # zlib only
_COLD_DELTA = 2      # XOR-delta rows, then zlib


def cold_plan(item_spec: dict, ptail: tuple = ()) -> list[tuple]:
    """Per-leaf serialization plan for one staging unit: [(key, shape,
    numpy dtype, delta_rows)]. delta_rows is the per-unit leading axis
    the XOR delta runs over (the frames of a segment, the image rows of
    a stacked obs), 0 for the other leaves. "priorities" (trailing shape
    `ptail`, float32) comes last: it rides every segment so a recall
    restages at its eviction-time priority mass. Leaves in the item
    spec's order (the staging layout's)."""
    plan = []
    entries = [(k, tuple(s.shape), numpy_dtype(s.dtype))
               for k, s in item_spec.items()]
    entries.append(("priorities", tuple(ptail), np.dtype(np.float32)))
    for key, shape, dtype in entries:
        unit_bytes = math.prod(shape) * dtype.itemsize if shape \
            else dtype.itemsize
        delta_rows = (int(shape[0])
                      if (dtype == np.uint8 and len(shape) >= 2
                          and unit_bytes >= 4096) else 0)
        plan.append((key, shape, dtype, delta_rows))
    return plan


def cold_pack(items: dict, plan: list[tuple],
              level: int = 1) -> tuple[bytes, int]:
    """{key: [n, *shape] host arrays} -> (payload, raw_bytes), following
    `plan` (host numpy, zlib and the comm/native.py delta rows)."""
    import zlib

    from ape_x_dqn_tpu_torch.comm.native import delta_encode, pack_records

    chunks = []
    raw_total = 0
    for key, shape, dtype, delta_rows in plan:
        a = np.ascontiguousarray(np.asarray(items[key], dtype=dtype))
        raw_total += a.nbytes
        if delta_rows:
            n = a.shape[0]
            body = zlib.compress(
                delta_encode(a.reshape(n * delta_rows, -1)), level)
            mode = _COLD_DELTA
        else:
            body = zlib.compress(a.tobytes(), level)
            mode = _COLD_DEFLATE
        if len(body) >= a.nbytes:  # never-inflate guard (per leaf)
            body, mode = a.tobytes(), _COLD_RAW
        chunks.append(bytes([mode]) + body)
    return pack_records(chunks), raw_total


def cold_unpack(payload: bytes, plan: list[tuple], n: int) -> dict:
    """Inverse of cold_pack: payload -> {key: [n, *shape] arrays},
    bitwise what went in (maybe read-only views over the decompressed
    bytes)."""
    import zlib

    from ape_x_dqn_tpu_torch.comm.native import (delta_undo_inplace,
                                                 unpack_records)

    recs = unpack_records(payload, max_records=len(plan) + 1)
    if len(recs) != len(plan):
        raise ValueError(
            f"cold segment holds {len(recs)} leaves, plan expects "
            f"{len(plan)}: segment written under a different item spec")
    out = {}
    for (key, shape, dtype, delta_rows), rec in zip(plan, recs):
        mode, body = rec[0], rec[1:]
        if mode == _COLD_RAW:
            raw = body
        elif mode == _COLD_DEFLATE:
            raw = zlib.decompress(body)
        elif mode == _COLD_DELTA:
            rows = np.frombuffer(zlib.decompress(body), np.uint8) \
                .reshape(n * delta_rows, -1).copy()
            delta_undo_inplace(rows)
            raw = rows
        else:
            raise ValueError(f"unknown cold leaf mode {mode}")
        buf = raw.tobytes() if isinstance(raw, np.ndarray) else raw
        out[key] = np.frombuffer(buf, dtype=dtype).reshape((n, *shape))
    return out
