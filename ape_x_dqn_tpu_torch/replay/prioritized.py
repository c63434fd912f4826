"""Device-resident prioritized replay: the sampling and priority half.

Counterpart of ``ape_x_dqn_tpu/replay/prioritized.py``. Storage and the
sum-tree live on the device; the write cursor `pos` and the filled count
`size` are host Python ints, advanced only by host calls, so reading
them costs no device sync. Each has a 0-dim device mirror (`pos_dev`,
`size_dev`) that every assignment refreshes with an in-place `fill_`
(no sync): the sampling half reads only the mirrors, so a captured CUDA
graph sees the replay as it is when the graph replays, not as it was
when the graph was captured. Unlike the JAX version, which returns new
state, `add` and the priority updates write the state IN PLACE, never
reallocating storage or tree, and return it.

An add is split the same way: `add_body` writes the rows, the leaves
and the tree at the DEVICE cursor and advances the device mirrors, with
device operations only (the ingest add's captured graph,
runtime/step_graph.py: AddGraph), and `advance_host` moves the host ints
by the block size the caller knows. `add` is the two in order.

The tiered cold store (replay/cold_store.py) composes three more: the
start of the ring's lowest-priority-mass region (`evict_plan`), that
region in staging layout with its stored leaf priorities
(`read_region`), and a DIRECTED add over exactly that region (`add_at`:
`add_body` with a device `start`, after which the cursor resumes behind
the region, as in the original). With the tier off none of them runs.

Conventions (Schaul et al. 2016; Horgan et al. 2018):
- stored priority = (|td| + eps)^alpha  (alpha applied at write time)
- IS weight w_i = (N * P(i))^-beta, normalized by max over the batch
- new transitions arrive WITH priorities

The dp-sharded learner (parallel/dist_learner.py) keeps `dp` shards
stacked on a leading axis of every tensor, as the original's
`DistTrainState` does: `init_sharded` makes a `ShardedReplayState`
(storage [dp, capacity, ...], tree [dp, 2*capacity], a cursor and a
fill per shard). The same methods then work per shard over that axis:
`add_lockstep` writes equal [dp, B] blocks at every shard's (equal)
cursor, `add_at_lockstep` each shard's block at its own start, and the
sampling half draws [dp, n] with one descent and ONE gather launch over
the shard-major flat view [dp * capacity, row] of the stacked storage
(index d * capacity + i). `capacity` stays the per-shard capacity.

Two layouts share the sampling and priority half: flat storage
(`PrioritizedReplay` itself: one slot per transition, pixel leaves
packed into byte rows by replay/packing.py and gathered by the
hand-written row-gather kernel, ops/frame_gather.py) and the frame ring
(replay/frame_ring.py). `UniformReplayDevice` is the uniform ring over
the same flat storage.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ape_x_dqn_tpu_torch.ops import sum_tree
from ape_x_dqn_tpu_torch.ops.frame_gather import gather_rows
from ape_x_dqn_tpu_torch.replay.packing import (PixelPacker,
                                                dus_rows_per_shard,
                                                make_packer,
                                                ring_write_size,
                                                ring_write_start,
                                                shard_rows)
from ape_x_dqn_tpu_torch.utils.misc import resolve_device


class ReplayState:
    """storage: per-slot tensors; tree: the (2*capacity,) sum-tree of
    p^alpha; pos: the next write cursor; size: the filled slots. `pos`
    and `size` are host ints whose setters also write their 0-dim int64
    device mirrors `pos_dev` and `size_dev` in place (the tensors keep
    their addresses for the life of the state)."""

    def __init__(self, storage: dict[str, torch.Tensor],
                 tree: torch.Tensor, pos: int = 0, size: int = 0):
        self.storage = storage
        self.tree = tree
        self.pos_dev = torch.zeros((), dtype=torch.int64, device=tree.device)
        self.size_dev = torch.zeros((), dtype=torch.int64,
                                    device=tree.device)
        self.pos = pos
        self.size = size

    @property
    def pos(self) -> int:
        return self._pos

    @pos.setter
    def pos(self, value: int) -> None:
        self._pos = int(value)
        self.pos_dev.fill_(self._pos)

    @property
    def size(self) -> int:
        return self._size

    @size.setter
    def size(self, value: int) -> None:
        self._size = int(value)
        self.size_dev.fill_(self._size)

    def set_host_cursor(self, pos: int, size: int) -> None:
        """Move the host ints alone: an add body already wrote the
        device mirrors (on its stream, maybe inside a graph)."""
        self._pos, self._size = int(pos), int(size)

    def cursors(self) -> list[tuple[int, int]]:
        """[(pos, size)] per shard (one shard)."""
        return [(self._pos, self._size)]

    def set_cursors(self, cursors: list[tuple[int, int]]) -> None:
        """`set_host_cursor` from `cursors()`'s form."""
        (pos, size), = cursors
        self.set_host_cursor(pos, size)


class ShardedReplayState(ReplayState):
    """dp replay shards stacked on a leading axis: storage [dp, rows,
    ...], tree [dp, 2*capacity], and per shard a write cursor and a
    fill: host int64 arrays `pos` and `size` [dp] whose setters write
    their device mirrors `pos_dev` and `size_dev` [dp] in place.
    Lockstep adds keep every shard's cursor equal; the cold tier's
    directed writes move each shard's own."""

    def __init__(self, storage: dict[str, torch.Tensor],
                 tree: torch.Tensor):
        self.storage = storage
        self.tree = tree
        dp = tree.shape[0]
        self.pos_dev = torch.zeros(dp, dtype=torch.int64, device=tree.device)
        self.size_dev = torch.zeros(dp, dtype=torch.int64,
                                    device=tree.device)
        self.pos = 0
        self.size = 0

    @property
    def dp(self) -> int:
        return self.tree.shape[0]

    def _ints(self, value) -> np.ndarray:
        return np.broadcast_to(np.asarray(value, np.int64),
                               (self.dp,)).copy()

    @property
    def pos(self) -> np.ndarray:
        return self._pos

    @pos.setter
    def pos(self, value) -> None:
        self._pos = self._ints(value)
        self.pos_dev.copy_(torch.from_numpy(self._pos))

    @property
    def size(self) -> np.ndarray:
        return self._size

    @size.setter
    def size(self, value) -> None:
        self._size = self._ints(value)
        self.size_dev.copy_(torch.from_numpy(self._size))

    def set_host_cursor(self, pos, size) -> None:
        self._pos, self._size = self._ints(pos), self._ints(size)

    def cursors(self) -> list[tuple[int, int]]:
        return list(zip(self._pos.tolist(), self._size.tolist()))

    def set_cursors(self, cursors: list[tuple[int, int]]) -> None:
        pos, size = zip(*cursors)
        self.set_host_cursor(pos, size)

    def flat_storage(self) -> dict[str, torch.Tensor]:
        """Each leaf's shard-major flat view [dp * rows, ...]: shard d's
        row i is row d * rows + i (views: writes reach the shards)."""
        return {k: v.flatten(0, 1) for k, v in self.storage.items()}


def sharded(state: ReplayState) -> bool:
    return isinstance(state, ShardedReplayState)


def flat_index(idx: torch.Tensor, rows_per_shard: int) -> torch.Tensor:
    """Per-shard slot indices [dp, n] -> rows of the shard-major flat
    view (`ShardedReplayState.flat_storage`), [dp * n] int64."""
    dp = idx.shape[0]
    off = torch.arange(dp, device=idx.device)[:, None] * rows_per_shard
    return (idx.long() + off).reshape(-1)


def ring_cursor(pos: int, size: int, block: int, capacity: int,
                size_scale: int = 1) -> tuple[int, int, int]:
    """Skip-to-head cursor math shared by every ring layout:
    -> (start, new_pos, new_size). `size_scale` converts cursor units
    to size units (the frame ring's cursor counts segments while its
    size counts transitions)."""
    start = ring_write_start(pos, block, capacity)
    pos1 = (start + block) % capacity
    size1 = ring_write_size(size, start * size_scale, block * size_scale,
                            capacity * size_scale)
    return start, pos1, size1


def ring_cursor_dev(state: ReplayState, block: int, capacity: int,
                    size_scale: int = 1,
                    start: torch.Tensor | None = None) -> torch.Tensor:
    """The device twin of `ring_cursor`, read from and written to the
    device mirrors: -> the block's start (0-dim int64, skip-to-head),
    and `pos_dev`/`size_dev` advanced in place. No host value is read,
    so a captured graph writes where the cursor is when it replays.
    A device `start` directs the write there instead (an `evict_plan`
    result): the cursor then resumes after the block."""
    pos, size = state.pos_dev, state.size_dev
    if start is None:
        start = torch.where(pos + block <= capacity, pos,
                            torch.zeros_like(pos))
    else:
        start = start.to(pos.dtype)
    end = start + block
    size1 = torch.clamp(torch.maximum(size, end * size_scale),
                        max=capacity * size_scale)
    pos.copy_(torch.remainder(end, capacity))
    size.copy_(size1)
    return start


def ring_cursor_at(size: int, start: int, block: int, capacity: int,
                   size_scale: int = 1) -> tuple[int, int]:
    """The host cursor after a DIRECTED write of `block` units at
    `start`: -> (new_pos, new_size)."""
    return ((start + block) % capacity,
            ring_write_size(size, start * size_scale, block * size_scale,
                            capacity * size_scale))


def min_mass_window(mass: torch.Tensor, block: int) -> torch.Tensor:
    """Start of the `block`-long contiguous window of `mass` with the
    least sum (a float32 cumsum, then the first argmin over [0,
    len - block]: the window never wraps). 0-dim int64, on the device;
    [dp] for stacked shards' masses [dp, len], one start per shard."""
    zero = torch.zeros((*mass.shape[:-1], 1), dtype=mass.dtype,
                       device=mass.device)
    c = torch.cat([zero, torch.cumsum(mass, -1)], -1)
    return torch.argmin(c[..., block:] - c[..., :-block], dim=-1)


def write_rows_at(buf: torch.Tensor, block: torch.Tensor,
                  start: torch.Tensor) -> None:
    """Rows [start, start + len(block)) of `buf` <- `block`, IN PLACE
    (the JAX version's dynamic_update_slice returns a new array), with
    `start` a device scalar; a [dp] `start` writes stacked shards
    (packing.dus_rows_per_shard)."""
    if start.dim():
        dus_rows_per_shard(buf, block, start)
        return
    idx = start + torch.arange(block.shape[0], device=buf.device)
    buf.index_copy_(0, idx, block.to(buf.device, buf.dtype))


class _FlatStorage:
    """Flat per-slot storage shared by `PrioritizedReplay` and
    `UniformReplayDevice`: the packer is built from the item spec, given
    to the constructor or to `init` (with neither, `init` raises)."""

    capacity: int
    device: torch.device
    _packer: PixelPacker | None = None
    _storage_spec: dict | None = None

    def _set_item_spec(self, item_spec: Any) -> None:
        self._packer, self._storage_spec = make_packer(item_spec)

    def _init_storage(self, item_spec: Any,
                      lead: tuple = ()) -> dict[str, torch.Tensor]:
        if item_spec is not None:
            self._set_item_spec(item_spec)
        if self._storage_spec is None:
            raise ValueError(
                f"{type(self).__name__} has no item spec — pass item_spec "
                f"to the constructor or to init()")
        return {k: torch.zeros((*lead, self.capacity, *s.shape),
                               dtype=s.dtype, device=self.device)
                for k, s in self._storage_spec.items()}

    def _write_rows(self, storage: dict, items: dict,
                    start: torch.Tensor) -> None:
        """Encode a [b, ...] block and write it at slot `start` (a
        device scalar), in place (host tensors are copied to the
        storage's device); stacked shards: [dp, b, ...] at [dp]
        starts."""
        if self._packer is not None:
            items = self._packer.encode(items)
        for k, buf in storage.items():
            write_rows_at(buf, items[k], start)

    def advance_host(self, state: ReplayState, block: int) -> None:
        """The host ints after one add of `block` slots per shard
        (`add_body` moved the device mirrors)."""
        state.set_cursors([ring_cursor(p, s, block, self.capacity)[1:]
                           for p, s in state.cursors()])

    def advance_host_at(self, state: ReplayState, start,
                        block: int) -> None:
        """The host ints after a directed add of `block` slots at
        `start` (an int, or one per shard) (`add_body` with a `start`
        moved the device mirrors)."""
        starts = np.broadcast_to(np.asarray(start, np.int64),
                                 (len(state.cursors()),))
        state.set_cursors([ring_cursor_at(s, int(st), block, self.capacity)
                           for (_, s), st in zip(state.cursors(), starts)])

    def init_sharded(self, dp: int, item_spec: Any = None
                     ) -> ShardedReplayState:
        """dp empty shards of `capacity` slots each, stacked."""
        return ShardedReplayState(
            storage=self._init_storage(item_spec, lead=(dp,)),
            tree=torch.zeros((dp, 2 * self.capacity), dtype=torch.float32,
                             device=self.device))

    def add_lockstep(self, state: ShardedReplayState, items: Any,
                     td_abs: torch.Tensor) -> ShardedReplayState:
        """`add` for stacked shards whose cursors advance in LOCKSTEP
        (the dist ingest contract: every add ships equal [dp, B] blocks,
        so the shard cursors stay equal). items {key: [dp, B, ...]};
        td_abs [dp, B] ([dp, G, B] segments on the frame ring)."""
        b = td_abs.shape[1]
        ring_write_start(int(state.pos[0]), b, self._ring_slots())
        self.add_body(state, items, td_abs)
        self.advance_host(state, b)
        return state

    def add_at_lockstep(self, state: ShardedReplayState, items: Any,
                        td_abs: torch.Tensor,
                        start) -> ShardedReplayState:
        """Directed `add_lockstep`: shard d gets items[d] at start[d]
        (its own evict_plan result). The shard cursors diverge here,
        which is safe because the swap runs only on a full ring: every
        later ship comes back through evict_plan and this add."""
        start_dev = torch.as_tensor(np.asarray(start), dtype=torch.int64,
                                    device=state.tree.device)
        self.add_body(state, items, td_abs, start_dev)
        self.advance_host_at(state, np.asarray(start), td_abs.shape[1])
        return state

    def _ring_slots(self) -> int:
        """The ring's cursor units (slots; the frame ring's segments)."""
        return self.capacity

    def _gather(self, storage: dict, idx: torch.Tensor) -> dict:
        """Items at slots idx [B]: packed byte-row leaves through the
        row-gather kernel (one launch each), the others by indexing;
        then decoded back to frames (a view)."""
        packer = self._packer
        items = {k: gather_rows(buf, idx)
                 if packer is not None and packer.packed(k) else buf[idx]
                 for k, buf in storage.items()}
        return packer.decode(items) if packer is not None else items

    def _gather_sharded(self, state: ShardedReplayState,
                        idx: torch.Tensor) -> dict:
        """Items at per-shard slots idx [dp, n] -> {key: [dp, n, ...]}:
        ONE gather launch per packed leaf over the stacked storage's
        flat view, at int64 rows d * capacity + i."""
        dp, n = idx.shape
        items = self._gather(state.flat_storage(),
                             flat_index(idx, self.capacity))
        return {k: v.reshape(dp, n, *v.shape[1:]) for k, v in items.items()}


class PrioritizedReplay(_FlatStorage):
    """Static config + state-transition functions over a ReplayState, in
    the flat layout: one slot per transition. Pixel leaves are stored as
    byte rows and ring writes are contiguous in-place blocks with
    skip-to-head wrap (replay/packing.py)."""

    # capability flag read by the learner's replay-health diagnostics
    has_priorities = True

    def __init__(self, capacity: int, alpha: float = 0.6,
                 beta: float = 0.4, eps: float = 1e-6,
                 device: str | torch.device = "cuda",
                 item_spec: Any = None):
        if not (capacity > 0 and (capacity & (capacity - 1)) == 0):
            raise ValueError("capacity must be a power of two")
        self.capacity = capacity
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        self.device = resolve_device(device)
        if item_spec is not None:
            self._set_item_spec(item_spec)

    # -- state construction ------------------------------------------------

    def init(self, item_spec: Any = None) -> ReplayState:
        """item_spec: {key: ItemSpec} for ONE item (replay/packing.py).
        Optional when the constructor already received it."""
        return ReplayState(storage=self._init_storage(item_spec),
                           tree=sum_tree.init(self.capacity, self.device),
                           pos=0, size=0)

    # -- transitions -------------------------------------------------------

    def add_body(self, state: ReplayState, items: Any,
                 td_abs: torch.Tensor,
                 start: torch.Tensor | None = None) -> None:
        """One contiguous block per leaf at the DEVICE cursor with
        skip-to-head wrap, the tree write-back and the device cursor
        advance, in place and with device operations only. A block size
        that does not divide the capacity retires the tail slots a skip
        leaves behind: `size` never counts them and the tree never
        carries priority there. A device `start` (0-dim) directs the
        block there instead (`add_at`). Stacked shards: items [dp, B,
        ...] and td_abs [dp, B] at every shard's device cursor, or at a
        [dp] `start`."""
        b = td_abs.shape[-1]
        start = ring_cursor_dev(state, b, self.capacity, start=start)
        self._write_rows(state.storage, items, start)
        dev = state.tree.device
        # [b], or [dp, b] at stacked shards' [dp] starts
        idx = start[..., None] + torch.arange(b, device=dev)
        pri = (td_abs.to(dev, torch.float32) + self.eps) ** self.alpha
        sum_tree.update(state.tree, idx, pri)

    def add(self, state: ReplayState, items: Any,
            td_abs: torch.Tensor) -> ReplayState:
        """Append a batch of items with initial |TD| priorities, in place.

        items: {key: [B, ...]}; td_abs: [B]. Overwrites FIFO when full;
        a block that would cross the ring boundary is written at slot 0
        instead (skip-to-head)."""
        ring_write_start(state.pos, td_abs.shape[0], self.capacity)
        self.add_body(state, items, td_abs)
        self.advance_host(state, td_abs.shape[0])
        return state

    # -- tiered cold store hooks (replay/cold_store.py) ---------------------

    def evict_plan(self, state: ReplayState, block: int) -> torch.Tensor:
        """Start slot (0-dim int64, on the device) of the minimum-
        priority-mass contiguous `block`-slot window; [dp] starts, one
        per stacked shard, each planned on its own tree."""
        return min_mass_window(state.tree[..., self.capacity:], block)

    def read_region(self, state: ReplayState, start: torch.Tensor,
                    block: int) -> tuple[dict, torch.Tensor]:
        """-> (items [block, ...] in staging layout, stored leaf
        priorities [block]) of the `block` slots at the device `start`,
        as fresh tensors; stacked shards: [dp, block, ...] from [dp]
        starts."""
        if start.dim():
            dp = start.shape[0]
            rows = shard_rows(start, block, self.capacity)
            items = {k: buf.index_select(0, rows).reshape(
                         dp, block, *buf.shape[1:])
                     for k, buf in state.flat_storage().items()}
            if self._packer is not None:
                items = self._packer.decode(items)
            leaves = shard_rows(start + self.capacity, block,
                                2 * self.capacity)
            return items, state.tree.view(-1).index_select(
                0, leaves).reshape(dp, block)
        idx = start + torch.arange(block, device=state.tree.device)
        items = {k: buf.index_select(0, idx)
                 for k, buf in state.storage.items()}
        if self._packer is not None:
            items = self._packer.decode(items)
        return items, state.tree.index_select(0, self.capacity + idx)

    def add_at(self, state: ReplayState, items: Any, td_abs: torch.Tensor,
               start: torch.Tensor | int) -> ReplayState:
        """Directed `add`: overwrite the `B` slots at `start` (an
        evict_plan result) instead of the FIFO cursor position."""
        start_dev = torch.as_tensor(start, dtype=torch.int64,
                                    device=state.tree.device)
        self.add_body(state, items, td_abs, start=start_dev)
        self.advance_host_at(state, int(start), td_abs.shape[0])
        return state

    def draw(self, state: ReplayState, batch: int,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """The stratification noise of one draw ([batch] uniform; [dp,
        batch] for stacked shards), from `generator`: the learner draws
        it before a step, outside any captured graph, and hands it in
        as `noise`."""
        lead = (state.dp,) if sharded(state) else ()
        return torch.rand((*lead, batch), generator=generator,
                          device=self.device)

    def sample_items(self, state: ReplayState, batch: int,
                     noise: torch.Tensor | None = None,
                     generator: torch.Generator | None = None
                     ) -> tuple[Any, torch.Tensor, torch.Tensor]:
        """-> (item batch, leaf indices [B], probs [B]), without IS
        weights (the frame ring shares this calling convention). Stacked
        shards: [dp, B] from noise [dp, B], probs within each shard (the
        dist learner weighs them across shards)."""
        idx, probs = sum_tree.sample(state.tree, batch,
                                     size=state.size_dev, noise=noise,
                                     generator=generator)
        if sharded(state):
            return self._gather_sharded(state, idx), idx, probs
        return self._gather(state.storage, idx), idx, probs

    def sample(self, state: ReplayState, batch: int,
               noise: torch.Tensor | None = None,
               generator: torch.Generator | None = None
               ) -> tuple[Any, torch.Tensor, torch.Tensor]:
        """-> (item batch, leaf indices [B], IS weights [B]).

        valid_mask zeroes the weight of dead slots BEFORE
        max-normalization (a ~zero-probability dead draw would otherwise
        become the max and crush every live weight). `noise` /
        `generator`: see ops/sum_tree.py `sample`."""
        items, idx, probs = self.sample_items(state, batch, noise,
                                              generator)
        n = torch.clamp(state.size_dev, min=1).to(torch.float32)
        w = (n * torch.clamp(probs, min=1e-12)) ** (-self.beta)
        w = w * self.valid_mask(state, idx)
        w = w / torch.clamp(w.max(), min=1e-12)
        return items, idx, w

    def update_priorities(self, state: ReplayState, idx: torch.Tensor,
                          td_abs: torch.Tensor) -> ReplayState:
        pri = (td_abs + self.eps) ** self.alpha
        sum_tree.update(state.tree, idx, pri)
        return state

    def valid_mask(self, state: ReplayState,
                   idx: torch.Tensor) -> torch.Tensor:
        """[B] f32: 1 where idx is trainable (flat storage has no dead
        slots; the frame ring overrides this)."""
        return torch.ones(idx.shape, dtype=torch.float32,
                          device=idx.device)

    # -- learning-health accessors (obs/learning.py) -----------------------

    def leaf_priorities(self, state: ReplayState,
                        idx: torch.Tensor) -> torch.Tensor:
        """Stored p^alpha at the given leaf indices (any idx shape;
        stacked shards: [dp, n], shard d's from shard d's tree)."""
        if sharded(state):
            return state.tree.gather(1, self.capacity + idx)
        return state.tree[self.capacity + idx]

    def cursor_transitions(self, state: ReplayState) -> torch.Tensor:
        """Write cursor in TRANSITION (= leaf-index) units (0-dim, on
        the device; [dp] for stacked shards)."""
        return state.pos_dev

    # -- split entry points of the K-batch learner cycle -------------------

    def sample_state(self, state: ReplayState, batch: int,
                     noise: torch.Tensor | None = None,
                     generator: torch.Generator | None = None):
        """SAMPLE half of the split learner cycle: reads only storage,
        tree and size, never the write cursor."""
        return self.sample(state, batch, noise, generator)

    def update_state(self, state: ReplayState, idx: torch.Tensor,
                     td_abs: torch.Tensor) -> ReplayState:
        """UPDATE half of the split learner cycle: writes only the
        sum-tree."""
        return self.update_priorities(state, idx, td_abs)


class UniformReplayDevice(_FlatStorage):
    """Uniform ring buffer with the same calling convention, over flat
    storage: sampling is uniform over filled slots and IS weights are all
    ones. Writes are in place, like PrioritizedReplay's."""

    # no tree: the learner's diagnostics skip the priority statistics
    has_priorities = False

    def __init__(self, capacity: int, item_spec: Any = None,
                 device: str | torch.device = "cuda"):
        if not (capacity > 0 and (capacity & (capacity - 1)) == 0):
            raise ValueError("capacity must be a power of two")
        self.capacity = capacity
        self.device = resolve_device(device)
        if item_spec is not None:
            self._set_item_spec(item_spec)

    def init(self, item_spec: Any = None) -> ReplayState:
        return ReplayState(storage=self._init_storage(item_spec),
                           tree=torch.zeros(1, device=self.device),  # unused
                           pos=0, size=0)

    def add_body(self, state: ReplayState, items: Any,
                 td_abs: torch.Tensor | None = None) -> None:
        """The block at the device cursor (see PrioritizedReplay)."""
        b = next(iter(items.values())).shape[0]
        self._write_rows(state.storage, items,
                         ring_cursor_dev(state, b, self.capacity))

    def add(self, state: ReplayState, items: Any,
            td_abs: torch.Tensor | None = None) -> ReplayState:
        b = next(iter(items.values())).shape[0]
        ring_write_start(state.pos, b, self.capacity)
        self.add_body(state, items, td_abs)
        self.advance_host(state, b)
        return state

    def draw(self, state: ReplayState, batch: int,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """The uniform draw of `batch` filled slots from `generator` (on
        the host's `size`): what the learner hands to `sample` as
        `idx`, drawn outside any captured graph."""
        return torch.randint(0, max(state.size, 1), (batch,),
                             generator=generator, device=self.device)

    def sample(self, state: ReplayState, batch: int,
               idx: torch.Tensor | None = None,
               generator: torch.Generator | None = None):
        """-> (item batch, slot indices [B], IS weights [B] = 1). `idx`
        replaces the uniform draw from `generator` (tests feed JAX's
        ``jax.random.randint`` indices); it takes the place the
        prioritized layouts give their stratification noise, so the
        learner's fed draws reach it the same way."""
        if idx is None:
            idx = self.draw(state, batch, generator)
        idx = idx.to(self.device)
        return (self._gather(state.storage, idx), idx,
                torch.ones(batch, dtype=torch.float32, device=self.device))

    def update_priorities(self, state: ReplayState, idx, td_abs
                          ) -> ReplayState:
        return state

    def leaf_priorities(self, state: ReplayState,
                        idx: torch.Tensor) -> torch.Tensor:
        return torch.zeros(idx.shape, dtype=torch.float32,
                           device=idx.device)

    def cursor_transitions(self, state: ReplayState) -> torch.Tensor:
        return state.pos_dev

    # split entry points (see PrioritizedReplay): sampling is uniform
    # and updates are no-ops, so the commuting contract holds trivially
    def sample_state(self, state: ReplayState, batch: int,
                     idx: torch.Tensor | None = None,
                     generator: torch.Generator | None = None):
        return self.sample(state, batch, idx, generator)

    def update_state(self, state: ReplayState, idx, td_abs) -> ReplayState:
        return self.update_priorities(state, idx, td_abs)
