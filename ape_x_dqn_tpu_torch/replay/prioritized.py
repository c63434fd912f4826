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

Conventions (Schaul et al. 2016; Horgan et al. 2018):
- stored priority = (|td| + eps)^alpha  (alpha applied at write time)
- IS weight w_i = (N * P(i))^-beta, normalized by max over the batch
- new transitions arrive WITH priorities

Two layouts share the sampling and priority half: flat storage
(`PrioritizedReplay` itself: one slot per transition, pixel leaves
packed into byte rows by replay/packing.py and gathered by the
hand-written row-gather kernel, ops/frame_gather.py) and the frame ring
(replay/frame_ring.py). `UniformReplayDevice` is the uniform ring over
the same flat storage.
"""

from __future__ import annotations

from typing import Any

import torch

from ape_x_dqn_tpu_torch.ops import sum_tree
from ape_x_dqn_tpu_torch.ops.frame_gather import gather_rows
from ape_x_dqn_tpu_torch.replay.packing import (PixelPacker, dus_rows,
                                                make_packer,
                                                ring_write_size,
                                                ring_write_start)
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


def ring_finish(state: ReplayState, idx: torch.Tensor, pri: torch.Tensor,
                pos1: int, size1: int) -> ReplayState:
    """Tree write-back + cursor advance shared by every ring layout (in
    place)."""
    sum_tree.update(state.tree, idx, pri)
    state.pos, state.size = pos1, size1
    return state


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

    def _init_storage(self, item_spec: Any) -> dict[str, torch.Tensor]:
        if item_spec is not None:
            self._set_item_spec(item_spec)
        if self._storage_spec is None:
            raise ValueError(
                f"{type(self).__name__} has no item spec — pass item_spec "
                f"to the constructor or to init()")
        return {k: torch.zeros((self.capacity, *s.shape), dtype=s.dtype,
                               device=self.device)
                for k, s in self._storage_spec.items()}

    def _write_rows(self, storage: dict, items: dict, start: int) -> None:
        """Encode a [b, ...] block and write it at slot `start`, in
        place (host tensors are copied to the storage's device)."""
        if self._packer is not None:
            items = self._packer.encode(items)
        for k, buf in storage.items():
            dus_rows(buf, items[k], start)

    def _gather(self, storage: dict, idx: torch.Tensor) -> dict:
        """Items at slots idx [B]: packed byte-row leaves through the
        row-gather kernel (one launch each), the others by indexing;
        then decoded back to frames (a view)."""
        packer = self._packer
        items = {k: gather_rows(buf, idx)
                 if packer is not None and packer.packed(k) else buf[idx]
                 for k, buf in storage.items()}
        return packer.decode(items) if packer is not None else items


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

    def _write_block(self, state: ReplayState, items: Any,
                     td_abs: torch.Tensor) -> ReplayState:
        """One contiguous block per leaf at the cursor with skip-to-head
        wrap, then the tree write-back (in place). A block size that
        does not divide the capacity retires the tail slots a skip
        leaves behind: `size` never counts them and the tree never
        carries priority there."""
        b = td_abs.shape[0]
        start, pos1, size1 = ring_cursor(state.pos, state.size, b,
                                         self.capacity)
        self._write_rows(state.storage, items, start)
        dev = state.tree.device
        idx = start + torch.arange(b, device=dev)
        pri = (td_abs.to(dev, torch.float32) + self.eps) ** self.alpha
        return ring_finish(state, idx, pri, pos1, size1)

    def add(self, state: ReplayState, items: Any,
            td_abs: torch.Tensor) -> ReplayState:
        """Append a batch of items with initial |TD| priorities, in place.

        items: {key: [B, ...]}; td_abs: [B]. Overwrites FIFO when full;
        a block that would cross the ring boundary is written at slot 0
        instead (skip-to-head)."""
        return self._write_block(state, items, td_abs)

    def draw(self, state: ReplayState, batch: int,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """The stratification noise of one draw ([batch] uniform), from
        `generator`: the learner draws it before a step, outside any
        captured graph, and hands it in as `noise`."""
        return torch.rand(batch, generator=generator, device=self.device)

    def sample_items(self, state: ReplayState, batch: int,
                     noise: torch.Tensor | None = None,
                     generator: torch.Generator | None = None
                     ) -> tuple[Any, torch.Tensor, torch.Tensor]:
        """-> (item batch, leaf indices [B], probs [B]), without IS
        weights (the frame ring shares this calling convention)."""
        idx, probs = sum_tree.sample(state.tree, batch,
                                     size=state.size_dev, noise=noise,
                                     generator=generator)
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
        """Stored p^alpha at the given leaf indices (any idx shape)."""
        return state.tree[self.capacity + idx]

    def cursor_transitions(self, state: ReplayState) -> torch.Tensor:
        """Write cursor in TRANSITION (= leaf-index) units (0-dim, on
        the device)."""
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

    def add(self, state: ReplayState, items: Any,
            td_abs: torch.Tensor | None = None) -> ReplayState:
        b = next(iter(items.values())).shape[0]
        start = ring_write_start(state.pos, b, self.capacity)
        self._write_rows(state.storage, items, start)
        state.pos = (start + b) % self.capacity
        state.size = ring_write_size(state.size, start, b, self.capacity)
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
