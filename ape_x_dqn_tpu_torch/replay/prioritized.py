"""Device-resident prioritized replay: the sampling and priority half.

Counterpart of ``ape_x_dqn_tpu/replay/prioritized.py``. Storage and the
sum-tree live on the device; the write cursor `pos` and the filled count
`size` are host Python ints, advanced only by host calls, so reading
them costs no device sync. Unlike the JAX version, which returns new
state, `add` and the priority updates write the state IN PLACE and
return it.

Conventions (Schaul et al. 2016; Horgan et al. 2018):
- stored priority = (|td| + eps)^alpha  (alpha applied at write time)
- IS weight w_i = (N * P(i))^-beta, normalized by max over the batch
- new transitions arrive WITH priorities

Only the frame-ring layout (replay/frame_ring.py) is ported so far; the
flat-storage write and gather wait for the flat/cartpole slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ape_x_dqn_tpu_torch.ops import sum_tree
from ape_x_dqn_tpu_torch.replay.packing import (ring_write_size,
                                                ring_write_start)
from ape_x_dqn_tpu_torch.utils.misc import resolve_device


@dataclass
class ReplayState:
    storage: dict[str, torch.Tensor]  # per-slot tensors
    tree: torch.Tensor                # (2*capacity,) sum-tree of p^alpha
    pos: int                          # next write cursor
    size: int                         # filled slots


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


class PrioritizedReplay:
    """Static config + state-transition functions over a ReplayState."""

    # capability flag read by the learner's replay-health diagnostics
    has_priorities = True

    def __init__(self, capacity: int, alpha: float = 0.6,
                 beta: float = 0.4, eps: float = 1e-6,
                 device: str | torch.device = "cuda"):
        if not (capacity > 0 and (capacity & (capacity - 1)) == 0):
            raise ValueError("capacity must be a power of two")
        self.capacity = capacity
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        self.device = resolve_device(device)

    def sample_items(self, state: ReplayState, batch: int,
                     noise: torch.Tensor | None = None,
                     generator: torch.Generator | None = None
                     ) -> tuple[Any, torch.Tensor, torch.Tensor]:
        """-> (item batch, leaf indices [B], probs [B]); the storage
        layout provides it."""
        raise NotImplementedError(
            "flat-storage replay is not ported yet; use FrameRingReplay")

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
        n = float(max(state.size, 1))
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

    def cursor_transitions(self, state: ReplayState) -> int:
        """Write cursor in TRANSITION (= leaf-index) units."""
        return state.pos

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
