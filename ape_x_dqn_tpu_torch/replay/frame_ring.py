"""Frame-ring prioritized replay: single frames on the device, stacks on
demand.

Counterpart of ``ape_x_dqn_tpu/replay/frame_ring.py`` (the layout and
its reasoning are documented there). In short: actors ship fixed-size
SEGMENTS of B transitions with the F = B + n_step + stack - 1 frames
they need; the ring stores each frame ONCE as a ``pad128(H*W)``-byte
row of a ``[S*F, frame_row]`` uint8 tensor, plus per-transition fields
``[capacity]`` (action/reward/discount/next_off). Segment k owns
transition slots [k*B, (k+1)*B) and frame rows [k*F, (k+1)*F); `pos`
counts SEGMENTS, `size` transitions, and the sum-tree indexes
transitions. A transition at slot j of segment k has
    obs      = rows k*F + j     + [0, stack)
    next_obs = rows k*F + j + m + [0, stack),  m = next_off (1..n_step)
and the sample path rebuilds both stacks with the hand-written frame-row
gather kernel (ops/frame_gather.py), one launch per side.

Dead padding slots (next_off 0) carry tree priority 0, are never
sampled, and get IS weight 0 if a clamp-landed draw hits one.

Writes are IN PLACE on the state (the JAX version returns new arrays).
The cold tier's hooks (`evict_plan`, `read_region`, `add_at`) work in
whole segments, the unit a transition's frames alias within. Every
method also takes the dp-sharded state (replay/prioritized.py:
`ShardedReplayState`, from `init_sharded`): frames [dp, S*F, row],
fields [dp, capacity]; the sample path gathers each side's stacks for
all shards in one launch over the flat view [dp*S*F, row], since a
transition d*capacity + i of the flat fields sits in flat segment
d*S + i // B, whose frame rows start at (d*S + i // B) * F.

The actor side (`FrameSegmentBuilder`, `frame_segment_spec`) cuts each
env's transition stream into the segments this replay stores; it is
host numpy, the original's code line for line.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ape_x_dqn_tpu_torch.ops import sum_tree
from ape_x_dqn_tpu_torch.ops.frame_gather import gather_rows
from ape_x_dqn_tpu_torch.replay.packing import (ItemSpec, frame_mode,
                                                pad128, ring_write_start,
                                                torch_dtype)
from ape_x_dqn_tpu_torch.replay.packing import shard_rows
from ape_x_dqn_tpu_torch.replay.prioritized import (PrioritizedReplay,
                                                    ReplayState,
                                                    ShardedReplayState,
                                                    flat_index,
                                                    min_mass_window,
                                                    ring_cursor,
                                                    ring_cursor_at,
                                                    ring_cursor_dev,
                                                    sharded,
                                                    write_rows_at)

FIELDS = ("action", "reward", "discount", "next_off")

# the predicate for frame-segment storage in the flat-DQN family (an
# alias of replay/packing.py's, as in the original)
frame_ring_mode = frame_mode


def frame_segment_spec(seg_transitions: int, n_step: int,
                       obs_shape: tuple[int, ...], obs_dtype) -> dict:
    """Item spec for ONE shipped segment (the ingest staging adds the
    leading axis, as for every other item spec)."""
    h, w, stack = obs_shape
    f = seg_transitions + n_step + stack - 1
    return {
        "seg_frames": ItemSpec((f, h, w), torch_dtype(obs_dtype)),
        "action": ItemSpec((seg_transitions,), torch.int32),
        "reward": ItemSpec((seg_transitions,), torch.float32),
        "discount": ItemSpec((seg_transitions,), torch.float32),
        "next_off": ItemSpec((seg_transitions,), torch.int32),
    }


class FrameSegmentBuilder:
    """Actor-side segment assembly (host numpy; one per actor env).

    Call order per actor loop (runtime/actor.py):
      on_reset(obs)            after every env.reset()
      on_step(next_obs)        after every env.step()
      add(action, reward, discount, span, priority)
                               for each emitted n-step transition, in
                               start-step order
      take_ready() -> [segment dicts] ready to ship
      flush()                  at shutdown: pad + emit the partial tail

    Per episode it keeps a frame log P where P[0:stack] are the reset
    observation's channels and each env step appends one new frame, so
    the step-t observation stack is the slice P[t:t+stack]. on_reset
    flushes the open partial segment first, so segments never span
    episodes.
    """

    def __init__(self, seg_transitions: int, n_step: int, stack: int):
        self.B = seg_transitions
        self.n = n_step
        self.stack = stack
        self.F = self.B + self.n + self.stack - 1
        self._frames: list[np.ndarray] = []  # P[base:], trimmed left
        self._base = 0          # P-index of self._frames[0]
        self._t = 0             # next transition start step (per episode)
        self._t0: int | None = None  # open segment's first start step
        self._fields: list[tuple] = []
        self._ready: list[dict] = []

    def on_reset(self, obs: np.ndarray) -> None:
        self._flush_partial()
        # seed from ALL channels: a full reset gives the wrapper's
        # zero-padded stack, an episodic-life pseudo-reset gives the
        # carried-over frames; both reconstruct exactly
        self._frames = [np.ascontiguousarray(obs[..., c])
                        for c in range(self.stack)]
        self._base = 0
        self._t = 0
        self._t0 = None

    def on_step(self, next_obs: np.ndarray) -> None:
        self._frames.append(np.ascontiguousarray(next_obs[..., -1]))

    def add(self, action, reward: float, discount: float, span: int,
            priority: float) -> None:
        assert 1 <= span <= self.n, span
        if self._t0 is None:
            self._t0 = self._t
            drop = self._t0 - self._base  # frames left of P[t0]: done with
            if drop:
                del self._frames[:drop]
                self._base = self._t0
        self._t += 1
        self._fields.append((action, float(reward), float(discount),
                             int(span), float(priority)))
        if len(self._fields) == self.B:
            self._emit()

    def _emit(self) -> None:
        s = self._t0 - self._base
        frames = self._frames[s:s + self.F]
        while len(frames) < self.F:      # episode ended early: repeat tail
            frames.append(frames[-1])
        pad = self.B - len(self._fields)
        # dead slots: priority 0 AND next_off 0 (the replay masks the
        # tree priority on next_off > 0, so eps^alpha never leaks in)
        fields = self._fields + [(0, 0.0, 0.0, 0, 0.0)] * pad
        acts, rews, discs, offs, pris = zip(*fields)
        self._ready.append({
            "seg_frames": np.stack(frames)[None],
            "action": np.asarray(acts, np.int32).reshape(1, self.B),
            "reward": np.asarray(rews, np.float32).reshape(1, self.B),
            "discount": np.asarray(discs, np.float32).reshape(1, self.B),
            "next_off": np.asarray(offs, np.int32).reshape(1, self.B),
            "priorities": np.asarray(pris, np.float32).reshape(1, self.B),
        })
        self._t0 = None
        self._fields = []

    def _flush_partial(self) -> None:
        if self._fields:
            self._emit()

    def flush(self) -> list[dict]:
        self._flush_partial()
        return self.take_ready()

    def take_ready(self) -> list[dict]:
        out, self._ready = self._ready, []
        return out


class FrameRingReplay(PrioritizedReplay):
    """Device-side prioritized replay over segment storage.

    `add` consumes staged segments {"seg_frames": [G, F, H, W] uint8,
    "action"/"reward"/"discount"/"next_off": [G, B]} with initial
    |TD| [G, B]; `sample` (inherited) returns flat transitions
    {obs, action, reward, next_obs, discount} with obs/next_obs
    [B, H, W, stack] uint8 views of the gathered rows.
    """

    def __init__(self, capacity: int, seg_transitions: int, n_step: int,
                 obs_shape: tuple[int, ...], obs_dtype=np.uint8,
                 alpha: float = 0.6, beta: float = 0.4, eps: float = 1e-6,
                 device: str | torch.device = "cuda"):
        super().__init__(capacity=capacity, alpha=alpha, beta=beta, eps=eps,
                         device=device)
        if capacity % seg_transitions != 0:
            raise ValueError("segment size must divide capacity")
        if len(obs_shape) != 3:
            raise ValueError(
                f"frame-ring replay needs [H, W, stack] pixel obs, "
                f"got {obs_shape}")
        if np.dtype(obs_dtype) != np.uint8:
            raise ValueError(
                f"frame-ring byte-row storage requires uint8 frames "
                f"(got {np.dtype(obs_dtype)})")
        self.B = seg_transitions
        self.n = n_step
        self.h, self.w, self.stack = obs_shape
        self.F = self.B + self.n + self.stack - 1
        self.S = capacity // self.B          # segment slots
        self.frame_bytes = self.h * self.w
        self.frame_row = pad128(self.frame_bytes)

    # -- state construction ------------------------------------------------

    def _storage(self, lead: tuple = ()) -> dict[str, torch.Tensor]:
        dev = self.device
        fields = {"action": torch.int32, "reward": torch.float32,
                  "discount": torch.float32, "next_off": torch.int32}
        storage = {"frames": torch.zeros(
            (*lead, self.S * self.F, self.frame_row), dtype=torch.uint8,
            device=dev)}
        for k, dtype in fields.items():
            storage[k] = torch.zeros((*lead, self.capacity), dtype=dtype,
                                     device=dev)
        return storage

    def init(self) -> ReplayState:
        return ReplayState(storage=self._storage(),
                           tree=sum_tree.init(self.capacity, self.device),
                           pos=0, size=0)

    def init_sharded(self, dp: int, item_spec: Any = None
                     ) -> ShardedReplayState:
        """dp empty rings of `capacity` transitions each, stacked (the
        item spec is fixed by the ring's geometry)."""
        return ShardedReplayState(
            storage=self._storage((dp,)),
            tree=torch.zeros((dp, 2 * self.capacity), dtype=torch.float32,
                             device=self.device))

    def _ring_slots(self) -> int:
        return self.S

    # -- transitions -------------------------------------------------------

    def add_body(self, state: ReplayState, items: Any,
                 td_abs: torch.Tensor,
                 seg0: torch.Tensor | None = None) -> None:
        """ONE contiguous block of G*F frame rows / G*B transition
        slots at the DEVICE segment cursor, with skip-to-head wrap, the
        tree write-back (dead pads get priority 0) and the device cursor
        advance: in place, device operations only. A device `seg0`
        (0-dim) directs the block to that segment instead (`add_at`).
        Stacked shards: items [dp, G, ...] and td_abs [dp, G, B], at
        every shard's cursor or at [dp] segments `seg0`."""
        g = td_abs.shape[-2]
        lead = tuple(td_abs.shape[:-2])
        seg0 = ring_cursor_dev(state, g, self.S, size_scale=self.B,
                               start=seg0)
        dev = state.tree.device
        tidx = seg0[..., None] * self.B + torch.arange(g * self.B,
                                                       device=dev)
        rows = items["seg_frames"].to(dev, torch.uint8).reshape(
            *lead, g * self.F, self.frame_bytes)
        if self.frame_row != self.frame_bytes:
            rows = F.pad(rows, (0, self.frame_row - self.frame_bytes))
        st = state.storage
        write_rows_at(st["frames"], rows, seg0 * self.F)
        for k in FIELDS:
            write_rows_at(st[k], items[k].reshape(*lead, g * self.B),
                          seg0 * self.B)
        td = td_abs.to(dev, torch.float32).reshape(*lead, g * self.B)
        valid = items["next_off"].to(dev).reshape(*lead, g * self.B) > 0
        pri = torch.where(valid, (td + self.eps) ** self.alpha,
                          torch.zeros_like(td))
        sum_tree.update(state.tree, tidx, pri)

    def advance_host(self, state: ReplayState, block: int) -> None:
        """The host ints after one add of `block` segments per shard."""
        state.set_cursors([ring_cursor(p, s, block, self.S,
                                       size_scale=self.B)[1:]
                           for p, s in state.cursors()])

    def advance_host_at(self, state: ReplayState, seg0,
                        block: int) -> None:
        """The host ints after a directed add of `block` segments at
        segment `seg0` (an int, or one per shard)."""
        starts = np.broadcast_to(np.asarray(seg0, np.int64),
                                 (len(state.cursors()),))
        state.set_cursors([ring_cursor_at(s, int(st), block, self.S,
                                          size_scale=self.B)
                           for (_, s), st in zip(state.cursors(), starts)])

    def add(self, state: ReplayState, items: Any,
            td_abs: torch.Tensor) -> ReplayState:
        """Write G whole segments at the segment cursor, in place.

        items: {"seg_frames": [G, F, H, W], "action"/"reward"/
        "discount"/"next_off": [G, B]}; td_abs: [G, B] initial |TD| (0
        on dead pads). Host tensors are copied to the replay's device.
        """
        ring_write_start(state.pos, td_abs.shape[0], self.S)
        self.add_body(state, items, td_abs)
        self.advance_host(state, td_abs.shape[0])
        return state

    # -- tiered cold store hooks (segment units) -----------------------------

    def evict_plan(self, state: ReplayState, block: int) -> torch.Tensor:
        """Start SEGMENT (0-dim int64, on the device) of the minimum-
        priority-mass run of `block` contiguous segments: the leaves are
        reduced per segment first, since a transition's frames alias
        across its segment and only whole segments can leave. Stacked
        shards: [dp] starts, each shard planned on its own tree."""
        leaves = state.tree[..., self.capacity:]
        seg_mass = leaves.reshape(*leaves.shape[:-1], self.S, self.B) \
            .sum(dim=-1)
        return min_mass_window(seg_mass, block)

    def read_region(self, state: ReplayState, seg0: torch.Tensor,
                    block: int) -> tuple[dict, torch.Tensor]:
        """-> (staging-layout segments {"seg_frames": [g, F, H, W],
        fields [g, B]}, stored leaf priorities [g, B]) of the `block`
        segments at the device `seg0`, as fresh tensors: the exact shape
        `add_body` takes, so a cold round trip restages bit-identically.
        Stacked shards: [dp, g, ...] from [dp] segments."""
        if seg0.dim():
            return self._read_region_sharded(state, seg0, block)
        g, dev = block, state.tree.device
        st = state.storage
        rows = st["frames"].index_select(
            0, seg0 * self.F + torch.arange(g * self.F, device=dev))
        items = {"seg_frames": rows[:, :self.frame_bytes].reshape(
            g, self.F, self.h, self.w)}
        tidx = seg0 * self.B + torch.arange(g * self.B, device=dev)
        for k in FIELDS:
            items[k] = st[k].index_select(0, tidx).reshape(g, self.B)
        pri = state.tree.index_select(0, self.capacity + tidx)
        return items, pri.reshape(g, self.B)

    def _read_region_sharded(self, state: ShardedReplayState,
                             seg0: torch.Tensor, g: int
                             ) -> tuple[dict, torch.Tensor]:
        dp = seg0.shape[0]
        flat = state.flat_storage()
        rows = flat["frames"].index_select(
            0, shard_rows(seg0 * self.F, g * self.F, self.S * self.F))
        items = {"seg_frames": rows[:, :self.frame_bytes].reshape(
            dp, g, self.F, self.h, self.w)}
        tidx = shard_rows(seg0 * self.B, g * self.B, self.capacity)
        for k in FIELDS:
            items[k] = flat[k].index_select(0, tidx).reshape(dp, g, self.B)
        leaves = shard_rows(seg0 * self.B + self.capacity, g * self.B,
                            2 * self.capacity)
        pri = state.tree.view(-1).index_select(0, leaves)
        return items, pri.reshape(dp, g, self.B)

    def add_at(self, state: ReplayState, items: Any, td_abs: torch.Tensor,
               seg0: torch.Tensor | int) -> ReplayState:
        """Directed segment add: overwrite the G segments at seg0 (an
        evict_plan result) instead of the FIFO segment cursor."""
        seg0_dev = torch.as_tensor(seg0, dtype=torch.int64,
                                   device=state.tree.device)
        self.add_body(state, items, td_abs, seg0=seg0_dev)
        self.advance_host_at(state, int(seg0), td_abs.shape[0])
        return state

    def stack_rows(self, state: ReplayState, idx: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Frame-row indices [Bt*stack] of the obs and next_obs stacks
        of transitions idx [Bt], in stack order."""
        seg = torch.div(idx, self.B, rounding_mode="floor")
        base = seg * self.F + idx % self.B
        offs = torch.arange(self.stack, device=idx.device)[None, :]
        nxt = base + state.storage["next_off"][idx].long()
        return ((base[:, None] + offs).reshape(-1),
                (nxt[:, None] + offs).reshape(-1))

    def unpack_stack(self, rows: torch.Tensor) -> torch.Tensor:
        """Gathered [Bt*stack, frame_row] rows -> [Bt, H, W, stack]
        (a view: trim, reshape and moveaxis copy nothing)."""
        f = rows[:, :self.frame_bytes].reshape(-1, self.stack, self.h,
                                               self.w)
        return torch.movedim(f, 1, -1)

    def _gather(self, state: ReplayState, idx: torch.Tensor) -> dict:
        """Reconstruct flat transitions {obs, action, reward, next_obs,
        discount} for transition indices idx [Bt]: one frame-row gather
        kernel launch per side, then a batch-local view as [H, W]
        planes (the network's NHWC -> NCHW permute undoes the moveaxis
        without a copy)."""
        st = state.storage
        obs_rows, next_rows = self.stack_rows(state, idx)
        return {
            "obs": self.unpack_stack(gather_rows(st["frames"], obs_rows)),
            "action": st["action"][idx],
            "reward": st["reward"][idx],
            # dead slots: next_off 0 — never sampled
            "next_obs": self.unpack_stack(
                gather_rows(st["frames"], next_rows)),
            "discount": st["discount"][idx],
        }

    def sample_items(self, state: ReplayState, batch: int,
                     noise: torch.Tensor | None = None,
                     generator: torch.Generator | None = None
                     ) -> tuple[Any, torch.Tensor, torch.Tensor]:
        """-> (flat transition batch, leaf indices [B], probs [B]);
        stacked shards: [dp, B] from noise [dp, B]."""
        idx, probs = sum_tree.sample(state.tree, batch,
                                     size=state.size_dev, noise=noise,
                                     generator=generator)
        if sharded(state):
            dp, n = idx.shape
            flat = SimpleNamespace(storage=state.flat_storage())
            items = self._gather(flat, flat_index(idx, self.capacity))
            return ({k: v.reshape(dp, n, *v.shape[1:])
                     for k, v in items.items()}, idx, probs)
        return self._gather(state, idx), idx, probs

    def _next_off(self, state: ReplayState,
                  idx: torch.Tensor) -> torch.Tensor:
        """next_off at transition indices idx (stacked shards: [dp, n],
        shard d's from shard d's ring)."""
        if sharded(state):
            return state.storage["next_off"].gather(1, idx)
        return state.storage["next_off"][idx]

    def update_priorities(self, state: ReplayState, idx: torch.Tensor,
                          td_abs: torch.Tensor) -> ReplayState:
        pri = (td_abs + self.eps) ** self.alpha
        # a dead slot must stay dead: a clamp-landed draw would otherwise
        # write (garbage-TD)^alpha here and resurrect it into the
        # sampling distribution permanently
        pri = torch.where(self._next_off(state, idx) > 0, pri,
                          torch.zeros_like(pri))
        sum_tree.update(state.tree, idx, pri)
        return state

    def valid_mask(self, state: ReplayState,
                   idx: torch.Tensor) -> torch.Tensor:
        """[B] f32: 1 on live transitions, 0 on dead pad slots."""
        return (self._next_off(state, idx) > 0).to(torch.float32)

    def cursor_transitions(self, state: ReplayState) -> torch.Tensor:
        """Write cursor in transition units (`pos` counts segments; 0-dim,
        on the device)."""
        return state.pos_dev * self.B

    def live_transitions(self, state: ReplayState) -> torch.Tensor:
        """Count of live (non-pad) transition slots: 0-dim, or [dp] for
        stacked shards (only the slot axis is reduced)."""
        return (state.storage["next_off"] > 0).sum(dim=-1)
