"""R2D2 sequence replay: host-side sequence assembly and the learner's
batch view.

Counterpart of ``ape_x_dqn_tpu/replay/sequence.py``. Actors assemble
fixed-length overlapping sequences with the recurrent state stored from
BEFORE the first step; the sequences are then items of the generic flat
`PrioritizedReplay` (replay/prioritized.py), so sampling and priority
updates are the flat learner's. Defaults follow Kapturowski et al.
2019: length 80, overlap 40, burn-in 40 (handled by the loss), priority
eta * max|td| + (1 - eta) * mean|td|.

In frame mode (frame_ring storage over [H, W, stack] pixels) a sequence
stores single frames ``seq_frames [L + stack - 1, H, W]`` instead of
per-step stacks ``obs [L, H, W, stack]``: consecutive steps share all
but one frame, so stacked storage is ~stack x redundant. The replay's
packer stores that leaf as one byte row, gathered by the row-gather
kernel (ops/frame_gather.py), and `batch_to_sequence_batch` rebuilds
the stacks with `stack` slices.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ape_x_dqn_tpu_torch.replay.packing import (ItemSpec, frame_mode,
                                                torch_dtype)

# THE predicate for single-frame sequence storage: the same object as
# the flat family's frame_ring_mode (replay/packing.py)
sequence_frame_mode = frame_mode


def sequence_item_spec(obs_shape: tuple[int, ...], obs_dtype,
                       seq_len: int, lstm_size: int,
                       frame_mode: bool = False) -> dict[str, ItemSpec]:
    """{key: ItemSpec} of ONE stored sequence (frame_mode: see the
    module docstring)."""
    f32 = torch.float32
    if frame_mode:
        h, w, stack = obs_shape
        obs_key = "seq_frames"
        obs = ItemSpec((seq_len + stack - 1, h, w), torch_dtype(obs_dtype))
    else:
        obs_key = "obs"
        obs = ItemSpec((seq_len, *obs_shape), torch_dtype(obs_dtype))
    return {
        obs_key: obs,
        "actions": ItemSpec((seq_len,), torch.int32),
        "rewards": ItemSpec((seq_len,), f32),
        "terminals": ItemSpec((seq_len,), f32),
        "mask": ItemSpec((seq_len,), f32),
        "init_c": ItemSpec((lstm_size,), f32),
        "init_h": ItemSpec((lstm_size,), f32),
    }


class SequenceBuilder:
    """Per-env accumulator emitting overlapping fixed-length sequences.

    Actors attach a per-step |TD| estimate, and every emitted item
    carries an initial sequence priority under the extra key
    ``"priority"`` (the eta-mix the learner writes back); callers strip
    it before storage with `split_priorities`. Host numpy throughout, as
    in the original, so the same steps give bitwise the same items."""

    def __init__(self, seq_len: int = 80, overlap: int = 40,
                 lstm_size: int = 512, priority_eta: float = 0.9,
                 frame_mode: bool = False):
        """frame_mode: emit single frames ("seq_frames") instead of
        per-step stacks; valid for [H, W, stack] pixel obs whose
        channels slide one frame per step (the Atari wrapper's
        invariant; holds within an episode, and sequences never span
        episodes)."""
        assert 0 <= overlap < seq_len
        self.seq_len = seq_len
        self.overlap = overlap
        self.lstm_size = lstm_size
        self.priority_eta = priority_eta
        self.frame_mode = frame_mode
        self._steps: list[dict] = []
        self._retained = 0  # leading steps already covered by a prior emit

    def append(self, obs, action, reward, terminal: bool,
               pre_state: tuple[np.ndarray, np.ndarray],
               td: float = 0.0,
               episode_end: bool | None = None) -> list[dict]:
        """Add one step; pre_state is the (c, h) fed to the net AT this
        step. `terminal` is stored in the terminals array; `episode_end`
        (default: terminal) flushes the sequence: a time-limit
        truncation ends the sequence without a terminal, since the
        recurrent state resets but the bootstrap survives. Returns the
        completed items (0 or more)."""
        if episode_end is None:
            episode_end = terminal
        c, h = pre_state
        self._steps.append(dict(
            obs=np.asarray(obs), action=int(action), reward=float(reward),
            terminal=bool(terminal), td=abs(float(td)),
            pre_c=np.asarray(c, np.float32).reshape(-1),
            pre_h=np.asarray(h, np.float32).reshape(-1)))
        out = []
        if len(self._steps) == self.seq_len:
            out.append(self._emit(self._steps))
            # the trailing overlap heads the next sequence
            self._steps = self._steps[self.seq_len - self.overlap:] \
                if self.overlap else []
            self._retained = len(self._steps)
        if episode_end:
            # flush the padded partial tail if it holds steps the
            # previous emit's overlap did not cover
            if len(self._steps) > self._retained:
                out.append(self._emit(self._steps))
            self._steps = []
            self._retained = 0
        return out

    def reset(self) -> None:
        self._steps = []
        self._retained = 0

    def flush(self) -> list[dict]:
        """Emit the padded partial tail (actor shutdown), if it holds a
        step the previous emit's overlap did not cover."""
        out = []
        if len(self._steps) > self._retained:
            out.append(self._emit(self._steps))
        self._steps = []
        self._retained = 0
        return out

    def _emit(self, steps: list[dict]) -> dict:
        n = len(steps)
        assert n > 0
        length = self.seq_len
        first = steps[0]
        actions = np.zeros(length, np.int32)
        rewards = np.zeros(length, np.float32)
        terminals = np.zeros(length, np.float32)
        mask = np.zeros(length, np.float32)
        tds = np.zeros(n, np.float32)
        for i, s in enumerate(steps):
            actions[i] = s["action"]
            rewards[i] = s["reward"]
            terminals[i] = float(s["terminal"])
            mask[i] = 1.0
            tds[i] = s["td"]
        eta = self.priority_eta
        priority = eta * float(tds.max()) + (1 - eta) * float(tds.mean())
        item = {
            "actions": actions, "rewards": rewards,
            "terminals": terminals, "mask": mask,
            "init_c": first["pre_c"], "init_h": first["pre_h"],
            "priority": priority,
        }
        if self.frame_mode:
            # frames [0:stack] are the first step's channels, then one
            # new frame (the newest channel) per step: step i's stack
            # is frames[i:i + stack]. The unmasked tail repeats the
            # last frame.
            h, w, stack = first["obs"].shape
            frames = np.zeros((length + stack - 1, h, w),
                              first["obs"].dtype)
            for c in range(stack):
                frames[c] = first["obs"][..., c]
            for i, s in enumerate(steps[1:], start=1):
                frames[stack - 1 + i] = s["obs"][..., -1]
            frames[stack - 1 + n:] = frames[stack - 2 + n]
            item["seq_frames"] = frames
        else:
            obs = np.zeros((length, *first["obs"].shape),
                           first["obs"].dtype)
            for i, s in enumerate(steps):
                obs[i] = s["obs"]
            item["obs"] = obs
        return item


def split_priorities(items: list[dict]) -> tuple[list[dict], np.ndarray]:
    """Strip the builder's "priority" key -> (storage items,
    priorities)."""
    pris = np.asarray([it.get("priority", 0.0) for it in items], np.float32)
    return [{k: v for k, v in it.items() if k != "priority"}
            for it in items], pris


def stack_items(items: list[dict]) -> dict:
    """Stack sequence items into a batch of [B, ...] arrays, skipping
    the builder's scalar "priority" key."""
    return {k: np.stack([it[k] for it in items])
            for k in items[0] if k != "priority"}


def batch_to_sequence_batch(items: Any):
    """Sampled items (a dict of [B, L, ...] tensors) -> SequenceBatch.

    Frame-mode items carry "seq_frames" [B, L + stack - 1, H, W]; step
    t's stack is frames t .. t + stack - 1, rebuilt by `stack` slices.
    They are stacked on a new axis 2 ([B, L, stack, H, W]) and handed
    on as the [B, L, H, W, stack] view the net's NHWC interface takes; the
    net turns it back to channels-first before it merges B and L, so
    the frames keep the NCHW layout its torso reads."""
    from ape_x_dqn_tpu_torch.ops.losses import SequenceBatch

    if "seq_frames" in items:
        f = items["seq_frames"]
        length = items["actions"].shape[-1]
        stack = f.shape[1] - length + 1
        obs = torch.stack([f[:, c:c + length] for c in range(stack)],
                          dim=2).permute(0, 1, 3, 4, 2)
    else:
        obs = items["obs"]
    return SequenceBatch(
        obs=obs, actions=items["actions"],
        rewards=items["rewards"], terminals=items["terminals"],
        mask=items["mask"],
        init_state=(items["init_c"], items["init_h"]))
