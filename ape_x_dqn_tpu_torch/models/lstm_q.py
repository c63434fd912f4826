"""Recurrent LSTM Q-network for the R2D2 config.

Counterpart of ``ape_x_dqn_tpu/models/lstm_q.py`` (``ApeXLSTMQNet``):
a torso (the Nature-CNN over uint8 NHWC frames, or one dense layer for
vector observations) -> an LSTM -> a (dueling) Q head, with the
recurrent state stored in replay. Two entry points share the
parameters:
- ``forward(obs [B, T, ...], state)``: the full-sequence unroll for the
  learner (the loss slices burn-in and training segments, not the net);
- ``step(obs [B, ...], state)``: one step for the actors and the
  inference server.

The cell is flax's ``OptimizedLSTMCell``, written out: gates i, f, g,
o; ``c' = f * c + i * g``; ``h' = o * tanh(c')``; input kernels carry no
bias, recurrent kernels do. The four gates' kernels are concatenated
into one ``weight_ih [4H, F]`` and one ``weight_hh [4H, H]`` (rows in
gate order i, f, g, o) with ``bias_hh [4H]``; models/convert.py builds
them from flax's per-gate ``ii..io`` / ``hi..ho`` tree.

Compute dtype, as in the original: the carry is cast to the compute
dtype at the start of an unroll, stays in it across every step (each
elementwise operation rounds to it), and comes back as float32 (replay
stores float32 states).

The unroll is a Python loop over time of one recurrent matmul and the
gate arithmetic per step. The input projection of every step is one
matmul over all T steps before the loop: the same products, row by
row, as the original's per-step ``x_t @ W_i``. (``torch.nn.LSTM`` is
not used: cuDNN's recurrence keeps its own internal precision for the
carry, which the bfloat16 semantics above do not allow.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ape_x_dqn_tpu_torch.models.base import dtype_of, preprocess_obs
from ape_x_dqn_tpu_torch.models.qnets import (DuelingHead, NatureCNNTorso,
                                              _dense)

LSTMState = tuple[torch.Tensor, torch.Tensor]  # (c, h), float32 in replay


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell`` parameters, gate-concatenated."""

    def __init__(self, in_features: int, hidden: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        self.weight_ih = nn.Parameter(torch.zeros(4 * hidden, in_features))
        self.weight_hh = nn.Parameter(torch.zeros(4 * hidden, hidden))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden))

    def input_proj(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., F] -> the input halves of the gates [..., 4H]."""
        return F.linear(x.to(self.dtype), self.weight_ih.to(self.dtype))

    def recurrent_weights(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(weight_hh, bias_hh) in the compute dtype, cast once per
        unroll."""
        return self.weight_hh.to(self.dtype), self.bias_hh.to(self.dtype)

    @staticmethod
    def cell(xp: torch.Tensor, c: torch.Tensor, h: torch.Tensor,
             w_hh: torch.Tensor, b_hh: torch.Tensor) -> LSTMState:
        """One step from the input projection xp [B, 4H] and the carry
        (c, h) in the compute dtype -> the new carry."""
        i, f, g, o = (F.linear(h, w_hh, b_hh) + xp).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return c, h


class ApeXLSTMQNet(nn.Module):
    """Torso -> LSTM -> (dueling) head over NHWC uint8 frames
    ([H, W, stack] obs) or float vectors (``mlp_torso``)."""

    def __init__(self, obs_shape: tuple[int, ...], num_actions: int,
                 lstm_size: int = 512, dense: int = 512,
                 dueling: bool = True, compute_dtype: str = "bfloat16",
                 mlp_torso: bool = False, mlp_hidden: int = 128):
        super().__init__()
        self.dt = dtype_of(compute_dtype)
        self.num_actions = num_actions
        self.lstm_size = lstm_size
        self.mlp_torso = mlp_torso
        if mlp_torso:
            self.torso = nn.Linear(obs_shape[-1], mlp_hidden)
            feat = mlp_hidden
        else:
            # the original's torso keeps NatureCNNTorso's default convs
            self.torso = NatureCNNTorso(tuple(obs_shape), dense=dense,
                                        dtype=self.dt)
            feat = dense
        self.lstm = LSTMCell(feat, lstm_size, dtype=self.dt)
        self.dueling = dueling
        if dueling:
            self.head = DuelingHead(lstm_size, num_actions, dtype=self.dt)
        else:
            self.head = nn.Linear(lstm_size, num_actions)

    def _channels_first(self, obs: torch.Tensor) -> torch.Tensor:
        """NHWC frames -> an NCHW view (vector obs pass through). Taken
        before the batch and time axes merge, so frames stored
        channels-first (replay/sequence.py) merge without a layout
        change."""
        return obs if self.mlp_torso else obs.movedim(-1, -3)

    def _torso(self, x: torch.Tensor) -> torch.Tensor:
        """[N, D] vectors or [N, C, H, W] frames -> features [N, F]."""
        if self.mlp_torso:
            return F.relu(_dense(self.torso, preprocess_obs(x, self.dt),
                                 self.dt))
        return self.torso(preprocess_obs(x, self.dt))

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        if self.dueling:
            return self.head(x)
        return _dense(self.head, x, self.dt).float()

    def forward(self, obs: torch.Tensor, state: LSTMState
                ) -> tuple[torch.Tensor, LSTMState]:
        """obs [B, T, ...] -> (q [B, T, A] float32, final state)."""
        b, t = obs.shape[:2]
        x = self._channels_first(obs)
        feats = self._torso(x.reshape(b * t, *x.shape[2:]))
        xp = self.lstm.input_proj(feats).reshape(b, t, -1)
        w_hh, b_hh = self.lstm.recurrent_weights()
        c, h = (s.to(self.dt) for s in state)
        ys = []
        for i in range(t):
            c, h = LSTMCell.cell(xp[:, i], c, h, w_hh, b_hh)
            ys.append(h)
        q = self._head(torch.stack(ys, dim=1).reshape(b * t, -1))
        return (q.reshape(b, t, self.num_actions),
                (c.float(), h.float()))

    def step(self, obs: torch.Tensor, state: LSTMState
             ) -> tuple[torch.Tensor, LSTMState]:
        """obs [B, ...], one timestep for acting."""
        xp = self.lstm.input_proj(self._torso(self._channels_first(obs)))
        c, h = (s.to(self.dt) for s in state)
        c, h = LSTMCell.cell(xp, c, h, *self.lstm.recurrent_weights())
        return self._head(h), (c.float(), h.float())

    def initial_state(self, batch: int,
                      device: str | torch.device = "cpu") -> LSTMState:
        z = torch.zeros((batch, self.lstm_size), dtype=torch.float32,
                        device=device)
        return z, z.clone()
