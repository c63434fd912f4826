"""Q-networks: MLP (CartPole), Nature-CNN with dueling heads (Atari).

The counterparts of ``ape_x_dqn_tpu/models/qnets.py``:
- The public forward pass takes the JAX package's layout, NHWC uint8
  frames ``[B, H, W, stack]``, and permutes to NCHW inside (a view; the
  uint8 -> compute-dtype cast makes the copy cuDNN reads).
- Each layer casts its input and its float32 weights to the compute
  dtype, as flax's ``dtype=`` does, so bf16 compute changes the layers
  and nothing else; Q outputs come back in float32.
- Flax flattens the last conv output in HWC order. Here the torso
  flattens NCHW (CHW order) and ``models/convert.py`` permutes the
  columns of ``torso_out`` to match: one place takes the permutation.
- Dueling merge Q = V + A - mean(A) (Wang et al. 2016).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ape_x_dqn_tpu_torch.models.base import dtype_of, preprocess_obs


def _dense(layer: nn.Module, x: torch.Tensor, dt: torch.dtype
           ) -> torch.Tensor:
    if not isinstance(layer, nn.Linear):
        # a layer column-split across cards
        # (parallel/tensor_parallel.py: ColumnSplitLinear)
        return layer.dense(x, dt)
    return F.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))


class DuelingHead(nn.Module):
    def __init__(self, in_features: int, num_actions: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.value = nn.Linear(in_features, 1)
        self.advantage = nn.Linear(in_features, num_actions)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = _dense(self.value, x, self.dtype)
        a = _dense(self.advantage, x, self.dtype)
        q = v + a - a.mean(dim=-1, keepdim=True)
        return q.float()


class MLPQNet(nn.Module):
    """Dense Q-network for low-dimensional observations (config 1)."""

    def __init__(self, in_features: int, num_actions: int,
                 hidden: Sequence[int] = (256, 256), dueling: bool = False,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.dt = dtype_of(compute_dtype)
        widths = [in_features, *hidden]
        self.hidden = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(widths[:-1], widths[1:]))
        self.dueling = dueling
        if dueling:
            self.head = DuelingHead(widths[-1], num_actions, dtype=self.dt)
        else:
            self.out = nn.Linear(widths[-1], num_actions)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = preprocess_obs(obs, self.dt)
        x = x.reshape(x.shape[0], -1)  # flatten any multi-dim obs
        for layer in self.hidden:
            x = F.relu(_dense(layer, x, self.dt))
        if self.dueling:
            return self.head(x)
        return _dense(self.out, x, self.dt).float()


def conv_out_hw(hw: tuple[int, int], kernels: Sequence[int],
                strides: Sequence[int]) -> tuple[int, int]:
    """Spatial size after the VALID-padded conv stack."""
    h, w = hw
    for k, s in zip(kernels, strides):
        h, w = (h - k) // s + 1, (w - k) // s + 1
    return h, w


class NatureCNNTorso(nn.Module):
    """The classic DQN conv stack (Mnih et al. 2015): 32x8s4, 64x4s2,
    64x3s1, dense 512. Takes NCHW input in the compute dtype."""

    def __init__(self, in_shape: tuple[int, int, int],
                 channels: Sequence[int] = (32, 64, 64),
                 kernels: Sequence[int] = (8, 4, 3),
                 strides: Sequence[int] = (4, 2, 1), dense: int = 512,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        h, w, c = in_shape
        self.dtype = dtype
        self.strides = tuple(strides)
        ins = [c, *channels[:-1]]
        self.convs = nn.ModuleList(
            nn.Conv2d(i, o, k, stride=s)
            for i, o, k, s in zip(ins, channels, kernels, strides))
        oh, ow = conv_out_hw((h, w), kernels, strides)
        self.torso_out = nn.Linear(oh * ow * channels[-1], dense)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        for conv, s in zip(self.convs, self.strides):
            x = F.relu(F.conv2d(x.to(dt), conv.weight.to(dt),
                                conv.bias.to(dt), stride=s))
        x = x.reshape(x.shape[0], -1)  # CHW order (see module docstring)
        return F.relu(_dense(self.torso_out, x, dt))


class NatureDQN(nn.Module):
    """Nature-CNN torso + (dueling) Q head over uint8 NHWC frames."""

    def __init__(self, obs_shape: tuple[int, int, int], num_actions: int,
                 channels: Sequence[int] = (32, 64, 64),
                 kernels: Sequence[int] = (8, 4, 3),
                 strides: Sequence[int] = (4, 2, 1), dense: int = 512,
                 dueling: bool = True, compute_dtype: str = "bfloat16"):
        super().__init__()
        self.dt = dtype_of(compute_dtype)
        self.torso = NatureCNNTorso(tuple(obs_shape), channels, kernels,
                                    strides, dense, dtype=self.dt)
        self.dueling = dueling
        if dueling:
            self.head = DuelingHead(dense, num_actions, dtype=self.dt)
        else:
            self.out = nn.Linear(dense, num_actions)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        # NHWC -> NCHW is a view here; preprocess_obs makes the copy
        x = preprocess_obs(obs.permute(0, 3, 1, 2), self.dt)
        x = self.torso(x)
        if self.dueling:
            return self.head(x)
        return _dense(self.out, x, self.dt).float()
