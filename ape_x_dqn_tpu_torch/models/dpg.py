"""Deterministic-policy-gradient actor-critic for continuous control.

Counterpart of ``ape_x_dqn_tpu/models/dpg.py`` (Ape-X DPG, Horgan et
al. 2018): a deterministic policy network mu(s) with a tanh-squashed
action scaled to [low, high], and a Q(s, a) critic over the
concatenated observation and action. Both have target copies updated by
Polyak averaging (models/base.py ``soft_update``).

Each layer casts its input and its float32 weights to the compute dtype,
as flax's ``dtype=`` does (the presets use float32); outputs come back
in float32. The dense layers are named ``hidden.{i}`` and ``out``, the
names ``models/convert.py: from_flax`` gives flax's ``Dense_{i}``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ape_x_dqn_tpu_torch.models.base import dtype_of, preprocess_obs
from ape_x_dqn_tpu_torch.models.qnets import _dense


class DPGActor(nn.Module):
    def __init__(self, obs_dim: int, action_dim: int,
                 action_low: float = -1.0, action_high: float = 1.0,
                 hidden: Sequence[int] = (300, 200),
                 compute_dtype: str = "float32"):
        super().__init__()
        self.dt = dtype_of(compute_dtype)
        widths = [obs_dim, *hidden]
        self.hidden = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(widths[:-1], widths[1:]))
        self.out = nn.Linear(widths[-1], action_dim)
        self.mid = (action_high + action_low) / 2.0
        self.half = (action_high - action_low) / 2.0

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        """obs [B, D] -> actions [B, A] float32 in [low, high]."""
        x = preprocess_obs(obs, self.dt)
        for layer in self.hidden:
            x = F.relu(_dense(layer, x, self.dt))
        a = torch.tanh(_dense(self.out, x, self.dt))
        return (self.mid + self.half * a).float()


class DPGCritic(nn.Module):
    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (300, 200),
                 compute_dtype: str = "float32"):
        super().__init__()
        self.dt = dtype_of(compute_dtype)
        widths = [obs_dim + action_dim, *hidden]
        self.hidden = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(widths[:-1], widths[1:]))
        self.out = nn.Linear(widths[-1], 1)

    def forward(self, obs: torch.Tensor,
                action: torch.Tensor) -> torch.Tensor:
        """obs [B, D], action [B, A] -> Q [B] float32."""
        x = torch.cat([preprocess_obs(obs, self.dt), action.to(self.dt)],
                      dim=-1)
        for layer in self.hidden:
            x = F.relu(_dense(layer, x, self.dt))
        return _dense(self.out, x, self.dt).squeeze(-1).float()


# the inference server runs mu(s) and Q(s, mu(s)) as one module
# (runtime/family.py) over one dict of "actor.*" and "critic.*" keys
PARTS = ("actor", "critic")


def server_params(parts) -> dict:
    """{"actor": state dict, "critic": state dict} -> the server's one
    dict of "actor.*" and "critic.*" keys (the values are not copied)."""
    return {f"{name}.{k}": v for name in PARTS
            for k, v in parts[name].items()}


def split_server_params(params: dict) -> dict:
    """The inverse of `server_params`: a key of any other prefix
    raises."""
    out: dict = {name: {} for name in PARTS}
    for key, v in params.items():
        name, _, k = key.partition(".")
        out[name][k] = v
    return out
