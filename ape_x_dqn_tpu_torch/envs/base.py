"""Environment interface: the static spec only (the env classes wait for
the actor slice)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class EnvSpec:
    """Static description of an environment's interfaces."""

    obs_shape: tuple[int, ...]
    obs_dtype: np.dtype
    discrete: bool
    num_actions: int = 0  # discrete only
    action_dim: int = 0  # continuous only
    action_low: float = -1.0
    action_high: float = 1.0
