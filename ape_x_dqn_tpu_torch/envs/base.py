"""Environment interface.

Counterpart of ``ape_x_dqn_tpu/envs/base.py``: a host-side (numpy)
environment API for the trainer's acting loop. The environments are
native implementations (CartPole physics, a synthetic ALE-compatible
game, a pendulum swing-up), with the real ALE and dm_control behind an
import, exactly as in the JAX package; their steps are bitwise equal to
the originals' (tests/test_torch_envs.py, tests/test_torch_dpg_env.py).
"""

from __future__ import annotations

import abc
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


class Env(abc.ABC):
    """Minimal synchronous env: reset() -> obs, step(a) -> (obs, r, done, info).

    `done` is episode termination (true terminal OR time limit); `info` may
    carry `terminal` (bootstrapping-relevant termination, i.e. excluding
    time limits), `lives`, and `episode_return` on episode end.
    """

    spec: EnvSpec

    @abc.abstractmethod
    def reset(self) -> np.ndarray:
        ...

    @abc.abstractmethod
    def step(self, action) -> tuple[np.ndarray, float, bool, dict]:
        ...

    def seed(self, seed: int) -> None:  # pragma: no cover - default noop
        pass


def make_env(cfg, seed: int = 0, actor_index: int = 0) -> Env:
    """Factory from an EnvConfig (ape_x_dqn_tpu_torch.configs.EnvConfig)."""
    from ape_x_dqn_tpu_torch.envs import atari, cartpole

    kind = cfg.kind
    if kind == "cartpole":
        return cartpole.CartPole(seed=seed)
    if kind == "cartpole_po":
        return cartpole.MaskedCartPole(seed=seed)
    if kind in ("atari", "synthetic_atari"):
        return atari.make_atari(cfg, seed=seed, actor_index=actor_index)
    if kind == "control":
        from ape_x_dqn_tpu_torch.envs import control
        return control.make_control(cfg, seed=seed)
    raise ValueError(f"unknown env kind {kind!r}")
