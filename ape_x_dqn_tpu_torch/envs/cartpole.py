"""CartPole-v1, implemented natively.

Counterpart of ``ape_x_dqn_tpu/envs/cartpole.py``: classic cart-pole
balancing dynamics (Barto, Sutton & Anderson 1983) with the standard
CartPole-v1 constants and termination bounds: reward +1 per step,
episode cap 500, solved at average return >= 475.
"""

from __future__ import annotations

import math

import numpy as np

from ape_x_dqn_tpu_torch.envs.base import Env, EnvSpec


class CartPole(Env):
    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    TOTAL_MASS = CART_MASS + POLE_MASS
    HALF_LENGTH = 0.5
    POLE_MASS_LENGTH = POLE_MASS * HALF_LENGTH
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_LIMIT = 12 * 2 * math.pi / 360
    X_LIMIT = 2.4
    MAX_STEPS = 500

    spec = EnvSpec(obs_shape=(4,), obs_dtype=np.dtype(np.float32),
                   discrete=True, num_actions=2)

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros(4, np.float32)
        self._steps = 0
        self._ep_return = 0.0

    def seed(self, seed: int) -> None:
        self._rng = np.random.default_rng(seed)

    def reset(self) -> np.ndarray:
        self._state = self._rng.uniform(-0.05, 0.05, size=4).astype(np.float32)
        self._steps = 0
        self._ep_return = 0.0
        return self._state.copy()

    def step(self, action):
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE_MAG if action == 1 else -self.FORCE_MAG
        cos_t, sin_t = math.cos(theta), math.sin(theta)
        temp = (force + self.POLE_MASS_LENGTH * theta_dot**2 * sin_t) \
            / self.TOTAL_MASS
        theta_acc = (self.GRAVITY * sin_t - cos_t * temp) / (
            self.HALF_LENGTH
            * (4.0 / 3.0 - self.POLE_MASS * cos_t**2 / self.TOTAL_MASS))
        x_acc = temp - self.POLE_MASS_LENGTH * theta_acc * cos_t \
            / self.TOTAL_MASS
        # Euler integration, semi-implicit order as in the classic task
        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * x_acc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * theta_acc
        self._state = np.array([x, x_dot, theta, theta_dot], np.float32)
        self._steps += 1

        fell = bool(abs(x) > self.X_LIMIT or abs(theta) > self.THETA_LIMIT)
        truncated = self._steps >= self.MAX_STEPS
        done = fell or truncated
        reward = 1.0
        self._ep_return += reward
        info: dict = {"terminal": fell}
        if done:
            info["episode_return"] = self._ep_return
            info["episode_length"] = self._steps
        return self._state.copy(), reward, done, info


class MaskedCartPole(CartPole):
    """Partially observable CartPole: velocities are hidden.

    obs = [x, theta] only — the classic POMDP variant where a memoryless
    policy cannot infer x_dot/theta_dot (the R2D2 runtime's end-to-end
    task in the JAX package).
    """

    spec = EnvSpec(obs_shape=(2,), obs_dtype=np.dtype(np.float32),
                   discrete=True, num_actions=2)

    def _mask(self, obs: np.ndarray) -> np.ndarray:
        return obs[[0, 2]]

    def reset(self) -> np.ndarray:
        return self._mask(super().reset())

    def step(self, action):
        obs, reward, done, info = super().step(action)
        return self._mask(obs), reward, done, info
