"""Continuous-control environments for the Ape-X DPG config.

Counterpart of ``ape_x_dqn_tpu/envs/control.py``. Env ids with an
underscore ("pendulum_swingup", "humanoid_stand", any
"<domain>_<task>") name a dm_control suite task and route to
`DMControlAdapter`, which runs the real MuJoCo physics behind the Env
API; such an id raises when dm_control cannot be imported. The native
`PendulumSwingUp` (id "pendulum", no underscore) is the dependency-free
deterministic stand-in, numpy for numpy the original's, so both
packages step it bit for bit alike.
"""

from __future__ import annotations

import numpy as np

from ape_x_dqn_tpu_torch.envs.base import Env, EnvSpec

try:
    from dm_control import suite  # type: ignore
    HAVE_DM_CONTROL = True
except ImportError:
    HAVE_DM_CONTROL = False


class PendulumSwingUp(Env):
    """Torque-limited pendulum swing-up.

    obs = [cos th, sin th, th_dot], action = torque in [-2, 2],
    reward = -(angle^2 + 0.1 th_dot^2 + 0.001 torque^2), horizon 200.
    """

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0
    MAX_STEPS = 200

    spec = EnvSpec(obs_shape=(3,), obs_dtype=np.dtype(np.float32),
                   discrete=False, action_dim=1,
                   action_low=-2.0, action_high=2.0)

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._th = 0.0
        self._th_dot = 0.0
        self._steps = 0
        self._ep_return = 0.0

    def seed(self, seed: int) -> None:
        self._rng = np.random.default_rng(seed)

    def _obs(self) -> np.ndarray:
        return np.array([np.cos(self._th), np.sin(self._th), self._th_dot],
                        np.float32)

    def reset(self) -> np.ndarray:
        self._th = float(self._rng.uniform(-np.pi, np.pi))
        self._th_dot = float(self._rng.uniform(-1.0, 1.0))
        self._steps = 0
        self._ep_return = 0.0
        return self._obs()

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          -self.MAX_TORQUE, self.MAX_TORQUE))
        th = ((self._th + np.pi) % (2 * np.pi)) - np.pi  # wrap to [-pi, pi]
        cost = th**2 + 0.1 * self._th_dot**2 + 0.001 * u**2
        self._th_dot += (3 * self.G / (2 * self.L) * np.sin(self._th)
                         + 3.0 / (self.M * self.L**2) * u) * self.DT
        self._th_dot = float(np.clip(self._th_dot, -self.MAX_SPEED,
                                     self.MAX_SPEED))
        self._th += self._th_dot * self.DT
        self._steps += 1
        done = self._steps >= self.MAX_STEPS
        reward = -float(cost)
        self._ep_return += reward
        info: dict = {"terminal": False}  # time limit only: bootstrap
        if done:
            info["episode_return"] = self._ep_return
            info["episode_length"] = self._steps
        return self._obs(), reward, done, info


class DMControlAdapter(Env):
    """A dm_control.suite task behind the Env API (flattened
    observations)."""

    def __init__(self, domain: str, task: str, seed: int = 0):
        self._env = suite.load(domain, task, task_kwargs={"random": seed})
        a_spec = self._env.action_spec()
        t = self._env.reset()
        dim = sum(int(np.prod(v.shape)) for v in t.observation.values())
        self.spec = EnvSpec(
            obs_shape=(dim,), obs_dtype=np.dtype(np.float32), discrete=False,
            action_dim=int(np.prod(a_spec.shape)),
            action_low=float(a_spec.minimum.min()),
            action_high=float(a_spec.maximum.max()))
        self._ep_return = 0.0

    def _flatten(self, obs_dict) -> np.ndarray:
        return np.concatenate(
            [np.asarray(v, np.float32).ravel() for v in obs_dict.values()])

    def reset(self) -> np.ndarray:
        self._ep_return = 0.0
        return self._flatten(self._env.reset().observation)

    def step(self, action):
        ts = self._env.step(np.asarray(action))
        reward = float(ts.reward or 0.0)
        self._ep_return += reward
        done = ts.last()
        info: dict = {"terminal": done and ts.discount == 0.0}
        if done:
            info["episode_return"] = self._ep_return
        return self._flatten(ts.observation), reward, done, info


def make_control(cfg, seed: int = 0) -> Env:
    if "_" in cfg.id:
        # an underscore id names a dm_control <domain>_<task>; silently
        # substituting the 3-d native pendulum would train another task
        # under the requested label
        if not HAVE_DM_CONTROL:
            raise ImportError(
                f"env id {cfg.id!r} names a dm_control task but "
                f"dm_control is not importable in this environment; "
                f"use id='pendulum' for the native stand-in")
        domain, task = cfg.id.split("_", 1)
        return DMControlAdapter(domain, task, seed=seed)
    return PendulumSwingUp(seed=seed)
