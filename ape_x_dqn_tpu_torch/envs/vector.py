"""Synchronous vectorized env driver.

Counterpart of ``ape_x_dqn_tpu/envs/vector.py``. A vector actor steps
several envs per thread so that one batched forward of the inference
server serves many env steps. Autoresets on done: the observation
returned for a done env is the first observation of its next episode;
the pre-reset observation, terminal flag and episode stats are reported
in that step's info.
"""

from __future__ import annotations

import numpy as np

from ape_x_dqn_tpu_torch.envs.base import Env


class SyncVectorEnv:
    def __init__(self, envs: list[Env]):
        assert envs, "need at least one env"
        self.envs = envs
        self.spec = envs[0].spec
        self.num_envs = len(envs)

    def reset(self) -> np.ndarray:
        return np.stack([e.reset() for e in self.envs])

    def step(self, actions):
        obs, rewards, dones, infos = [], [], [], []
        for env, a in zip(self.envs, actions):
            o, r, d, info = env.step(a)
            if d:
                # keep the pre-reset observation: time-limit ends bootstrap
                # from it (terminal=False), so it must survive the autoreset
                info["terminal_obs"] = o
                o = env.reset()
            obs.append(o)
            rewards.append(r)
            dones.append(d)
            infos.append(info)
        return (np.stack(obs), np.asarray(rewards, np.float32),
                np.asarray(dones, bool), infos)
