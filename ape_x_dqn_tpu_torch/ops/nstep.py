"""Host-side n-step return builder for acting loops.

Counterpart of ``ape_x_dqn_tpu/ops/nstep.py``. Each env keeps a rolling
window of its last n steps and emits an n-step transition (s_t, a_t,
R_n, s_{t+n}, gamma^n * (1 - terminal)) once the window fills, flushing
shortened tails at episode end. Pure numpy: this runs on the host.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np


@dataclass
class NStepTransition:
    obs: np.ndarray
    action: int | np.ndarray
    reward: float        # accumulated discounted n-step return
    next_obs: np.ndarray
    discount: float      # gamma^k * (1 - terminal), k = actual steps spanned
    aux: object = None   # caller payload from the FIRST step of the window
                         # (actors stash q_t(a_t) here for initial priorities)
    span: int = 0        # k: env steps between obs and next_obs


class NStepBuilder:
    def __init__(self, n_step: int, gamma: float):
        if n_step < 1:
            raise ValueError(f"n_step must be >= 1, got {n_step}")
        self.n = n_step
        self.gamma = gamma
        self._window: deque = deque()

    def append(self, obs, action, reward: float, next_obs,
               terminal: bool, truncated: bool = False,
               aux=None) -> list[NStepTransition]:
        """Add one env step; returns 0+ completed n-step transitions.

        `terminal` is a bootstrapping-relevant episode end (discount -> 0);
        `truncated` ends the episode without zeroing the bootstrap
        (time-limit: flush with discount gamma^k).
        """
        self._window.append((obs, action, float(reward), aux))
        out: list[NStepTransition] = []
        if terminal or truncated:
            # flush the whole window through the episode end — including a
            # just-filled window, which must NOT bootstrap past a terminal
            bootstrap = 0.0 if terminal else 1.0
            while self._window:
                out.append(self._emit(next_obs, bootstrap))
                self._window.popleft()
        elif len(self._window) == self.n:
            out.append(self._emit(next_obs, 1.0))
            self._window.popleft()
        return out

    def _emit(self, next_obs, bootstrap: float) -> NStepTransition:
        ret = 0.0
        for k, (_, _, r, _) in enumerate(self._window):
            ret += (self.gamma**k) * r
        k_span = len(self._window)
        obs0, action0, _, aux0 = self._window[0]
        return NStepTransition(
            obs=obs0, action=action0, reward=ret, next_obs=next_obs,
            discount=(self.gamma**k_span) * bootstrap, aux=aux0,
            span=k_span)

    def reset(self) -> None:
        self._window.clear()
