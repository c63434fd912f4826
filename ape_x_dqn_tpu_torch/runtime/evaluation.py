"""Eval worker: greedy-policy evaluation episodes.

Counterpart of the part of ``ape_x_dqn_tpu/runtime/evaluation.py`` that
the driver runs: a periodic evaluator playing near-greedy (eps = 0.001)
episodes whose *unclipped* returns are the score, sharing the batched
inference server with the actors (one more client, no separate params
copy). Eval episodes differ from training ones in the standard ways: no
episodic-life pseudo-terminals, no reward clipping, near-greedy policy.

The standalone suite evaluation (``evaluate_suite``, ``run_suite_eval``,
the CLI's ``--eval-only``) waits for checkpoints (ROADMAP Queue A item
11); the continuous eval policy waits for its family (item 13).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

import numpy as np

from ape_x_dqn_tpu_torch.envs import make_env
from ape_x_dqn_tpu_torch.utils.metrics import ATARI_HUMAN_RANDOM, median_hns


class EvalWorker:
    """Runs greedy eval episodes against a Q-value query function."""

    def __init__(self, cfg, query_fn: Callable, game: str | None = None,
                 seed: int | None = None,
                 policy_factory: Callable[[], Callable] | None = None):
        """query_fn(obs) -> q-values [A] (e.g. the inference server's
        .query). policy_factory, when given, builds a fresh per-episode
        policy (obs -> q-values)."""
        self.cfg = cfg
        env_cfg = cfg.env
        if game is not None:
            if env_cfg.id == "atari57":
                # a per-game eval env for a multi-game net keeps the
                # shared 18-action legal set the net was sized for
                env_cfg = dataclasses.replace(env_cfg,
                                              full_action_set=True)
            env_cfg = dataclasses.replace(env_cfg, id=game)
        if env_cfg.kind in ("atari", "synthetic_atari"):
            env_cfg = dataclasses.replace(env_cfg, episodic_life=False,
                                          clip_rewards=False)
        seed = (cfg.seed + 977_231) if seed is None else seed
        self.env = make_env(env_cfg, seed=seed)
        self.query = query_fn
        self.policy_factory = policy_factory
        self.eps = cfg.eval_eps
        self.rng = np.random.default_rng(seed)
        # eval_max_frames counts RAW env frames (the Atari protocol's
        # 108k = 30 min at 60 Hz); a skipped env consumes frame_skip raw
        # frames per agent step
        self._frames_per_step = (
            env_cfg.frame_skip
            if env_cfg.kind in ("atari", "synthetic_atari") else 1)

    def run_episode(self, max_frames: int = 108_000,
                    stop_event=None,
                    deadline: float | None = None) -> float | None:
        """One episode -> its unclipped return, or None if stop_event
        fired or the wall-clock deadline passed mid-episode."""
        policy = (self.policy_factory() if self.policy_factory is not None
                  else self.query)
        obs = self.env.reset()
        ep_return = 0.0
        for _ in range(max(max_frames // self._frames_per_step, 1)):
            if stop_event is not None and stop_event.is_set():
                return None
            if deadline is not None and time.monotonic() > deadline:
                return None
            # always query, then eps-explore on top
            q = policy(obs)
            if self.rng.random() < self.eps:
                action = int(self.rng.integers(self.env.spec.num_actions))
            else:
                action = int(np.argmax(q))
            obs, reward, done, info = self.env.step(action)
            ep_return += info.get("raw_reward", reward)
            if done:
                # prefer the env's own unclipped accounting
                return float(info.get("episode_return", ep_return))
        return ep_return

    def run(self, episodes: int, max_frames: int = 108_000,
            stop_event=None, deadline_s: float | None = None) -> dict | None:
        """Aggregate stats over episodes; None if cancelled before any
        episode completed. deadline_s bounds the whole evaluation's wall
        clock (at shutdown an unbounded greedy policy could otherwise
        hold the driver for minutes)."""
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        returns = []
        for _ in range(episodes):
            r = self.run_episode(max_frames, stop_event=stop_event,
                                 deadline=deadline)
            if r is None:
                break
            returns.append(r)
        if not returns:
            return None
        return {
            "episodes": len(returns),
            "mean_return": float(np.mean(returns)),
            "median_return": float(np.median(returns)),
            "min_return": float(np.min(returns)),
            "max_return": float(np.max(returns)),
        }


def run_eval_measured(worker: EvalWorker, episodes: int, server,
                      stop_event=None,
                      deadline_s: float | None = None,
                      max_frames: int = 108_000
                      ) -> tuple[dict | None, int]:
    """worker.run while polling the shared server's queue depth at
    ~20 Hz -> (result, max depth seen DURING the eval): the
    back-pressure the eval puts on concurrent actors."""
    depth = {"max": int(server.queue_depth)}
    done = threading.Event()

    def poll():
        while not done.wait(0.05):
            depth["max"] = max(depth["max"], int(server.queue_depth))

    t = threading.Thread(target=poll, name="eval-depth-poll", daemon=True)
    t.start()
    try:
        res = worker.run(episodes, max_frames=max_frames,
                         stop_event=stop_event, deadline_s=deadline_s)
    finally:
        done.set()
        t.join(timeout=1.0)
    return res, depth["max"]


ATARI57_GAMES: tuple[str, ...] = tuple(sorted(ATARI_HUMAN_RANDOM))


def eval_game_rotation(cfg) -> tuple[bool, tuple[str, ...]]:
    """Whether a run's periodic eval rotates through the suite, and the
    game list: multi-game runs (env id 'atari57') must rotate, or a
    fixed worker would measure only the alphabetically-first game."""
    rotate = (cfg.env.id == "atari57"
              and cfg.env.kind in ("atari", "synthetic_atari"))
    return rotate, ATARI57_GAMES


class RollingSuiteScore:
    """Rolling per-game score table for the multi-game eval rotation:
    the latest unclipped return per game and a backend-marked rolling
    median HNS over the games seen so far (the unqualified key never
    appears for the synthetic backend)."""

    def __init__(self, cfg):
        from ape_x_dqn_tpu_torch.envs.atari import atari_backend

        self._backend = atari_backend(cfg.env.kind)
        self._scores: dict[str, float] = {}

    def update(self, game: str, mean_return: float) -> dict:
        """Record a game's latest eval; returns metric fields to log."""
        self._scores[game] = float(mean_return)
        known = {g: s for g, s in self._scores.items()
                 if g in ATARI_HUMAN_RANDOM}
        key = ("rolling_median_hns" if self._backend == "ale"
               else "rolling_median_hns_synthetic")
        out = {"eval_games_seen": len(self._scores)}
        if known:
            out[key] = median_hns(known)
        return out

    @property
    def scores(self) -> dict[str, float]:
        return dict(self._scores)


def final_eval_game(cfg) -> str | None:
    """The game of a driver's end-of-run fallback eval: a rotating
    config must name one (the first of the suite), not fall back to an
    unmarked default worker."""
    rotate, games = eval_game_rotation(cfg)
    return games[0] if rotate else None


def make_eval_policy_factory(family: str, lstm_size: int,
                             query_fn: Callable) -> Callable | None:
    """Per-episode eval policy builder per model family. Recurrent
    policies carry a fresh (c, h) across one episode's queries; plain
    Q-nets need none (EvalWorker queries directly); the continuous
    policy waits for its family."""
    if family == "dpg":
        raise NotImplementedError(
            "eval policies of the 'dpg' family are not ported to the "
            "PyTorch package yet: they wait for ROADMAP Queue A item 13")
    if family != "r2d2":
        return None

    def factory():
        state = {"c": np.zeros(lstm_size, np.float32),
                 "h": np.zeros(lstm_size, np.float32)}

        def policy(obs):
            out = query_fn({"obs": obs, "c": state["c"], "h": state["h"]})
            state["c"], state["h"] = out["c"], out["h"]
            return out["q"]

        return policy

    return factory
