"""Eval worker: greedy-policy evaluation episodes.

Counterpart of the part of ``ape_x_dqn_tpu/runtime/evaluation.py`` that
the driver runs: a periodic evaluator playing near-greedy (eps = 0.001)
episodes whose *unclipped* returns are the score, sharing the batched
inference server with the actors (one more client, no separate params
copy). Eval episodes differ from training ones in the standard ways: no
episodic-life pseudo-terminals, no reward clipping, near-greedy policy.

The standalone suite evaluation is here too: `evaluate_suite` (per-game
greedy scores -> the median human-normalized score) and
`run_suite_eval` (the CLI's ``--eval-only``: params restored from the
newest checkpoint, no learner, no actors).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Iterable

import numpy as np
import torch

from ape_x_dqn_tpu_torch.envs import make_env
from ape_x_dqn_tpu_torch.models.dpg import PARTS, server_params
from ape_x_dqn_tpu_torch.utils.metrics import ATARI_HUMAN_RANDOM, median_hns


class EvalWorker:
    """Runs greedy eval episodes against a Q-value query function."""

    def __init__(self, cfg, query_fn: Callable, game: str | None = None,
                 seed: int | None = None,
                 policy_factory: Callable[[], Callable] | None = None):
        """query_fn(obs) -> q-values [A] (e.g. the inference server's
        .query). policy_factory, when given, builds a fresh per-episode
        policy: obs -> q-values for discrete envs, obs -> the action for
        continuous ones (the deterministic DPG actor)."""
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
        discrete = self.env.spec.discrete
        obs = self.env.reset()
        ep_return = 0.0
        for _ in range(max(max_frames // self._frames_per_step, 1)):
            if stop_event is not None and stop_event.is_set():
                return None
            if deadline is not None and time.monotonic() > deadline:
                return None
            if not discrete:
                action = np.asarray(policy(obs))  # deterministic mu(s)
            else:
                # always query (a recurrent policy advances its state
                # every step), then eps-explore on top
                q = policy(obs)
                if self.rng.random() < self.eps:
                    action = int(
                        self.rng.integers(self.env.spec.num_actions))
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
    policies carry a fresh (c, h) across one episode's queries;
    continuous policies return the deterministic action mu(s); plain
    Q-nets need none (EvalWorker queries directly)."""
    if family == "dpg":
        return lambda: lambda obs: query_fn(obs)["a"]
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


def evaluate_suite(cfg, query_fn: Callable,
                   games: Iterable[str] | None = None,
                   episodes_per_game: int | None = None,
                   max_frames: int = 108_000,
                   policy_factory: Callable | None = None) -> dict:
    """Per-game greedy scores -> median human-normalized score.

    Loops the suite, evaluates each game with the shared query_fn, and
    aggregates the Atari-57 metric. Returns {"scores": {game: mean},
    "hns": {game: hns}, "backends": {game: "ale"|"synthetic"}, and
    EITHER "median_hns" (every game ran on the real ALE) OR
    "median_hns_synthetic" (the in-image catch stand-in ran instead).
    The split key is deliberate: without `ale_py`, make_env substitutes
    SyntheticAtari for every game, and an unmarked "median_hns" from
    that path would look like the real number while measuring a catch
    game."""
    from ape_x_dqn_tpu_torch.envs.atari import atari_backend
    from ape_x_dqn_tpu_torch.utils.metrics import human_normalized_score

    games = tuple(games) if games is not None else ATARI57_GAMES
    # at least one episode: configs carry eval_episodes=0 to switch off
    # the TRAINING-time eval, and a suite score of None is useless
    episodes = max(episodes_per_game or cfg.eval_episodes, 1)
    backend = atari_backend(cfg.env.kind)
    scores: dict[str, float] = {}
    for game in games:
        worker = EvalWorker(cfg, query_fn, game=game,
                            policy_factory=policy_factory)
        scores[game] = worker.run(episodes, max_frames)["mean_return"]
    known = {g: s for g, s in scores.items() if g in ATARI_HUMAN_RANDOM}
    out = {
        "scores": scores,
        "hns": {g: human_normalized_score(g, s) for g, s in known.items()},
        "backends": {g: backend for g in scores},
    }
    key = "median_hns" if backend == "ale" else "median_hns_synthetic"
    out[key] = median_hns(known)
    return out


def checkpoint_server_params(family: str, saved_params: dict) -> dict:
    """A checkpoint's "params" entry -> the params the family's server
    forward takes (runtime/family.py: the dqn and r2d2 nets' state
    dicts; for dpg the {actor.*, critic.*} keys of one dict)."""
    if family == "dpg":
        return server_params(saved_params)
    return dict(saved_params)


def run_suite_eval(cfg, games: Iterable[str] | None = None,
                   episodes_per_game: int | None = None,
                   checkpoint_dir: str | None = None,
                   max_frames: int = 108_000,
                   device: str = "cuda") -> dict:
    """Standalone evaluation (the CLI's --eval-only): build the net,
    restore the newest checkpoint's params, and run greedy episodes —
    the HNS suite for Atari configs, the config's own env otherwise. No
    learner, no actors, no training state. Without a checkpoint the
    freshly initialised params play (restored_step None). The summary
    carries `params_crc32`, the fingerprint of the params that played."""
    from ape_x_dqn_tpu_torch.models import build_network
    from ape_x_dqn_tpu_torch.runtime.family import (
        family_of, family_setup, server_apply_fn)
    from ape_x_dqn_tpu_torch.utils.checkpoint import CheckpointManager
    from ape_x_dqn_tpu_torch.utils.misc import resolve_device

    if games is not None and cfg.env.kind not in ("atari",
                                                  "synthetic_atari"):
        # per-game Atari envs give 84x84x4 observations, which cannot
        # feed a network sized for this config's own env
        raise ValueError(
            f"--games is only valid for Atari configs (env.kind 'atari' "
            f"or 'synthetic_atari'), got kind={cfg.env.kind!r}")
    dev = resolve_device(device)
    family = family_of(cfg)
    probe = make_env(cfg.env, seed=cfg.seed)
    spec = probe.spec
    net = build_network(cfg.network, spec)
    family_setup(cfg, spec, net, probe.reset())
    nets = net if family == "dpg" else (net,)
    for module in nets:
        module.to(dev)
    params = (server_params({name: m.state_dict()
                             for name, m in zip(PARTS, net)})
              if family == "dpg" else net.state_dict())
    params = {k: v.detach() for k, v in params.items()}
    restored_step = None
    if checkpoint_dir:
        mngr = CheckpointManager(checkpoint_dir)
        restored_step = mngr.latest_step()
        if restored_step is not None:
            # no template: only the params are needed from the payload
            raw = mngr.restore(restored_step)
            params = {k: v.to(dev) for k, v in checkpoint_server_params(
                family, raw["params"]).items()}
        mngr.close()
    fn = server_apply_fn(family, net)

    def to_dev(x):
        return torch.as_tensor(np.asarray(x))[None].to(dev)

    @torch.no_grad()
    def query(inp):
        batched = ({k: to_dev(v) for k, v in inp.items()}
                   if isinstance(inp, dict) else to_dev(inp))
        out = fn(params, batched)
        if isinstance(out, dict):
            return {k: v[0].float().cpu().numpy() for k, v in out.items()}
        return out[0].float().cpu().numpy()

    factory = make_eval_policy_factory(family, cfg.network.lstm_size,
                                       query)
    if games is None and cfg.env.kind not in ("atari", "synthetic_atari"):
        worker = EvalWorker(cfg, query, policy_factory=factory)
        out = worker.run(max(episodes_per_game or cfg.eval_episodes, 1),
                         max_frames)
    else:
        out = evaluate_suite(cfg, query, games=games,
                             episodes_per_game=episodes_per_game,
                             max_frames=max_frames,
                             policy_factory=factory)
    out["restored_step"] = restored_step
    out["params_crc32"] = params_crc32(params)
    return out


def params_crc32(params: dict) -> int:
    """One CRC-32 over a param dict's tensors, in sorted key order: the
    eval-only summary's fingerprint of the params it played, comparable
    bitwise with a checkpoint's."""
    import zlib

    crc = 0
    for k in sorted(params):
        t = params[k].detach().to("cpu").contiguous().reshape(-1)
        crc = zlib.crc32(k.encode(), crc)
        crc = zlib.crc32(t.view(torch.uint8).numpy(), crc)
    return crc
