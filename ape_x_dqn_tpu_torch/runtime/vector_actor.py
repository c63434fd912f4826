"""Vectorized actor: one thread drives K envs per batched inference query.

Counterpart of ``ape_x_dqn_tpu/runtime/vector_actor.py`` for the
flat-DQN family. One actor thread steps a SyncVectorEnv of K envs and
sends ONE K-item query per vector step
(`BatchedInferenceServer.query_batch`), so the server sees batch-K work
from a single thread and the per-step round trip amortises K ways.

Per-env bookkeeping (n-step building, initial-priority resolution,
frame-segment assembly) stays host-side numpy per env core. The
one-step pending mechanism is the scalar actor's, applied per env;
truncation flushes batch their terminal observations into one extra
query per vector step.

Each env core owns a distinct slot of the global Horgan eps schedule:
vector actor i's env j is global slot i*K+j of num_actors*K. Seeds
follow the original exactly (env seed*10007 + slot, policy
seed*7919 + i). `RecurrentVectorActor` is the R2D2 variant; the
continuous one waits for its slice (ROADMAP Queue A item 13).
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np

from ape_x_dqn_tpu_torch.envs import make_env
from ape_x_dqn_tpu_torch.envs.vector import SyncVectorEnv
from ape_x_dqn_tpu_torch.obs.core import NULL_OBS
from ape_x_dqn_tpu_torch.ops.nstep import NStepBuilder, NStepTransition
from ape_x_dqn_tpu_torch.replay.frame_ring import FrameSegmentBuilder
from ape_x_dqn_tpu_torch.replay.sequence import SequenceBuilder
from ape_x_dqn_tpu_torch.runtime.actor import (
    DiscretePolicyHooks, actor_epsilon, feed_sequence, resolve_pending,
    sequence_builder, sequence_ship_after, ship_flat_outbox,
    ship_sequence_outbox)


class _EnvCore:
    """Per-env actor state: eps slot, n-step window, pending
    initial-priority list, optional frame-segment builder."""

    __slots__ = ("eps", "nstep", "pending", "seg")

    def __init__(self, eps: float, nstep: NStepBuilder,
                 seg: FrameSegmentBuilder | None):
        self.eps = eps
        self.nstep = nstep
        self.pending: list[NStepTransition] = []
        self.seg = seg


def _split(out, k: int) -> list:
    """Slice a batched reply (an array, or a dict of arrays) into k
    per-env replies."""
    if isinstance(out, dict):
        return [{key: v[j] for key, v in out.items()} for j in range(k)]
    return [out[j] for j in range(k)]


class VectorActor(DiscretePolicyHooks):
    """Flat-DQN family vector actor. Same constructor and run contract
    as runtime.actor.Actor, except query_fn is the server's
    `query_batch` (inputs carry a leading [K] batch dim)."""

    _ships_frame_segments = True

    def __init__(self, cfg, actor_index: int,
                 query_fn: Callable[[np.ndarray, int], np.ndarray],
                 transport, seed: int | None = None,
                 episode_callback: Callable[[int, dict], None] | None = None,
                 obs: object | None = None):
        self.cfg = cfg
        self.index = actor_index
        self.query = query_fn
        self.transport = transport
        self.obs = obs if obs is not None else NULL_OBS
        self._hb = f"actor-{actor_index}"
        seed = cfg.seed if seed is None else seed
        self.K = max(cfg.actors.envs_per_actor, 1)
        total_slots = cfg.actors.num_actors * self.K
        envs = []
        self.cores: list[_EnvCore] = []
        frame_ring = (self._ships_frame_segments
                      and getattr(cfg.replay, "storage", "flat")
                      == "frame_ring")
        for j in range(self.K):
            g = actor_index * self.K + j  # global eps-schedule slot
            envs.append(make_env(cfg.env, seed=seed * 10_007 + g,
                                 actor_index=g))
            seg = None
            if frame_ring:
                spec = envs[-1].spec
                assert spec.discrete and len(spec.obs_shape) == 3, \
                    "frame_ring storage needs discrete [H, W, stack] " \
                    "pixel envs"
                seg = FrameSegmentBuilder(
                    cfg.replay.seg_transitions, cfg.learner.n_step,
                    stack=spec.obs_shape[-1])
            self.cores.append(_EnvCore(
                actor_epsilon(g, total_slots, cfg.actors.base_eps,
                              cfg.actors.eps_alpha),
                NStepBuilder(cfg.learner.n_step, cfg.learner.gamma), seg))
        self.venv = SyncVectorEnv(envs)
        self.spec = self.venv.spec
        self.rng = np.random.default_rng(seed * 7919 + actor_index)
        self.episode_callback = episode_callback
        self.frames = 0
        self._frames_unshipped = 0
        self._outbox: list[tuple[NStepTransition, float]] = []

    # -- priority resolution / shipping (per-env cores, shared outbox) ----

    def _queue(self, core: _EnvCore, t: NStepTransition,
               priority: float) -> None:
        if core.seg is not None:
            core.seg.add(t.action, t.reward, t.discount, t.span, priority)
        else:
            self._outbox.append((t, priority))

    def _resolve_pending(self, core: _EnvCore, out) -> None:
        if not core.pending:
            return
        resolve_pending(core.pending, self._bootstrap_value(out),
                        lambda t, p: self._queue(core, t, p))

    def _ship(self, force: bool = False) -> None:
        if any(c.seg is not None for c in self.cores):
            for core in self.cores:
                segs = (core.seg.flush() if force
                        else core.seg.take_ready())
                for seg in segs:
                    seg["actor"] = self.index
                    seg["frames"] = self._frames_unshipped
                    self._frames_unshipped = 0
                    self.transport.send_experience(seg)
            return
        if not self._outbox:
            return
        if not force and len(self._outbox) < self.cfg.actors.ingest_batch:
            return
        ship_flat_outbox(self._outbox, self._action_array, self.index,
                         self._frames_unshipped, self.transport)
        self._outbox = []
        self._frames_unshipped = 0

    # -- main loop ---------------------------------------------------------

    def run(self, max_frames: int,
            stop_event: threading.Event | None = None) -> int:
        obs = self.venv.reset()  # [K, ...]
        for j, core in enumerate(self.cores):
            if core.seg is not None:
                core.seg.on_reset(obs[j])
        while self.frames < max_frames and not (
                stop_event is not None and stop_event.is_set()):
            self.obs.beat(self._hb)
            with self.obs.span("actor.inference", k=self.K):
                out = self.query(obs, self.K)
            outs = _split(out, self.K)
            actions = []
            for j, core in enumerate(self.cores):
                self._resolve_pending(core, outs[j])
                actions.append(self._select_action(outs[j], core.eps))
            next_obs, rewards, dones, infos = self.venv.step(actions)
            self.frames += self.K
            self._frames_unshipped += self.K
            # per-env n-step append; the autoreset means env j's true
            # post-step observation is terminal_obs when done
            emitted: list[list[NStepTransition]] = []
            trunc_j: list[int] = []
            for j, core in enumerate(self.cores):
                info = infos[j]
                done = bool(dones[j])
                terminal = bool(info.get("terminal", done))
                truncated = done and not terminal
                step_next = info["terminal_obs"] if done else next_obs[j]
                if core.seg is not None:
                    core.seg.on_step(step_next)
                emitted.append(core.nstep.append(
                    obs[j], actions[j], float(rewards[j]), step_next,
                    terminal, truncated,
                    aux=self._taken_value(outs[j], actions[j])))
                if truncated and any(t.discount != 0.0
                                     for t in emitted[-1]):
                    trunc_j.append(j)
            # truncation flushes bootstrap from their terminal obs: one
            # batched query for all truncated envs this step (rare)
            v_term: dict[int, float] = {}
            if trunc_j:
                tb = np.stack([infos[j]["terminal_obs"] for j in trunc_j])
                touts = _split(self.query(tb, len(trunc_j)), len(trunc_j))
                for i, j in enumerate(trunc_j):
                    v_term[j] = self._bootstrap_value(touts[i])
            for j, core in enumerate(self.cores):
                for t in emitted[j]:
                    if t.discount == 0.0:
                        self._queue(core, t, abs(t.reward - float(t.aux)))
                    elif j in v_term:
                        target = t.reward + t.discount * v_term[j]
                        self._queue(core, t, abs(target - float(t.aux)))
                    else:
                        core.pending.append(t)
                if dones[j]:
                    if core.seg is not None:
                        # flushes the open partial segment: segments
                        # never span episodes (the autoreset obs seeds
                        # the next)
                        core.seg.on_reset(next_obs[j])
                    if (self.episode_callback
                            and "episode_return" in infos[j]):
                        self.episode_callback(self.index, infos[j])
            obs = next_obs
            self._ship()
        # shutdown: resolve parked transitions with one final batched
        # forward (their bootstrap obs is each env's current obs)
        if any(core.pending for core in self.cores):
            try:
                outs = _split(self.query(obs, self.K), self.K)
                for j, core in enumerate(self.cores):
                    self._resolve_pending(core, outs[j])
            except Exception:
                for core in self.cores:
                    core.pending.clear()  # server down: drop, don't die
        self._ship(force=True)
        return self.frames


class _RecurrentEnvCore:
    """Per-env recurrent actor state: eps slot, sequence builder,
    carried LSTM state, and the one-step-parked record awaiting its
    1-step TD bootstrap (as in runtime.actor.RecurrentActor)."""

    __slots__ = ("eps", "builder", "c", "h", "prev")

    def __init__(self, eps: float, builder: SequenceBuilder,
                 lstm_size: int):
        self.eps = eps
        self.builder = builder
        self.c = np.zeros(lstm_size, np.float32)
        self.h = np.zeros(lstm_size, np.float32)
        self.prev: dict | None = None

    def zero_state(self) -> None:
        self.c = np.zeros_like(self.c)
        self.h = np.zeros_like(self.h)


class RecurrentVectorActor:
    """R2D2 vector actor: K envs per thread, one batched stateful query
    per vector step ({obs, c, h}, each with a leading [K] axis), per-env
    SequenceBuilders shipping stored-state sequences.

    Per env core the semantics are runtime.actor.RecurrentActor's (the
    parked record, the terminal and truncation TD seeds, the state
    zeroed at episode end), with the truncation bootstrap queries of
    all truncated envs batched into one extra query per vector step."""

    def __init__(self, cfg, actor_index: int, query_fn, transport,
                 seed: int | None = None, episode_callback=None,
                 obs: object | None = None):
        self.cfg = cfg
        self.index = actor_index
        self.query = query_fn
        self.transport = transport
        self.obs = obs if obs is not None else NULL_OBS
        self._hb = f"actor-{actor_index}"
        seed = cfg.seed if seed is None else seed
        self.K = max(cfg.actors.envs_per_actor, 1)
        self.gamma = cfg.learner.gamma
        self.lstm_size = cfg.network.lstm_size
        total_slots = cfg.actors.num_actors * self.K
        envs, self.cores = [], []
        for j in range(self.K):
            g = actor_index * self.K + j
            envs.append(make_env(cfg.env, seed=seed * 10_007 + g,
                                 actor_index=g))
            self.cores.append(_RecurrentEnvCore(
                actor_epsilon(g, total_slots, cfg.actors.base_eps,
                              cfg.actors.eps_alpha),
                sequence_builder(cfg, envs[-1].spec.obs_shape),
                self.lstm_size))
        self.venv = SyncVectorEnv(envs)
        self.spec = self.venv.spec
        self.rng = np.random.default_rng(seed * 7919 + actor_index)
        self.episode_callback = episode_callback
        self.frames = 0
        self._frames_unshipped = 0
        self.ship_after = sequence_ship_after(cfg)
        self._outbox: list[dict] = []

    def _feed(self, core: _RecurrentEnvCore, rec: dict, td: float) -> None:
        feed_sequence(self._outbox, core.builder, rec, td)

    def _resolve_prev(self, core: _RecurrentEnvCore, q_next) -> None:
        """The parked record's 1-step TD bootstrap arrives with the next
        query's Q-values for this env."""
        if core.prev is None:
            return
        td = (core.prev["reward"] + self.gamma * float(np.max(q_next))
              - core.prev["q_sa"])
        self._feed(core, core.prev, td)
        core.prev = None

    def _ship(self, force: bool = False) -> None:
        if not self._outbox:
            return
        if not force and len(self._outbox) < self.ship_after:
            return
        ship_sequence_outbox(self._outbox, self.index,
                             self._frames_unshipped, self.transport)
        self._outbox = []
        self._frames_unshipped = 0

    def _query_all(self, obs) -> dict:
        return self.query({
            "obs": obs,
            "c": np.stack([core.c for core in self.cores]),
            "h": np.stack([core.h for core in self.cores])}, self.K)

    def run(self, max_frames: int,
            stop_event: threading.Event | None = None) -> int:
        obs = self.venv.reset()
        while self.frames < max_frames and not (
                stop_event is not None and stop_event.is_set()):
            self.obs.beat(self._hb)
            with self.obs.span("actor.inference", k=self.K):
                out = self._query_all(obs)
            q, cs, hs = (np.asarray(out["q"]), np.asarray(out["c"]),
                         np.asarray(out["h"]))
            actions = []
            for j, core in enumerate(self.cores):
                self._resolve_prev(core, q[j])
                if self.rng.random() < core.eps:
                    actions.append(int(self.rng.integers(
                        self.spec.num_actions)))
                else:
                    actions.append(int(np.argmax(q[j])))
            next_obs, rewards, dones, infos = self.venv.step(actions)
            self.frames += self.K
            self._frames_unshipped += self.K
            # first pass: build the records, collect truncations
            recs, trunc_j = [], []
            for j, core in enumerate(self.cores):
                info = infos[j]
                done = bool(dones[j])
                terminal = bool(info.get("terminal", done))
                recs.append(dict(
                    obs=obs[j], action=actions[j],
                    reward=float(rewards[j]), terminal=terminal,
                    pre_state=(core.c, core.h),
                    q_sa=float(q[j][actions[j]]), episode_end=done))
                if done and not terminal:
                    trunc_j.append(j)
            # truncation: the sequence ends (the state resets) but the
            # bootstrap survives: one batched query on the truncated
            # envs' final observations with their post-step states
            v_term: dict[int, float] = {}
            if trunc_j:
                tout = self.query({
                    "obs": np.stack([infos[j]["terminal_obs"]
                                     for j in trunc_j]),
                    "c": np.stack([cs[j] for j in trunc_j]),
                    "h": np.stack([hs[j] for j in trunc_j])},
                    len(trunc_j))
                tq = np.asarray(tout["q"])
                for i, j in enumerate(trunc_j):
                    v_term[j] = float(np.max(tq[i]))
            # second pass: route the records, advance or reset the state
            for j, core in enumerate(self.cores):
                rec = recs[j]
                if rec["terminal"]:
                    self._feed(core, rec, rec["reward"] - rec["q_sa"])
                elif j in v_term:
                    td = (rec["reward"] + self.gamma * v_term[j]
                          - rec["q_sa"])
                    self._feed(core, rec, td)
                else:
                    core.prev = rec
                if dones[j]:
                    core.zero_state()
                    if (self.episode_callback
                            and "episode_return" in infos[j]):
                        self.episode_callback(self.index, infos[j])
                else:
                    core.c, core.h = cs[j], hs[j]
            obs = next_obs
            self._ship()
        # shutdown: resolve the parked records with one final batched
        # forward, flush the partial sequence tails, ship everything
        if any(core.prev is not None for core in self.cores):
            try:
                q = np.asarray(self._query_all(obs)["q"])
                for j, core in enumerate(self.cores):
                    if core.prev is not None:
                        core.prev["episode_end"] = False
                        self._resolve_prev(core, q[j])
            except Exception:  # server down: seed without the bootstrap
                for core in self.cores:
                    if core.prev is not None:
                        core.prev["episode_end"] = False
                        self._feed(core, core.prev,
                                   core.prev["reward"] - core.prev["q_sa"])
                        core.prev = None
        for core in self.cores:
            self._outbox.extend(core.builder.flush())
        self._ship(force=True)
        return self.frames
