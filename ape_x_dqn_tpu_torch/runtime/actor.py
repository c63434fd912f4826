"""Actor runtime: eps_i-greedy env stepping against the inference server.

Counterpart of ``ape_x_dqn_tpu/runtime/actor.py`` for the flat-DQN
family. Each actor steps CPU envs with an eps_i-greedy policy (Horgan
et al. 2018: eps_i = base ** (1 + alpha * i / (N-1))), getting Q-values
from the batched inference server, accumulates n-step returns, computes
INITIAL priorities actor-side (fresh experience enters the sum-tree
with real TD magnitudes) and ships transition batches, or frame-ring
segments, through the transport.

A transition emitted at step t needs max_a Q(s_{t+n}), which arrives
with the NEXT server query, so non-terminal transitions park in a
one-step pending list. Terminal transitions (discount 0) and truncation
flushes resolve at once (the latter through one extra query on the
terminal observation).

Everything here is host numpy, and the generators are seeded exactly as
the original seeds them (env seed*10007 + i, policy seed*7919 + i), so
a port actor and a JAX actor fed the same Q-values ship bit-identical
streams. The recurrent (R2D2) actor, `RecurrentActor`, ships
stored-state sequences instead; the continuous (Ape-X DPG) actor,
`ContinuousActor`, acts with mu(s) plus Gaussian noise and seeds its
priorities from the critic's Q(s, mu(s)).
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np

from ape_x_dqn_tpu_torch.envs import make_env
from ape_x_dqn_tpu_torch.obs.core import NULL_OBS
from ape_x_dqn_tpu_torch.ops.nstep import NStepBuilder, NStepTransition
from ape_x_dqn_tpu_torch.replay.frame_ring import FrameSegmentBuilder
from ape_x_dqn_tpu_torch.replay.sequence import (SequenceBuilder,
                                                 split_priorities,
                                                 stack_items)


def actor_epsilon(i: int, n: int, base: float = 0.4,
                  alpha: float = 7.0) -> float:
    if n <= 1:
        return base
    return base ** (1.0 + alpha * i / (n - 1))


def flat_transition_batch(ts: list[NStepTransition], pris: np.ndarray,
                          actions: np.ndarray, actor_index: int,
                          frames: int) -> dict:
    """The wire format of a batch of flat n-step transitions, one schema
    for the scalar and vector actors (the ingest staging and
    transition_item_spec depend on these keys)."""
    return {
        "obs": np.stack([t.obs for t in ts]),
        "action": actions,
        "reward": np.asarray([t.reward for t in ts], np.float32),
        "next_obs": np.stack([t.next_obs for t in ts]),
        "discount": np.asarray([t.discount for t in ts], np.float32),
        "priorities": pris,
        "actor": actor_index,
        "frames": frames,
    }


def sequence_ship_after(cfg) -> int:
    """Sequences per shipment: ingest_batch counts TRANSITIONS, so
    sequences ship in proportionally smaller groups (shared by the
    scalar and vector recurrent actors)."""
    return max(1, cfg.actors.ingest_batch // cfg.replay.seq_length)


def feed_sequence(outbox: list, builder: SequenceBuilder, rec: dict,
                  td: float) -> None:
    """Append one recurrent step record (obs, action, reward, terminal,
    pre_state, episode_end) to a SequenceBuilder, routing any completed
    sequence items into the outbox."""
    outbox.extend(builder.append(
        rec["obs"], rec["action"], rec["reward"], rec["terminal"],
        rec["pre_state"], td=td, episode_end=rec["episode_end"]))


def ship_sequence_outbox(outbox: list, actor_index: int, frames: int,
                         transport) -> None:
    """Stack an outbox of sequence items into the wire batch and send
    it (one schema for the scalar and vector recurrent actors;
    sequence_item_spec depends on its keys)."""
    items, pris = split_priorities(outbox)
    batch = stack_items(items)
    batch["priorities"] = pris
    batch["actor"] = actor_index
    batch["frames"] = frames
    transport.send_experience(batch)


def sequence_builder(cfg, obs_shape: tuple[int, ...]) -> SequenceBuilder:
    """One env's SequenceBuilder: single frames per sequence under
    frame_ring storage, which needs [H, W, stack] pixel obs."""
    frame_mode = cfg.replay.storage == "frame_ring"
    if frame_mode:
        assert len(obs_shape) == 3, \
            "frame_ring sequence storage needs [H, W, stack] pixel obs"
    return SequenceBuilder(
        seq_len=cfg.replay.seq_length, overlap=cfg.replay.seq_overlap,
        lstm_size=cfg.network.lstm_size,
        priority_eta=cfg.replay.priority_eta, frame_mode=frame_mode)


class DiscretePolicyHooks:
    """Eps-greedy Q-policy hooks shared by the scalar and vector
    discrete actors. The host class provides self.spec and self.rng."""

    def _select_action(self, out, eps: float):
        if self.rng.random() < eps:
            return int(self.rng.integers(self.spec.num_actions))
        return int(np.argmax(out))

    def _bootstrap_value(self, out) -> float:
        return float(np.max(out))

    def _taken_value(self, out, action) -> float:
        return float(out[action])

    def _action_array(self, ts: list[NStepTransition]) -> np.ndarray:
        return np.asarray([t.action for t in ts], np.int32)


class ContinuousPolicyHooks:
    """Ape-X DPG policy hooks shared by the scalar and vector actors:
    deterministic mu(s) plus Gaussian exploration noise (Horgan et al.
    2018, "Ape-X DPG"), with initial priorities seeded from the
    critic's Q(s, mu(s)). The host class provides self.spec and
    self.rng, and calls _init_noise(cfg) once self.spec exists."""

    def _init_noise(self, cfg) -> None:
        self._noise_scale = (cfg.actors.noise_sigma
                             * (self.spec.action_high
                                - self.spec.action_low) / 2.0)

    def _select_action(self, out, eps: float):
        # eps is unused: continuous exploration is additive noise
        noise = self.rng.normal(0.0, self._noise_scale,
                                size=self.spec.action_dim)
        return np.clip(np.asarray(out["a"], np.float32) + noise,
                       self.spec.action_low,
                       self.spec.action_high).astype(np.float32)

    def _bootstrap_value(self, out) -> float:
        return float(out["q"])

    def _taken_value(self, out, action) -> float:
        # Q(s, mu(s)) stands in for Q(s, a_taken): the noise is small,
        # and this only seeds the initial priority
        return float(out["q"])

    def _action_array(self, ts: list[NStepTransition]) -> np.ndarray:
        return np.stack([np.asarray(t.action, np.float32) for t in ts])


def resolve_pending(pending: list[NStepTransition], v_next: float,
                    queue_fn: Callable[[NStepTransition, float], None]
                    ) -> None:
    """Resolve parked transitions with the just-arrived bootstrap value
    (max_a Q of each transition's next_obs): the initial priority is
    the |TD| against the value stashed at selection time. One
    implementation for the scalar and vector actors."""
    for t in pending:
        target = t.reward + t.discount * v_next
        queue_fn(t, abs(target - float(t.aux)))
    pending.clear()


def ship_flat_outbox(outbox: list[tuple[NStepTransition, float]],
                     action_array: Callable, actor_index: int,
                     frames: int, transport) -> None:
    """Stack an outbox of (transition, priority) into the flat wire
    batch and send it (shared by the scalar and vector actors)."""
    ts = [t for t, _ in outbox]
    pris = np.asarray([p for _, p in outbox], np.float32)
    transport.send_experience(flat_transition_batch(
        ts, pris, action_array(ts), actor_index, frames))


class Actor(DiscretePolicyHooks):
    """Discrete eps_i-greedy actor."""

    _ships_frame_segments = True

    def __init__(self, cfg, actor_index: int,
                 query_fn: Callable[[np.ndarray], np.ndarray],
                 transport, seed: int | None = None,
                 episode_callback: Callable[[int, dict], None] | None = None,
                 obs: object | None = None):
        """query_fn(obs) -> q-values [A] (the inference server's
        .query). obs: the observability facade (NULL_OBS when
        omitted)."""
        self.cfg = cfg
        self.index = actor_index
        self.query = query_fn
        self.transport = transport
        self.obs = obs if obs is not None else NULL_OBS
        self._hb = f"actor-{actor_index}"
        self.eps = actor_epsilon(actor_index, cfg.actors.num_actors,
                                 cfg.actors.base_eps, cfg.actors.eps_alpha)
        seed = cfg.seed if seed is None else seed
        self.env = make_env(cfg.env, seed=seed * 10_007 + actor_index,
                            actor_index=actor_index)
        self.spec = self.env.spec
        self.rng = np.random.default_rng(seed * 7919 + actor_index)
        self.nstep = NStepBuilder(cfg.learner.n_step, cfg.learner.gamma)
        self.episode_callback = episode_callback
        self.frames = 0
        self._frames_unshipped = 0
        self._outbox: list[tuple[NStepTransition, float]] = []
        self._pending: list[NStepTransition] = []
        # frame-ring shipping (replay/frame_ring.py): transitions leave
        # as fixed segments of single frames instead of stacked obs pairs
        self._seg: FrameSegmentBuilder | None = None
        if (self._ships_frame_segments
                and getattr(cfg.replay, "storage", "flat") == "frame_ring"):
            spec = self.env.spec
            assert spec.discrete and len(spec.obs_shape) == 3, \
                "frame_ring storage needs discrete [H, W, stack] pixel envs"
            self._seg = FrameSegmentBuilder(
                cfg.replay.seg_transitions, cfg.learner.n_step,
                stack=spec.obs_shape[-1])

    # -- priority resolution ----------------------------------------------

    def _queue(self, t: NStepTransition, priority: float) -> None:
        """A transition's initial priority is resolved: hand it to the
        shipping pipeline. Callers queue in start-step order (the
        pending list drains before any newer transition routes), which
        the frame-segment builder relies on."""
        if self._seg is not None:
            self._seg.add(t.action, t.reward, t.discount, t.span, priority)
        else:
            self._outbox.append((t, priority))

    def _resolve_pending(self, out) -> None:
        resolve_pending(self._pending, self._bootstrap_value(out),
                        self._queue)

    def _route(self, transitions: list[NStepTransition],
               terminal_obs: np.ndarray | None) -> None:
        v_term: float | None = None
        for t in transitions:
            if t.discount == 0.0:
                self._queue(t, abs(t.reward - float(t.aux)))
            elif terminal_obs is not None:
                # truncation flush: the bootstrap obs will not be queried
                # again, so ask the server once for its value
                if v_term is None:
                    v_term = self._bootstrap_value(self.query(terminal_obs))
                target = t.reward + t.discount * v_term
                self._queue(t, abs(target - float(t.aux)))
            else:
                self._pending.append(t)

    def _ship_segments(self, force: bool = False) -> None:
        segs = self._seg.flush() if force else self._seg.take_ready()
        for seg in segs:
            seg["actor"] = self.index
            # env-frame accounting rides the first segment of the batch
            seg["frames"] = self._frames_unshipped
            self._frames_unshipped = 0
            self.transport.send_experience(seg)
        if segs:
            self.obs.mark("actor.ship", segments=len(segs))

    def _ship(self, force: bool = False) -> None:
        if self._seg is not None:
            self._ship_segments(force)
            return
        if not self._outbox:
            return
        if not force and len(self._outbox) < self.cfg.actors.ingest_batch:
            return
        rows = len(self._outbox)
        ship_flat_outbox(self._outbox, self._action_array, self.index,
                         self._frames_unshipped, self.transport)
        self._outbox = []
        self._frames_unshipped = 0
        self.obs.mark("actor.ship", rows=rows)

    # -- main loop ---------------------------------------------------------

    def run(self, max_frames: int,
            stop_event: threading.Event | None = None) -> int:
        obs = self.env.reset()
        if self._seg is not None:
            self._seg.on_reset(obs)
        while self.frames < max_frames and not (
                stop_event is not None and stop_event.is_set()):
            self.obs.beat(self._hb)
            with self.obs.span("actor.inference"):
                out = self.query(obs)
            self._resolve_pending(out)
            action = self._select_action(out, self.eps)
            with self.obs.span("actor.env_step"):
                next_obs, reward, done, info = self.env.step(action)
            self.frames += 1
            self._frames_unshipped += 1
            if self._seg is not None:
                self._seg.on_step(next_obs)
            terminal = info.get("terminal", done)
            truncated = done and not terminal
            new_ts = self.nstep.append(obs, action, reward, next_obs,
                                       terminal, truncated,
                                       aux=self._taken_value(out, action))
            self._route(new_ts, terminal_obs=next_obs if truncated else None)
            if done:
                obs = self.env.reset()
                if self._seg is not None:
                    # flushes the open partial segment first: segments
                    # never span episodes
                    self._seg.on_reset(obs)
                if self.episode_callback and "episode_return" in info:
                    self.episode_callback(self.index, info)
            else:
                obs = next_obs
            self._ship()
        # resolve parked transitions (waiting on Q(s_{t+n}), which would
        # have arrived with the next query) with one final forward so
        # they are not dropped at shutdown
        if self._pending:
            try:
                self._resolve_pending(self.query(obs))
            except Exception:
                self._pending.clear()  # server already down: drop, don't die
        self._ship(force=True)
        return self.frames


class ContinuousActor(ContinuousPolicyHooks, Actor):
    """Ape-X DPG actor: actions are mu(s) + N(0, sigma^2) clipped to the
    action box, sigma = ActorConfig.noise_sigma times the box's half
    range. The inference server answers {"a": mu(s), "q": Q(s, mu(s))}
    in one batched forward, so initial priorities come from the
    critic's values through the same one-step pending mechanism as the
    discrete actor's."""

    _ships_frame_segments = False  # DPG obs are low-dimensional

    def __init__(self, cfg, actor_index: int,
                 query_fn: Callable[[np.ndarray], dict],
                 transport, seed: int | None = None,
                 episode_callback: Callable[[int, dict], None] | None = None,
                 obs: object | None = None):
        super().__init__(cfg, actor_index, query_fn, transport, seed=seed,
                         episode_callback=episode_callback, obs=obs)
        self._init_noise(cfg)


class RecurrentActor(Actor):
    """R2D2 actor: carries LSTM state, ships stored-state sequences.

    Shares Actor's construction (eps schedule, env and generator
    seeding, frame accounting) but replaces the flat n-step pipeline
    with a SequenceBuilder and a stateful loop. Each query sends
    {"obs", "c", "h"} and gets {"q", "c", "h"} back, so the batched
    server serves many actors' recurrent steps at once.

    Initial sequence priorities come from 1-step TD estimates. A step's
    TD needs max_a Q(s_{t+1}), which arrives with the NEXT query, so
    each step parks for one iteration before entering the builder.
    Frame-mode shipping (frame_ring storage) happens inside the
    SequenceBuilder, not through Actor's segment path."""

    _ships_frame_segments = False

    def __init__(self, cfg, actor_index: int,
                 query_fn: Callable[[dict], dict],
                 transport, seed: int | None = None,
                 episode_callback: Callable[[int, dict], None] | None = None,
                 obs: object | None = None):
        super().__init__(cfg, actor_index, query_fn, transport, seed=seed,
                         episode_callback=episode_callback, obs=obs)
        self.gamma = cfg.learner.gamma
        self.lstm_size = cfg.network.lstm_size
        self.builder = sequence_builder(cfg, self.env.spec.obs_shape)
        self.ship_after = sequence_ship_after(cfg)
        self._outbox: list[dict] = []  # sequence items, not transitions

    def _zero_state(self) -> tuple[np.ndarray, np.ndarray]:
        z = np.zeros(self.lstm_size, np.float32)
        return z, z.copy()

    def _feed(self, rec: dict, td: float) -> None:
        feed_sequence(self._outbox, self.builder, rec, td)

    def _ship(self, force: bool = False) -> None:
        if not self._outbox:
            return
        if not force and len(self._outbox) < self.ship_after:
            return
        rows = len(self._outbox)
        ship_sequence_outbox(self._outbox, self.index,
                             self._frames_unshipped, self.transport)
        self._outbox = []
        self._frames_unshipped = 0
        self.obs.mark("actor.ship", sequences=rows)

    def run(self, max_frames: int,
            stop_event: threading.Event | None = None) -> int:
        obs = self.env.reset()
        c, h = self._zero_state()
        prev: dict | None = None  # step awaiting its 1-step TD bootstrap
        while self.frames < max_frames and not (
                stop_event is not None and stop_event.is_set()):
            self.obs.beat(self._hb)
            with self.obs.span("actor.inference"):
                out = self.query({"obs": obs, "c": c, "h": h})
            q = out["q"]
            if prev is not None:
                td = (prev["reward"] + self.gamma * float(np.max(q))
                      - prev["q_sa"])
                self._feed(prev, td)
                prev = None
            if self.rng.random() < self.eps:
                action = int(self.rng.integers(self.env.spec.num_actions))
            else:
                action = int(np.argmax(q))
            next_obs, reward, done, info = self.env.step(action)
            self.frames += 1
            self._frames_unshipped += 1
            terminal = info.get("terminal", done)
            rec = dict(obs=obs, action=action, reward=float(reward),
                       terminal=terminal, pre_state=(c, h),
                       q_sa=float(q[action]), episode_end=done)
            if terminal:
                # the bootstrap is zero: the TD is determined now
                self._feed(rec, rec["reward"] - rec["q_sa"])
            elif done:
                # truncation: the sequence ends (the state resets) but
                # the bootstrap survives: one more query on the last obs
                out2 = self.query({"obs": next_obs,
                                   "c": out["c"], "h": out["h"]})
                td = (reward + self.gamma * float(np.max(out2["q"]))
                      - rec["q_sa"])
                self._feed(rec, td)
            else:
                prev = rec
            if done:
                obs = self.env.reset()
                c, h = self._zero_state()
                if self.episode_callback and "episode_return" in info:
                    self.episode_callback(self.index, info)
            else:
                obs = next_obs
                c, h = out["c"], out["h"]
            self._ship()
        # shutdown: resolve the parked step with one final forward,
        # flush the builder's partial tail and ship everything
        if prev is not None:
            try:
                out = self.query({"obs": obs, "c": c, "h": h})
                td = (prev["reward"] + self.gamma * float(np.max(out["q"]))
                      - prev["q_sa"])
            except Exception:
                td = prev["reward"] - prev["q_sa"]
            prev["episode_end"] = False
            self._feed(prev, td)
        self._outbox.extend(self.builder.flush())
        self._ship(force=True)
        return self.frames
