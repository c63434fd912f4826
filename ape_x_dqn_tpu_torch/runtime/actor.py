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
streams. The continuous (DPG) and recurrent (R2D2) actors wait for
their slices (ROADMAP Queue A items 13 and 12).
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np

from ape_x_dqn_tpu_torch.envs import make_env
from ape_x_dqn_tpu_torch.obs.core import NULL_OBS
from ape_x_dqn_tpu_torch.ops.nstep import NStepBuilder, NStepTransition
from ape_x_dqn_tpu_torch.replay.frame_ring import FrameSegmentBuilder


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
