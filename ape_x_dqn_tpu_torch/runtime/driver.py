"""Ape-X orchestration on one card: actors + inference server + ingest +
learner.

Counterpart of ``ape_x_dqn_tpu/runtime/driver.py`` (``ApexDriver``) on
one device. Threads around the device-resident replay:
- N actor threads: env stepping and initial priorities
  (runtime/actor.py, runtime/vector_actor.py), each slot restarted on a
  crash with its remaining frame budget, up to actors.max_restarts;
- the inference server's thread (parallel/inference_server.py): batched
  forwards of the published params on the card;
- 1 ingest thread: transport -> pinned staging buffers -> add/add_many
  (runtime/ingest.py);
- 1 learner thread: train_many chunks paced by steps_per_frame_cap, with
  param publication at publish_every boundary crossings;
- an eval thread at eval_every_steps boundaries, and a final greedy
  eval at teardown.

    from ape_x_dqn_tpu_torch.configs import get_config
    from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
    out = ApexDriver(get_config("pong")).run(wall_clock_limit_s=600)

Locks: `_lock` guards the shared counters; `_state_lock` serialises
everything that mutates the learner's state IN PLACE (the ingest adds
and the train dispatches) and the param copy taken for publication. The
inference server holds its own param copy and never reads the
learner's tensors.

Nothing compiles in the port, so the original's AOT warm-up becomes one
forward per server bucket (`_warmup`), which changes no learner state.
What the original builds and the port does not have yet raises, naming
its ROADMAP Queue A item: the multi-GPU learner (14), the serving tier
(16), the remediation and operations planes (19), checkpoints and the
legacy staging path (11), the profiler capture (17) and the DPG
family (13); the port's config already refuses the cold tier (15).
The R2D2 family runs here: recurrent actors, stateful {obs, c, h}
server queries, whole sequences as staging units and the
`SequenceLearner` (runtime/sequence_learner.py). With observability off (the
only ported facade) the supervisor has no watchdog to read, as in the
original with obs off; the HBM fits-check waits for ``utils/hbm.py``
(item 17).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque

import numpy as np
import torch

from ape_x_dqn_tpu_torch.comm.transport import LoopbackTransport, batch_rows
from ape_x_dqn_tpu_torch.envs import make_env
from ape_x_dqn_tpu_torch.models import build_network
from ape_x_dqn_tpu_torch.obs.core import build_obs
from ape_x_dqn_tpu_torch.parallel.inference_server import (
    BatchedInferenceServer)
from ape_x_dqn_tpu_torch.runtime.build import build_prioritized_replay
from ape_x_dqn_tpu_torch.runtime.evaluation import (
    EvalWorker, RollingSuiteScore, eval_game_rotation, final_eval_game,
    make_eval_policy_factory, run_eval_measured)
from ape_x_dqn_tpu_torch.runtime.family import (
    actor_class, family_of, family_setup, server_apply_fn, warmup_example)
from ape_x_dqn_tpu_torch.runtime.ingest import IngestStager
from ape_x_dqn_tpu_torch.runtime.learner import DQNLearner
from ape_x_dqn_tpu_torch.runtime.sequence_learner import SequenceLearner
from ape_x_dqn_tpu_torch.runtime.single_process import build_replay
from ape_x_dqn_tpu_torch.utils.metrics import (Metrics, Throughput,
                                               log_run_header)
from ape_x_dqn_tpu_torch.utils.misc import next_pow2, resolve_device
from ape_x_dqn_tpu_torch.utils.rng import component_generator


def _refuse_unported(cfg) -> None:
    """Raise for what the original driver builds and the port does not
    have yet, rather than running without it."""
    waits = []
    if cfg.parallel.dp * cfg.parallel.tp > 1:
        waits.append(("parallel.dp * parallel.tp > 1 (the multi-GPU "
                      "learner)", 14))
    if cfg.serving.multi_tenant:
        waits.append(("serving.multi_tenant (the serving tier)", 16))
    rcfg = getattr(cfg, "remediation", None)
    if rcfg is not None and rcfg.mode != "off":
        waits.append((f"remediation.mode={rcfg.mode!r} (the remediation "
                       f"and operations planes)", 19))
    if cfg.checkpoint_dir:
        waits.append(("checkpoint_dir (utils/checkpoint.py)", 11))
    if not getattr(cfg.replay, "ingest_zero_copy", True):
        waits.append(("replay.ingest_zero_copy=False (the legacy staging "
                      "path)", 11))
    if cfg.profile_dir:
        waits.append(("profile_dir (the profiler capture)", 17))
    if family_of(cfg) == "dpg":
        waits.append(("the 'dpg' family", 13))
    if waits:
        what, item = waits[0]
        raise NotImplementedError(
            f"{what} is not ported to the PyTorch package yet: it waits "
            f"for ROADMAP Queue A item {item}")


class ApexDriver:
    def __init__(self, cfg, metrics: Metrics | None = None,
                 transport=None, device: str | torch.device = "cuda"):
        """transport: experience ingest + param distribution (defaults
        to the in-process LoopbackTransport). device: the card the
        replay, the learner and the inference server live on (a CUDA
        request without a card raises)."""
        _refuse_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.metrics = metrics or Metrics()
        # observability facade: NULL_OBS (an enabled config raises)
        self.obs = build_obs(getattr(cfg, "obs", None), self.metrics)
        probe_env = make_env(cfg.env, seed=cfg.seed)
        self.spec = probe_env.spec
        self.net = build_network(cfg.network, self.spec)
        obs0 = probe_env.reset()
        self.family = family_of(cfg)
        setup = family_setup(cfg, self.spec, self.net, obs0)
        self.net.to(self.device)
        item_spec = setup.item_spec
        self._frame_mode = setup.frame_mode
        self._item_keys = tuple(item_spec.keys())
        self.dp = 1
        self.replay = (build_prioritized_replay(
                           cfg, self.spec, next_pow2(cfg.replay.capacity),
                           self.device, frame_mode=True)
                       if self._frame_mode
                       else build_replay(cfg.replay, self.device))
        self.learner = (SequenceLearner(self.replay, cfg.learner,
                                        cfg.replay)
                        if self.family == "r2d2"
                        else DQNLearner(self.replay, cfg.learner))
        replay_state = (self.replay.init() if self._frame_mode
                        else self.replay.init(item_spec))
        self.state = self.learner.init(  # guarded-by: _state_lock
            self.net, replay_state,
            component_generator(cfg.seed, "learner", device=self.device))
        self.capacity = self.replay.capacity
        # the learner updates its tensors in place: the server gets a
        # copy (publish_params clones) and keeps it to itself
        server_params = self.learner.publish_params(self.state)
        self.server = BatchedInferenceServer(
            server_apply_fn(self.family, self.net), server_params,
            max_batch=cfg.inference.max_batch,
            deadline_ms=cfg.inference.deadline_ms,
            obs=self.obs, device=self.device)
        self.transport = transport if transport is not None \
            else LoopbackTransport()
        self.obs.blackbox.set_peer(f"driver-{os.getpid()}")
        self.obs.blackbox.install()
        # initial publication, so a client of the param channel can
        # bootstrap before the first publish_every boundary
        self.transport.publish_params(server_params, 0)
        self.stop_event = threading.Event()
        # learner priority: cleared while the learner dispatches, and
        # every actor query waits on it (see _gated)
        self._actors_may_run = threading.Event()
        self._actors_may_run.set()
        self._lock = threading.Lock()
        self._state_lock = threading.Lock()
        self.episode_returns: deque[float] = deque(maxlen=200)  # guarded-by: _lock
        self.frames = Throughput(window_s=30.0)
        self.grad_steps = Throughput(window_s=30.0)
        # rows actually landed in replay (after drops and coalescing)
        self.ingest_rows = Throughput(window_s=30.0)
        self._frames_total = 0  # guarded-by: _lock
        self._grad_steps_total = 0
        self.actor_errors: list[tuple[int, Exception]] = []  # guarded-by: _lock
        self.actor_restarts: list[tuple[int, str]] = []  # guarded-by: _lock
        self.loop_errors: list[tuple[str, Exception]] = []  # guarded-by: _lock
        # actor slots: each has its own stop event and thread generation
        self._slot_stops: dict[int, threading.Event] = {}  # guarded-by: _lock
        self._slot_threads: dict[int, threading.Thread] = {}  # guarded-by: _lock
        self._slot_budget: dict[int, int] = {}  # guarded-by: _lock
        # frames produced by FINISHED attempts of the slot's current
        # generation (crash restarts)
        self._slot_done: dict[int, int] = {}  # guarded-by: _lock
        self._slot_restarts: dict[int, int] = {}  # guarded-by: _lock
        self._quarantined: set[int] = set()  # guarded-by: _lock
        self._ingested_batches = 0  # guarded-by: _lock
        # host mirror of the replay fill, so the learner loop never
        # reads the state to decide whether it may train
        self._replay_filled = 0  # guarded-by: _lock
        # ingest staging: units (transitions, or whole frame segments in
        # frame-ring mode) accumulate in pinned host buffers until a
        # full fixed-size block ships to the device in one add
        self._stage_chunk = setup.stage_chunk
        self._unit_items = setup.unit_items
        self._stage_dropped = 0
        self._stage_dropped_per_shard = np.zeros(self.dp, np.int64)
        self._item_spec = item_spec
        ptail = (cfg.replay.seg_transitions,) if self._frame_mode else ()
        self._stager = IngestStager(
            item_spec, ptail,
            block_units=self.dp * self._stage_chunk,
            coalesce=getattr(cfg.replay, "ingest_coalesce", 4),
            buffers=getattr(cfg.replay, "stage_buffers", 2),
            ship=self._ship_staged, pin=self.device.type == "cuda")
        self.last_eval: dict | None = None  # guarded-by: _lock

    # -- components --------------------------------------------------------

    def _make_eval_worker(self, game: str | None = None) -> EvalWorker:
        factory = make_eval_policy_factory(
            self.family, self.cfg.network.lstm_size, self.server.query)
        return EvalWorker(self.cfg, self.server.query, game=game,
                          policy_factory=factory)

    def _on_episode(self, actor_index: int, info: dict) -> None:
        with self._lock:
            self.episode_returns.append(float(info["episode_return"]))

    def _spawn_actor_slot(self, i: int, max_frames: int,
                          attempt0: int = 0) -> threading.Thread:
        """Start actor slot i with its own generation stop event (the
        global teardown sets every slot event)."""
        ev = threading.Event()
        t = threading.Thread(target=self._actor_thread,
                             args=(i, max_frames, ev, attempt0),
                             name=f"actor-{i}", daemon=True)
        with self._lock:
            self._slot_stops[i] = ev
            self._slot_threads[i] = t
            self._slot_budget[i] = max_frames
            self._slot_done[i] = 0  # fresh generation, fresh accounting
        t.start()
        return t

    def _actor_threads(self) -> list[threading.Thread]:
        """Current-generation actor threads."""
        with self._lock:
            return list(self._slot_threads.values())

    def _actor_thread(self, i: int, max_frames: int,
                      slot_stop: threading.Event | None = None,
                      attempt0: int = 0) -> None:
        """Supervised actor slot: on a crash the actor is rebuilt and
        resumes the REMAINING frame budget, up to actors.max_restarts
        times. Exhausting the budget records the error, which fails the
        run report (actor_errors)."""
        stop = slot_stop if slot_stop is not None else self.stop_event
        vector = self.cfg.actors.envs_per_actor > 1
        actor_cls = actor_class(self.family, vector=vector)
        query = self._gated(self.server.query_batch if vector
                            else self.server.query)
        self.obs.register(f"actor-{i}")
        try:
            self._actor_attempts(i, actor_cls, query, max_frames,
                                 self.cfg.actors.max_restarts, attempt0,
                                 stop)
        finally:
            with self._lock:
                current = (slot_stop is None or self._slot_threads.get(i)
                           is threading.current_thread())
            if current:
                self.obs.clear(f"actor-{i}")

    def _gated(self, query):
        """An actor's query that first waits while the learner
        dispatches. The eager learner issues thousands of torch calls a
        macro-step, and each call drops and retakes the interpreter
        lock; beside actor threads that keep the lock busy, every
        retake waits its turn, and a train_many that takes ~0.07 s alone
        took ~5 s beside 8 vector actors on the card (PERF.md §6),
        holding _state_lock so long that ingest stalled and the
        transport dropped most of the experience. Actors therefore
        pause at their next query while the learner dispatches (at the
        pong preset's pacing, a few percent of the time) and run freely
        otherwise."""
        gate = self._actors_may_run

        def gated(*args, **kwargs):
            gate.wait()
            return query(*args, **kwargs)

        return gated

    def _actor_attempts(self, i, actor_cls, query, remaining,
                        restarts_left, attempt,
                        stop: threading.Event) -> None:
        while remaining > 0 and not stop.is_set():
            actor = None
            try:
                # salt the seed per attempt: an unsalted rebuild would
                # replay the exact env + eps-greedy stream already
                # ingested
                seed = (self.cfg.seed if attempt == 0
                        else self.cfg.seed + 7907 * attempt)
                actor = actor_cls(self.cfg, i, query,
                                  self.transport, seed=seed,
                                  episode_callback=self._on_episode,
                                  obs=self.obs)
                actor.run(remaining, stop)
                return  # frames counted at ingest
            except Exception as e:
                # frames the crashed actor already shipped stay counted;
                # only its unshipped tail is lost
                done = actor.frames if actor is not None else 0
                remaining -= done
                with self._lock:
                    if self._slot_stops.get(i) is stop:
                        self._slot_done[i] = \
                            self._slot_done.get(i, 0) + done
                # a crash with no budget left (frames or restarts) is an
                # error, not a recovered restart
                if (restarts_left <= 0 or remaining <= 0
                        or stop.is_set()):
                    with self._lock:
                        self.actor_errors.append((i, e))
                    return
                restarts_left -= 1
                attempt += 1
                with self._lock:
                    self.actor_restarts.append((i, repr(e)))
                self.metrics.log(self._grad_steps_total, actor_restart=i)

    # -- fleet supervisor --------------------------------------------------

    def _supervise_tick(self) -> None:
        """One supervisory pass over heartbeat staleness. With
        observability off there is no watchdog to read, so the pass is
        a no-op, exactly as in the original with obs off; the
        watchdog-driven restarts and quarantines arrive with the
        observability and operations planes (ROADMAP Queue A items 17
        and 19)."""
        if self.obs.watchdog is None:
            return
        self.obs.check_stalled()

    def _min_fill(self) -> int:
        return min(self.cfg.replay.min_fill, self.capacity // 2)

    # -- ingest ------------------------------------------------------------

    def _ingest_loop(self) -> None:
        try:
            self._ingest_loop_inner()
        except Exception as e:
            with self._lock:
                self.loop_errors.append(("ingest", e))

    def _ingest_loop_inner(self) -> None:
        self.obs.register("ingest")
        try:
            while not self.stop_event.is_set():
                self.obs.beat("ingest")
                batch = self.transport.recv_experience(timeout=0.1)
                if batch is None:
                    # queue ran dry: ship the complete staged blocks so
                    # coalescing costs bounded latency
                    self._stager.drain()
                    continue
                self._ingest_one(batch, batch_rows(batch))
            # ship the staged full blocks; the partial tail is dropped
            # and counted (_flush_stage)
            self._flush_stage(force=True)
        finally:
            self.obs.clear("ingest")

    def _ingest_one(self, batch: dict, n: int) -> None:
        # frame segments and sequences carry fewer units than env
        # frames: actors ship the true frame count alongside (flat
        # batches: frames == units)
        frames = int(batch.get("frames", n))
        self._stage_one(batch, n)
        self.frames.add(frames)
        with self._lock:
            self._frames_total += frames
            self._ingested_batches += 1

    def _stage_one(self, batch: dict, n: int) -> None:
        self._stager.put(batch)
        # below min_fill the learner waits on replay: ship complete
        # blocks at once instead of letting coalescing delay the first
        # train dispatch by up to a full buffer
        if self._replay_filled < self._min_fill():
            self._stager.drain()
        self.obs.gauge("ingest_staging_occupancy", self._stager.occupancy())
        self.obs.gauge("ingest_decode_ms", self._stager.last_put_decode_ms)
        self.obs.gauge("ingest_ship_ms", self._stager.last_ship_ms)

    def _ship_staged(self, views: dict, g: int) -> list:
        """Ship g coalesced staged blocks (the IngestStager callback):
        one asynchronous host-to-device copy per leaf straight out of
        the pinned staging memory, a CUDA event recorded after them,
        then ONE add (g == 1) or add_many under _state_lock. -> the
        event (none on the CPU), which the stager synchronises on
        before it rewrites the memory."""
        count = g * self.dp * self._stage_chunk
        shape = (g, self._stage_chunk) if g > 1 else (self._stage_chunk,)
        staged = {k: v.reshape(shape + tuple(v.shape[1:])).to(
                      self.device, non_blocking=True)
                  for k, v in views.items()}
        handles = []
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            handles.append(ev)
        pris = staged.pop("priorities")
        with self._state_lock:
            with self.obs.span("replay.add", units=count):
                if g > 1:
                    self.state = self.learner.add_many(self.state, staged,
                                                       pris)
                else:
                    self.state = self.learner.add(self.state, staged, pris)
        self.ingest_rows.add(count * self._unit_items)
        with self._lock:
            self._replay_filled = min(
                self._replay_filled + count * self._unit_items,
                self.capacity)
        self.obs.gauge("ingest_coalesce_width", g)
        return handles

    def _flush_stage(self, force: bool = False) -> None:
        """Ship the complete staged blocks; at force-flush the sub-block
        tail is DROPPED and counted in transitions: live transitions
        (next_off > 0) in frame-ring mode and seq_length per sequence
        for r2d2 (an upper bound: overlapping sequences share steps),
        where env frames ride the ingest messages separately and stay
        counted; units in flat mode, where one unit is one env frame and
        the frame count comes off with it."""
        self._stager.drain()
        tail = self._stager.tail_units()
        if force and tail:
            if self._frame_mode:
                live = (self._stager.tail_view("next_off") > 0
                        ).sum(axis=-1)
                per_shard = self._tail_shard_counts(live)
            elif self.family == "r2d2":
                per_shard = np.asarray(
                    self._stager.tail_shard_units(self.dp),
                    np.int64) * self.cfg.replay.seq_length
            else:
                per_shard = np.asarray(
                    self._stager.tail_shard_units(self.dp), np.int64)
                with self._lock:
                    self._frames_total -= tail
            self._stage_dropped += int(per_shard.sum())
            self._stage_dropped_per_shard += per_shard
            self._stager.discard_tail()

    def _tail_shard_counts(self, per_unit) -> np.ndarray:
        """Fold unit-indexed drop counts into per-shard totals (staged
        unit i of a would-be [dp, stage_chunk] block belongs to shard
        i // stage_chunk; one shard on one card)."""
        out = np.zeros(self.dp, np.int64)
        for i, n in enumerate(np.asarray(per_unit, np.int64)):
            out[i // self._stage_chunk] += int(n)
        return out

    # -- learner -----------------------------------------------------------

    def _warmup(self) -> None:
        """One forward per inference-server bucket before any thread
        starts (pinned buffers, device workspace, library handles).
        Nothing compiles in the port, and nothing here touches the
        learner's state. A remote-only learner (no local actors, no
        eval) never queries its own server and skips it."""
        if (self.cfg.actors.num_actors > 0 or self.cfg.eval_every_steps > 0
                or self.cfg.eval_episodes > 0):
            self.server.warmup(
                warmup_example(self.family, self.cfg, self.spec),
                extra_sizes=(self.cfg.actors.envs_per_actor,))

    def _learner_loop(self, max_grad_steps: int) -> None:
        self.obs.register("learner")
        try:
            self._learner_loop_inner(max_grad_steps)
        except Exception as e:
            with self._lock:
                self.loop_errors.append(("learner", e))
        finally:
            self.obs.clear("learner")

    def _publish_params(self) -> None:
        # copy under the state lock: an add or a train dispatch would
        # otherwise write the tensors being copied
        with self._state_lock:
            with self.obs.span("learner.publish_params"):
                pub = self.learner.publish_params(self.state)
        self.server.update_params(pub, self._grad_steps_total)
        self.transport.publish_params(pub, self._grad_steps_total)

    def _learner_loop_inner(self, max_grad_steps: int) -> None:
        publish_every = self.cfg.learner.publish_every
        # a chunk larger than the publish cadence would snap to 1 forever
        chunk = max(min(self.cfg.learner.train_chunk, publish_every), 1)
        last_log = 0
        cap = self.cfg.learner.steps_per_frame_cap
        while (not self.stop_event.is_set()
               and self._grad_steps_total < max_grad_steps):
            self.obs.beat("learner")
            with self._lock:
                filled = self._replay_filled
                frames = self._frames_total
            if filled < self._min_fill():
                time.sleep(0.05)
                continue
            if cap is not None and self._grad_steps_total >= cap * frames:
                time.sleep(0.01)  # pacing: let actors catch up
                continue
            self.obs.maybe_profile(self._grad_steps_total)
            # up to `chunk` grad-steps per dispatch without overshooting
            # the step target; publication fires on boundary CROSSINGS
            # (a chunk need not divide publish_every)
            done = self._grad_steps_total
            k = chunk if chunk <= max_grad_steps - done else 1
            self._actors_may_run.clear()  # learner priority (_gated)
            try:
                with self._state_lock:
                    with self.obs.stage_window("train", k):
                        with self.obs.span("learner.train", k=k):
                            if k > 1:
                                self.state, m = self.learner.train_many(
                                    self.state, k)
                            else:
                                self.state, m = self.learner.train_step(
                                    self.state)
            finally:
                self._actors_may_run.set()
            self._grad_steps_total += k
            self.grad_steps.add(k)
            self.obs.set_learner_step(self._grad_steps_total)
            if done // publish_every != self._grad_steps_total // publish_every:
                self._publish_params()
            if self._grad_steps_total - last_log >= 100:
                last_log = self._grad_steps_total
                # ONE fetch of the logged metrics at the log boundary
                loss, q_mean, td = torch.stack(
                    [m["loss"].float(), m["q_mean"].float(),
                     m["td_abs_mean"].float()]).tolist()
                with self._lock:
                    avg_ret = (float(np.mean(self.episode_returns))
                               if self.episode_returns else 0.0)
                    replay_size = self._replay_filled
                self.metrics.log(
                    self._grad_steps_total,
                    loss=loss, q_mean=q_mean,
                    frames=self._frames_total,
                    frames_per_s=self.frames.rate(),
                    grad_steps_per_s=self.grad_steps.rate(),
                    avg_return=avg_ret,
                    replay_size=replay_size,
                    ingest_dropped=self.transport.dropped)
                self.obs.observe("td_abs", td)
                self.obs.gauge("replay_occupancy", replay_size)
                self.obs.perf_rate("grad_steps_per_s",
                                   self.grad_steps.rate(),
                                   step=self._grad_steps_total)
                self.obs.perf_rate("env_fps", self.frames.rate(),
                                   step=self._grad_steps_total)
                self.obs.perf_rate("ingest_rows_per_s",
                                   self.ingest_rows.rate(),
                                   step=self._grad_steps_total)
                self.obs.publish(self._grad_steps_total)

    def _eval_loop(self) -> None:
        """Greedy eval at every eval_every_steps grad-step boundary,
        sharing the inference server."""
        try:
            every = self.cfg.eval_every_steps
            rotate, games = eval_game_rotation(self.cfg)
            worker = None if rotate else self._make_eval_worker()
            rolling = RollingSuiteScore(self.cfg) if rotate else None
            next_at = every
            eval_i = 0
            while not self.stop_event.wait(0.2):
                if self._grad_steps_total < next_at:
                    continue
                game = None
                if rotate:
                    game = games[eval_i % len(games)]
                    worker = self._make_eval_worker(game=game)
                    eval_i += 1
                t_eval = time.monotonic()
                try:
                    res, depth_max = run_eval_measured(
                        worker, self.cfg.eval_episodes, self.server,
                        stop_event=self.stop_event,
                        max_frames=self.cfg.eval_max_frames)
                except TimeoutError as e:
                    # a transient server stall must not end the eval
                    # thread: log it, skip this slot, keep going
                    self.metrics.log(self._grad_steps_total,
                                     eval_game=game or self.cfg.env.id,
                                     eval_error=repr(e))
                    next_at = (self._grad_steps_total // every + 1) * every
                    continue
                if res is None:  # cancelled mid-eval at shutdown
                    break
                with self._lock:
                    self.last_eval = res
                roll = (rolling.update(game, res["mean_return"])
                        if rolling is not None and game else {})
                self.metrics.log(self._grad_steps_total,
                                 avg_eval_return=res["mean_return"],
                                 eval_episodes=res["episodes"],
                                 eval_game=game or self.cfg.env.id,
                                 eval_wall_s=time.monotonic() - t_eval,
                                 server_queue_depth_max=depth_max,
                                 **roll)
                next_at = (self._grad_steps_total // every + 1) * every
        except Exception as e:
            with self._lock:
                self.loop_errors.append(("eval", e))

    # -- run ---------------------------------------------------------------

    def run(self, total_env_frames: int | None = None,
            max_grad_steps: int = 10**9,
            wall_clock_limit_s: float | None = None) -> dict:
        total = total_env_frames or self.cfg.total_env_frames
        per_actor = total // max(self.cfg.actors.num_actors, 1)
        log_run_header(self.metrics, self.cfg, self._grad_steps_total)
        self._warmup()
        ingest = threading.Thread(target=self._ingest_loop, name="ingest",
                                  daemon=True)
        learner = threading.Thread(target=self._learner_loop,
                                   args=(max_grad_steps,), name="learner",
                                   daemon=True)
        evaluator = (threading.Thread(target=self._eval_loop, name="eval",
                                      daemon=True)
                     if self.cfg.eval_every_steps > 0 else None)
        t0 = time.monotonic()
        ingest.start()
        learner.start()
        if evaluator is not None:
            evaluator.start()
        for i in range(self.cfg.actors.num_actors):
            self._spawn_actor_slot(i, per_actor)
        try:
            prev_stuck_at = -1  # _ingested_batches at the last stuck poll
            while True:
                self._supervise_tick()
                if (wall_clock_limit_s is not None
                        and time.monotonic() - t0 > wall_clock_limit_s):
                    break
                if self._grad_steps_total >= max_grad_steps:
                    break
                if not (learner.is_alive() and ingest.is_alive()):
                    break  # crashed loop: its error is in loop_errors
                if not any(t.is_alive() for t in self._actor_threads()):
                    # actors finished: drain pending experience, then
                    # let the learner reach a finite grad-step target,
                    # UNLESS it can never progress (replay stuck below
                    # min_fill, or the pacing cap binds with no frames
                    # left to arrive)
                    if self.transport.pending == 0:
                        with self._lock:
                            size = self._replay_filled
                            ingested = self._ingested_batches
                            frames = self._frames_total
                        cap = self.cfg.learner.steps_per_frame_cap
                        stuck = size < self._min_fill() or (
                            cap is not None
                            and self._grad_steps_total >= cap * frames)
                        if max_grad_steps >= 10**9:
                            break
                        # stuck on two consecutive polls with no ingest
                        # between: the final batch may be mid-add
                        if stuck and ingested == prev_stuck_at:
                            break
                        prev_stuck_at = ingested if stuck else -1
                time.sleep(0.2)
        finally:
            self.stop_event.set()
            with self._lock:
                slot_events = list(self._slot_stops.values())
            for ev in slot_events:
                ev.set()
            for t in self._actor_threads():
                t.join(timeout=5)
            learner.join(timeout=10)
            ingest.join(timeout=5)
            if evaluator is not None:
                evaluator.join(timeout=10)
            # end-of-training eval: short runs can finish inside one
            # eval poll interval (and eval_every_steps=0 disables the
            # periodic thread), so guarantee one greedy evaluation while
            # the inference server is still up
            if (self.cfg.eval_episodes > 0 and self.last_eval is None
                    and self._grad_steps_total > 0
                    and not self.loop_errors):
                try:
                    game = final_eval_game(self.cfg)
                    res = self._make_eval_worker(game=game).run(
                        self.cfg.eval_episodes,
                        max_frames=self.cfg.eval_max_frames,
                        deadline_s=self.cfg.final_eval_deadline_s)
                    if res is not None:
                        with self._lock:
                            self.last_eval = res
                        self.metrics.log(self._grad_steps_total,
                                         avg_eval_return=res["mean_return"],
                                         eval_episodes=res["episodes"],
                                         eval_game=game or self.cfg.env.id)
                except Exception as e:
                    self.loop_errors.append(("final_eval", e))
            self.server.stop()
            self.obs.close(self._grad_steps_total)
        with self._lock:
            avg_ret = (float(np.mean(self.episode_returns))
                       if self.episode_returns else 0.0)
        alive = [t.name for t in (learner, ingest, *self._actor_threads())
                 if t.is_alive()]
        if alive:
            logging.getLogger(__name__).warning(
                "threads still running after teardown: %s", alive)
        return {
            "frames": self._frames_total,
            "grad_steps": self._grad_steps_total,
            "avg_return": avg_ret,
            "episodes": len(self.episode_returns),
            "wall_s": time.monotonic() - t0,
            "server": self.server.stats,
            "ingest_dropped": self.transport.dropped + self._stage_dropped,
            "ingest_dropped_per_shard":
                self._stage_dropped_per_shard.tolist(),
            "actor_errors": list(self.actor_errors),
            "actor_restarts": list(self.actor_restarts),
            "actor_quarantines": sorted(self._quarantined),
            "supervisor_restarts": dict(self._slot_restarts),
            "loop_errors": list(self.loop_errors),
            "eval": self.last_eval,
        }
