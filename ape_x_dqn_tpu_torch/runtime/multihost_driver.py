"""Multi-host Ape-X: one learner process per host (or per card), in
lockstep.

Counterpart of ``ape_x_dqn_tpu/runtime/multihost_driver.py``. The
reference scales its learner with NCCL/MPI process groups running
synchronized training steps while each host ingests its own actors'
experience. Here:

- Every process joins one ``torch.distributed`` group
  (parallel/multihost.py: `init_multihost`, which the CLI's
  ``--coordinator`` calls: gloo for CPU tensors, and NCCL for CUDA
  tensors on a card) and builds the same dist learner
  (parallel/dist_learner.py) from the same seed, over a process-local
  mesh of its own dp rows (`process_rows`: dp_local = dp / nproc, on its
  own card; on one card every rank takes it, and `check_hbm_fits` counts
  the ranks there). Each SGD step's gradient crosses processes in one
  exchange, whose mode the group agrees on once, after counting the
  processes on each card (`agreed_exchange_mode`): NCCL on the device
  when every rank is alone on its card, each macro-step then ONE
  captured graph with its collectives inside; else gloo through the
  host, between captured segments. Every process holds the whole
  params, so publication is process-local.
- Each host runs its OWN actors + batched inference server + transport;
  experience lands only in the replay shards that host owns, exactly
  like the reference's per-learner replay locality.
- The learner loop is a synchronous ROUND protocol instead of the
  single-host driver's free-running threads: the learner's step is a
  collective, so every process must issue the identical call sequence.
  Each round:

      1. all processes agree (the `global_stats` collective) whether
         every host has a full ingest block staged; if so, all add
         together (gating beats padding: dead filler items would cycle
         the replay ring and evict real experience on idle hosts);
      2. the replay fill check, the train dispatch, the publication
         boundary, checkpoints and termination all branch on GLOBAL
         values (the collective's outputs, or counts every process
         advances alike), never on host-local state.

  The same dispatches on every rank also give the same order of graph
  replays, which the NCCL mode needs: a replayed collective waits on
  the device for its peers' replays, with no host timeout.

  A host whose actors all die stalls global ingest (training continues
  on existing data); a host whose PROCESS dies hangs or fails the
  collectives, the same failure domain as the reference's NCCL group,
  recovered by restarting the job from a checkpoint. The
  `StallWatchdog` (obs/health.py) ends a process whose peers stopped
  answering, a replayed NCCL collective waiting on the device
  included (the round loop then blocks on the step's loss). It is
  armed wherever this process waits on its peers: across the group's
  first collectives and NCCL's communicator at construction, the
  learner's warm-up (its exchanges and captures), the round loop, and
  `close`, which releases the step graphs (NCCL destroys no
  communicator while a CUDA graph holding one of its collectives
  lives; the CLI calls it before it leaves the group).

Checkpoints (``checkpoint_dir``, which every process must set, or none):
params, target params, Adam, the learner's generator, the step and the
global frame count; every process holds the same values, so process 0
writes after a barrier, and the restore takes the newest step EVERY
process can read (a min over the group). Eval runs on process 0 only.

The warm-up (`_warmup_learner`, the counterpart of the original's
ahead-of-time compiles of `add` and `train_many`) captures this
process's graphs before the actors start, so no capture stalls the
single-threaded round loop while the bounded transport drops
experience: a CUDA graph is captured from real steps, so the learner
runs them on a zero block and the state is then put back exactly as it
was built. Every process does it at the same point (its steps'
exchanges are collectives).

Run via the CLI (one command per process):
    python -m ape_x_dqn_tpu_torch.runtime.train --config pong \\
        --coordinator HOST:PORT --num-processes 2 --process-id 0 ...
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
import time
from collections import deque

import numpy as np
import torch

from ape_x_dqn_tpu_torch.comm.param_codec import tree_map
from ape_x_dqn_tpu_torch.comm.transport import LoopbackTransport, batch_rows
from ape_x_dqn_tpu_torch.envs import make_env
from ape_x_dqn_tpu_torch.models import build_network
from ape_x_dqn_tpu_torch.obs.core import build_obs
from ape_x_dqn_tpu_torch.obs.fleet import FleetAggregator
from ape_x_dqn_tpu_torch.obs.health import StallWatchdog, make_lock
from ape_x_dqn_tpu_torch.ops import frame_gather
from ape_x_dqn_tpu_torch.parallel import multihost
from ape_x_dqn_tpu_torch.parallel.dist_learner import (DistDQNLearner,
                                                       DistSequenceLearner)
from ape_x_dqn_tpu_torch.parallel.inference_server import (
    BatchedInferenceServer, build_serving_tier)
from ape_x_dqn_tpu_torch.parallel.mesh import make_mesh
from ape_x_dqn_tpu_torch.runtime.build import build_prioritized_replay
from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
from ape_x_dqn_tpu_torch.runtime.evaluation import (
    RollingSuiteScore, eval_game_rotation, final_eval_game, params_crc32,
    run_eval_measured)
from ape_x_dqn_tpu_torch.runtime.family import (
    actor_class, family_of, family_setup, server_apply_fn)
from ape_x_dqn_tpu_torch.runtime.learner import (checkpoint_tree,
                                                 restore_checkpoint_tree)
from ape_x_dqn_tpu_torch.utils.checkpoint import CheckpointManager
from ape_x_dqn_tpu_torch.utils.hbm import check_hbm_fits
from ape_x_dqn_tpu_torch.utils.metrics import Metrics, log_run_header
from ape_x_dqn_tpu_torch.utils.misc import next_pow2, resolve_device
from ape_x_dqn_tpu_torch.utils.rng import component_generator


class MultihostApexDriver:
    """Synchronous-round Ape-X driver; one instance per learner process.

    Supports the flat-DQN family (both storage layouts) and the
    recurrent R2D2 family (stored-state sequence replay, both item
    layouts). The continuous DPG family runs multi-host by putting its
    ACTORS on remote hosts (runtime/actor_host.py) against a
    single-process learner."""

    def __init__(self, cfg, metrics: Metrics | None = None,
                 transport=None, device: str | torch.device = "cuda"):
        """transport: as ApexDriver's (a SocketIngestServer also takes
        remote actor hosts). device: the card (default: cuda, card rank
        % the visible cards; `multihost.local_device`), or "cpu". A
        rank's mesh is its one card repeated; a multi-host rank that
        holds several cards is not ported (ROADMAP Queue A item 6)."""
        if cfg.checkpoint_replay:
            # replicating every dp shard's replay into one payload would
            # multiply it by dp x capacity: needs a sharded save first
            raise NotImplementedError(
                "checkpoint_replay is single-host only for now "
                "(ApexDriver); the multihost driver checkpoints "
                "params/opt/rng/step/frames and refills replay on "
                "resume — set checkpoint_replay=False here")
        # a 1-process fleet is valid ONLY under an initialized process
        # group (the CLI's --coordinator path); plain single-process
        # training belongs in ApexDriver
        if not multihost.initialized():
            raise RuntimeError(
                "MultihostApexDriver requires an initialized "
                "torch.distributed process group (parallel/multihost.py: "
                "init_multihost; use ApexDriver for single-process runs)")
        self.cfg = cfg
        self.family = family_of(cfg)
        if self.family == "dpg":
            raise NotImplementedError(
                "the multihost lockstep loop covers the DQN and R2D2 "
                "families; DPG nets are small — run the learner "
                "single-process with remote actor hosts "
                "(runtime/actor_host.py)")
        if cfg.replay.kind not in ("prioritized", "sequence"):
            raise ValueError(
                "the multihost learner requires prioritized replay "
                "(the per-shard sum-trees ARE the sharded state; "
                "kind='sequence' for R2D2); got "
                f"replay.kind={cfg.replay.kind!r}")
        self.rank = multihost.process_index()
        self.nproc = multihost.process_count()
        self.device = resolve_device(multihost.local_device(device))
        if self.device.type == "cuda":
            # streams, events and NCCL's communicator default to it
            torch.cuda.set_device(self.device)
        self.metrics = metrics or Metrics()
        self.obs = build_obs(getattr(cfg, "obs", None), self.metrics)
        probe_env = make_env(cfg.env, seed=cfg.seed)
        self.spec = probe_env.spec
        self.net = build_network(cfg.network, self.spec)
        obs0 = probe_env.reset()

        self.dp = cfg.parallel.dp
        self.row_start, self.row_stop = multihost.process_rows(self.dp)
        self.dp_local = self.row_stop - self.row_start
        tp = cfg.parallel.tp
        # this process's rows, every one on its own card
        self.mesh = make_mesh(dp=self.dp_local, tp=tp,
                              devices=[self.device] * (self.dp_local * tp))

        setup = family_setup(cfg, self.spec, self.net, obs0)
        self._frame_mode = setup.frame_mode
        self._chunk = setup.stage_chunk
        self._unit_items = setup.unit_items
        self._item_keys = tuple(setup.item_spec.keys())
        self._item_spec = setup.item_spec
        # the group's first collectives wait on every peer: a watchdog
        # ends this process if one never answers
        with self._watched("joining the group: the placement and mode "
                           "agreement, NCCL's communicator"):
            # the processes that share the card (a one-off gather), then
            # one exchange mode for the whole group (one collective)
            self.processes_on_card = multihost.processes_on_device(
                self.device)
            mode = multihost.agreed_exchange_mode(
                self.device.type == "cuda", self.processes_on_card)
            # early, loud fits-check: this process's shards + model
            # state, times the processes on the card, and NCCL's buffers
            self.hbm_budget = check_hbm_fits(
                cfg, self.spec.obs_shape, self.spec.obs_dtype,
                param_count=sum(p.numel() for p in self.net.parameters()),
                device=self.device,
                shards_per_card=self.mesh.shards_on(self.device),
                processes_per_card=self.processes_on_card,
                nccl=mode == "nccl")
            # the NCCL exchange makes its communicator now, before any
            # capture, and raises rather than fall back to gloo
            self.exchange = multihost.GradExchange(mode, self.device)
        self.net.to(self.device)

        # identical construction on every process (same cfg.seed) ->
        # identical initial params and learner generator
        shard_cap = next_pow2(max(cfg.replay.capacity // self.dp, 2))
        self.replay = build_prioritized_replay(
            cfg, self.spec, shard_cap, self.device,
            frame_mode=self._frame_mode)
        self.capacity = shard_cap * self.dp
        self.learner = (
            DistSequenceLearner(self.replay, cfg.learner, cfg.replay,
                                self.mesh, exchange=self.exchange)
            if self.family == "r2d2"
            else DistDQNLearner(self.replay, cfg.learner, self.mesh,
                                exchange=self.exchange))
        self.state = self.learner.init(
            self.net, None if self._frame_mode else setup.item_spec,
            component_generator(cfg.seed, "learner", device=self.device))
        cuda = self.device.type == "cuda"
        # the round loop's device work (adds, steps, exchanges, the
        # publication copy) runs on its own stream; the server keeps
        # the default one
        self._learn_stream = torch.cuda.Stream(self.device) if cuda else None

        server_params = self.learner.publish_params(self.state)
        server_mesh = self.mesh if cfg.inference.shard_over_mesh else None
        # the server and the serving tier stay process-local: admission
        # and dispatch never cross processes, so neither can perturb
        # the lockstep
        self.serving = None
        if cfg.serving.multi_tenant:
            self.serving = build_serving_tier(
                cfg.serving, max_batch=cfg.inference.max_batch,
                deadline_ms=cfg.inference.deadline_ms, mesh=server_mesh,
                obs=self.obs, device=self.device)
            self.server = self.serving.register_policy(
                cfg.env.id, server_apply_fn(self.family, self.net),
                server_params, family=self.family,
                priority=cfg.serving.default_class)
        else:
            self.server = BatchedInferenceServer(
                server_apply_fn(self.family, self.net), server_params,
                max_batch=cfg.inference.max_batch,
                deadline_ms=cfg.inference.deadline_ms, mesh=server_mesh,
                obs=self.obs, device=self.device)
        self.transport = transport if transport is not None \
            else LoopbackTransport()
        self._host_params = not isinstance(self.transport,
                                           LoopbackTransport)
        self._pinned: dict[str, torch.Tensor] = {}
        # fleet telemetry (obs/fleet.py): host-local, no collectives
        self.fleet = None
        if self.obs.enabled:
            agg = FleetAggregator(self.obs)
            if agg.install(self.transport):
                self.fleet = agg
        self.transport.publish_params(self._transport_params(server_params),
                                      0)

        self.stop_event = threading.Event()
        self._lock = make_lock("multihost_driver._lock")
        self.episode_returns: deque[float] = deque(maxlen=200)  # guarded-by: _lock
        self._frames_local = 0  # guarded-by: _lock
        # frame counters survive resume: _frames_base restores from the
        # checkpoint so a --total-env-frames budget CONTINUES after a
        # preemption; _frames_global_latest mirrors the last collective's
        # total (identical on every process) for the checkpoint payload
        self._frames_base = 0
        self._frames_global_latest = 0
        self._grad_steps = 0
        self._restored_step: int | None = None
        # all-or-none agreement on checkpoint_dir: saves and restores are
        # collectives, so a fleet where only some processes got a
        # directory would issue mismatched calls
        has = 1 if cfg.checkpoint_dir else 0
        mn = multihost.global_min_scalar(has)
        mx = -multihost.global_min_scalar(-has)
        if mn != mx:
            raise ValueError(
                "checkpoint_dir must be set on EVERY process or none "
                f"(this process: {'set' if has else 'unset'}) — "
                "checkpoint save/restore are collectives")
        self.ckpt = (CheckpointManager(cfg.checkpoint_dir)
                     if cfg.checkpoint_dir else None)
        self.checkpoint_saves = 0
        if self.ckpt is not None:
            self._maybe_restore()
        self._stage: list[dict] = []
        self._stage_n = 0
        self._actor_threads: list[threading.Thread] = []
        self._saw_remote = False  # first remote actor-host connection
        self.actor_errors: list[tuple[int, Exception]] = []  # guarded-by: _lock
        self.last_eval: dict | None = None  # guarded-by: _lock
        self._eval_error: Exception | None = None  # guarded-by: _lock

    @contextlib.contextmanager
    def _watched(self, what: str):
        """A `StallWatchdog` armed across the block (`what` names it in
        its diagnostic): collectives outside the round loop wait on
        every peer too. -> the watchdog, to stamp."""
        watchdog = StallWatchdog(self.cfg.multihost_watchdog_s,
                                 describe=lambda: what)
        watchdog.start()
        try:
            yield watchdog
        finally:
            watchdog.stop()

    def close(self) -> None:
        """Release the learner's step graphs, after the card has run
        them (`GraphedEndpoints.release_graphs`): NCCL destroys no
        communicator while a CUDA graph holding one of its collectives
        lives, so the CLI calls this before it leaves the process
        group. A replayed collective whose peer died never ends, so the
        wait for the card is watched too."""
        with self._watched("releasing the step graphs"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.learner.release_graphs()

    # -- checkpoint/resume -------------------------------------------------

    def _ckpt_template(self) -> dict:
        tree = checkpoint_tree(self.state)
        tree["frames_global"] = int(self._frames_global_latest)
        return tree

    def _save_checkpoint(self, wait: bool = False) -> None:
        """COLLECTIVE (a barrier): every process calls it on the same
        round; process 0 writes the (replicated) train state."""
        with self.obs.span("ckpt.save", step=self._grad_steps):
            multihost.barrier()
            if self.rank == 0:
                # copies on the device, on the round loop's stream; the
                # writer thread waits for them
                payload = tree_map(
                    lambda x: x.detach().clone()
                    if isinstance(x, torch.Tensor) else x,
                    self._ckpt_template())
                ready = None
                if self.device.type == "cuda":
                    ready = torch.cuda.Event()
                    ready.record()
                self.ckpt.save(self._grad_steps, payload, wait=wait,
                               ready=ready)
        self.checkpoint_saves += 1

    def _maybe_restore(self) -> None:
        """Restore the newest checkpoint step EVERY process can read,
        IN PLACE (the graphs read the state's tensors at fixed
        addresses). The min-agreement makes a missing or stale directory
        on one host degrade to a fresh start (or an older common step)
        instead of deadlocking the collectives."""
        local = self.ckpt.latest_step()
        agreed = multihost.global_min_scalar(
            -1 if local is None else int(local))
        if agreed < 0:
            return
        with self.obs.span("ckpt.restore"):
            raw = self.ckpt.restore(agreed, template=self._ckpt_template())
        restore_checkpoint_tree(self.state, raw)
        self._grad_steps = int(raw["step"])
        self._frames_base = int(raw.get("frames_global", 0))
        self._frames_global_latest = self._frames_base
        self._restored_step = agreed
        # republish: the server and the transport hold the fresh init
        self._publish(self._grad_steps)

    # -- publication ---------------------------------------------------------

    # what the one-process driver does alike, from the same attributes:
    # the transport's copy of a publication (`pub` in process, numpy for
    # remote hosts; _host_params, device, _pinned), an episode's return,
    # an eval worker on the server, and the warm-up of the server's
    # buckets and of the cost counters (cfg, server, family, spec)
    _transport_params = ApexDriver._transport_params
    _on_episode = ApexDriver._on_episode
    _make_eval_worker = ApexDriver._make_eval_worker
    _warmup = ApexDriver._warmup

    def _publish(self, version: int) -> None:
        """Process-local: every process holds the whole params. The
        copy is made on the caller's stream, which is waited for before
        the server (on its own stream) gets it."""
        pub = self.learner.publish_params(self.state)
        host = self._transport_params(pub)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.server.update_params(pub, version)
        self.transport.publish_params(host, version)

    # -- local actor plumbing (per host) ----------------------------------

    def _actor_thread(self, i: int, max_frames: int) -> None:
        try:
            # distinct global actor identities per process: without the
            # offset every process's actor i would share seeds and eps_i;
            # the eps schedule spans the num_actors * nproc fleet
            n_local = self.cfg.actors.num_actors
            acfg = dataclasses.replace(
                self.cfg, actors=dataclasses.replace(
                    self.cfg.actors, num_actors=n_local * self.nproc))
            vector = self.cfg.actors.envs_per_actor > 1
            query = (self.server.query_batch if vector
                     else self.server.query)
            actor = actor_class(self.family, vector=vector)(
                acfg, self.rank * n_local + i, query, self.transport,
                episode_callback=self._on_episode, obs=self.obs)
            actor.run(max_frames, self.stop_event)
        except Exception as e:  # noqa: BLE001 - reported in run() output
            with self._lock:
                self.actor_errors.append((i, e))

    def _eval_loop(self) -> None:
        """Greedy eval on PROCESS 0 only, between publish boundaries.
        Collective-free: the worker queries the process-local server,
        so it runs beside the round loop without perturbing any
        process's call sequence."""
        try:
            every = self.cfg.eval_every_steps
            rotate, games = eval_game_rotation(self.cfg)
            worker = None if rotate else self._make_eval_worker()
            rolling = RollingSuiteScore(self.cfg) if rotate else None
            next_at = every
            eval_i = 0
            while not self.stop_event.wait(0.2):
                if self._grad_steps < next_at:
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
                    # a transient server stall: skip this slot
                    self.metrics.log(self._grad_steps,
                                     eval_game=game or self.cfg.env.id,
                                     eval_error=repr(e))
                    next_at = (self._grad_steps // every + 1) * every
                    continue
                if res is None:  # cancelled mid-eval at shutdown
                    break
                with self._lock:
                    self.last_eval = res
                roll = (rolling.update(game, res["mean_return"])
                        if rolling is not None and game else {})
                self.metrics.log(self._grad_steps,
                                 avg_eval_return=res["mean_return"],
                                 eval_episodes=res["episodes"],
                                 eval_game=game or self.cfg.env.id,
                                 eval_wall_s=time.monotonic() - t_eval,
                                 server_queue_depth_max=depth_max,
                                 **roll)
                next_at = (self._grad_steps // every + 1) * every
        except Exception as e:  # noqa: BLE001 - surfaced in run() output
            with self._lock:
                self._eval_error = e

    def _pump_ingest(self) -> None:
        """Drain the transport into the local stage (each round; the
        round loop owns the state, so there is no ingest thread).

        While producers are live the stage is capped at a few ingest
        blocks: the round loop consumes at most one block per round, so
        an uncapped pump would absorb everything actors produce during
        a dispatch (unbounded host memory) and defeat the transport's
        drop-oldest backpressure. Once every producer is gone the cap
        lifts: leftover queue contents are finite, and local_idle needs
        pending == 0, so a capped pump would leave this host unable to
        ever read idle (a fleet-wide livelock at the all_idle gate)."""
        conns = getattr(self.transport, "active_connections", 0)
        if conns > 0 or getattr(self.transport, "ever_connected", False):
            # ever_connected catches a producer that connected and
            # vanished between two of this loop's looks
            self._saw_remote = True
        producers_live = (
            any(t.is_alive() for t in self._actor_threads) or conns > 0)
        cap = 4 * self.dp_local * self._chunk if producers_live \
            else float("inf")
        while self._stage_n < cap:
            batch = self.transport.recv_experience(timeout=0.0)
            if batch is None:
                return
            n = batch_rows(batch)
            frames = int(batch.get("frames", n))
            # copy the rows out (a shared-memory slot is then released)
            rel = getattr(batch, "release", None)
            batch = {k: np.asarray(batch[k]).copy()
                     for k in self._item_keys + ("priorities",)}
            if rel is not None:
                rel()
            with self._lock:
                self._frames_local += frames
            self._stage.append(batch)
            self._stage_n += n

    def _pop_block(self) -> dict | None:
        """Take one [dp_local, chunk, ...] block off the stage (unit i
        of the block goes to this process's shard i // chunk)."""
        need = self.dp_local * self._chunk
        if self._stage_n < need:
            return None
        fields = {k: np.concatenate([b[k] for b in self._stage])
                  for k in self._item_keys + ("priorities",)}
        take = {k: v[:need] for k, v in fields.items()}
        rest = {k: v[need:] for k, v in fields.items()}
        self._stage = [rest] if rest["priorities"].shape[0] else []
        self._stage_n -= need
        return take

    def _add_block(self, block: dict) -> None:
        """One lockstep add of this process's [dp_local, chunk] block:
        the add graph's static inputs on the card (one replay), the add
        body elsewhere; then the host cursor advances."""
        views = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in block.items()}
        staged = self.learner.land_add(1, views, (self.dp_local,
                                                  self._chunk))
        self.state = self.learner.add_landed(self.state, 1, staged)

    def _filled(self) -> int:
        """The global replay fill: lockstep adds keep every process's
        shards alike, so this process's host cursors times nproc."""
        return int(np.sum(self.state.replay.size)) * self.nproc

    def _min_fill(self) -> int:
        return min(self.cfg.replay.min_fill, self.capacity // 2)

    def _warmup_learner(self, chunk_steps: int) -> None:
        """Capture the add graph and the step graphs the round loop
        replays (a `chunk_steps` dispatch, and the single steps of a
        short tail), each by its warm-up and capture calls, on a zero
        block added twice; then put the state back: params, targets,
        Adam, the generator and the step from a copy, the replay zeroed
        and its cursors at 0, as built. The exchanges' counts restart.
        On the CPU the same steps run eagerly (nothing to capture)."""
        keep = tree_map(lambda x: x.detach().clone()
                        if isinstance(x, torch.Tensor) else x,
                        checkpoint_tree(self.state))
        n = self.dp_local * self._chunk
        ptail = ((self.cfg.replay.seg_transitions,) if self._frame_mode
                 else ())
        zero = {k: torch.zeros((n, *s.shape), dtype=s.dtype).numpy()
                for k, s in self._item_spec.items()}
        zero["priorities"] = np.ones((n, *ptail), np.float32)
        for _ in range(2):
            self._add_block(zero)
        for _ in range(2):
            self.state, _ = self.learner.train_many(self.state, chunk_steps)
        if chunk_steps > 1:   # the tail of a run dispatches single steps
            for _ in range(2):
                self.state, _ = self.learner.train_step(self.state)
        rs = self.state.replay
        with torch.no_grad():
            for t in rs.storage.values():
                t.zero_()
            rs.tree.zero_()
        rs.pos = np.zeros(self.dp_local, np.int64)
        rs.size = np.zeros(self.dp_local, np.int64)
        restore_checkpoint_tree(self.state, keep)
        self.exchange.reset()

    @staticmethod
    def _part(parts: dict, name: str, t0: float,
              t_train: float | None) -> float:
        """Add the seconds since `t0` to `parts[name]` once the training
        window has opened (`t_train`). -> now."""
        now = time.monotonic()
        if t_train is not None:
            parts[name] += now - t0
        return now

    def _step_graphs(self) -> dict:
        """{step endpoint: captured graphs one call replays}: 1 with the
        NCCL exchange, 5 a K=4 macro-step with gloo's (segments), 0
        where nothing is captured (the CPU)."""
        return {g.name: g.graphs
                for g in self.learner.step_graphs().values()}

    # -- the lockstep round loop ------------------------------------------

    def run(self, total_env_frames: int | None = None,
            max_grad_steps: int = 10**9) -> dict:
        """Round loop. Termination derives from global frame/step counts
        only (wall clocks differ across hosts and would diverge the
        call sequences)."""
        cfg = self.cfg
        total = total_env_frames or cfg.total_env_frames
        per_actor = (total // max(self.nproc, 1)
                     // max(cfg.actors.num_actors, 1))
        publish_every = cfg.learner.publish_every
        chunk_steps = max(min(cfg.learner.train_chunk, publish_every), 1)

        threads = [threading.Thread(target=self._actor_thread,
                                    args=(i, per_actor),
                                    name=f"actor-{i}", daemon=True)
                   for i in range(cfg.actors.num_actors)]
        self._actor_threads = threads  # _pump_ingest's cap-lift check
        log_run_header(self.metrics, cfg, self._grad_steps)
        self.metrics.log(self._grad_steps,
                         multihost_backend=self.exchange.mode,
                         world_size=self.nproc, process=self.rank,
                         rows=[self.row_start, self.row_stop],
                         processes_on_card=self.processes_on_card)
        print(f"[multihost] process {self.rank}/{self.nproc}: backend "
              f"{self.exchange.mode}, world size {self.nproc}, rows "
              f"[{self.row_start}, {self.row_stop}) of dp={self.dp}, "
              f"device {self.device}, {self.processes_on_card} "
              f"process(es) on this card", file=sys.stderr, flush=True)
        self._warmup()
        if self.device.type == "cuda":
            # the state was made on the default stream
            torch.cuda.synchronize(self.device)
        stream = (torch.cuda.stream(self._learn_stream)
                  if self._learn_stream is not None
                  else contextlib.nullcontext())
        # the learner's warm-up exchanges and captures wait on every peer
        # as the round loop's steps do
        with self._watched("the learner's warm-up: its exchanges and "
                           "captures"), stream:
            self._warmup_learner(chunk_steps)
        self.metrics.log(self._grad_steps, step_graphs=self._step_graphs())
        evaluator = None
        if (self.rank == 0 and cfg.eval_every_steps > 0
                and cfg.eval_episodes > 0):
            evaluator = threading.Thread(target=self._eval_loop,
                                         name="eval", daemon=True)
            evaluator.start()
        for t in threads:
            t.start()

        t0 = time.monotonic()
        t_train = None
        # the round loop's host seconds by part, from the first train
        # dispatch on (the training window): the rest of the window is
        # the loop's own bookkeeping
        parts = dict.fromkeys(("ingest", "stats", "add", "dispatch",
                               "publish", "checkpoint", "idle"), 0.0)
        frames_global = float(self._frames_base)
        loss = float("nan")
        last_ckpt = self._grad_steps
        filled = self._filled()
        watchdog = StallWatchdog(
            cfg.multihost_watchdog_s,
            describe=lambda: (
                f"grad_steps={self._grad_steps} filled={filled} "
                f"frames_local={self._frames_local} "
                f"stage_n={self._stage_n}"))
        watchdog.start()
        try:
            with stream:
                while True:
                    t_part = time.monotonic()
                    self._pump_ingest()
                    t_part = self._part(parts, "ingest", t_part, t_train)
                    progressed = False
                    # 0. ONE collective for this round's global control
                    # values. local_idle: this host can never produce
                    # another ingest block (actors finished or dead, no
                    # live remote producer, transport drained),
                    # independent of the stage: a host stranded with a
                    # full block that OTHER hosts can never match must
                    # still read idle, or an asymmetric drain spins
                    # every process forever
                    blocks_ready = 1.0 if self._stage_n >= \
                        self.dp_local * self._chunk else 0.0
                    # boot grace: a host with NO local actors whose
                    # listening transport has never seen a remote actor
                    # host must not read idle (active_connections is 0
                    # only because producers are still booting); bounded
                    # by actors.remote_boot_grace_s, host-local wall
                    # clock, which changes only this host's REPORTED flag
                    booting = (cfg.actors.num_actors == 0
                               and hasattr(self.transport,
                                           "active_connections")
                               and not self._saw_remote
                               and time.monotonic() - t0
                               < cfg.actors.remote_boot_grace_s)
                    # quiesced() (socket transport) debounces transient
                    # remote disconnects; loopback never has producers
                    # that flicker
                    remote_quiet = (
                        self.transport.quiesced()
                        if hasattr(self.transport, "quiesced")
                        else getattr(self.transport,
                                     "active_connections", 0) == 0)
                    local_idle = 1.0 if (
                        not booting
                        and not any(t.is_alive() for t in threads)
                        and remote_quiet
                        and self.transport.pending == 0) else 0.0
                    with self._lock:
                        frames_local = self._frames_local
                    t_part = time.monotonic()
                    all_ready, all_idle, frames_global = \
                        multihost.global_stats(blocks_ready, local_idle,
                                               float(frames_local))
                    t_part = self._part(parts, "stats", t_part, t_train)
                    # a resumed run continues its frame budget from the
                    # checkpointed global count
                    frames_global += self._frames_base
                    self._frames_global_latest = int(frames_global)
                    # the collective returned: every peer is alive and in
                    # lockstep as of this round
                    watchdog.stamp()
                    # 1. collective ingest, gated on EVERY host having a
                    # block
                    if all_ready:
                        with self.obs.span("replay.add"):
                            self._add_block(self._pop_block())
                        filled = self._filled()
                        progressed = True
                    t_part = self._part(parts, "add", t_part, t_train)
                    # 2. lockstep training, branching on global values
                    # only; steps_per_frame_cap paces the learner to the
                    # GLOBAL frame count
                    cap = cfg.learner.steps_per_frame_cap
                    cap_bound = (cap is not None
                                 and self._grad_steps >= cap * frames_global)
                    if filled >= self._min_fill() and not cap_bound \
                            and self._grad_steps < max_grad_steps:
                        # whole chunks; publication on boundary crossings
                        done = self._grad_steps
                        k = chunk_steps if chunk_steps <= \
                            max_grad_steps - done else 1
                        if t_train is None:
                            t_train = t_part = time.monotonic()
                        with self.obs.stage_window("train_dist", k,
                                                   stream=self._learn_stream):
                            with self.obs.span("learner.train", k=k):
                                if k > 1:
                                    self.state, m = self.learner.train_many(
                                        self.state, k)
                                else:
                                    self.state, m = self.learner.train_step(
                                        self.state)
                                loss = float(m["loss"])  # honest timing
                        t_part = self._part(parts, "dispatch", t_part,
                                            t_train)
                        self._grad_steps += k
                        self.obs.set_learner_step(self._grad_steps)
                        self.obs.mark("replay.sample",
                                      fused_into="learner.train")
                        self.obs.mark("replay.priority_update",
                                      fused_into="learner.train")
                        progressed = True
                        if done // publish_every != \
                                self._grad_steps // publish_every:
                            with self.obs.span("learner.publish_params"):
                                self._publish(self._grad_steps)
                            with self._lock:
                                returns = list(self.episode_returns)
                            self.metrics.log(
                                self._grad_steps, loss=loss,
                                replay_filled=filled,
                                frames_global=int(frames_global),
                                frames_local=frames_local,
                                avg_return=(float(np.mean(returns))
                                            if returns else None))
                            self.obs.gauge("replay_occupancy", filled)
                            self.obs.publish(self._grad_steps)
                        t_part = self._part(parts, "publish", t_part,
                                            t_train)
                    # checkpoints on a grad-step cadence: a global value,
                    # so every process reaches the barrier on one round
                    if (self.ckpt is not None
                            and self._grad_steps - last_ckpt
                            >= cfg.checkpoint_every):
                        self._save_checkpoint()
                        last_ckpt = self._grad_steps
                        watchdog.stamp()
                        self._part(parts, "checkpoint", t_part, t_train)
                    # 3. global termination: every condition derives from
                    # the round's collective, so every process breaks on
                    # the same round (guards against frame counts that
                    # never reach `total`: drops, per-actor truncation)
                    if self._grad_steps >= max_grad_steps:
                        break
                    if frames_global >= total and max_grad_steps >= 10**9:
                        break  # frame-budget run: actors are done
                    if all_idle and not all_ready and (
                            max_grad_steps >= 10**9
                            or filled < self._min_fill() or cap_bound):
                        # no host can produce experience again and the
                        # ingest gate cannot fire; there is no finite step
                        # target to chase, training can never start, or
                        # the pacing cap binds forever
                        break
                    if not progressed:
                        # idle round: host-local pacing, no collective
                        # skipped
                        t_part = time.monotonic()
                        time.sleep(0.05)
                        self._part(parts, "idle", t_part, t_train)
                # final checkpoint BEFORE joining actors: the break is
                # lockstep, so the barrier is aligned. The watchdog stays
                # armed through the final collectives.
                watchdog.stamp()
                if self.ckpt is not None and self._grad_steps > last_ckpt:
                    self._save_checkpoint(wait=True)
                if self.ckpt is not None:
                    self.ckpt.close()
                if self._learn_stream is not None:
                    self._learn_stream.synchronize()
        except BaseException:
            # crash path: HOST-LOCAL teardown only; the clean exit's
            # collectives would hang on peers that diverged or died
            watchdog.stop()
            self.stop_event.set()
            self.server.stop()
            self.obs.close(self._grad_steps)
            raise
        watchdog.stop()
        t_end = time.monotonic()
        self.stop_event.set()
        for t in threads:
            t.join(timeout=5)
        if evaluator is not None:
            evaluator.join(timeout=10)
        # a guaranteed greedy evaluation on process 0 while the local
        # server is still up (short runs can end inside one eval poll)
        if (self.rank == 0 and cfg.eval_episodes > 0
                and self.last_eval is None and self._grad_steps > 0
                and self._eval_error is None):
            try:
                game = final_eval_game(cfg)
                res = self._make_eval_worker(game=game).run(
                    cfg.eval_episodes, max_frames=cfg.eval_max_frames,
                    deadline_s=cfg.final_eval_deadline_s)
                if res is not None:
                    with self._lock:
                        self.last_eval = res
                    self.metrics.log(
                        self._grad_steps,
                        avg_eval_return=res["mean_return"],
                        eval_episodes=res["episodes"],
                        eval_game=game or cfg.env.id)
            except Exception as e:  # noqa: BLE001
                with self._lock:
                    self._eval_error = e
        self.server.stop()
        self.obs.close(self._grad_steps)
        with self._lock:
            avg_ret = (float(np.mean(self.episode_returns))
                       if self.episode_returns else 0.0)
        cuda = self.device.type == "cuda"
        peak = torch.cuda.max_memory_allocated(self.device) if cuda else None
        peak_reserved = (torch.cuda.max_memory_reserved(self.device)
                         if cuda else None)
        return {
            "process": self.rank,
            "frames": int(frames_global),
            "frames_local": self._frames_local,
            "grad_steps": self._grad_steps,
            "loss": loss,
            "replay_filled": filled,
            "avg_return": avg_ret,
            "wall_s": t_end - t0,
            # seconds from the first train dispatch to the loop's end, and
            # those spent in the dispatches (each up to its loss on the
            # host); the rest of the window is the round loop's own
            "train_wall_s": (t_end - t_train) if t_train else 0.0,
            "dispatch_s": parts["dispatch"],
            # the window's host seconds by part of the round loop
            "round_s": parts,
            "restored_step": self._restored_step,
            # grad-step of the last weight publication (0 = never)
            "params_version": self.server.params_version,
            "checkpoint_saves": self.checkpoint_saves,
            "actor_errors": [f"{i}: {e!r}" for i, e in self.actor_errors],
            "eval": self.last_eval,
            "eval_error": (repr(self._eval_error)
                           if self._eval_error else None),
            "multihost": {
                "backend": self.exchange.mode, "world_size": self.nproc,
                "rows": [self.row_start, self.row_stop],
                "device": str(self.device),
                "processes_on_card": self.processes_on_card,
                "exchange": self.exchange.stats(),
                "params_crc32": params_crc32(
                    self.learner.publish_params(self.state)),
                "gather_rows_launches": frame_gather.gather_rows.launches,
                "add_graph_replays": sum(
                    g.replays for g in self.learner.add_graphs().values()),
                "step_graphs": self._step_graphs(),
                "peak_mem_bytes": peak,
                "peak_reserved_bytes": peak_reserved,
                "hbm_budget_bytes": self.hbm_budget.total,
                "hbm_budget_nccl_bytes": self.hbm_budget.nccl,
            },
        }

