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

Streams (on CUDA): the learner thread and the ingest thread each work on
a stream of their own, and the server on the default one, so the
server's forwards run beside the learner's graphs instead of queueing
behind them. Under `_state_lock` each train dispatch first waits (on the
device) for the adds ingest has enqueued, and records an event that the
next add waits for; the learner keeps at most two dispatches in flight
and waits for its stream before it hands a publication to the server.

On the card the learner replays captured CUDA graphs (runtime/
step_graph.py), which release the interpreter lock for a whole
macro-step as the original's jitted learner does, so actors query the
server freely. An eager learner (the CPU path, or `learner.capture`
off) issues thousands of torch calls a macro-step, each retaking the
interpreter lock; for it alone the driver keeps the learner-priority
gate (`_gated`): actor queries wait while the learner dispatches.

Remote actor hosts (runtime/actor_host.py): pass a
``comm.socket_transport.SocketIngestServer`` as `transport` and the
learner also ingests what hosts ship over TCP or shared memory; each
publication then hands the server a numpy copy of the params, made on
the learner thread and ordered after its stream. With no local actors
(``actors.num_actors == 0``) the learner waits for the first host
(``actors.remote_boot_grace_s``) and ends once every host has quiesced
and the queue has drained. The summary's ``wire`` entry holds the
transport's byte and shared-memory accounting.

Checkpoints (``checkpoint_dir``, utils/checkpoint.py): params, target
params, optimizer state, the learner's RNG state and the grad-step
counter every ``checkpoint_every`` grad-steps and at shutdown (the
replay too under ``checkpoint_replay``), copied on the device under the
state lock and written by the manager's thread. A driver built over a
directory that holds one restores the newest IN PLACE (``copy_`` into
the tensors the captured graphs read, the replay's cursor through its
setters, so the device mirrors follow), before any graph is captured.
The resumed run's grad-step counter goes on from the restored step; its
pacing (``steps_per_frame_cap``) counts only the steps and frames of
this run, so a run that resumes without its replay trains at the cap's
pace once it has refilled ``min_fill``, as a fresh run does.

Nothing compiles in the port, so the original's AOT warm-up becomes one
forward per server bucket (`_warmup`), which changes no learner state;
the ingest add is one captured graph per (replay, g) on the card
(runtime/step_graph.py: AddGraph). Before anything is allocated on the
card, `check_hbm_fits` prices the run (utils/hbm.py), each card at the
replay shards the mesh puts there, and raises when it cannot fit. All
three families run here: flat DQN, R2D2 (recurrent actors, stateful
{obs, c, h} server queries, whole sequences as staging units and the
`SequenceLearner`,
runtime/sequence_learner.py) and Ape-X DPG (continuous actors, {a, q}
server replies and the `DPGLearner`, runtime/dpg_learner.py).

The dp-sharded learner (``parallel.dp * parallel.tp > 1``,
parallel/dist_learner.py): the DQN and R2D2 families over a (dp, tp)
mesh (parallel/mesh.py) of `mesh_devices`, by default the visible
cards, as the original's mesh is over ``jax.devices()``; a list that
repeats one card puts every shard on it (the presets' own dp=4 x tp=2
meshes on one card: ``[card] * 8``). The replay is dp shards of
``next_pow2(capacity // dp)`` stacked on one card; ingest stages blocks
of dp * stage_chunk units, and each ships as [dp, chunk] (or [g, dp,
chunk]): unit i of a block goes to shard i // chunk, so the shards fill
in lockstep; the cold tier's swap runs per shard, with the door closure
per shard. The summary's ``replay_shards`` holds each shard's fill and
mass. Over several distinct cards (``cpu:0 .. cpu:3`` on the CPU) the
learner is parallel/cards.py's: one group of stacked shards per owner
card, the [.., dp, chunk] blocks split by rows with one add graph per
group, the tp split across a row's cards, the servers' batches split
over the cards (parallel/inference_server.py), the HBM check per card
(`check_mesh_fits`, with the cold tier's swap buffers on each owner),
and the summary's ``mesh`` block (layout, the exchange's calls and
bytes, the graphs a call replays, gather launches, peak and budget by
card). The cold tier's swap runs per group on its owner (below), and
legacy staging moves each group's rows from the host straight to its
owner.

Legacy staging (``replay.ingest_zero_copy=False``): batches append to a
list and concatenate into fixed blocks at each flush (`_flush_stage`,
`_add_block`), with no `IngestStager`; each block ships through the
learner's `add`, eagerly. The cold tier refills through the stager and
refuses it.

Observability (``obs.enabled``, obs/core.py): spans, heartbeats, the
stall watchdog, the flight recorder, stage windows (CUDA events on the
learner's and ingest's streams, read at publish time), the fleet
aggregator over a socket transport's telemetry frames, and the fleet
supervisor (`_supervise_tick`: restart a wedged local actor slot in
place, quarantine it past ``actors.supervisor_max_restarts``,
quarantine a silent remote peer), with the remediation engine
(``remediation.mode`` observe or enforce, runtime/remediation.py) first
in line. ``profile_dir`` opens one ``torch.profiler`` window over
``profile_steps`` grad-steps.

Serving tier (``serving.multi_tenant``, parallel/inference_server.py):
the driver builds a `MultiPolicyInferenceServer` and registers its
policy under ``env.id``; `self.server` is then that tenant's
`TenantClient`, with the single-policy server's surface, and the
remediation engine's queue-SLO rule acts on the tier's backpressure.

Tiered cold replay (``replay.cold_tier_capacity``, replay/cold_store.py,
with a disk rung under it, replay/disk_store.py): once the ring is full
every staged block is an eviction swap (`_ship_staged_cold`): the
ring's lowest-priority-mass region is read out, compressed into the
host store, and overwritten by the block with a directed add; on the
card the plan and read, and the directed add, replay captured graphs
(runtime/step_graph.py). When the ingest queue runs dry, the refill tick
recalls the heaviest cold segments through the same stager
(`_cold_refill_tick`). The summary's ``cold_tier`` block holds the door
closure ``evicted == stored + dropped`` in transitions. Over several
cards each card group plans, reads and overwrites its own rows' regions
on its owner; every owner's reads are enqueued into pinned host buffers
of its own before one wait per owner, then the directed adds follow,
and the closure holds per shard as on one card.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import deque

import numpy as np
import torch

from ape_x_dqn_tpu_torch.comm.param_codec import tree_map
from ape_x_dqn_tpu_torch.comm.transport import LoopbackTransport, batch_rows
from ape_x_dqn_tpu_torch.envs import make_env
from ape_x_dqn_tpu_torch.models import build_network
from ape_x_dqn_tpu_torch.obs import profiling
from ape_x_dqn_tpu_torch.obs.core import ProfileWindow, build_obs
from ape_x_dqn_tpu_torch.obs.fleet import MAX_SPAN_IDS, FleetAggregator
from ape_x_dqn_tpu_torch.ops import frame_gather as fg
from ape_x_dqn_tpu_torch.parallel.cards import CardsLearner, group_learner
from ape_x_dqn_tpu_torch.parallel.dist_learner import (DistDQNLearner,
                                                       DistSequenceLearner)
from ape_x_dqn_tpu_torch.parallel.inference_server import (
    BatchedInferenceServer, MultiPolicyInferenceServer, build_serving_tier)
from ape_x_dqn_tpu_torch.parallel.mesh import make_mesh
from ape_x_dqn_tpu_torch.replay.cold_store import ColdStore
from ape_x_dqn_tpu_torch.runtime.build import build_prioritized_replay
from ape_x_dqn_tpu_torch.runtime.evaluation import (
    EvalWorker, RollingSuiteScore, eval_game_rotation, final_eval_game,
    make_eval_policy_factory, run_eval_measured)
from ape_x_dqn_tpu_torch.runtime.dpg_learner import DPGLearner
from ape_x_dqn_tpu_torch.runtime.family import (
    actor_class, family_of, family_setup, server_apply_fn, warmup_example)
from ape_x_dqn_tpu_torch.runtime.ingest import IngestStager
from ape_x_dqn_tpu_torch.runtime.learner import (
    DQNLearner, checkpoint_tree, restore_checkpoint_tree)
from ape_x_dqn_tpu_torch.runtime.remediation import (Actuators,
                                                     RemediationEngine)
from ape_x_dqn_tpu_torch.runtime.sequence_learner import SequenceLearner
from ape_x_dqn_tpu_torch.runtime.single_process import build_replay
from ape_x_dqn_tpu_torch.utils.checkpoint import CheckpointManager
from ape_x_dqn_tpu_torch.utils.hbm import (check_hbm_fits, check_mesh_fits,
                                          swap_bytes)
from ape_x_dqn_tpu_torch.utils.metrics import (Metrics, Throughput,
                                               log_run_header)
from ape_x_dqn_tpu_torch.utils.misc import next_pow2, resolve_device
from ape_x_dqn_tpu_torch.utils.rng import component_generator


class ApexDriver:
    def __init__(self, cfg, metrics: Metrics | None = None,
                 transport=None, device: str | torch.device = "cuda",
                 mesh_devices: list | None = None):
        """transport: experience ingest + param distribution (defaults
        to the in-process LoopbackTransport; a SocketIngestServer also
        accepts remote actor hosts). device: the card the replay, the
        learner and the inference server live on (a CUDA request
        without a card raises). mesh_devices: the dp-sharded learner's
        device list (default: the visible cards; parallel/mesh.py),
        whose one card must be of `device`'s type."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.metrics = metrics or Metrics()
        # observability facade (obs/): NULL_OBS unless cfg.obs.enabled,
        # so every span/beat below is a no-op method call when off
        self.obs = build_obs(getattr(cfg, "obs", None), self.metrics)
        probe_env = make_env(cfg.env, seed=cfg.seed)
        self.spec = probe_env.spec
        self.net = build_network(cfg.network, self.spec)
        obs0 = probe_env.reset()
        self.family = family_of(cfg)
        setup = family_setup(cfg, self.spec, self.net, obs0)
        modules = self.net if self.family == "dpg" else (self.net,)
        self.dp = cfg.parallel.dp
        self.is_dist = cfg.parallel.dp * cfg.parallel.tp > 1
        self.mesh = None
        if self.is_dist:
            # the original's mesh error on too few devices (the CLI's
            # default device list on a one-card box)
            self.mesh = make_mesh(dp=cfg.parallel.dp, tp=cfg.parallel.tp,
                                  devices=mesh_devices)
            if self.mesh.device.type != self.device.type:
                raise ValueError(
                    f"the mesh's device {self.mesh.device} is not a "
                    f"{self.device.type} device")
            self.device = resolve_device(self.mesh.device)
        # a mesh over several distinct cards: one card group per owner
        # (parallel/cards.py)
        self.cards = self.mesh is not None and self.mesh.distinct
        if self.is_dist and self.family == "dpg":
            raise NotImplementedError(
                "the distributed learner covers the DQN and R2D2 "
                "families; DPG nets are small — run dp=tp=1")
        # early, loud fits-check: the replay + model state must fit the
        # card BEFORE anything is allocated there (utils/hbm.py), with
        # every replay shard the mesh puts on it; over several cards,
        # every card with its own shards and param pieces
        self.hbm_budgets: dict = {}
        if self.cards:
            self.hbm_budgets = check_mesh_fits(
                cfg, self.spec.obs_shape, self.spec.obs_dtype,
                {k: tuple(v.shape) for k, v in self.net.state_dict().items()},
                self.mesh, swap_per_shard=(
                    swap_bytes(setup.item_spec, setup.stage_chunk,
                               cfg.replay.seg_transitions
                               if setup.frame_mode else None)
                    if cfg.replay.cold_tier_capacity > 0 else 0))
            self.hbm_budget = self.hbm_budgets[self.device]
        else:
            self.hbm_budget = check_hbm_fits(
                cfg, self.spec.obs_shape, self.spec.obs_dtype,
                param_count=sum(p.numel() for m in modules
                                for p in m.parameters()),
                device=self.device,
                shards_per_card=(self.mesh.shards_on(self.device)
                                 if self.mesh is not None else 1))
        for module in modules:
            module.to(self.device)
        item_spec = setup.item_spec
        self._frame_mode = setup.frame_mode
        self._item_keys = tuple(item_spec.keys())
        lgen = component_generator(cfg.seed, "learner", device=self.device)
        if self.is_dist:
            # replay shards + batch shards + one gradient over the mesh;
            # ingest round-robins staging units across the shards
            assert cfg.replay.kind in ("prioritized", "sequence"), \
                "distributed learner requires prioritized replay " \
                "(kind='prioritized', or kind='sequence' for R2D2)"
            shard_cap = next_pow2(max(cfg.replay.capacity // self.dp, 2))

            def shard_replay(device):
                return build_prioritized_replay(
                    cfg, self.spec, shard_cap, device,
                    frame_mode=self._frame_mode)

            r2d2 = self.family == "r2d2"
            if self.cards:
                self.learner = CardsLearner(
                    group_learner(
                        DistSequenceLearner if r2d2 else DistDQNLearner,
                        cfg.learner, cfg.replay if r2d2 else None),
                    shard_replay, cfg.learner, self.mesh)
                self.replay = self.learner.replay
            else:
                self.replay = shard_replay(self.device)
                self.learner = (
                    DistSequenceLearner(self.replay, cfg.learner,
                                        cfg.replay, self.mesh)
                    if r2d2
                    else DistDQNLearner(self.replay, cfg.learner,
                                        self.mesh))
            self.state = self.learner.init(  # guarded-by: _state_lock
                self.net, None if self._frame_mode else item_spec, lgen)
            self.capacity = shard_cap * self.dp
        else:
            self.replay = (build_prioritized_replay(
                               cfg, self.spec,
                               next_pow2(cfg.replay.capacity), self.device,
                               frame_mode=True)
                           if self._frame_mode
                           else build_replay(cfg.replay, self.device))
            replay_state = (self.replay.init() if self._frame_mode
                            else self.replay.init(item_spec))
            if self.family == "dpg":
                self.learner = DPGLearner(self.replay, cfg.learner)
                self.state = self.learner.init(  # guarded-by: _state_lock
                    *self.net, replay_state, lgen)
            else:
                self.learner = (SequenceLearner(self.replay, cfg.learner,
                                                cfg.replay)
                                if self.family == "r2d2"
                                else DQNLearner(self.replay, cfg.learner))
                self.state = self.learner.init(  # guarded-by: _state_lock
                    self.net, replay_state, lgen)
            self.capacity = self.replay.capacity
        # the learner updates its tensors in place: the server gets a
        # copy (publish_params clones) and keeps it to itself
        server_params = self.learner.publish_params(self.state)
        # the mesh-sharded server mode (buckets in multiples of the
        # mesh size) under inference.shard_over_mesh
        server_mesh = (self.mesh if self.is_dist
                       and cfg.inference.shard_over_mesh else None)
        # serving.multi_tenant swaps the single-policy server for the
        # serving tier: this driver's policy registers under env.id and
        # self.server is its TenantClient, with the same surface, so the
        # actor, eval and publication paths do not know about tenancy
        self.serving: MultiPolicyInferenceServer | None = None
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
        # a transport that serves remote hosts gets host (numpy) params;
        # the in-process one hands the server's tensors to nobody
        self._host_params = not isinstance(self.transport,
                                           LoopbackTransport)
        self._pinned: dict[str, torch.Tensor] = {}  # learner thread only
        # fleet telemetry plane (obs/fleet.py): with obs on and a
        # telemetry-capable transport, remote peers' snapshot frames
        # merge into this run's JSONL under peer/<id>/ keys and their
        # heartbeats feed the stall watchdog
        self.fleet: FleetAggregator | None = None
        if self.obs.enabled:
            agg = FleetAggregator(self.obs)
            if agg.install(self.transport):
                self.fleet = agg
        # forensics plane (obs/blackbox.py): the flight recorder dumps
        # on crash/atexit/SIGUSR2, and every dump carries the fleet's
        # retained per-peer telemetry frames
        self.obs.blackbox.set_peer(f"driver-{os.getpid()}")
        if self.fleet is not None:
            self.obs.blackbox.add_context_provider(
                lambda: {"peer_frames": self.fleet.retained_frames()})
        self.obs.blackbox.install()
        # initial publication, so a client of the param channel can
        # bootstrap before the first publish_every boundary
        self.transport.publish_params(self._transport_params(server_params),
                                      0)
        self.stop_event = threading.Event()
        # learner priority, for an eager learner only: cleared while it
        # dispatches, and every actor query waits on it (see _gated)
        self._gate_actors = not self.learner.graphed
        self._actors_may_run = threading.Event()
        self._actors_may_run.set()
        # the learner's and ingest's own streams (CUDA), the event of the
        # last train dispatch that the next add waits for (guarded-by:
        # _state_lock), and the dispatches still in flight (learner
        # thread only)
        cuda = self.device.type == "cuda"
        self._learn_stream = torch.cuda.Stream(self.device) if cuda else None
        self._ingest_stream = (torch.cuda.Stream(self.device) if cuda
                               else None)
        self._learn_done: torch.cuda.Event | None = None
        self._in_flight: deque = deque()
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
        self._slot_actor_obj: dict[int, object] = {}  # guarded-by: _lock
        # frames produced by FINISHED attempts of the slot's current
        # generation (crash restarts); the live attempt's count lives on
        # the actor object itself
        self._slot_done: dict[int, int] = {}  # guarded-by: _lock
        self._slot_restarts: dict[int, int] = {}  # guarded-by: _lock
        self._quarantined: set[int] = set()  # guarded-by: _lock
        self._peer_quarantined: set[str] = set()  # guarded-by: _lock
        # remediation-paused slots: slot -> remaining frame budget
        # (reversible, unlike a quarantine)
        self._slot_paused: dict[int, int] = {}  # guarded-by: _lock
        # the transport+stage drop total the remediation sensor last saw
        # (supervisor tick thread only)
        self._remed_dropped_seen = 0
        # fleet remediation plane (runtime/remediation.py): the policy
        # engine closing the monitor->actuator loop inside
        # _supervise_tick. mode="off" never constructs it
        self.remediation: RemediationEngine | None = None
        rcfg = getattr(cfg, "remediation", None)
        if rcfg is not None and rcfg.mode != "off":
            self.remediation = RemediationEngine(
                rcfg, obs=self.obs, metrics=self.metrics,
                actuators=Actuators(
                    restart_actor=self._supervise_actor,
                    quarantine_peer=self._quarantine_peer,
                    pause_actor=self._pause_actor_slot,
                    resume_actor=self._resume_actor_slot,
                    set_backpressure=self._remediation_backpressure,
                    set_priority=self._remediation_set_priority),
                default_class=cfg.serving.default_class)
            if self.obs.perf is not None:
                self.obs.perf.add_listener(self.remediation.note_perf)
            if self.obs.learn is not None:
                self.obs.learn.add_listener(self.remediation.note_learn)
        self._ingested_batches = 0  # guarded-by: _lock
        # frames ingested per actor index (remote hosts ship their
        # global index: actor_offset + slot); ingest thread only
        self._frames_by_actor: dict[int, int] = {}
        # host mirror of the replay fill, so the learner loop never
        # reads the state to decide whether it may train
        self._replay_filled = 0  # guarded-by: _lock
        # ingest staging: units (transitions, or whole frame segments in
        # frame-ring mode) accumulate in pinned host buffers until a
        # full fixed-size block ships to the device in one add
        self._stage_chunk = setup.stage_chunk
        self._unit_items = setup.unit_items
        self._stage_dropped = 0
        # the same staged drops per dp shard: unit i of a would-be [dp,
        # chunk] block lands on shard i // stage_chunk, so
        # sum(_stage_dropped_per_shard) == _stage_dropped
        self._stage_dropped_per_shard = np.zeros(self.dp, np.int64)
        # the dp-sharded learner's dispatches are their own stage
        self._train_stage = "train_dist" if self.is_dist else "train"
        self._item_spec = item_spec
        ptail = (cfg.replay.seg_transitions,) if self._frame_mode else ()
        # zero-copy staging (runtime/ingest.py), or, with
        # ingest_zero_copy=False, the legacy list of batches and its
        # unit count, concatenated at each flush (ingest thread only)
        self._stage: list[dict] = []
        self._stage_n = 0
        self._stager: IngestStager | None = None
        if getattr(cfg.replay, "ingest_zero_copy", True):
            self._stager = IngestStager(
                item_spec, ptail,
                block_units=self.dp * self._stage_chunk,
                coalesce=getattr(cfg.replay, "ingest_coalesce", 4),
                buffers=getattr(cfg.replay, "stage_buffers", 2),
                ship=self._ship_staged, pin=self.device.type == "cuda")
        # tiered cold store (replay/cold_store.py), off by default: with
        # the tier on and the ring full, every ship evicts the ring's
        # lowest-priority-mass region to the host store, and the idle
        # refill tick recalls the heaviest cold segments through the
        # stager. The cold counters count transitions and are touched by
        # the ingest thread only; the closure evicted == stored +
        # dropped counts door outcomes (a displaced segment was stored
        # first: the store counts displacements apart)
        self._cold: ColdStore | None = None
        self._disk = None        # disk rung (replay/disk_store.py)
        self._cold_evicted = 0   # ingest thread only
        self._cold_stored = 0    # ingest thread only
        self._cold_dropped = 0   # ingest thread only
        self._cold_recalled = 0  # ingest thread only
        # the same door outcomes per dp shard (the dist swap runs per
        # shard, so evicted[d] == stored[d] + dropped[d] holds per shard)
        self._cold_evicted_per_shard = np.zeros(self.dp, np.int64)
        self._cold_stored_per_shard = np.zeros(self.dp, np.int64)
        self._cold_dropped_per_shard = np.zeros(self.dp, np.int64)
        # last-seen store counters for the delta-emitted obs counters
        self._cold_dropped_seen = 0
        self._cold_displaced_seen = 0
        self._disk_seen: dict = {}
        # the swap's pinned host buffers for the evicted region, one set
        # per card group (ingest thread only)
        self._region_host: dict[int, dict[str, torch.Tensor]] = {}
        cold_cap = cfg.replay.cold_tier_capacity
        if cold_cap > 0:
            if self.family != "dqn" or not getattr(
                    self.replay, "has_priorities", False):
                raise NotImplementedError(
                    "the cold tier needs prioritized flat/frame-ring "
                    "DQN replay (priority-mass eviction has no meaning "
                    "without a sum tree); set cold_tier_capacity=0 for "
                    f"family={self.family!r}, kind={cfg.replay.kind!r}")
            if self._stager is None:
                raise ValueError(
                    "the cold tier refills through the zero-copy ingest "
                    "stager — replay.ingest_zero_copy=False and "
                    "cold_tier_capacity > 0 are incompatible")
            if cfg.replay.cold_tier_disk_capacity > 0:
                from ape_x_dqn_tpu_torch.replay.disk_store import DiskStore
                self._disk = DiskStore(
                    cfg.replay.cold_tier_disk_dir,
                    cfg.replay.cold_tier_disk_capacity,
                    queue_depth=cfg.replay.cold_tier_disk_queue,
                    file_bytes=cfg.replay.cold_tier_disk_file_bytes,
                    compact_frac=cfg.replay.cold_tier_disk_compact_frac)
            self._cold = ColdStore(
                item_spec, cold_cap, unit_items=self._unit_items,
                ptail=ptail,
                compress_level=cfg.replay.cold_tier_compress_level,
                spill=self._disk)
        # the --profile-dir capture: one torch.profiler window over
        # profile_steps grad-steps from the first train dispatch
        self._profile = (ProfileWindow(cfg.profile_dir, cfg.profile_steps)
                         if cfg.profile_dir else None)
        # host mirror of the replay's write cursor (in leaves), for the
        # sample_age_steps histogram (ingest thread writes, learner
        # thread reads at the publish cadence: a heuristic view)
        ring = getattr(self.replay, "B", 1)
        self._age = self.obs.age_tracker(self.replay.capacity)
        self._age_block = self._stage_chunk * (ring if self._frame_mode
                                                else 1)
        self.last_eval: dict | None = None  # guarded-by: _lock
        # checkpoint/resume: params, targets, optimizer, RNG and step
        # always; the replay's contents too under cfg.checkpoint_replay
        self.ckpt = (CheckpointManager(cfg.checkpoint_dir)
                     if cfg.checkpoint_dir else None)
        self.checkpoint_saves = 0
        if self.ckpt is not None:
            self._maybe_restore()
        # the pacing cap counts the grad-steps of THIS run (a resumed run
        # goes on from its restored step, but its frames start at 0)
        self._paced_from = self._grad_steps_total

    # -- checkpoint / resume -----------------------------------------------

    def _ckpt_payload(self) -> tuple[dict, torch.cuda.Event | None]:
        """A copy of the train state, taken under the state lock so no
        add or train dispatch is enqueued meanwhile: the small tensors
        are cloned on the device (on the caller's stream, after every
        train dispatch and add enqueued so far on the learner's and the
        ingest stream, so a save at shutdown on the main thread's stream
        never reads a step mid-update) and reach the host on the
        manager's writer thread once the returned event has fired; the
        replay's contents, too large to clone on the card, are copied to
        the host here."""
        cuda = self.device.type == "cuda"
        with self._state_lock:
            if cuda:
                current = torch.cuda.current_stream(self.device)
                for stream in (self._learn_stream, self._ingest_stream):
                    if stream != current:
                        current.wait_stream(stream)
            tree = checkpoint_tree(self.state,
                                   self.cfg.checkpoint_replay)
            replay = tree.pop("replay", None)
            payload = tree_map(
                lambda x: x.detach().clone()
                if isinstance(x, torch.Tensor) else x, tree)
            if replay is not None:
                payload["replay"] = tree_map(
                    lambda x: x.to("cpu")
                    if isinstance(x, torch.Tensor) else x, replay)
            ready = None
            if cuda:
                ready = torch.cuda.Event()
                ready.record()
        return payload, ready

    def _save_checkpoint(self, wait: bool = False) -> None:
        with self.obs.span("ckpt.save", step=self._grad_steps_total):
            payload, ready = self._ckpt_payload()
            self.ckpt.save(self._grad_steps_total, payload, wait=wait,
                           ready=ready)
        self.checkpoint_saves += 1

    def _maybe_restore(self) -> None:
        """Restore the newest checkpoint IN PLACE. The captured graphs
        read the state's tensors at fixed addresses, so every value is
        copied into the tensor that holds it (load_state_dict and
        ``copy_``), never rebound; the replay's cursor and fill go
        through their setters, which refresh the device mirrors the
        graphs read. What is restored follows what the file holds, not
        the checkpoint_replay flag (the flag governs saves)."""
        if self.ckpt.latest_step() is None:
            return
        saved = self.ckpt.item_keys()
        with_replay = (("replay" in saved) if saved is not None
                       else self.cfg.checkpoint_replay)
        with self._state_lock:
            template = checkpoint_tree(self.state, with_replay)
            with self.obs.span("ckpt.restore"):
                restored = self.ckpt.restore(template=template)
            if restored is None:
                return
            restore_checkpoint_tree(self.state, restored)
        self._grad_steps_total = int(restored["step"])
        if "replay" in restored:
            # restored contents: the learner can train at once instead
            # of waiting for min_fill again
            with self._lock:
                self._replay_filled = int(np.sum(
                    restored["replay"]["size"]))
        self._publish_params()

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
        query = self.server.query_batch if vector else self.server.query
        if self._gate_actors:
            query = self._gated(query)
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
        """An actor's query that first waits while an EAGER learner
        dispatches (the CPU path, or `learner.capture` off; a learner
        that replays CUDA graphs needs no gate). The eager learner
        issues thousands of torch calls a macro-step, and each call
        drops and retakes the interpreter lock; beside actor threads
        that keep the lock busy, every retake waits its turn, and a
        train_many that takes ~0.07 s alone took ~5 s beside 8 vector
        actors on the card (PERF.md §6), holding _state_lock so long
        that ingest stalled and the transport dropped most of the
        experience. Actors therefore pause at their next query while
        the learner dispatches and run freely otherwise."""
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
                # the supervisor reads this actor's frame count when it
                # supersedes a wedged slot (remaining-budget estimate)
                with self._lock:
                    self._slot_actor_obj[i] = actor
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

    _FATAL_COMPONENTS = ("learner", "ingest", "inference-server", "eval")

    def _supervise_tick(self) -> None:
        """One supervisory pass over heartbeat staleness, replacing the
        bare check_stalled() raise in run()'s poll loop.

        Partition of stale components (actors.supervise):
        - local actor slots (actor-N): restart in place with the
          remaining frame budget, up to actors.supervisor_max_restarts
          per slot; past the budget the slot is QUARANTINED (heartbeat
          cleared, actor_quarantines counter, attributed JSONL event)
          and the run continues degraded — a restart storm must never
          become a crash loop.
        - remote peers (telemetry heartbeats): quarantined + counted
          (peer_stall_events) — the peer's own host supervises its
          workers; this learner just stops waiting on it.
        - fatal locals (learner / ingest / inference-server / eval):
          fall through to check_stalled(), which raises the attributed
          StallError — a driver cannot restart its own learner.

        With the remediation plane on (cfg.remediation.mode != "off"),
        the engine ticks its gauge rules here and gets first claim on
        stale actors/peers: in enforce mode a handled (applied) target
        skips the default path — the engine's actuator IS the default
        path's method, now cooldown-limited and attributed; any other
        outcome (observed / cooldown / failed) falls through to the
        pre-remediation behavior, so a wedged slot is never left for
        check_stalled() to escalate into a run-fatal StallError."""
        obs = self.obs
        eng = self.remediation
        if eng is not None:
            eng.tick(self._remediation_sensors(),
                     step=self._grad_steps_total)
        if obs.watchdog is None:
            return
        if not getattr(self.cfg.actors, "supervise", False):
            obs.check_stalled()
            return
        for name, staleness, _note in obs.heartbeats.stale(
                obs.watchdog.timeout_s):
            slot = name[len("actor-"):] if name.startswith("actor-") else ""
            if slot.isdigit():
                if eng is not None and eng.remediate_stale_actor(
                        int(slot), staleness,
                        step=self._grad_steps_total):
                    continue
                self._supervise_actor(int(slot), staleness)
            elif name not in self._FATAL_COMPONENTS:
                if eng is not None and eng.remediate_stale_peer(
                        name, staleness, step=self._grad_steps_total):
                    continue
                self._quarantine_peer(name, staleness)
        # anything still stale is a fatal local component
        obs.check_stalled()

    def _supervise_actor(self, i: int, staleness: float) -> None:
        """Restart or quarantine one wedged LOCAL actor slot."""
        with self._lock:
            if i in self._quarantined:
                already = True
            else:
                already = False
                used = self._slot_restarts.get(i, 0)
                exhausted = used >= self.cfg.actors.supervisor_max_restarts
                if exhausted:
                    self._quarantined.add(i)
                    # drop the wedged thread from liveness bookkeeping:
                    # a quarantined slot must not keep run()'s
                    # any(is_alive) drain check true forever, or the
                    # degraded-but-terminating contract becomes a hang
                    self._slot_threads.pop(i, None)
                    old_ev = self._slot_stops.pop(i, None)
                else:
                    self._slot_restarts[i] = used + 1
                    old_ev = self._slot_stops.get(i)
                actor = self._slot_actor_obj.pop(i, None)
                budget = self._slot_budget.get(i, 0)
                done_prior = self._slot_done.get(i, 0)
        if already:
            # a superseded thread un-wedged long enough to beat again:
            # re-clear so the fallthrough check_stalled() can't convert
            # a quarantine into a fatal StallError
            self.obs.clear(f"actor-{i}")
            return
        if old_ev is not None:
            old_ev.set()  # superseded generation exits if it un-wedges
        if exhausted:
            self.obs.clear(f"actor-{i}")
            self.obs.count("actor_quarantines")
            self.metrics.log(self._grad_steps_total, actor_quarantined=i,
                             stall_staleness_s=round(staleness, 1))
            # archive the victim's ring: a quarantine is a terminal
            # verdict for the slot, so the evidence goes to disk now
            self.obs.blackbox.record("quarantine", component=f"actor-{i}",
                                     staleness_s=round(staleness, 1))
            self.obs.blackbox.dump("quarantine", component=f"actor-{i}",
                                   step=self._grad_steps_total)
            logging.getLogger(__name__).warning(
                "[fleet] actor slot %d exhausted its supervised-restart "
                "budget (%d) — quarantined; the run continues without it",
                i, self.cfg.actors.supervisor_max_restarts)
            return
        # remaining = generation budget minus EVERY frame the slot
        # already produced this generation: crash-restart attempts that
        # ended before this supersession (_slot_done) plus the wedged
        # current attempt's count
        done = done_prior
        if actor is not None:
            try:
                done += int(actor.frames)
            except (TypeError, ValueError, AttributeError):
                pass
        remaining = max(budget - done, 0)
        self.obs.count("supervisor_restarts")
        with self._lock:
            self.actor_restarts.append(
                (i, f"supervised: stalled {staleness:.1f}s"))
        self.metrics.log(self._grad_steps_total, supervisor_restart=i,
                         stall_staleness_s=round(staleness, 1))
        # every restart decision archives the ring as it stood when the
        # slot wedged — the postmortem bundler's per-incident evidence
        self.obs.blackbox.record("supervisor_restart",
                                 component=f"actor-{i}",
                                 staleness_s=round(staleness, 1))
        self.obs.blackbox.dump("supervisor_restart",
                               component=f"actor-{i}",
                               step=self._grad_steps_total)
        # re-arm the heartbeat NOW so the check_stalled() fallthrough in
        # this very tick doesn't still see the slot as stale
        self.obs.beat(f"actor-{i}", "supervised restart")
        if remaining > 0:
            # fresh seed salt stream for the superseded generation's
            # successor (offset past crash-restart salts)
            self._spawn_actor_slot(i, remaining,
                                   attempt0=100 + self._slot_restarts[i])
        else:
            self.obs.clear(f"actor-{i}")

    def _quarantine_peer(self, name: str, staleness: float) -> None:
        """A REMOTE component's telemetry heartbeat went stale: count
        it, attribute it in the JSONL, and clear the heartbeat so it
        cannot wedge this driver's watchdog — the peer's own host owns
        its recovery (actor_host --supervise); if it reconnects, its
        next telemetry frame re-registers the heartbeat."""
        with self._lock:
            first = name not in self._peer_quarantined
            self._peer_quarantined.add(name)
        self.obs.clear(name)
        self.obs.count("peer_stall_events")
        self.metrics.log(self._grad_steps_total, peer_stall=name,
                         stall_staleness_s=round(staleness, 1))
        if first:
            # the remote died without a local ring: dump OURS, which
            # carries its last retained telemetry frame (context
            # provider above) — its black box of last resort
            self.obs.blackbox.record("peer_stall", peer=name.split("/")[0],
                                     component=name,
                                     staleness_s=round(staleness, 1))
            self.obs.blackbox.dump("peer_stall", component=name,
                                   step=self._grad_steps_total)
            logging.getLogger(__name__).warning(
                "[fleet] remote component %r silent for %.1fs — "
                "quarantined from the stall watchdog (its host owns "
                "recovery); ingest continues from the remaining fleet",
                name, staleness)

    # -- remediation actuators + sensors (runtime/remediation.py) ----------

    def _pause_actor_slot(self, i: int) -> bool:
        """Ingest-pressure autoscale actuator: park one RUNNING actor
        slot by setting its generation stop event — the thread exits
        cooperatively at its next stop check and clears its own
        heartbeat (it stays the slot's current generation, so the
        watchdog never sees a stale ghost). The remaining frame budget
        is banked in _slot_paused for resume. Returns False when the
        slot has nothing to pause (dead, quarantined, already paused)."""
        with self._lock:
            ev = self._slot_stops.get(i)
            t = self._slot_threads.get(i)
            if (ev is None or t is None or not t.is_alive()
                    or i in self._quarantined or i in self._slot_paused):
                return False
            actor = self._slot_actor_obj.get(i)
            budget = self._slot_budget.get(i, 0)
            done = self._slot_done.get(i, 0)
        if actor is not None:
            try:
                done += int(actor.frames)
            except (TypeError, ValueError, AttributeError):
                pass
        remaining = max(budget - done, 0)
        ev.set()
        with self._lock:
            self._slot_paused[i] = remaining
        logging.getLogger(__name__).warning(
            "[fleet] remediation paused actor slot %d under ingest "
            "pressure (%d frames banked)", i, remaining)
        return True

    def _resume_actor_slot(self, i: int) -> bool:
        """Resume a remediation-paused slot with its banked frame
        budget (fresh generation, salted seed stream)."""
        with self._lock:
            remaining = self._slot_paused.pop(i, None)
            restarts = self._slot_restarts.get(i, 0)
            if remaining is None or i in self._quarantined:
                return False
        if remaining <= 0:
            return False  # budget already produced; slot is finished
        self._spawn_actor_slot(i, remaining, attempt0=200 + restarts)
        return True

    def _remediation_backpressure(self, engaged: bool) -> bool:
        """Queue-SLO actuator: nudge the serving tier's backpressure
        flag (the same gauge and transport callback as the admission
        controller's own transitions; the controller keeps running and
        re-transitions if its depth-based hysteresis disagrees).
        Skipped (False) without a tier."""
        if self.serving is None:
            return False
        return self.serving.force_backpressure(engaged)  # apexlint: unaccounted(counted centrally in RemediationEngine._apply)

    def _remediation_set_priority(self, tenant: str, cls: int) -> bool:
        """Learn-health actuator: re-temper THIS driver's tenant
        priority class. Only the tenant whose TenantClient this driver
        owns is re-temperable: co-tenants' clients belong to their
        registrants."""
        if self.serving is None \
                or getattr(self.server, "policy_id", None) != tenant:
            return False
        hi = self.cfg.serving.priority_classes - 1
        self.server.priority = min(max(int(cls), 0), hi)
        return True

    def _remediation_sensors(self) -> dict:
        """Fresh gauge-sensor snapshot for the engine's tick: the
        serving queue's depth against its SLO and the backpressure flag
        (with the tier on), ingest drop pressure (delta since the last
        tick) and the local slot population (supervisor-tick thread
        only — the delta bookkeeping needs no lock)."""
        s: dict = {}
        if self.serving is not None:
            s["queue_depth"] = self.serving.queue_depth
            s["queue_slo"] = self.cfg.serving.queue_slo_items
            s["backpressure"] = self.serving.backpressure_engaged
        with self._lock:
            running = [i for i, t in self._slot_threads.items()
                       if t.is_alive() and i not in self._quarantined
                       and i not in self._slot_paused]
            paused = list(self._slot_paused)
        dropped = (int(getattr(self.transport, "dropped", 0))
                   + self._stage_dropped)
        s["ingest_dropped_delta"] = dropped - self._remed_dropped_seen
        self._remed_dropped_seen = dropped
        s["running_slots"] = running
        s["paused_slots"] = paused
        return s

    def _pacing_binds(self, frames: int) -> bool:
        """learner.steps_per_frame_cap: this run's grad-steps have
        reached the cap's share of this run's frames."""
        cap = self.cfg.learner.steps_per_frame_cap
        return (cap is not None
                and self._grad_steps_total - self._paced_from >= cap * frames)

    def _min_fill(self) -> int:
        return min(self.cfg.replay.min_fill, self.capacity // 2)

    # -- ingest ------------------------------------------------------------

    def _on_stream(self, stream):
        """The calling thread's work goes to `stream` (CUDA), and the
        stream is drained when the thread leaves."""
        if stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.callback(stream.synchronize)
        stack.enter_context(torch.cuda.stream(stream))
        return stack

    def _ingest_loop(self) -> None:
        try:
            with self._on_stream(self._ingest_stream):
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
                    if self._stager is not None:
                        self._stager.drain()
                    # idle bandwidth goes to cold recalls: high-mass
                    # cold segments restage through the same stager
                    self._cold_refill_tick()
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
        actor = batch.get("actor")
        # cross-process correlation (obs/fleet.StampingTransport): a
        # stamped batch's staging gets its own span sharing the origin's
        # batch_id, and the tag rides the stager into the replay.add
        # that carries it
        bid = batch.get("batch_id")
        if bid is None:
            self._stage_one(batch, n)
        else:
            peer = str(batch.get("peer", ""))
            with self.obs.span("ingest.batch", batch_id=int(bid),
                               peer=peer, rows=n):
                self._stage_one(batch, n, tag=(peer, int(bid)))
        # wire codec accounting: a WireBatch knows its wire and decoded
        # sizes; dict batches came in locally
        wire = getattr(batch, "wire_nbytes", 0)
        if wire:
            self.obs.gauge("wire_compression_ratio",
                           batch.raw_nbytes / wire)
        self.frames.add(frames)
        if actor is not None:
            by_actor = self._frames_by_actor
            by_actor[int(actor)] = by_actor.get(int(actor), 0) + frames
        with self._lock:
            self._frames_total += frames
            self._ingested_batches += 1
        if self.obs.enabled:
            self._emit_shm_gauges()
            self._emit_param_gauges()

    def _emit_shm_gauges(self) -> None:
        """Shared-memory transport instruments (ingest thread only —
        the delta bookkeeping needs no lock). Counters delta-emit so
        report --check sees torn slots / TCP fallbacks the moment they
        start; the inflight gauge is the ring-lease population."""
        tp = self.transport
        if not getattr(tp, "shm_rings", None) and \
                not getattr(tp, "shm_doorbells", 0):
            return
        if not hasattr(self, "_shm_seen"):
            self._shm_seen = {"shm_doorbells": 0, "shm_torn_slots": 0,
                              "shm_fallbacks": 0}
        # literal metric names, one per INSTRUMENTS row of obs/report.py
        d = int(tp.shm_doorbells) - self._shm_seen["shm_doorbells"]
        if d:
            self.obs.count("shm_doorbells", d)
            self._shm_seen["shm_doorbells"] += d
        d = int(tp.shm_torn_slots) - self._shm_seen["shm_torn_slots"]
        if d:
            self.obs.count("shm_torn_slots", d)
            self._shm_seen["shm_torn_slots"] += d
        d = int(tp.shm_fallbacks) - self._shm_seen["shm_fallbacks"]
        if d:
            self.obs.count("shm_fallbacks", d)
            self._shm_seen["shm_fallbacks"] += d
        self.obs.gauge("shm_slots_inflight",
                       float(tp.shm_slots_inflight))

    def _emit_param_gauges(self) -> None:
        """Param-plane codec instruments (ingest thread only — same
        delta-bookkeeping discipline as _emit_shm_gauges). The ratio
        gauge carries the never-inflate floor: report --check flags any
        sample below 1.0, which a correct encoder can never produce."""
        tp = self.transport
        if not getattr(tp, "param_pushes", 0) and \
                not getattr(tp, "param_bytes_out", 0):
            return
        if not hasattr(self, "_param_seen"):
            self._param_seen = {"param_bytes_out": 0, "param_resyncs": 0,
                                "param_push_queue_drops": 0}
        # literal metric names, one per INSTRUMENTS row of obs/report.py
        d = int(tp.param_bytes_out) - self._param_seen["param_bytes_out"]
        if d:
            self.obs.count("param_bytes_out", d)
            self._param_seen["param_bytes_out"] += d
        d = int(tp.param_resyncs) - self._param_seen["param_resyncs"]
        if d:
            self.obs.count("param_resyncs", d)
            self._param_seen["param_resyncs"] += d
        drops = sum(tp.param_push_queue_drops.values())
        d = drops - self._param_seen["param_push_queue_drops"]
        if d:
            self.obs.count("param_push_queue_drops", d)
            self._param_seen["param_push_queue_drops"] += d
        ratio = float(tp.param_compression_ratio)
        if ratio > 0.0:
            self.obs.gauge("param_compression_ratio", ratio)

    def _wire_summary(self) -> dict | None:
        """The socket transport's accounting for the run summary: bytes
        in (on the wire and decoded), param bytes out (and what they
        would have cost uncoded), pushes, resyncs and the shared-memory
        plane. None for the in-process transport."""
        tp = self.transport
        if not hasattr(tp, "active_connections"):
            return None
        keys = ("bytes_in", "raw_bytes_in", "wire_compression_ratio",
                "param_bytes_out", "param_raw_bytes_out",
                "param_compression_ratio", "param_pushes", "param_resyncs",
                "param_push_queue_drops", "shm_doorbells", "shm_bytes_in",
                "shm_torn_slots", "shm_fallbacks", "shm_reclaimed",
                "shm_dropped", "telemetry_frames", "wire_decode_errors",
                "ever_connected")
        return {k: getattr(tp, k) for k in keys}

    def _stage_one(self, batch: dict, n: int, tag=None) -> None:
        if self._stager is None:
            rel = getattr(batch, "release", None)
            if rel is not None:
                # a shm slot batch on the legacy path: the deferred
                # concatenate would pin the ring slot while it waits in
                # _stage, so copy the rows now and free the slot
                batch = {k: np.asarray(batch[k]).copy()
                         for k in self._item_keys + ("priorities",)}
                rel()
            self._stage.append(batch)
            self._stage_n += n
            self._flush_stage()
            return
        self._stager.put(batch, tag=tag)
        # below min_fill the learner waits on replay: ship complete
        # blocks at once instead of letting coalescing delay the first
        # train dispatch by up to a full buffer
        if self._replay_filled < self._min_fill():
            self._stager.drain()
        self.obs.gauge("ingest_staging_occupancy", self._stager.occupancy())
        self.obs.gauge("ingest_decode_ms", self._stager.last_put_decode_ms)
        self.obs.gauge("ingest_ship_ms", self._stager.last_ship_ms)

    def _shard_lead(self, g: int) -> tuple:
        """The leading axes of g staged blocks: (g,) when g > 1, then
        (dp,) on the mesh, then the chunk."""
        lead = (g,) if g > 1 else ()
        if self.is_dist:
            lead += (self.dp,)
        return lead + (self._stage_chunk,)

    def _ship_staged(self, views: dict, g: int) -> list:
        """Ship g coalesced staged blocks (the IngestStager callback):
        one asynchronous host-to-device copy per leaf straight out of
        the pinned staging memory (into the add graph's static inputs
        on the card), a CUDA event recorded after them, then ONE add
        under _state_lock: on the card one replay of the captured graph
        of this (replay, g) (runtime/step_graph.py: AddGraph), else the
        add body, eagerly. -> the event (none on the CPU), which the
        stager synchronises on before it rewrites the memory."""
        count = g * self.dp * self._stage_chunk
        if self._cold is not None and self._replay_filled >= self.capacity:
            # ring full + tier on: every ship becomes an eviction swap
            return self._ship_staged_cold(views, g)
        staged = self.learner.land_add(g, views, self._shard_lead(g))
        handles = []
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            handles.append(ev)
        with self._state_lock:
            if self._learn_done is not None:
                # the add writes what the last train dispatch reads
                self._ingest_stream.wait_event(self._learn_done)
            with self.obs.stage_window("ingest", count,
                                       stream=self._ingest_stream):
                with self.obs.span("replay.add", **self._add_span_args(
                        count)):
                    self.state = self.learner.add_landed(self.state, g,
                                                         staged)
        if self._age is not None:
            for _ in range(g):
                self._age.on_add(self._age_block, self._grad_steps_total)
        self.ingest_rows.add(count * self._unit_items)
        with self._lock:
            self._replay_filled = min(
                self._replay_filled + count * self._unit_items,
                self.capacity)
        self.obs.gauge("ingest_coalesce_width", g)
        return handles

    def _ship_staged_cold(self, views: dict, g: int) -> list:
        """Eviction-swap ship (cold tier on, ring full), block by block:
        each block's eviction plan must see the tree the previous swap
        left. Per block, under _state_lock on the ingest stream: the
        evict graph picks the ring's lowest-priority-mass region and
        reads it in staging layout (`learner.evict_landed`), the region
        and its start are copied to pinned host buffers and waited for
        (the barrier that keeps the reads ahead of the overwrite), and
        the add_at graph overwrites exactly that region with the block,
        reading the start on the device. Outside the lock the region
        goes through the ColdStore's door. On the mesh each shard plans,
        reads and overwrites its own region ([dp] starts), and each
        shard's region goes through the door as its own segment, so the
        closure holds per shard; over several cards each card group does
        so on its owner, on the learner's streams there (`on_cards`).
        -> the event of the last host-to-device copy (none on the
        CPU)."""
        chunk = self._stage_chunk
        units = chunk * self.dp
        lead = self._shard_lead(1)
        handles = []
        for j in range(g):
            block = {k: v[j * units:(j + 1) * units]
                     for k, v in views.items()}
            inputs = self.learner.land_add_at(block, lead)
            with self._state_lock:
                if self._learn_done is not None:
                    # the swap writes what the last train dispatch reads
                    self._ingest_stream.wait_event(self._learn_done)
                with self.obs.span("replay.evict", units=units), (
                        self.learner.on_cards() if self.cards
                        else contextlib.nullcontext()):
                    evicted = self.learner.evict_landed(self.state, chunk)
                    region = self._fetch_region(evicted)
                    start = ([e[0] for e in evicted] if self.cards
                             else evicted[0])
                    self.state = self.learner.add_at_landed(
                        self.state, inputs, start, region.pop("start"))
            ev_pri = region.pop("priorities")
            shards = ([({k: v[d] for k, v in region.items()}, ev_pri[d])
                       for d in range(self.dp)] if self.is_dist
                      else [(region, ev_pri)])
            for d, (seg, pri) in enumerate(shards):
                live = int((pri > 0).sum())
                self._cold_evicted += live
                self._cold_evicted_per_shard[d] += live
                if self._cold.put(seg, pri, live) == "stored":
                    self._cold_stored += live
                    self._cold_stored_per_shard[d] += live
                else:
                    self._cold_dropped += live
                    self._cold_dropped_per_shard[d] += live
                self.obs.count("cold_evictions")
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            handles.append(ev)
        self.ingest_rows.add(g * chunk * self.dp * self._unit_items)
        # _replay_filled stays at capacity: eviction swaps slots 1:1
        self.obs.gauge("ingest_coalesce_width", g)
        self._emit_cold_gauges()
        return handles

    def _fetch_region(self, evicted) -> dict:
        """The evicted region on the host ({item keys, "priorities",
        "start"} as numpy, [dp, ...] in row order on the mesh) from
        `evicted`, the evict result (start, items, priorities), or one
        per card group over several cards. On CUDA one non-blocking
        copy per leaf into pinned buffers kept for the swap, one set per
        group, on its owner's current stream (the ingest stream, or the
        learner's stream forked from it there); every owner's copies
        are enqueued before the first wait, then one event per owner
        is waited for, so every read has landed before the directed
        adds are enqueued and before the next swap rewrites the
        buffers."""
        parts = evicted if self.cards else [evicted]
        hosts, done = [], []
        for i, (start, items, pri) in enumerate(parts):
            leaves = dict(items, priorities=pri, start=start)
            if start.device.type != "cuda":
                hosts.append({k: v.numpy() for k, v in leaves.items()})
                continue
            bufs = self._region_host.setdefault(i, {})
            for k, v in leaves.items():
                buf = bufs.get(k)
                if buf is None:
                    buf = bufs[k] = torch.empty(
                        v.shape, dtype=v.dtype, pin_memory=True)
                buf.copy_(v, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(start.device))
            done.append(ev)
            hosts.append({k: bufs[k].numpy() for k in leaves})
        for ev in done:
            ev.synchronize()
        if not self.cards:
            return hosts[0]
        out = {}
        for k, first in hosts[0].items():
            whole = np.empty((self.dp, *first.shape[1:]), first.dtype)
            for host, group in zip(hosts, self.learner.groups):
                whole[list(group.rows)] = host[k]
            out[k] = whole
        return out

    def _cold_refill_tick(self) -> None:
        """Idle-time recall (ingest thread, queue dry): pop up to
        cold_tier_refill of the highest-priority-mass cold segments,
        invert their stored leaf values back to |td| (the add re-applies
        (|td|+eps)^alpha), and restage them through the stager, so
        recalled data rides the one-copy staging->add path of fresh
        actor experience. Then promote the heaviest disk segments back
        through the RAM door."""
        if self._cold is None:
            return
        # bound the burst by what the active staging buffer absorbs
        # without shipping: a recalled or promoted segment is at most one
        # stage_chunk of units (the eviction block)
        room = self._stager.free_units() // max(1, self._stage_chunk)
        k = min(self.cfg.replay.cold_tier_refill, room)
        did = False
        if k > 0 and len(self._cold):
            alpha, eps = self.replay.alpha, self.replay.eps
            for batch in self._cold.recall(k):
                pri = np.asarray(batch["priorities"], np.float32)
                td = np.maximum(pri ** (1.0 / alpha) - eps, 0.0) \
                    .astype(np.float32)
                self._stager.put(dict(batch, priorities=td))
                self._cold_recalled += int((pri > 0).sum())
                self.obs.count("cold_recalls")
            did = True
        # disk promotions AFTER recalls: the heaviest disk segments
        # climb back through the RAM door (put_segment; its displaced
        # victims spill back down), gated on the door's current floor
        # so a promotion never bounces
        if self._disk is not None:
            kd = self.cfg.replay.cold_tier_disk_promote
            if kd > 0:
                floor = self._cold.displacement_floor()
                for seg in self._disk.promote(kd, floor):
                    self._cold.put_segment(seg)
                    did = True
        if did:
            self._emit_cold_gauges()

    def _emit_cold_gauges(self) -> None:
        cold = self._cold
        self.obs.gauge("cold_segments", float(len(cold)))
        self.obs.gauge("cold_bytes", float(cold.bytes_compressed))
        self.obs.gauge("cold_compression_ratio",
                       cold.compression_ratio())
        # door outcomes as delta-emitted counters: report --check warns
        # when drops outrun displacements (store thrashing, the signal
        # the disk rung exists to absorb)
        d = cold.dropped - self._cold_dropped_seen
        if d:
            self.obs.count("cold_dropped", d)
            self._cold_dropped_seen = cold.dropped
        d = cold.displaced - self._cold_displaced_seen
        if d:
            self.obs.count("cold_displaced", d)
            self._cold_displaced_seen = cold.displaced
        if self._disk is None:
            return
        s = self._disk.stats()
        self.obs.gauge("cold_disk_segments", float(s["segments"]))
        self.obs.gauge("cold_disk_transitions", float(s["transitions"]))
        self.obs.gauge("cold_disk_bytes", float(s["bytes"]))

        def delta(key: str) -> int:
            d = s[key] - self._disk_seen.get(key, 0)
            if d:
                self._disk_seen[key] = s[key]
            return d

        # literal metric names (not a name loop), one per INSTRUMENTS
        # row of obs/report.py
        d = delta("spilled")
        if d:
            self.obs.count("cold_disk_spills", d)
        d = delta("promoted")
        if d:
            self.obs.count("cold_disk_promotions", d)
        d = delta("queue_full")
        if d:
            self.obs.count("cold_disk_queue_full", d)
        d = delta("io_errors")
        if d:
            self.obs.count("cold_disk_errors", d)

    def _cold_summary(self) -> dict:
        """The run summary's cold_tier block: the transition-denominated
        door closure evicted == stored + dropped (per shard too), the
        store's state, the swap graphs' replays (by card over several)
        and the disk rung's stats."""
        cold = self._cold
        out = {
            "evicted": self._cold_evicted,
            "stored": self._cold_stored,
            "dropped": self._cold_dropped,
            "recalled": self._cold_recalled,
            "displaced_segments": cold.displaced,
            "segments": len(cold),
            "transitions": cold.transitions,
            "bytes": cold.bytes_compressed,
            "compression_ratio": cold.compression_ratio(),
            "evicted_per_shard": self._cold_evicted_per_shard.tolist(),
            "stored_per_shard": self._cold_stored_per_shard.tolist(),
            "dropped_per_shard": self._cold_dropped_per_shard.tolist(),
            "swap_graph_replays": {
                k: g.replays
                for k, g in sorted(self.learner.swap_graphs().items())},
        }
        if self.cards:
            out["swap_graph_replays_by_card"] = {
                card: {k: g.replays for k, g in sorted(graphs.items())}
                for card, graphs in
                self.learner.swap_graphs_by_card().items()}
        if self._disk is not None:
            out["disk"] = self._disk.stats()
        return out

    def _add_span_args(self, count: int) -> dict:
        """The replay.add span's args: the units, and the origin
        batch_ids staged into this add (truncated: attribution, not an
        exhaustive ledger)."""
        args: dict = {"units": count}
        tags = self._stager.shipping_tags if self._stager is not None \
            else ()
        if tags:
            args["batch_ids"] = [t[1] for t in tags[:MAX_SPAN_IDS]]
        return args

    def _add_block(self, take: dict, count: int) -> None:
        """The legacy path's add of one block of `count` staging units
        ({key: [count, ...]} numpy, with "priorities"): [dp, chunk, ...]
        on the mesh, through the learner's eager `add` under the state
        lock, on the ingest stream after the last train dispatch. Over
        several cards the block stays on the host and each card group's
        rows go straight to its owner (`CardsLearner.add`)."""
        def put(v):
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.is_dist:
                t = t.reshape(self.dp, self._stage_chunk, *t.shape[1:])
            return t if self.cards else t.to(self.device)

        items = {k: put(v) for k, v in take.items() if k != "priorities"}
        pris = put(take["priorities"])
        with self._state_lock:
            if self._learn_done is not None:
                self._ingest_stream.wait_event(self._learn_done)
            with self.obs.span("replay.add", units=count):
                self.state = self.learner.add(self.state, items, pris)
        self.ingest_rows.add(count * self._unit_items)
        with self._lock:
            self._replay_filled = min(
                self._replay_filled + count * self._unit_items,
                self.capacity)

    def _flush_stage(self, force: bool = False) -> None:
        """Ship the complete staged blocks ([dp, chunk] on the mesh:
        consecutive chunks go round-robin to the shards, keeping their
        priority masses balanced); at force-flush the sub-block
        tail is DROPPED and counted in transitions: live transitions
        (next_off > 0) in frame-ring mode and seq_length per sequence
        for r2d2 (an upper bound: overlapping sequences share steps),
        where env frames ride the ingest messages separately and stay
        counted; units in flat mode, where one unit is one env frame and
        the frame count comes off with it. The same accounting on both
        staging paths."""
        if self._stager is None:
            self._flush_legacy(force)
            return
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

    def _flush_legacy(self, force: bool) -> None:
        """`_flush_stage` on the legacy path: concatenate the staged
        batches, ship every whole block through `_add_block`, keep the
        rest; at force-flush drop and count the tail."""
        block = self.dp * self._stage_chunk
        while self._stage_n >= block:
            fields = {
                k: np.concatenate([np.asarray(b[k]) for b in self._stage])
                for k in self._item_keys + ("priorities",)}
            take = {k: v[:block] for k, v in fields.items()}
            rest = {k: v[block:] for k, v in fields.items()}
            self._stage = [rest] if rest["priorities"].shape[0] else []
            self._stage_n -= block
            self._add_block(take, block)
        if not (force and self._stage_n):
            return
        if self._frame_mode:
            live = np.concatenate(
                [(np.asarray(b["next_off"]) > 0).sum(axis=-1)
                 for b in self._stage])
            per_shard = self._tail_shard_counts(live)
        elif self.family == "r2d2":
            per_shard = self._tail_shard_counts(np.full(
                self._stage_n, self.cfg.replay.seq_length, np.int64))
        else:
            per_shard = self._tail_shard_counts(
                np.ones(self._stage_n, np.int64))
            with self._lock:
                self._frames_total -= self._stage_n
        self._stage_dropped += int(per_shard.sum())
        self._stage_dropped_per_shard += per_shard
        self._stage = []
        self._stage_n = 0

    def _tail_shard_counts(self, per_unit) -> np.ndarray:
        """Fold unit-indexed drop counts into per-shard totals: staged
        unit i of a would-be [dp, stage_chunk] block belongs to shard
        i // stage_chunk, the round-robin split the ship reshapes into.
        The tail is shorter than one block, so the index never
        overflows dp."""
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
        eval) never queries its own server and skips it. With the
        stage costs wanted (obs on), the cost counters' first use runs
        here too: it imports torch modules for seconds, which inside the
        first add or train dispatch silenced that thread's heartbeat past
        the stall watchdog's timeout on a loaded host."""
        if profiling.costs_wanted():
            profiling.count_cost(lambda: torch.zeros(1) + 1)
        if (self.cfg.actors.num_actors > 0 or self.cfg.eval_every_steps > 0
                or self.cfg.eval_episodes > 0):
            self.server.warmup(
                warmup_example(self.family, self.cfg, self.spec),
                extra_sizes=(self.cfg.actors.envs_per_actor,))

    def _learner_loop(self, max_grad_steps: int) -> None:
        self.obs.register("learner")
        try:
            with self._on_stream(self._learn_stream):
                self._learner_loop_inner(max_grad_steps)
        except Exception as e:
            with self._lock:
                self.loop_errors.append(("learner", e))
        finally:
            self.obs.clear("learner")
            # a run that ends inside the profile window still writes its
            # trace (and frees the process-wide profiler for a later run)
            if self._profile is not None:
                self._profile.close()

    def _transport_params(self, pub: dict) -> dict:
        """What the transport publishes: `pub` itself in process; for a
        transport serving remote hosts a plain dict of numpy arrays, the
        one device-to-host copy of a publication (never a pickled torch
        tensor, which would make every receiver need this torch build
        and a card). On CUDA the copies go into pinned buffers, enqueued
        on the caller's stream after the clone that made `pub`, and the
        caller waits for that stream alone (not the device)."""
        if not self._host_params:
            return pub
        if self.device.type != "cuda":
            return {k: v.detach().cpu().numpy().copy()
                    for k, v in pub.items()}
        for k, v in pub.items():
            buf = self._pinned.get(k)
            if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
                self._pinned[k] = torch.empty(v.shape, dtype=v.dtype,
                                              pin_memory=True)
            self._pinned[k].copy_(v, non_blocking=True)
        with self.obs.span("learner.publish_wait"):
            torch.cuda.current_stream(self.device).synchronize()
        # fresh arrays: the transport keeps them after the pinned
        # buffers are rewritten by the next publication
        return {k: self._pinned[k].numpy().copy() for k in pub}

    def _publish_params(self) -> None:
        """The whole publication under one span: the device copy, the
        host copy and the wait for the learner's stream, which drains
        the dispatches in flight (its own span, `learner.publish_wait`)."""
        with self.obs.span("learner.publish_params"):
            # copy under the state lock: an add or a train dispatch would
            # otherwise write the tensors being copied
            with self._state_lock:
                pub = self.learner.publish_params(self.state)
            # the host copy (remote hosts) waits for the caller's stream,
            # the learner's on its thread, which the server needs anyway:
            # it reads `pub` on its own stream
            host = self._transport_params(pub)
            if self._learn_stream is not None and not self._host_params:
                with self.obs.span("learner.publish_wait"):
                    self._learn_stream.synchronize()
        self.server.update_params(pub, self._grad_steps_total)
        self.transport.publish_params(host, self._grad_steps_total)

    def _learner_loop_inner(self, max_grad_steps: int) -> None:
        publish_every = self.cfg.learner.publish_every
        # a chunk larger than the publish cadence would snap to 1 forever
        chunk = max(min(self.cfg.learner.train_chunk, publish_every), 1)
        last_log = 0
        last_ckpt = self._grad_steps_total
        m = None
        while (not self.stop_event.is_set()
               and self._grad_steps_total < max_grad_steps):
            self.obs.beat("learner")
            with self._lock:
                filled = self._replay_filled
                frames = self._frames_total
            if filled < self._min_fill():
                time.sleep(0.05)
                continue
            if self._pacing_binds(frames):
                time.sleep(0.01)  # pacing: let actors catch up
                continue
            if (self._profile is not None
                    and self._profile.step(self._grad_steps_total)):
                self.metrics.log(self._grad_steps_total,
                                 profile_trace=self.cfg.profile_dir)
            self.obs.maybe_profile(self._grad_steps_total)
            # up to `chunk` grad-steps per dispatch without overshooting
            # the step target; publication fires on boundary CROSSINGS
            # (a chunk need not divide publish_every)
            done = self._grad_steps_total
            k = chunk if chunk <= max_grad_steps - done else 1
            while len(self._in_flight) >= 2:
                self._in_flight.popleft().synchronize()
            if self._gate_actors:
                self._actors_may_run.clear()  # learner priority (_gated)
            try:
                with self._state_lock:
                    if self._learn_stream is not None:
                        # after the adds ingest has enqueued so far
                        self._learn_stream.wait_stream(self._ingest_stream)
                    with self.obs.stage_window(self._train_stage, k,
                                               stream=self._learn_stream):
                        with self.obs.span("learner.train", k=k):
                            if k > 1:
                                self.state, m = self.learner.train_many(
                                    self.state, k)
                            else:
                                self.state, m = self.learner.train_step(
                                    self.state)
                    if self._learn_stream is not None:
                        self._learn_done = torch.cuda.Event()
                        self._learn_done.record(self._learn_stream)
                        self._in_flight.append(self._learn_done)
            finally:
                self._actors_may_run.set()
            self._grad_steps_total += k
            self.grad_steps.add(k)
            self.obs.set_learner_step(self._grad_steps_total)
            if done // publish_every != self._grad_steps_total // publish_every:
                self._publish_params()
            if (self.ckpt is not None and self._grad_steps_total - last_ckpt
                    >= self.cfg.checkpoint_every):
                self._save_checkpoint()
                last_ckpt = self._grad_steps_total
            if self._grad_steps_total - last_log >= 100:
                last_log = self._grad_steps_total
                self._log_boundary(m)
        # a run that ends between log boundaries still logs (and, with
        # obs on, publishes) its last dispatch's metrics once
        if m is not None and self._grad_steps_total > last_log:
            self._log_boundary(m)

    def _mesh_summary(self) -> dict:
        """The mesh over several cards: its layout, the exchange's calls
        and bytes, the graphs a call of each train endpoint replays, the
        gather launches by card and each card's peak memory (CUDA's
        allocator; null on the CPU) against its budget."""
        cuda = self.device.type == "cuda"
        cards = {}
        for dev, budget in self.hbm_budgets.items():
            cards[str(dev)] = {
                "budget_bytes": budget.total,
                "peak_allocated_bytes": (torch.cuda.max_memory_allocated(dev)
                                         if cuda else None),
                "gather_launches": fg.gather_rows.by_device.get(str(dev), 0)}
        return {**self.learner.layout(),
                "exchange": self.learner.exchange.stats(),
                "step_graphs": {
                    (k if isinstance(k, str) else f"{k[0]}{k[1]}"): g.graphs
                    for k, g in self.learner.step_graphs().items()},
                "per_card": cards}

    def _log_boundary(self, m: dict) -> None:
        """The learner's log record and the observability publication,
        with ONE fetch of the logged metrics (and, with obs on, the
        learning diagnostics): every 100 grad-steps, and once at the
        end of the loop."""
        diag = m.get("diag", {}) if self.obs.enabled else {}
        loss, q_mean, td, *dvals = torch.stack(
            [m["loss"].float(), m["q_mean"].float(),
             m["td_abs_mean"].float()]
            + [v.float() for v in diag.values()]).tolist()
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
        if diag:
            diag = dict(zip(diag, dvals))
            self.obs.learn_health(diag, loss, step=self._grad_steps_total,
                                  tenant=self.cfg.env.id)
            self._observe_sample_ages(diag)
        if self.is_dist:
            # lockstep ingest fills every shard alike, so the bounds come
            # from the host fill mirror (no device read in the loop); the
            # summary's replay_shards reads the shards themselves
            fill = replay_size / max(self.capacity, 1)
            profiling.publish_multichip(self.obs, fill_min=fill,
                                        fill_max=fill)
        self._attach_stage_costs()
        self.obs.perf_rate("grad_steps_per_s", self.grad_steps.rate(),
                           step=self._grad_steps_total)
        self.obs.perf_rate("env_fps", self.frames.rate(),
                           step=self._grad_steps_total)
        self.obs.perf_rate("ingest_rows_per_s", self.ingest_rows.rate(),
                           step=self._grad_steps_total)
        self.obs.publish(self._grad_steps_total)

    def _observe_sample_ages(self, diag: dict) -> None:
        """sample_age_steps from the learner's in-graph sample-age order
        statistics (ring distances from the write cursor, in leaves),
        mapped to grad-steps through the host mirror of the cursor: the
        age in grad-steps of the p50 and p90 transitions of the last
        draw. Approximate: adds in flight move the cursor meanwhile."""
        if self._age is None or "sample_age_p50" not in diag:
            return
        self.obs.observe_sample_ages(self._age.ages_at_distances(
            [diag["sample_age_p50"], diag["sample_age_p90"]],
            self._grad_steps_total))

    def _attach_stage_costs(self) -> None:
        """Give the profiler the analytic roofs of the train and ingest
        stages once the graphs' warm-ups have counted them
        (runtime/step_graph.py): per grad-step from the step graph that
        covers the most steps, per staged unit from the one-block add."""
        if not self.obs.stage_attached(self._train_stage):
            graphs = [g for g in self.learner.step_graphs().values()
                      if g.cost is not None]
            if graphs:
                g = max(graphs, key=lambda g: g.steps)
                self.obs.stage_attach(self._train_stage, g.steps,
                                      cost=g.cost)
        if not self.obs.stage_attached("ingest"):
            add = self.learner.add_graphs().get(1)
            if add is not None and add.cost is not None:
                self.obs.stage_attach("ingest", self.dp * self._stage_chunk,
                                      cost=add.cost)

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
        if self.device.type == "cuda":
            # the state was made on the default stream; the learner and
            # ingest streams do not wait for it on their own
            for dev in (self.mesh.cards if self.cards else [self.device]):
                torch.cuda.synchronize(dev)
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
        saw_remote = False
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
                # remote actor hosts (socket transport): the learner
                # outlives its local actors while hosts are connected,
                # still booting (the boot grace of a remote-only
                # learner) or only just gone (quiesced()'s debounce).
                # The grace ends only once a host has SENT EXPERIENCE
                # (ever_connected): a param-only probe must not end it
                if hasattr(self.transport, "active_connections"):
                    if self.transport.ever_connected:
                        saw_remote = True
                    booting = (not saw_remote
                               and self.cfg.actors.num_actors == 0
                               and time.monotonic() - t0
                               < self.cfg.actors.remote_boot_grace_s)
                    if booting or not self.transport.quiesced():
                        time.sleep(0.2)
                        continue
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
                        stuck = (size < self._min_fill()
                                 or self._pacing_binds(frames))
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
            # final checkpoint, so a stopped run resumes where it ended;
            # a write that fails is an error of the run
            if self.ckpt is not None and self._grad_steps_total > 0:
                try:
                    self._save_checkpoint(wait=True)
                except Exception as e:
                    self.loop_errors.append(("checkpoint", e))
            self.server.stop()
            if self._disk is not None:
                # let queued spills land before the thread stops; a hard
                # kill here is what the recovery scan is for, so failures
                # are logged, never raised
                try:
                    self._disk.drain(timeout=5.0)
                except TimeoutError as e:
                    # queued spills that never landed are lost segments
                    self.obs.count("cold_disk_errors")
                    self.loop_errors.append(("disk_drain", e))
                self._disk.close()
            self.obs.close(self._grad_steps_total)
        with self._lock:
            avg_ret = (float(np.mean(self.episode_returns))
                       if self.episode_returns else 0.0)
        alive = [t.name for t in (learner, ingest, *self._actor_threads())
                 if t.is_alive()]
        if alive:
            logging.getLogger(__name__).warning(
                "threads still running after teardown: %s", alive)
        out = {
            "frames": self._frames_total,
            "frames_by_actor": dict(sorted(self._frames_by_actor.items())),
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
            "checkpoint_saves": self.checkpoint_saves,
            "add_graph_replays": {g: a.replays for g, a in sorted(
                self.learner.add_graphs().items())},
        }
        if self.remediation is not None:
            out["remediation"] = self.remediation.summary()
        if self.serving is not None:
            # the tier's totals and this driver's tenant under the names
            # of its serve/<id>/ gauges
            pid = self.server.policy_id
            mine = {("queue_depth" if k == "pending" else k): v
                    for k, v in self.server.stats.items()}
            out["serving"] = dict(self.serving.stats, **{
                f"serve/{pid}/{k}": v for k, v in mine.items()})
        if self._cold is not None:
            out["cold_tier"] = self._cold_summary()
        if self.is_dist:
            # the per-shard fill and mass, read from the shards at
            # teardown (every loop has joined)
            out["replay_shards"] = self.learner.shard_stats(self.state)
        if self.cards:
            out["mesh"] = self._mesh_summary()
        wire = self._wire_summary()
        if wire is not None:
            out["wire"] = wire
        return out
