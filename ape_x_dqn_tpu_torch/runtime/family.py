"""Model-family dispatch for the driver.

Counterpart of ``ape_x_dqn_tpu/runtime/family.py``. A RunConfig's
network kind selects a runtime family: flat-DQN ("dqn"), recurrent R2D2
("r2d2") or continuous Ape-X DPG ("dpg"). They differ in the inference
server's protocol, the actor class and the warm-up example, and the
dispatch lives here once: the "dqn" family (flat and frame-ring
storage), the "r2d2" family (flat sequence replay, single frames per
sequence under frame_ring storage) and the "dpg" family (flat
continuous transitions; the network is the pair (actor, critic)).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ape_x_dqn_tpu_torch.models import init_params
from ape_x_dqn_tpu_torch.replay.frame_ring import (frame_ring_mode,
                                                   frame_segment_spec)
from ape_x_dqn_tpu_torch.replay.sequence import (sequence_frame_mode,
                                                 sequence_item_spec)
from ape_x_dqn_tpu_torch.runtime.actor import (Actor, ContinuousActor,
                                               RecurrentActor)
from ape_x_dqn_tpu_torch.utils.rng import component_generator


def family_of(cfg) -> str:
    return {"lstm_q": "r2d2", "dpg": "dpg"}.get(cfg.network.kind, "dqn")


def actor_class(family: str, vector: bool = False) -> type:
    """Actor implementation per family. vector=True selects the
    K-envs-per-thread actor (runtime/vector_actor.py), whose query is
    the server's `query_batch` (the recurrent one ships {obs, c, h}
    with a leading [K] axis)."""
    if vector:
        from ape_x_dqn_tpu_torch.runtime.vector_actor import (
            ContinuousVectorActor, RecurrentVectorActor, VectorActor)
        return {"r2d2": RecurrentVectorActor,
                "dpg": ContinuousVectorActor}.get(family, VectorActor)
    return {"r2d2": RecurrentActor, "dpg": ContinuousActor}.get(
        family, Actor)


class _Step(torch.nn.Module):
    """`net.step` as a module's forward, so ``functional_call`` can run
    it on the server's params (keys prefixed "net.")."""

    def __init__(self, net: torch.nn.Module):
        super().__init__()
        self.net = net

    def forward(self, obs, c, h):
        return self.net.step(obs, (c, h))


class _ActorCritic(torch.nn.Module):
    """mu(s) and Q(s, mu(s)) as one module's forward, over the
    {actor.*, critic.*} params `DPGLearner.publish_params` hands out."""

    def __init__(self, actor: torch.nn.Module, critic: torch.nn.Module):
        super().__init__()
        self.actor = actor
        self.critic = critic

    def forward(self, obs):
        a = self.actor(obs)
        return {"a": a, "q": self.critic(obs, a)}


def server_apply_fn(family: str, net) -> Callable:
    """The batched forward the inference server runs, per family, as
    ``functional_call`` of a private copy of `net` on the params the
    server holds, so the server never swaps parameters on a module
    another thread trains.
    - dqn:  obs [B, ...]  -> q [B, A]
    - r2d2: {obs, c, h}   -> {q, c, h}   (the stateful step)
    - dpg:  obs [B, ...]  -> {a: mu(s), q: Q(s, mu(s))}  (`net` is the
      pair (actor, critic))"""
    if family == "dpg":
        pair = _ActorCritic(*net)
        module = copy.deepcopy(pair).requires_grad_(False)

        def apply_dpg(params: dict, obs: torch.Tensor) -> dict:
            return torch.func.functional_call(module, params, (obs,))

        return apply_dpg
    module = copy.deepcopy(net).requires_grad_(False)
    if family == "r2d2":
        step = _Step(module)

        def apply_rec(params: dict, inp: dict) -> dict:
            q, (c, h) = torch.func.functional_call(
                step, {f"net.{k}": v for k, v in params.items()},
                (inp["obs"], inp["c"], inp["h"]))
            return {"q": q, "c": c, "h": h}

        return apply_rec

    def apply(params: dict, obs: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(module, params, (obs,))

    return apply


def warmup_example(family: str, cfg, spec: Any) -> Any:
    """One server request (no batch dim) for the warm-up forwards:
    shapes and dtypes only."""
    obs = np.zeros(spec.obs_shape, spec.obs_dtype)
    if family == "r2d2":
        z = np.zeros(cfg.network.lstm_size, np.float32)
        return {"obs": obs, "c": z, "h": z}
    return obs


class FamilySetup(NamedTuple):
    """Initial params, replay item layout and ingest staging geometry
    for a config's family."""
    params: Any          # the network (dpg: the pair), initialised in place
    item_spec: dict
    frame_mode: bool     # dqn family storing single-frame segments
    stage_chunk: int     # staging units per ingest block
    unit_items: int      # transitions per staging unit (fill counting)


def family_setup(cfg, spec: Any, net,
                 obs0: np.ndarray) -> FamilySetup:
    """Initialise the params (flax's default init drawn from
    ``component_generator(cfg.seed, "net_init")``, as
    runtime/build.py does) and pick the replay item layout and staging
    chunk.

    - dqn: frame_ring storage swaps the item spec to whole frame
      segments (staging units of seg_transitions transitions,
      segs_per_add to a block); flat storage stages single transitions,
      ingest_batch to a block.
    - r2d2: the units are whole sequences, in the flat replay either
      way; frame_ring storage only makes each sequence hold single
      frames. ingest_batch counts TRANSITIONS, so the block is
      ingest_batch // seq_length sequences (at least one): a block of
      ingest_batch sequences would hold ingest_batch * seq_length env
      steps and starve the learner waiting for its first add.
    - dpg: the actor and the critic drawn from their own components
      ("actor_init", "critic_init"), flat continuous transitions staged
      one by one, ingest_batch to a block; frame_ring storage is for
      pixel families and raises.

    `obs0` is unused (the original traces its init from it)."""
    from ape_x_dqn_tpu_torch.runtime.dpg_learner import continuous_item_spec
    from ape_x_dqn_tpu_torch.runtime.learner import transition_item_spec

    family = family_of(cfg)
    if family == "dpg":
        if cfg.replay.storage == "frame_ring":
            raise NotImplementedError(
                "frame_ring storage is for pixel families (dqn/r2d2); "
                "use storage='flat' for dpg")
        actor, critic = net
        init_params(actor, component_generator(cfg.seed, "actor_init"))
        init_params(critic, component_generator(cfg.seed, "critic_init"))
        item_spec = continuous_item_spec(spec.obs_shape, spec.obs_dtype,
                                         spec.action_dim)
        return FamilySetup(net, item_spec, False,
                           max(cfg.actors.ingest_batch, 1), 1)
    init_params(net, component_generator(cfg.seed, "net_init"))
    if family == "r2d2":
        seq_frame_mode = sequence_frame_mode(cfg.replay.storage,
                                             spec.obs_shape)
        if cfg.replay.storage == "frame_ring" and not seq_frame_mode:
            raise ValueError(
                f"frame_ring sequence storage needs [H, W, stack] "
                f"pixel obs, got {spec.obs_shape}; set "
                f"replay.storage='flat' for vector observations")
        item_spec = sequence_item_spec(
            spec.obs_shape, spec.obs_dtype, cfg.replay.seq_length,
            cfg.network.lstm_size, frame_mode=seq_frame_mode)
        return FamilySetup(
            net, item_spec, False,
            max(cfg.actors.ingest_batch // cfg.replay.seq_length, 1), 1)
    if cfg.replay.storage == "frame_ring":
        if cfg.replay.kind != "prioritized":
            raise NotImplementedError(
                "flat-family frame_ring storage requires prioritized "
                "replay")
        if not frame_ring_mode(cfg.replay.storage, spec.obs_shape):
            raise ValueError(
                f"frame_ring storage needs [H, W, stack] pixel obs, "
                f"got {spec.obs_shape}; set replay.storage='flat' for "
                f"vector observations")
        item_spec = frame_segment_spec(
            cfg.replay.seg_transitions, cfg.learner.n_step,
            spec.obs_shape, spec.obs_dtype)
        return FamilySetup(net, item_spec, True,
                           max(cfg.replay.segs_per_add, 1),
                           cfg.replay.seg_transitions)
    item_spec = transition_item_spec(spec.obs_shape, spec.obs_dtype)
    return FamilySetup(net, item_spec, False,
                       max(cfg.actors.ingest_batch, 1), 1)
