"""Model-family dispatch for the driver.

Counterpart of ``ape_x_dqn_tpu/runtime/family.py``. A RunConfig's
network kind selects a runtime family: flat-DQN ("dqn"), recurrent R2D2
("r2d2") or continuous Ape-X DPG ("dpg"). They differ in the inference
server's protocol, the actor class and the warm-up example, and the
dispatch lives here once. The port has the "dqn" family (flat and
frame-ring storage) and the "r2d2" family (flat sequence replay, single
frames per sequence under frame_ring storage); "dpg" raises, naming the
ROADMAP Queue A item it waits for (13).
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
from ape_x_dqn_tpu_torch.runtime.actor import Actor, RecurrentActor
from ape_x_dqn_tpu_torch.utils.rng import component_generator

def family_of(cfg) -> str:
    return {"lstm_q": "r2d2", "dpg": "dpg"}.get(cfg.network.kind, "dqn")


def _dpg_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "the Ape-X DPG family is not ported to the PyTorch package yet: "
        "it waits for ROADMAP Queue A item 13")


def actor_class(family: str, vector: bool = False) -> type:
    """Actor implementation per family. vector=True selects the
    K-envs-per-thread actor (runtime/vector_actor.py), whose query is
    the server's `query_batch` (the recurrent one ships {obs, c, h}
    with a leading [K] axis)."""
    if family == "dpg":
        raise _dpg_not_ported()
    if vector:
        from ape_x_dqn_tpu_torch.runtime.vector_actor import (
            RecurrentVectorActor, VectorActor)
        return RecurrentVectorActor if family == "r2d2" else VectorActor
    return RecurrentActor if family == "r2d2" else Actor


class _Step(torch.nn.Module):
    """`net.step` as a module's forward, so ``functional_call`` can run
    it on the server's params (keys prefixed "net.")."""

    def __init__(self, net: torch.nn.Module):
        super().__init__()
        self.net = net

    def forward(self, obs, c, h):
        return self.net.step(obs, (c, h))


def server_apply_fn(family: str, net: torch.nn.Module) -> Callable:
    """The batched forward the inference server runs, per family, as
    ``functional_call`` of a private copy of `net` on the params the
    server holds, so the server never swaps parameters on a module
    another thread trains.
    - dqn:  obs [B, ...]  -> q [B, A]
    - r2d2: {obs, c, h}   -> {q, c, h}   (the stateful step)"""
    if family == "dpg":
        raise _dpg_not_ported()
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
    if family == "dpg":
        raise _dpg_not_ported()
    obs = np.zeros(spec.obs_shape, spec.obs_dtype)
    if family == "r2d2":
        z = np.zeros(cfg.network.lstm_size, np.float32)
        return {"obs": obs, "c": z, "h": z}
    return obs


class FamilySetup(NamedTuple):
    """Initial params, replay item layout and ingest staging geometry
    for a config's family."""
    params: Any          # the network, initialised in place
    item_spec: dict
    frame_mode: bool     # dqn family storing single-frame segments
    stage_chunk: int     # staging units per ingest block
    unit_items: int      # transitions per staging unit (fill counting)


def family_setup(cfg, spec: Any, net: torch.nn.Module,
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

    `obs0` is unused (the original traces its init from it)."""
    from ape_x_dqn_tpu_torch.runtime.learner import transition_item_spec

    family = family_of(cfg)
    if family == "dpg":
        raise _dpg_not_ported()
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
