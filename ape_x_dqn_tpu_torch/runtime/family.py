"""Model-family dispatch for the driver.

Counterpart of ``ape_x_dqn_tpu/runtime/family.py``. A RunConfig's
network kind selects a runtime family: flat-DQN ("dqn"), recurrent R2D2
("r2d2") or continuous Ape-X DPG ("dpg"). They differ in the inference
server's protocol, the actor class and the warm-up example, and the
dispatch lives here once. The port has the "dqn" family (flat and
frame-ring storage); the other two raise, naming the ROADMAP Queue A
item they wait for (12 and 13).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ape_x_dqn_tpu_torch.models import init_params
from ape_x_dqn_tpu_torch.replay.frame_ring import (frame_ring_mode,
                                                   frame_segment_spec)
from ape_x_dqn_tpu_torch.runtime.actor import Actor
from ape_x_dqn_tpu_torch.utils.rng import component_generator

_WAITS = {"r2d2": ("R2D2 (lstm_q)", 12), "dpg": ("Ape-X DPG", 13)}


def family_of(cfg) -> str:
    return {"lstm_q": "r2d2", "dpg": "dpg"}.get(cfg.network.kind, "dqn")


def _not_ported(family: str) -> NotImplementedError:
    what, item = _WAITS[family]
    return NotImplementedError(
        f"the {what} family is not ported to the PyTorch package yet: it "
        f"waits for ROADMAP Queue A item {item}")


def actor_class(family: str, vector: bool = False) -> type:
    """Actor implementation per family. vector=True selects the
    K-envs-per-thread actor (runtime/vector_actor.py), whose query is
    the server's `query_batch`."""
    if family != "dqn":
        raise _not_ported(family)
    if vector:
        from ape_x_dqn_tpu_torch.runtime.vector_actor import VectorActor
        return VectorActor
    return Actor


def server_apply_fn(family: str, net: torch.nn.Module) -> Callable:
    """The batched forward the inference server runs, per family. dqn:
    obs [B, ...] -> q [B, A], as ``functional_call`` of a private copy
    of `net` on the params the server holds, so the server never swaps
    parameters on a module another thread trains."""
    if family != "dqn":
        raise _not_ported(family)
    module = copy.deepcopy(net).requires_grad_(False)

    def apply(params: dict, obs: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(module, params, (obs,))

    return apply


def warmup_example(family: str, cfg, spec: Any) -> Any:
    """One server request (no batch dim) for the warm-up forwards:
    shapes and dtypes only."""
    if family != "dqn":
        raise _not_ported(family)
    return np.zeros(spec.obs_shape, spec.obs_dtype)


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
    chunk. frame_ring storage swaps the item spec to whole frame
    segments (staging units of seg_transitions transitions, segs_per_add
    to a block); flat storage stages single transitions, ingest_batch to
    a block. `obs0` is unused by the dqn family (the original traces
    its init from it)."""
    from ape_x_dqn_tpu_torch.runtime.learner import transition_item_spec

    family = family_of(cfg)
    if family != "dqn":
        raise _not_ported(family)
    init_params(net, component_generator(cfg.seed, "net_init"))
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
