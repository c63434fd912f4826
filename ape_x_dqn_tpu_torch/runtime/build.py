"""Entry point: build the prioritized DQN learner for a RunConfig.

The counterpart of ``ape_x_dqn_tpu/runtime/driver.py``'s
``build_prioritized_replay`` together with ``bench.py``'s
``build_learner``: the frame ring is sized with
``next_pow2(cfg.replay.capacity)`` transitions in segments of
``cfg.replay.seg_transitions``, exactly as the JAX driver sizes it.

    from ape_x_dqn_tpu_torch.configs import get_config
    from ape_x_dqn_tpu_torch.envs.base import EnvSpec
    from ape_x_dqn_tpu_torch.runtime.build import build_learner

    spec = EnvSpec(obs_shape=(84, 84, 4), obs_dtype=np.dtype(np.uint8),
                   discrete=True, num_actions=18)
    learner, state = build_learner(get_config("pong"), spec)  # on cuda
    state = learner.add_many(state, segments, td_abs)
    state, metrics = learner.train_step_k(state, 4)
"""

from __future__ import annotations

import torch

from ape_x_dqn_tpu_torch.models import build_network, init_params
from ape_x_dqn_tpu_torch.replay.frame_ring import (FrameRingReplay,
                                                   frame_ring_mode)
from ape_x_dqn_tpu_torch.replay.prioritized import PrioritizedReplay
from ape_x_dqn_tpu_torch.runtime.learner import (DQNLearner, TrainState,
                                                 transition_item_spec)
from ape_x_dqn_tpu_torch.utils.misc import next_pow2, resolve_device
from ape_x_dqn_tpu_torch.utils.rng import component_generator


def build_prioritized_replay(cfg, spec, capacity: int,
                             device: str | torch.device,
                             frame_mode: bool | None = None):
    """Prioritized replay at `capacity` in the configured storage
    layout, as the JAX driver's ``build_prioritized_replay`` builds it:
    the frame ring in frame mode (frame_ring storage over [H, W, stack]
    pixels; `frame_mode` None reads it from the config), flat
    `PrioritizedReplay` otherwise."""
    r = cfg.replay
    if frame_mode is None:
        frame_mode = frame_ring_mode(r.storage, spec.obs_shape)
    if frame_mode:
        return FrameRingReplay(
            capacity=capacity, seg_transitions=r.seg_transitions,
            n_step=cfg.learner.n_step, obs_shape=spec.obs_shape,
            obs_dtype=spec.obs_dtype, alpha=r.alpha, beta=r.beta, eps=r.eps,
            device=device)
    return PrioritizedReplay(capacity=capacity, alpha=r.alpha, beta=r.beta,
                             eps=r.eps, device=device)


def build_learner(cfg, spec, device: str | torch.device = "cuda"
                  ) -> tuple[DQNLearner, TrainState]:
    """-> (learner, state): the network drawn from ``cfg.seed`` (flax's
    default init), its target copy, the optimizer state, an empty
    prioritized replay (frame ring or flat, by the config) at
    ``next_pow2(cfg.replay.capacity)`` and the learner's generator, all
    on `device`. Raises if `device` is CUDA and CUDA is
    unavailable."""
    dev = resolve_device(device)
    replay = build_prioritized_replay(
        cfg, spec, next_pow2(cfg.replay.capacity), dev)
    net = build_network(cfg.network, spec)
    init_params(net, component_generator(cfg.seed, "net_init"))
    net.to(dev)
    learner = DQNLearner(replay, cfg.learner)
    replay_state = (replay.init() if isinstance(replay, FrameRingReplay)
                    else replay.init(transition_item_spec(spec.obs_shape,
                                                          spec.obs_dtype)))
    state = learner.init(net, replay_state,
                         component_generator(cfg.seed, "learner",
                                             device=dev))
    return learner, state
