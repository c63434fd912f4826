"""Ape-X DPG learner: critic + policy + Polyak targets in one step body.

Counterpart of ``ape_x_dqn_tpu/runtime/dpg_learner.py``. One grad-step
samples the prioritized replay, updates the critic on its TD error,
then lets the policy ascend the UPDATED critic (the standard DDPG
order), then moves both target networks toward their online networks
(``soft_update``, tau from LearnerConfig), then writes the critic's |TD|
back as priorities. Two `ClipAdam`s, at `critic_lr` and `policy_lr`.

Like the other learners it updates its state IN PLACE, and the step is
one body that reads only device values: on the CPU it runs eagerly, and
on the card `train_step` and `train_many` replay it as a captured CUDA
graph (runtime/step_graph.py). Two 300/200 MLPs, two optimizers and two
soft updates a grad-step are a few hundred small kernels, so the graph
carries this learner from its first step. The K-batch relaxation and
the double-buffered sampler are rejected, as in the original.
"""

from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass
from typing import Iterable

import torch
from torch import nn

from ape_x_dqn_tpu_torch.models.base import soft_update
from ape_x_dqn_tpu_torch.models.dpg import server_params
from ape_x_dqn_tpu_torch.obs import learning as learn_obs
from ape_x_dqn_tpu_torch.obs.stages import mark_stage
from ape_x_dqn_tpu_torch.ops.losses import ContinuousBatch, make_dpg_losses
from ape_x_dqn_tpu_torch.replay.packing import ItemSpec, torch_dtype
from ape_x_dqn_tpu_torch.replay.prioritized import ReplayState
from ape_x_dqn_tpu_torch.runtime.learner import (AdamState, ClipAdam,
                                                 SingleChipLearner)
from ape_x_dqn_tpu_torch.runtime.step_graph import GraphedEndpoints


@dataclass
class DPGTrainState:
    actor: nn.Module           # online policy (its parameters are params)
    critic: nn.Module
    target_actor: nn.Module
    target_critic: nn.Module
    actor_opt: AdamState
    critic_opt: AdamState
    replay: ReplayState
    generator: torch.Generator
    step: int                  # grad-step counter (host)


def continuous_item_spec(obs_shape, obs_dtype,
                         action_dim: int) -> dict[str, ItemSpec]:
    """Item spec for one flat n-step transition (continuous actions)."""
    obs = ItemSpec(tuple(obs_shape), torch_dtype(obs_dtype))
    return {
        "obs": obs,
        "action": ItemSpec((action_dim,), torch.float32),
        "reward": ItemSpec((), torch.float32),
        "next_obs": obs,
        "discount": ItemSpec((), torch.float32),
    }


class DPGLearner(GraphedEndpoints):
    def __init__(self, replay, lcfg):
        if getattr(lcfg, "sample_chunk", 1) > 1:
            raise ValueError(
                "learner.sample_chunk > 1 is not implemented by the "
                "DPG learner — set sample_chunk=1")
        if getattr(lcfg, "sample_prefetch", False):
            raise ValueError(
                "learner.sample_prefetch is not implemented by the "
                "DPG learner — set sample_prefetch=False")
        self.replay = replay
        self.lcfg = lcfg
        self.critic_optimizer = ClipAdam(lcfg.max_grad_norm, lcfg.critic_lr,
                                         eps=lcfg.adam_eps)
        self.actor_optimizer = ClipAdam(lcfg.max_grad_norm, lcfg.policy_lr,
                                        eps=lcfg.adam_eps)
        self.critic_loss, self.policy_loss = make_dpg_losses()

    # -- state ------------------------------------------------------------

    def init(self, actor: nn.Module, critic: nn.Module,
             replay_state: ReplayState,
             generator: torch.Generator) -> DPGTrainState:
        targets = [copy.deepcopy(m).requires_grad_(False)
                   for m in (actor, critic)]
        return DPGTrainState(
            actor=actor, critic=critic, target_actor=targets[0],
            target_critic=targets[1],
            actor_opt=self.actor_optimizer.init(actor.parameters()),
            critic_opt=self.critic_optimizer.init(critic.parameters()),
            replay=replay_state, generator=generator, step=0)

    # -- core step ----------------------------------------------------------

    @staticmethod
    def _apply(optimizer: ClipAdam, opt_state: AdamState, params: list,
               loss: torch.Tensor):
        """Gradients of `loss` for `params`, one optimizer step in place.
        -> (grads, updates)."""
        mark_stage("backward", loss.device)
        grads = torch.autograd.grad(loss, params)
        mark_stage("optimizer", loss.device)
        updates = optimizer.update(grads, opt_state)
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.add_(u)
        return grads, updates

    def _step_body(self, state: DPGTrainState, noise: torch.Tensor) -> dict:
        """One grad-step, in place on `state` (captured on the card),
        its stages marked as the DQN learners' (obs/stages.py): sample,
        then loss, backward and optimizer for the critic and again for
        the policy (the soft target updates close the second optimizer
        stage), diag, writeback, end."""
        dev = state.replay.tree.device
        mark_stage("sample", dev)
        items, idx, is_w = self.replay.sample(
            state.replay, self.lcfg.batch_size, noise)
        mark_stage("loss", dev)
        batch = ContinuousBatch(
            obs=items["obs"], actions=items["action"],
            rewards=items["reward"], next_obs=items["next_obs"],
            discounts=items["discount"])
        c_loss, c_aux = self.critic_loss(state.critic, state.target_critic,
                                         state.target_actor, batch, is_w)
        c_params = list(state.critic.parameters())
        c_grads, c_updates = self._apply(self.critic_optimizer,
                                         state.critic_opt, c_params, c_loss)
        # the policy ascends the UPDATED critic (standard DDPG ordering)
        mark_stage("loss", dev)
        p_loss, p_aux = self.policy_loss(state.actor, state.critic, batch)
        self._apply(self.actor_optimizer, state.actor_opt,
                    list(state.actor.parameters()), p_loss)
        soft_update(state.target_actor, state.actor, self.lcfg.tau)
        soft_update(state.target_critic, state.critic, self.lcfg.tau)
        mark_stage("diag", dev)
        metrics = {
            "loss": c_loss.detach(),
            "policy_loss": p_loss.detach(),
            "q_mean": c_aux["q_mean"],
            "td_abs_mean": c_aux["td_abs"].mean(),
            "a_abs_mean": p_aux["a_abs_mean"],
            # learning-health scalars over the CRITIC update (the TD
            # learner); draw and write-back see one tree: staleness 0
            "diag": {**learn_obs.sgd_diag(c_aux, is_w, c_grads, c_updates,
                                          [p.detach() for p in c_params]),
                     **learn_obs.replay_health(self.replay, state.replay,
                                               idx, None)},
        }
        mark_stage("writeback", dev)
        self.replay.update_priorities(state.replay, idx, c_aux["td_abs"])
        mark_stage("end", dev)
        return metrics

    # -- endpoints ------------------------------------------------------------

    def train_step(self, state: DPGTrainState,
                   noise: torch.Tensor | None = None):
        """One grad-step. `noise` ([batch_size] uniform) replaces the
        generator's stratification draw (tests feed JAX's). On the card
        it replays a captured graph."""
        noise = self._draw(state, self.lcfg.batch_size, noise)
        metrics = self._run(
            "step", lambda lrn, s, u: lrn._step_body(s, u), state, noise)
        state.step += 1
        return state, metrics

    def train_many(self, state: DPGTrainState, n: int,
                   noise: Iterable[torch.Tensor] | None = None):
        """n grad-steps (n replays of the one-step graph on the card).
        `noise`: one stratification-noise tensor per step. -> (state,
        the last step's metrics)."""
        draws = iter(noise) if noise is not None else itertools.repeat(None)
        metrics = None
        for _ in range(n):
            state, metrics = self.train_step(state, next(draws))
        return state, metrics

    # the ingest adds touch only the replay: the DQN learners' own
    add = SingleChipLearner.add
    add_many = SingleChipLearner.add_many

    def publish_params(self, state: DPGTrainState) -> dict[str, torch.Tensor]:
        """Independent {actor.*, critic.*} param copies for the inference
        server, which evaluates mu(s) and Q(s, mu(s)) per query."""
        return {k: v.detach().clone() for k, v in server_params(
            {"actor": state.actor.state_dict(),
             "critic": state.critic.state_dict()}).items()}
