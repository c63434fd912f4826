"""The n-step double-DQN Huber loss with importance-sampling weights.

Counterpart of the DQN part of ``ape_x_dqn_tpu/ops/losses.py``; the
R2D2 and DPG losses wait for their slices. The loss returns
(scalar_loss, aux) where aux carries the |TD| priorities the learner
writes back into the sum-tree and the learning-health scalars.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import nn

from ape_x_dqn_tpu_torch.ops import value_rescale


def huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Huber of a residual, with optax's formula (0.5 x^2 inside delta,
    delta * (|x| - 0.5 delta) outside) so values and grads match."""
    abs_x = torch.abs(x)
    quadratic = torch.clamp(abs_x, max=delta)
    linear = abs_x - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


class TransitionBatch(NamedTuple):
    """A batch of n-step transitions (time-collapsed).

    rewards are the already-accumulated n-step discounted returns R_n;
    discounts are gamma^n * (1 - terminal) for the bootstrap term.
    """

    obs: torch.Tensor        # [B, ...]
    actions: torch.Tensor    # [B] int
    rewards: torch.Tensor    # [B] f32   (n-step return)
    next_obs: torch.Tensor   # [B, ...]  (s_{t+n})
    discounts: torch.Tensor  # [B] f32   (gamma^n, 0 at terminal)


def _take(q: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.gather(q, -1, a.long()[:, None])[:, 0]


def dqn_td_error(q_s: torch.Tensor, q_sp_online: torch.Tensor,
                 q_sp_target: torch.Tensor, batch: TransitionBatch,
                 double: bool = True, rescale: bool = False
                 ) -> torch.Tensor:
    """Per-sample TD error for the (double) n-step DQN target; the
    target carries no gradient."""
    q_sa = _take(q_s, batch.actions)
    with torch.no_grad():
        if double:
            q_boot = _take(q_sp_target, torch.argmax(q_sp_online, dim=-1))
        else:
            q_boot = torch.amax(q_sp_target, dim=-1)
        if rescale:
            target = value_rescale.h(
                batch.rewards
                + batch.discounts * value_rescale.h_inv(q_boot))
        else:
            target = batch.rewards + batch.discounts * q_boot
    return q_sa - target


def make_dqn_loss(double: bool = True, huber_delta: float = 1.0,
                  rescale: bool = False) -> Callable:
    """Build loss(net, target_net, batch, is_weights) -> (loss, aux).

    The bootstrap forward passes (online and target net on next_obs)
    run without autograd: no gradient flows through them in the JAX
    loss either (argmax and stop_gradient), so the values are the same
    and the backward pass skips them."""

    def loss_fn(net: nn.Module, target_net: nn.Module,
                batch: TransitionBatch, is_weights: torch.Tensor):
        q_s = net(batch.obs)
        with torch.no_grad():
            q_sp_online = net(batch.next_obs)
            q_sp_target = target_net(batch.next_obs)
        td = dqn_td_error(q_s, q_sp_online, q_sp_target, batch,
                          double=double, rescale=rescale)
        per_sample = huber(td, huber_delta)
        loss = torch.mean(is_weights * per_sample)
        with torch.no_grad():
            # learning-health diagnostics (obs/learning.py): the
            # online-max vs target-net bootstrap gap is the
            # overestimation Double-DQN exists to shrink
            a_star = torch.argmax(q_sp_online, dim=-1)
            boot_t = _take(q_sp_target, a_star)
            td_d = td.detach()
            aux = {"td_abs": torch.abs(td_d),
                   "loss_per_sample": per_sample.detach(),
                   "q_mean": q_s.detach().mean(), "td_mean": td_d.mean(),
                   "q_max": q_s.detach().max(),
                   "target_q_mean": boot_t.mean(),
                   "q_gap": (torch.amax(q_sp_online, dim=-1)
                             - boot_t).mean()}
        return loss, aux

    return loss_fn
