"""The n-step double-DQN Huber loss with importance-sampling weights.

Counterpart of the DQN and R2D2 parts of ``ape_x_dqn_tpu/ops/losses.py``
(the DPG losses wait for their slice). Each loss returns (scalar_loss,
aux) where aux carries the |TD| priorities the learner writes back into
the sum-tree and the learning-health scalars.
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


# ---------------------------------------------------------------------------
# R2D2 sequence loss


class SequenceBatch(NamedTuple):
    """Fixed-length sequences with stored recurrent state."""

    obs: torch.Tensor        # [B, L, ...]
    actions: torch.Tensor    # [B, L] int32
    rewards: torch.Tensor    # [B, L] f32 (per-step, undiscounted)
    terminals: torch.Tensor  # [B, L] f32 (1 at true terminal steps)
    mask: torch.Tensor       # [B, L] f32 (1 on valid steps; 0 on padding)
    init_state: tuple        # (c, h) each [B, H]: state before obs[:, 0]


def nstep_targets_in_sequence(rewards: torch.Tensor,
                              terminals: torch.Tensor,
                              bootstrap: torch.Tensor, mask: torch.Tensor,
                              n_step: int, gamma: float, rescale: bool
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """n-step targets at every t using values bootstrap[t+n] within
    [0, L) -> (target, valid).

    bootstrap[t] is the (already action-selected) bootstrap value at t,
    in the rescaled space if `rescale`. Rolled quantities wrap, so each
    is masked to real in-range data: wrapped rewards and terminals from
    the sequence head never leak into windows hanging off the tail. A
    position trains iff it is real data and its target is determined:
    the bootstrap at t+n is real in-range data, or a terminal inside
    [t, t+n) zeroed it."""
    b, length = rewards.shape
    if rescale:
        bootstrap = value_rescale.h_inv(bootstrap)
    dev = rewards.device
    t_idx = torch.arange(length, device=dev)[None, :]
    ret = torch.zeros((b, length), device=dev)
    disc = torch.ones((b, length), device=dev)
    alive = torch.ones((b, length), device=dev)
    for k in range(n_step):
        m_k = (torch.roll(mask, -k, dims=1)
               * (t_idx + k < length).float())
        ret = ret + disc * alive * torch.roll(rewards, -k, dims=1) * m_k
        alive = alive * (1.0 - torch.roll(terminals, -k, dims=1) * m_k)
        disc = disc * gamma
    target = ret + disc * alive * torch.roll(bootstrap, -n_step, dims=1)
    if rescale:
        target = value_rescale.h(target)
    boot_ok = ((t_idx < length - n_step).float()
               * torch.roll(mask, -n_step, dims=1))
    valid = mask * torch.clamp(boot_ok + (1.0 - alive), 0.0, 1.0)
    return target, valid


def make_r2d2_loss(burn_in: int, n_step: int, gamma: float,
                   huber_delta: float = 1.0, double: bool = True,
                   rescale: bool = True,
                   priority_eta: float = 0.9) -> Callable:
    """Build loss(net, target_net, batch, is_weights) -> (loss, aux)
    for recurrent nets, ``net(obs [B, T, ...], state) -> (q [B, T, A],
    final_state)``.

    - The online burn-in unroll runs without autograd: the original
      stops its gradient, so the state is the same and the backward
      pass skips it. The target net burns in from the same stored
      state.
    - Double-DQN bootstrap; the target carries no gradient.
    - A per-sequence Huber mean over the valid steps, weighted by IS.
    - Priorities: eta * max|td| + (1 - eta) * mean|td| per sequence."""

    def loss_fn(net: nn.Module, target_net: nn.Module,
                batch: SequenceBatch, is_weights: torch.Tensor):
        state0 = tuple(batch.init_state)
        obs_b, obs_t = batch.obs[:, :burn_in], batch.obs[:, burn_in:]
        with torch.no_grad():
            if burn_in > 0:
                _, state_b = net(obs_b, state0)
                _, state_bt = target_net(obs_b, state0)
            else:
                state_b = state_bt = state0
            q_target, _ = target_net(obs_t, state_bt)
        q_online, _ = net(obs_t, state_b)            # [B, T, A]

        actions = batch.actions[:, burn_in:].long()
        rewards = batch.rewards[:, burn_in:]
        terminals = batch.terminals[:, burn_in:]
        mask = batch.mask[:, burn_in:]

        q_sa = torch.gather(q_online, -1, actions[..., None])[..., 0]
        with torch.no_grad():
            q_on = q_online.detach()
            if double:
                boot = torch.gather(q_target, -1,
                                    torch.argmax(q_on, dim=-1)[..., None]
                                    )[..., 0]
            else:
                boot = torch.amax(q_target, dim=-1)
            target, valid = nstep_targets_in_sequence(
                rewards, terminals, boot, mask, n_step, gamma, rescale)
        td = (q_sa - target) * valid
        per_step = huber(td, huber_delta)
        denom = torch.clamp(valid.sum(dim=1), min=1.0)
        per_seq = per_step.sum(dim=1) / denom
        loss = torch.mean(is_weights * per_seq)

        with torch.no_grad():
            td_d = td.detach()
            td_abs = torch.abs(td_d)
            priorities = (priority_eta * td_abs.amax(dim=1)
                          + (1 - priority_eta) * td_abs.sum(dim=1) / denom)
            # valid-masked means: padding never dilutes the statistics
            vsum = torch.clamp(valid.sum(), min=1.0)
            aux = {"td_abs": priorities, "q_mean": q_sa.detach().mean(),
                   "valid_frac": valid.mean(),
                   "td_mean": td_d.sum() / vsum,
                   "q_max": q_on.max(),
                   "target_q_mean": (target * valid).sum() / vsum,
                   "q_gap": ((torch.amax(q_on, dim=-1) - boot)
                             * valid).sum() / vsum}
        return loss, aux

    return loss_fn
