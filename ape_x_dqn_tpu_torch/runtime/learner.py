"""The learner: sample -> loss -> update -> priority write-back.

Counterpart of ``ape_x_dqn_tpu/runtime/learner.py`` (``SingleChipLearner``
and ``DQNLearner``). PyTorch runs eagerly, so where the JAX package
compiles each endpoint into one donated jit, this learner runs the same
sequence of device operations from the host and updates its state IN
PLACE: the network and optimizer tensors, the replay storage and the
sum-tree. The endpoints return the (same) state object for symmetry
with the JAX calls. The host never waits for the device inside a step:
cursors and the step count are host ints, and metrics are device
tensors read by the caller where it already synchronises.

The K-batch relaxation (LearnerConfig.sample_chunk = K) keeps the JAX
package's semantics exactly: one stratified K*B draw whose chunk j takes
the INTERLEAVED strata {j, j+K, j+2K, ...}, per-chunk IS
renormalisation, K SGD steps, then ONE priority write-back. The
double-buffered form (LearnerConfig.sample_prefetch) keeps one
macro-step's sample in flight: `sample_k` draws the NEXT sample from the
current tree before `learn_k` trains on the pending one. `evict_region`
and `add_at` wait for the tiers' slice.
"""

from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass
from typing import Any, Iterable

import numpy as np
import torch
from torch import nn

from ape_x_dqn_tpu_torch.models.base import hard_update
from ape_x_dqn_tpu_torch.obs import learning as learn_obs
from ape_x_dqn_tpu_torch.ops.losses import TransitionBatch, make_dqn_loss
from ape_x_dqn_tpu_torch.replay.packing import ItemSpec, torch_dtype
from ape_x_dqn_tpu_torch.replay.prioritized import ReplayState


@dataclass
class AdamState:
    count: int                 # host int, like optax's int32 count
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


@dataclass
class TrainState:
    net: nn.Module             # online network (its parameters are params)
    target_net: nn.Module
    opt_state: AdamState
    replay: ReplayState
    generator: torch.Generator
    step: int                  # grad-step counter


def transition_item_spec(obs_shape, obs_dtype) -> dict[str, ItemSpec]:
    """Item spec for one flat n-step transition (discrete actions)."""
    obs = ItemSpec(tuple(obs_shape), torch_dtype(obs_dtype))
    return {
        "obs": obs,
        "action": ItemSpec((), torch.int32),
        "reward": ItemSpec((), torch.float32),
        "next_obs": obs,
        "discount": ItemSpec((), torch.float32),
    }


class ClipAdam:
    """``optax.chain(clip_by_global_norm(max_norm), adam(lr, eps=eps))``
    with optax's exact formulas, written out as tensor code.

    Clip: with g_norm = sqrt(sum g^2) over every gradient element, each
    gradient becomes (g / g_norm) * max_norm unless g_norm < max_norm.
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm, so it is
    not the same function.) Adam: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2
    + b2 nu, update = -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t))
    + eps). The moments update IN PLACE."""

    def __init__(self, max_norm: float, lr: float, eps: float = 1e-8,
                 b1: float = 0.9, b2: float = 0.999):
        self.max_norm = max_norm
        self.lr = lr
        self.eps = eps
        self.b1 = b1
        self.b2 = b2

    def init(self, params) -> AdamState:
        return AdamState(count=0,
                         mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params])

    def update(self, grads, state: AdamState) -> list[torch.Tensor]:
        """-> the updates to add to the params; advances `state`."""
        g_norm = learn_obs.global_norm(grads)
        trigger = g_norm < self.max_norm
        grads = [torch.where(trigger, g, (g / g_norm) * self.max_norm)
                 for g in grads]
        state.count += 1
        # bias corrections in float32, as optax computes decay**count
        t = np.float32(state.count)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** t)
        updates = []
        for g, mu, nu in zip(grads, state.mu, state.nu):
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            updates.append(u * (-self.lr))
        return updates


def make_optimizer(lcfg) -> ClipAdam:
    return ClipAdam(lcfg.max_grad_norm, lcfg.lr, eps=lcfg.adam_eps)


class SingleChipLearner:
    """Shared single-device learner machinery: state init, the exact
    per-step path, the K-batch relaxation, train_many, the ingest add
    and param publication. Subclasses define `_sgd_step(state, items,
    is_w) -> (td_abs, metrics)`, the family-specific piece."""

    # -- state ------------------------------------------------------------

    def init(self, net: nn.Module, replay_state: ReplayState,
             generator: torch.Generator) -> TrainState:
        target = copy.deepcopy(net)  # own parameter storage
        target.requires_grad_(False)
        return TrainState(net=net, target_net=target,
                          opt_state=self.optimizer.init(
                              list(net.parameters())),
                          replay=replay_state, generator=generator, step=0)

    # -- core step ----------------------------------------------------------

    def _sgd_step(self, state: TrainState, items: dict,
                  is_w: torch.Tensor):
        raise NotImplementedError  # family-specific: batch + loss

    def _optimize(self, state: TrainState, loss: torch.Tensor):
        """The family-independent half of an SGD step, in place on
        `state`: the gradients of `loss`, the optimizer update, the step
        count and the hard target sync every target_sync_every steps (a
        host branch: the step count lives on the host). -> (grads,
        updates, the params after the update, detached)."""
        params = list(state.net.parameters())
        grads = torch.autograd.grad(loss, params)
        updates = self.optimizer.update(grads, state.opt_state)
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.add_(u)
        state.step += 1
        if state.step % self.lcfg.target_sync_every == 0:
            hard_update(state.target_net, state.net)
        return grads, updates, [p.detach() for p in params]

    def _train_step(self, state: TrainState,
                    noise: torch.Tensor | None = None):
        items, idx, is_w = self.replay.sample(
            state.replay, self.lcfg.batch_size, noise, state.generator)
        td_abs, metrics = self._sgd_step(state, items, is_w)
        # draw and write-back see the same tree: staleness is 0
        metrics["diag"] = {**metrics["diag"],
                           **learn_obs.replay_health(
                               self.replay, state.replay, idx, None)}
        self.replay.update_priorities(state.replay, idx, td_abs)
        return state, metrics

    def _sample_stage(self, replay_state: ReplayState, k: int,
                      noise: torch.Tensor | None = None,
                      generator: torch.Generator | None = None):
        """SAMPLE stage of the K-batch cycle: one stratified K*B
        descent + frame gather + IS weights, chunked for the K SGD
        steps. -> (items_k [K, B, ...], idx_k [K, B], is_w_k [K, B],
        pri_k [K, B] descent-time leaf priorities)."""
        b = self.lcfg.batch_size
        items, idx, is_w = self.replay.sample_state(replay_state, k * b,
                                                    noise, generator)
        pri = self.replay.leaf_priorities(replay_state, idx)

        # stratum i of the K*B descent covers mass slice [i, i+1)/(K*B)
        # over leaves in ring-insertion order, so chunk j takes the
        # INTERLEAVED strata {j, j+K, j+2K, ...} to span the full
        # priority range (a contiguous split would hand each chunk one
        # age-correlated 1/K slice of the replay)
        def chunked(x):
            return x.reshape(b, k, *x.shape[1:]).transpose(0, 1)

        items_k = {key: chunked(v) for key, v in items.items()}
        # sample() max-normalized over the K*B pool; renormalizing per
        # chunk recovers the exact per-step IS convention
        is_w_k = chunked(is_w)
        is_w_k = is_w_k / torch.clamp(is_w_k.amax(dim=1, keepdim=True),
                                      min=1e-12)
        return items_k, chunked(idx), is_w_k, chunked(pri)

    def _learn_stage(self, state: TrainState, sample, k: int):
        """LEARN stage: K SGD steps over an already-drawn sample + ONE
        priority write-back (target sync happens inside the steps)."""
        b = self.lcfg.batch_size
        items_k, idx_k, is_w_k, pri_k = sample
        td_parts = []
        metrics = None
        for j in range(k):
            it = {key: v[j] for key, v in items_k.items()}
            td_abs, metrics = self._sgd_step(state, it, is_w_k[j])
            td_parts.append(td_abs)
        # write-back-time replay health, read before the write-back:
        # the tree now vs pri_k, what the descent saw
        metrics["diag"] = {**metrics["diag"],
                           **learn_obs.replay_health(
                               self.replay, state.replay, idx_k, pri_k)}
        # td_parts[j] pairs with idx_k[j] (chunk order)
        self.replay.update_state(state.replay, idx_k.reshape(k * b),
                                 torch.cat(td_parts))
        return state, metrics

    def _train_step_k(self, state: TrainState, k: int,
                      noise: torch.Tensor | None = None):
        """K grad-steps from ONE stratified sample + ONE priority
        write-back (the K-batch relaxation): chunk j+1 trains on
        priorities that predate chunk j's TD errors."""
        sample = self._sample_stage(state.replay, k, noise,
                                    state.generator)
        return self._learn_stage(state, sample, k)

    # -- endpoints ------------------------------------------------------------

    def train_step(self, state: TrainState,
                   noise: torch.Tensor | None = None):
        """One exact grad-step. `noise` ([batch_size] uniform) replaces
        the generator's stratification draw (tests feed JAX's)."""
        return self._train_step(state, noise)

    def train_step_k(self, state: TrainState, k: int,
                     noise: torch.Tensor | None = None):
        """One K-batch macro-step (k grad-steps). `noise`: [k *
        batch_size] stratification noise, as in `train_step`."""
        return self._train_step_k(state, k, noise)

    def sample_k(self, state: TrainState, k: int,
                 noise: torch.Tensor | None = None):
        """SAMPLE dispatch of the double-buffered pipeline: draw the
        NEXT macro-step's chunked sample from the current tree. Leaves
        the state untouched, except that the draw advances
        `state.generator`; the sample holds its own copies of the
        gathered items, so later in-place writes do not reach it.
        `noise`: [k * batch_size] stratification noise, as in
        `train_step_k`."""
        return self._sample_stage(state.replay, k, noise, state.generator)

    def learn_k(self, state: TrainState, sample, k: int):
        """LEARN dispatch: K SGD steps + one write-back on a sample drawn
        earlier by `sample_k`, possibly against a tree that an `add` or
        a write-back has changed since (the accepted one-dispatch
        staleness). It draws nothing."""
        return self._learn_stage(state, sample, k)

    def train_many(self, state: TrainState, n: int,
                   noise: Iterable[torch.Tensor] | None = None):
        """n grad-steps. With sample_chunk=K>1: n % K exact single steps
        FIRST, then n // K K-batch macro-steps, so the returned
        (last-step) metrics come from the macro-steps that do the bulk
        of the work. With sample_prefetch the macro-steps run
        double-buffered (`_train_many_prefetch`). `noise`: one
        stratification-noise tensor per draw, in draw order (tests feed
        JAX's). -> (state, last step's metrics)."""
        k = getattr(self.lcfg, "sample_chunk", 1)
        draws = iter(noise) if noise is not None else itertools.repeat(None)
        if getattr(self.lcfg, "sample_prefetch", False):
            return self._train_many_prefetch(state, n, max(k, 1), draws)
        metrics = None
        if k <= 1:
            for _ in range(n):
                state, metrics = self._train_step(state, next(draws))
            return state, metrics
        for _ in range(n % k):
            state, metrics = self._train_step(state, next(draws))
        for _ in range(n // k):
            state, metrics = self._train_step_k(state, k, next(draws))
        return state, metrics

    def _train_many_prefetch(self, state: TrainState, n: int, k: int,
                             draws):
        """Double-buffered macro-steps: the NEXT macro-step's sample is
        drawn from the tree BEFORE this macro-step's K SGD steps and
        write-back run, so it sees priorities that predate that
        write-back (one dispatch of lag). Remainder singles first; the
        first macro-step trains on a fresh prologue draw, so a
        one-macro-step call matches `train_step_k` in params; the last
        prefetched sample is discarded."""
        metrics = None
        for _ in range(n % k):
            state, metrics = self._train_step(state, next(draws))
        if n // k:
            pending = self.sample_k(state, k, next(draws))
            for _ in range(n // k):
                nxt = self.sample_k(state, k, next(draws))
                state, metrics = self.learn_k(state, pending, k)
                pending = nxt
        return state, metrics

    def add(self, state: TrainState, items: Any,
            td_abs: torch.Tensor) -> TrainState:
        self.replay.add(state.replay, items, td_abs)
        return state

    def add_many(self, state: TrainState, items: Any,
                 td_abs: torch.Tensor) -> TrainState:
        """Coalesced ingest: items [g, ...staging block], td_abs [g, ...]
        — g staged blocks added in order."""
        for j in range(td_abs.shape[0]):
            self.replay.add(state.replay, {k: v[j] for k, v in items.items()},
                            td_abs[j])
        return state

    def publish_params(self, state: TrainState) -> dict[str, torch.Tensor]:
        """Independent param copy for the inference side: the train
        endpoints update the network in place."""
        return {k: v.detach().clone()
                for k, v in state.net.state_dict().items()}


class DQNLearner(SingleChipLearner):
    """The flat-transition DQN learner."""

    def __init__(self, replay, lcfg, optimizer: ClipAdam | None = None):
        self.replay = replay
        self.lcfg = lcfg
        self.optimizer = optimizer or make_optimizer(lcfg)
        self.loss_fn = make_dqn_loss(
            double=lcfg.double_dqn, huber_delta=lcfg.huber_delta,
            rescale=lcfg.value_rescale)

    def _sgd_step(self, state: TrainState, items: dict,
                  is_w: torch.Tensor):
        """One loss/grad/optimizer/target-sync update on an already-
        sampled batch, in place on `state`. -> (td_abs, metrics)."""
        batch = TransitionBatch(
            obs=items["obs"], actions=items["action"],
            rewards=items["reward"], next_obs=items["next_obs"],
            discounts=items["discount"])
        loss, aux = self.loss_fn(state.net, state.target_net, batch, is_w)
        grads, updates, params = self._optimize(state, loss)
        metrics = {
            "loss": loss.detach(),
            "q_mean": aux["q_mean"],
            "td_abs_mean": aux["td_abs"].mean(),
            "grad_norm": learn_obs.global_norm(grads),
            "diag": learn_obs.sgd_diag(aux, is_w, grads, updates, params),
        }
        return aux["td_abs"], metrics
