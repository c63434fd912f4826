"""The learner: sample -> loss -> update -> priority write-back.

Counterpart of ``ape_x_dqn_tpu/runtime/learner.py`` (``SingleChipLearner``
and ``DQNLearner``). Where the JAX package compiles each endpoint into
one donated jit, this learner writes each endpoint as one step body that
updates its state IN PLACE (the network and optimizer tensors, the
replay storage and the sum-tree) and reads only device values: the
replay's cursor and fill mirrors and Adam's count, which is also the
grad-step count that keys the hard target sync, are device tensors, and
the stratification
noise is drawn before the body. On the CPU the body runs eagerly; on
the card `train_step` and `train_step_k` (and so `train_many`) replay it
as a captured CUDA graph (runtime/step_graph.py). The endpoints return
the (same) state object for symmetry with the JAX calls; the host step
count stays a host int, and metrics are device tensors read by the
caller where it already synchronises.

The K-batch relaxation (LearnerConfig.sample_chunk = K) keeps the JAX
package's semantics exactly: one stratified K*B draw whose chunk j takes
the INTERLEAVED strata {j, j+K, j+2K, ...}, per-chunk IS
renormalisation, K SGD steps, then ONE priority write-back. The
double-buffered form (LearnerConfig.sample_prefetch) keeps one
macro-step's sample in flight: `sample_k` draws the NEXT sample from the
current tree before `learn_k` trains on the pending one; these two run
eagerly on every device. `evict_region` and `add_at` are the tiered
cold store's eviction swap, eagerly; the driver replays them as captured
graphs on the card (runtime/step_graph.py: `evict_landed`,
`add_at_landed`).
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
from ape_x_dqn_tpu_torch.obs.stages import mark_stage
from ape_x_dqn_tpu_torch.ops.losses import TransitionBatch, make_dqn_loss
from ape_x_dqn_tpu_torch.replay.packing import ItemSpec, torch_dtype
from ape_x_dqn_tpu_torch.replay.prioritized import ReplayState
from ape_x_dqn_tpu_torch.runtime.step_graph import GraphedEndpoints


@dataclass
class AdamState:
    count: torch.Tensor        # 0-dim int32 on the device, as optax's
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


@dataclass
class TrainState:
    net: nn.Module             # online network (its parameters are params)
    target_net: nn.Module
    opt_state: AdamState
    replay: ReplayState
    generator: torch.Generator
    step: int                  # grad-step counter (host); on the device,
                               # opt_state.count holds the same count


def checkpoint_tree(state, with_replay: bool = False) -> dict:
    """A train state (`TrainState`, or runtime/dpg_learner.py's
    `DPGTrainState`) as a checkpoint payload of its LIVE tensors (no
    copies): "params", "target_params", "opt_state" (DPG: each keyed by
    "actor" and "critic"), "rng" (the generator's state), "step", and
    "replay" (storage, sum-tree, cursor, fill) when asked."""

    if hasattr(state, "groups"):
        # a mesh over several cards (parallel/cards.py): the same tree
        return state.tree(with_replay)

    def adam(opt) -> dict:
        return {"count": opt.count, "mu": list(opt.mu), "nu": list(opt.nu)}

    if hasattr(state, "actor"):
        params = {"actor": state.actor.state_dict(),
                  "critic": state.critic.state_dict()}
        target = {"actor": state.target_actor.state_dict(),
                  "critic": state.target_critic.state_dict()}
        opt = {"actor": adam(state.actor_opt),
               "critic": adam(state.critic_opt)}
    else:
        params = state.net.state_dict()
        target = state.target_net.state_dict()
        opt = adam(state.opt_state)
    tree = {"params": params, "target_params": target, "opt_state": opt,
            "rng": state.generator.get_state(), "step": int(state.step)}
    if with_replay:
        r = state.replay
        # ints; per-shard lists for the dist learner's stacked shards
        pos, size = ((r.pos.tolist(), r.size.tolist())
                     if isinstance(r.pos, np.ndarray)
                     else (int(r.pos), int(r.size)))
        tree["replay"] = {"storage": dict(r.storage), "tree": r.tree,
                          "pos": pos, "size": size}
    return tree


@torch.no_grad()
def restore_checkpoint_tree(state, tree: dict) -> None:
    """Write a `checkpoint_tree` payload back into `state` IN PLACE:
    the captured CUDA graphs read the state's tensors at fixed
    addresses, so every value is copied into the tensor that holds it
    (``load_state_dict``, ``copy_``), never rebound. That includes
    Adam's device count, which also keys the masked hard target sync;
    the replay's cursor and fill go through their setters, which
    refresh the device mirrors the graphs read."""

    if hasattr(state, "groups"):
        state.restore(tree)     # parallel/cards.py, piece by piece
        return

    def adam(opt, saved: dict) -> None:
        opt.count.copy_(saved["count"])
        for t, v in zip(opt.mu, saved["mu"]):
            t.copy_(v)
        for t, v in zip(opt.nu, saved["nu"]):
            t.copy_(v)

    if hasattr(state, "actor"):
        for name in ("actor", "critic"):
            getattr(state, name).load_state_dict(tree["params"][name])
            getattr(state, f"target_{name}").load_state_dict(
                tree["target_params"][name])
            adam(getattr(state, f"{name}_opt"), tree["opt_state"][name])
    else:
        state.net.load_state_dict(tree["params"])
        state.target_net.load_state_dict(tree["target_params"])
        adam(state.opt_state, tree["opt_state"])
    if "replay" in tree:
        r, saved = state.replay, tree["replay"]
        for k, v in saved["storage"].items():
            r.storage[k].copy_(v)
        r.tree.copy_(saved["tree"])
        r.pos, r.size = saved["pos"], saved["size"]
    state.generator.set_state(tree["rng"])
    state.step = int(tree["step"])


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
    + eps). The moments and the count update IN PLACE, on the device:
    the bias corrections are float32 device values, as optax computes
    them, so a captured graph replays them. The params may lie on
    several cards (a net column-split across them,
    parallel/tensor_parallel.py): the norm and the count live on the
    first one, and each moment beside its param."""

    def __init__(self, max_norm: float, lr: float, eps: float = 1e-8,
                 b1: float = 0.9, b2: float = 0.999):
        self.max_norm = max_norm
        self.lr = lr
        self.eps = eps
        self.b1 = b1
        self.b2 = b2

    def init(self, params) -> AdamState:
        params = list(params)
        return AdamState(count=torch.zeros((), dtype=torch.int32,
                                           device=params[0].device),
                         mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params])

    def update(self, grads, state: AdamState) -> list[torch.Tensor]:
        """-> the updates to add to the params; advances `state`."""
        g_norm = learn_obs.global_norm(grads)
        trigger = g_norm < self.max_norm
        grads = [torch.where(trigger.to(g.device), g,
                             (g / g_norm.to(g.device)) * self.max_norm)
                 for g in grads]
        state.count.add_(1)
        # bias corrections in float32, as optax computes decay**count
        t = state.count.to(torch.float32)
        bc1 = 1 - self.b1 ** t
        bc2 = 1 - self.b2 ** t
        updates = []
        for g, mu, nu in zip(grads, state.mu, state.nu):
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
            u = (mu / bc1.to(g.device)) / (
                torch.sqrt(nu / bc2.to(g.device)) + self.eps)
            updates.append(u * (-self.lr))
        return updates


def make_optimizer(lcfg) -> ClipAdam:
    return ClipAdam(lcfg.max_grad_norm, lcfg.lr, eps=lcfg.adam_eps)


class SingleChipLearner(GraphedEndpoints):
    """Shared single-device learner machinery: state init, the exact
    per-step path, the K-batch relaxation, train_many, the ingest add
    and param publication. Subclasses set `loss_fn` and define
    `_make_batch(items) -> the loss's batch`, the family-specific
    piece; it runs inside the step bodies, so it may not read host
    state that changes between calls or synchronise with the host.

    Every step body opens its stages with `mark_stage` (obs/stages.py):
    sample, gather (in the replay), then per SGD step loss, backward,
    optimizer and diag, then diag, writeback and end."""

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

    def _make_batch(self, items: dict):
        raise NotImplementedError  # family-specific: the loss's batch

    def _sgd_step(self, state: TrainState, items: dict,
                  is_w: torch.Tensor):
        """One loss/grad/optimizer/target-sync update on an already-
        sampled batch, in place on `state`. -> (td_abs, metrics); R2D2's
        td_abs are the eta-mixed per-sequence priorities, over which its
        diagnostics' TD quantiles run too."""
        mark_stage("loss", is_w.device)
        loss, aux = self.loss_fn(state.net, state.target_net,
                                 self._make_batch(items), is_w)
        grads, updates, params = self._optimize(state, loss)
        mark_stage("diag", is_w.device)
        metrics = {"loss": loss.detach(), "q_mean": aux["q_mean"],
                   "td_abs_mean": aux["td_abs"].mean()}
        if "valid_frac" in aux:     # R2D2's share of unmasked steps
            metrics["valid_frac"] = aux["valid_frac"]
        metrics["grad_norm"] = learn_obs.global_norm(grads)
        metrics["diag"] = learn_obs.sgd_diag(aux, is_w, grads, updates,
                                             params)
        return aux["td_abs"], metrics

    def _optimize(self, state: TrainState, loss: torch.Tensor):
        """The family-independent half of an SGD step, in place on
        `state`: the gradients of `loss`, the optimizer update and the
        hard target sync every target_sync_every steps, a masked copy
        keyed on Adam's device count, which counts the grad-steps (the
        host step count is the endpoints' to advance). -> (grads,
        updates, the params after the update, detached)."""
        mark_stage("backward", loss.device)
        grads = torch.autograd.grad(loss, list(state.net.parameters()))
        updates, params = self._apply_grads(state, grads)
        return grads, updates, params

    def _apply_grads(self, state: TrainState, grads):
        """The optimizer update of `grads` and the masked hard target
        sync, in place on `state` (the multi-process dist learner calls
        it on the gradient reduced across processes). -> (updates, the
        params after the update, detached)."""
        mark_stage("optimizer", state.opt_state.count.device)
        params = list(state.net.parameters())
        updates = self.optimizer.update(grads, state.opt_state)
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.add_(u)
        every = self.lcfg.target_sync_every
        hard_update(state.target_net, state.net,
                    where=state.opt_state.count % every == 0)
        return updates, [p.detach() for p in params]

    def _step_body(self, state: TrainState, noise: torch.Tensor) -> dict:
        """The body of one exact grad-step (captured on the card)."""
        dev = state.replay.tree.device
        mark_stage("sample", dev)
        items, idx, is_w = self.replay.sample(
            state.replay, self.lcfg.batch_size, noise)
        td_abs, metrics = self._sgd_step(state, items, is_w)
        # draw and write-back see the same tree: staleness is 0
        mark_stage("diag", dev)
        metrics["diag"] = {**metrics["diag"],
                           **learn_obs.replay_health(
                               self.replay, state.replay, idx, None)}
        mark_stage("writeback", dev)
        self.replay.update_priorities(state.replay, idx, td_abs)
        mark_stage("end", dev)
        return metrics

    def _per_draw(self) -> int:
        """Items one grad-step draws from each replay (shard)."""
        return self.lcfg.batch_size

    def _train_step(self, state: TrainState,
                    noise: torch.Tensor | None = None):
        noise = self._draw(state, self._per_draw(), noise)
        metrics = self._run(
            "step", lambda lrn, s, u: lrn._step_body(s, u), state, noise)
        state.step += 1
        return state, metrics

    def _sample_stage(self, replay_state: ReplayState, k: int,
                      noise: torch.Tensor | None = None,
                      generator: torch.Generator | None = None):
        """SAMPLE stage of the K-batch cycle: one stratified K*B
        descent + frame gather + IS weights, chunked for the K SGD
        steps. -> (items_k [K, B, ...], idx_k [K, B], is_w_k [K, B],
        pri_k [K, B] descent-time leaf priorities)."""
        b = self.lcfg.batch_size
        mark_stage("sample", replay_state.tree.device)
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

    def _sample_dispatch(self, replay_state, k: int,
                         noise: torch.Tensor | None = None,
                         generator: torch.Generator | None = None):
        """`_sample_stage` as a dispatch of its own (`sample_k`): what
        follows it is no stage of it."""
        sample = self._sample_stage(replay_state, k, noise, generator)
        mark_stage("end", replay_state.tree.device)
        return sample

    def _learn_stage(self, state: TrainState, sample, k: int) -> dict:
        """LEARN stage: K SGD steps over an already-drawn sample + ONE
        priority write-back (target sync happens inside the steps), to
        the end of the body. -> the last step's metrics; the host step
        count is the caller's to advance."""
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
        dev = state.replay.tree.device
        mark_stage("diag", dev)
        metrics["diag"] = {**metrics["diag"],
                           **learn_obs.replay_health(
                               self.replay, state.replay, idx_k, pri_k)}
        # td_parts[j] pairs with idx_k[j] (chunk order)
        mark_stage("writeback", dev)
        self.replay.update_state(state.replay, idx_k.reshape(k * b),
                                 torch.cat(td_parts))
        mark_stage("end", dev)
        return metrics

    def _step_body_k(self, state: TrainState, k: int,
                     noise: torch.Tensor) -> dict:
        """The body of one K-batch macro-step (captured on the card)."""
        return self._learn_stage(
            state, self._sample_stage(state.replay, k, noise), k)

    def _train_step_k(self, state: TrainState, k: int,
                      noise: torch.Tensor | None = None):
        """K grad-steps from ONE stratified sample + ONE priority
        write-back (the K-batch relaxation): chunk j+1 trains on
        priorities that predate chunk j's TD errors."""
        noise = self._draw(state, k * self._per_draw(), noise)
        metrics = self._run(
            ("k", k), lambda lrn, s, u: lrn._step_body_k(s, k, u), state,
            noise)
        state.step += k
        return state, metrics

    # -- endpoints ------------------------------------------------------------

    def train_step(self, state: TrainState,
                   noise: torch.Tensor | None = None):
        """One exact grad-step. `noise` ([batch_size] uniform) replaces
        the generator's stratification draw (tests feed JAX's). On the
        card it replays a captured graph (runtime/step_graph.py)."""
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
        return self._sample_dispatch(state.replay, k, noise,
                                     state.generator)

    def learn_k(self, state: TrainState, sample, k: int):
        """LEARN dispatch: K SGD steps + one write-back on a sample drawn
        earlier by `sample_k`, possibly against a tree that an `add` or
        a write-back has changed since (the accepted one-dispatch
        staleness). It draws nothing."""
        metrics = self._learn_stage(state, sample, k)
        state.step += k
        return state, metrics

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

    # -- the tiered cold store's endpoints (runtime/driver.py) --------------

    def evict_region(self, state: TrainState, block: int):
        """-> (start, staging-layout items, stored leaf priorities) of
        the ring's lowest-priority-mass `block`-unit region, on the
        device (fresh tensors: the caller fetches them before `add_at`
        overwrites the region)."""
        return self._evict_body(state, block)

    def add_at(self, state: TrainState, items: Any, td_abs: torch.Tensor,
               start) -> TrainState:
        """Directed ingest add: overwrite the evict_region start instead
        of the FIFO cursor (cold tier on and the ring full)."""
        self.replay.add_at(state.replay, items, td_abs, start)
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

    def _make_batch(self, items: dict) -> TransitionBatch:
        return TransitionBatch(
            obs=items["obs"], actions=items["action"],
            rewards=items["reward"], next_obs=items["next_obs"],
            discounts=items["discount"])
