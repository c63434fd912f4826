"""The dp-sharded learner: dp replay shards, each sampled and updated on
its own, one gradient over the whole batch.

Counterpart of ``ape_x_dqn_tpu/parallel/dist_learner.py``. The layout
is the original's `DistTrainState`: every replay tensor carries a
leading [dp] axis (storage [dp, cap_shard, ...], tree [dp, 2*cap_shard],
cursor and fill [dp]; replay/prioritized.py: `ShardedReplayState`), with
one set of params and one Adam state. The shards live stacked on one
card (parallel/mesh.py): the semantics below do not depend on how many
cards hold them. A one-process mesh over several cards runs one such
learner per card group, each with its rows' shards on its owner and an
in-process exchange among the groups (parallel/cards.py), with the
same arithmetic as the multi-process form below.

Across processes (the multi-host learner, runtime/multihost_driver.py):
a learner built with a `GradExchange` (parallel/multihost.py) holds
only its process's dp_local = dp / nproc contiguous shards, rows
[row_start, row_stop) of the global mesh, on its own card, and does
explicitly what GSPMD inserts into the original's step
(``ape_x_dqn_tpu/parallel/dist_learner.py``):
- the batch is still [dp * b_local] globally: each process computes the
  loss over its [dp_local * b_local] rows with its own IS max M_p and
  its gradient g_p; ONE exchange per SGD step carries M_p * g_p, M_p *
  loss_p, the local |TD| and Q means and M_p, and every process forms
  the exact global gradient (1/(M * nproc)) * sum_p M_p * g_p with
  M = max_p M_p (the IS max over the whole training batch; the global
  fill N cancels out of w / max w), the global loss likewise and the
  means' average, summed in rank order, so every process applies the
  same update to the same params. A single-card learner and a dist
  learner without an exchange run exactly as before;
- the noise: each process draws the full [dp, n] from its (identically
  seeded) generator and keeps its rows, so the processes replay the
  one-process stream;
- the priority write-back, the target sync (keyed on Adam's count, the
  same everywhere) and ingest stay per process.
The exchanged bodies are generators that yield at each exchange, one
code path for both of the exchange's modes (parallel/multihost.py). On
the card, with every rank alone on its card (NCCL on the device), an
exchanged macro-step is ONE captured graph with its collectives inside
(runtime/step_graph.py: `ExchangedStep`); with ranks that share a card
(gloo through the host) it is a `SegmentedStep`, captured segments
around the host collective.

What the original does, here as well:
- each shard draws batch/dp stratified samples from its own sum-tree
  (one descent for all shards, ops/sum_tree.py, and one gather-kernel
  launch per packed leaf and draw over the shard-major flat view);
- a draw's IS weight is (N_global * p/dp)^-beta with p the probability
  within its shard and N_global the sum of the shard fills, times the
  per-shard valid mask, max-normalized per TRAINING BATCH over all
  shards;
- the loss runs on the batch flattened shard-major, [dp*b_local]: its
  batch mean is the original's gradient psum;
- the priorities write back per shard; the K-batch relaxation chunks
  [dp, b_local*k] -> [k, dp, b_local] (chunk j takes strata {j, j+k,
  ...} within every shard) and inverts it on the write-back;
- ingest adds equal [dp, chunk] blocks to every shard in lockstep
  (`add`, `add_many`: the driver round-robins staging units across the
  shards); the cold tier's swap runs per shard (`evict_region`,
  `add_at`).

As in the single-card learners (runtime/learner.py), the stratification
noise ([dp, n] per draw, one generator) is drawn before each step body,
every endpoint writes its state IN PLACE, and on the card `train_step`,
`train_step_k` (so `train_many`), the ingest add and the eviction swap
replay captured CUDA graphs (runtime/step_graph.py; with an exchange,
one graph or segments, as above); `sample_k` and `learn_k` stay
eager. `tp` splits no layer on one card (a column split
changes no number); `param_specs` holds what it splits across cards
(parallel/sharding.py, parallel/tensor_parallel.py).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch import nn

from ape_x_dqn_tpu_torch.obs import learning as learn_obs
from ape_x_dqn_tpu_torch.obs.stages import mark_stage
from ape_x_dqn_tpu_torch.ops.losses import (TransitionBatch, make_dqn_loss,
                                            make_r2d2_loss)
from ape_x_dqn_tpu_torch.parallel.mesh import Mesh
from ape_x_dqn_tpu_torch.parallel.multihost import GradExchange, process_rows
from ape_x_dqn_tpu_torch.parallel.sharding import make_param_shardings
from ape_x_dqn_tpu_torch.replay.sequence import batch_to_sequence_batch
from ape_x_dqn_tpu_torch.runtime.learner import (ClipAdam,
                                                 SingleChipLearner,
                                                 TrainState, make_optimizer)
from ape_x_dqn_tpu_torch.runtime.step_graph import drive


@dataclass
class DistTrainState(TrainState):
    """A `TrainState` whose replay is a `ShardedReplayState` ([dp]
    leading axis on every replay tensor). The original keeps [dp] RNG
    keys; here one generator draws the [dp, n] noise of a draw."""


class _DistLearnerBase(SingleChipLearner):
    """Shared (dp, tp) machinery; subclasses set `loss_fn` and
    `_make_batch(flattened items) -> loss batch`. `replay` is configured
    with the PER-SHARD capacity. With an `exchange`, `mesh` is this
    process's dp_local x tp rows and the global dp is dp_local x the
    process count (module docstring); the card groups of a one-process
    mesh over several cards (parallel/cards.py) pass their own `rows`
    and an in-process exchange among the groups."""

    shard_dims = 1

    def __init__(self, replay, lcfg, mesh: Mesh,
                 optimizer: ClipAdam | None = None,
                 exchange: GradExchange | None = None,
                 rows: list[int] | None = None):
        self.replay = replay
        self.lcfg = lcfg
        self.mesh = mesh
        self.exchange = exchange
        self.nproc = exchange.nproc if exchange is not None else 1
        self.dp_local = mesh.dp
        self.dp = mesh.dp * self.nproc
        if rows is None:
            self.row_start, self.row_stop = (
                process_rows(self.dp) if exchange is not None
                else (0, self.dp))
            rows = range(self.row_start, self.row_stop)
        self.rows = list(rows)
        assert len(self.rows) == self.dp_local
        assert lcfg.batch_size % self.dp == 0, \
            "batch_size must divide by dp"
        self.b_local = lcfg.batch_size // self.dp
        self.optimizer = optimizer or make_optimizer(lcfg)
        self.param_specs: dict[str, tuple] = {}

    def _make_batch(self, items: dict):
        raise NotImplementedError

    # -- state --------------------------------------------------------------

    def init(self, net: nn.Module, item_spec: Any,
             generator: torch.Generator) -> DistTrainState:
        """Params from `net` (on the mesh's card), a target copy, Adam,
        and dp empty replay shards (`item_spec`: one item; None for the
        frame ring, whose geometry fixes it)."""
        target = copy.deepcopy(net)
        target.requires_grad_(False)
        if not self.param_specs:
            # (a card group's are the whole net's, set before its net
            # was split: parallel/cards.py)
            self.param_specs = make_param_shardings(net, self.mesh)
        return DistTrainState(
            net=net, target_net=target,
            opt_state=self.optimizer.init(list(net.parameters())),
            replay=self.replay.init_sharded(self.dp_local, item_spec),
            generator=generator, step=0)

    # -- the step -----------------------------------------------------------

    def _per_draw(self) -> int:
        return self.b_local

    def _draw(self, state, batch: int,
              noise: torch.Tensor | None) -> torch.Tensor:
        """One draw's [dp_local, batch] noise: with an exchange, rows
        [row_start, row_stop) of the full [dp, batch] draw every process
        makes from its identically seeded generator."""
        if noise is not None or self.exchange is None:
            return super()._draw(state, batch, noise)
        full = torch.rand((self.dp, batch), generator=state.generator,
                          device=self.replay.device)
        return full[self.row_start:self.row_stop]

    def _sample_weighted(self, replay_state, noise: torch.Tensor,
                         n: int):
        """Per-shard stratified sample of n items + global IS weights
        over the [dp, n] pool: a draw lands in each shard with
        probability 1/dp (every shard contributes exactly n draws) and
        within shard d on item i with probs = p_i/m_d, so P(i) = probs/dp
        exactly, even with skewed shard masses. Dead frame-ring pad
        slots train with weight 0. -> (items [dp, n, ...], idx [dp, n],
        w [dp, n] NOT yet max-normalized)."""
        mark_stage("sample", replay_state.tree.device)
        items, idx, probs = self.replay.sample_items(replay_state, n, noise)
        # across processes the lockstep adds keep every process's fill
        # equal, so this process's sum times nproc is the global fill
        # (and N cancels out of w / max w in any case)
        n_global = torch.clamp(
            replay_state.size_dev.to(torch.float32).sum() * self.nproc,
            min=1.0)
        w = (n_global * torch.clamp(probs / self.dp, min=1e-12)) \
            ** (-self.replay.beta)
        w = w * self.replay.valid_mask(replay_state, idx)
        return items, idx, w

    def _flat(self, x: torch.Tensor) -> torch.Tensor:
        """[dp, b, ...] -> [dp*b, ...], shard-major."""
        return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])

    def _sgd_step(self, state: DistTrainState, items: dict,
                  w: torch.Tensor):
        """One loss/grad/optimizer/target-sync update on an
        already-sampled [dp, b_local] batch, in place. `w` is the raw IS
        weight, max-normalized here over exactly this training batch.
        -> (td_shard [dp, b_local], metrics)."""
        mark_stage("loss", w.device)
        w = w / torch.clamp(w.max(), min=1e-12)
        batch = self._make_batch({k: self._flat(v) for k, v in items.items()})
        wf = self._flat(w)
        loss, aux = self.loss_fn(state.net, state.target_net, batch, wf)
        grads, updates, params = self._optimize(state, loss)
        mark_stage("diag", w.device)
        td_shard = aux["td_abs"].reshape(self.dp_local, self.b_local)
        metrics = {"loss": loss.detach(), "q_mean": aux["q_mean"],
                   "td_abs_mean": aux["td_abs"].mean(),
                   "grad_norm": learn_obs.global_norm(grads),
                   "diag": self._diag(aux, wf, td_shard, grads, updates,
                                      params)}
        return td_shard, metrics

    def _diag(self, aux, wf, td_shard, grads, updates, params) -> dict:
        diag = learn_obs.sgd_diag(aux, wf, grads, updates, params)
        # the per-shard mean-|TD| bounds expose shard skew the global
        # mean would average away (across processes: this process's)
        shard_means = td_shard.mean(dim=1)
        diag["shard_td_mean_min"] = shard_means.min()
        diag["shard_td_mean_max"] = shard_means.max()
        return diag

    def _sgd_step_exchanged(self, state: DistTrainState, items: dict,
                            w: torch.Tensor):
        """`_sgd_step` across processes, as a generator: this process's
        loss and gradient under its own IS max M_p, ONE exchange (yield
        the packed [grads * M_p, loss * M_p, |TD| mean, Q mean, M_p],
        receive every process's), then the exact global gradient,
        loss and means and the update (module docstring). -> (td_shard,
        metrics)."""
        mark_stage("loss", w.device)
        m_p = torch.clamp(w.max(), min=1e-12)
        batch = self._make_batch({k: self._flat(v) for k, v in items.items()})
        wf = self._flat(w / m_p)
        loss, aux = self.loss_fn(state.net, state.target_net, batch, wf)
        params = list(state.net.parameters())
        mark_stage("backward", w.device)
        grads = torch.autograd.grad(loss, params)
        mark_stage("exchange", w.device)
        td_mean = aux["td_abs"].mean()
        # on the owner: the pieces of a net split across cards come
        # over (parallel/tensor_parallel.py), and go back below
        send = torch.cat([
            torch.cat([g.reshape(-1).to(m_p.device) for g in grads]) * m_p,
            torch.stack([loss.detach() * m_p, td_mean.float(),
                         aux["q_mean"].float(), m_p])])
        recv = yield send
        m = recv[:, -1].max()
        total = recv.sum(dim=0)         # rank order, alike everywhere
        scale = 1.0 / (m * self.nproc)
        flat = total[:-4] * scale
        grads = [v.view_as(p).to(p.device) for v, p in
                 zip(flat.split([p.numel() for p in params]), params)]
        updates, params = self._apply_grads(state, grads)
        mark_stage("diag", w.device)
        td_shard = aux["td_abs"].reshape(self.dp_local, self.b_local)
        metrics = {"loss": total[-4] * scale,
                   "q_mean": total[-2] / self.nproc,
                   "td_abs_mean": total[-3] / self.nproc,
                   "grad_norm": learn_obs.global_norm(grads),
                   "diag": self._diag(aux, wf, td_shard, grads, updates,
                                      params)}
        return td_shard, metrics

    def _step_body(self, state: DistTrainState,
                   noise: torch.Tensor) -> dict:
        """One exact grad-step (captured on the card): draw, update,
        per-shard write-back. With an exchange, a generator
        (`_sgd_step_exchanged`)."""
        if self.exchange is not None:
            return self._step_body_exchanged(state, noise)
        items, idx, w = self._sample_weighted(state.replay, noise,
                                              self.b_local)
        td_shard, metrics = self._sgd_step(state, items, w)
        # draw and write-back see the same shard trees: staleness is 0
        return self._write_back_step(state, idx, td_shard, metrics)

    def _step_body_exchanged(self, state: DistTrainState,
                             noise: torch.Tensor):
        items, idx, w = self._sample_weighted(state.replay, noise,
                                              self.b_local)
        td_shard, metrics = yield from self._sgd_step_exchanged(
            state, items, w)
        return self._write_back_step(state, idx, td_shard, metrics)

    def _write_back_step(self, state: DistTrainState, idx, td_shard,
                         metrics: dict) -> dict:
        """The end of an exact step: replay health, the per-shard
        write-back."""
        dev = state.replay.tree.device
        mark_stage("diag", dev)
        metrics["diag"] = {**metrics["diag"],
                           **learn_obs.replay_health_sharded(
                               self.replay, state.replay, idx, None)}
        mark_stage("writeback", dev)
        self.replay.update_priorities(state.replay, idx, td_shard)
        mark_stage("end", dev)
        return metrics

    def _sample_stage(self, replay_state, k: int,
                      noise: torch.Tensor | None = None,
                      generator: torch.Generator | None = None):
        """SAMPLE stage of the K-batch cycle: one per-shard stratified
        K*b_local descent + gather + global IS weights, chunked for the
        K SGD steps. -> (items_k [K, dp, b_local, ...], idx [dp,
        K*b_local] unchunked for the per-shard write-back, w_k [K, dp,
        b_local] raw, pri [dp, K*b_local] descent-time priorities)."""
        n = k * self.b_local
        if noise is None:
            noise = self.replay.draw(replay_state, n, generator)
        items, idx, w = self._sample_weighted(replay_state, noise, n)
        pri = self.replay.leaf_priorities(replay_state, idx)

        # [dp, b_local*k, ...] -> [k, dp, b_local, ...]: chunk j takes
        # strata {j, j+k, ...} of every shard (stratum i*k + j at [j, :, i])
        def chunked(x):
            y = x.reshape(x.shape[0], self.b_local, k, *x.shape[2:])
            return torch.movedim(y, 2, 0)

        return ({key: chunked(v) for key, v in items.items()}, idx,
                chunked(w), pri)

    def _learn_stage(self, state: DistTrainState, sample, k: int) -> dict:
        """LEARN stage: K SGD steps over an already-drawn sample + ONE
        per-shard write-back. -> the last step's metrics (with an
        exchange, a generator that returns them)."""
        if self.exchange is not None:
            return self._learn_stage_exchanged(state, sample, k)
        items_k, idx, w_k, pri_k = sample
        td_parts = []
        metrics = None
        for j in range(k):
            td_shard, metrics = self._sgd_step(
                state, {key: v[j] for key, v in items_k.items()}, w_k[j])
            td_parts.append(td_shard)
        return self._write_back(state, idx, pri_k, td_parts, metrics, k)

    def _learn_stage_exchanged(self, state: DistTrainState, sample,
                               k: int):
        items_k, idx, w_k, pri_k = sample
        td_parts = []
        metrics = None
        for j in range(k):
            td_shard, metrics = yield from self._sgd_step_exchanged(
                state, {key: v[j] for key, v in items_k.items()}, w_k[j])
            td_parts.append(td_shard)
        return self._write_back(state, idx, pri_k, td_parts, metrics, k)

    def _write_back(self, state: DistTrainState, idx, pri_k, td_parts,
                    metrics: dict, k: int) -> dict:
        # write-back-time replay health: the shard trees now vs pri_k
        dev = state.replay.tree.device
        mark_stage("diag", dev)
        metrics["diag"] = {**metrics["diag"],
                           **learn_obs.replay_health_sharded(
                               self.replay, state.replay, idx, pri_k)}
        # invert the chunking: td_all[d, i*k + j] = td_parts[j][d, i]
        mark_stage("writeback", dev)
        td_all = torch.movedim(torch.stack(td_parts), 0, 2).reshape(
            self.dp_local, k * self.b_local)
        self.replay.update_priorities(state.replay, idx, td_all)
        mark_stage("end", dev)
        return metrics

    def sample_k(self, state: DistTrainState, k: int,
                 noise: torch.Tensor | None = None):
        """SAMPLE dispatch of the double-buffered pipeline (see
        `SingleChipLearner.sample_k`), its noise from `_draw`."""
        return self._sample_dispatch(
            state.replay, k, self._draw(state, k * self.b_local, noise))

    def learn_k(self, state: DistTrainState, sample, k: int):
        """LEARN dispatch (see `SingleChipLearner.learn_k`); with an
        exchange its K SGD steps run eagerly, each with its exchange."""
        if self.exchange is None:
            return super().learn_k(state, sample, k)
        metrics = drive(self._learn_stage(state, sample, k), self.exchange)
        state.step += k
        return state, metrics

    # -- ingest and the cold tier's swap ------------------------------------

    def add(self, state: DistTrainState, items: Any,
            td_abs: torch.Tensor) -> DistTrainState:
        """items {key: [dp, B, ...]}, td_abs [dp, B]: one lockstep write
        for every shard."""
        self.replay.add_lockstep(state.replay, items, td_abs)
        return state

    def add_many(self, state: DistTrainState, items: Any,
                 td_abs: torch.Tensor) -> DistTrainState:
        """Coalesced ingest: items [g, dp, B, ...], td_abs [g, dp, B] —
        g lockstep adds in order."""
        for j in range(td_abs.shape[0]):
            self.replay.add_lockstep(
                state.replay, {k: v[j] for k, v in items.items()},
                td_abs[j])
        return state

    def add_at(self, state: DistTrainState, items: Any,
               td_abs: torch.Tensor, start) -> DistTrainState:
        """Directed add: shard d overwrites its `evict_region` start[d]
        (the cold tier on and the ring full)."""
        self.replay.add_at_lockstep(state.replay, items, td_abs, start)
        return state

    # `evict_region` (inherited) plans and reads per shard: -> (start
    # [dp], items [dp, block, ...], priorities [dp, block, ...])

    # -- per-shard observability -------------------------------------------

    def shard_stats(self, state: DistTrainState) -> dict:
        """Per-shard replay fill and mass (the original's keys): sizes
        (the replay's item units), live (frame-ring pads excluded), fill
        (sizes / per-shard capacity), tree_mass (each shard's sum-tree
        root, the stratified sampler's denominator), fill_min/_max; and
        tp_split_params, the parameters a tp split would divide. Reads
        the device: call off the hot loop."""
        rs = state.replay
        sizes = np.asarray(rs.size, np.int64).reshape(-1)
        live = sizes
        if hasattr(self.replay, "live_transitions"):
            live = self.replay.live_transitions(rs).cpu().numpy() \
                .reshape(-1).astype(np.int64)
        cap = float(max(int(self.replay.capacity), 1))
        mass = rs.tree[:, 1].double().cpu().numpy()
        fill = sizes / cap
        return {
            "sizes": sizes.tolist(),
            "live": live.tolist(),
            "fill": [round(float(f), 6) for f in fill],
            "tree_mass": [round(float(m), 4) for m in mass],
            "fill_min": float(fill.min()),
            "fill_max": float(fill.max()),
            "tp_split_params": sorted(
                p for p, spec in self.param_specs.items() if "tp" in spec),
        }


class DistDQNLearner(_DistLearnerBase):
    """Flat n-step double-DQN over the mesh (flat or frame-ring shards)."""

    def __init__(self, replay, lcfg, mesh: Mesh,
                 optimizer: ClipAdam | None = None,
                 exchange: GradExchange | None = None,
                 rows: list[int] | None = None):
        super().__init__(replay, lcfg, mesh, optimizer, exchange, rows)
        self.loss_fn = make_dqn_loss(
            double=lcfg.double_dqn, huber_delta=lcfg.huber_delta,
            rescale=lcfg.value_rescale)

    def _make_batch(self, items: dict) -> TransitionBatch:
        return TransitionBatch(
            obs=items["obs"], actions=items["action"],
            rewards=items["reward"], next_obs=items["next_obs"],
            discounts=items["discount"])


class DistSequenceLearner(_DistLearnerBase):
    """R2D2 stored-state sequences over the mesh: shards hold whole
    sequences as items; the burn-in unroll and the n-step sequence loss
    run on the flattened [dp*b_local] sequence batch (the LSTM's time
    axis stays whole), and the per-sequence eta-mixed |TD| writes back
    per shard."""

    def __init__(self, replay, lcfg, rcfg, mesh: Mesh,
                 optimizer: ClipAdam | None = None,
                 exchange: GradExchange | None = None,
                 rows: list[int] | None = None):
        super().__init__(replay, lcfg, mesh, optimizer, exchange, rows)
        self.loss_fn = make_r2d2_loss(
            burn_in=rcfg.burn_in, n_step=lcfg.n_step, gamma=lcfg.gamma,
            huber_delta=lcfg.huber_delta, double=lcfg.double_dqn,
            rescale=lcfg.value_rescale, priority_eta=rcfg.priority_eta)

    def _make_batch(self, items: dict):
        return batch_to_sequence_batch(items)
