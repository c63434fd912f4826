"""R2D2 sequence learner: sample -> unroll -> update -> priorities.

Counterpart of ``ape_x_dqn_tpu/runtime/sequence_learner.py``: sequences
with stored LSTM state are items of the flat prioritized replay
(replay/sequence.py), and `SequenceLearner` inherits every step,
K-batch, prefetch, train_many and add path from `SingleChipLearner`
(runtime/learner.py). Only the sequence-batch construction and the R2D2
loss live here, so the K-batch semantics cannot drift from the flat
learner's. Like that learner it runs eagerly and updates its state in
place; the LSTM unrolls are Python loops over time (models/lstm_q.py).
"""

from __future__ import annotations

import torch

from ape_x_dqn_tpu_torch.obs import learning as learn_obs
from ape_x_dqn_tpu_torch.ops.losses import make_r2d2_loss
from ape_x_dqn_tpu_torch.replay.sequence import batch_to_sequence_batch
from ape_x_dqn_tpu_torch.runtime.learner import (ClipAdam,
                                                 SingleChipLearner,
                                                 TrainState, make_optimizer)


class SequenceLearner(SingleChipLearner):
    """The R2D2 learner over sequence items (`sequence_item_spec`)."""

    def __init__(self, replay, lcfg, rcfg,
                 optimizer: ClipAdam | None = None):
        """rcfg: the ReplayConfig (burn_in, priority_eta)."""
        self.replay = replay
        self.lcfg = lcfg
        self.optimizer = optimizer or make_optimizer(lcfg)
        self.loss_fn = make_r2d2_loss(
            burn_in=rcfg.burn_in, n_step=lcfg.n_step, gamma=lcfg.gamma,
            huber_delta=lcfg.huber_delta, double=lcfg.double_dqn,
            rescale=lcfg.value_rescale, priority_eta=rcfg.priority_eta)

    def _sgd_step(self, state: TrainState, items: dict,
                  is_w: torch.Tensor):
        """One unroll/loss/optimizer/target-sync update on an already-
        sampled sequence batch, in place on `state`. -> (the eta-mixed
        per-sequence |TD| priorities, metrics)."""
        batch = batch_to_sequence_batch(items)
        loss, aux = self.loss_fn(state.net, state.target_net, batch, is_w)
        grads, updates, params = self._optimize(state, loss)
        metrics = {
            "loss": loss.detach(),
            "q_mean": aux["q_mean"],
            "td_abs_mean": aux["td_abs"].mean(),
            "valid_frac": aux["valid_frac"],
            "grad_norm": learn_obs.global_norm(grads),
            # td quantiles here are over the eta-mixed per-sequence
            # priorities (the write-back signal)
            "diag": learn_obs.sgd_diag(aux, is_w, grads, updates, params),
        }
        return aux["td_abs"], metrics
