"""The faults a training cell can have, planted in the port underneath
a run (``harness.run(..., patch=...)``): the tests see each turn
``correct`` false on the CPU, and ``calibrate.py --faults`` reads them on
the card at a cell's own size. Each takes the built program (an
adaptor's ``Program``) and breaks it in place."""

from __future__ import annotations

import torch


def _learners(prog) -> list:
    """The port's learners that run the SGD steps: a mesh over cards
    runs one per card group."""
    return list(getattr(prog.learner, "learners", [prog.learner]))


def unchanged(prog) -> None:
    """A step that returns its state unchanged: no update of the params,
    no moment, no count."""
    def apply_grads(state, grads):
        params = list(state.net.parameters())
        return ([torch.zeros_like(p) for p in params],
                [p.detach() for p in params])

    for lrn in _learners(prog):
        lrn._apply_grads = apply_grads


def half_batch(prog) -> None:
    """Half of each batch left out, the mean taken over the rest."""
    for lrn in _learners(prog):
        inner = lrn.loss_fn

        def loss_fn(net, target, batch, w, inner=inner):
            n = w.shape[0] // 2
            half = type(batch)(*[
                tuple(s[:n] for s in v) if isinstance(v, tuple) else v[:n]
                for v in batch])
            loss, aux = inner(net, target, half, w[:n])
            return loss, dict(aux, td_abs=torch.cat([aux["td_abs"]] * 2))

        lrn.loss_fn = loss_fn


def altered(prog) -> None:
    """An answer altered where it is produced: the |TD|s a step writes
    back, 1.5 times what it computed."""
    for lrn in _learners(prog):
        inner = lrn.loss_fn

        def loss_fn(net, target, batch, w, inner=inner):
            loss, aux = inner(net, target, batch, w)
            return loss, dict(aux, td_abs=aux["td_abs"] * 1.5)

        lrn.loss_fn = loss_fn


def no_exchange(prog) -> None:
    """The exchange between cards left out: every card group gets back
    its own vector in each group's place, so it steps on its own
    gradient alone."""
    exchange = prog.learner.exchange

    def gather(sends, outs):
        for out, s in zip(outs, sends):
            out.copy_(s.expand_as(out))

    exchange._gather = gather


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered, "no_exchange": no_exchange}
