"""Learning-health diagnostics computed on the device inside the
learner step: the ``metrics["diag"]`` dict.

Counterpart of `sgd_diag` and `replay_health` in
``ape_x_dqn_tpu/obs/learning.py`` (the host-side publication and the
LearnMonitor wait for the driver slice). Everything is a reduction over
tensors the step already holds, returned as 0-dim float32 device
tensors: the host reads them only where it already synchronises, and
nothing here copies host data to the device (which would wait for it).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def percentiles(x: torch.Tensor, ps: Sequence[float]) -> list:
    """``jnp.percentile(x, ps)`` with its default linear interpolation
    (the same as ``torch.quantile``'s), from one sort; the positions
    are computed on the host in float32, as JAX computes them."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    out = []
    for p in ps:
        pos = np.float32(p) / np.float32(100.0) * np.float32(n - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        hw = float(pos - np.float32(lo))
        out.append(s[lo] * (1.0 - hw) + s[hi] * hw)
    return out


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax's
    ``global_norm``)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


def sgd_diag(aux: dict, is_w: torch.Tensor, grads, updates,
             params) -> dict:
    """Per-SGD-step diagnostics. `aux` is the loss aux (ops/losses.py),
    `is_w` the IS weights applied, `grads`/`updates`/`params` the
    optimizer triple (params after the update)."""
    td = aux["td_abs"].float().reshape(-1)
    qs = percentiles(td, (50.0, 90.0, 99.0))
    w = is_w.float().reshape(-1)
    # Kish effective sample size as a fraction of the batch
    ess = w.sum() ** 2 / (w.numel() * torch.clamp((w * w).sum(), min=1e-12))
    pn = global_norm(params)
    zero = torch.zeros((), device=td.device)
    return {
        "td_abs_p50": qs[0],
        "td_abs_p90": qs[1],
        "td_abs_p99": qs[2],
        "td_signed_mean": aux.get("td_mean", zero),
        "q_mean": aux.get("q_mean", zero),
        "q_max": aux.get("q_max", zero),
        "target_q_mean": aux.get("target_q_mean", zero),
        "q_gap": aux.get("q_gap", zero),
        "grad_norm": global_norm(grads),
        "update_ratio": global_norm(updates) / torch.clamp(pn, min=1e-12),
        "is_ess_frac": ess,
    }


def replay_health(replay, rs, idx: torch.Tensor,
                  pri_then: torch.Tensor | None) -> dict:
    """Replay-side diagnostics at write-back time, read BEFORE the
    write-back changes the tree.

    `idx` is any int tensor of sampled leaf indices; `pri_then` the
    matching priorities read at descent time (None where the draw and
    the write-back see the same tree: staleness is 0 there). Ages are
    ring distances from the write cursor in transitions."""
    cap = int(replay.capacity)
    idx = idx.reshape(-1)
    cursor = replay.cursor_transitions(rs)
    age = torch.remainder(cursor - 1 - idx, cap).float()
    ages = percentiles(age, (50.0, 90.0))
    out = {"sample_age_p50": ages[0], "sample_age_p90": ages[1]}
    zero = torch.zeros((), device=idx.device)
    if not getattr(replay, "has_priorities", True):
        out["prio_staleness_frac"] = zero
        out["priority_top_frac"] = zero
        return out
    if pri_then is None:
        out["prio_staleness_frac"] = zero
    else:
        then = pri_then.reshape(-1).float()
        now = replay.leaf_priorities(rs, idx)
        out["prio_staleness_frac"] = (now - then).abs().mean() \
            / torch.clamp(then.mean(), min=1e-12)
    out["priority_top_frac"] = rs.tree[cap:].max() \
        / torch.clamp(rs.tree[1], min=1e-12)
    return out
