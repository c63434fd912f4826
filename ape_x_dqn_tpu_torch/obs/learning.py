"""Learning-health diagnostics computed on the device inside the
learner step: the ``metrics["diag"]`` dict.

Counterpart of ``ape_x_dqn_tpu/obs/learning.py``. `sgd_diag` and
`replay_health` run inside the step bodies: everything is a reduction
over tensors the step already holds, returned as 0-dim float32 device
tensors that ride the graph's packed metrics vector. The host reads
them only at the publish cadence, where the driver already fetches its
logged metrics (one copy for all of them), and nothing here copies host
data to the device (which would wait for it).

The host half is a copy of the original's: `publish_learn` (one
literal `learn_*` gauge per diagnostic, and `learn/<tenant>/...`
duplicates) and `LearnMonitor`, the warn-only anomaly engine (a loss
spike against its EWMA, Q blowup, ESS collapse, dead gradients,
priority collapse), which fires one attributed `learning_degradation`
event per (tenant, rule) cooldown and never raises.
"""

from __future__ import annotations

import logging
import time
from typing import Sequence

import numpy as np
import torch

from ape_x_dqn_tpu_torch.obs.health import make_lock

# Absolute-threshold rule bounds. These are deliberately loose — the
# monitor flags pathology (divergence, collapse), not suboptimality —
# and each is mirrored by the matching healthy-range row in
# obs/report.py INSTRUMENTS so the offline report flags the same line
# the online monitor fires on.
Q_MAX_LIMIT = 1e3          # |q_max| above this = Q blowup (catch/atari
#                            Qs live in clipped-reward units, O(1..100))
ESS_FRAC_MIN = 0.05        # IS effective-sample-size below 5% of batch
UPDATE_RATIO_MIN = 1e-9    # ||update||/||param|| below this = dead grads
TOP_FRAC_MAX = 0.5         # one transition holding half the priority mass


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
    ``global_norm``), on the first tensor's device (a net column-split
    across cards holds pieces on several)."""
    dev = tensors[0].device
    return torch.sqrt(sum((t.float() * t.float()).sum().to(dev)
                          for t in tensors))


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


def replay_health_sharded(replay, rs, idx: torch.Tensor,
                          pri_then: torch.Tensor | None) -> dict:
    """`replay_health` for the dist learner's stacked shard states
    (`replay` is the per-shard replay; `idx` is [dp, n]): the ages from
    each shard's own cursor, every reduction over all shards (the
    original's GSPMD psum), the top leaf's share of the global mass."""
    cap = int(replay.capacity)
    cursor = replay.cursor_transitions(rs)                  # [dp]
    age = torch.remainder(cursor[:, None] - 1 - idx, cap).float()
    ages = percentiles(age.reshape(-1), (50.0, 90.0))
    out = {"sample_age_p50": ages[0], "sample_age_p90": ages[1]}
    zero = torch.zeros((), device=idx.device)
    if not getattr(replay, "has_priorities", True):
        out["prio_staleness_frac"] = zero
        out["priority_top_frac"] = zero
        return out
    if pri_then is None:
        out["prio_staleness_frac"] = zero
    else:
        then = pri_then.float()
        now = replay.leaf_priorities(rs, idx)
        out["prio_staleness_frac"] = (now - then).abs().mean() \
            / torch.clamp(then.mean(), min=1e-12)
    leaves = rs.tree[:, cap:]
    mass = rs.tree[:, 1].sum()
    out["priority_top_frac"] = leaves.max() / torch.clamp(mass, min=1e-12)
    return out


# -- host-side publication -------------------------------------------------

def publish_learn(obs, vals: dict, tenant: str = "") -> None:
    """Publish one host-read diag snapshot as `learn_*` gauges.

    One LITERAL emission per instrument (each has its obs/report.py
    INSTRUMENTS row); the per-tenant duplicates ride dynamic
    slash-prefixed keys, which the registry namespaces and the report
    regroups per game."""
    g = vals.get
    obs.gauge("learn_td_abs_p50", g("td_abs_p50", 0.0))
    obs.gauge("learn_td_abs_p90", g("td_abs_p90", 0.0))
    obs.gauge("learn_td_abs_p99", g("td_abs_p99", 0.0))
    obs.gauge("learn_td_signed_mean", g("td_signed_mean", 0.0))
    obs.gauge("learn_q_mean", g("q_mean", 0.0))
    obs.gauge("learn_q_max", g("q_max", 0.0))
    obs.gauge("learn_target_q_mean", g("target_q_mean", 0.0))
    obs.gauge("learn_q_gap", g("q_gap", 0.0))
    obs.gauge("learn_grad_norm", g("grad_norm", 0.0))
    obs.gauge("learn_update_ratio", g("update_ratio", 0.0))
    obs.gauge("learn_is_ess_frac", g("is_ess_frac", 1.0))
    obs.gauge("learn_priority_top_frac", g("priority_top_frac", 0.0))
    obs.gauge("learn_sample_age_p50", g("sample_age_p50", 0.0))
    obs.gauge("learn_sample_age_p90", g("sample_age_p90", 0.0))
    obs.gauge("learn_prio_staleness_frac", g("prio_staleness_frac", 0.0))
    if "shard_td_mean_min" in vals:  # dist learner only
        obs.gauge("learn_shard_td_mean_min", vals["shard_td_mean_min"])
        obs.gauge("learn_shard_td_mean_max", vals["shard_td_mean_max"])
    if tenant:
        for k, v in vals.items():
            obs.gauge(f"learn/{tenant}/{k}", v)


# -- the anomaly engine ----------------------------------------------------

class LearnMonitor:
    """Warn-only learning-anomaly engine (PerfMonitor's sibling).

    One EWMA baseline per tenant over the loss (relative rule: spike =
    loss > spike_mult x baseline after min_samples) plus four absolute
    rules over the diagnostics. Each (tenant, rule) fires at most once
    per cooldown; a fire is a counter bump + one attributed JSONL event
    — never an exception. Like PerfMonitor, the baseline keeps
    absorbing the new regime, so a persistently sick learner alerts
    once per cooldown and then becomes the new normal in the EWMA while
    the absolute rules (and the report's healthy ranges) keep flagging.
    """

    def __init__(self, obs, metrics, spike_mult: float = 10.0,
                 alpha: float = 0.2, min_samples: int = 8,
                 cooldown_s: float = 30.0):
        self._obs = obs
        self._metrics = metrics
        self.spike_mult = spike_mult
        self._alpha = alpha
        self._min_samples = min_samples
        self._cooldown_s = cooldown_s
        self._lock = make_lock("learning.learn_monitor")
        self._loss: dict[str, dict] = {}        # guarded-by: _lock
        self._last_fire: dict[tuple, float] = {}  # guarded-by: _lock
        # fire listeners (the remediation plane subscribes here):
        # called OUTSIDE the monitor lock, once per emitted event, with
        # (rule, value, baseline, step, tenant). Append-only at wiring
        # time, so iteration is safe without the lock.
        self._listeners: list = []

    def add_listener(self, cb) -> None:
        self._listeners.append(cb)

    def observe(self, vals: dict, loss: float, step: int = 0,
                tenant: str = "") -> None:
        loss = float(loss)
        fires: list[tuple[str, float, float]] = []
        now = time.monotonic()
        with self._lock:
            if loss == loss:  # NaN losses skip the EWMA, not the rules
                s = self._loss.setdefault(tenant, {"ewma": loss, "n": 0})
                baseline = s["ewma"]
                if (s["n"] >= self._min_samples and baseline > 0.0
                        and loss > self.spike_mult * baseline):
                    fires.append(("loss_spike", loss, baseline))
                s["ewma"] = (1 - self._alpha) * baseline \
                    + self._alpha * loss
                s["n"] += 1
            for rule, value, bad in (
                ("q_blowup", vals.get("q_max"),
                 lambda v: abs(v) > Q_MAX_LIMIT),
                ("ess_collapse", vals.get("is_ess_frac"),
                 lambda v: v < ESS_FRAC_MIN),
                ("dead_gradients", vals.get("update_ratio"),
                 lambda v: v < UPDATE_RATIO_MIN),
                ("priority_collapse", vals.get("priority_top_frac"),
                 lambda v: v > TOP_FRAC_MAX),
            ):
                if value is None:
                    continue
                value = float(value)
                if value == value and bad(value):
                    fires.append((rule, value, 0.0))
            fires = [f for f in fires
                     if now - self._last_fire.get(
                         (tenant, f[0]), float("-inf"))
                     >= self._cooldown_s]
            for rule, _, _ in fires:
                self._last_fire[(tenant, rule)] = now
        for rule, value, baseline in fires:
            self._obs.count("learning_degradations")
            self._metrics.log(
                step, learning_degradation=rule,
                learn_tenant=tenant or None,
                learn_value=round(value, 6),
                learn_baseline=round(baseline, 6))
            for cb in self._listeners:
                try:
                    cb(rule, value, baseline, step, tenant)
                except Exception:  # noqa: BLE001 - warn-only plane
                    logging.getLogger(__name__).warning(
                        "learning-degradation listener failed",
                        exc_info=True)
