"""The learning-health plane's host half (obs/learning.py:
`publish_learn` and `LearnMonitor`) against the JAX package's: one
seeded stream of diagnostic snapshots and losses on one fake clock
publishes the same `learn_*` gauges (and per-tenant duplicates) and
fires the same attributed `learning_degradation` events, counters and
listener calls, in the same order."""

from types import SimpleNamespace

import numpy as np
import pytest

from ape_x_dqn_tpu.obs import learning as jlearn
from ape_x_dqn_tpu_torch.obs import learning as tlearn


class Sink:
    def __init__(self):
        self.gauges, self.counts, self.events = [], [], []

    def gauge(self, name, value):
        self.gauges.append((name, float(value)))

    def count(self, name, n=1.0):
        self.counts.append((name, n))


def _stream(seed):
    """Diagnostics with a loss spike, a Q blowup, an ESS collapse, dead
    gradients and a priority collapse somewhere in them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):
        vals = {"td_abs_p50": float(rng.random()),
                "td_abs_p90": float(rng.random() + 1),
                "q_mean": float(rng.normal()),
                "q_max": 2e3 if i == 25 else float(rng.random() * 10),
                "is_ess_frac": 0.01 if i == 30 else 0.9,
                "update_ratio": 1e-12 if i in (31, 32) else 1e-4,
                "priority_top_frac": 0.9 if i == 35 else 0.01,
                "sample_age_p50": float(rng.integers(0, 1000))}
        loss = 50.0 if i == 20 else float(rng.random() * 0.1 + 0.05)
        if i == 28:
            loss = float("nan")
        out.append((vals, loss))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("tenant", ["", "pong"])
def test_the_same_stream_fires_the_same_events(monkeypatch, seed, tenant):
    results = []
    for mod in (jlearn, tlearn):
        now = {"t": 100.0}
        monkeypatch.setattr(mod.time, "monotonic", lambda: now["t"])
        sink, fires, logs = Sink(), [], []
        metrics = SimpleNamespace(
            log=lambda step, **kw: logs.append((step, kw)))
        mon = mod.LearnMonitor(sink, metrics, spike_mult=10.0, alpha=0.2,
                               min_samples=8, cooldown_s=30.0)
        mon.add_listener(lambda *a: fires.append(a))
        for step, (vals, loss) in enumerate(_stream(seed)):
            now["t"] += 3.0
            mod.publish_learn(sink, vals, tenant=tenant)
            mon.observe(vals, loss, step=step, tenant=tenant)
        results.append((sink.gauges, sink.counts, logs, fires))
    assert results[0] == results[1]
    rules = {f[0] for f in results[1][3]}
    assert {"loss_spike", "q_blowup", "ess_collapse", "dead_gradients",
            "priority_collapse"} <= rules


def test_thresholds_are_the_originals():
    for name in ("Q_MAX_LIMIT", "ESS_FRAC_MIN", "UPDATE_RATIO_MIN",
                 "TOP_FRAC_MAX"):
        assert getattr(tlearn, name) == getattr(jlearn, name)
