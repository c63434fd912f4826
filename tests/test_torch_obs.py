"""The port's observability core against the JAX package's, on the same
inputs (a seeded stream of observations, or a fake clock):

- the metric registry (obs/registry.py): one JSONL record per publish,
  the same keys and values;
- the span tracer (obs/trace.py): the same trace events and aggregates
  on one clock;
- the heartbeat watchdog (obs/health.py): the same attributed stall;
- the facade (obs/core.py): one session's instruments through both
  `Obs` give the same JSONL records, but for the compile telemetry that
  the port replaces with graph captures (none on the CPU), which the
  comparison leaves out; `NullObs` keeps method-for-method parity with
  `Obs`;
- `SampleAgeTracker`: the same write steps under skip-to-head wraps.
"""

import inspect
import json

import numpy as np
import pytest

from ape_x_dqn_tpu import configs as jcfgs
from ape_x_dqn_tpu.obs import core as jcore
from ape_x_dqn_tpu.obs import health as jhealth
from ape_x_dqn_tpu.obs import registry as jreg
from ape_x_dqn_tpu.obs import trace as jtrace
from ape_x_dqn_tpu_torch import configs as tcfgs
from ape_x_dqn_tpu_torch.obs import core as tcore
from ape_x_dqn_tpu_torch.obs import health as thealth
from ape_x_dqn_tpu_torch.obs import registry as treg
from ape_x_dqn_tpu_torch.obs import trace as ttrace

# the original's compile telemetry, which the port replaces with its
# graph-capture counters
JAX_ONLY = ("gauge/compile_cache_entries", "ctr/jit_compiles",
            "ctr/jit_compile_ms")


class RecMetrics:
    """A metrics sink that keeps its records (time dropped)."""

    def __init__(self):
        self.records = []

    def log(self, step, **kw):
        self.records.append({"step": int(step), **kw})


def _norm(records, drop=()):
    return [json.loads(json.dumps({k: v for k, v in r.items()
                                   if k not in drop}))
            for r in records]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_publishes_the_same_records(seed):
    rng = np.random.default_rng(seed)
    regs = (jreg.MetricRegistry(), treg.MetricRegistry())
    sinks = (RecMetrics(), RecMetrics())
    edges = jreg.geometric_edges(1e-2, 1e4, per_decade=3)
    assert edges == treg.geometric_edges(1e-2, 1e4, per_decade=3)
    for step in range(3):
        vals = rng.lognormal(0, 2, 50)
        counts = rng.integers(1, 5, 4)
        for reg, sink in zip(regs, sinks):
            h = reg.histogram("lat", edges)
            h.observe_many(vals[:25])
            for v in vals[25:]:
                h.observe(float(v))
            for i, c in enumerate(counts):
                reg.counter(f"c{i}").inc(float(c))
            reg.gauge("depth").set(float(vals[0]))
            reg.publish(sink, step, extra={"span/x": {"count": step}})
    assert _norm(sinks[0].records) == _norm(sinks[1].records)
    assert regs[0].snapshot_frame() == regs[1].snapshot_frame()


def test_tracer_writes_the_same_trace_on_one_clock(tmp_path, monkeypatch):
    clock = {"t": 100.0}

    def tick():
        clock["t"] += 0.25
        return clock["t"]

    out = []
    for mod, name in ((jtrace, "jax"), (ttrace, "torch")):
        clock["t"] = 100.0
        monkeypatch.setattr(mod.time, "perf_counter", tick)
        path = tmp_path / f"{name}.json"
        tr = mod.SpanTracer(str(path), max_events=5)
        for i in range(4):
            with tr.span("learner.train", k=i):
                with tr.span("replay.add", units=8):
                    pass
        tr.mark("replay.sample", fused_into="learner.train")
        tr.remote_span("actor.ship", 0.5, age_s=1.0, peer="host-a")
        agg = tr.aggregates()
        tr.close()
        events = json.loads(path.read_text())["traceEvents"]
        for ev in events:
            ev.pop("pid", None)
            ev.pop("tid", None)
        out.append((agg, events, mod.span_names(mod.load_trace(str(path)))))
    assert out[0] == out[1]


def test_watchdog_attributes_the_same_stall():
    stalls = []
    for mod in (jhealth, thealth):
        reg = mod.HeartbeatRegistry()
        reg.register("learner", now=0.0)
        reg.register("actor-3", now=0.0)
        reg.beat("learner", "step 8", now=4.0)
        reg.beat("inference-server", "batch of 4", now=9.5)
        dog = mod.HeartbeatWatchdog(reg, timeout_s=5.0)
        dog.check(now=4.5)                          # all fresh
        with pytest.raises(mod.StallError) as ei:
            dog.check(now=10.0)
        e = ei.value
        stalls.append((e.component, e.staleness_s, e.last_note, str(e),
                       reg.stale(5.0, now=10.0), reg.ages(now=10.0)))
        reg.clear("actor-3")
        dog.check(now=8.0)
    assert stalls[0] == stalls[1]
    assert stalls[0][0] == "actor-3"


def _session(core, cfgs, metrics, tmp_path, name):
    cfg = cfgs.ObsConfig(enabled=True, heartbeat_timeout_s=30.0,
                         blackbox_dir=str(tmp_path / name))
    obs = core.build_obs(cfg, metrics)
    rng = np.random.default_rng(5)
    obs.register("learner")
    for step in range(1, 4):
        obs.set_learner_step(step * 10)
        for _ in range(6):
            obs.on_server_batch(int(rng.integers(1, 64)),
                                int(rng.integers(0, step * 10)),
                                int(rng.integers(0, 8)))
        obs.observe("td_abs", float(rng.random()))
        obs.observe_many("infer_latency_ms", rng.lognormal(1, 1, 10))
        obs.gauge("replay_occupancy", 1000 * step)
        obs.count("replay_adds", 64)
        obs.learn_health({"td_abs_p50": 0.5 * step, "q_max": 3.0,
                          "is_ess_frac": 0.8, "update_ratio": 1e-4,
                          "priority_top_frac": 0.01}, 0.1 * step,
                         step=step * 10, tenant="pong")
        tracker = obs.age_tracker(64)
        tracker.on_add(40, step)
        obs.observe_sample_ages(tracker.ages([0, 5, 39], step * 10))
        obs.publish(step * 10)
    obs.close(40)
    return obs


def test_facade_publishes_the_same_records(tmp_path):
    sinks = (RecMetrics(), RecMetrics())
    for core, cfgs, sink, name in ((jcore, jcfgs, sinks[0], "jax"),
                                   (tcore, tcfgs, sinks[1], "torch")):
        obs = _session(core, cfgs, sink, tmp_path, name)
        assert obs.enabled and obs.watchdog is not None
    got, want = _norm(sinks[1].records), _norm(sinks[0].records, JAX_ONLY)
    assert len(got) == len(want) == 4
    assert got == want
    last = got[-1]
    assert last["hist/param_lag_steps"]["count"] == 18
    assert last["hist/sample_age_steps"]["count"] == 9


def test_null_obs_keeps_method_parity():
    def methods(cls):
        return {n for n, v in inspect.getmembers(cls, inspect.isfunction)
                if not n.startswith("_")}

    assert methods(tcore.Obs) <= methods(tcore.NullObs)
    assert methods(jcore.NullObs) <= methods(tcore.NullObs)
    assert tcore.build_obs(None, RecMetrics()) is tcore.NULL_OBS
    assert tcore.build_obs(tcfgs.ObsConfig(), RecMetrics()) is tcore.NULL_OBS


@pytest.mark.parametrize("blocks", [(16, 16, 16, 24, 8), (40, 40, 30, 10)])
def test_sample_age_tracker_matches(blocks):
    trackers = (jcore.SampleAgeTracker(64), tcore.SampleAgeTracker(64))
    idx = np.arange(64)
    for step, n in enumerate(blocks):
        for t in trackers:
            t.on_add(n, step)
        np.testing.assert_array_equal(trackers[0].ages(idx, 10),
                                      trackers[1].ages(idx, 10))
    # the port's view of the in-graph order statistics: a distance d
    # behind the cursor is the slot cursor - 1 - d
    t = trackers[1]
    np.testing.assert_array_equal(
        t.ages_at_distances([0, 3], 10),
        t.ages(np.remainder([t._pos - 1, t._pos - 4], 64), 10))
