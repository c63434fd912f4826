"""The port's remediation plane (runtime/remediation.py) against the JAX
package's: one stream of sensor snapshots, stale heartbeats and
degradation events, on one fake clock, gives the same decisions (JSONL
records), the same outcomes (counters, gauges, summary) and the same
actuator calls, in observe and in enforce mode; then the port's driver
builds the engine for `observe` and `enforce` and wires its actuators,
where the serving tier's two are skipped (False) while there is none."""

import numpy as np
import pytest

from ape_x_dqn_tpu import configs as jcfgs
from ape_x_dqn_tpu.runtime import remediation as jrem
from ape_x_dqn_tpu_torch import configs as tcfgs
from ape_x_dqn_tpu_torch.runtime import remediation as trem


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class Sink:
    def __init__(self):
        self.counters, self.gauges, self.records = {}, [], []

    def count(self, name, n=1.0):
        self.counters[name] = self.counters.get(name, 0.0) + n

    def gauge(self, name, value):
        self.gauges.append((name, value))

    def log(self, step, **kw):
        self.records.append({"step": step, **kw})


def _run(mod, cfgs, mode, seed):
    clock, sink, calls = FakeClock(), Sink(), []

    def actuator(name, ok=True):
        return lambda *a: (calls.append((name, a)), ok)[1]

    acts = mod.Actuators(
        restart_actor=actuator("restart_actor"),
        quarantine_peer=actuator("quarantine_peer"),
        pause_actor=actuator("pause_actor"),
        resume_actor=actuator("resume_actor"),
        set_backpressure=actuator("set_backpressure"),
        set_priority=actuator("set_priority", ok=False))
    cfg = cfgs.RemediationConfig(mode=mode, hysteresis_ticks=2,
                                 cooldown_s=20.0, budget_per_min=3.0,
                                 event_threshold=2, release_after_s=60.0)
    eng = mod.RemediationEngine(cfg, sink, sink, acts, default_class=1,
                                clock=clock)
    rng = np.random.default_rng(seed)
    outcomes = []
    for step in range(60):
        clock.t += float(rng.integers(1, 8))
        eng.tick({"queue_depth": float(rng.integers(0, 40)),
                  "queue_slo": 16.0,
                  "ingest_dropped_delta": float(rng.integers(0, 3)),
                  "running_slots": [0, 1, 2], "paused_slots": []},
                 step=step)
        r = rng.random()
        if r < 0.15:
            outcomes.append(eng.remediate_stale_actor(
                int(rng.integers(0, 3)), 9.0, step=step))
        elif r < 0.25:
            outcomes.append(eng.remediate_stale_peer(
                f"host-{int(rng.integers(0, 2))}/actor-0", 12.0, step=step))
        elif r < 0.4:
            eng.note_perf("ingest_rows_per_s", 10.0, 100.0, step,
                          f"host-{int(rng.integers(0, 2))}")
        elif r < 0.5:
            eng.note_learn("loss_spike", 9.0, 0.5, step, "pong")
    return (sink.records, sink.counters, sink.gauges, calls, outcomes,
            eng.summary())


@pytest.mark.parametrize("mode", ["observe", "enforce"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_same_stream_gives_the_same_decisions(mode, seed):
    theirs = _run(jrem, jcfgs, mode, seed)
    ours = _run(trem, tcfgs, mode, seed)
    assert ours == theirs
    assert ours[0], "no decision was made"
    if mode == "observe":
        assert ours[3] == []        # observe never acts


@pytest.mark.parametrize("mode", ["observe", "enforce"])
def test_the_driver_builds_the_engine(mode):
    from tests.test_torch_driver_threads import _tiny_cfg
    from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver

    cfg = _tiny_cfg().replace(
        remediation=tcfgs.RemediationConfig(mode=mode),
        obs=tcfgs.ObsConfig(enabled=True))
    driver = ApexDriver(cfg, device="cpu")
    try:
        assert driver.remediation is not None
        assert driver.remediation.mode == mode
        assert driver._remediation_backpressure(True) is False
        assert driver._remediation_set_priority("catch", 0) is False
        sensors = driver._remediation_sensors()
        assert sensors["running_slots"] == []
        assert sensors["ingest_dropped_delta"] == 0
        driver._supervise_tick()
    finally:
        driver.server.stop()
        driver.obs.close()
