"""The driver's fleet supervisor (runtime/driver.py: `_supervise_tick`)
against the JAX package's, the port of tests/test_chaos.py's wedged-
actor cases: with observability on and a short heartbeat timeout, both
drivers take the same operations and must come to the same state: a
wedged local actor slot restarts in place with its remaining frame
budget, a slot past `actors.supervisor_max_restarts` is quarantined
(its heartbeat cleared, its thread dropped from the liveness count),
a silent remote peer is quarantined, and a silent learner still
raises the attributed StallError. Then one real run on the CPU: an
actor that wedges in every attempt is restarted, then quarantined, and
the run still ends with its other actor's frames."""

import threading
import time

import pytest

from ape_x_dqn_tpu import configs as jcfgs
from ape_x_dqn_tpu.obs.health import StallError as JaxStallError
from ape_x_dqn_tpu.runtime.driver import ApexDriver as JaxDriver
from ape_x_dqn_tpu_torch import configs as tcfgs
from ape_x_dqn_tpu_torch.obs.health import StallError
from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver

PEER = "chaos-host-1-a0"


def _cfg(pkg, timeout_s=0.3):
    return pkg.get_config("cartpole_smoke").replace(
        actors=pkg.ActorConfig(num_actors=2, ingest_batch=16,
                               supervise=True, supervisor_max_restarts=2),
        replay=pkg.ReplayConfig(kind="prioritized", capacity=1024,
                                min_fill=64),
        learner=pkg.LearnerConfig(batch_size=32, n_step=3,
                                  target_sync_every=100, publish_every=20),
        inference=pkg.InferenceConfig(max_batch=8, deadline_ms=1.0),
        obs=pkg.ObsConfig(enabled=True, heartbeat_timeout_s=timeout_s),
        eval_every_steps=0, eval_episodes=0)


@pytest.fixture(scope="module")
def drivers():
    made = {"jax": JaxDriver(_cfg(jcfgs)),
            "torch": ApexDriver(_cfg(tcfgs), device="cpu")}
    yield made
    for d in made.values():
        d.server.stop()
        d.obs.close()


def _age_heartbeat(driver, name):
    """`name`'s heartbeat goes stale past the watchdog timeout while
    every other registered component stays fresh."""
    driver.obs.register(name)
    time.sleep(driver.obs.watchdog.timeout_s + 0.15)
    for other in list(driver.obs.heartbeats.ages()):
        if other != name:
            driver.obs.beat(other, "test keep-alive")


def _spawns(driver):
    spawned = []
    driver._spawn_actor_slot = \
        lambda i, f, attempt0=0: spawned.append((i, f, attempt0))
    return spawned


def _counter(driver, name):
    return driver.obs.registry.counter(name).value


def _restart(driver):
    spawned = _spawns(driver)
    try:
        driver._slot_restarts.pop(0, None)
        driver._slot_budget[0] = 640
        before = _counter(driver, "supervisor_restarts")
        _age_heartbeat(driver, "actor-0")
        driver._supervise_tick()        # must not raise: a restart
        driver._supervise_tick()        # the re-armed beat stays green
        return (spawned, driver._slot_restarts[0],
                _counter(driver, "supervisor_restarts") - before)
    finally:
        del driver._spawn_actor_slot
        driver.obs.clear("actor-0")


def _quarantine(driver):
    spawned = _spawns(driver)
    wedged = threading.Event()
    t = threading.Thread(target=wedged.wait, daemon=True)
    t.start()
    try:
        driver._slot_threads[1] = t
        driver._slot_stops[1] = wedged
        driver._slot_restarts[1] = driver.cfg.actors.supervisor_max_restarts
        before = _counter(driver, "actor_quarantines")
        _age_heartbeat(driver, "actor-1")
        driver._supervise_tick()        # exhausted: quarantine
        out = (spawned, 1 in driver._quarantined,
               1 in driver._slot_threads, wedged.is_set(),
               "actor-1" in driver.obs.heartbeats.ages())
        _age_heartbeat(driver, "actor-1")   # a late beat of the old one
        driver._supervise_tick()        # idempotent
        return out + (_counter(driver, "actor_quarantines") - before,
                      "actor-1" in driver.obs.heartbeats.ages())
    finally:
        wedged.set()
        del driver._spawn_actor_slot
        driver._quarantined.discard(1)
        driver._slot_restarts.pop(1, None)


def _budget(driver):
    class Actor:
        frames = 40

    spawned = _spawns(driver)
    try:
        driver._slot_restarts.pop(0, None)
        driver._slot_budget[0] = 640
        driver._slot_done[0] = 100      # earlier crash-restart attempts
        driver._slot_actor_obj[0] = Actor()
        _age_heartbeat(driver, "actor-0")
        driver._supervise_tick()
        return spawned
    finally:
        del driver._spawn_actor_slot
        driver._slot_done.pop(0, None)
        driver._slot_restarts.pop(0, None)
        driver.obs.clear("actor-0")


def _peer(driver):
    name = f"{PEER}/actor-7"
    before = _counter(driver, "peer_stall_events")
    _age_heartbeat(driver, name)
    driver._supervise_tick()            # remote: count and clear
    return (_counter(driver, "peer_stall_events") - before,
            name in driver.obs.heartbeats.ages(),
            name in driver._peer_quarantined)


def _fatal(driver):
    _age_heartbeat(driver, "learner")
    try:
        driver._supervise_tick()
    except (StallError, JaxStallError) as e:
        return type(e).__name__, e.component
    finally:
        driver.obs.clear("learner")
    return None


@pytest.mark.parametrize("case", [_restart, _quarantine, _budget, _peer,
                                  _fatal], ids=lambda f: f.__name__[1:])
def test_the_supervisor_decides_like_the_original(drivers, case):
    theirs = case(drivers["jax"])
    ours = case(drivers["torch"])
    assert ours == theirs
    expected = {"_restart": ([(0, 640, 101)], 1, 1),
                "_budget": [(0, 500, 101)],
                "_peer": (1, False, True),
                "_fatal": ("StallError", "learner")}
    if case.__name__ in expected:
        assert ours == expected[case.__name__]
    if case is _quarantine:
        assert ours == ([], True, False, True, False, 1, False)


def test_a_wedged_actor_is_restarted_then_quarantined(monkeypatch):
    """A real run on the CPU: actor slot 1 wedges in every attempt
    (no heartbeat, no frames); the supervisor restarts it twice, then
    quarantines it, and the run ends on slot 0's frames."""
    from ape_x_dqn_tpu_torch.runtime import actor as actor_mod

    cfg = _cfg(tcfgs, timeout_s=5.0)
    cfg = cfg.replace(actors=tcfgs.ActorConfig(
        num_actors=2, ingest_batch=16, supervise=True,
        supervisor_max_restarts=2))
    release = threading.Event()
    real_run = actor_mod.Actor.run

    def run(self, max_frames, stop=None):
        if self.index == 1:             # wedged: no beat, no frames
            while not (release.is_set() or (stop and stop.is_set())):
                time.sleep(0.02)
            return 0
        return real_run(self, max_frames, stop)

    monkeypatch.setattr(actor_mod.Actor, "run", run)
    driver = ApexDriver(cfg, device="cpu")
    try:
        out = driver.run(total_env_frames=1600, wall_clock_limit_s=90)
    finally:
        release.set()
    assert out["loop_errors"] == [] and out["actor_errors"] == []
    assert out["supervisor_restarts"] == {1: 2}
    assert out["actor_quarantines"] == [1]
    assert out["frames_by_actor"].get(0, 0) > 0
    assert 1 not in out["frames_by_actor"]
