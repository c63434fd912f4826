"""The port's threaded Ape-X driver (ape_x_dqn_tpu_torch/runtime/driver.py)
and the CLI's default mode, end to end on the CPU: the original's driver
tests (tests/test_runtime.py, tests/test_vector_actor.py) at their small
sizes, with device="cpu". Actors, the inference server, ingest and the
learner run in threads, so these check behaviour (wiring, accounting,
recovery, shutdown, pacing), not numbers."""

import json

import numpy as np
import pytest

from ape_x_dqn_tpu_torch.configs import (ActorConfig, InferenceConfig,
                                         LearnerConfig, ParallelConfig,
                                         ReplayConfig, get_config)
from ape_x_dqn_tpu_torch.runtime import train
from ape_x_dqn_tpu_torch.runtime.actor import Actor
from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
from ape_x_dqn_tpu_torch.utils.metrics import Metrics


def _tiny_cfg(num_actors=2, envs_per_actor=1):
    return get_config("cartpole_smoke").replace(
        actors=ActorConfig(num_actors=num_actors, base_eps=0.6,
                           envs_per_actor=envs_per_actor, ingest_batch=16),
        replay=ReplayConfig(kind="prioritized", capacity=2048, min_fill=64),
        learner=LearnerConfig(batch_size=32, n_step=3,
                              target_sync_every=100, publish_every=20),
        inference=InferenceConfig(max_batch=8, deadline_ms=1.0),
    )


def test_driver_end_to_end(tmp_path):
    """Actors -> server -> transport -> ingest -> learner, with the
    self-describing JSONL header."""
    log_path = str(tmp_path / "metrics.jsonl")
    cfg = _tiny_cfg()
    driver = ApexDriver(cfg, metrics=Metrics(log_path=log_path),
                        device="cpu")
    out = driver.run(total_env_frames=1200, max_grad_steps=50,
                     wall_clock_limit_s=120)
    with open(log_path) as fh:
        head = json.loads(fh.readline())
    assert head["sample_chunk"] == 1
    assert head["replay_storage"] == "flat"
    assert head["replay_kind"] == "prioritized"
    assert head["run_name"] == cfg.name
    assert out["actor_errors"] == [] and out["loop_errors"] == [], out
    assert out["frames"] >= 64, out
    assert out["grad_steps"] >= 50, out
    assert out["episodes"] > 0
    assert out["server"]["items"] > 0
    assert out["eval"] is not None and out["eval"]["episodes"] > 0
    assert driver.server.params_version > 0   # published at least once


def test_vector_driver_batches_the_server():
    """One vector actor of 4 envs: the server sees multi-item requests."""
    cfg = _tiny_cfg(num_actors=1, envs_per_actor=4).replace(
        inference=InferenceConfig(max_batch=16, deadline_ms=1.0),
        eval_every_steps=0, eval_episodes=0)
    out = ApexDriver(cfg, device="cpu").run(
        total_env_frames=1600, max_grad_steps=50, wall_clock_limit_s=120)
    assert out["actor_errors"] == [] and out["loop_errors"] == [], out
    assert out["frames"] >= 64 and out["grad_steps"] >= 50, out
    assert out["episodes"] > 0
    assert out["server"]["avg_batch"] > 2.0, out["server"]


class _FlakyActor(Actor):
    """Crashes actor 0's first run; behaves normally after."""

    crashed: dict = {}

    def run(self, max_frames, stop_event=None):
        if self.index == 0 and not _FlakyActor.crashed.get("done"):
            _FlakyActor.crashed["done"] = True
            raise RuntimeError("injected actor crash")
        return super().run(max_frames, stop_event)


def test_actor_crash_recovery(monkeypatch):
    _FlakyActor.crashed = {}
    monkeypatch.setattr("ape_x_dqn_tpu_torch.runtime.family.Actor",
                        _FlakyActor)
    out = ApexDriver(_tiny_cfg(), device="cpu").run(
        total_env_frames=1200, max_grad_steps=50, wall_clock_limit_s=120)
    assert _FlakyActor.crashed.get("done")
    assert out["actor_errors"] == [], out["actor_errors"]
    assert [i for i, _ in out["actor_restarts"]] == [0], out
    assert out["grad_steps"] >= 50, out


def test_actor_crash_exhausts_restart_budget(monkeypatch):
    """max_restarts=0: the crash is an actor error, not retried."""
    _FlakyActor.crashed = {}
    monkeypatch.setattr("ape_x_dqn_tpu_torch.runtime.family.Actor",
                        _FlakyActor)
    cfg = _tiny_cfg().replace(actors=ActorConfig(
        num_actors=2, base_eps=0.6, ingest_batch=16, max_restarts=0))
    out = ApexDriver(cfg, device="cpu").run(
        total_env_frames=600, max_grad_steps=30, wall_clock_limit_s=120)
    assert [i for i, _ in out["actor_errors"]] == [0], out
    assert out["actor_restarts"] == []


def test_driver_shuts_down_when_the_learner_cannot_progress():
    """Actors finish below min_fill with a finite grad-step target:
    run() returns instead of spinning to the wall clock."""
    cfg = _tiny_cfg(num_actors=1).replace(
        replay=ReplayConfig(kind="prioritized", capacity=2048,
                            min_fill=2000))
    out = ApexDriver(cfg, device="cpu").run(
        total_env_frames=100, max_grad_steps=50, wall_clock_limit_s=60)
    assert out["actor_errors"] == [], out["actor_errors"]
    assert out["grad_steps"] == 0
    assert out["wall_s"] < 50


def test_steps_per_frame_cap_binds():
    """The learner paces itself to the ingested frames: at most one
    chunk over cap * frames."""
    cap = 0.05
    cfg = _tiny_cfg(num_actors=1).replace(
        learner=LearnerConfig(batch_size=32, n_step=3,
                              target_sync_every=100, publish_every=20,
                              train_chunk=4, steps_per_frame_cap=cap),
        eval_every_steps=0, eval_episodes=0)
    out = ApexDriver(cfg, device="cpu").run(
        total_env_frames=1200, max_grad_steps=10**9,
        wall_clock_limit_s=120)
    assert out["actor_errors"] == [] and out["loop_errors"] == [], out
    assert out["grad_steps"] > 0
    assert out["grad_steps"] <= cap * out["frames"] \
        + cfg.learner.train_chunk, out


def test_frame_ring_driver_end_to_end():
    """Vector actors shipping frame segments into the frame ring, a
    small float32 Nature-CNN with K=4 sampling: no drops at the
    transport or the stager beyond the teardown tail."""
    from ape_x_dqn_tpu_torch.configs import EnvConfig, NetworkConfig
    cfg = get_config("pong").replace(
        env=EnvConfig(id="catch", kind="synthetic_atari", max_noop_start=4),
        network=NetworkConfig(kind="nature_cnn", cnn_channels=(8, 16, 16),
                              torso_dense=32, compute_dtype="float32"),
        replay=ReplayConfig(kind="prioritized", capacity=4096, min_fill=256,
                            storage="frame_ring", seg_transitions=8,
                            segs_per_add=2),
        learner=LearnerConfig(batch_size=16, n_step=3, sample_chunk=4,
                              target_sync_every=50, publish_every=16,
                              train_chunk=8, steps_per_frame_cap=0.05),
        actors=ActorConfig(num_actors=2, envs_per_actor=4, base_eps=0.5),
        inference=InferenceConfig(max_batch=16, deadline_ms=1.0),
        eval_every_steps=0, eval_episodes=1)
    driver = ApexDriver(cfg, device="cpu")
    out = driver.run(total_env_frames=2000, wall_clock_limit_s=120)
    assert out["actor_errors"] == [] and out["loop_errors"] == [], out
    assert out["grad_steps"] >= 40, out
    assert out["frames"] == 2000 and out["episodes"] > 0, out
    assert driver.server.params_version > 0
    seg = cfg.replay.seg_transitions
    assert driver.state.replay.size == driver._replay_filled
    assert driver.state.replay.size % seg == 0
    assert out["eval"]["episodes"] == 1


def test_counters_survive_thread_contention():
    """More actor threads than cores and a 10 us switch interval: no
    lost update in the shared counters (every shipped frame counted
    once, the replay's fill mirror equal to the replay's own size)."""
    import sys

    from ape_x_dqn_tpu_torch.comm.transport import LoopbackTransport
    cfg = _tiny_cfg(num_actors=12).replace(
        replay=ReplayConfig(kind="prioritized", capacity=8192, min_fill=64),
        eval_every_steps=0, eval_episodes=0)
    import threading

    class Counting(LoopbackTransport):
        shipped = 0
        lock = threading.Lock()

        def send_experience(self, batch):
            with self.lock:
                Counting.shipped += int(batch["frames"])
            super().send_experience(batch)

    transport = Counting(max_pending=10**6)
    driver = ApexDriver(cfg, transport=transport, device="cpu")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        out = driver.run(total_env_frames=2400, wall_clock_limit_s=120)
    finally:
        sys.setswitchinterval(old)
    assert out["actor_errors"] == [] and out["loop_errors"] == [], out
    assert transport.dropped == 0
    # flat staging: a dropped tail unit takes its env frame off the count
    assert out["frames"] + out["ingest_dropped"] == Counting.shipped, out
    assert Counting.shipped > 2300
    assert driver.state.replay.size == driver._replay_filled > 0
    assert out["grad_steps"] > 0


def test_driver_refuses_what_is_not_ported():
    """What the original builds, the port builds: a dp=2 mesh (on the
    CPU repeated) gives the dp-sharded learner, a dp=2 mesh over two
    distinct devices its card groups (parallel/cards.py),
    ingest_zero_copy=False the legacy staging path, and the profiler
    capture and the remediation plane (items 17 and 19) build. Over
    distinct devices, the cold tier and legacy staging still wait,
    naming ROADMAP item 6."""
    base = _tiny_cfg()
    dist = ApexDriver(base.replace(parallel=ParallelConfig(dp=2, tp=1)),
                      device="cpu", mesh_devices=["cpu", "cpu"])
    assert dist.is_dist and dist.state.replay.tree.shape[0] == 2
    legacy = ApexDriver(base.replace(replay=ReplayConfig(
        kind="prioritized", capacity=2048, ingest_zero_copy=False)),
        device="cpu")
    assert legacy._stager is None and not legacy.is_dist
    cards = ApexDriver(base.replace(parallel=ParallelConfig(dp=2, tp=1)),
                       device="cpu", mesh_devices=["cpu:0", "cpu:1"])
    assert cards.cards and len(cards.learner.groups) == 2
    assert [st.replay.tree.shape[0] for st in cards.state.groups] == [1, 1]
    for d in (dist, legacy, cards):
        d.server.stop()
    two = base.replace(parallel=ParallelConfig(dp=2, tp=1))
    for cfg in (two.replace(replay=ReplayConfig(
                    kind="prioritized", capacity=2048,
                    ingest_zero_copy=False)),
                two.replace(replay=ReplayConfig(
                    kind="prioritized", capacity=2048,
                    cold_tier_capacity=1024))):
        with pytest.raises(NotImplementedError, match="item 6\\b"):
            ApexDriver(cfg, device="cpu", mesh_devices=["cpu:0", "cpu:1"])
    for cfg in (base.replace(profile_dir="prof"),
                base.replace(remediation=type(base.remediation)(
                    mode="observe"))):
        driver = ApexDriver(cfg, device="cpu")
        assert (driver.remediation is not None) == (
            cfg.remediation.mode == "observe")
        assert (driver._profile is not None) == bool(cfg.profile_dir)


def test_multi_tenant_driver_runs_to_a_clean_end(tmp_path):
    """serving.multi_tenant: the driver's policy registers in the
    serving tier under env.id and its actors query through the tenant's
    client, to a clean end; with obs on, the JSONL carries the tenant's
    serve/<id>/ gauges, and the remediation engine reads the tier's
    queue sensors (a small SLO line, enforce mode; the actors ride class
    0, which is never shed) and moves its backpressure and the
    tenant's class through the driver's actuators."""
    log_path = str(tmp_path / "run.jsonl")
    base = _tiny_cfg(num_actors=2, envs_per_actor=4)
    cfg = base.replace(
        serving=type(base.serving)(multi_tenant=True, queue_slo_items=4,
                                   default_class=0, stats_every_s=0.2),
        remediation=type(base.remediation)(mode="enforce"),
        obs=type(base.obs)(enabled=True),
        inference=InferenceConfig(max_batch=16, deadline_ms=1.0))
    driver = ApexDriver(cfg, metrics=Metrics(log_path=log_path),
                        device="cpu")
    assert driver.serving is not None
    assert driver.server.policy_id == cfg.env.id
    sensors = driver._remediation_sensors()
    assert sensors["queue_slo"] == 4 and "queue_depth" in sensors
    out = driver.run(total_env_frames=1600, max_grad_steps=40,
                     wall_clock_limit_s=120)
    assert out["actor_errors"] == [] and out["loop_errors"] == [], out
    assert out["grad_steps"] >= 40 and out["frames"] >= 64, out
    tier = out["serving"]
    assert tier["tenants"] == 1 and tier["items"] > 0, tier
    assert tier["offered"] == tier["admitted"] + tier["shed"], tier
    assert tier["shed_by_class"][0] == 0
    pid = cfg.env.id
    assert tier[f"serve/{pid}/offered"] == tier["offered"] > 0, tier
    assert tier[f"serve/{pid}/version"] > 0, tier
    assert driver.server.params_version > 0  # publications reached it
    with open(log_path) as fh:
        keys = set().union(*(json.loads(line) for line in fh))
    for name in ("offered", "admitted", "queue_depth", "p99_ms"):
        assert f"gauge/serve/{pid}/{name}" in keys, sorted(keys)[:40]
    assert out["remediation"]["mode"] == "enforce"
    # the actuators reach the tier
    engaged = driver.serving.backpressure_engaged
    assert driver._remediation_backpressure(not engaged) is True
    assert driver.serving.backpressure_engaged is (not engaged)
    assert driver._remediation_set_priority(cfg.env.id, 2) is True
    assert driver.server.priority == 2
    assert driver._remediation_set_priority("another-tenant", 1) is False


# -- the CLI's default mode ------------------------------------------------


def test_cli_default_mode_prints_the_summary(capsys):
    rc = train.main(["--config", "cartpole_smoke", "--device", "cpu",
                     "--total-env-frames", "1200", "--max-grad-steps", "50",
                     "--wall-clock-limit", "120"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    out = json.loads(lines[0])
    assert out["grad_steps"] >= 50 and out["episodes"] > 0
    assert out["server"]["items"] > 0
    assert out["actor_errors"] == [] and out["loop_errors"] == []


def test_cli_exits_1_on_a_loop_error(capsys, monkeypatch):
    from ape_x_dqn_tpu_torch.runtime.learner import DQNLearner

    def boom(self, state, n, noise=None):
        raise RuntimeError("injected learner fault")

    monkeypatch.setattr(DQNLearner, "train_many", boom)
    rc = train.main(["--config", "cartpole_smoke", "--device", "cpu",
                     "--total-env-frames", "1200", "--max-grad-steps", "50",
                     "--wall-clock-limit", "60"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1
    assert out["loop_errors"] and "injected learner fault" in \
        out["loop_errors"][0]
    assert all(isinstance(e, str) for e in out["loop_errors"])


@pytest.mark.parametrize("argv,item", [
    (["--compilation-cache-dir", "cc"], None),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "0", "--wall-clock-limit", "5"], "multihost"),
])
def test_cli_unported_modes_exit_2(argv, item, capsys):
    """A jit cache does not apply to the port, which compiles nothing at
    run time; the multi-host learner (ported since; its runs are
    tests/test_torch_multihost*.py) refuses a wall-clock limit, as the
    original does, before it joins any process group."""
    try:
        rc = train.main(["--config", "cartpole_smoke", "--device", "cpu",
                         *argv])
    except SystemExit as e:
        rc = e.code
    err = capsys.readouterr().err
    assert rc == 2
    if item is None:
        assert "does not apply" in err
    else:
        assert "not supported in multihost mode" in err


def test_cli_default_device_is_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--config", "cartpole_smoke", "--total-env-frames", "10"])


def test_metrics_header_and_summary_types():
    out = ApexDriver(_tiny_cfg(num_actors=1).replace(
        eval_every_steps=0, eval_episodes=0), device="cpu").run(
        total_env_frames=300, max_grad_steps=8, wall_clock_limit_s=60)
    assert set(out) >= {"frames", "grad_steps", "avg_return", "episodes",
                        "wall_s", "server", "ingest_dropped",
                        "ingest_dropped_per_shard", "actor_errors",
                        "actor_restarts", "actor_quarantines",
                        "supervisor_restarts", "loop_errors", "eval"}
    assert np.isfinite(out["wall_s"])
