"""The multi-host learner's host-side parts in one process, against the
JAX package where it has them: the lockstep `StallWatchdog` (the
original's three tests of tests/test_multihost.py, run against both
classes), the loopback transport's telemetry path beside the original's
(each with its package's `FleetAggregator`), the `ApexDriver` fleet that
path gives, the CLI's conflicting-flag errors beside the original CLI's,
parallel/multihost.py's helpers without a group, and
`MultihostApexDriver` in a one-process gloo group: its refusals and one
short lockstep run. Last, a learner and its graphs are freed without a
collection (the graphs reach the learner through a weak reference).

The two-process runs are tests/test_torch_multihost_learner.py (the
learner), tests/test_torch_multihost_cli.py and
tests/test_torch_multihost_resume.py (the CLI)."""

import gc
import json
import socket
import time
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ape_x_dqn_tpu import configs as jcfgs
from ape_x_dqn_tpu.comm.transport import LoopbackTransport as JLoopback
from ape_x_dqn_tpu.obs import core as jcore
from ape_x_dqn_tpu.obs import fleet as jfleet
from ape_x_dqn_tpu.obs.health import StallWatchdog as JStallWatchdog
from ape_x_dqn_tpu.runtime import train as jtrain
from ape_x_dqn_tpu_torch import configs as tcfgs
from ape_x_dqn_tpu_torch.comm.transport import LoopbackTransport
from ape_x_dqn_tpu_torch.configs import (ActorConfig, InferenceConfig,
                                         LearnerConfig, ParallelConfig,
                                         ReplayConfig, get_config)
from ape_x_dqn_tpu_torch.obs import core as tcore
from ape_x_dqn_tpu_torch.obs import fleet as tfleet
from ape_x_dqn_tpu_torch.obs.health import StallWatchdog
from ape_x_dqn_tpu_torch.parallel import multihost
from ape_x_dqn_tpu_torch.runtime import train
from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
from ape_x_dqn_tpu_torch.runtime.multihost_driver import MultihostApexDriver

WATCHDOGS = {"jax": JStallWatchdog, "torch": StallWatchdog}


@pytest.mark.parametrize("pkg", sorted(WATCHDOGS))
def test_stall_watchdog_fires_and_aborts(pkg):
    """Silence past the timeout emits a diagnostic naming the process;
    two consecutive silent windows invoke the fatal action; stamps
    reset strikes (tests/test_multihost.py:120)."""
    events, codes = [], []
    wd = WATCHDOGS[pkg](1.2, describe=lambda: "state-snapshot",
                        fatal=codes.append, emit=events.append)
    wd.start()
    try:
        # keep stamping well inside the window: must never fire
        for _ in range(4):
            time.sleep(0.2)
            wd.stamp()
        assert events == [] and codes == []
        # go silent: strike 1 (diagnostic), then strike 2 (fatal)
        deadline = time.monotonic() + 5
        while len(codes) == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert len(events) >= 2, events
        assert "state-snapshot" in events[0]
        assert "no round progress" in events[0]
        assert "process 0" in events[0]
        assert codes == [70], codes
    finally:
        wd.stop()


@pytest.mark.parametrize("pkg", sorted(WATCHDOGS))
def test_stall_watchdog_disabled_at_zero(pkg):
    wd = WATCHDOGS[pkg](0.0, describe=lambda: "",
                        fatal=lambda c: None, emit=lambda m: None)
    wd.start()  # must not start a thread
    assert not wd._thread.is_alive()
    wd.stop()


@pytest.mark.parametrize("pkg", sorted(WATCHDOGS))
def test_stall_watchdog_stop_joins_thread(pkg):
    """stop() JOINS the watch thread: a watcher still running after
    stop() returns could fire into interpreter teardown."""
    wd = WATCHDOGS[pkg](30.0, describe=lambda: "",
                        fatal=lambda c: None, emit=lambda m: None)
    wd.start()
    assert wd._thread.is_alive()
    wd.stop()
    assert not wd._thread.is_alive()


class RecMetrics:
    def __init__(self):
        self.records = []

    def log(self, step, **kw):
        self.records.append({"step": int(step), **kw})


def _through_loopback(cfgs, core, fleet, transport_cls, frames):
    """Send `frames` through a loopback transport before and after a
    FleetAggregator installs on it. -> (send results, the transport's
    frame count, the aggregator's peers, the merged record keys, the
    telemetry counter)."""
    metrics = RecMetrics()
    obs = core.build_obs(cfgs.ObsConfig(enabled=True, blackbox=False),
                         metrics)
    obs.set_learner_step(7)
    tp = transport_cls()
    sent = [tp.send_telemetry(frames[0])]
    agg = fleet.FleetAggregator(obs)
    assert agg.install(tp)
    sent += [tp.send_telemetry(f) for f in frames]
    keys = sorted({k for r in metrics.records for k in r})
    return (sent, tp.telemetry_frames, agg.peers, keys,
            obs.registry.snapshot_frame()["ctr"].get("telemetry_frames"))


def test_loopback_telemetry_matches_the_original():
    """The same frames through the JAX LoopbackTransport and the port's,
    each with its package's FleetAggregator: the same send results
    (False before a hook is installed), counts, peers and merged
    keys."""
    host = tcore.build_obs(tcfgs.ObsConfig(enabled=True, blackbox=False),
                           RecMetrics())
    host.register("actor-0")
    host.count("param_pull_errors", 2)
    host.gauge("server_queue_depth", 3)
    frames = [json.loads(json.dumps(tfleet.build_frame(
        host, peer, seq, rows_out=rows)))
        for peer, seq, rows in (("host-a", 0, 10), ("host-a", 1, 30),
                                ("host-b", 0, 5), ("host-a", 1, 30))]
    theirs = _through_loopback(jcfgs, jcore, jfleet, JLoopback, frames)
    ours = _through_loopback(tcfgs, tcore, tfleet, LoopbackTransport,
                             frames)
    assert ours == theirs
    sent, n, peers, keys, ctr = ours
    assert sent == [False, True, True, True, True] and n == 4
    assert peers == ["host-a", "host-b"] and ctr == 3  # one duplicate
    assert "peer/host-a/ctr/param_pull_errors" in keys


def _tiny_cfg(**kw):
    return get_config("cartpole_smoke").replace(
        actors=ActorConfig(num_actors=1, base_eps=0.6, ingest_batch=8),
        replay=ReplayConfig(kind="prioritized", capacity=2048, min_fill=64),
        learner=LearnerConfig(batch_size=32, n_step=3, train_chunk=2,
                              target_sync_every=100, publish_every=10),
        inference=InferenceConfig(max_batch=8, deadline_ms=1.0),
        eval_every_steps=0, eval_episodes=0, **kw)


def test_apex_driver_with_obs_gets_a_fleet():
    """With obs.enabled and the default in-process transport the
    driver's fleet aggregator is installed (FleetAggregator.install
    found no telemetry hook before), and a frame sent through the
    transport reaches it."""
    cfg = _tiny_cfg(obs=tcfgs.ObsConfig(enabled=True, blackbox=False))
    driver = ApexDriver(cfg, device="cpu")
    try:
        assert isinstance(driver.transport, LoopbackTransport)
        assert driver.fleet is not None
        host = tcore.build_obs(tcfgs.ObsConfig(enabled=True,
                                               blackbox=False),
                               RecMetrics())
        assert driver.transport.send_telemetry(
            tfleet.build_frame(host, "host-c", 0))
        assert driver.fleet.peers == ["host-c"]
    finally:
        driver.server.stop()
        driver.obs.close(0)


@pytest.mark.parametrize("argv,message", [
    (["--coordinator", "127.0.0.1:1"],
     "--coordinator requires --num-processes and --process-id"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "0", "--wall-clock-limit", "5"],
     "--wall-clock-limit is not supported in multihost mode"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "0", "--single-process"],
     "--single-process and --coordinator conflict"),
], ids=["no_count", "wall_clock", "single_process"])
def test_cli_conflicting_flags_match_the_original(argv, message, capsys):
    """The original's parser errors (exit 2, before any process group
    is joined), from both CLIs."""
    errs = []
    for main in (jtrain.main, train.main):
        with pytest.raises(SystemExit) as exc:
            main(["--config", "cartpole_smoke", *argv])
        assert exc.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert message in errs[1]
    assert errs[0].split(": error: ")[1] == errs[1].split(": error: ")[1]


def test_cli_refuses_eval_only_with_a_coordinator(capsys):
    with pytest.raises(SystemExit) as exc:
        train.main(["--config", "cartpole_smoke", "--eval-only",
                    "--coordinator", "127.0.0.1:1", "--num-processes", "2",
                    "--process-id", "0"])
    assert exc.value.code == 2
    assert "--eval-only is single-process (no learner mesh); drop " \
        "--coordinator" in capsys.readouterr().err


def test_helpers_without_a_group():
    assert not multihost.initialized()
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.process_rows(8) == (0, 8)
    assert multihost.global_min_scalar(-3) == -3
    frames = 123_456_789_012
    assert multihost.global_stats(1.0, 0.0, float(frames)) == \
        (True, False, float(frames))
    assert multihost.processes_on_device(torch.device("cpu")) == 1
    assert multihost.local_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="initialized"):
        MultihostApexDriver(_tiny_cfg(), device="cpu")


@pytest.fixture
def group1():
    """A one-process gloo group (the original's 1-process fleet under an
    initialized distributed runtime), torn down after the test."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.init_multihost(f"127.0.0.1:{port}", 1, 0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_refusals(group1):
    base = _tiny_cfg()
    with pytest.raises(NotImplementedError, match="checkpoint_replay"):
        MultihostApexDriver(base.replace(checkpoint_replay=True),
                            device="cpu")
    with pytest.raises(NotImplementedError, match="DQN and R2D2"):
        MultihostApexDriver(get_config("apex_dpg"), device="cpu")
    with pytest.raises(ValueError, match="prioritized replay"):
        MultihostApexDriver(base.replace(replay=ReplayConfig(
            kind="uniform", capacity=2048)), device="cpu")


def test_one_process_fleet_runs_the_round_protocol(group1, tmp_path):
    """dp=2 in a one-process group: ingest gated by the collective,
    whole chunks, publications, a checkpoint, the summary's keys."""
    cfg = _tiny_cfg(parallel=ParallelConfig(dp=2, tp=1),
                    checkpoint_dir=str(tmp_path / "ck"),
                    checkpoint_every=6)
    driver = MultihostApexDriver(cfg, device="cpu")
    assert driver.dp_local == 2 and driver.processes_on_card == 1
    out = driver.run(total_env_frames=1200, max_grad_steps=10)
    assert out["actor_errors"] == [] and out["grad_steps"] == 10, out
    assert out["frames_local"] == out["frames"] > 0
    assert out["replay_filled"] >= 64 and out["params_version"] == 10
    assert out["checkpoint_saves"] == 2 and np.isfinite(out["loss"])
    mh = out["multihost"]
    assert mh["world_size"] == 1 and mh["rows"] == [0, 2]
    assert mh["exchange"]["calls"] == 10
    assert sorted(driver.ckpt.all_steps()) == [6, 10]


def test_a_learner_and_its_graphs_are_freed_without_a_collection():
    """The graphs a learner holds reach it through a weak reference, so
    dropping the last reference frees the learner at once (before, a
    learner and its graphs formed a cycle that waited for a collection,
    which could fall inside a later capture)."""
    from ape_x_dqn_tpu_torch.envs.base import EnvSpec
    from ape_x_dqn_tpu_torch.runtime.build import build_learner

    cfg = get_config("cartpole_smoke")
    spec = EnvSpec((4,), np.dtype(np.float32), True, 2)
    learner, state = build_learner(cfg, spec, device="cpu")
    rng = np.random.default_rng(0)
    n = 64
    views = {"obs": torch.from_numpy(rng.normal(size=(n, 4))
                                     .astype(np.float32)),
             "action": torch.zeros(n, dtype=torch.int32),
             "reward": torch.ones(n), "next_obs": torch.zeros(n, 4),
             "discount": torch.full((n,), 0.99),
             "priorities": torch.ones(n)}
    learner.add_landed(state, 1, learner.land_add(1, views, (n,)))
    learner.train_many(state, 2)
    assert learner.step_graphs() and learner.add_graphs()
    ref = weakref.ref(learner)
    gc.disable()
    try:
        del learner
        assert ref() is None
    finally:
        gc.enable()


def test_the_learner_warm_up_leaves_the_state_as_built(group1):
    """`_warmup_learner` runs the add and the step endpoints (their
    warm-up and capture calls on the card) on a zero block, then puts
    the state back: params, targets, Adam, the generator, the step, the
    replay's storage, trees and cursors all as built, bitwise."""
    from ape_x_dqn_tpu_torch.runtime.learner import checkpoint_tree

    cfg = _tiny_cfg(parallel=ParallelConfig(dp=2, tp=1))
    driver = MultihostApexDriver(cfg, device="cpu")
    try:
        def snapshot():
            st = driver.state
            flat = {}

            def walk(node, path):
                if isinstance(node, dict):
                    for k, v in node.items():
                        walk(v, path + (k,))
                elif isinstance(node, list):
                    for i, v in enumerate(node):
                        walk(v, path + (i,))
                elif isinstance(node, torch.Tensor):
                    flat[path] = node.detach().clone()
                else:
                    flat[path] = node
            walk(checkpoint_tree(st), ())
            for k, v in st.replay.storage.items():
                flat[("storage", k)] = v.clone()
            flat["tree"] = st.replay.tree.clone()
            flat["cursors"] = (st.replay.pos.tolist(), st.replay.size.tolist(),
                               st.replay.pos_dev.tolist(),
                               st.replay.size_dev.tolist())
            return flat

        before = snapshot()
        driver._warmup_learner(2)
        assert driver.learner.step_graphs() and driver.learner.add_graphs()
        after = snapshot()
        assert before.keys() == after.keys()
        for key, v in before.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, after[key]), key
            else:
                assert v == after[key], key
        assert driver.exchange.calls == 0
    finally:
        driver.server.stop()
