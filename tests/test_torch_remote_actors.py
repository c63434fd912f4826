"""Remote actor hosts (runtime/actor_host.py) feeding the port's driver
over TCP, ported from tests/test_comm.py's two-process tests: cartpole,
R2D2 and DPG hosts run as ``python -m
ape_x_dqn_tpu_torch.runtime.actor_host --device cpu`` subprocesses; a
remote-only learner waits for its first host and ends once hosts have
quiesced; a killed host does not disturb the learner; a param-only
probe does not end the boot grace; the CLI's ``--listen`` prints the
bound port and ingests from a host over shared memory. Waits are
bounded by timeouts."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from ape_x_dqn_tpu_torch.comm.socket_transport import (
    SocketIngestServer, SocketTransport)
from ape_x_dqn_tpu_torch.configs import (
    ActorConfig, InferenceConfig, LearnerConfig, ReplayConfig, get_config)
from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
from ape_x_dqn_tpu_torch.runtime.train import apply_overrides

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _learner_cfg(num_local_actors=1):
    return get_config("cartpole_smoke").replace(
        actors=ActorConfig(num_actors=num_local_actors, base_eps=0.6,
                           ingest_batch=16),
        replay=ReplayConfig(kind="prioritized", capacity=2048, min_fill=64),
        # the pacing cap keeps a free-running learner from starving the
        # ingest thread on a small host
        learner=LearnerConfig(batch_size=32, n_step=3,
                              target_sync_every=100, publish_every=20,
                              steps_per_frame_cap=1.0),
        inference=InferenceConfig(max_batch=8, deadline_ms=1.0),
        eval_every_steps=0, eval_episodes=0,
    )


def _spawn_host(config, port, frames, offset=1, sets=(), actors=1):
    return subprocess.Popen(
        [sys.executable, "-m", "ape_x_dqn_tpu_torch.runtime.actor_host",
         "--config", config, "--connect", f"127.0.0.1:{port}",
         "--actors", str(actors), "--actor-offset", str(offset),
         "--frames-per-actor", str(frames), "--device", "cpu"]
        + [a for s in sets for a in ("--set", s)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _host_summary(proc, timeout):
    stdout, stderr = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, stderr[-2000:]
    out = json.loads(stdout.strip().splitlines()[-1])
    assert out["errors"] == [] and out["device"] == "cpu"
    return out


_CARTPOLE_SETS = ("actors.ingest_batch=16", "inference.deadline_ms=1.0")


def test_two_process_training_over_tcp():
    """A host process feeds the learner over the socket transport and
    pulls params; training proceeds on the combined stream, and every
    frame the host produced is ingested or counted as dropped."""
    cfg = _learner_cfg(num_local_actors=1)
    server = SocketIngestServer("127.0.0.1", 0)
    # constructing the driver publishes params v0, which the host waits
    # for; its batches park in the ingest queue until run() starts
    driver = ApexDriver(cfg, transport=server, device="cpu")
    proc = _spawn_host("cartpole_smoke", server.port, 300,
                       sets=_CARTPOLE_SETS)
    try:
        host = _host_summary(proc, 120)
        assert host["frames"] == 300 and host["last_param_version"] == 0
        assert server.pending > 0, "remote experience never reached the queue"
        out = driver.run(total_env_frames=4000, max_grad_steps=10**9,
                         wall_clock_limit_s=240)
        assert out["actor_errors"] == [], out["actor_errors"]
        assert out["loop_errors"] == [], out["loop_errors"]
        assert out["grad_steps"] > 0, out
        assert out["frames_by_actor"].get(1, 0) > 0, out["frames_by_actor"]
        accounted = (out["frames"]
                     + server.dropped * cfg.actors.ingest_batch
                     + driver._stage_dropped)
        assert accounted > 4050, (out["frames"], server.dropped,
                                  driver._stage_dropped)
        assert out["wire"]["bytes_in"] > 0
        assert out["wire"]["param_bytes_out"] > 0
    finally:
        if proc.poll() is None:
            proc.kill()
        server.stop()


_R2D2_SETS = (
    "env.kind=cartpole_po", "env.id=CartPolePO",
    "replay.storage=flat",
    "network.lstm_size=32", "network.torso_dense=64",
    "network.compute_dtype=float32",
    "replay.capacity=512", "replay.seq_length=16", "replay.seq_overlap=8",
    "replay.burn_in=4", "replay.min_fill=24",
    "learner.batch_size=16", "learner.publish_every=20",
    "learner.train_chunk=4",
    "actors.ingest_batch=64", "inference.max_batch=8",
    "inference.deadline_ms=1.0",
    "parallel.dp=1", "parallel.tp=1",
    "eval_every_steps=0", "eval_episodes=0",
)


def test_two_process_r2d2_training_over_tcp():
    """A RECURRENT host ships stored-state sequences over the socket
    transport; the sequence learner trains on the combined stream."""
    cfg = apply_overrides(get_config("r2d2"), list(_R2D2_SETS))
    cfg = cfg.replace(actors=dataclasses.replace(cfg.actors, num_actors=1))
    server = SocketIngestServer("127.0.0.1", 0)
    driver = ApexDriver(cfg, transport=server, device="cpu")
    proc = _spawn_host("r2d2", server.port, 400, sets=_R2D2_SETS)
    try:
        _host_summary(proc, 180)
        assert server.pending > 0, "remote sequences never reached the queue"
        out = driver.run(total_env_frames=2000, max_grad_steps=10**9,
                         wall_clock_limit_s=240)
        assert out["actor_errors"] == [], out["actor_errors"]
        assert out["loop_errors"] == [], out["loop_errors"]
        assert out["grad_steps"] > 0, out
        # the host's 400 frames arrived on top of the local 2000
        assert out["frames"] > 2100, out
        assert out["frames_by_actor"].get(1, 0) > 0
    finally:
        if proc.poll() is None:
            proc.kill()
        server.stop()


_DPG_SETS = ("env.id=pendulum", "network.dpg_hidden=(32,32)",
             "network.compute_dtype=float32", "replay.capacity=4096",
             "replay.min_fill=64", "learner.batch_size=32",
             "learner.publish_every=10", "learner.train_chunk=4",
             "actors.ingest_batch=16", "actors.noise_sigma=0.15",
             "inference.max_batch=4", "inference.deadline_ms=1.0",
             "parallel.dp=1", "parallel.tp=1", "eval_every_steps=0",
             "eval_episodes=0")


def test_two_process_dpg_training_over_tcp():
    """The DPG family over the remote-host path: {actor.*, critic.*}
    params load into the host's two nets, its server answers {a, q},
    and the continuous transitions it ships train the DPG learner."""
    cfg = apply_overrides(get_config("apex_dpg"), list(_DPG_SETS))
    cfg = cfg.replace(actors=dataclasses.replace(cfg.actors, num_actors=0,
                                                 remote_boot_grace_s=60.0))
    server = SocketIngestServer("127.0.0.1", 0, idle_grace_s=1.0)
    driver = ApexDriver(cfg, transport=server, device="cpu")
    proc = _spawn_host("apex_dpg", server.port, 600, offset=0,
                       sets=_DPG_SETS)
    try:
        out = driver.run(total_env_frames=10**9, max_grad_steps=10**9,
                         wall_clock_limit_s=180)
        host = _host_summary(proc, 60)
        assert host["frames"] == 600
        assert out["loop_errors"] == [], out["loop_errors"]
        assert out["grad_steps"] > 0, out
        # every frame the host shipped was ingested; a sub-block tail
        # staged at teardown is dropped and counted
        assert out["frames_by_actor"] == {0: 600}
        assert out["frames"] + out["ingest_dropped"] == 600
    finally:
        if proc.poll() is None:
            proc.kill()
        server.stop()


def test_remote_only_learner_waits_then_quiesces():
    """A learner with ZERO local actors (a) survives the window before
    any host connects (boot grace), (b) trains on late-arriving remote
    experience, and (c) ends through the QUIESCE path once the remote
    disconnects, with no finite step target."""
    cfg = _learner_cfg(num_local_actors=0).replace(
        actors=ActorConfig(num_actors=0, remote_boot_grace_s=60.0),
        learner=LearnerConfig(batch_size=32, n_step=3,
                              target_sync_every=100, publish_every=20,
                              train_chunk=4))
    server = SocketIngestServer("127.0.0.1", 0, idle_grace_s=1.0)
    driver = ApexDriver(cfg, transport=server, device="cpu")
    sent = threading.Event()

    def late_remote():
        time.sleep(1.5)  # the learner must still be waiting
        client = SocketTransport("127.0.0.1", server.port)
        rng = np.random.default_rng(0)
        for _ in range(10):
            n = 32
            client.send_experience({
                "obs": rng.normal(size=(n, 4)).astype(np.float32),
                "action": rng.integers(0, 2, n).astype(np.int32),
                "reward": rng.normal(size=n).astype(np.float32),
                "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
                "discount": np.full(n, 0.97, np.float32),
                "priorities": rng.random(n).astype(np.float32) + 0.1,
                "actor": 0, "frames": n,
            })
        sent.set()
        time.sleep(0.5)  # let the reader drain before the socket dies
        client.close()

    t = threading.Thread(target=late_remote, daemon=True)
    t.start()
    try:
        out = driver.run(total_env_frames=10**9, max_grad_steps=10**9,
                         wall_clock_limit_s=120)
        t.join(timeout=10)
        assert sent.is_set()
        assert out["loop_errors"] == [], out["loop_errors"]
        assert out["grad_steps"] > 0, out
        assert out["frames"] >= 64, out
        # only the quiesce path ends the run this early
        assert out["wall_s"] < 60, out
    finally:
        server.stop()


def test_actor_loss_fault_injection():
    """Killing a host mid-run does not disturb the learner: training
    reaches its target with no errors."""
    cfg = _learner_cfg(num_local_actors=1)
    server = SocketIngestServer("127.0.0.1", 0)
    driver = ApexDriver(cfg, transport=server, device="cpu")
    proc = _spawn_host("cartpole_smoke", server.port, 10**7,
                       sets=_CARTPOLE_SETS)
    killer = threading.Timer(6.0, lambda: proc.send_signal(signal.SIGKILL))
    killer.start()
    try:
        out = driver.run(total_env_frames=1500, max_grad_steps=60,
                         wall_clock_limit_s=180)
        killer.join(timeout=10)
        proc.wait(timeout=10)
        assert proc.returncode == -signal.SIGKILL
        assert out["actor_errors"] == [], out["actor_errors"]
        assert out["loop_errors"] == [], out["loop_errors"]
        assert out["grad_steps"] >= 60, out
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
        server.stop()


def test_param_probe_does_not_end_learner_boot_grace():
    """A remote-only learner holds its full boot grace even when a
    param-only client touches the listener."""
    cfg = get_config("cartpole_smoke").replace(
        actors=ActorConfig(num_actors=0, remote_boot_grace_s=4.0),
        replay=ReplayConfig(kind="prioritized", capacity=512, min_fill=64),
        learner=LearnerConfig(batch_size=16, publish_every=20),
        inference=InferenceConfig(max_batch=4, deadline_ms=1.0),
        eval_every_steps=0, eval_episodes=0)
    server = SocketIngestServer("127.0.0.1", 0)
    driver = ApexDriver(cfg, transport=server, device="cpu")
    probe = SocketTransport("127.0.0.1", server.port)
    t_run = {}

    def run():
        t0 = time.monotonic()
        driver.run(total_env_frames=10**9, max_grad_steps=10**9,
                   wall_clock_limit_s=20.0)
        t_run["wall"] = time.monotonic() - t0

    th = threading.Thread(target=run, daemon=True)
    th.start()
    for _ in range(6):
        probe.get_params()
        time.sleep(0.25)
    probe.close()
    th.join(timeout=60)
    assert not th.is_alive(), "driver.run never returned"
    # it ends when the grace lapses with no producer, not at the probe
    assert t_run["wall"] >= 3.5, t_run
    server.stop()


def test_actor_host_refuses_what_is_not_ported():
    from ape_x_dqn_tpu_torch.runtime.actor_host import run_actor_host

    cfg = get_config("cartpole_smoke")
    for bad, item in ((cfg.replace(obs=type(cfg.obs)(enabled=True)),
                       "items 17 and 19"),
                      (cfg.replace(serving=type(cfg.serving)(
                          multi_tenant=True)), "item 16")):
        with pytest.raises(NotImplementedError, match=item):
            run_actor_host(bad, "127.0.0.1", 1, device="cpu")


def test_actor_host_default_device_is_cuda():
    import torch

    from ape_x_dqn_tpu_torch.runtime import actor_host

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        actor_host.main(["--config", "cartpole_smoke",
                         "--connect", "127.0.0.1:1"])


def test_cli_listen_learner_with_a_shm_host(tmp_path):
    """The CLI's --listen: port 0 binds a free port, printed on stderr;
    a host on the same machine negotiates shared memory; the learner
    trains on its frames, checkpoints, and ends once the host quiesces
    (--actors 0), exiting 0 with the wire accounting in its summary."""
    learner = subprocess.Popen(
        [sys.executable, "-m", "ape_x_dqn_tpu_torch.runtime.train",
         "--config", "cartpole_smoke", "--device", "cpu", "--actors", "0",
         "--listen", "127.0.0.1:0", "--wall-clock-limit", "90",
         "--checkpoint-dir", str(tmp_path / "ck"),
         "--set", "actors.remote_boot_grace_s=60",
         "--set", "checkpoint_every=50", "--set", "comm.shm=true",
         "--set", "learner.publish_every=20"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    host = None
    try:
        line = learner.stderr.readline().strip()
        assert line.startswith("ingest listening on 127.0.0.1:"), line
        port = int(line.rsplit(":", 1)[1])
        assert port > 0
        host = _spawn_host("cartpole_smoke", port, 800, offset=0, actors=2,
                           sets=("comm.shm=true",
                                 "actors.param_pull_every=50"))
        hout = _host_summary(host, 120)
        assert hout["shm_posts"] > 0 and hout["shm_bytes_out"] > 0
        assert hout["last_param_version"] > 0  # pulled past version 0
        stdout, stderr = learner.communicate(timeout=120)
        assert learner.returncode == 0, stderr[-2000:]
        out = json.loads(stdout.strip().splitlines()[-1])
        assert out["loop_errors"] == [] and out["grad_steps"] > 0
        assert set(out["frames_by_actor"]) == {"0", "1"}
        assert out["wire"]["shm_doorbells"] > 0
        assert out["wire"]["shm_bytes_in"] == hout["shm_bytes_out"]
        assert out["checkpoint_saves"] >= 1
        assert (tmp_path / "ck" / f"{out['grad_steps']}.pt").exists()
    finally:
        for p in (learner, host):
            if p is not None and p.poll() is None:
                p.kill()
