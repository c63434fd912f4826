"""The port's multi-host learner through its CLI as two gloo processes
on the CPU (`--coordinator 127.0.0.1:<free port> --num-processes 2
--process-id i --device cpu`): the original's two-process tests of
tests/test_multihost.py `:198` (lockstep DQN with eval on process 0 and
the metrics file) and `:258` (R2D2) with its `_SETS`, `_R2D2_SETS` and
budgets; `:99` and `:176` are tests/test_torch_multihost_budget.py, and
`:285` tests/test_torch_multihost_resume.py, on the helpers here. The
original's own runs of these skip on this host's JAX CPU backend. Each
process gets its own timeout, so a hung collective fails its test; both
are killed on the way out. Each process runs torch on one thread: the
runs are small, and the suite's other workers share the cores."""

import json
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120

_SETS = [
    "parallel.dp=8", "parallel.tp=1",
    "replay.kind=prioritized", "replay.capacity=4096",
    "replay.min_fill=64",
    "learner.batch_size=32", "learner.n_step=3",
    "learner.target_sync_every=100", "learner.publish_every=10",
    "learner.train_chunk=2",
    # envs_per_actor=2 routes the local actors through the vector actor
    "actors.num_actors=1", "actors.base_eps=0.6", "actors.ingest_batch=8",
    "actors.envs_per_actor=2",
    "inference.max_batch=8", "inference.deadline_ms=1.0",
    "eval_every_steps=0", "eval_episodes=0",
]

_R2D2_SETS = [
    "parallel.dp=8", "parallel.tp=1",
    "env.id=CartPolePO", "env.kind=cartpole_po",
    "network.lstm_size=32", "network.torso_dense=64",
    "network.compute_dtype=float32",
    "replay.capacity=512", "replay.seq_length=16", "replay.seq_overlap=8",
    "replay.burn_in=4", "replay.min_fill=16", "replay.storage=flat",
    "learner.batch_size=16", "learner.n_step=3", "learner.lr=1e-3",
    "learner.target_sync_every=100", "learner.publish_every=10",
    "learner.train_chunk=2",
    # envs_per_actor=2 routes through RecurrentVectorActor
    "actors.num_actors=1", "actors.base_eps=0.4", "actors.ingest_batch=64",
    "actors.envs_per_actor=2",
    "inference.max_batch=8", "inference.deadline_ms=1.0",
    "eval_every_steps=0", "eval_episodes=0",
]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(port, pid, extra, config="cartpole_smoke", sets=_SETS):
    """One process of the pair; "{pid}" in `extra` becomes its id."""
    return subprocess.Popen(
        [sys.executable, "-m", "ape_x_dqn_tpu_torch.runtime.train",
         "--config", config, "--device", "cpu",
         "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(pid)]
        + [a for s in sets for a in ("--set", s)]
        + [a.format(pid=pid) for a in extra],  # later --set wins
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def run_pair(extra, config="cartpole_smoke", sets=_SETS) -> list[dict]:
    """Both processes to their end (each within TIMEOUT_S, exit 0) ->
    their summary lines."""
    port = free_port()
    procs = [launch(port, pid, extra, config, sets) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, stderr[-3000:]
            assert "backend gloo, world size 2" in stderr
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _lockstep(outs):
    """The original's lockstep invariants, and the port's: the same
    params on both ranks, every rank feeding the collective."""
    assert outs[0]["grad_steps"] == outs[1]["grad_steps"]
    assert outs[0]["frames"] == outs[1]["frames"]
    assert outs[0]["loss"] == pytest.approx(outs[1]["loss"], rel=1e-5)
    assert outs[0]["frames_local"] > 0 and outs[1]["frames_local"] > 0
    mh = [o["multihost"] for o in outs]
    assert mh[0]["params_crc32"] == mh[1]["params_crc32"]
    assert [m["rows"] for m in mh] == [[0, 4], [4, 8]]
    assert mh[0]["exchange"]["calls"] == mh[1]["exchange"]["calls"] \
        == outs[0]["grad_steps"]


def test_two_process_lockstep_training(tmp_path):
    outs = run_pair(["--total-env-frames", "1600", "--max-grad-steps", "20",
                     "--metrics-file", str(tmp_path / "m{pid}.jsonl"),
                     # eval on process 0 (host-local, collective-free)
                     "--set", "eval_every_steps=5",
                     "--set", "eval_episodes=1"])
    for out in outs:
        assert out["grad_steps"] >= 20, out
        assert out["actor_errors"] == [], out
        assert out["frames"] > 0
        assert out["replay_filled"] >= 64
    _lockstep(outs)
    # eval ran on process 0 only, without perturbing the lockstep (the
    # agreement above IS the non-perturbation check)
    assert outs[0]["eval_error"] is None, outs[0]
    assert outs[0]["eval"] is not None and \
        outs[0]["eval"]["episodes"] >= 1, outs[0]
    assert outs[1]["eval"] is None, outs[1]
    # per-round metrics stream to --metrics-file (publish cadence)
    for pid in range(2):
        recs = [json.loads(ln) for ln in
                (tmp_path / f"m{pid}.jsonl").read_text().splitlines()]
        assert any("loss" in r for r in recs), recs
        assert any(r.get("multihost_backend") == "gloo"
                   and r.get("process") == pid for r in recs), recs


def test_two_process_lockstep_r2d2():
    """R2D2 over the lockstep round loop: sequence replay shards and the
    LSTM sequence loss, recurrent actors querying {obs, c, h}."""
    outs = run_pair(["--total-env-frames", "2400", "--max-grad-steps", "10"],
                    config="r2d2", sets=_R2D2_SETS)
    for out in outs:
        assert out["grad_steps"] >= 10, out
        assert out["actor_errors"] == [], out
        assert out["frames"] > 0
    _lockstep(outs)
