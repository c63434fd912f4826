"""The port's single-process trainer (ape_x_dqn_tpu_torch/runtime/
single_process.py) and its CLI (runtime/train.py) on the CPU.

The learning bar is the JAX package's own quick bar
(tests/test_e2e_cartpole.py: last20 > 60 after 9,000 frames). The port's
weights and actor draws come from its own generators (the JAX package's
threefry bits cannot be reproduced without JAX), so the runs are not
episode-for-episode the JAX package's; what is compared with it exactly
is the summary's and the run header's keys."""

import json

import pytest
import torch

from ape_x_dqn_tpu.configs import get_config as jax_get_config
from ape_x_dqn_tpu.runtime.single_process import (
    train_single_process as jax_train)
from ape_x_dqn_tpu.utils.metrics import Metrics as JaxMetrics
from ape_x_dqn_tpu.utils.metrics import Throughput as JaxThroughput
from ape_x_dqn_tpu.utils.metrics import log_run_header as jax_header
from ape_x_dqn_tpu_torch.configs import get_config
from ape_x_dqn_tpu_torch.runtime import train
from ape_x_dqn_tpu_torch.runtime.single_process import train_single_process
from ape_x_dqn_tpu_torch.utils.metrics import (Metrics, Throughput,
                                               log_run_header)


@pytest.fixture
def one_thread():
    """One intra-op thread: the MLP's tiny ops gain nothing from more,
    and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_cartpole_learns_quick_on_cpu(one_thread):
    cfg = get_config("cartpole_smoke", seed=0)
    out = train_single_process(cfg, total_env_frames=9_000, device="cpu")
    # untrained/random policy averages ~20; require clear learning signal
    assert out["episodes"] >= 5
    assert out["last20_return"] > 60.0, out


def test_same_seed_runs_give_identical_summaries(one_thread):
    cfg = get_config("cartpole_smoke", seed=3)
    a = train_single_process(cfg, total_env_frames=1_500, device="cpu")
    b = train_single_process(cfg, total_env_frames=1_500, device="cpu")
    assert a == b and a["grad_steps"] > 0


def test_cli_single_process_prints_the_jax_summary_keys(capsys, one_thread,
                                                        tmp_path):
    want = jax_train(jax_get_config("cartpole_smoke"),
                     total_env_frames=1_100)
    log = tmp_path / "run.jsonl"
    rc = train.main(["--config", "cartpole_smoke", "--single-process",
                     "--total-env-frames", "1100", "--device", "cpu",
                     "--metrics-file", str(log),
                     "--set", "learner.batch_size=32"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert sorted(out) == sorted(want)
    assert out["frames"] == 1_100 and out["grad_steps"] > 0
    header = json.loads(log.read_text().splitlines()[0])
    assert header["batch_size"] == 32 and header["run_name"] == \
        "cartpole_smoke"


def test_run_header_matches_jax():
    got, want = Metrics(), JaxMetrics()
    log_run_header(got, get_config("pong"))
    jax_header(want, jax_get_config("pong"))
    a, b = got.latest(), want.latest()
    a.pop("time"), b.pop("time")
    assert a == b


def test_throughput_matches_jax():
    """The windowed rate on one explicit clock, through both."""
    got, want = Throughput(window_s=2.0), JaxThroughput(window_s=2.0)
    for t, n in [(0.0, 5), (0.5, 3), (1.0, 7), (2.5, 1), (3.1, 4)]:
        got.add(n, now=t)
        want.add(n, now=t)
        assert got.rate(now=t + 0.1) == want.rate(now=t + 0.1)
    assert got.total == want.total == 20


@pytest.mark.parametrize("argv,waits_for", [
    (["--compilation-cache-dir", "cache"], "nothing is jit-compiled"),
])
def test_modes_not_ported_exit_nonzero(argv, waits_for, capsys):
    """What the port does not take exits 2 with its reason. (The
    multi-host flags run since the multi-host learner was ported:
    tests/test_torch_multihost*.py.)"""
    rc = train.main(["--config", "cartpole_smoke", *argv])
    assert rc == 2
    assert waits_for in capsys.readouterr().err


@pytest.mark.parametrize("argv,flag", [
    (["--single-process", "--listen", "0.0.0.0:0"], "--listen"),
    (["--single-process", "--checkpoint-dir", "ck"], "--checkpoint-dir"),
])
def test_single_process_refuses_driver_only_options(argv, flag, capsys):
    """The one-process trainer neither takes remote hosts nor saves
    checkpoints: it refuses the options rather than ignoring them."""
    rc = train.main(["--config", "cartpole_smoke", *argv])
    assert rc == 2
    err = capsys.readouterr().err
    assert flag in err and "--single-process" in err and "ROADMAP" in err


def test_obs_enabled_raises_rather_than_running_unobserved(tmp_path):
    """An obs-enabled config runs observed (it used to raise while the
    facade was missing): the split dispatch publishes the stage windows,
    the staleness histograms, the learning-health gauges and the spans."""
    cfg = get_config("cartpole_smoke")
    cfg = cfg.replace(obs=type(cfg.obs)(
        enabled=True, publish_every_steps=50,
        trace_path=str(tmp_path / "trace.json")))
    metrics = Metrics()
    out = train_single_process(cfg, total_env_frames=1300, device="cpu",
                               metrics=metrics)
    assert out["grad_steps"] > 100
    last = metrics.latest()
    assert last["hist/sample_age_steps"]["count"] > 0
    assert last["hist/param_lag_steps"]["count"] > 0
    assert 0 < last["gauge/mfu_learn_k"] <= 1
    assert 0 < last["gauge/hbm_bw_frac_sample_k"] <= 1
    assert "gauge/learn_q_mean" in last and "span/learner.learn" in last
