"""The port's suite evaluation and per-game suite runner
(runtime/evaluation.py: evaluate_suite, run_suite_eval; runtime/
suite.py), ported from tests/test_evaluation.py, tests/test_suite.py
and tests/test_cli.py's --eval-only cases: backend-marked median HNS,
the per-game trainer with per-game checkpoints, resume-skip, shard math
and aggregation, and --eval-only restoring dqn, r2d2 and dpg
checkpoints. Against the JAX package: evaluate_suite in both packages
on the same numpy query_fn gives the same per-game scores."""

import json

import numpy as np
import pytest

from ape_x_dqn_tpu_torch.configs import (
    ActorConfig, EnvConfig, InferenceConfig, LearnerConfig, ReplayConfig,
    get_config)
from ape_x_dqn_tpu_torch.runtime.evaluation import (
    ATARI57_GAMES, evaluate_suite)
from ape_x_dqn_tpu_torch.runtime.suite import (
    aggregate_suite, main as suite_main, run_suite_training, suite_games)
from ape_x_dqn_tpu_torch.runtime.train import main
from ape_x_dqn_tpu_torch.utils.metrics import median_hns


def test_evaluate_suite_median_hns():
    cfg = get_config("pong").replace(
        env=EnvConfig(id="pong", kind="synthetic_atari"),
        eval_episodes=1)

    def query_fn(obs):
        return np.zeros(6, np.float32)

    out = evaluate_suite(cfg, query_fn, games=("pong", "breakout"),
                         episodes_per_game=1, max_frames=500)
    assert set(out["scores"]) == {"pong", "breakout"}
    assert set(out["hns"]) == {"pong", "breakout"}
    expect = median_hns({g: out["scores"][g] for g in out["scores"]})
    assert abs(out["median_hns_synthetic"] - expect) < 1e-9


def test_synthetic_suite_never_emits_unmarked_north_star():
    """In an image without ale_py, every game runs the synthetic
    stand-in — the result must mark every
    game's backend and must NOT carry the north-star 'median_hns' key
    (it appears only when the real ALE produced it)."""
    cfg = get_config("pong").replace(
        env=EnvConfig(id="pong", kind="atari"),  # asks for REAL atari
        eval_episodes=1)

    def query_fn(obs):
        return np.zeros(6, np.float32)

    out = evaluate_suite(cfg, query_fn, games=("pong",),
                         episodes_per_game=1, max_frames=300)
    assert out["backends"] == {"pong": "synthetic"}
    assert "median_hns" not in out
    assert "median_hns_synthetic" in out


def test_suite_eval_rejects_games_for_non_atari_config():
    """--games on a non-Atari config would build per-game Atari envs
    against a network sized for the config's own env; it must fail with
    a clear error instead."""
    import pytest

    from ape_x_dqn_tpu_torch.runtime.evaluation import run_suite_eval

    cfg = get_config("cartpole_smoke")
    with pytest.raises(ValueError, match="only valid for Atari"):
        run_suite_eval(cfg, games=("pong",), device="cpu")


def test_suite_games_shard_partition():
    games = suite_games()
    assert len(games) == 57
    shards = [suite_games(shard=(i, 4)) for i in range(4)]
    assert sum(len(s) for s in shards) == 57
    assert sorted(g for s in shards for g in s) == sorted(games)
    with pytest.raises(ValueError):
        suite_games(shard=(4, 4))


def _suite_cfg():
    return get_config("pong").replace(
        env=EnvConfig(id="catch", kind="synthetic_atari"),
        replay=ReplayConfig(kind="prioritized", capacity=4096,
                            min_fill=64, storage="frame_ring",
                            seg_transitions=8, segs_per_add=2),
        learner=LearnerConfig(batch_size=16, n_step=3,
                              target_sync_every=100, publish_every=20,
                              train_chunk=4),
        actors=ActorConfig(num_actors=1, envs_per_actor=2,
                           ingest_batch=16),
        inference=InferenceConfig(max_batch=8, deadline_ms=1.0),
        parallel=get_config("cartpole_smoke").parallel,  # dp=1, tp=1
        eval_every_steps=0, eval_episodes=1,
    )


def test_suite_training_two_games(tmp_path):
    out = run_suite_training(
        _suite_cfg(), str(tmp_path / "suite"),
        games=("pong", "breakout"),
        max_grad_steps_per_game=30,
        wall_clock_limit_s_per_game=120, device="cpu")
    assert set(out["scores"]) == {"pong", "breakout"}
    assert out["backends"] == {"pong": "synthetic",
                               "breakout": "synthetic"}
    # synthetic backends can never emit the unmarked north-star key
    assert "median_hns" not in out and "median_hns_synthetic" in out
    assert out["complete"] is True
    for g in ("pong", "breakout"):
        assert not out["per_game"][g]["errors"], out["per_game"][g]
        assert out["per_game"][g]["grad_steps"] >= 30
        assert (tmp_path / "suite" / g / "result.json").exists()
        assert (tmp_path / "suite" / g / "metrics.jsonl").exists()
        assert (tmp_path / "suite" / g / "ckpt").exists()
    assert (tmp_path / "suite" / "suite.json").exists()

    # resume: completed games are skipped (result.json short-circuits;
    # a retrained game would need >=30 more grad steps of wall time)
    import time
    t0 = time.monotonic()
    out2 = run_suite_training(
        _suite_cfg(), str(tmp_path / "suite"),
        games=("pong", "breakout"),
        max_grad_steps_per_game=30,
        wall_clock_limit_s_per_game=120, device="cpu")
    assert time.monotonic() - t0 < 5.0, "resume retrained a done game"
    assert out2["scores"] == out["scores"]


def test_suite_rejects_no_eval():
    with pytest.raises(ValueError, match="eval_episodes"):
        run_suite_training(_suite_cfg().replace(eval_episodes=0),
                           "/tmp/unused", games=("pong",), device="cpu")


def test_suite_rejects_oversized_mesh_early():
    """atari57_apex carries dp=4 x tp=2; the port's learner runs on one
    card, so the suite fails before training, naming the multi-GPU
    item, with an actionable message."""
    from ape_x_dqn_tpu_torch.configs import ParallelConfig
    cfg = _suite_cfg().replace(parallel=ParallelConfig(dp=8, tp=2))
    with pytest.raises(ValueError, match="parallel.dp=1"):
        run_suite_training(cfg, "/tmp/unused", games=("pong",),
                           device="cpu")
    with pytest.raises(ValueError, match="item 14"):
        run_suite_training(cfg.replace(parallel=ParallelConfig(dp=2, tp=1)),
                           "/tmp/unused", games=("pong",), device="cpu")


def test_sharded_suite_writes_per_shard_files(tmp_path):
    """Shards sharing --out must not overwrite each other's aggregate,
    and a shard median must never appear under the suite-level key.
    The full suite.json comes only from
    aggregate_suite over the per-game result.json files."""
    out_dir = str(tmp_path / "suite")
    games = ("pong", "breakout")
    # two 1-game shards of the same 2-game list into the SAME out dir
    for i in range(2):
        agg = run_suite_training(
            _suite_cfg(), out_dir, games=games, shard=(i, 2),
            max_grad_steps_per_game=30,
            wall_clock_limit_s_per_game=120, device="cpu")
        assert agg["shard"] == [i, 2]
        assert "median_hns" not in agg
        assert "median_hns_synthetic" not in agg
        assert "shard_median_hns_synthetic" in agg
        assert (tmp_path / "suite" / f"suite.{i}of2.json").exists()
    assert not (tmp_path / "suite" / "suite.json").exists()

    # an aggregate over games still missing results must qualify its
    # median as partial — never the suite-level key
    part = aggregate_suite(out_dir, games=games + ("qbert",))
    assert part["complete"] is False
    assert "median_hns_synthetic" not in part
    assert "partial_median_hns_synthetic" in part

    full = aggregate_suite(out_dir, games=games)
    assert (tmp_path / "suite" / "suite.json").exists()
    assert full["complete"] is True
    assert set(full["scores"]) == set(games)
    assert "median_hns_synthetic" in full and "shard" not in full

    # --aggregate-only CLI reaches the same path
    rc = suite_main(["--out", out_dir, "--aggregate-only",
                     "--games", ",".join(games)])
    assert rc == 0


def test_atari57_suite_is_57_games():
    assert len(ATARI57_GAMES) == 57


def test_evaluate_suite_matches_the_jax_package():
    """The same numpy query_fn (a fixed linear policy over the frame)
    through both packages' evaluate_suite: the same per-game scores,
    HNS and backend-marked median."""
    from ape_x_dqn_tpu import configs as jax_configs
    from ape_x_dqn_tpu.runtime import evaluation as jax_eval

    rng = np.random.default_rng(0)
    # four q-values: a legal action in both games (pong 6, breakout 4)
    w = rng.standard_normal((84 * 84 * 4, 4)).astype(np.float32)

    def query_fn(obs):
        return np.asarray(obs, np.float32).reshape(-1) @ w / 255.0

    kw = dict(games=("pong", "breakout"), episodes_per_game=2,
              max_frames=1200)
    ours = evaluate_suite(get_config("pong").replace(
        env=EnvConfig(id="pong", kind="synthetic_atari")), query_fn, **kw)
    theirs = jax_eval.evaluate_suite(jax_configs.get_config("pong").replace(
        env=jax_configs.EnvConfig(id="pong", kind="synthetic_atari")),
        query_fn, **kw)
    assert ours == theirs


def test_cli_eval_only_restores_checkpoint(capsys, tmp_path):
    """--eval-only: train briefly with checkpoints, then evaluate the
    saved policy standalone (no learner, no actors) through the same
    CLI; the params that played are the checkpoint's."""
    import torch

    from ape_x_dqn_tpu_torch.runtime.evaluation import params_crc32

    ckpt = str(tmp_path / "ckpt")
    rc = main([
        "--config", "cartpole_smoke", "--device", "cpu",
        "--total-env-frames", "900",
        "--max-grad-steps", "30",
        "--actors", "1",
        "--checkpoint-dir", ckpt,
        "--set", "replay.kind=prioritized",
        "--set", "replay.capacity=2048",
        "--set", "replay.min_fill=64",
        "--set", "learner.batch_size=32",
        "--set", "inference.max_batch=8",
        "--set", "eval_every_steps=0",
        "--set", "eval_episodes=0",
    ])
    capsys.readouterr()
    assert rc == 0
    rc = main([
        "--config", "cartpole_smoke", "--eval-only", "--device", "cpu",
        "--checkpoint-dir", ckpt,
        "--set", "eval_episodes=2",
    ])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert out["restored_step"] is not None and out["restored_step"] >= 30
    assert out["episodes"] == 2 and out["mean_return"] > 0
    saved = torch.load(f"{ckpt}/{out['restored_step']}.pt",
                       weights_only=True)["params"]
    assert out["params_crc32"] == params_crc32(saved)


def test_cli_eval_only_suite_games(capsys):
    """--eval-only --games on an Atari config runs the HNS harness over
    the named games (the synthetic env stands in for ALE here)."""
    rc = main([
        "--config", "pong", "--eval-only", "--device", "cpu",
        "--games", "pong,breakout",
        "--set", "eval_episodes=1",
    ])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert set(out["scores"]) == {"pong", "breakout"}
    assert "median_hns_synthetic" in out and "median_hns" not in out
    assert out["restored_step"] is None


def test_cli_eval_only_r2d2_restores_checkpoint(capsys, tmp_path):
    """--eval-only on the recurrent family: restore an R2D2 checkpoint
    and run the stateful {obs,c,h} eval policy standalone."""
    from ape_x_dqn_tpu_torch.runtime.evaluation import params_crc32
    import torch

    ckpt = str(tmp_path / "ckpt")
    common = [
        "--config", "r2d2", "--device", "cpu",
        "--set", "env.id=CartPolePO", "--set", "env.kind=cartpole_po",
        "--set", "network.lstm_size=16", "--set", "network.torso_dense=32",
        "--set", "network.compute_dtype=float32",
        "--set", "replay.capacity=256", "--set", "replay.seq_length=8",
        "--set", "replay.seq_overlap=4", "--set", "replay.burn_in=2",
        "--set", "replay.min_fill=8", "--set", "replay.storage=flat",
        "--set", "learner.batch_size=8",
        "--set", "parallel.dp=1", "--set", "parallel.tp=1",
        "--set", "actors.num_actors=1",
        "--set", "eval_every_steps=0", "--set", "eval_episodes=0",
    ]
    rc = main(common + ["--total-env-frames", "600",
                        "--max-grad-steps", "10",
                        "--checkpoint-dir", ckpt])
    capsys.readouterr()
    assert rc == 0
    rc = main(common + ["--eval-only", "--checkpoint-dir", ckpt,
                        "--set", "eval_episodes=1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert out["restored_step"] is not None
    assert out["episodes"] == 1 and out["mean_return"] > 0
    saved = torch.load(f"{ckpt}/{out['restored_step']}.pt",
                       weights_only=True)["params"]
    assert out["params_crc32"] == params_crc32(saved)


def test_cli_eval_only_dpg_restores_checkpoint(capsys, tmp_path):
    """--eval-only on the continuous family: the actor and critic
    params map from the DPG checkpoint into the deterministic mu(s)
    eval policy."""
    from ape_x_dqn_tpu_torch.runtime.evaluation import (
        checkpoint_server_params, params_crc32)
    import torch

    ckpt = str(tmp_path / "ckpt")
    common = [
        "--config", "apex_dpg", "--device", "cpu",
        "--set", "env.id=pendulum", "--set", "network.dpg_hidden=(32,32)",
        "--set", "replay.capacity=512", "--set", "replay.min_fill=64",
        "--set", "learner.batch_size=16",
        "--set", "actors.num_actors=1",
        "--set", "eval_every_steps=0", "--set", "eval_episodes=0",
    ]
    rc = main(common + ["--total-env-frames", "600",
                        "--max-grad-steps", "10",
                        "--checkpoint-dir", ckpt])
    capsys.readouterr()
    assert rc == 0
    rc = main(common + ["--eval-only", "--checkpoint-dir", ckpt,
                        "--set", "eval_episodes=1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert out["restored_step"] is not None
    assert out["episodes"] == 1 and np.isfinite(out["mean_return"])
    saved = torch.load(f"{ckpt}/{out['restored_step']}.pt",
                       weights_only=True)["params"]
    assert out["params_crc32"] == params_crc32(
        checkpoint_server_params("dpg", saved))


def test_suite_and_eval_only_default_to_cuda(tmp_path):
    """The suite runner and --eval-only run on the card unless asked
    for the CPU: without one, a CUDA request raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        suite_main(["--config", "pong", "--out", str(tmp_path / "s"),
                    "--games", "pong", "--set", "parallel.dp=1",
                    "--set", "parallel.tp=1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--config", "cartpole_smoke", "--eval-only"])
