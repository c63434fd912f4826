"""The R2D2 family through the port's Ape-X driver and CLI on the CPU
(ape_x_dqn_tpu_torch/runtime/driver.py, family.py, evaluation.py,
train.py), at the original's small sizes (tests/test_r2d2_runtime.py):
recurrent actors -> stateful {obs, c, h} server queries -> sequence
ingest -> the SequenceLearner -> the recurrent greedy eval. Threads, so
these check wiring and accounting, not numbers; the stateful server
forward and the eval policy are held against the net's own step.

The masked-CartPole learning bar (eval mean return > 35, as
tests/test_r2d2_runtime.py sets it) needs the card: marked `cuda`, it
skips here."""

import json

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch.comm.transport import LoopbackTransport
from ape_x_dqn_tpu_torch.configs import (ActorConfig, EnvConfig,
                                         InferenceConfig, LearnerConfig,
                                         NetworkConfig, ParallelConfig,
                                         ReplayConfig, get_config)
from ape_x_dqn_tpu_torch.envs.base import EnvSpec
from ape_x_dqn_tpu_torch.models import build_network
from ape_x_dqn_tpu_torch.replay.packing import pad128
from ape_x_dqn_tpu_torch.runtime import train
from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
from ape_x_dqn_tpu_torch.runtime.evaluation import make_eval_policy_factory
from ape_x_dqn_tpu_torch.runtime.family import (actor_class, family_setup,
                                                server_apply_fn,
                                                warmup_example)
from ape_x_dqn_tpu_torch.runtime.sequence_learner import SequenceLearner
from ape_x_dqn_tpu_torch.runtime.vector_actor import RecurrentVectorActor


def _r2d2_cfg(num_actors=2, lstm=32, seq=16, overlap=8, burn_in=4):
    """The original's test config (tests/test_r2d2_runtime.py)."""
    return get_config("r2d2").replace(
        env=EnvConfig(id="CartPolePO", kind="cartpole_po"),
        network=NetworkConfig(kind="lstm_q", lstm_size=lstm, torso_dense=64,
                              dueling=True, compute_dtype="float32"),
        replay=ReplayConfig(kind="sequence", capacity=512, seq_length=seq,
                            seq_overlap=overlap, burn_in=burn_in,
                            min_fill=32, priority_eta=0.9),
        learner=LearnerConfig(batch_size=16, n_step=3, value_rescale=True,
                              target_sync_every=100, lr=1e-3,
                              publish_every=25, train_chunk=4),
        actors=ActorConfig(num_actors=num_actors, base_eps=0.4,
                           ingest_batch=64),
        inference=InferenceConfig(max_batch=8, deadline_ms=1.0),
        parallel=ParallelConfig(dp=1, tp=1),
        eval_every_steps=0,
    )


def test_r2d2_driver_end_to_end():
    cfg = _r2d2_cfg().replace(eval_every_steps=50, eval_episodes=2)
    driver = ApexDriver(cfg, device="cpu")
    assert driver.family == "r2d2"
    assert isinstance(driver.learner, SequenceLearner)
    out = driver.run(total_env_frames=2500, max_grad_steps=60,
                     wall_clock_limit_s=120)
    assert out["actor_errors"] == [], out["actor_errors"]
    assert out["loop_errors"] == [], out["loop_errors"]
    assert out["grad_steps"] >= 60, out
    assert out["frames"] >= 100, out
    assert out["episodes"] > 0
    assert driver.server.params_version > 0
    # the eval ran with the recurrent policy
    assert out["eval"] is not None and out["eval"]["episodes"] > 0
    # one unit is one sequence: the fill mirror counts sequences
    assert driver.state.replay.size == driver._replay_filled > 0


def test_r2d2_frame_sequences_through_the_vector_driver():
    """Pixel CNN-torso LSTM on synthetic catch with frame-mode sequence
    storage and vector actors: single-frame sequences staged whole, the
    packed seq_frames leaf in the flat replay, and the first shipped
    sequence read back from replay slot 0 bitwise."""
    cfg = get_config("r2d2").replace(
        env=EnvConfig(id="catch", kind="synthetic_atari", resize=42,
                      max_noop_start=4),
        network=NetworkConfig(kind="lstm_q", lstm_size=32, torso_dense=64,
                              dueling=True, compute_dtype="float32"),
        replay=ReplayConfig(kind="sequence", capacity=256, seq_length=16,
                            seq_overlap=8, burn_in=4, min_fill=16,
                            storage="frame_ring"),
        learner=LearnerConfig(batch_size=8, n_step=3, value_rescale=True,
                              target_sync_every=100, lr=1e-3,
                              publish_every=10, train_chunk=2,
                              sample_chunk=2),
        actors=ActorConfig(num_actors=1, envs_per_actor=2, base_eps=0.4,
                           ingest_batch=32),
        inference=InferenceConfig(max_batch=4, deadline_ms=1.0),
        parallel=ParallelConfig(dp=1, tp=1),
        eval_every_steps=0, eval_episodes=0)
    first: list[dict] = []

    class Recording(LoopbackTransport):
        def send_experience(self, batch):
            if not first:
                first.append({k: np.array(v, copy=True)
                              for k, v in batch.items()})
            super().send_experience(batch)

    driver = ApexDriver(cfg, transport=Recording(), device="cpu")
    assert driver.family == "r2d2" and not driver._frame_mode
    assert "seq_frames" in driver._item_keys
    assert actor_class("r2d2", vector=True) is RecurrentVectorActor
    out = driver.run(total_env_frames=1600, max_grad_steps=10,
                     wall_clock_limit_s=120)
    assert out["actor_errors"] == [], out["actor_errors"]
    assert out["loop_errors"] == [], out["loop_errors"]
    assert out["grad_steps"] >= 10, out
    assert driver.server.params_version > 0
    storage = driver.state.replay.storage
    assert storage["seq_frames"].shape == (256, pad128(19 * 42 * 42))
    seq = first[0]
    got = storage["seq_frames"][0, :19 * 42 * 42].reshape(19, 42, 42)
    np.testing.assert_array_equal(got.numpy(), seq["seq_frames"][0])
    for key in ("actions", "rewards", "terminals", "mask", "init_c",
                "init_h"):
        np.testing.assert_array_equal(storage[key][0].numpy(),
                                      seq[key][0], err_msg=key)


def test_r2d2_frame_sequences_reject_vector_obs():
    cfg = _r2d2_cfg()
    cfg = cfg.replace(replay=ReplayConfig(kind="sequence", capacity=512,
                                          seq_length=16, seq_overlap=8,
                                          storage="frame_ring"))
    with pytest.raises(ValueError, match="pixel obs"):
        ApexDriver(cfg, device="cpu")


def test_r2d2_drops_count_transitions_at_teardown():
    """The force-flush drops a sub-block tail of whole sequences and
    counts seq_length transitions for each (the original's
    denomination); env frames stay counted."""
    cfg = _r2d2_cfg().replace(actors=ActorConfig(num_actors=1,
                                                 ingest_batch=48))
    driver = ApexDriver(cfg, device="cpu")
    driver._stage_chunk = 4          # a 4-sequence block: 3 stay staged
    driver._stager = type(driver._stager)(
        driver._item_spec, (), block_units=4, coalesce=1, buffers=1,
        ship=driver._ship_staged)
    items = {k: np.zeros((3, *s.shape), np.float32 if s.dtype
                         == torch.float32 else np.int32)
             for k, s in driver._item_spec.items()}
    driver._ingest_one({**items, "priorities": np.ones(3, np.float32),
                        "frames": 40}, 3)
    driver._flush_stage(force=True)
    assert driver._stage_dropped == 3 * cfg.replay.seq_length
    assert driver._frames_total == 40
    assert driver.state.replay.size == 0
    driver.server.stop()


def test_stateful_server_forward_and_recurrent_eval_policy():
    """{obs, c, h} -> {q, c, h} on the server's params equals the net's
    own step, and the eval policy carries (c, h) from one query to the
    next within an episode."""
    cfg = _r2d2_cfg()
    spec = EnvSpec((2,), np.dtype(np.float32), True, 2)
    net = build_network(cfg.network, spec)
    setup = family_setup(cfg, spec, net, np.zeros(2, np.float32))
    assert setup.stage_chunk == 64 // 16 and setup.unit_items == 1
    params = {k: v.detach().clone() for k, v in net.state_dict().items()}
    apply = server_apply_fn("r2d2", net)
    ex = warmup_example("r2d2", cfg, spec)
    assert set(ex) == {"obs", "c", "h"} and ex["c"].shape == (32,)
    rng = np.random.default_rng(0)
    inp = {"obs": torch.from_numpy(rng.normal(size=(3, 2)).astype(
               np.float32)),
           "c": torch.from_numpy(rng.normal(size=(3, 32)).astype(
               np.float32)),
           "h": torch.from_numpy(rng.normal(size=(3, 32)).astype(
               np.float32))}
    with torch.no_grad():
        out = apply(params, inp)
        q, (c, h) = net.step(inp["obs"], (inp["c"], inp["h"]))
    for got, want in ((out["q"], q), (out["c"], c), (out["h"], h)):
        assert torch.equal(got, want)

    seen = []

    def query(req):
        seen.append((req["c"].copy(), req["h"].copy()))
        return {"q": np.zeros(2, np.float32),
                "c": req["c"] + 1.0, "h": req["h"] - 1.0}

    policy = make_eval_policy_factory("r2d2", 32, query)()
    for _ in range(3):
        policy(np.zeros(2, np.float32))
    assert [float(c[0]) for c, _ in seen] == [0.0, 1.0, 2.0]
    assert [float(h[0]) for _, h in seen] == [0.0, -1.0, -2.0]
    # a fresh episode starts from zeros
    make_eval_policy_factory("r2d2", 32, query)()(np.zeros(2, np.float32))
    assert float(seen[-1][0][0]) == 0.0


def test_cli_runs_the_r2d2_preset_through_the_driver(capsys):
    """`--config r2d2` with the dp/tp sets reaches the driver (here cut
    to masked CartPole on the CPU); the preset's own dp=4, tp=2 is the
    multi-GPU learner and stays refused."""
    sets = ["parallel.dp=1", "parallel.tp=1", "env.kind=cartpole_po",
            "env.id=CartPolePO", "network.lstm_size=16",
            "network.torso_dense=32", "network.compute_dtype=float32",
            "replay.storage=flat", "replay.capacity=256",
            "replay.seq_length=8", "replay.seq_overlap=4",
            "replay.burn_in=2", "replay.min_fill=16",
            "learner.batch_size=8", "learner.sample_chunk=2",
            "actors.envs_per_actor=2", "eval_episodes=1"]
    argv = ["--config", "r2d2", "--device", "cpu", "--actors", "2",
            "--total-env-frames", "3000", "--max-grad-steps", "8",
            "--wall-clock-limit", "60"]
    for s in sets:
        argv += ["--set", s]
    rc = train.main(argv)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, out
    assert out["actor_errors"] == [] and out["loop_errors"] == []
    assert out["grad_steps"] >= 8
    assert out["eval"] is not None and out["eval"]["episodes"] == 1
    with pytest.raises(NotImplementedError, match="item 14\\b"):
        train.main(["--config", "r2d2", "--device", "cpu"])


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import: every xdist worker
    must collect the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the learning bar runs the driver "
                    "on the card")
    return "cuda"


@pytest.mark.cuda
def test_r2d2_learns_masked_cartpole_on_the_card(cuda_device):
    """The original's learning bar (tests/test_r2d2_runtime.py:
    test_r2d2_improves_masked_cartpole), on the card: greedy recurrent
    eval over 10 episodes above 35 (the untrained plateau is ~22)."""
    cfg = _r2d2_cfg(num_actors=2, lstm=64).replace(
        eval_every_steps=0, eval_episodes=10, total_env_frames=40_000)
    driver = ApexDriver(cfg, device=cuda_device)
    out = driver.run(max_grad_steps=10**9, wall_clock_limit_s=480)
    print(json.dumps({k: out[k] for k in ("frames", "grad_steps", "wall_s",
                                          "episodes", "avg_return",
                                          "eval")}))
    assert out["actor_errors"] == [] and out["loop_errors"] == []
    assert out["eval"] is not None
    assert out["eval"]["mean_return"] > 35, out["eval"]
