"""Ape-X DPG through the port's driver: noisy continuous actors ->
batched mu(s) + Q(s, mu(s)) inference -> ingest -> the DPG learner ->
deterministic eval, from the CLI's default mode (the counterparts of
tests/test_dpg_runtime.py's driver cases). The file imports no JAX, so
its card case runs on a machine with the card with

    python -m pytest --noconftest -m cuda -s tests/test_torch_dpg_driver.py

The CPU cases run the native pendulum at the `_dpg_cfg` size of the
original's tests (64x64 nets, a 16,384-slot replay, 2 actors); the
humanoid case steps the real dm_control physics, which imports here.
The learning bar is the original's: greedy eval on the native pendulum
above -400 (a random policy scores about -1400), as a `slow` CPU test
and as a card test. Over the real dm_control physics (ids with an
underscore): the original's driver e2e on pendulum swingup (`slow`
here: about 55 s on the CPU), and its two `slow` bars, eval above 200 on pendulum swingup within 60,000 frames
and above 90 on walker stand within 120,000, each also as a card case
(which skips where dm_control is not installed)."""

import json

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch.configs import LearnerConfig, get_config
from ape_x_dqn_tpu_torch.envs import make_env
from ape_x_dqn_tpu_torch.envs.control import HAVE_DM_CONTROL
from ape_x_dqn_tpu_torch.models import build_network, init_params
from ape_x_dqn_tpu_torch.replay.prioritized import PrioritizedReplay
from ape_x_dqn_tpu_torch.runtime import train
from ape_x_dqn_tpu_torch.runtime.dpg_learner import (DPGLearner,
                                                     continuous_item_spec)
from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
from ape_x_dqn_tpu_torch.runtime.family import server_apply_fn
from ape_x_dqn_tpu_torch.utils.rng import component_generator

# `_dpg_cfg` of tests/test_dpg_runtime.py, as CLI overrides of the
# apex_dpg preset (2 actors: --actors 2)
DPG_SETS = (
    "env.id=pendulum", "network.dpg_hidden=(64,64)",
    "network.compute_dtype=float32", "replay.capacity=16384",
    "replay.min_fill=256", "learner.batch_size=64", "learner.n_step=5",
    "learner.gamma=0.99", "learner.critic_lr=1e-3",
    "learner.policy_lr=5e-4", "learner.tau=0.01",
    "learner.publish_every=25", "learner.train_chunk=4",
    "actors.ingest_batch=32", "actors.noise_sigma=0.15",
    "inference.max_batch=8", "inference.deadline_ms=1.0",
    "parallel.dp=1", "parallel.tp=1", "eval_every_steps=0",
    "eval_episodes=3")


def _argv(device, frames, wall, *extra):
    argv = ["--config", "apex_dpg", "--device", device, "--actors", "2",
            "--total-env-frames", str(frames), "--wall-clock-limit",
            str(wall)]
    for s in (*DPG_SETS, *extra):
        argv += ["--set", s]
    return argv


def _cli(capsys, argv) -> dict:
    rc = train.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1, lines
    return json.loads(lines[0])


def test_cli_runs_apex_dpg_through_the_driver(capsys):
    """`python -m ape_x_dqn_tpu_torch.runtime.train --config apex_dpg
    --set env.id=pendulum ...` at the original's test size, paced at one
    grad-step per frame (its test_dpg_driver_end_to_end)."""
    out = _cli(capsys, _argv("cpu", 2400, 240,
                             "learner.steps_per_frame_cap=1.0"))
    assert out["actor_errors"] == [] and out["loop_errors"] == [], out
    assert out["grad_steps"] >= 60 and out["frames"] >= 1000, out
    assert out["episodes"] > 0
    assert out["eval"] is not None and out["eval"]["episodes"] > 0
    assert out["server"]["items"] > 0


def test_driver_publishes_and_keeps_the_gate_for_an_eager_learner():
    """The driver builds the DPG family: the learner is a DPGLearner,
    the server answers {a, q} and has seen a publication; on the CPU
    the learner is eager, so the learner-priority gate stays on."""
    from ape_x_dqn_tpu_torch.runtime.train import apply_overrides

    cfg = apply_overrides(get_config("apex_dpg"), list(DPG_SETS))
    driver = ApexDriver(cfg.replace(actors=type(cfg.actors)(
        num_actors=1, ingest_batch=32, noise_sigma=0.15)), device="cpu")
    assert driver.family == "dpg" and isinstance(driver.learner, DPGLearner)
    assert driver._gate_actors and not driver.learner.graphed
    out = driver.run(total_env_frames=800, max_grad_steps=10 ** 9,
                     wall_clock_limit_s=120)
    assert out["actor_errors"] == [] and out["loop_errors"] == [], out
    assert out["grad_steps"] > 0 and driver.server.params_version > 0
    assert out["eval"] is not None
    apply = server_apply_fn("dpg", driver.net)
    reply = apply(driver.learner.publish_params(driver.state),
                  torch.zeros(5, 3))
    assert reply["a"].shape == (5, 1) and reply["q"].shape == (5,)
    assert float(reply["a"].abs().max()) <= 2.0


@pytest.mark.skipif(not HAVE_DM_CONTROL, reason="dm_control not installed")
def test_dpg_humanoid_stand_smoke():
    """The real humanoid (67-d obs, 21-d action): 128 transitions from
    the real physics, then five finite-loss grad-steps (the original's
    test_dpg_humanoid_stand_smoke)."""
    cfg = get_config("apex_dpg")
    assert cfg.env.id == "humanoid_stand"
    env = make_env(cfg.env, seed=0)
    assert env.spec.obs_shape == (67,) and env.spec.action_dim == 21
    net_cfg = cfg.network.__class__(kind="dpg", dpg_hidden=(64, 64),
                                    compute_dtype="float32")
    actor, critic = build_network(net_cfg, env.spec)
    init_params(actor, component_generator(0, "actor_init"))
    init_params(critic, component_generator(0, "critic_init"))
    replay = PrioritizedReplay(1024, device="cpu")
    learner = DPGLearner(replay, LearnerConfig(
        batch_size=32, n_step=5, critic_lr=1e-3, policy_lr=1e-4, tau=0.05))
    state = learner.init(actor, critic, replay.init(
        continuous_item_spec((67,), np.float32, 21)),
        component_generator(0, "learner"))
    rng = np.random.default_rng(0)
    obs = env.reset()
    cols = {k: [] for k in ("obs", "action", "reward", "next_obs")}
    for _ in range(128):
        a = rng.uniform(-1, 1, 21).astype(np.float32)
        nxt, r, done, _ = env.step(a)
        for k, v in zip(cols, (obs, a, r, nxt)):
            cols[k].append(v)
        obs = env.reset() if done else nxt
    items = {k: torch.from_numpy(np.asarray(np.stack(v), np.float32))
             for k, v in cols.items()}
    items["discount"] = torch.full((128,), 0.99)
    state = learner.add(state, items, torch.ones(128))
    state, m = learner.train_many(state, 5)
    assert state.step == 5
    assert np.isfinite(m["loss"].item()) and np.isfinite(
        m["policy_loss"].item())


def _bar(capsys, device) -> dict:
    """The original's test_dpg_improves_pendulum: 60,000 frames, no
    pacing cap, greedy eval above -400."""
    out = _cli(capsys, _argv(device, 60_000, 600))
    assert out["actor_errors"] == [] and out["loop_errors"] == [], out
    assert out["eval"] is not None, out
    assert out["eval"]["mean_return"] > -400, out["eval"]
    return out


@pytest.mark.slow
def test_dpg_improves_pendulum(capsys):
    _bar(capsys, "cpu")


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the card's learner replays "
                    "captured CUDA graphs")
    return torch.device("cuda")


@pytest.mark.cuda
def test_dpg_improves_pendulum_on_the_card(cuda_device, capsys):
    out = _bar(capsys, "cuda")
    with capsys.disabled():
        print(f"\ndpg pendulum bar on the card: eval {out['eval']}; "
              f"frames {out['frames']}, grad_steps {out['grad_steps']}, "
              f"wall {out['wall_s']:.1f} s")


# -- the real dm_control physics (ids with an underscore route to the
# DMControlAdapter): the original's three driver cases over it

def _real(device, env_id, frames, wall, *extra) -> list[str]:
    return _argv(device, frames, wall, f"env.id={env_id}", *extra)


@pytest.mark.slow
@pytest.mark.skipif(not HAVE_DM_CONTROL, reason="dm_control not installed")
def test_dpg_driver_real_dm_control_e2e(capsys):
    """The driver against REAL MuJoCo physics (pendulum swingup): the
    original's test_dpg_driver_real_dm_control_e2e, paced at one
    grad-step per frame past min_fill. `slow`: ~55 s on the CPU (the
    three 1,000-step eval episodes of the real physics), past the 30 s
    a tier-1 test may take."""
    out = _cli(capsys, _real("cpu", "pendulum_swingup", 2400, 240,
                             "learner.steps_per_frame_cap=1.0"))
    assert out["actor_errors"] == [] and out["loop_errors"] == [], out
    assert out["grad_steps"] >= 60 and out["frames"] >= 1000, out
    # deterministic eval on the real physics; swingup rewards lie in
    # [0, 1] a step, so a return lies in [0, 1000]
    assert out["eval"] is not None and out["eval"]["episodes"] > 0
    assert 0.0 <= out["eval"]["mean_return"] <= 1000.0


# the original's real-physics bars: (env.id, frames, wall s, eval above)
REAL_BARS = {"pendulum": ("pendulum_swingup", 60_000, 600, 200.0),
             "walker_stand": ("walker_stand", 120_000, 900, 90.0)}


def _real_bar(capsys, device, which) -> dict:
    if not HAVE_DM_CONTROL:
        pytest.skip("dm_control not installed (the real physics)")
    env_id, frames, wall, above = REAL_BARS[which]
    out = _cli(capsys, _real(device, env_id, frames, wall))
    assert out["actor_errors"] == [] and out["loop_errors"] == [], out
    assert out["eval"] is not None, out
    assert out["eval"]["mean_return"] > above, out["eval"]
    return out


@pytest.mark.slow
def test_dpg_improves_real_pendulum(capsys):
    """The original's bar: greedy eval above 200 on the real pendulum
    swingup within 60,000 frames (random: ~0-80)."""
    _real_bar(capsys, "cpu", "pendulum")


@pytest.mark.slow
def test_dpg_improves_real_walker_stand(capsys):
    """The original's bar: greedy eval above 90 on the real walker
    stand within 120,000 frames (random: ~25-45)."""
    _real_bar(capsys, "cpu", "walker_stand")


@pytest.mark.slow
@pytest.mark.cuda
@pytest.mark.parametrize("which", list(REAL_BARS))
def test_dpg_improves_real_physics_on_the_card(cuda_device, capsys, which):
    out = _real_bar(capsys, "cuda", which)
    with capsys.disabled():
        print(f"\ndpg {which} bar on the card: eval {out['eval']}; frames "
              f"{out['frames']}, grad_steps {out['grad_steps']}, wall "
              f"{out['wall_s']:.1f} s")
