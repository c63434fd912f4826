"""The frame budget and the pacing cap of the port's multi-host learner,
two gloo processes on the CPU through the CLI: the original's
tests/test_multihost.py `:99` and `:176` with its `_SETS` and budgets
(helpers in tests/test_torch_multihost_cli.py)."""

from tests.test_torch_multihost_cli import run_pair


def test_frame_budget_terminates_when_total_unreachable():
    """Per-actor budget truncation (1001 frames / 2 procs / 3 actors ->
    at most 996 produced) must not hang the frame-budget round loop:
    the all-hosts-idle check breaks it."""
    outs = run_pair(["--total-env-frames", "1001",
                     "--set", "actors.num_actors=3"])
    # per-actor truncation: 1001 // 2 procs // 3 actors = 166 each
    assert outs[0]["frames"] == outs[1]["frames"] <= 996
    assert outs[0]["frames"] > 0


def test_multihost_steps_per_frame_cap_binds():
    """learner.steps_per_frame_cap paces the lockstep learner to the
    GLOBAL frame count, and the fleet still terminates when the cap
    binds forever after the actors finish."""
    cap = 0.05
    outs = run_pair(["--total-env-frames", "800",
                     "--set", f"learner.steps_per_frame_cap={cap}"])
    assert outs[0]["grad_steps"] == outs[1]["grad_steps"]
    assert outs[0]["grad_steps"] > 0, outs
    # pacing rechecks before each <= train_chunk dispatch
    assert outs[0]["grad_steps"] <= cap * outs[0]["frames"] + 2, outs
