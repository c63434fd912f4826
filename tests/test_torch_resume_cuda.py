"""A resumed learner on the card: after a checkpoint restore, the
captured graph's first replay equals an eager step from the same
restored state, bitwise, for the four learners (frame ring, flat,
sequence, DPG). Marked `cuda`, it skips without a card: a CUDA graph
has no CPU mode. On the card's machine (no JAX) run it with

    python -m pytest --noconftest -m cuda tests/test_torch_resume_cuda.py

Each case trains a learner through its graph (warm-up, capture,
replay), checkpoints its whole state (the replay included) through the
CheckpointManager, and restores the file into two fresh learners built
the same way: one with `capture` on, one eager. The restore writes into
the tensors each fresh state holds, before either has captured, so the
graph is captured over the restored values. Both then take the same
three steps; the second is the graph's capture and first replay.

The driver's saves on the card are held too: the save at shutdown runs
on the main thread's stream while train dispatches may still run on the
learner's, and the file must hold the state those dispatches leave,
stamped with their step."""

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch.comm.param_codec import tree_map
from ape_x_dqn_tpu_torch.configs import get_config
from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
from ape_x_dqn_tpu_torch.runtime.learner import (checkpoint_tree,
                                                 restore_checkpoint_tree)
from ape_x_dqn_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_graph_cuda import (CASES, _snapshot,  # noqa: F401
                                         cuda_device)


def _step(learner, state, k):
    return (learner.train_step_k(state, k) if k > 1
            else learner.train_step(state))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: t for k, v in tree.items()
                for p, t in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {p: t for i, v in enumerate(tree)
                for p, t in _flat(v, f"{prefix}{i}/").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu()}
    return {prefix: torch.tensor(tree)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_first_replay_after_a_resume_matches_an_eager_step(
        cuda_device, case, tmp_path):
    make, _ = CASES[case]
    learner, state, add, k = make(cuda_device)
    state = add(state, np.random.default_rng(0), 64 if k > 1 else 8)
    for _ in range(3):  # warm-up, capture + replay, replay
        state, _ = _step(learner, state, k)
    assert learner.graphed
    mngr = CheckpointManager(str(tmp_path / "ck"))
    payload = tree_map(lambda x: x.detach().clone()
                       if isinstance(x, torch.Tensor) else x,
                       checkpoint_tree(state, with_replay=True))
    ready = torch.cuda.Event()
    ready.record()
    mngr.save(state.step, payload, wait=True, ready=ready)
    saved = mngr.restore()
    want = _flat(payload)

    runs = []
    for capture in (True, False):
        fresh, fstate, _, _ = make(cuda_device)
        fresh.capture = capture
        restore_checkpoint_tree(fstate, saved)
        got = _flat(checkpoint_tree(fstate, with_replay=True))
        assert got.keys() == want.keys()
        for name in want:
            assert torch.equal(got[name], want[name]), \
                f"{case}: {name} not restored bitwise"
        snaps = []
        for _ in range(3):
            fstate, m = _step(fresh, fstate, k)
            snaps.append(_snapshot(fstate, m))
        torch.cuda.synchronize()
        runs.append((fresh, fstate, snaps))
    (gl, gs, gsnaps), (el, es, esnaps) = runs
    key = ("k", 4) if k > 1 else "step"
    assert gl.step_graphs()[key].captured
    assert not el.step_graphs()[key].captured
    for i in (0, 1, 2):  # the warm-up, the first replay, a replay
        for name in gsnaps[i]:
            assert torch.equal(gsnaps[i][name], esnaps[i][name]), \
                f"{case}: {name} differs after resumed step {i + 1}"
    assert gs.step == es.step == int(saved["step"]) + 3 * k


def _assert_file_holds(mngr, state, step):
    assert mngr.latest_step() == step
    saved = _flat(mngr.restore(step))
    live = _flat(checkpoint_tree(state))
    for name in live:
        if name.startswith(("params/", "target_params/", "opt_state/")):
            assert torch.equal(saved[name], live[name]), \
                f"{name}: the file is not the live state of step {step}"
    assert int(saved["step/"]) == state.step == step


@pytest.mark.cuda
def test_a_save_at_shutdown_holds_the_state_of_its_step(cuda_device,
                                                         tmp_path):
    """A driver on the card with eval off saves at shutdown; the file
    equals the live state once the card is synchronised. Then train
    dispatches are left in flight on the learner's stream and the save
    is made on this thread's stream at once, as the shutdown save is:
    the file must hold what those dispatches leave, not a state taken
    mid-update."""
    cfg = get_config("cartpole_smoke").replace(
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=10**9,
        eval_every_steps=0, eval_episodes=0)
    d = ApexDriver(cfg, device=cuda_device)
    out = d.run(total_env_frames=20_000, max_grad_steps=64,
                wall_clock_limit_s=120)
    assert out["actor_errors"] == [] and out["loop_errors"] == []
    assert out["checkpoint_saves"] == 1  # the save at shutdown alone
    torch.cuda.synchronize()
    _assert_file_holds(d.ckpt, d.state, out["grad_steps"])

    k = cfg.learner.train_chunk
    with torch.cuda.stream(d._learn_stream):
        for _ in range(16):
            d.state, _ = d.learner.train_many(d.state, k)
            d._grad_steps_total += k
    d._save_checkpoint(wait=True)
    torch.cuda.synchronize()
    _assert_file_holds(d.ckpt, d.state, out["grad_steps"] + 16 * k)
