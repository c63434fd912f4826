"""Checkpoint/resume in the port (utils/checkpoint.py, the driver's
save and in-place restore), ported from tests/test_checkpoint.py: the
manager round-trips a payload bitwise, stamps its storage layout and
turns a mismatch into the recovery guidance; a resumed driver restores
params, target, optimizer, RNG and step bitwise and continues its
grad-step counter; replay contents ride along under checkpoint_replay;
restores follow what the file holds, not the flag. Plus the port's own
traps: restores write into the tensors the learner already holds (the
captured graphs' addresses), the DPG and R2D2 states round-trip too, a
failed write raises, and saves keep the newest three."""

import dataclasses

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch.configs import (
    ActorConfig, InferenceConfig, LearnerConfig, ReplayConfig, get_config)
from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
from ape_x_dqn_tpu_torch.runtime.learner import checkpoint_tree
from ape_x_dqn_tpu_torch.runtime.train import apply_overrides
from ape_x_dqn_tpu_torch.utils import checkpoint as ckpt_mod
from ape_x_dqn_tpu_torch.utils.checkpoint import CheckpointManager


def _ckpt_cfg(tmp_path, **kw):
    return get_config("cartpole_smoke").replace(
        actors=ActorConfig(num_actors=1, base_eps=0.6, ingest_batch=16),
        replay=ReplayConfig(kind="prioritized", capacity=2048, min_fill=64),
        learner=LearnerConfig(batch_size=32, n_step=3,
                              target_sync_every=100, publish_every=20),
        inference=InferenceConfig(max_batch=8, deadline_ms=1.0),
        checkpoint_dir=str(tmp_path / "ckpt"),
        checkpoint_every=20,
        eval_every_steps=0, eval_episodes=0,
        **kw)


def _flat_tensors(tree, prefix=""):
    """{path: tensor} of a checkpoint tree, for bitwise comparisons."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_tensors(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat_tensors(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().clone()
    else:
        out[prefix] = torch.tensor(tree)
    return out


def _assert_trees_equal(a, b):
    fa, fb = _flat_tensors(a), _flat_tensors(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def test_checkpoint_manager_roundtrip(tmp_path):
    mngr = CheckpointManager(str(tmp_path / "m"))
    payload = {"params": {"w": torch.arange(6, dtype=torch.float32)
                          .reshape(2, 3)},
               "opt": {"mu": [torch.ones(2), torch.zeros(1)]},
               "np": np.arange(3, dtype=np.int64), "step": 7}
    mngr.save(7, payload, wait=True)
    assert mngr.latest_step() == 7
    got = mngr.restore(template=payload)
    assert torch.equal(got["params"]["w"], payload["params"]["w"])
    assert torch.equal(got["opt"]["mu"][0], torch.ones(2))
    assert torch.equal(got["np"], torch.arange(3))  # numpy -> tensor
    assert got["step"] == 7
    # the file loads with weights_only: tensors, ints and containers
    raw = torch.load(tmp_path / "m" / "7.pt", weights_only=True)
    assert raw[ckpt_mod._LAYOUT_KEY] == ckpt_mod.STORAGE_LAYOUT_VERSION
    mngr.close()


def test_checkpoint_manager_keeps_the_newest_three(tmp_path):
    mngr = CheckpointManager(str(tmp_path / "m"))
    for step in (10, 20, 30, 40, 50):
        mngr.save(step, {"step": step})
    mngr.close()  # joins the write in flight
    assert mngr.all_steps() == [30, 40, 50]
    assert not list((tmp_path / "m").glob("*.tmp.*"))  # renamed into place


def test_failed_checkpoint_write_raises(tmp_path, monkeypatch):
    """A write that fails is never silent: the next save, a wait and
    the close raise it; no torn file is left behind."""
    mngr = CheckpointManager(str(tmp_path / "m"))

    def boom(obj, f, *a, **kw):
        open(f, "wb").write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", boom)
    mngr.save(1, {"step": 1})
    with pytest.raises(RuntimeError, match="disk full"):
        mngr.wait_until_finished()
    assert mngr.latest_step() is None
    assert not list((tmp_path / "m").iterdir())


def test_checkpoint_layout_version_stamp_transparent(tmp_path):
    """Every payload carries a storage-layout version stamp on disk,
    yet callers never see it; a version mismatch fails loudly with the
    recovery guidance."""
    mngr = CheckpointManager(str(tmp_path / "m"))
    payload = {"params": {"w": torch.ones(2, 3)}, "step": 5}
    mngr.save(5, payload, wait=True)
    raw = mngr._raw_item_keys(5)
    assert raw is not None and ckpt_mod._LAYOUT_KEY in raw
    assert mngr.item_keys(5) == {"params", "step"}
    got = mngr.restore(template=payload)
    assert ckpt_mod._LAYOUT_KEY not in got
    assert torch.equal(got["params"]["w"], payload["params"]["w"])
    mngr.save(6, {**payload, ckpt_mod._LAYOUT_KEY: 999}, wait=True)
    with pytest.raises(RuntimeError, match="storage layout v999"):
        mngr.restore(step=6, template=payload)
    mngr.close()


def test_checkpoint_structure_mismatch_guidance(tmp_path):
    """A payload whose structure does not match the template surfaces
    as a RuntimeError carrying the recovery guidance."""
    mngr = CheckpointManager(str(tmp_path / "m"))
    mngr.save(3, {"params": {"w": torch.ones(4, 4)}, "step": 3}, wait=True)
    bad = {"params": {"w": torch.zeros(4, 4)},
           "replay_frames": torch.zeros(8, 128, dtype=torch.uint8),
           "step": 0}
    with pytest.raises(RuntimeError, match="restart the run fresh"):
        mngr.restore(step=3, template=bad)
    with pytest.raises(RuntimeError, match="restart the run fresh"):
        mngr.restore(step=3, template={"params": {"w": torch.zeros(4, 5)},
                                       "step": 0})
    mngr.close()


def test_driver_saves_and_resumes(tmp_path):
    cfg = _ckpt_cfg(tmp_path)
    d1 = ApexDriver(cfg, device="cpu")
    out1 = d1.run(total_env_frames=1500, max_grad_steps=50,
                  wall_clock_limit_s=120)
    assert out1["actor_errors"] == [] and out1["loop_errors"] == []
    assert out1["grad_steps"] >= 50
    assert d1.ckpt.latest_step() == out1["grad_steps"]
    assert out1["checkpoint_saves"] >= 3  # every 20 grad-steps + the end
    final = checkpoint_tree(d1.state)

    # a fresh driver restores the newest checkpoint bitwise, in place,
    # and resumes the grad-step counter
    d2 = ApexDriver(cfg, device="cpu")
    assert d2._grad_steps_total == out1["grad_steps"]
    assert d2.state.step == out1["grad_steps"]
    _assert_trees_equal(checkpoint_tree(d2.state), final)
    assert int(d2.state.opt_state.count) == out1["grad_steps"]
    # the restored params were published to the fresh inference server
    assert d2.server.params_version == out1["grad_steps"]

    # the resumed run continues to an ABSOLUTE grad-step target
    out2 = d2.run(total_env_frames=1500,
                  max_grad_steps=out1["grad_steps"] + 20,
                  wall_clock_limit_s=120)
    assert out2["actor_errors"] == [] and out2["loop_errors"] == []
    assert out2["grad_steps"] >= out1["grad_steps"] + 20
    assert d2.ckpt.latest_step() == out2["grad_steps"]


def test_resumed_driver_paces_from_its_restored_step(tmp_path):
    """learner.steps_per_frame_cap counts the grad-steps and frames of
    THIS run: a driver resumed at step S without its replay trains once
    it has refilled min_fill and this run's frames allow it, instead of
    waiting until its frames reach S / cap."""
    cfg = _ckpt_cfg(tmp_path)
    cfg = cfg.replace(learner=dataclasses.replace(
        cfg.learner, steps_per_frame_cap=0.05))
    d1 = ApexDriver(cfg, device="cpu")
    out1 = d1.run(total_env_frames=1500, max_grad_steps=40,
                  wall_clock_limit_s=120)
    assert out1["actor_errors"] == [] and out1["loop_errors"] == []
    assert out1["grad_steps"] >= 40

    d2 = ApexDriver(cfg, device="cpu")
    assert d2._grad_steps_total == out1["grad_steps"]
    assert d2._pacing_binds(0) and not d2._pacing_binds(100)
    # 600 frames allow 30 grad-steps of this run; counted from step 0
    # they would allow none (40 >= 0.05 * 600)
    out2 = d2.run(total_env_frames=600,
                  max_grad_steps=out1["grad_steps"] + 10,
                  wall_clock_limit_s=120)
    assert out2["actor_errors"] == [] and out2["loop_errors"] == []
    assert out2["grad_steps"] >= out1["grad_steps"] + 10


def test_restore_writes_into_the_tensors_the_state_holds():
    """A restore never rebinds a tensor (a captured graph holds their
    addresses): params, targets, Adam's moments and device count, the
    replay's storage and sum-tree keep their storage, take the saved
    values, and the cursor's device mirrors follow the setters."""
    from ape_x_dqn_tpu_torch.runtime.learner import restore_checkpoint_tree
    from ape_x_dqn_tpu_torch.comm.param_codec import tree_map

    cfg = get_config("cartpole_smoke").replace(
        replay=ReplayConfig(kind="prioritized", capacity=256, min_fill=64),
        inference=InferenceConfig(max_batch=8, deadline_ms=1.0))
    d = ApexDriver(cfg, device="cpu")
    try:
        live = checkpoint_tree(d.state, with_replay=True)
        ptrs = {id(t): t.data_ptr() for t in _live(live)}
        saved = tree_map(lambda x: x.clone() + 1
                         if isinstance(x, torch.Tensor)
                         and x.dtype != torch.uint8 else x, live)
        saved["rng"] = d.state.generator.get_state()
        saved["replay"]["pos"], saved["replay"]["size"] = 5, 9
        saved["step"] = 3
        restore_checkpoint_tree(d.state, saved)
        assert {id(t): t.data_ptr() for t in _live(live)} == ptrs
        _assert_trees_equal(checkpoint_tree(d.state, with_replay=True),
                            saved)
        assert int(d.state.opt_state.count) == 1
        assert (int(d.state.replay.pos_dev),
                int(d.state.replay.size_dev)) == (5, 9)
    finally:
        d.server.stop()


def _live(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _live(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _live(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def test_replay_contents_checkpoint_skips_min_fill(tmp_path):
    """Opt-in replay checkpointing: a resumed driver restores the replay
    (storage, sum-tree, cursor and fill with their device mirrors) and
    can train at once."""
    cfg = _ckpt_cfg(tmp_path, checkpoint_replay=True)
    d1 = ApexDriver(cfg, device="cpu")
    out1 = d1.run(total_env_frames=1500, max_grad_steps=50,
                  wall_clock_limit_s=120)
    assert out1["actor_errors"] == [] and out1["loop_errors"] == []
    filled1 = d1._replay_filled
    assert filled1 >= cfg.replay.min_fill
    r1 = d1.state.replay

    d2 = ApexDriver(cfg, device="cpu")
    try:
        assert d2._replay_filled == filled1
        assert d2._replay_filled >= d2._min_fill()
        r2 = d2.state.replay
        assert torch.equal(r2.tree, r1.tree)
        for k in r1.storage:
            assert torch.equal(r2.storage[k], r1.storage[k]), k
        assert (r2.pos, r2.size) == (r1.pos, r1.size)
        assert (int(r2.pos_dev), int(r2.size_dev)) == (r1.pos, r1.size)
        state, m = d2.learner.train_step(d2.state)
        assert np.isfinite(float(m["loss"]))
    finally:
        d2.server.stop()


def test_checkpoint_replay_flag_toggle_does_not_brick_resume(tmp_path):
    """checkpoint_replay governs SAVES; restores follow what the file
    holds — toggling the flag between runs neither fails the restore
    nor loses saved replay contents."""
    cfg_off = _ckpt_cfg(tmp_path)
    d1 = ApexDriver(cfg_off, device="cpu")
    out1 = d1.run(total_env_frames=1500, max_grad_steps=40,
                  wall_clock_limit_s=120)
    assert out1["actor_errors"] == [] and out1["loop_errors"] == []

    cfg_on = cfg_off.replace(checkpoint_replay=True)
    d2 = ApexDriver(cfg_on, device="cpu")
    assert d2._grad_steps_total == out1["grad_steps"]
    out2 = d2.run(total_env_frames=1500,
                  max_grad_steps=out1["grad_steps"] + 20,
                  wall_clock_limit_s=120)
    assert out2["actor_errors"] == [] and out2["loop_errors"] == []

    d3 = ApexDriver(cfg_off, device="cpu")
    try:
        assert d3._grad_steps_total == out2["grad_steps"]
        assert d3._replay_filled > 0
    finally:
        d3.server.stop()


def test_driver_without_checkpoint_dir_has_no_manager():
    cfg = get_config("cartpole_smoke").replace(
        actors=ActorConfig(num_actors=1),
        inference=InferenceConfig(max_batch=8, deadline_ms=1.0))
    d = ApexDriver(cfg, device="cpu")
    try:
        assert d.ckpt is None
    finally:
        d.server.stop()


_R2D2_SETS = [
    "env.id=CartPolePO", "env.kind=cartpole_po", "network.lstm_size=16",
    "network.torso_dense=32", "network.compute_dtype=float32",
    "replay.capacity=256", "replay.seq_length=8", "replay.seq_overlap=4",
    "replay.burn_in=2", "replay.min_fill=8", "replay.storage=flat",
    "learner.batch_size=8", "parallel.dp=1", "parallel.tp=1",
    "actors.num_actors=1", "eval_every_steps=0", "eval_episodes=0",
    "checkpoint_every=5"]
_DPG_SETS = [
    "env.id=pendulum", "network.dpg_hidden=(32,32)",
    "replay.capacity=512", "replay.min_fill=64", "learner.batch_size=16",
    "actors.num_actors=1", "eval_every_steps=0", "eval_episodes=0",
    "checkpoint_every=5"]


@pytest.mark.parametrize("config,sets", [("r2d2", _R2D2_SETS),
                                         ("apex_dpg", _DPG_SETS)],
                         ids=["r2d2", "dpg"])
def test_sequence_and_dpg_states_resume_bitwise(tmp_path, config, sets):
    """The SequenceLearner's and the DPGLearner's (two Adams, Polyak
    targets) train states round-trip through a checkpoint bitwise, and
    the resumed driver trains on."""
    cfg = apply_overrides(get_config(config), sets).replace(
        checkpoint_dir=str(tmp_path / "ck"))
    d1 = ApexDriver(cfg, device="cpu")
    out1 = d1.run(total_env_frames=600, max_grad_steps=10,
                  wall_clock_limit_s=120)
    assert out1["loop_errors"] == [] and out1["grad_steps"] >= 10
    final = checkpoint_tree(d1.state)
    d2 = ApexDriver(cfg, device="cpu")
    assert d2._grad_steps_total == out1["grad_steps"]
    _assert_trees_equal(checkpoint_tree(d2.state), final)
    out2 = d2.run(total_env_frames=600,
                  max_grad_steps=out1["grad_steps"] + 5,
                  wall_clock_limit_s=120)
    assert out2["loop_errors"] == []
    assert out2["grad_steps"] >= out1["grad_steps"] + 5
