"""The port's driver with the dp-sharded learner and the legacy staging
path, hand stepped on the CPU: the dp=2 and legacy forms of the
original's tests/test_ingest.py, on a mesh of the CPU repeated.

- per-shard drop closure under the [dp, chunk] round-robin split, in
  the three denominations (flat units, frame-ring live transitions,
  r2d2 sequences x seq_length), on both staging paths;
- the tail-drop accounting, on both staging paths as the original
  parametrizes it;
- the same recorded wire stream through both staging paths lands the
  same replay-bound blocks, with the same drops;
- the cold tier at dp=2: the door closure per shard, through recalls
  and the disk rung; the cold tier refuses legacy staging;
- against the JAX driver: one synthetic stream through a dp=2 JAX
  driver and the port's lands bitwise the same shards (storage,
  cursors) and leaf priorities within 1e-6;
- the mesh on the driver: r2d2 and the frame ring through run() on a
  dp=2 x tp=1 mesh to a clean end with replay_shards in lockstep, and
  the CLI's default device list (no card here) failing with the
  original's mesh error.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu import configs as jcfgs
from ape_x_dqn_tpu.runtime.driver import ApexDriver as JaxDriver
from ape_x_dqn_tpu_torch import configs as tcfgs
from ape_x_dqn_tpu_torch.comm.socket_transport import (WireBatch,
                                                       decode_batch,
                                                       encode_batch)
from ape_x_dqn_tpu_torch.runtime import train
from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver


def _flat_cfg(pkg=tcfgs, **replay_kw):
    return pkg.get_config("cartpole_smoke").replace(
        replay=pkg.ReplayConfig(kind="prioritized", capacity=2048,
                                min_fill=64, **replay_kw),
        learner=pkg.LearnerConfig(batch_size=32, n_step=3,
                                  target_sync_every=100, publish_every=20),
        actors=pkg.ActorConfig(num_actors=1, base_eps=0.5, ingest_batch=16),
        inference=pkg.InferenceConfig(max_batch=4, deadline_ms=0.5),
        eval_every_steps=0, eval_episodes=0)


def _ring_cfg(pkg=tcfgs, **replay_kw):
    kw = dict(kind="prioritized", capacity=4096, min_fill=128,
              storage="frame_ring", seg_transitions=8, segs_per_add=2)
    kw.update(replay_kw)
    return pkg.RunConfig(
        name="catch",
        env=pkg.EnvConfig(id="catch", kind="synthetic_atari", frame_skip=4,
                          max_noop_start=4),
        network=pkg.NetworkConfig(kind="nature_cnn", dueling=True,
                                  cnn_channels=(8, 16, 16), torso_dense=32,
                                  compute_dtype="float32"),
        replay=pkg.ReplayConfig(**kw),
        learner=pkg.LearnerConfig(batch_size=32, n_step=3,
                                  target_sync_every=100, publish_every=20),
        actors=pkg.ActorConfig(num_actors=1, base_eps=0.5, ingest_batch=8),
        inference=pkg.InferenceConfig(max_batch=4, deadline_ms=0.5),
        eval_every_steps=0, eval_episodes=0)


def _r2d2_cfg(pkg=tcfgs, **replay_kw):
    return pkg.get_config("r2d2").replace(
        env=pkg.EnvConfig(id="CartPolePO", kind="cartpole_po"),
        network=pkg.NetworkConfig(kind="lstm_q", lstm_size=32,
                                  torso_dense=64, dueling=True,
                                  compute_dtype="float32"),
        replay=pkg.ReplayConfig(kind="sequence", capacity=512, seq_length=16,
                                seq_overlap=8, burn_in=4, min_fill=32,
                                priority_eta=0.9, **replay_kw),
        learner=pkg.LearnerConfig(batch_size=16, n_step=3, value_rescale=True,
                                  target_sync_every=100, lr=1e-3,
                                  publish_every=25, train_chunk=4),
        actors=pkg.ActorConfig(num_actors=1, base_eps=0.4, ingest_batch=64),
        inference=pkg.InferenceConfig(max_batch=8, deadline_ms=1.0),
        parallel=pkg.ParallelConfig(dp=1, tp=1),
        eval_every_steps=0, eval_episodes=0)


def _dp2(cfg, pkg=tcfgs):
    return cfg.replace(parallel=pkg.ParallelConfig(dp=2, tp=1))


def _cold_ring_cfg(**replay_kw):
    kw = dict(capacity=128, min_fill=32, cold_tier_capacity=1024)
    kw.update(replay_kw)
    return _ring_cfg(**kw)


def _synth_batch(driver, n, seed=0, frames=None):
    rng = np.random.default_rng(seed)
    batch = {}
    for k, s in driver._item_spec.items():
        dtype = torch.zeros(0, dtype=s.dtype).numpy().dtype
        shape = (n,) + tuple(s.shape)
        if np.issubdtype(dtype, np.integer):
            batch[k] = rng.integers(0, 3, size=shape).astype(dtype)
        else:
            batch[k] = (rng.random(shape) * 4).astype(dtype)
    ptail = (driver.cfg.replay.seg_transitions,) if driver._frame_mode \
        else ()
    batch["priorities"] = rng.random((n,) + ptail).astype(np.float32)
    if frames is not None:
        batch["frames"] = frames
    return batch


@pytest.fixture
def make():
    made = []

    def build(cfg, cls=ApexDriver, **kw):
        if cls is ApexDriver:
            kw.setdefault("device", "cpu")
            dp, tp = cfg.parallel.dp, cfg.parallel.tp
            if dp * tp > 1:
                kw.setdefault("mesh_devices", ["cpu"] * (dp * tp))
        d = cls(cfg, **kw)
        made.append(d)
        return d

    yield build
    for d in made:
        d.server.stop()
        if getattr(d, "_disk", None) is not None:
            d._disk.close()


# -- tail-drop accounting, legacy and zero-copy ---------------------------


@pytest.mark.parametrize("zero_copy", [False, True])
def test_flat_tail_drop_accounting(make, zero_copy):
    d = make(_flat_cfg(ingest_zero_copy=zero_copy))
    assert (d._stager is not None) == zero_copy
    block = d.dp * d._stage_chunk
    tail = 3
    d._ingest_one(_synth_batch(d, block + tail), block + tail)
    d._flush_stage(force=True)
    assert d._stage_dropped == tail
    assert d._frames_total == block
    assert d._replay_filled == block * d._unit_items
    assert d.state.replay.size == block


@pytest.mark.parametrize("zero_copy", [False, True])
def test_frame_ring_tail_drop_accounting(make, zero_copy):
    d = make(_ring_cfg(ingest_zero_copy=zero_copy))
    block = d.dp * d._stage_chunk
    batch = _synth_batch(d, block + 1, frames=37)
    batch["next_off"][block:] = 0
    batch["next_off"][block:, :5] = 2  # 5 live transitions in the tail
    d._ingest_one(batch, block + 1)
    d._flush_stage(force=True)
    assert d._stage_dropped == 5
    assert d._frames_total == 37
    assert d._replay_filled == block * d._unit_items


@pytest.mark.parametrize("zero_copy", [False, True])
def test_r2d2_tail_drop_accounting(make, zero_copy):
    d = make(_r2d2_cfg(ingest_zero_copy=zero_copy))
    block = d.dp * d._stage_chunk
    tail = 2
    d._ingest_one(_synth_batch(d, block + tail, frames=29), block + tail)
    d._flush_stage(force=True)
    assert d._stage_dropped == tail * d.cfg.replay.seq_length
    assert d._frames_total == 29
    assert d._replay_filled == block * d._unit_items


# -- per-shard drop closure at dp=2 ----------------------------------------


@pytest.mark.parametrize("zero_copy", [False, True])
def test_flat_per_shard_drop_closure_dp2(make, zero_copy):
    d = make(_dp2(_flat_cfg(ingest_zero_copy=zero_copy)))
    assert d.is_dist and d.dp == 2
    chunk = d._stage_chunk
    block = d.dp * chunk
    tail = chunk + 2  # all of shard 0's share + 2 units of shard 1's
    assert block > tail
    d._ingest_one(_synth_batch(d, block + tail), block + tail)
    d._flush_stage(force=True)
    assert d._stage_dropped == tail
    assert d._stage_dropped_per_shard.tolist() == [chunk, 2]
    assert int(d._stage_dropped_per_shard.sum()) == d._stage_dropped
    assert d._frames_total == block
    # the block landed chunk units per shard, in lockstep
    assert d.state.replay.size.tolist() == [chunk, chunk]


@pytest.mark.parametrize("zero_copy", [False, True])
def test_frame_ring_per_shard_drop_closure_dp2(make, zero_copy):
    d = make(_dp2(_ring_cfg(ingest_zero_copy=zero_copy)))
    assert d.is_dist and d._frame_mode
    chunk = d._stage_chunk
    block = d.dp * chunk
    tail = chunk + 1
    assert block > tail
    batch = _synth_batch(d, block + tail, frames=11)
    batch["next_off"][block:] = 0
    for j in range(tail):
        batch["next_off"][block + j, :j + 1] = 2   # j+1 live transitions
    d._ingest_one(batch, block + tail)
    d._flush_stage(force=True)
    assert d._stage_dropped == sum(j + 1 for j in range(tail))
    assert d._stage_dropped_per_shard.tolist() == [
        sum(j + 1 for j in range(chunk)), chunk + 1]
    assert int(d._stage_dropped_per_shard.sum()) == d._stage_dropped
    assert d._frames_total == 11


@pytest.mark.parametrize("zero_copy", [False, True])
def test_r2d2_per_shard_drop_closure_dp2(make, zero_copy):
    d = make(_dp2(_r2d2_cfg(ingest_zero_copy=zero_copy)))
    assert d.is_dist and d.family == "r2d2"
    chunk = d._stage_chunk
    block = d.dp * chunk
    tail = chunk + 1
    d._ingest_one(_synth_batch(d, block + tail, frames=29), block + tail)
    d._flush_stage(force=True)
    seq = d.cfg.replay.seq_length
    assert d._stage_dropped == tail * seq
    assert d._stage_dropped_per_shard.tolist() == [chunk * seq, seq]
    assert int(d._stage_dropped_per_shard.sum()) == d._stage_dropped
    assert d._frames_total == 29


# -- the two staging paths on one recorded stream ---------------------------


def _record_stream(make, cfg, payloads, sizes):
    """The recorded wire payloads through one driver with the device
    add stubbed to capture the host blocks: -> (rows per key, dropped,
    frames)."""
    d = make(cfg)
    recorded = []
    if d._stager is not None:
        def ship(views, g):
            recorded.append({k: v.numpy().copy() for k, v in views.items()})
            return []
        d._stager._ship = ship
    else:
        def add_block(take, count):
            recorded.append({k: np.array(v) for k, v in take.items()})
        d._add_block = add_block
    for n, payload in zip(sizes, payloads):
        batch = WireBatch(payload) if d._stager is not None \
            else decode_batch(payload)
        d._ingest_one(batch, n)
    d._flush_stage(force=True)
    keys = d._item_keys + ("priorities",)
    rows = {k: np.concatenate([r[k] for r in recorded]) for k in keys}
    return rows, d._stage_dropped, d._frames_total


@pytest.mark.parametrize("cfg_fn", [_flat_cfg, _ring_cfg, _r2d2_cfg],
                         ids=["flat", "frame_ring", "r2d2"])
def test_ingest_parity_zero_copy_vs_legacy(make, cfg_fn):
    """The same recorded wire stream (ragged batch sizes, crossing the
    staging boundaries mid-batch) lands bitwise the same replay-bound
    blocks through both staging paths, with the same drops."""
    probe = make(cfg_fn())
    sizes = [3, 7, 1, 6, 5, 2]
    if probe._frame_mode:
        sizes = [2, 1, 3, 1, 2, 2]
    payloads = [encode_batch(_synth_batch(probe, n, seed=i, frames=n * 4))
                for i, n in enumerate(sizes)]
    got = _record_stream(make, cfg_fn(ingest_zero_copy=True), payloads,
                         sizes)
    want = _record_stream(make, cfg_fn(ingest_zero_copy=False), payloads,
                          sizes)
    assert got[1:] == want[1:]
    for k, v in want[0].items():
        assert got[0][k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[0][k], v, err_msg=k)


# -- the cold tier at dp=2 -------------------------------------------------


def _fill_ring(d, seed0=0):
    block = d.dp * d._stage_chunk
    for i in range(d.capacity // d._unit_items // block):
        d._ingest_one(_synth_batch(d, block, seed=seed0 + i), block)
    d._stager.drain()
    assert d._replay_filled == d.capacity
    return block


def _closure_per_shard(d):
    np.testing.assert_array_equal(
        d._cold_evicted_per_shard,
        d._cold_stored_per_shard + d._cold_dropped_per_shard)
    assert int(d._cold_evicted_per_shard.sum()) == d._cold_evicted
    assert int(d._cold_stored_per_shard.sum()) == d._cold_stored
    assert int(d._cold_dropped_per_shard.sum()) == d._cold_dropped
    assert d._cold_evicted == d._cold_stored + d._cold_dropped


def test_cold_tier_dp2_per_shard_closure(make):
    d = make(_dp2(_cold_ring_cfg()))
    assert d.is_dist and d.dp == 2 and d._cold is not None
    block = _fill_ring(d)
    for i in range(4):
        d._ingest_one(_synth_batch(d, block, seed=60 + i), block)
    d._stager.drain()
    assert d._cold_evicted > 0
    assert d._cold_evicted_per_shard.shape == (2,)
    assert (d._cold_evicted_per_shard > 0).all()
    _closure_per_shard(d)
    assert d._replay_filled == d.capacity
    # the shards stay full through the swaps; host and device cursors
    # of every shard agree
    rs = d.state.replay
    assert (rs.size == d.capacity // d.dp).all()
    assert rs.size_dev.tolist() == rs.size.tolist()
    assert rs.pos_dev.tolist() == rs.pos.tolist()


def test_cold_tier_dp2_recall_keeps_per_shard_closure(make):
    d = make(_dp2(_cold_ring_cfg()))
    block = _fill_ring(d)
    for i in range(4):
        d._ingest_one(_synth_batch(d, block, seed=70 + i), block)
    d._stager.drain()
    assert len(d._cold) > 0
    d._cold_refill_tick()
    d._stager.drain()
    assert d._cold_recalled > 0
    _closure_per_shard(d)


def test_cold_disk_dp2_per_shard_closure(make, tmp_path):
    d = make(_dp2(_cold_ring_cfg(
        cold_tier_capacity=32, cold_tier_disk_capacity=1 << 16,
        cold_tier_disk_dir=str(tmp_path / "spill"))))
    assert d.is_dist and d._disk is not None
    block = _fill_ring(d)
    for i in range(6):
        d._ingest_one(_synth_batch(d, block, seed=130 + i), block)
    d._stager.drain()
    d._disk.drain(timeout=10.0)
    assert d._cold.spilled > 0
    _closure_per_shard(d)


def test_cold_tier_rejects_legacy_staging(make):
    with pytest.raises(ValueError, match="ingest_zero_copy"):
        make(_cold_ring_cfg(ingest_zero_copy=False))


# -- against the JAX driver at dp=2 -----------------------------------------


@pytest.mark.parametrize("zero_copy", [False, True])
def test_dp2_ingest_matches_the_jax_driver(make, zero_copy):
    """One synthetic frame-ring stream through a dp=2 JAX driver and the
    port's: the same shards, bit for bit, the same per-shard cursors,
    leaf priorities within 1e-6."""
    jd = make(_dp2(_ring_cfg(jcfgs, ingest_zero_copy=zero_copy), jcfgs),
              cls=JaxDriver)
    td = make(_dp2(_ring_cfg(ingest_zero_copy=zero_copy)))
    if jd._stager is not None:
        # the reference ships a snapshot (the CPU backend aliases
        # numpy rows; tests/test_torch_driver.py)
        jship = jd._stager._ship
        jd._stager._ship = lambda views, g: jship(
            {k: np.array(v, copy=True) for k, v in views.items()}, g)
    for i, n in enumerate([5, 3, 9, 2, 7, 4]):
        batch = _synth_batch(td, n, seed=200 + i, frames=n * 8)
        jd._ingest_one(dict(batch), n)
        td._ingest_one(dict(batch), n)
    jd._flush_stage(force=True)
    td._flush_stage(force=True)
    assert td._stage_dropped_per_shard.tolist() == \
        jd._stage_dropped_per_shard.tolist()
    jr, tr = jd.state.replay, td.state.replay
    assert tr.pos.tolist() == np.asarray(jr.pos).tolist()
    assert tr.size.tolist() == np.asarray(jr.size).tolist()
    assert int(tr.size.sum()) > 0
    for key, v in tr.storage.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jr.storage[key]),
                                      err_msg=key)
    np.testing.assert_allclose(tr.tree.numpy(), np.asarray(jr.tree),
                               rtol=1e-6, atol=1e-6)


# -- the mesh through run() and the CLI -------------------------------------


@pytest.mark.parametrize("cfg_fn", [_ring_cfg, _r2d2_cfg],
                         ids=["frame_ring", "r2d2"])
def test_dist_driver_runs_to_a_clean_end(make, cfg_fn):
    cfg = _dp2(cfg_fn())
    cfg = cfg.replace(learner=dataclasses.replace(
        cfg.learner, steps_per_frame_cap=None))
    d = make(cfg)
    out = d.run(total_env_frames=3000, max_grad_steps=24,
                wall_clock_limit_s=60)
    assert not out["actor_errors"] and not out["loop_errors"], out
    assert out["grad_steps"] > 0
    shards = out["replay_shards"]
    assert len(shards["sizes"]) == 2
    assert shards["fill_min"] == shards["fill_max"] > 0
    assert d.state.replay.pos.tolist() == d.state.replay.pos_dev.tolist()


def test_cli_r2d2_without_overrides_fails_with_the_mesh_error():
    """The preset's dp=4 x tp=2 mesh over the default device list (the
    visible cards; none here): the original's assertion, before any
    allocation."""
    if torch.cuda.device_count() >= 8:
        pytest.skip("eight cards are visible")
    with pytest.raises(AssertionError, match=r"dp\(4\) \* tp\(2\) > "
                                             r"device count"):
        train.main(["--config", "r2d2", "--device", "cpu",
                    "--total-env-frames", "10"])


def test_dist_refuses_dpg(make):
    cfg = tcfgs.get_config("apex_dpg")
    cfg = cfg.replace(env=dataclasses.replace(cfg.env, id="pendulum"),
                      parallel=tcfgs.ParallelConfig(dp=2, tp=1))
    with pytest.raises(NotImplementedError, match="DPG nets are small"):
        make(cfg)


def test_dist_checkpoint_restores_the_shards_in_place(make, tmp_path):
    """A dp=2 driver saves its state with the replay (per-shard cursors
    as lists); a new driver over the same directory restores every
    shard IN PLACE (the tensors its graphs would hold keep their
    addresses), host and device cursors alike."""
    cfg = _dp2(_ring_cfg()).replace(checkpoint_dir=str(tmp_path / "ck"),
                                    checkpoint_replay=True)
    d = make(cfg)
    block = d.dp * d._stage_chunk
    for i in range(3):
        d._ingest_one(_synth_batch(d, block, seed=300 + i), block)
    d._stager.drain()
    d.state, _ = d.learner.train_step(d.state)
    d._grad_steps_total = d.state.step
    d._save_checkpoint(wait=True)
    rs = d.state.replay
    ptrs = {}
    restore = ApexDriver._maybe_restore

    def addresses_then_restore(self):
        r = self.state.replay
        ptrs.update({k: v.data_ptr() for k, v in r.storage.items()},
                    tree=r.tree.data_ptr())
        restore(self)

    ApexDriver._maybe_restore = addresses_then_restore
    try:
        e = make(cfg)
    finally:
        ApexDriver._maybe_restore = restore
    es = e.state.replay
    tree_ptr = ptrs.pop("tree")
    assert e.state.step == 1 and e._replay_filled == int(rs.size.sum())
    assert es.pos.tolist() == rs.pos.tolist() == es.pos_dev.tolist()
    assert es.size.tolist() == rs.size.tolist() == es.size_dev.tolist()
    for k, v in rs.storage.items():
        assert torch.equal(es.storage[k], v), k
        assert es.storage[k].data_ptr() == ptrs[k]
    assert torch.equal(es.tree, rs.tree) and es.tree.data_ptr() == tree_ptr
    for a, b in zip(e.state.net.parameters(), d.state.net.parameters()):
        assert torch.equal(a, b)
