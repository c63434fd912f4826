"""The port's driver with the tiered cold replay on (replay.cold_tier_*),
hand stepped on the CPU: the one-card cold-tier tests of the original's
tests/test_ingest.py. With the tier on and the ring full, every ship is
an eviction swap; the closure evicted == cold_stored + cold_dropped
(transitions, door outcomes) holds through fills, swaps and recalls,
recalls ride the same staging accounting as fresh ingest, and the hot
ring stays exactly full. The disk rung captures the RAM door's losers
and promotes them back on the idle tick. Then the port's own invariant:
after every swap the replay's host cursor (pos, size) equals its device
mirrors, and the directed write moved both as the original's cursor
math says. The dp=2 forms are in tests/test_torch_driver_dist.py."""

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch import configs as tcfgs
from ape_x_dqn_tpu_torch.replay.packing import ring_write_size
from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver


def _ring_cfg(**replay_kw):
    kw = dict(kind="prioritized", capacity=128, min_fill=32,
              storage="frame_ring", seg_transitions=8, segs_per_add=2,
              cold_tier_capacity=1024)
    kw.update(replay_kw)
    return tcfgs.RunConfig(
        name="catch",
        env=tcfgs.EnvConfig(id="catch", kind="synthetic_atari",
                            frame_skip=4, max_noop_start=4),
        network=tcfgs.NetworkConfig(kind="nature_cnn", dueling=True,
                                    cnn_channels=(8, 16, 16),
                                    torso_dense=32,
                                    compute_dtype="float32"),
        replay=tcfgs.ReplayConfig(**kw),
        learner=tcfgs.LearnerConfig(batch_size=32, n_step=3,
                                    target_sync_every=100,
                                    publish_every=20),
        actors=tcfgs.ActorConfig(num_actors=1, base_eps=0.5,
                                 ingest_batch=8),
        inference=tcfgs.InferenceConfig(max_batch=4, deadline_ms=0.5),
        eval_every_steps=0, eval_episodes=0)


def _synth_batch(driver, n, seed=0):
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
    return batch


@pytest.fixture
def make():
    made = []

    def build(cfg):
        d = ApexDriver(cfg, device="cpu")
        made.append(d)
        return d

    yield build
    for d in made:
        d.server.stop()
        if d._disk is not None:
            d._disk.close()


def _fill_ring(d, seed0=0):
    block = d.dp * d._stage_chunk
    for i in range(d.capacity // d._unit_items // block):
        d._ingest_one(_synth_batch(d, block, seed=seed0 + i), block)
    d._stager.drain()
    assert d._replay_filled == d.capacity
    return block


def test_cold_tier_eviction_closure(make):
    d = make(_ring_cfg())
    assert d._cold is not None
    block = _fill_ring(d)
    assert d._cold_evicted == 0  # filling evicts nothing
    for i in range(4):
        d._ingest_one(_synth_batch(d, block, seed=50 + i), block)
    d._stager.drain()
    assert d._cold_evicted > 0
    assert d._cold_evicted == d._cold_stored + d._cold_dropped
    assert d._cold.transitions <= d.cfg.replay.cold_tier_capacity
    # evictions swap slots 1:1: the hot ring stays exactly full
    assert d._replay_filled == d.capacity
    assert d.state.replay.size == d.capacity


def test_cold_tier_recall_rides_staging_accounting(make):
    d = make(_ring_cfg())
    block = _fill_ring(d)
    for i in range(4):
        d._ingest_one(_synth_batch(d, block, seed=80 + i), block)
    d._stager.drain()
    assert len(d._cold) > 0
    before = (d._cold_evicted, d._cold_stored + d._cold_dropped)
    assert before[0] == before[1]
    d._cold_refill_tick()   # the ingest loop's idle hook
    d._stager.drain()
    assert d._cold_recalled > 0
    # a recalled block restages through the eviction swap (the ring is
    # still full), so the closure holds through the churn
    assert d._cold_evicted == d._cold_stored + d._cold_dropped
    assert d._cold_evicted > before[0]
    assert d._replay_filled == d.capacity


def test_cold_off_never_routes_to_eviction_ship(make):
    """Default path untouched: with the tier off, a full ring keeps
    shipping through the plain add (blind FIFO)."""
    d = make(_ring_cfg(cold_tier_capacity=0))
    assert d._cold is None

    def boom(views, g):  # pragma: no cover - the assertion is the point
        raise AssertionError("cold ship path used with the tier off")

    d._ship_staged_cold = boom
    block = _fill_ring(d)
    for i in range(2):
        d._ingest_one(_synth_batch(d, block, seed=50 + i), block)
    d._stager.drain()
    assert d._replay_filled == d.capacity
    d._cold_refill_tick()  # no cold store: a no-op, not an error


def test_cold_tier_rejects_legacy_staging():
    with pytest.raises(ValueError, match="ingest_zero_copy"):
        ApexDriver(_ring_cfg(ingest_zero_copy=False), device="cpu")


def test_host_and_device_cursors_agree_after_every_swap(make):
    """Each swap moves the host cursor (pos, size) and the device
    mirrors (pos_dev, size_dev) alike: pos to the segment after the
    evicted region, size by ring_write_size (full stays full); the
    evicted region is the one evict_plan picked on the tree before the
    swap."""
    d = make(_ring_cfg())
    block = _fill_ring(d)
    st = d.state.replay
    assert (st.pos, st.size) == (int(st.pos_dev), int(st.size_dev))
    seen = []
    orig = d.learner.add_at_landed

    def add_at_landed(state, inputs, start, start_host):
        plan = int(d.replay.evict_plan(state.replay, d._stage_chunk))
        size0 = state.replay.size
        out = orig(state, inputs, start, start_host)
        r = state.replay
        seen.append((plan, int(start_host), r.pos, r.size,
                     int(r.pos_dev), int(r.size_dev), size0))
        return out

    d.learner.add_at_landed = add_at_landed
    for i in range(5):
        d._ingest_one(_synth_batch(d, block, seed=200 + i), block)
        d._stager.drain()
    assert len(seen) >= 5
    S, B, g = d.replay.S, d.replay.B, d._stage_chunk
    for plan, start, pos, size, pos_dev, size_dev, size0 in seen:
        assert start == plan
        assert (pos, size) == (pos_dev, size_dev)
        assert pos == (start + g) % S
        assert size == ring_write_size(size0, start * B, g * B, S * B)
        assert size == d.capacity


def _disk_cfg(tmp_path, **replay_kw):
    kw = dict(cold_tier_capacity=32,  # ~3 eviction blocks of live
              # transitions: later puts displace or drop, so they spill
              cold_tier_disk_capacity=1 << 16,
              cold_tier_disk_dir=str(tmp_path / "spill"))
    kw.update(replay_kw)
    return _ring_cfg(**kw)


def test_cold_disk_captures_door_losers(make, tmp_path):
    d = make(_disk_cfg(tmp_path))
    assert d._disk is not None
    block = _fill_ring(d)
    for i in range(8):
        d._ingest_one(_synth_batch(d, block, seed=90 + i), block)
    d._stager.drain()
    d._disk.drain(timeout=10.0)
    s = d._disk.stats()
    assert d._cold.spilled > 0
    assert s["spilled"] == d._cold.spilled  # the queue never refused
    assert s["transitions"] > 0 and s["io_errors"] == 0
    # the eviction closure is untouched by spill traffic
    assert d._cold_evicted == d._cold_stored + d._cold_dropped
    assert d._cold.transitions <= d.cfg.replay.cold_tier_capacity


def test_cold_disk_refill_tick_promotes(make, tmp_path):
    d = make(_disk_cfg(tmp_path))
    block = _fill_ring(d)
    for i in range(8):
        d._ingest_one(_synth_batch(d, block, seed=110 + i), block)
    d._stager.drain()
    d._disk.drain(timeout=10.0)
    assert d._disk.stats()["segments"] > 0
    # the idle tick recalls RAM segments first (making door room), then
    # promotes the heaviest disk segment back through put_segment
    d._cold_refill_tick()
    d._stager.drain()
    assert d._disk.stats()["promoted"] >= 1
    assert d._cold_evicted == d._cold_stored + d._cold_dropped


def test_cold_disk_stats_reach_run_report_shape(make, tmp_path):
    """The summary's disk block mirrors DiskStore.stats(): the keys the
    bench and obs read."""
    d = make(_disk_cfg(tmp_path))
    s = d._cold_summary()["disk"]
    assert set(s) >= {"segments", "transitions", "bytes", "files",
                      "spilled", "promoted", "dropped", "queue_full",
                      "io_errors", "corrupt_segments", "compactions"}
    assert set(d._cold_summary()) >= {
        "evicted", "stored", "dropped", "recalled", "displaced_segments",
        "segments", "transitions", "bytes", "compression_ratio",
        "swap_graph_replays"}


def test_flat_cold_tier_swaps_through_the_driver(make):
    """The flat prioritized layout: the same swap and closure, with the
    packed pixel leaves read back through the packer."""
    cfg = _ring_cfg(storage="flat", capacity=256, min_fill=32,
                    cold_tier_capacity=512)
    d = make(cfg)
    assert not d._frame_mode and d._cold is not None
    block = _fill_ring(d)
    for i in range(3):
        d._ingest_one(_synth_batch(d, block, seed=300 + i), block)
    d._stager.drain()
    assert d._cold_evicted > 0
    assert d._cold_evicted == d._cold_stored + d._cold_dropped
    st = d.state.replay
    assert (st.pos, st.size) == (int(st.pos_dev), int(st.size_dev))
    assert st.size == d.capacity


def test_cold_tier_refuses_families_without_a_sum_tree():
    cfg = _ring_cfg(kind="uniform", storage="flat", capacity=256)
    with pytest.raises(NotImplementedError, match="cold tier"):
        ApexDriver(cfg, device="cpu")
