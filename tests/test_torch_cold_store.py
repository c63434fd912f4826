"""The port's tiered cold replay (replay/cold_store.py, the cold codec of
replay/packing.py and the replay layers' evict_plan / read_region /
add_at) against the original's tests/test_cold_store.py, on the CPU:

- the bitwise round trip, on both storage layouts: a region evicted
  through evict_plan -> read_region -> cold_pack -> ColdStore -> recall
  -> restage -> add lands items bit-identical to the never-evicted
  originals (priorities through the alpha inversion, to 1e-5);
- the lowest-mass eviction and the cold-off FIFO add;
- ColdStore's door (displacement, drops, the never-inflate floor, the
  disk-spill hook) and the ReplayConfig validation;
- against the JAX package: evict_plan on the same leaves for both
  layouts (exact where the minimum window is unique by a clear margin;
  the port's window carries the minimum mass to 1e-5 relative on a
  2^16-leaf random tree, where float32 cumsums may order near-ties
  differently), and cold_pack's payload bytes equal to the JAX
  cold_pack's for the same region.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.replay.frame_ring import FrameRingReplay as JaxRing
from ape_x_dqn_tpu.replay.packing import cold_pack as jax_cold_pack
from ape_x_dqn_tpu.replay.packing import cold_plan as jax_cold_plan
from ape_x_dqn_tpu.replay.prioritized import PrioritizedReplay as JaxFlat
from ape_x_dqn_tpu.runtime.learner import (
    transition_item_spec as jax_transition_item_spec)
from ape_x_dqn_tpu_torch.configs import ReplayConfig
from ape_x_dqn_tpu_torch.replay import cold_store as cold_store_mod
from ape_x_dqn_tpu_torch.replay.cold_store import (ColdSegment, ColdStore,
                                                   codec_status)
from ape_x_dqn_tpu_torch.replay.frame_ring import (FrameRingReplay,
                                                   frame_segment_spec)
from ape_x_dqn_tpu_torch.replay.packing import ItemSpec, cold_pack, cold_plan
from ape_x_dqn_tpu_torch.replay.prioritized import PrioritizedReplay
from ape_x_dqn_tpu_torch.runtime.learner import transition_item_spec

OBS_SHAPE = (84, 84, 4)


def _ring():
    # capacity 64 transitions, B=8 -> 8 segments
    return FrameRingReplay(64, seg_transitions=8, n_step=3,
                           obs_shape=OBS_SHAPE, device="cpu")


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _seg_batch(r, g, rng, compressible=True):
    """g staging segments; compressible frames exercise the delta path
    (consecutive frames differ in a few pixels, like real Atari)."""
    if compressible:
        base = rng.integers(0, 255, (84, 84)).astype(np.uint8)
        frames = np.broadcast_to(base, (g, r.F, 84, 84)).copy()
        frames[:, :, ::7, ::11] = rng.integers(
            0, 255, frames[:, :, ::7, ::11].shape)
    else:
        frames = rng.integers(0, 255, (g, r.F, 84, 84)).astype(np.uint8)
    return {
        "seg_frames": frames.astype(np.uint8),
        "action": rng.integers(0, 18, (g, r.B)).astype(np.int32),
        "reward": rng.standard_normal((g, r.B)).astype(np.float32),
        "discount": np.full((g, r.B), 0.99, np.float32),
        "next_off": rng.integers(1, 4, (g, r.B)).astype(np.int32),
    }


def _flat_batch(n, rng):
    return {
        "obs": rng.integers(0, 255, (n, *OBS_SHAPE)).astype(np.uint8),
        "action": rng.integers(0, 18, (n,)).astype(np.int32),
        "reward": rng.standard_normal((n,)).astype(np.float32),
        "next_obs": rng.integers(0, 255, (n, *OBS_SHAPE)).astype(np.uint8),
        "discount": np.full((n,), 0.99, np.float32),
    }


def _np(tree):
    return {k: v.numpy() for k, v in tree.items()}


def _gather_all(r, state, idx):
    return _np(r._gather(state, torch.as_tensor(idx)))


def _flat_replay(capacity=16):
    return PrioritizedReplay(capacity, device="cpu",
                             item_spec=transition_item_spec(OBS_SHAPE,
                                                            np.uint8))


# -- bitwise round-trip parity --------------------------------------------


def test_frame_ring_cold_round_trip_bitwise():
    """Evict the lowest-mass segments through the full cold cycle and
    restage them into a SECOND ring: every reconstructed transition
    (obs/next_obs stacks included) is bit-identical to sampling the
    original ring at the original slots."""
    rng = np.random.default_rng(0)
    r = _ring()
    st = r.init()
    g = 2  # eviction block: 2 segments, like segs_per_add=2 staging
    tds = [0.7, 0.05, 0.9, 0.4]  # the block starting at seg 2 is lightest
    for td in tds:
        r.add(st, _t(_seg_batch(r, g, rng)),
              torch.full((g, r.B), td))
    seg0 = r.evict_plan(st, g)
    assert int(seg0) == 2  # the td=0.05 block (segments 2, 3)
    items, pri = r.read_region(st, seg0, g)
    items, pri = _np(items), pri.numpy()

    cold = ColdStore(frame_segment_spec(r.B, r.n, OBS_SHAPE, np.uint8),
                     capacity_transitions=1024, unit_items=r.B,
                     ptail=(r.B,))
    assert cold.put(items, pri, live=int((pri > 0).sum())) == "stored"
    [back] = cold.recall(1)
    for k in items:
        assert back[k].dtype == items[k].dtype, k
        np.testing.assert_array_equal(back[k], items[k], err_msg=k)
    np.testing.assert_array_equal(back["priorities"], pri)

    td_back = np.maximum(
        np.asarray(back["priorities"]) ** (1.0 / r.alpha) - r.eps, 0.0
    ).astype(np.float32)
    r2 = _ring()
    st2 = r2.add(r2.init(),
                 _t({k: v for k, v in back.items() if k != "priorities"}),
                 torch.from_numpy(td_back))
    idx_orig = int(seg0) * r.B + np.arange(g * r.B)
    got = _gather_all(r2, st2, np.arange(g * r.B))
    want = _gather_all(r, st, idx_orig)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(
        st2.tree[r2.capacity:r2.capacity + g * r.B].numpy(),
        pri.reshape(-1), rtol=1e-5)


def test_flat_cold_round_trip_bitwise():
    """The same on the flat layout: the PixelPacker byte rows decode
    through read_region, survive the cold codec, and restage
    bit-identically."""
    rng = np.random.default_rng(1)
    spec = transition_item_spec(OBS_SHAPE, np.uint8)
    r = _flat_replay()
    st = r.init()
    blocks = [_flat_batch(4, rng) for _ in range(4)]
    for b, td in zip(blocks, [0.6, 0.8, 0.02, 0.5]):  # block 2 lightest
        r.add(st, _t(b), torch.full((4,), td))
    start = r.evict_plan(st, 4)
    assert int(start) == 8
    items, pri = r.read_region(st, start, 4)
    items, pri = _np(items), pri.numpy()
    for k in blocks[2]:  # read_region already round-trips the packer
        np.testing.assert_array_equal(items[k], blocks[2][k], err_msg=k)

    cold = ColdStore(spec, capacity_transitions=64)
    assert cold.put(items, pri, live=4) == "stored"
    [back] = cold.recall(1)
    td_back = np.maximum(
        np.asarray(back["priorities"]) ** (1.0 / r.alpha) - r.eps, 0.0
    ).astype(np.float32)
    r2 = _flat_replay()
    st2 = r2.add(r2.init(),
                 _t({k: v for k, v in back.items() if k != "priorities"}),
                 torch.from_numpy(td_back))
    got, _ = r2.read_region(st2, torch.tensor(0), 4)
    for k in blocks[2]:
        a = got[k].numpy()
        assert a.dtype == blocks[2][k].dtype, k
        np.testing.assert_array_equal(a, blocks[2][k], err_msg=k)


# -- eviction placement and the cold-off FIFO pin -------------------------


def test_evict_plan_picks_lowest_mass_region():
    rng = np.random.default_rng(2)
    r = _ring()
    st = r.init()
    for td in (0.3, 0.6, 0.01, 0.02, 0.9, 0.8, 0.7, 0.5):
        r.add(st, _t(_seg_batch(r, 1, rng)), torch.full((1, r.B), td))
    # the window of 2 contiguous segments with least mass: segments 2+3
    assert int(r.evict_plan(st, 2)) == 2
    fr = _flat_replay()
    fst = fr.init()
    for td in (0.5, 0.01, 0.9, 0.7):
        fr.add(fst, _t(_flat_batch(4, rng)), torch.full((4,), td))
    assert int(fr.evict_plan(fst, 4)) == 4


def test_cold_off_add_stays_fifo():
    """With the tier off nothing consults priority mass: a full ring's
    next default add overwrites the FIFO cursor position even when a
    far lower-mass region exists."""
    rng = np.random.default_rng(3)
    r = _ring()
    st = r.init()
    batches = [_seg_batch(r, 1, rng) for _ in range(8)]
    tds = (0.9, 0.001, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9)  # seg 1 lightest
    for b, td in zip(batches, tds):
        r.add(st, _t(b), torch.full((1, r.B), td))
    assert st.pos == 0 and st.size == r.capacity
    fresh = _seg_batch(r, 1, rng)
    r.add(st, _t(fresh), torch.full((1, r.B), 0.5))
    got0, _ = r.read_region(st, torch.tensor(0), 1)
    got1, _ = r.read_region(st, torch.tensor(1), 1)
    for k in fresh:
        np.testing.assert_array_equal(got0[k].numpy(), fresh[k], err_msg=k)
        np.testing.assert_array_equal(got1[k].numpy(), batches[1][k],
                                      err_msg=k)


# -- the parity cases against the JAX package -------------------------------


def _jax_ring():
    return JaxRing(64, seg_transitions=8, n_step=3, obs_shape=OBS_SHAPE)


@pytest.mark.parametrize("layout", ["frame_ring", "flat"])
def test_evict_plan_matches_the_jax_package(layout):
    """The same adds through both packages: evict_plan agrees for every
    block size on leaves whose minimum window is unique by a clear
    margin, and so do the region's items and stored priorities."""
    rng = np.random.default_rng(12)
    if layout == "frame_ring":
        tr, jr = _ring(), _jax_ring()
        ts, js = tr.init(), jr.init()
        tds = (0.31, 0.62, 0.013, 0.024, 0.93, 0.81, 0.17, 0.55)
        for td in tds:
            b = _seg_batch(tr, 1, rng)
            pri = np.full((1, tr.B), td, np.float32)
            tr.add(ts, _t(b), torch.from_numpy(pri))
            js = jr.add(js, jax.tree.map(jnp.asarray, b), jnp.asarray(pri))
        blocks = (1, 2, 3, 4)
    else:
        spec = jax_transition_item_spec(OBS_SHAPE, np.uint8)
        tr, jr = _flat_replay(), JaxFlat(16, item_spec=spec)
        ts, js = tr.init(), jr.init()
        for td in (0.52, 0.011, 0.93, 0.71):
            b = _flat_batch(4, rng)
            pri = (td * (1 + 0.1 * rng.random(4))).astype(np.float32)
            tr.add(ts, _t(b), torch.from_numpy(pri))
            js = jr.add(js, jax.tree.map(jnp.asarray, b), jnp.asarray(pri))
        blocks = (1, 2, 4, 8)
    for block in blocks:
        t0 = tr.evict_plan(ts, block)
        j0 = jr.evict_plan(js, block)
        assert int(t0) == int(j0), (layout, block)
        titems, tpri = tr.read_region(ts, t0, block)
        jitems, jpri = jr.read_region(js, j0, block)
        np.testing.assert_allclose(tpri.numpy(), np.asarray(jpri),
                                   rtol=1e-6)
        for k, v in jitems.items():
            np.testing.assert_array_equal(titems[k].numpy(), np.asarray(v),
                                          err_msg=f"{layout} {k}")


@pytest.mark.parametrize("layout", ["frame_ring", "flat"])
def test_evict_plan_window_mass_on_a_large_tree(layout):
    """2^16 random leaves (a quarter of them dead, 0): the port's window
    carries the minimum mass (float64 reference) to 1e-5 relative, and
    equals the JAX package's index where the minimum is unique by a
    clear margin (checked here by the float64 reference)."""
    rng = np.random.default_rng(13)
    cap, seg = 1 << 16, 16
    leaves = rng.random(cap).astype(np.float32) ** 2
    leaves[rng.random(cap) < 0.25] = 0.0
    tree = np.zeros(2 * cap, np.float32)
    tree[cap:] = leaves
    if layout == "frame_ring":
        port = FrameRingReplay(cap, seg_transitions=seg, n_step=3,
                               obs_shape=(8, 8, 4), device="cpu")
        ref = JaxRing(cap, seg_transitions=seg, n_step=3,
                      obs_shape=(8, 8, 4))
        mass = leaves.reshape(-1, seg).sum(-1, dtype=np.float64)
    else:
        port = PrioritizedReplay(cap, device="cpu")
        ref = JaxFlat(cap)
        mass = leaves.astype(np.float64)
    st = type("S", (), {"tree": torch.from_numpy(tree)})()
    jst = type("S", (), {"tree": jnp.asarray(tree)})()
    for block in (1, 4, 64):
        win = np.convolve(mass, np.ones(block), "valid")
        got = int(port.evict_plan(st, block))
        best = win.min()
        assert abs(win[got] - best) <= 1e-5 * max(abs(best), 1e-6) + 1e-5, (
            layout, block, win[got], best)
        order = np.sort(win)
        if order.size > 1 and order[1] - order[0] > 1e-3 * max(order[0],
                                                                  1e-3):
            assert got == int(ref.evict_plan(jst, block)), (layout, block)


@pytest.mark.parametrize("layout", ["frame_ring", "flat"])
def test_cold_pack_payload_matches_the_jax_codec(layout):
    """The same region, packed by both packages' cold_pack: the same
    plan and the same payload bytes, so segments (and disk files) cross
    between them."""
    rng = np.random.default_rng(14)
    if layout == "frame_ring":
        r = _ring()
        tspec = frame_segment_spec(r.B, r.n, OBS_SHAPE, np.uint8)
        from ape_x_dqn_tpu.replay.frame_ring import (
            frame_segment_spec as jax_frame_segment_spec)
        jspec = jax_frame_segment_spec(r.B, r.n, OBS_SHAPE, np.uint8)
        items = _seg_batch(r, 2, rng)
        ptail = (r.B,)
        pri = rng.random((2, r.B)).astype(np.float32)
    else:
        tspec = transition_item_spec(OBS_SHAPE, np.uint8)
        jspec = jax_transition_item_spec(OBS_SHAPE, np.uint8)
        items = _flat_batch(4, rng)
        ptail = ()
        pri = rng.random(4).astype(np.float32)
    tplan, jplan = cold_plan(tspec, ptail), jax_cold_plan(jspec, ptail)
    assert tplan == jplan
    region = dict(items, priorities=pri)
    for level in (1, 6):
        tpay, traw = cold_pack(region, tplan, level)
        jpay, jraw = jax_cold_pack(region, jplan, level)
        assert traw == jraw
        assert tpay == jpay, (layout, level)


# -- ColdStore admission policy ---------------------------------------------


def _tiny_store(cap=16, spill=None):
    spec = {"x": ItemSpec((4, 1024), torch.uint8)}
    return ColdStore(spec, capacity_transitions=cap, unit_items=4,
                     ptail=(4,), spill=spill)


def _tiny_seg(rng, mass):
    items = {"x": rng.integers(0, 4, (1, 4, 1024)).astype(np.uint8)}
    pri = np.full((1, 4), mass, np.float32)
    return items, pri


def test_cold_store_mass_ordered_displacement_and_door_drop():
    rng = np.random.default_rng(4)
    cs = _tiny_store(cap=16)  # 4 segments of 4 live transitions
    for mass in (0.4, 0.2, 0.8, 0.6):
        items, pri = _tiny_seg(rng, mass)
        assert cs.put(items, pri, live=4) == "stored"
    assert len(cs) == 4 and cs.transitions == 16
    items, pri = _tiny_seg(rng, 0.1)  # lighter than the lightest stored
    assert cs.put(items, pri, live=4) == "dropped"
    assert cs.dropped == 1 and len(cs) == 4
    items, pri = _tiny_seg(rng, 0.9)  # heavier: displaces mass 0.2
    assert cs.put(items, pri, live=4) == "stored"
    assert cs.displaced == 1 and len(cs) == 4
    [a] = cs.recall(1)  # recall pops the highest mass first
    assert a["priorities"][0, 0] == np.float32(0.9)
    [b] = cs.recall(1)
    assert b["priorities"][0, 0] == np.float32(0.8)
    assert cs.recalled == 2
    items, pri = _tiny_seg(rng, 0.0)  # all-dead: dropped, not stored
    assert cs.put(items, pri, live=0) == "dropped"
    assert cs.stored == 5 and cs.dropped == 2


def test_cold_store_compression_ratio_floor():
    """Incompressible data hits the per-leaf never-inflate guard (raw
    mode): the resident ratio never reads below 1.0."""
    rng = np.random.default_rng(5)
    spec = {"x": ItemSpec((4, 4096), torch.uint8)}
    cs = ColdStore(spec, capacity_transitions=64, unit_items=4,
                   ptail=(4,))
    items = {"x": rng.integers(0, 256, (2, 4, 4096)).astype(np.uint8)}
    pri = np.full((2, 4), 0.5, np.float32)
    assert cs.put(items, pri, live=8) == "stored"
    assert cs.compression_ratio() >= 1.0
    # the payload may exceed raw only by the constant per-leaf framing
    assert cs.bytes_compressed <= cs.bytes_raw + 9 * 2


def test_codec_status_reports_available():
    ok, detail = codec_status()
    assert ok
    assert detail in ("native", "numpy-fallback")


# -- ReplayConfig validation --------------------------------------------------


def test_replay_config_rejects_negative_cold_capacity():
    with pytest.raises(ValueError, match="cold_tier_capacity"):
        ReplayConfig(cold_tier_capacity=-1)


def test_replay_config_guided_error_without_codec(monkeypatch):
    monkeypatch.setattr(cold_store_mod, "codec_status",
                        lambda: (False, "ImportError: no comm.native"))
    with pytest.raises(ValueError, match="numpy fallback"):
        ReplayConfig(cold_tier_capacity=1 << 16)


def test_replay_config_cold_defaults_off():
    cfg = ReplayConfig()
    assert cfg.cold_tier_capacity == 0
    assert dataclasses.replace(cfg).cold_tier_capacity == 0
    # the tier now builds (no refusal at config time)
    assert ReplayConfig(cold_tier_capacity=1 << 16).cold_tier_capacity > 0


# -- the disk-spill hook ------------------------------------------------------


class _FakeSpill:
    """Records offers; configurable accept, so the queue-full refusal
    path is testable without a writeback thread."""

    def __init__(self, accept=True):
        self.offers = []
        self.accept = accept

    def offer(self, seg):
        self.offers.append(seg)
        return self.accept


def _spill_store(cap=16, accept=True):
    spill = _FakeSpill(accept)
    return _tiny_store(cap, spill=spill), spill


def _fill(cs, rng, masses):
    for mass in masses:
        items, pri = _tiny_seg(rng, mass)
        assert cs.put(items, pri, live=4) == "stored"


def test_cold_spill_door_dropped_candidate_is_offered():
    rng = np.random.default_rng(6)
    cs, spill = _spill_store(cap=16)
    _fill(cs, rng, (0.4, 0.5, 0.6, 0.7))
    items, pri = _tiny_seg(rng, 0.1)  # lighter than everything stored
    assert cs.put(items, pri, live=4) == "dropped"
    assert cs.dropped == 1 and cs.spilled == 1
    [seg] = spill.offers
    assert seg.mass_sum == pytest.approx(0.1 * 4)
    assert seg.live == 4 and len(seg.payload) > 0


def test_cold_spill_displacement_victims_are_offered():
    rng = np.random.default_rng(7)
    cs, spill = _spill_store(cap=16)
    _fill(cs, rng, (0.2, 0.5, 0.6, 0.7))
    items, pri = _tiny_seg(rng, 0.9)  # displaces the 0.2 segment
    assert cs.put(items, pri, live=4) == "stored"
    assert cs.displaced == 1 and cs.spilled == 1
    [victim] = spill.offers
    assert victim.mass_sum == pytest.approx(0.2 * 4)


def test_cold_spill_refusal_not_counted_as_spilled():
    rng = np.random.default_rng(8)
    cs, spill = _spill_store(cap=16, accept=False)
    _fill(cs, rng, (0.4, 0.5, 0.6, 0.7))
    items, pri = _tiny_seg(rng, 0.1)
    assert cs.put(items, pri, live=4) == "dropped"
    assert len(spill.offers) == 1  # offered, refused (queue full)
    assert cs.spilled == 0


def test_cold_spill_all_dead_regions_never_offered():
    rng = np.random.default_rng(9)
    cs, spill = _spill_store(cap=16)
    items, pri = _tiny_seg(rng, 0.0)
    assert cs.put(items, pri, live=0) == "dropped"
    assert spill.offers == []  # zero mass: nothing worth disk bytes


def test_put_segment_door_without_touching_eviction_counters():
    rng = np.random.default_rng(10)
    cs, spill = _spill_store(cap=16)
    _fill(cs, rng, (0.3, 0.5, 0.6, 0.7))
    stored0, dropped0 = cs.stored, cs.dropped
    heavy = ColdSegment(b"promoted-bytes", 1, 4, 48, 0.4 * 4, 0.4, 7)
    assert cs.put_segment(heavy) == "stored"
    assert cs.displaced == 1
    [victim] = spill.offers
    assert victim.mass_sum == pytest.approx(0.3 * 4)
    # lighter than the floor: dropped, NOT re-spilled (no ping-pong)
    light = ColdSegment(b"light-bytes", 1, 4, 48, 0.01, 0.01, 8)
    assert cs.put_segment(light) == "dropped"
    assert len(spill.offers) == 1
    assert (cs.stored, cs.dropped) == (stored0, dropped0)


def test_displacement_floor_tracks_lightest_at_capacity():
    rng = np.random.default_rng(11)
    cs, _ = _spill_store(cap=16)
    assert cs.displacement_floor() == 0.0
    _fill(cs, rng, (0.4, 0.6))
    assert cs.displacement_floor() == 0.0  # below capacity
    _fill(cs, rng, (0.5, 0.7))
    assert cs.displacement_floor() == pytest.approx(0.4 * 4)


# -- ReplayConfig disk-knob validation ---------------------------------------


def test_replay_config_rejects_negative_disk_capacity():
    with pytest.raises(ValueError, match="cold_tier_disk_capacity"):
        ReplayConfig(cold_tier_disk_capacity=-1)


def test_replay_config_disk_requires_ram_tier():
    with pytest.raises(ValueError, match="cold_tier_capacity > 0"):
        ReplayConfig(cold_tier_disk_capacity=1 << 20)


def test_replay_config_disk_requires_dir():
    with pytest.raises(ValueError, match="cold_tier_disk_dir"):
        ReplayConfig(cold_tier_capacity=1 << 16,
                     cold_tier_disk_capacity=1 << 20)


def test_replay_config_disk_knob_bounds(tmp_path):
    kw = dict(cold_tier_capacity=1 << 16,
              cold_tier_disk_capacity=1 << 20,
              cold_tier_disk_dir=str(tmp_path / "x"))
    assert ReplayConfig(**kw).cold_tier_disk_queue == 16
    with pytest.raises(ValueError, match="cold_tier_disk_queue"):
        ReplayConfig(**kw, cold_tier_disk_queue=0)
    with pytest.raises(ValueError, match="cold_tier_disk_file_bytes"):
        ReplayConfig(**kw, cold_tier_disk_file_bytes=100)
    with pytest.raises(ValueError, match="cold_tier_disk_compact_frac"):
        ReplayConfig(**kw, cold_tier_disk_compact_frac=1.5)
    with pytest.raises(ValueError, match="cold_tier_disk_promote"):
        ReplayConfig(**kw, cold_tier_disk_promote=-1)


def test_replay_config_disk_defaults_off():
    cfg = ReplayConfig()
    assert cfg.cold_tier_disk_capacity == 0
    assert dataclasses.replace(cfg).cold_tier_disk_capacity == 0
