"""The cold tier and legacy staging over distinct devices in one process
(parallel/cards.py, runtime/driver.py), on the CPU over ``cpu:0,
cpu:1`` (distinct device objects whose tensors land on ``cpu``):

- the swap endpoints of `CardsLearner` (`evict_landed`, `land_add_at`,
  `add_at_landed`) at dp=2 over two devices and at dp=4 over two (two
  rows a device, rows 0 and 2 on cpu:0), against the JAX package's
  `DistDQNLearner.evict_region` / `add_at` on its emulated devices and
  the port's stacked `DistDQNLearner` on one device, from the same
  replay (the JAX side's sum-trees copied into the port's): the [dp]
  starts, the regions and their priorities equal, and after the
  directed add of one block the storage and the cursors equal and the
  sum-trees within 1e-6 of both (the leaf transform (|td| + eps) **
  alpha rounds by a block's layout on the CPU: the stacked learner's
  [dp, block] and a group's [dp_c, block] differ in the last bit of a
  few leaves, and XLA's differs from both);
- the driver with the cold tier over two devices: hand stepped
  alongside the stacked driver on the same blocks (the same swaps, the
  same per-shard door outcomes, the same replay), and through `run()`
  to a clean end with evicted == stored + dropped per shard and
  recalls;
- legacy staging over two devices: force-flush drop counts per shard
  equal the stacked driver's, the replay equal, and `run()` to a
  clean end."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
from ape_x_dqn_tpu_torch.runtime.learner import checkpoint_tree
from tests.test_torch_dist_cards import _flat
from tests.test_torch_driver_dist import (_closure_per_shard,
                                          _cold_ring_cfg, _dp2, _fill_ring,
                                          _ring_cfg, _synth_batch)

TWO = ["cpu:0", "cpu:1"]
BLOCK = 16
TREE_TOL = 1e-6


def _shards(learner):
    """(group or None, its global rows) of the port learner's states."""
    groups = getattr(learner, "groups", None)
    if groups is None:
        return [(None, list(range(learner.dp)))]
    return [(i, list(g.rows)) for i, g in enumerate(groups)]


def _replays(learner, state):
    if hasattr(state, "groups"):
        return [st.replay for st in state.groups]
    return [state.replay]


def _evict_rows(learner, evicted, dp) -> dict:
    """The evict result(s) -> {start, priorities, items...} [dp, ...] in
    row order (the driver's `_fetch_region` without the pinned copies)."""
    parts = evicted if isinstance(evicted, list) else [evicted]
    out = {}
    for (_, rows), (start, items, pri) in zip(_shards(learner), parts):
        leaves = dict(items, priorities=pri, start=start)
        for k, v in leaves.items():
            v = v.numpy()
            if k not in out:
                out[k] = np.empty((dp, *v.shape[1:]), v.dtype)
            out[k][rows] = v
    return out


@pytest.mark.parametrize("dp,devices", [(2, TWO), (4, TWO * 2)],
                         ids=["dp2_on_two", "dp4_on_two"])
def test_swap_endpoints_match_jax_and_the_stacked_learner(dp, devices):
    jl, js, port, items, td, _ = _flat(dp, 1, devices)
    cl, cs = port(devices)
    sl, ss = port(["cpu"] * dp)
    assert len(cl.groups) == 2
    # fill every shard's 64 slots: the 40 recorded items, then 24 of
    # them again under fresh priorities (repeated masses would tie two
    # windows, which the two packages' cumulative sums break apart)
    td2 = np.random.default_rng(8).uniform(0.1, 2.0, (dp, 24)).astype(
        np.float32)
    fill = [(items, td), ({k: v[:, :24] for k, v in items.items()}, td2)]
    for its, t in fill:
        js = jl.add(js, {k: jnp.asarray(v) for k, v in its.items()},
                    jnp.asarray(t))
        for lrn, st in ((cl, cs), (sl, ss)):
            lrn.add(st, {k: torch.from_numpy(v) for k, v in its.items()},
                    torch.from_numpy(t))
    jtree = torch.from_numpy(np.array(js.replay.tree))
    for lrn, st in ((cl, cs), (sl, ss)):
        for (_, rows), rs in zip(_shards(lrn), _replays(lrn, st)):
            rs.tree.copy_(jtree[rows])
            assert rs.size.tolist() == [64] * len(rows)
    # the plan and read of one block per shard
    jstart, jitems, jpri = jl.evict_region(js, BLOCK)
    want = dict({k: np.asarray(v) for k, v in jitems.items()},
                priorities=np.asarray(jpri), start=np.asarray(jstart))
    got = _evict_rows(cl, cl.evict_landed(cs, BLOCK), dp)
    stacked = _evict_rows(sl, sl.evict_landed(ss, BLOCK), dp)
    assert set(got) == set(want) == set(stacked)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(stacked[k], v, err_msg=k)
    # the directed add of a new block at those starts
    rng = np.random.default_rng(9)
    new = {k: (rng.normal(size=(dp, BLOCK, *v.shape[2:])) * 2
               ).astype(v.dtype) for k, v in items.items()}
    new_td = rng.uniform(0.1, 2.0, (dp, BLOCK)).astype(np.float32)
    js = jl.add_at(js, {k: jnp.asarray(v) for k, v in new.items()},
                   jnp.asarray(new_td), jstart)
    views = {k: torch.from_numpy(v.reshape(dp * BLOCK, *v.shape[2:]))
             for k, v in dict(new, priorities=new_td).items()}
    start_host = want["start"]
    for lrn, st in ((cl, cs), (sl, ss)):
        inputs = lrn.land_add_at(views, (dp, BLOCK))
        evicted = lrn.evict_landed(st, BLOCK)    # the device starts
        start = ([e[0] for e in evicted] if isinstance(evicted, list)
                 else evicted[0])
        np.testing.assert_array_equal(
            _evict_rows(lrn, evicted, dp)["start"], start_host)
        lrn.add_at_landed(st, inputs, start, start_host)
    got = checkpoint_tree(cs, with_replay=True)["replay"]
    stacked = checkpoint_tree(ss, with_replay=True)["replay"]
    for k, v in got["storage"].items():
        assert torch.equal(v, stacked["storage"][k]), k
    np.testing.assert_allclose(got["tree"].numpy(),
                               stacked["tree"].numpy(), rtol=TREE_TOL,
                               atol=TREE_TOL)
    assert got["pos"] == stacked["pos"] == np.asarray(
        js.replay.pos).tolist()
    assert got["size"] == stacked["size"] == [64] * dp
    np.testing.assert_allclose(got["tree"].numpy(),
                               np.asarray(js.replay.tree), rtol=TREE_TOL,
                               atol=TREE_TOL)
    # the new block landed where every side put it, rows unpacked alike
    for r in range(dp):
        s = int(start_host[r])
        np.testing.assert_array_equal(
            got["storage"]["action"][r, s:s + BLOCK].numpy(),
            new["action"][r])


@pytest.fixture
def make():
    made = []

    def build(cfg, devices):
        d = ApexDriver(cfg, device="cpu", mesh_devices=devices)
        made.append(d)
        return d

    yield build
    for d in made:
        d.server.stop()
        if d._disk is not None:
            d._disk.close()


def test_cold_tier_over_two_devices_swaps_as_the_stacked_driver(make):
    """The same fill, swaps and recall through both drivers: the same
    door outcomes per shard, the same recalls, the same replay."""
    outs = []
    for devices in (TWO, ["cpu"] * 2):
        d = make(_dp2(_cold_ring_cfg()), devices)
        assert d.cards == (devices == TWO)
        block = _fill_ring(d)
        for i in range(4):
            d._ingest_one(_synth_batch(d, block, seed=60 + i), block)
        d._stager.drain()
        d._cold_refill_tick()
        d._stager.drain()
        _closure_per_shard(d)
        assert (d._cold_evicted_per_shard > 0).all()
        assert d._cold_recalled > 0
        outs.append((d._cold_evicted_per_shard.tolist(),
                     d._cold_stored_per_shard.tolist(), d._cold_recalled,
                     checkpoint_tree(d.state, with_replay=True)["replay"]))
    (ev, st, rec, got), (ev_s, st_s, rec_s, want) = outs
    assert (ev, st, rec) == (ev_s, st_s, rec_s)
    assert got["pos"] == want["pos"] and got["size"] == want["size"]
    for k, v in got["storage"].items():
        assert torch.equal(v, want["storage"][k]), k
    # leaves and sums within float rounding (the leaf transform's pow
    # rounds by block shape on the CPU)
    np.testing.assert_allclose(got["tree"].numpy(), want["tree"].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_cold_tier_driver_over_two_devices_runs_to_a_clean_end(make):
    cfg = _dp2(_cold_ring_cfg())
    # paced, so that the eager learner's gate leaves the actor its time
    cfg = cfg.replace(learner=dataclasses.replace(
        cfg.learner, steps_per_frame_cap=0.02))
    d = make(cfg, TWO)
    # the ring (128 transitions) fills within the first few hundred
    # frames; the rest of the budget swaps, and the ingest thread's idle
    # ticks recall
    out = d.run(total_env_frames=1500, wall_clock_limit_s=40)
    assert not out["actor_errors"] and not out["loop_errors"], out
    assert out["grad_steps"] > 0
    cold = out["cold_tier"]
    assert cold["evicted"] > 0 and cold["recalled"] > 0, cold
    np.testing.assert_array_equal(
        cold["evicted_per_shard"],
        np.add(cold["stored_per_shard"], cold["dropped_per_shard"]))
    assert all(n > 0 for n in cold["evicted_per_shard"])
    assert out["mesh"]["cards"] == TWO
    for st in d.state.groups:
        assert st.replay.pos.tolist() == st.replay.pos_dev.tolist()
        assert st.replay.size.tolist() == st.replay.size_dev.tolist()
    # the budget counts each owner's swap buffers
    assert all(b.swap > 0 for b in d.hbm_budgets.values())


@pytest.mark.parametrize("frame_ring", [True, False],
                         ids=["frame_ring", "flat"])
def test_legacy_staging_over_two_devices_drops_as_the_stacked(make,
                                                             frame_ring):
    outs = []
    for devices in (TWO, ["cpu"] * 2):
        cfg = _ring_cfg(ingest_zero_copy=False)
        if not frame_ring:
            cfg = _ring_cfg(ingest_zero_copy=False, storage="flat",
                            capacity=256)
        d = make(_dp2(cfg), devices)
        assert d._stager is None and d.cards == (devices == TWO)
        block = d.dp * d._stage_chunk
        tail = d._stage_chunk + 1
        for i in range(3):
            batch = _synth_batch(d, block + (tail if i == 2 else 0),
                                 seed=i, frames=11)
            if frame_ring and i == 2:
                batch["next_off"][block:] = 0
                for j in range(tail):
                    batch["next_off"][block + j, :j + 1] = 2
            d._ingest_one(batch, batch["priorities"].shape[0])
        d._flush_stage(force=True)
        outs.append((d._stage_dropped_per_shard.tolist(), d._stage_dropped,
                     checkpoint_tree(d.state, with_replay=True)["replay"]))
    (per, total, got), (per_s, total_s, want) = outs
    assert per == per_s and total == total_s > 0
    assert got["size"] == want["size"] and got["pos"] == want["pos"]
    for k, v in got["storage"].items():
        assert torch.equal(v, want["storage"][k]), k
    np.testing.assert_allclose(got["tree"].numpy(), want["tree"].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_legacy_staging_over_two_devices_runs_to_a_clean_end(make):
    cfg = _dp2(_ring_cfg(ingest_zero_copy=False))
    cfg = cfg.replace(learner=dataclasses.replace(
        cfg.learner, steps_per_frame_cap=None))
    d = make(cfg, TWO)
    out = d.run(total_env_frames=3000, max_grad_steps=24,
                wall_clock_limit_s=60)
    assert not out["actor_errors"] and not out["loop_errors"], out
    assert out["grad_steps"] > 0
    shards = out["replay_shards"]
    assert shards["fill_min"] == shards["fill_max"] > 0
    assert out["mesh"]["exchange"]["calls"] == out["grad_steps"]


def test_the_budget_counts_each_owners_swap_buffers(make):
    """utils/hbm.py's `swap_bytes` is what a swap leaves allocated on an
    owner per shard it holds: the evict result (start, region,
    priorities) and the add_at inputs (the same again); the driver's
    card budgets carry it, on every owner."""
    from ape_x_dqn_tpu_torch.utils.hbm import swap_bytes

    d = make(_dp2(_cold_ring_cfg()), TWO)
    block = _fill_ring(d)
    evicted = d.learner.evict_landed(d.state, d._stage_chunk)
    for (start, items, pri), b in zip(evicted, d.hbm_budgets.values()):
        held = sum(t.numel() * t.element_size()
                   for t in (start, pri, *items.values()))
        assert swap_bytes(d._item_spec, d._stage_chunk,
                          d.cfg.replay.seg_transitions) == 2 * held
        assert b.swap == 2 * held     # one shard on each owner
    assert block == d.dp * d._stage_chunk


def test_a_ranks_cards_are_priced_with_their_ranks_and_nccl():
    """A multi-host rank over several cards: every card's total counts
    once per rank on it (`processes_per_card`), and the cross-rank
    communicator's part sits on the rank's first card only."""
    from ape_x_dqn_tpu_torch.configs import get_config
    from ape_x_dqn_tpu_torch.envs.base import EnvSpec
    from ape_x_dqn_tpu_torch.models import build_network
    from ape_x_dqn_tpu_torch.parallel.mesh import rank_mesh
    from ape_x_dqn_tpu_torch.utils.hbm import (NCCL_DEVICE_BYTES,
                                               check_mesh_fits, mesh_budgets)

    cfg = get_config("r2d2")
    net = build_network(cfg.network,
                        EnvSpec((84, 84, 4), np.dtype(np.uint8), True, 18))
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    mesh = rank_mesh(2, 2, cards)       # one group on cuda:0, split
    got = mesh_budgets(cfg, (84, 84, 4), np.uint8, shapes, mesh,
                       cross_nccl=True)
    assert got[cards[0]].nccl == NCCL_DEVICE_BYTES
    assert got[cards[1]].nccl == 0
    base = mesh_budgets(cfg, (84, 84, 4), np.uint8, shapes, mesh)
    assert got[cards[0]].total == base[cards[0]].total + NCCL_DEVICE_BYTES
    need = got[cards[0]].total
    assert check_mesh_fits(cfg, (84, 84, 4), np.uint8, shapes, mesh,
                           hbm_bytes=need, cross_nccl=True) == got
    with pytest.raises(ValueError, match=r"x 2 processes on card cuda:0"):
        check_mesh_fits(cfg, (84, 84, 4), np.uint8, shapes, mesh,
                        hbm_bytes=need, processes_per_card=2,
                        cross_nccl=True)
