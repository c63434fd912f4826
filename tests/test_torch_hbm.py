"""The port's memory budget (utils/hbm.py) against the JAX package's:
for every preset, over pixel and vector observations, the replay
storage, the sum-tree, the model state, the per-device capacity and the
layout detail equal the original's byte for byte; only the transient
headroom is the port's own (measured on the card, not on a TPU).
`check_hbm_fits` raises with the budget table for a run that cannot
fit 80 GB, and the driver calls it before it allocates anything."""

import dataclasses

import numpy as np
import pytest

from ape_x_dqn_tpu import configs as jcfgs
from ape_x_dqn_tpu.utils import hbm as jhbm
from ape_x_dqn_tpu_torch import configs as tcfgs
from ape_x_dqn_tpu_torch.utils import hbm as thbm

GB80 = 80 * 1024 ** 3
SHAPES = {"pixels": ((84, 84, 4), np.uint8),
          "vector": ((17,), np.float32),
          "pendulum": ((3,), np.float32)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("preset", sorted(jcfgs.PRESETS))
def test_run_budget_is_the_originals_byte_for_byte(preset, shape):
    obs, dtype = SHAPES[shape]
    for params in (1_686_566, 6_500_000):
        want = jhbm.run_budget(jcfgs.get_config(preset), obs, dtype, params)
        got = thbm.run_budget(tcfgs.get_config(preset), obs, dtype, params)
        assert got.replay_storage == want.replay_storage
        assert got.replay_tree == want.replay_tree
        assert got.model_state == want.model_state
        assert got.capacity == want.capacity
        assert got.detail == want.detail
        assert got.headroom == thbm.TRANSIENT_HEADROOM
        assert got.total - got.headroom == want.total - want.headroom


def _pong(capacity: int):
    cfg = tcfgs.get_config("pong")
    return cfg.replace(
        env=dataclasses.replace(cfg.env, kind="synthetic_atari"),
        replay=dataclasses.replace(cfg.replay, capacity=capacity))


def test_check_hbm_fits_raises_past_80_gb():
    fits = thbm.check_hbm_fits(_pong(1 << 20), (84, 84, 4),
                               hbm_bytes=GB80)
    assert fits.total < GB80
    with pytest.raises(ValueError, match="needs .* GiB per device") as ei:
        thbm.check_hbm_fits(_pong(1 << 24), (84, 84, 4), hbm_bytes=GB80)
    assert "TOTAL per device" in str(ei.value)
    assert thbm.device_hbm_bytes("cpu") is None


def test_the_driver_checks_before_it_allocates(monkeypatch):
    """A 16M-transition pong ring (~157 GiB) on an 80 GB card: the driver
    raises in its fits-check, before any replay storage exists."""
    from ape_x_dqn_tpu_torch.replay.frame_ring import FrameRingReplay
    from ape_x_dqn_tpu_torch.runtime import driver as driver_mod

    def no_alloc(self, *a, **kw):
        raise AssertionError("the replay was allocated before the check")

    monkeypatch.setattr(FrameRingReplay, "init", no_alloc)
    monkeypatch.setattr(driver_mod, "check_hbm_fits",
                        lambda *a, **kw: thbm.check_hbm_fits(
                            *a, **{**kw, "hbm_bytes": GB80}))
    with pytest.raises(ValueError, match="needs"):
        driver_mod.ApexDriver(_pong(1 << 24), device="cpu")


def test_serving_gather_is_priced_apart():
    """With the serving tier coalescing, the budget adds the gathered
    forward's params: the largest bucket (max_batch 64 for pong) x one
    tenant's float32 params; nothing without the tier or without
    coalescing, so every preset's default budget is unchanged."""
    pong = tcfgs.get_config("pong")
    params = 1_686_566
    assert thbm.serving_transient_bytes(pong, params) == 0
    tier = pong.replace(serving=dataclasses.replace(
        pong.serving, multi_tenant=True))
    assert thbm.serving_transient_bytes(tier, params) == 64 * params * 4
    budget = thbm.run_budget(tier, (84, 84, 4), np.uint8, params)
    plain = thbm.run_budget(pong, (84, 84, 4), np.uint8, params)
    assert budget.total - plain.total == 64 * params * 4
    assert "serving gather" in budget.table()
    off = tier.replace(serving=dataclasses.replace(tier.serving,
                                                   coalesce=False))
    assert thbm.serving_transient_bytes(off, params) == 0


@pytest.mark.parametrize("preset,storage", [
    ("atari57_apex", 20_703_084_544), ("r2d2", 38_738_591_744)])
def test_a_one_card_mesh_is_priced_at_all_its_shards(preset, storage):
    """The presets' own dp=4 x tp=2 mesh over one card repeated
    ([card] * 8) puts all four replay shards on that card: the card's
    budget is four times the original's per-device (one-shard) replay
    and sum-tree, the model state whole, and it fits 80 GB."""
    from ape_x_dqn_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(dp=4, tp=2, devices=["cpu"] * 8)
    shards = mesh.shards_on("cpu")
    assert shards == 4
    params = 6_500_000
    want = jhbm.run_budget(jcfgs.get_config(preset), (84, 84, 4), np.uint8,
                           params)
    got = thbm.check_hbm_fits(tcfgs.get_config(preset), (84, 84, 4),
                              np.uint8, param_count=params, hbm_bytes=GB80,
                              shards_per_card=shards)
    assert got.replay_storage == 4 * want.replay_storage == storage
    assert got.replay_tree == 4 * want.replay_tree
    assert got.model_state == want.model_state
    assert got.capacity == 4 * want.capacity
    assert got.detail["shards_per_card"] == 4
    assert got.total < GB80
