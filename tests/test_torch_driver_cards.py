"""The Ape-X driver over a mesh of distinct devices in one process
(parallel/cards.py), on the CPU over ``cpu:0 .. cpu:3`` (distinct device
objects whose tensors land on ``cpu``):

- `ApexDriver(mesh_devices=["cpu:0", ...])` through `run()` on the
  small configs of tests/test_torch_driver_dist.py: the frame ring at
  dp=2 over two devices, R2D2 at dp=2 x tp=2 over four (its 256-unit
  LSTM split across each row's two devices), to a clean end with the
  shards in lockstep and the summary's `mesh` block;
- a checkpoint carried across the two layouts, bitwise: saved over the
  four devices (the pieces joined), restored into the stacked learner
  on one device, saved there, restored over the four devices again;
- the servers over a split mesh (each batch split over the devices,
  the params replicated) against the same servers on one device: the
  single-policy server and the tier's coalesced forward, 1e-6."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch import configs as tcfgs
from ape_x_dqn_tpu_torch.configs import NetworkConfig
from ape_x_dqn_tpu_torch.envs.base import EnvSpec
from ape_x_dqn_tpu_torch.models import build_network
from ape_x_dqn_tpu_torch.parallel.inference_server import (
    BatchedInferenceServer)
from ape_x_dqn_tpu_torch.parallel.mesh import make_mesh
from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
from ape_x_dqn_tpu_torch.runtime.family import server_apply_fn
from ape_x_dqn_tpu_torch.runtime.learner import checkpoint_tree
from tests.test_torch_driver_dist import (_dp2, _r2d2_cfg, _ring_cfg,
                                          _synth_batch)
from tests.test_torch_serving import _NoDispatch, _wait_depth

CPUS = [f"cpu:{i}" for i in range(4)]


def _r2d2_split_cfg(**kw):
    cfg = _r2d2_cfg(**kw)
    return cfg.replace(
        parallel=tcfgs.ParallelConfig(dp=2, tp=2),
        network=dataclasses.replace(cfg.network, lstm_size=256))


@pytest.fixture
def make():
    made = []

    def build(cfg, mesh_devices, **kw):
        d = ApexDriver(cfg, device="cpu", mesh_devices=mesh_devices, **kw)
        made.append(d)
        return d

    yield build
    for d in made:
        d.server.stop()


@pytest.mark.parametrize("cfg_fn,devices", [
    (lambda: _dp2(_ring_cfg()), CPUS[:2]),
    (_r2d2_split_cfg, CPUS)], ids=["frame_ring_dp2", "r2d2_dp2xtp2"])
def test_cards_driver_runs_to_a_clean_end(make, cfg_fn, devices):
    cfg = cfg_fn()
    cfg = cfg.replace(learner=dataclasses.replace(
        cfg.learner, steps_per_frame_cap=None))
    d = make(cfg, devices)
    assert d.cards and len(d.learner.groups) == 2
    out = d.run(total_env_frames=3000, max_grad_steps=24,
                wall_clock_limit_s=60)
    assert not out["actor_errors"] and not out["loop_errors"], out
    assert out["grad_steps"] > 0
    shards = out["replay_shards"]
    assert len(shards["sizes"]) == 2
    assert shards["fill_min"] == shards["fill_max"] > 0
    mesh = out["mesh"]
    assert mesh["cards"] == devices
    assert mesh["rows_per_card"] == {devices[0]: [0],
                                     devices[-2 if len(devices) > 2
                                             else -1]: [1]}
    split = cfg.parallel.tp > 1
    assert mesh["split_layers"] == (["lstm"] if split else [])
    assert mesh["tp_partners"] == ({"cpu:0": ["cpu:1"],
                                    "cpu:2": ["cpu:3"]} if split else {})
    # one exchange per grad-step, of the whole packed vector per group
    assert mesh["exchange"]["calls"] == out["grad_steps"]
    assert mesh["exchange"]["groups"] == 2
    assert set(mesh["per_card"]) == set(devices)
    assert all(c["budget_bytes"] > 0 for c in mesh["per_card"].values())
    for st in d.state.groups:
        assert st.replay.pos.tolist() == st.replay.pos_dev.tolist()
        assert st.replay.size.tolist() == st.replay.size_dev.tolist()


def _step_and_save(d, seed):
    """Ingest three staged blocks, one grad-step, a checkpoint; -> the
    saved tree as the learner holds it."""
    block = d.dp * d._stage_chunk
    for i in range(3):
        batch = _synth_batch(d, block, seed=seed + i, frames=block)
        batch["actions"] %= d.spec.num_actions
        d._ingest_one(batch, block)
    d._stager.drain()
    d.state, _ = d.learner.train_step(d.state)
    d._grad_steps_total = d.state.step
    d._save_checkpoint(wait=True)
    return checkpoint_tree(d.state, with_replay=True)


def _assert_same(got: dict, want: dict, what: str):
    for key in ("params", "target_params"):
        assert list(got[key]) == list(want[key])
        for k, v in got[key].items():
            assert torch.equal(v, want[key][k]), f"{what}: {key}.{k}"
    for part in ("mu", "nu"):
        for a, b in zip(got["opt_state"][part], want["opt_state"][part]):
            assert torch.equal(a, b), f"{what}: adam {part}"
    assert int(got["opt_state"]["count"]) == int(want["opt_state"]["count"])
    assert torch.equal(got["rng"], want["rng"]) and got["step"] == want["step"]
    r, w = got["replay"], want["replay"]
    assert r["pos"] == w["pos"] and r["size"] == w["size"]
    assert torch.equal(r["tree"].cpu(), w["tree"].cpu()), what
    for k, v in r["storage"].items():
        assert torch.equal(v.cpu(), w["storage"][k].cpu()), f"{what}: {k}"


def test_checkpoint_carries_across_layouts_bitwise(make, tmp_path):
    base = _r2d2_split_cfg().replace(checkpoint_replay=True)
    first = base.replace(checkpoint_dir=str(tmp_path / "cards"))
    a = make(first, CPUS)
    assert a.learner.split_layers == ["lstm"]
    saved = _step_and_save(a, 100)
    # restored into the stacked learner on one device: the same tree
    b = make(first, ["cpu"] * 4)
    assert not b.cards and b.state.step == 1
    _assert_same(checkpoint_tree(b.state, with_replay=True), saved,
                 "four devices -> one")
    # and back: a stacked checkpoint restores into the pieces in place
    b.ckpt = type(b.ckpt)(str(tmp_path / "stacked"))
    saved_b = _step_and_save(b, 200)
    c = make(base.replace(checkpoint_dir=str(tmp_path / "stacked")), CPUS)
    assert c.cards and c.state.step == 2
    _assert_same(checkpoint_tree(c.state, with_replay=True), saved_b,
                 "one device -> four")


def _mlp_apply():
    spec = EnvSpec((6,), np.dtype(np.float32), True, 4)
    torch.manual_seed(0)
    net = build_network(NetworkConfig(kind="mlp", mlp_hidden=(32,),
                                      dueling=True,
                                      compute_dtype="float32"), spec)
    params = {k: v.detach().clone() for k, v in net.state_dict().items()}
    return server_apply_fn("dqn", net), params


def test_split_server_matches_the_plain_server():
    apply, params = _mlp_apply()
    mesh = make_mesh(dp=4, tp=2, devices=CPUS * 2)
    split = BatchedInferenceServer(apply, params, max_batch=16, mesh=mesh,
                                   device="cpu")
    plain = BatchedInferenceServer(apply, params, max_batch=16,
                                   device="cpu")
    try:
        assert split._split is not None and plain._split is None
        assert set(split._params) == set(mesh.cards)
        rng = np.random.default_rng(0)
        for n in (1, 5, 13):
            x = rng.normal(size=(n, 6)).astype(np.float32)
            got = split.query_batch(x, n)
            np.testing.assert_allclose(got, plain.query_batch(x, n),
                                       rtol=1e-6, atol=1e-6)
        # a publication reaches every device's replica
        new = {k: v * 0.5 for k, v in params.items()}
        split.update_params(new, 3)
        plain.update_params(new, 3)
        x = rng.normal(size=(8, 6)).astype(np.float32)
        np.testing.assert_allclose(split.query_batch(x, 8),
                                   plain.query_batch(x, 8), rtol=1e-6,
                                   atol=1e-6)
    finally:
        split.stop()
        plain.stop()


def test_split_tier_coalesced_forward_matches_one_device():
    """A batch that mixes two tenants: ONE gathered forward per device
    over its rows of the batch, against the same tier on one device."""
    apply, params = _mlp_apply()
    other = {k: v * -0.7 for k, v in params.items()}
    mesh = make_mesh(dp=2, tp=2, devices=CPUS)
    outs = []
    for m in (mesh, None):
        tier = _NoDispatch(max_batch=8, deadline_ms=0.0,
                           queue_slo_items=100, mesh=m, device="cpu")
        try:
            a = tier.register_policy("a", apply, params, family="q")
            b = tier.register_policy("b", apply, other, family="q")
            rng = np.random.default_rng(1)
            xs = [rng.normal(size=6).astype(np.float32),
                  rng.normal(size=(3, 6)).astype(np.float32),
                  rng.normal(size=6).astype(np.float32)]
            tickets = [a.submit(xs[0]), b.submit(xs[1], 3), a.submit(xs[2])]
            _wait_depth(tier, 5)
            tier._forward(*tier._take_batch())
            outs.append([np.asarray(t.wait(5.0)) for t in tickets])
            assert tier.stats["gather_batches"] == 1
        finally:
            tier.stop()
    for got, want in zip(*outs):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_split_server_serves_concurrent_actors():
    """Many threads' single queries through a split server, each reply
    the plain forward of its own observation."""
    apply, params = _mlp_apply()
    mesh = make_mesh(dp=2, tp=1, devices=CPUS[:2])
    server = BatchedInferenceServer(apply, params, max_batch=8,
                                    deadline_ms=2.0, mesh=mesh,
                                    device="cpu")
    xs = np.random.default_rng(2).normal(size=(12, 6)).astype(np.float32)
    want = apply(params, torch.from_numpy(xs)).numpy()
    got = [None] * len(xs)

    def ask(i):
        got[i] = server.query(xs[i])

    try:
        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        server.stop()
    np.testing.assert_allclose(np.stack(got), want, rtol=1e-6, atol=1e-6)
