"""The one-process mesh over distinct devices (parallel/mesh.py) and
the tp pieces (parallel/sharding.py), on the CPU: ``cpu:0 .. cpu:3``
are distinct device objects whose tensors all land on ``cpu``, so a
mesh over them runs the per-card code without a card.

- the grouping of a mesh by card: rows by owner, tp partners by row;
  a mesh of one device repeated stays one group, whole;
- `replicated` and `batch_sharding` as placements;
- `shard_params` and its inverse round-trip, bitwise;
- each device's pieces against the original's `shard_params` shards
  on its eight emulated devices (`addressable_shards`), for the Nature
  CNN and the LSTM Q-net at the presets' widths, exactly (the same
  float32 values, moved into the port's layout);
- the HBM budget of every card of such a mesh, and the card that does
  not fit named (utils/hbm.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.configs import NetworkConfig as JNetworkConfig
from ape_x_dqn_tpu.envs.base import EnvSpec as JEnvSpec
from ape_x_dqn_tpu.models import build_network as jax_build_network
from ape_x_dqn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ape_x_dqn_tpu.parallel.sharding import shard_params as jax_shard_params
from ape_x_dqn_tpu_torch.configs import NetworkConfig
from ape_x_dqn_tpu_torch.envs.base import EnvSpec
from ape_x_dqn_tpu_torch.models import build_network
from ape_x_dqn_tpu_torch.models.convert import (dense_weight, from_flax,
                                                torso_out_weight)
from ape_x_dqn_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                               replicated)
from ape_x_dqn_tpu_torch.parallel.sharding import (shard_params,
                                                   torch_split,
                                                   unshard_params)

CPUS = [f"cpu:{i}" for i in range(4)]


def _dev(name):
    return torch.device(name)


@pytest.mark.parametrize("dp,tp,devices,groups", [
    (4, 1, CPUS, [("cpu:0", (0,), ("cpu:0",)), ("cpu:1", (1,), ("cpu:1",)),
                  ("cpu:2", (2,), ("cpu:2",)), ("cpu:3", (3,), ("cpu:3",))]),
    (2, 2, CPUS, [("cpu:0", (0,), ("cpu:0", "cpu:1")),
                  ("cpu:2", (1,), ("cpu:2", "cpu:3"))]),
    (4, 2, CPUS * 2, [("cpu:0", (0, 2), ("cpu:0", "cpu:1")),
                      ("cpu:2", (1, 3), ("cpu:2", "cpu:3"))]),
    (2, 4, CPUS * 2, [("cpu:0", (0, 1), tuple(CPUS))]),
], ids=["dp4xtp1", "dp2xtp2", "cpus_x2_dp4xtp2", "cpus_x2_dp2xtp4"])
def test_mesh_groups_rows_by_owner(dp, tp, devices, groups):
    mesh = make_mesh(dp=dp, tp=tp, devices=devices)
    assert mesh.distinct and mesh.shape == {"dp": dp, "tp": tp}
    got = [(str(g.owner), g.rows, tuple(map(str, g.tp_devices)))
           for g in mesh.groups]
    assert got == groups
    assert all(g.split == (tp > 1) for g in mesh.groups)
    assert mesh.cards == [_dev(d) for d in dict.fromkeys(devices[:dp * tp])]
    for owner, rows, _ in groups:
        assert mesh.shards_on(owner) == len(rows)
    assert sum(mesh.shards_on(d) for d in mesh.cards) == dp
    # a partner owns no shard
    if tp > 1 and dp * tp == 4 and dp > 1:
        assert mesh.shards_on("cpu:1") == 0
    assert sorted(p for d in mesh.cards for p in mesh.positions_on(d)) \
        == list(range(dp * tp))


def test_one_device_repeated_stays_one_whole_group():
    mesh = make_mesh(dp=4, tp=2, devices=["cpu"] * 8)
    assert not mesh.distinct and len(mesh.groups) == 1
    (g,) = mesh.groups
    assert g.rows == (0, 1, 2, 3) and not g.split
    assert mesh.shards_on("cpu") == 4


def test_mesh_refusals():
    with pytest.raises(AssertionError, match=r"dp\(3\) \* tp\(2\) > "
                                             r"device count \(4\)"):
        make_mesh(dp=3, tp=2, devices=CPUS)
    with pytest.raises(ValueError, match="one type"):
        make_mesh(dp=2, tp=1, devices=["cpu", "cuda:0"])
    # rows that share an owner keep one set of tp partners
    mesh = make_mesh(dp=2, tp=2, devices=["cpu:0", "cpu:1", "cpu:0",
                                          "cpu:2"])
    with pytest.raises(NotImplementedError, match="one set of tp"):
        mesh.groups


def test_replicated_puts_one_copy_per_card():
    mesh = make_mesh(dp=4, tp=2, devices=CPUS * 2)
    params = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}
    put = replicated(mesh).put(params)
    assert list(put) == [_dev(d) for d in CPUS]
    for copy in put.values():
        for k, v in params.items():
            assert torch.equal(copy[k], v) and copy[k] is not v
    one = replicated(mesh).put(params["w"])
    assert len(one) == 4 and all(torch.equal(v, params["w"])
                                 for v in one.values())


@pytest.mark.parametrize("dp,tp,devices", [
    (4, 2, CPUS * 2), (2, 2, CPUS), (4, 1, CPUS)])
def test_batch_sharding_groups_positions_by_card(dp, tp, devices):
    mesh = make_mesh(dp=dp, tp=tp, devices=devices)
    split = batch_sharding(mesh)
    n = 3 * mesh.size
    rows = split.rows(n)
    # position p holds rows [3p, 3p+3); a card holds its positions' rows
    for dev, idx in rows.items():
        want = [r for p in mesh.positions_on(dev)
                for r in range(3 * p, 3 * p + 3)]
        assert idx.tolist() == want
    x = torch.arange(n * 2.0).reshape(n, 2)
    parts = split.split(x)
    assert sum(v.shape[0] for v in parts.values()) == n
    assert torch.equal(split.gather(parts, n), x)
    with pytest.raises(ValueError, match="does not split"):
        split.rows(n + 1)


NETS = {
    "nature_cnn": (dict(kind="nature_cnn", dueling=True), (84, 84, 4),
                   False),
    "lstm_q": (dict(kind="lstm_q", lstm_size=512, dueling=True),
               (84, 84, 4), True),
}


def _flax_params(name):
    cfg, obs, seq = NETS[name]
    jnet = jax_build_network(JNetworkConfig(**cfg),
                             JEnvSpec(obs, np.dtype(np.uint8), True, 6))
    x = jnp.zeros((1, 1, *obs) if seq else (1, *obs), jnp.uint8)
    if seq:
        z = jnp.zeros((1, cfg["lstm_size"]), jnp.float32)
        return jnet.init(jax.random.key(0), x, (z, z))
    return jnet.init(jax.random.key(0), x)


@pytest.mark.parametrize("name", list(NETS))
def test_shard_params_round_trips(name):
    cfg, obs, _ = NETS[name]
    net = build_network(NetworkConfig(**cfg),
                        EnvSpec(obs, np.dtype(np.uint8), True, 6))
    sd = net.state_dict()
    pieces = shard_params(sd, ["cpu:0", "cpu:1"])
    owner, partner = pieces.values()
    assert set(owner) == set(sd)
    split = {k for k, v in sd.items() if torch_split(k, tuple(v.shape), 2)}
    assert set(partner) == split and split
    for k in split:
        assert owner[k].shape[0] * 2 == sd[k].shape[0]
    whole = unshard_params(pieces)
    assert list(whole) == list(sd)
    for k, v in sd.items():
        assert torch.equal(whole[k], v), k


def _shards_by_tp(arr, jmesh):
    """{tp index: the shard data on a device of that tp column}."""
    col = {dev: t for row in jmesh.devices for t, dev in enumerate(row)}
    out = {}
    for s in arr.addressable_shards:
        out.setdefault(col[s.device], np.asarray(s.data))
    return out


@pytest.mark.parametrize("name", list(NETS))
def test_pieces_match_the_original_shards(name):
    """Piece t of every split parameter is what the original's
    `shard_params` puts on the devices of tp column t (in the port's
    layout: transposed, the LSTM's per-gate shards concatenated, the
    torso_out rows permuted as models/convert.py permutes them); the
    replicated parameters stay whole on the owner."""
    params = _flax_params(name)
    jmesh = jax_make_mesh(dp=4, tp=2)
    sharded = jax_shard_params(params, jmesh)
    p, s = params["params"], sharded["params"]
    pieces = list(shard_params(from_flax(jax.tree.map(np.asarray, params)),
                               ["cpu:0", "cpu:1"]).values())
    torso = s["torso"]["torso_out"]
    channels = p["torso"]["Conv_2"]["kernel"].shape[-1]
    for t in (0, 1):
        k = _shards_by_tp(torso["kernel"], jmesh)[t]
        b = _shards_by_tp(torso["bias"], jmesh)[t]
        assert k.shape[1] * 2 == p["torso"]["torso_out"]["kernel"].shape[1]
        np.testing.assert_array_equal(
            pieces[t]["torso.torso_out.weight"].numpy(),
            torso_out_weight(k, channels).numpy())
        np.testing.assert_array_equal(
            pieces[t]["torso.torso_out.bias"].numpy(), b)
        if name != "lstm_q":
            continue
        cell = s["lstm"]
        for key, fmt in (("lstm.weight_ih", "i{}"), ("lstm.weight_hh",
                                                      "h{}")):
            want = np.concatenate(
                [dense_weight(_shards_by_tp(cell[fmt.format(g)]["kernel"],
                                            jmesh)[t]).numpy()
                 for g in "ifgo"])
            np.testing.assert_array_equal(pieces[t][key].numpy(), want)
        want = np.concatenate([_shards_by_tp(cell[f"h{g}"]["bias"],
                                             jmesh)[t] for g in "ifgo"])
        np.testing.assert_array_equal(pieces[t]["lstm.bias_hh"].numpy(),
                                      want)
    # every leaf the original splits, and no other, is split here
    owner, partner = pieces
    jsplit = sum(1 for leaf in jax.tree.leaves(sharded)
                 if not leaf.sharding.is_fully_replicated)
    n_flax = {"torso.torso_out.weight": 1, "torso.torso_out.bias": 1,
              "lstm.weight_ih": 4, "lstm.weight_hh": 4, "lstm.bias_hh": 4}
    assert sum(n_flax[k] for k in partner) == jsplit
    for k, v in from_flax(jax.tree.map(np.asarray, params)).items():
        if k not in partner:
            assert torch.equal(owner[k], v), k


def test_budget_per_card_and_the_card_that_does_not_fit():
    """utils/hbm.py prices every card of a mesh over cards: the owners
    their shards (one copy each) and the replicated params with their
    pieces, the partners only their pieces; NCCL's part on the owners;
    a card over its memory raises, named."""
    from ape_x_dqn_tpu_torch.configs import get_config
    from ape_x_dqn_tpu_torch.utils.hbm import (NCCL_DEVICE_BYTES,
                                               check_mesh_fits, mesh_budgets,
                                               run_budget)

    cfg = get_config("r2d2")
    net = build_network(cfg.network,
                        EnvSpec((84, 84, 4), np.dtype(np.uint8), True, 18))
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    whole = sum(int(np.prod(s)) for s in shapes.values())
    split = sum(int(np.prod(s)) for k, s in shapes.items()
                if torch_split(k, s, 2))
    mesh = make_mesh(dp=4, tp=2, devices=CPUS * 2)
    got = mesh_budgets(cfg, (84, 84, 4), np.uint8, shapes, mesh)
    one = run_budget(cfg, (84, 84, 4), np.uint8, whole)
    owner, partner = got[_dev("cpu:0")], got[_dev("cpu:1")]
    assert owner.replay_storage == 2 * one.replay_storage
    assert partner.replay_storage == 0 and partner.replay_tree == 0
    assert owner.model_state == 16 * (whole - split // 2)
    assert partner.model_state == 16 * (split // 2)
    assert got[_dev("cpu:2")] == owner and got[_dev("cpu:3")] == partner
    # the exchange's NCCL lives on the owners of a card mesh only
    assert owner.nccl == partner.nccl == 0
    with pytest.raises(ValueError, match=r"on card cpu:0 of the mesh"):
        check_mesh_fits(cfg, (84, 84, 4), np.uint8, shapes, mesh,
                        hbm_bytes=owner.total - 1)
    assert check_mesh_fits(cfg, (84, 84, 4), np.uint8, shapes, mesh,
                           hbm_bytes=owner.total) == got
    assert NCCL_DEVICE_BYTES > 0
