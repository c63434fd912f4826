"""The dp-sharded learner over distinct devices in one process
(parallel/cards.py), on the CPU over ``cpu:0 .. cpu:3``: one card group
per owner, each with its rows' shards stacked on it, the in-process
exchange among the groups, and the tp column split across a row's
devices. At dp=4 x tp=1 (four groups), dp=2 x tp=2 (two groups, each
split over two devices) and ``[cpu:0 .. cpu:3] * 2`` at dp=4 x tp=2 (two
groups of two rows, each split), one K=4 macro-step with the target
synced twice inside it (target_sync_every=2), held:

- against the JAX package's `DistDQNLearner` / `DistSequenceLearner`
  on its emulated devices at the same dp x tp (GSPMD splits the same
  layers), with the noise rebuilt from the original's [dp] key chain
  (tests/test_torch_parallel.py: `_noise`), on the same params and
  replay contents: the sampled indices exactly, params, target params,
  sum-trees and the loss terms at the tolerances of
  tests/test_torch_parallel.py (float32 1e-5; bfloat16 3e-2);
- against the port's stacked learner (every shard on one device, the
  layers whole) on the same noise, within tighter tolerances: float32
  2e-6, bfloat16 1e-2 (the groups' gradients are formed per group and
  summed, which rounds in bf16 differently from one batch, and Adam
  turns a rounding-level gradient into a visible update; a split layer
  computes the same products in two matmuls).

The MLP's 4 x 256 hidden layer splits at tp=2 on both sides, as the
presets' 512-wide layers do; the R2D2 net (the LSTM over vector
observations: a 128-wide dense torso and 32 units) splits its torso and
its four gates with their biases at min_dim=16 in the port, which the
original at its fixed min_dim=256 computes whole (a column split
changes no number). The R2D2 cases of the dp4xtp1 and [cpu:0 ..
cpu:3] * 2 layouts are in tests/test_torch_dist_cards_r2d2.py (the JAX
side's compiles take most of the time)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.configs import LearnerConfig as JLearnerConfig
from ape_x_dqn_tpu.configs import NetworkConfig as JNetworkConfig
from ape_x_dqn_tpu.configs import ReplayConfig as JReplayConfig
from ape_x_dqn_tpu.envs.base import EnvSpec as JEnvSpec
from ape_x_dqn_tpu.models import build_network as jax_build_network
from ape_x_dqn_tpu.parallel import dist_learner as jdist
from ape_x_dqn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ape_x_dqn_tpu.replay.prioritized import PrioritizedReplay as JaxPER
from ape_x_dqn_tpu.replay.sequence import \
    sequence_item_spec as jax_seq_spec
from ape_x_dqn_tpu.runtime.learner import \
    transition_item_spec as jax_item_spec
from ape_x_dqn_tpu_torch.configs import (LearnerConfig, NetworkConfig,
                                         ReplayConfig)
from ape_x_dqn_tpu_torch.envs.base import EnvSpec
from ape_x_dqn_tpu_torch.models import build_network
from ape_x_dqn_tpu_torch.models.convert import from_flax
from ape_x_dqn_tpu_torch.parallel.cards import CardsLearner, group_learner
from ape_x_dqn_tpu_torch.parallel.dist_learner import (DistDQNLearner,
                                                       DistSequenceLearner)
from ape_x_dqn_tpu_torch.parallel.mesh import make_mesh
from ape_x_dqn_tpu_torch.replay.prioritized import PrioritizedReplay
from ape_x_dqn_tpu_torch.replay.sequence import sequence_item_spec
from ape_x_dqn_tpu_torch.runtime.learner import (checkpoint_tree,
                                                 transition_item_spec)
from ape_x_dqn_tpu_torch.utils.rng import component_generator

CPUS = [f"cpu:{i}" for i in range(4)]
LAYOUTS = {"dp4xtp1": (4, 1, CPUS), "dp2xtp2": (2, 2, CPUS),
           "cpus_x2_dp4xtp2": (4, 2, CPUS * 2)}
MLP = dict(kind="mlp", mlp_hidden=(256,), dueling=False,
           compute_dtype="float32")
SEQ_NET = dict(kind="lstm_q", lstm_size=32, mlp_hidden=(64,),
               dueling=True, compute_dtype="bfloat16")


def _noise(jstate, n, dp) -> torch.Tensor:
    """The [dp, n] noise the JAX learner draws next (per shard d, the
    second half of split(rng[d]), then uniform)."""
    keys = jax.vmap(lambda k: jax.random.split(k, 2))(jstate.rng)
    return torch.from_numpy(np.stack(
        [np.asarray(jax.random.uniform(keys[d, 1], (n,)))
         for d in range(dp)]))


def _flat(dp, tp, devices):
    lcfg = dict(batch_size=32, sample_chunk=4, target_sync_every=2,
                lr=1e-3)
    jnet = jax_build_network(JNetworkConfig(**MLP),
                             JEnvSpec((4,), np.dtype(np.float32), True, 2))
    params = jnet.init(jax.random.key(0), jnp.zeros((1, 4)))
    jl = jdist.DistDQNLearner(jnet.apply, JaxPER(capacity=64),
                              JLearnerConfig(**lcfg),
                              jax_make_mesh(dp=dp, tp=tp))
    js = jl.init(params, jax_item_spec((4,), jnp.float32),
                 jax.random.key(1))
    net = build_network(NetworkConfig(**MLP), EnvSpec(
        (4,), np.dtype(np.float32), True, 2))
    net.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))

    def port(mesh_devices):
        mesh = make_mesh(dp=dp, tp=tp, devices=mesh_devices)
        if mesh.distinct:
            lrn = CardsLearner(
                group_learner(DistDQNLearner, LearnerConfig(**lcfg)),
                lambda d: PrioritizedReplay(capacity=64, device=d),
                LearnerConfig(**lcfg), mesh)
        else:
            lrn = DistDQNLearner(PrioritizedReplay(capacity=64,
                                                   device="cpu"),
                                 LearnerConfig(**lcfg), mesh)
        st = lrn.init(copy.deepcopy(net), transition_item_spec(
            (4,), np.float32), component_generator(0, "learner"))
        return lrn, st

    rng = np.random.default_rng(3)
    n = 40                                # skip-to-head never triggers
    items = {
        "obs": rng.normal(size=(dp, n, 4)).astype(np.float32),
        "action": rng.integers(0, 2, (dp, n)).astype(np.int32),
        "reward": rng.normal(size=(dp, n)).astype(np.float32),
        "next_obs": rng.normal(size=(dp, n, 4)).astype(np.float32),
        "discount": np.full((dp, n), 0.99, np.float32),
    }
    td = rng.uniform(0.1, 2.0, (dp, n)).astype(np.float32)
    td[1] *= 1e-2                        # a lighter shard
    return jl, js, port, items, td, lcfg["batch_size"] // dp


def _sequence(dp, tp, devices):
    """R2D2 over vector observations (the LSTM net's dense torso), so
    the torso, the four gates and their biases split at min_dim=16."""
    seq, lstm, obs = 6, SEQ_NET["lstm_size"], (8,)
    lcfg = dict(batch_size=16, n_step=2, value_rescale=True,
                target_sync_every=2, lr=1e-3, sample_chunk=4)
    rcfg = dict(kind="sequence", seq_length=seq, burn_in=2)
    jnet = jax_build_network(JNetworkConfig(**SEQ_NET),
                             JEnvSpec(obs, np.dtype(np.float32), True, 3))
    z = jnp.zeros((1, lstm), jnp.float32)
    params = jnet.init(jax.random.key(0),
                       jnp.zeros((1, 1, *obs), jnp.float32), (z, z))
    jl = jdist.DistSequenceLearner(
        lambda p, o, s: jnet.apply(p, o, s), JaxPER(capacity=32),
        JLearnerConfig(**lcfg), JReplayConfig(**rcfg),
        jax_make_mesh(dp=dp, tp=tp))
    js = jl.init(params, jax_seq_spec(obs, np.float32, seq, lstm),
                 jax.random.key(1))
    net = build_network(NetworkConfig(**SEQ_NET),
                        EnvSpec(obs, np.dtype(np.float32), True, 3))
    net.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    spec = sequence_item_spec(obs, np.float32, seq, lstm)

    def port(mesh_devices):
        mesh = make_mesh(dp=dp, tp=tp, devices=mesh_devices)
        lc, rc = LearnerConfig(**lcfg), ReplayConfig(**rcfg)
        if mesh.distinct:
            lrn = CardsLearner(
                group_learner(DistSequenceLearner, lc, rc),
                lambda d: PrioritizedReplay(capacity=32, device=d),
                lc, mesh, min_dim=16)
        else:
            lrn = DistSequenceLearner(PrioritizedReplay(
                capacity=32, device="cpu"), lc, rc, mesh)
        st = lrn.init(copy.deepcopy(net), spec,
                      component_generator(0, "learner"))
        return lrn, st

    rng = np.random.default_rng(4)
    n = 24
    mask = np.ones((dp, n, seq), np.float32)
    mask[:, ::5, seq - 2:] = 0.0
    items = {
        "obs": rng.normal(size=(dp, n, seq, *obs)).astype(np.float32),
        "actions": rng.integers(0, 3, (dp, n, seq)).astype(np.int32),
        "rewards": rng.normal(size=(dp, n, seq)).astype(np.float32),
        "terminals": np.zeros((dp, n, seq), np.float32),
        "mask": mask,
        "init_c": (0.3 * rng.normal(size=(dp, n, lstm))).astype(np.float32),
        "init_h": (0.3 * rng.normal(size=(dp, n, lstm))).astype(np.float32),
    }
    td = rng.uniform(0.1, 2.0, (dp, n)).astype(np.float32)
    return jl, js, port, items, td, lcfg["batch_size"] // dp


def _add(lrn, st, items, td):
    lrn.add(st, {k: torch.from_numpy(v) for k, v in items.items()},
            torch.from_numpy(td))


def _whole(state) -> dict:
    return checkpoint_tree(state, with_replay=True)


def _assert_trees(got, want, atol, what):
    for key in ("params", "target_params"):
        for k, v in got[key].items():
            np.testing.assert_allclose(
                v.numpy(), want[key][k], rtol=0, atol=atol,
                err_msg=f"{what}: {key}.{k}")


CASES = {"mlp_f32": (_flat, "f32", 1e-5, 2e-6),
         "lstm_bf16": (_sequence, "bf16", 3e-2, 1e-2)}


@pytest.mark.parametrize("case,layout", [
    ("mlp_f32", "dp4xtp1"), ("mlp_f32", "dp2xtp2"),
    ("mlp_f32", "cpus_x2_dp4xtp2"), ("lstm_bf16", "dp2xtp2")])
def test_card_groups_match_jax_and_the_stacked_learner(case, layout):
    check_layout(case, layout)


def check_layout(case, layout):
    """One K=4 macro-step of `case` on `layout` (module docstring)."""
    build, kind, jax_tol, stacked_tol = CASES[case]
    dp, tp, devices = LAYOUTS[layout]
    jl, js, port, items, td, b_local = build(dp, tp, devices)
    cl, cs = port(devices)
    sl, ss = port(["cpu"] * (dp * tp))
    assert isinstance(cl, CardsLearner) and len(cl.groups) == (
        4 if tp == 1 else 2)
    assert bool(cl.split_layers) == (tp > 1)
    js = jl.add(js, {k: jnp.asarray(v) for k, v in items.items()},
                jnp.asarray(td))
    _add(cl, cs, items, td)
    _add(sl, ss, items, td)
    # the sampling half alone: the same indices
    noise = _noise(js, 4 * b_local, dp)
    keys = jax.vmap(lambda k: jax.random.split(k, 2))(js.rng)[:, 1]
    _, jidx, _ = jl._sample_weighted(js.replay, keys, 4 * b_local)
    for g, lrn, st in zip(cl.groups, cl.learners, cs.groups):
        _, idx, _ = lrn._sample_weighted(st.replay, noise[list(g.rows)],
                                         4 * b_local)
        np.testing.assert_array_equal(idx.numpy(),
                                      np.asarray(jidx)[list(g.rows)])
    # one K=4 macro-step: two target syncs inside it
    js, jm = jl.train_step_k(js, 4)
    cs, cm = cl.train_step_k(cs, 4, noise)
    ss, sm = sl.train_step_k(ss, 4, noise)
    assert cs.step == ss.step == int(js.step) == 4
    got, stacked = _whole(cs), _whole(ss)
    jwant = {"params": from_flax(jax.tree.map(np.asarray, js.params)),
             "target_params": from_flax(jax.tree.map(np.asarray,
                                                     js.target_params))}
    jwant = {k: {n: v.numpy() for n, v in d.items()}
             for k, d in jwant.items()}
    _assert_trees(got, jwant, jax_tol, "vs jax")
    _assert_trees(got, {k: {n: v.numpy() for n, v in d.items()}
                        for k, d in ((k, stacked[k]) for k in
                                     ("params", "target_params"))},
                  stacked_tol, "vs stacked")
    # the target synced at count 2 and 4: equal to the params
    for k, v in got["params"].items():
        assert torch.equal(v, got["target_params"][k]), k
    assert got["replay"]["pos"] == np.asarray(js.replay.pos).tolist()
    assert got["replay"]["size"] == np.asarray(js.replay.size).tolist()
    tree = got["replay"]["tree"].numpy()
    if kind == "f32":
        np.testing.assert_allclose(tree, np.asarray(js.replay.tree),
                                   rtol=jax_tol, atol=jax_tol)
    np.testing.assert_allclose(tree, stacked["replay"]["tree"].numpy(),
                               rtol=stacked_tol, atol=stacked_tol)
    for k in ("loss", "q_mean", "td_abs_mean"):
        np.testing.assert_allclose(cm[k].item(), float(jm[k]),
                                   rtol=jax_tol, atol=jax_tol, err_msg=k)
        np.testing.assert_allclose(cm[k].item(), sm[k].item(),
                                   rtol=stacked_tol, atol=stacked_tol,
                                   err_msg=k)
    for k in ("shard_td_mean_min", "shard_td_mean_max"):
        np.testing.assert_allclose(cm["diag"][k].item(),
                                   float(jm["diag"][k]), rtol=jax_tol,
                                   atol=jax_tol, err_msg=k)
    assert set(cm["diag"]) == set(sm["diag"])
    # one exchange per SGD step, of the whole packed vector
    assert cl.exchange.calls == 4


def test_card_groups_train_many_and_the_prefetch_path():
    """train_many's remainder singles and macro-steps, and the
    double-buffered path, on the groups as on the stacked learner
    (float32 MLP, 2e-6), with the exchange called once per step."""
    dp, tp, devices = LAYOUTS["cpus_x2_dp4xtp2"]
    _, _, port, items, td, _ = _flat(dp, tp, devices)
    for prefetch in (False, True):
        cl, cs = port(devices)
        sl, ss = port(["cpu"] * (dp * tp))
        for lrn in (cl, sl):
            lrn.lcfg = LearnerConfig(batch_size=32, sample_chunk=4,
                                     target_sync_every=3,
                                     sample_prefetch=prefetch)
        cl.learners[0].lcfg = cl.learners[1].lcfg = cl.lcfg
        _add(cl, cs, items, td)
        _add(sl, ss, items, td)
        cs, _ = cl.train_many(cs, 10)
        ss, _ = sl.train_many(ss, 10)
        assert cs.step == ss.step == 10 and cl.exchange.calls == 10
        got, want = _whole(cs), _whole(ss)
        for k, v in got["params"].items():
            np.testing.assert_allclose(v.numpy(), want["params"][k].numpy(),
                                       rtol=0, atol=2e-6, err_msg=k)
