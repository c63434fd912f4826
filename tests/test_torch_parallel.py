"""The port's dp-sharded learner (ape_x_dqn_tpu_torch/parallel/) against
the JAX package's tests/test_parallel.py, on the port's mesh of one
device repeated (["cpu"] * n; the original's eight emulated CPU devices
on the JAX side): the mesh, the parameter specs, the stacked shard
state, the dist learner's step, K-batch and prefetch paths, per-shard
write-back, the mesh-sharded inference servers and the skewed-shard IS
weights. Then parity: the same params (models/convert.py), the same
replay contents and the noise rebuilt from the original's [dp] key chain
through one JAX and one port train_step and train_step_k at dp=4.

Tolerances: the sampled indices exact; sum-trees and IS weights 1e-6;
float32 MLP params 1e-5 and the loss 1e-5 relative; the Nature CNN and
the LSTM in bfloat16 at 3e-2 absolute (the band of
tests/test_torch_models.py and tests/test_torch_r2d2_models.py: bf16
rounds each layer in different places in the two frameworks)."""

import threading

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
from ape_x_dqn_tpu.parallel.sharding import \
    make_param_shardings as jax_param_shardings
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
from ape_x_dqn_tpu_torch.parallel.dist_learner import (DistDQNLearner,
                                                       DistSequenceLearner)
from ape_x_dqn_tpu_torch.parallel.mesh import make_mesh
from ape_x_dqn_tpu_torch.parallel.sharding import make_param_shardings
from ape_x_dqn_tpu_torch.replay.prioritized import (PrioritizedReplay,
                                                    ShardedReplayState)
from ape_x_dqn_tpu_torch.replay.packing import ItemSpec
from ape_x_dqn_tpu_torch.replay.sequence import sequence_item_spec
from ape_x_dqn_tpu_torch.runtime.learner import transition_item_spec
from ape_x_dqn_tpu_torch.utils.rng import component_generator

VEC = EnvSpec(obs_shape=(4,), obs_dtype=np.dtype(np.float32),
              discrete=True, num_actions=2)
MLP = dict(kind="mlp", mlp_hidden=(256,), dueling=False,
           compute_dtype="float32")


def _mesh(dp, tp):
    return make_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp))


def _make_dist(dp=4, tp=2, batch=32, **lkw):
    mesh = _mesh(dp, tp)
    torch.manual_seed(0)
    net = build_network(NetworkConfig(**MLP), VEC)
    lcfg = LearnerConfig(batch_size=batch, target_sync_every=10, **lkw)
    replay = PrioritizedReplay(capacity=64, alpha=0.6, beta=0.4,
                               device="cpu")
    learner = DistDQNLearner(replay, lcfg, mesh)
    state = learner.init(net, transition_item_spec((4,), np.float32),
                         component_generator(1, "learner"))
    return mesh, learner, state


def _ingest(learner, state, dp, n_per_shard, seed=0):
    rng = np.random.default_rng(seed)
    items = {
        "obs": rng.normal(size=(dp, n_per_shard, 4)).astype(np.float32),
        "action": rng.integers(0, 2, (dp, n_per_shard)).astype(np.int32),
        "reward": rng.normal(size=(dp, n_per_shard)).astype(np.float32),
        "next_obs": rng.normal(size=(dp, n_per_shard, 4)).astype(
            np.float32),
        "discount": np.full((dp, n_per_shard), 0.99, np.float32),
    }
    return learner.add(state, {k: torch.from_numpy(v)
                               for k, v in items.items()},
                       torch.ones((dp, n_per_shard)))


def test_mesh_construction():
    mesh = _mesh(4, 2)
    assert mesh.shape == {"dp": 4, "tp": 2} and mesh.size == 8
    assert mesh.shards_on("cpu") == 4
    with pytest.raises(AssertionError, match=r"dp\(3\) \* tp\(3\) > "
                                             r"device count \(8\)"):
        make_mesh(dp=3, tp=3, devices=["cpu"] * 8)
    # distinct devices build a mesh of card groups (parallel/cards.py;
    # tests/test_torch_mesh_cards.py), one device repeated stays one
    cards = make_mesh(dp=2, tp=1, devices=["cpu:0", "cpu:1"])
    assert cards.distinct and [g.rows for g in cards.groups] == [(0,), (1,)]
    assert not mesh.distinct and len(mesh.groups) == 1
    # devices of two types still raise
    with pytest.raises(ValueError, match="one type"):
        make_mesh(dp=2, tp=1, devices=["cpu", "cuda:0"])
    if not torch.cuda.is_available():
        # the default device list is the visible cards: none here
        with pytest.raises(AssertionError, match=r"device count \(0\)"):
            make_mesh(dp=1, tp=1)


def _jax_specs(net_cfg, obs, dtype, seq=False):
    jnet = jax_build_network(JNetworkConfig(**net_cfg),
                             JEnvSpec(obs, np.dtype(dtype), True, 6))
    x = jnp.zeros((1, 1, *obs) if seq else (1, *obs), dtype)
    if seq:
        z = jnp.zeros((1, net_cfg["lstm_size"]), jnp.float32)
        params = jnet.init(jax.random.key(0), x, (z, z))
    else:
        params = jnet.init(jax.random.key(0), x)
    sh = jax_param_shardings(params, jax_make_mesh(dp=4, tp=2))
    flat = jax.tree_util.tree_flatten_with_path(sh)[0]
    return {"/".join(str(k.key) for k in path[1:]): tuple(s.spec)
            for path, s in flat}


@pytest.mark.parametrize("net_cfg,obs,dtype,seq", [
    (MLP, (4,), np.float32, False),
    (dict(kind="nature_cnn", dueling=True), (84, 84, 4), np.uint8, False),
    (dict(kind="lstm_q", lstm_size=512, dueling=True), (84, 84, 4),
     np.uint8, True),
], ids=["mlp", "nature_cnn", "lstm_q"])
def test_param_shardings_tp(net_cfg, obs, dtype, seq):
    """Every parameter's spec at tp=2 is the original's, keyed by its
    flax path; the MLP's 4x256 hidden kernel is column-split."""
    tnet = build_network(NetworkConfig(**net_cfg),
                         EnvSpec(obs, np.dtype(dtype), True, 6))
    got = make_param_shardings(tnet, _mesh(4, 2))
    assert got == _jax_specs(net_cfg, obs, dtype, seq)
    assert any(s == (None, "tp") for s in got.values())


def test_dist_replay_state_sharded():
    dp = 4
    _, learner, state = _make_dist(dp=dp, tp=2)
    rs = state.replay
    assert isinstance(rs, ShardedReplayState)
    assert rs.tree.shape == (dp, 2 * 64)
    # storage leaves carry the leading dp axis; the cursor one per shard
    assert rs.storage["obs"].shape == (dp, 64, 4)
    assert rs.pos_dev.shape == rs.size_dev.shape == (dp,)
    assert rs.pos.tolist() == rs.size.tolist() == [0] * dp


def test_dist_train_step_runs_and_syncs():
    dp = 4
    _, learner, state = _make_dist(dp=dp, tp=2, batch=32)
    state = _ingest(learner, state, dp, 16)
    assert int(state.replay.size.sum()) == dp * 16
    # lockstep: every shard's host and device cursor alike
    assert state.replay.pos.tolist() == [16] * dp
    assert state.replay.size_dev.tolist() == [16] * dp
    p0 = next(state.net.parameters()).detach().clone()
    for _ in range(3):
        state, m = learner.train_step(state)
    assert np.isfinite(m["loss"].item())
    assert state.step == 3 and int(state.opt_state.count) == 3
    assert not torch.allclose(p0, next(state.net.parameters()))
    for _ in range(7):
        state, m = learner.train_step(state)
    # target sync at step 10
    for t, p in zip(state.target_net.parameters(), state.net.parameters()):
        torch.testing.assert_close(t, p, rtol=0, atol=0)


def test_dist_matches_priorities_locally():
    """Priority write-back stays shard-local: sampled indices from shard
    d update shard d's tree only, and each shard draws its own."""
    dp = 2
    _, learner, state = _make_dist(dp=dp, tp=1, batch=8)
    state = _ingest(learner, state, dp, 8)
    before = state.replay.tree.clone()
    state, _ = learner.train_step(state)
    after = state.replay.tree
    assert not torch.allclose(before[0], after[0])
    assert not torch.allclose(before[1], after[1])


def test_train_many_scan():
    dp = 4
    _, learner, state = _make_dist(dp=dp, tp=2, batch=32)
    state = _ingest(learner, state, dp, 16)
    state, m = learner.train_many(state, 5)
    assert state.step == 5 and np.isfinite(m["loss"].item())


def test_publish_params_replicated():
    """An independent copy of the whole params on the mesh's device (the
    train endpoints write the learner's in place)."""
    mesh, learner, state = _make_dist(dp=4, tp=2)
    pub = learner.publish_params(state)
    for k, v in state.net.state_dict().items():
        assert pub[k].device == mesh.device
        assert torch.equal(pub[k], v)
        assert pub[k].data_ptr() != v.data_ptr()


def test_sharded_inference_server():
    """Mesh mode: buckets are powers of two rounded up to a multiple of
    the mesh size (every shard gets identical work), replies identical
    to the unsharded forward."""
    from ape_x_dqn_tpu_torch.parallel.inference_server import \
        BatchedInferenceServer

    mesh = _mesh(4, 2)
    params = torch.arange(16, dtype=torch.float32).reshape(4, 4)

    def apply_fn(p, obs):
        return obs @ p

    server = BatchedInferenceServer(apply_fn, params, max_batch=16,
                                    deadline_ms=5.0, mesh=mesh,
                                    device="cpu")
    try:
        assert server._bucket(1) == 8  # rounded up to mesh.size
        assert server._bucket(9) == 16
        results = {}

        def client(i):
            obs = np.full(4, float(i), np.float32)
            results[i] = server.query(obs)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(11)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(11):
            expect = np.full(4, float(i), np.float32) @ params.numpy()
            np.testing.assert_allclose(results[i], expect, rtol=1e-6)
        assert server.stats["items"] == 11
    finally:
        server.stop()


def test_sharded_inference_server_pytree_requests():
    """Recurrent-style request trees under the mesh (the port's
    recurrent actors send {obs, c, h} and get {q, c, h})."""
    from ape_x_dqn_tpu_torch.parallel.inference_server import \
        BatchedInferenceServer

    def apply_fn(p, inputs):
        return {"q": inputs["obs"] @ p, "c": inputs["c"] + 1.0,
                "h": inputs["h"] * 2.0}

    server = BatchedInferenceServer(apply_fn, torch.eye(4), max_batch=8,
                                    deadline_ms=5.0, mesh=_mesh(4, 2),
                                    device="cpu")
    try:
        obs = np.arange(4, dtype=np.float32)
        out = server.query({"obs": obs, "c": np.zeros(3, np.float32),
                            "h": np.ones(3, np.float32)})
        np.testing.assert_allclose(out["q"], obs, rtol=1e-6)
        np.testing.assert_allclose(out["c"], np.ones(3), rtol=1e-6)
        np.testing.assert_allclose(out["h"], np.full(3, 2.0), rtol=1e-6)
    finally:
        server.stop()


def _stack(replay, states) -> ShardedReplayState:
    """Single-shard states -> one stacked state (cursors per shard)."""
    out = ShardedReplayState(
        {k: torch.stack([s.storage[k] for s in states])
         for k in states[0].storage},
        torch.stack([s.tree for s in states]))
    out.pos = [s.pos for s in states]
    out.size = [s.size for s in states]
    return out


def test_skewed_shard_is_weights():
    """The dist IS weights under deliberately unbalanced shard priority
    masses (one shard starved 1000x). P(i) = probs/dp is the actual
    stratified sampling probability: at beta=1 the weighted estimate of
    a per-item value is the exact uniform mean, while the single global
    tree's p_i/M is biased for this sampler; the per-item ratio of the
    two is exactly (dp*m_d/M)^beta. The port's `_sample_weighted` gives
    the formula's weights on the JAX package's draws."""
    dp, cap, b_local = 4, 64, 32
    spec = {"g": ItemSpec((), torch.float32)}
    replay = PrioritizedReplay(capacity=cap, alpha=1.0, beta=1.0, eps=0.0,
                               device="cpu", item_spec=spec)
    jreplay = JaxPER(capacity=cap, alpha=1.0, beta=1.0, eps=0.0)
    masses = np.array([1e-3, 1.0, 1.0, 2.0], np.float64)
    states, jstates = [], []
    for d in range(dp):
        vals = np.full(cap, d + 1.0, np.float32)
        pri = np.full(cap, masses[d] / cap, np.float32)
        states.append(replay.add(replay.init(), {"g": torch.from_numpy(vals)},
                                 torch.from_numpy(pri)))
        jstates.append(jreplay.add(
            jreplay.init({"g": jax.ShapeDtypeStruct((), jnp.float32)}),
            {"g": jnp.asarray(vals)}, jnp.asarray(pri)))
    state = _stack(replay, states)
    jstate = jax.tree.map(lambda *xs: jnp.stack(xs), *jstates)

    keys = jax.random.split(jax.random.key(0), dp)
    jitems, jidx, jprobs = jax.vmap(
        lambda rs, k: jreplay.sample_items(rs, k, b_local))(jstate, keys)
    noise = torch.from_numpy(np.stack(
        [np.asarray(jax.random.uniform(k, (b_local,))) for k in keys]))
    items, idx, probs = replay.sample_items(state, b_local, noise)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs),
                               rtol=1e-6)
    g = items["g"].double().numpy()          # [dp, b]
    probs = probs.double().numpy()           # [dp, b] = p_i / m_d

    n_global = float(dp * cap)
    learner = DistDQNLearner(replay, LearnerConfig(batch_size=dp * b_local),
                             _mesh(dp, 1))
    _, _, w = learner._sample_weighted(state, noise, b_local)
    np.testing.assert_allclose(w.double().numpy(),
                               (n_global * probs / dp) ** -1.0, rtol=1e-6)

    # (1) beta=1 unbiasedness under skew
    w_dist = (n_global * probs / dp) ** -1.0
    uniform_mean = float(np.mean([d + 1.0 for d in range(dp)]))
    assert abs(float((w_dist * g).mean()) - uniform_mean) < 1e-3
    # ... while global-mass weights bias the starved shard ~250x
    m = masses.astype(np.float32)
    big_m = float(m.sum())
    w_oracle = (n_global * probs * (m[:, None] / big_m)) ** -1.0
    assert abs(float((w_oracle * g).mean()) - uniform_mean) > 10.0

    # (2) the exact analytic deviation at beta=0.4
    beta = 0.4
    wd = (n_global * probs / dp) ** -beta
    wo = (n_global * probs * (m[:, None] / big_m)) ** -beta
    np.testing.assert_allclose(wd / wo, np.broadcast_to(
        ((dp * m / big_m) ** beta)[:, None], wd.shape), rtol=1e-4)


def test_global_stats_packed_reduction():
    """global_stats packs (all_ready, all_idle, exact frame sum) into one
    reduction; the int64 frame lanes stay exact far past f32's 2^24."""
    from ape_x_dqn_tpu_torch.parallel import multihost

    frames = 123_456_789_012
    ready, idle, total = multihost.global_stats(1.0, 0.0, float(frames))
    assert ready is True and idle is False
    assert total == float(frames)


def test_dist_kbatch_train_step_k():
    """K-batch relaxation on the mesh: one per-shard stratified
    K*b_local sample + one per-shard write-back per K grad-steps, the
    remainder path, and run-twice determinism."""
    def build():
        _, lrn, st = _make_dist(dp=4, tp=2, batch=32, sample_chunk=4)
        lrn.lcfg = LearnerConfig(batch_size=32, target_sync_every=3,
                                 sample_chunk=4)
        return lrn, _ingest(lrn, st, 4, 48)

    learner, state = build()
    root_before = state.replay.tree[:, 1].clone()
    state, m = learner.train_step_k(state, 4)
    assert state.step == 4 and np.isfinite(m["loss"].item())
    assert (state.replay.tree[:, 1] != root_before).all()
    # train_many: 10 = 2 remainder singles + 2 macro-steps of 4
    state, m = learner.train_many(state, 10)
    assert state.step == 14 and np.isfinite(m["loss"].item())

    def run_once():
        lrn, st = build()
        st, _ = lrn.train_step_k(st, 4)
        return [p.detach().clone() for p in st.net.parameters()]

    for a, b in zip(run_once(), run_once()):
        assert torch.equal(a, b)


def test_dist_prefetch_train_many():
    """Double-buffered sampling on the mesh: step counts, per-shard tree
    repair, the remainder path, first-macro equivalence with the fused
    train_step_k (params AND shard trees), determinism."""
    def build(prefetch=True):
        _, lrn, st = _make_dist(dp=4, tp=2, batch=32)
        lrn.lcfg = LearnerConfig(batch_size=32, target_sync_every=3,
                                 sample_chunk=4, sample_prefetch=prefetch)
        return lrn, _ingest(lrn, st, 4, 48)

    learner, state = build()
    root_before = state.replay.tree[:, 1].clone()
    state, m = learner.train_many(state, 10)
    assert state.step == 10 and np.isfinite(m["loss"].item())
    assert (state.replay.tree[:, 1] != root_before).all()

    l1, s1 = build(True)
    l2, s2 = build(False)
    s1, _ = l1.train_many(s1, 4)
    s2, _ = l2.train_step_k(s2, 4)
    for a, b in zip(s1.net.parameters(), s2.net.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(s1.replay.tree, s2.replay.tree)

    def run_once():
        lrn, st = build()
        st, _ = lrn.train_many(st, 12)
        return [p.detach().clone() for p in st.net.parameters()]

    for a, b in zip(run_once(), run_once()):
        assert torch.equal(a, b)


# -- parity with the JAX package's dist learners at dp=4 ----------------------

DP, TP = 4, 2


def _noise(jstate, n) -> torch.Tensor:
    """The [dp, n] noise the JAX learner draws next: per shard d, the
    second half of split(rng[d]) (`_split_rng`), then uniform."""
    keys = jax.vmap(lambda k: jax.random.split(k, 2))(jstate.rng)
    return torch.from_numpy(np.stack(
        [np.asarray(jax.random.uniform(keys[d, 1], (n,)))
         for d in range(DP)]))


def _compare(js, jm, ts, tm, atol, loss_rtol):
    assert ts.step == int(js.step)
    for name, got, want in (("params", ts.net, js.params),
                            ("target", ts.target_net, js.target_params)):
        want = from_flax(jax.tree.map(np.asarray, want))
        for k, v in got.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                       atol=atol, err_msg=f"{name}.{k}")
    assert ts.replay.pos.tolist() == np.asarray(js.replay.pos).tolist()
    assert ts.replay.size.tolist() == np.asarray(js.replay.size).tolist()
    for k in ("loss", "q_mean", "td_abs_mean"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                   rtol=loss_rtol, atol=atol, err_msg=k)
    assert set(tm["diag"]) == set(jm["diag"])


def _check_draw(jl, js, tl, ts, n):
    """The sampling half alone: the same indices, IS weights within
    1e-6, on the trees both hold."""
    np.testing.assert_allclose(ts.replay.tree.numpy(),
                               np.asarray(js.replay.tree), rtol=1e-6,
                               atol=1e-6)
    noise = _noise(js, n)
    keys = jax.vmap(lambda k: jax.random.split(k, 2))(js.rng)[:, 1]
    _, jidx, jw = jl._sample_weighted(js.replay, keys, n)
    _, idx, w = tl._sample_weighted(ts.replay, noise, n)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)


def _flat_pair():
    lcfg = dict(batch_size=32, sample_chunk=4, target_sync_every=2,
                lr=1e-3)
    jnet = jax_build_network(JNetworkConfig(**MLP),
                             JEnvSpec((4,), np.dtype(np.float32), True, 2))
    params = jnet.init(jax.random.key(0), jnp.zeros((1, 4)))
    jl = jdist.DistDQNLearner(jnet.apply, JaxPER(capacity=64),
                              JLearnerConfig(**lcfg),
                              jax_make_mesh(dp=DP, tp=TP))
    js = jl.init(params, jax_item_spec((4,), jnp.float32),
                 jax.random.key(1))
    tnet = build_network(NetworkConfig(**MLP), VEC)
    tnet.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    tl = DistDQNLearner(PrioritizedReplay(capacity=64, device="cpu"),
                        LearnerConfig(**lcfg), _mesh(DP, TP))
    ts = tl.init(tnet, transition_item_spec((4,), np.float32),
                 component_generator(0, "learner"))
    rng = np.random.default_rng(3)
    n = 40                                # skip-to-head never triggers
    items = {
        "obs": rng.normal(size=(DP, n, 4)).astype(np.float32),
        "action": rng.integers(0, 2, (DP, n)).astype(np.int32),
        "reward": rng.normal(size=(DP, n)).astype(np.float32),
        "next_obs": rng.normal(size=(DP, n, 4)).astype(np.float32),
        "discount": np.full((DP, n), 0.99, np.float32),
    }
    td = rng.uniform(0.1, 2.0, (DP, n)).astype(np.float32)
    td[1] *= 1e-2                        # a lighter shard
    js = jl.add(js, {k: jnp.asarray(v) for k, v in items.items()},
                jnp.asarray(td))
    tl.add(ts, {k: torch.from_numpy(v) for k, v in items.items()},
           torch.from_numpy(td))
    return jl, js, tl, ts, lcfg["batch_size"] // DP


def _sequence_pair():
    seq, lstm, obs = 6, 8, (36, 36, 4)
    net = dict(kind="lstm_q", lstm_size=lstm, cnn_channels=(4, 8, 8),
               torso_dense=16, dueling=True, compute_dtype="bfloat16")
    lcfg = dict(batch_size=16, n_step=2, value_rescale=True,
                target_sync_every=3, lr=1e-3, sample_chunk=4)
    rcfg = dict(kind="sequence", seq_length=seq, burn_in=2)
    jnet = jax_build_network(JNetworkConfig(**net),
                             JEnvSpec(obs, np.dtype(np.uint8), True, 3))
    z = jnp.zeros((1, lstm), jnp.float32)
    params = jnet.init(jax.random.key(0),
                       jnp.zeros((1, 1, *obs), jnp.uint8), (z, z))
    jl = jdist.DistSequenceLearner(
        lambda p, o, s: jnet.apply(p, o, s), JaxPER(capacity=32),
        JLearnerConfig(**lcfg), JReplayConfig(**rcfg),
        jax_make_mesh(dp=DP, tp=TP))
    js = jl.init(params, jax_seq_spec(obs, np.uint8, seq, lstm,
                                      frame_mode=True), jax.random.key(1))
    tnet = build_network(NetworkConfig(**net),
                         EnvSpec(obs, np.dtype(np.uint8), True, 3))
    tnet.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    tl = DistSequenceLearner(PrioritizedReplay(capacity=32, device="cpu"),
                             LearnerConfig(**lcfg), ReplayConfig(**rcfg),
                             _mesh(DP, TP))
    ts = tl.init(tnet, sequence_item_spec(obs, np.uint8, seq, lstm,
                                          frame_mode=True),
                 component_generator(0, "learner"))
    rng = np.random.default_rng(4)
    n = 24
    mask = np.ones((DP, n, seq), np.float32)
    mask[:, ::5, seq - 2:] = 0.0
    items = {
        "seq_frames": rng.integers(0, 255, (DP, n, seq + 3, 36, 36)
                                   ).astype(np.uint8),
        "actions": rng.integers(0, 3, (DP, n, seq)).astype(np.int32),
        "rewards": rng.normal(size=(DP, n, seq)).astype(np.float32),
        "terminals": np.zeros((DP, n, seq), np.float32),
        "mask": mask,
        "init_c": (0.3 * rng.normal(size=(DP, n, lstm))).astype(np.float32),
        "init_h": (0.3 * rng.normal(size=(DP, n, lstm))).astype(np.float32),
    }
    td = rng.uniform(0.1, 2.0, (DP, n)).astype(np.float32)
    js = jl.add(js, {k: jnp.asarray(v) for k, v in items.items()},
                jnp.asarray(td))
    tl.add(ts, {k: torch.from_numpy(v) for k, v in items.items()},
           torch.from_numpy(td))
    return jl, js, tl, ts, lcfg["batch_size"] // DP


@pytest.mark.parametrize("pair,atol,loss_rtol", [
    (_flat_pair, 1e-5, 1e-5), (_sequence_pair, 3e-2, 3e-2)],
    ids=["mlp_f32", "lstm_bf16"])
def test_dist_learner_matches_jax(pair, atol, loss_rtol):
    """One train_step, then one K=4 train_step_k, on the same params,
    replay contents and draws, at dp=4 x tp=2."""
    jl, js, tl, ts, b_local = pair()
    _check_draw(jl, js, tl, ts, b_local)
    noise = _noise(js, b_local)
    js, jm = jl.train_step(js)
    ts, tm = tl.train_step(ts, noise)
    _compare(js, jm, ts, tm, atol, loss_rtol)
    if atol < 1e-4:                      # float32: the write-back too
        np.testing.assert_allclose(ts.replay.tree.numpy(),
                                   np.asarray(js.replay.tree), rtol=1e-5,
                                   atol=1e-6)
    else:
        # bf16: put the JAX write-back into the port, so the K-batch
        # draw below sees the same trees
        ts.replay.tree.copy_(torch.from_numpy(np.array(js.replay.tree)))
    _check_draw(jl, js, tl, ts, 4 * b_local)
    noise = _noise(js, 4 * b_local)
    js, jm = jl.train_step_k(js, 4)
    ts, tm = tl.train_step_k(ts, 4, noise)
    _compare(js, jm, ts, tm, atol, loss_rtol)
    for k in ("shard_td_mean_min", "shard_td_mean_max"):
        np.testing.assert_allclose(tm["diag"][k].item(),
                                   float(jm["diag"][k]), rtol=loss_rtol,
                                   atol=atol, err_msg=k)
