"""The dp-sharded frame-ring replay (replay/frame_ring.py on a
`ShardedReplayState`, parallel/dist_learner.py), the port's forms of
the JAX package's tests/test_dist_frame_ring.py:

- dp=1 bitwise parity: the stacked state at dp=1 (lockstep adds,
  stacked sampling and write-back) is the single-card FrameRingReplay
  bit for bit: sharding is a layout decision, never a numerics one;
- skewed shard fills and masses: the global-N IS weights recover the
  exact uniform mean over the global live pool, on the JAX package's
  draws, and equal the JAX learner's weights to 1e-6;
- dead pad slots train with weight 0;
- shard_stats and live_transitions per shard;
- the Nature CNN's DistDQNLearner over frame-ring shards against the
  JAX one at dp=4 x tp=2: one train_step and one K=4 train_step_k on
  the same params, contents and draws, in bfloat16 (3e-2 absolute, the
  band of tests/test_torch_models.py), the draws' indices exact and
  their IS weights within 1e-6.

The original's seventh test (test_multichip_baseline_comparable_shapes_
only) reads the root bench.py's multichip lane, which the port does
not have yet (ROADMAP Queue A item 18)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ape_x_dqn_tpu.configs import LearnerConfig as JLearnerConfig
from ape_x_dqn_tpu.configs import NetworkConfig as JNetworkConfig
from ape_x_dqn_tpu.envs.base import EnvSpec as JEnvSpec
from ape_x_dqn_tpu.models import build_network as jax_build_network
from ape_x_dqn_tpu.parallel.dist_learner import \
    DistDQNLearner as JaxDistDQNLearner
from ape_x_dqn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ape_x_dqn_tpu.replay.frame_ring import FrameRingReplay as JaxRing
from ape_x_dqn_tpu_torch.configs import LearnerConfig, NetworkConfig
from ape_x_dqn_tpu_torch.envs.base import EnvSpec
from ape_x_dqn_tpu_torch.models import build_network
from ape_x_dqn_tpu_torch.models.convert import from_flax
from ape_x_dqn_tpu_torch.parallel.dist_learner import DistDQNLearner
from ape_x_dqn_tpu_torch.parallel.mesh import make_mesh
from ape_x_dqn_tpu_torch.replay.frame_ring import FrameRingReplay
from ape_x_dqn_tpu_torch.replay.prioritized import ShardedReplayState
from ape_x_dqn_tpu_torch.utils.rng import component_generator

OBS_SHAPE = (6, 6, 4)


def _ring(cap=64, seg=8, obs=OBS_SHAPE, **kw):
    return FrameRingReplay(capacity=cap, seg_transitions=seg, n_step=3,
                           obs_shape=obs, device="cpu", **kw)


def _segs(replay, g, rng, next_off=3, lead=()):
    b, f = replay.B, replay.F
    items = {
        "seg_frames": rng.integers(0, 255, (*lead, g, f, replay.h, replay.w)
                                   ).astype(np.uint8),
        "action": rng.integers(0, 4, (*lead, g, b)).astype(np.int32),
        "reward": rng.normal(size=(*lead, g, b)).astype(np.float32),
        "discount": np.full((*lead, g, b), 0.97, np.float32),
        "next_off": np.full((*lead, g, b), next_off, np.int32),
    }
    pris = rng.uniform(0.1, 2.0, (*lead, g, b)).astype(np.float32)
    return items, pris


def _t(tree: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _stack(states) -> ShardedReplayState:
    out = ShardedReplayState(
        {k: torch.stack([s.storage[k] for s in states])
         for k in states[0].storage},
        torch.stack([s.tree for s in states]))
    out.pos = [s.pos for s in states]
    out.size = [s.size for s in states]
    return out


def _assert_state_eq(single, sharded):
    """Every stacked leaf is the single-card leaf under a leading [1]."""
    for k, v in single.storage.items():
        assert torch.equal(v, sharded.storage[k][0]), k
    assert torch.equal(single.tree, sharded.tree[0])
    assert sharded.pos.tolist() == [single.pos]
    assert sharded.size.tolist() == [single.size]
    assert sharded.pos_dev.tolist() == [single.pos]


def _learner(replay, dp, batch):
    return DistDQNLearner(replay, LearnerConfig(batch_size=batch),
                          make_mesh(dp=dp, tp=1, devices=["cpu"] * dp))


# -- dp=1 bitwise parity ---------------------------------------------------


def test_dp1_lockstep_add_sample_update_parity():
    replay = _ring()
    items, pris = _segs(replay, 4, np.random.default_rng(0))
    s1 = replay.add(replay.init(), _t(items), torch.from_numpy(pris))
    sd = replay.add_lockstep(replay.init_sharded(1),
                             {k: v[None] for k, v in _t(items).items()},
                             torch.from_numpy(pris)[None])
    _assert_state_eq(s1, sd)

    noise = torch.rand(16, generator=torch.Generator().manual_seed(42))
    it1, idx1, p1 = replay.sample_items(s1, 16, noise)
    itd, idxd, pd = replay.sample_items(sd, 16, noise[None])
    assert torch.equal(idx1, idxd[0]) and torch.equal(p1, pd[0])
    for k, v in it1.items():
        assert torch.equal(v, itd[k][0]), k

    td = torch.from_numpy(np.random.default_rng(3).uniform(
        0.1, 1.0, 16).astype(np.float32))
    replay.update_priorities(s1, idx1, td)
    replay.update_priorities(sd, idxd, td[None])
    _assert_state_eq(s1, sd)


def test_dp1_add_many_matches_single_chip_adds():
    """The dist learner's coalesced add_many ([g, dp, ...]) at dp=1
    equals g sequential single-card adds."""
    replay = _ring()
    learner = _learner(replay, 1, 16)
    net = build_network(NetworkConfig(kind="nature_cnn", dueling=True,
                                      cnn_channels=(4, 8, 8),
                                      torso_dense=16,
                                      compute_dtype="float32"),
                        EnvSpec(OBS_SHAPE, np.dtype(np.uint8), True, 4))
    state = learner.init(net, None, component_generator(0, "learner"))
    rng = np.random.default_rng(7)
    blocks = [_segs(replay, 2, rng) for _ in range(3)]
    grp = {k: torch.from_numpy(np.stack([b[0][k] for b in blocks])[:, None])
           for k in blocks[0][0]}
    grp_td = torch.from_numpy(np.stack([b[1] for b in blocks])[:, None])
    learner.add_many(state, grp, grp_td)
    s1 = replay.init()
    for items, pris in blocks:
        replay.add(s1, _t(items), torch.from_numpy(pris))
    _assert_state_eq(s1, state.replay)


# -- skewed shard fills ----------------------------------------------------


def test_skewed_shard_fill_is_weights_frame_ring():
    """The skew in the FILL (shard 0 holds 2 segments, shard 1 is full)
    and in the priority mass (1000x starved). Constant per-shard values
    and priorities make the beta=1 estimate zero-variance, so one draw
    recovers the exact uniform mean over the global live pool; the
    weights are the JAX learner's on the same draws."""
    dp, cap, seg = 2, 64, 8
    replay = _ring(cap=cap, seg=seg, alpha=1.0, beta=1.0, eps=0.0)
    jreplay = JaxRing(capacity=cap, seg_transitions=seg, n_step=3,
                      obs_shape=OBS_SHAPE, alpha=1.0, beta=1.0, eps=0.0)
    learner = _learner(replay, dp, 64)
    jlearner = JaxDistDQNLearner(lambda p, o: o, jreplay,
                                 JLearnerConfig(batch_size=64),
                                 jax_make_mesh(dp=dp, tp=1))
    masses, n_segs = [1e-3, 1.0], [2, cap // seg]
    rng = np.random.default_rng(0)
    states, jstates = [], []
    for d in range(dp):
        g = n_segs[d]
        items, _ = _segs(replay, g, rng)
        items["action"] = np.full((g, seg), d + 1, np.int32)  # value d+1
        pris = np.full((g, seg), masses[d] / (g * seg), np.float32)
        states.append(replay.add(replay.init(), _t(items),
                                 torch.from_numpy(pris)))
        jstates.append(jreplay.add(
            jreplay.init(), {k: jnp.asarray(v) for k, v in items.items()},
            jnp.asarray(pris)))
    state = _stack(states)
    jstate = jax.tree.map(lambda *xs: jnp.stack(xs), *jstates)

    keys = jax.random.split(jax.random.key(0), dp)
    noise = torch.from_numpy(np.stack(
        [np.asarray(jax.random.uniform(k, (32,))) for k in keys]))
    items, idx, w = learner._sample_weighted(state, noise, 32)
    _, jidx, jw = jlearner._sample_weighted(jstate, keys, 32)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
    assert (replay.valid_mask(state, idx) == 1.0).all()
    w = w.double().numpy()
    assert (w > 0.0).all() and np.isfinite(w).all()
    n0, n1 = n_segs[0] * seg, n_segs[1] * seg
    uniform_mean = (n0 * 1.0 + n1 * 2.0) / (n0 + n1)
    est = float((w * items["action"].double().numpy()).mean())
    assert abs(est - uniform_mean) < 1e-3, (est, uniform_mean)


def test_dead_pad_slots_sample_with_zero_weight():
    """A shard whose segments are all episode pads (next_off == 0)
    keeps them out of training: every draw there gets IS weight 0."""
    dp, cap, seg = 2, 32, 8
    replay = _ring(cap=cap, seg=seg, alpha=1.0, beta=1.0, eps=0.0)
    learner = _learner(replay, dp, 64)
    rng = np.random.default_rng(1)
    states = []
    for d in range(dp):
        items, pris = _segs(replay, 2, rng, next_off=3 if d == 0 else 0)
        states.append(replay.add(replay.init(), _t(items),
                                 torch.from_numpy(pris)))
    state = _stack(states)
    noise = torch.rand((dp, 32), generator=torch.Generator().manual_seed(5))
    _, idx, w = learner._sample_weighted(state, noise, 32)
    valid = replay.valid_mask(state, idx)
    assert (valid[1] == 0.0).all()
    assert torch.equal(w[1], torch.zeros_like(w[1]))
    assert (w[0] > 0.0).all()


# -- per-shard observability -----------------------------------------------


def test_shard_stats_reports_per_shard_fill_and_mass():
    """shard_stats: sizes/live/fill/tree_mass per shard, frame-ring live
    counts excluding dead pads."""
    dp, cap, seg = 2, 32, 8
    replay = _ring(cap=cap, seg=seg)
    learner = _learner(replay, dp, 16)
    net = build_network(NetworkConfig(kind="nature_cnn", dueling=True,
                                      cnn_channels=(4, 8, 8),
                                      torso_dense=16,
                                      compute_dtype="float32"),
                        EnvSpec(OBS_SHAPE, np.dtype(np.uint8), True, 4))
    state = learner.init(net, None, component_generator(0, "learner"))
    items, pris = _segs(replay, 2, np.random.default_rng(2), lead=(dp,))
    items["next_off"][1, :, seg // 2:] = 0   # shard 1 half pads
    learner.add(state, _t(items), torch.from_numpy(pris))
    stats = learner.shard_stats(state)
    assert stats["sizes"] == [16, 16]
    assert stats["live"] == [16, 8]
    assert stats["fill"] == [0.5, 0.5]
    assert stats["fill_min"] == stats["fill_max"] == 0.5
    assert len(stats["tree_mass"]) == dp
    assert all(m > 0 for m in stats["tree_mass"])


def test_live_transitions_single_and_sharded():
    replay = _ring(cap=32, seg=8)
    items, pris = _segs(replay, 2, np.random.default_rng(4))
    s1 = replay.add(replay.init(), _t(items), torch.from_numpy(pris))
    assert int(replay.live_transitions(s1)) == 16
    sd = replay.add_lockstep(replay.init_sharded(1),
                             {k: v[None] for k, v in _t(items).items()},
                             torch.from_numpy(pris)[None])
    assert replay.live_transitions(sd).tolist() == [16]


# -- the Nature CNN's dist learner against the JAX package's --------------


def test_dist_frame_ring_learner_matches_jax():
    dp, tp, obs, seg, cap = 4, 2, (36, 36, 4), 8, 64
    net = dict(kind="nature_cnn", cnn_channels=(4, 8, 8), torso_dense=32,
               dueling=True, compute_dtype="bfloat16")
    lcfg = dict(batch_size=32, sample_chunk=4, target_sync_every=2,
                lr=1e-3)
    jnet = jax_build_network(JNetworkConfig(**net),
                             JEnvSpec(obs, np.dtype(np.uint8), True, 6))
    params = jnet.init(jax.random.key(0), jnp.zeros((1, *obs), jnp.uint8))
    jr = JaxRing(cap, seg, 3, obs)
    jl = JaxDistDQNLearner(jnet.apply, jr, JLearnerConfig(**lcfg),
                           jax_make_mesh(dp=dp, tp=tp))
    js = jl.init(params, None, jax.random.key(1))
    tnet = build_network(NetworkConfig(**net),
                         EnvSpec(obs, np.dtype(np.uint8), True, 6))
    tnet.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    tr = _ring(cap=cap, seg=seg, obs=obs)
    tl = DistDQNLearner(tr, LearnerConfig(**lcfg),
                        make_mesh(dp=dp, tp=tp, devices=["cpu"] * 8))
    ts = tl.init(tnet, None, component_generator(0, "learner"))
    items, pris = _segs(tr, 6, np.random.default_rng(9), lead=(dp,))
    items["next_off"][:, :, -1] = 0          # a dead pad per segment
    js = jl.add(js, {k: jnp.asarray(v) for k, v in items.items()},
                jnp.asarray(pris))
    tl.add(ts, _t(items), torch.from_numpy(pris))
    np.testing.assert_allclose(ts.replay.tree.numpy(),
                               np.asarray(js.replay.tree), rtol=1e-6)

    def draws(n):
        keys = jax.vmap(lambda k: jax.random.split(k, 2))(js.rng)[:, 1]
        noise = torch.from_numpy(np.stack(
            [np.asarray(jax.random.uniform(k, (n,))) for k in keys]))
        _, jidx, jw = jl._sample_weighted(js.replay, keys, n)
        _, idx, w = tl._sample_weighted(ts.replay, noise, n)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
        return noise

    def compare(jm, tm):
        assert ts.step == int(js.step)
        want = from_flax(jax.tree.map(np.asarray, js.params))
        for k, v in ts.net.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                       atol=3e-2, err_msg=k)
        for k in ("loss", "q_mean", "td_abs_mean"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                       rtol=3e-2, atol=3e-2, err_msg=k)

    b_local = lcfg["batch_size"] // dp
    noise = draws(b_local)
    js, jm = jl.train_step(js)
    ts, tm = tl.train_step(ts, noise)
    compare(jm, tm)
    # the next draw from the JAX write-back's trees
    ts.replay.tree.copy_(torch.from_numpy(np.array(js.replay.tree)))
    noise = draws(4 * b_local)
    js, jm = jl.train_step_k(js, 4)
    ts, tm = tl.train_step_k(ts, 4, noise)
    compare(jm, tm)
