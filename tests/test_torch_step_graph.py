"""The learners' step bodies are safe to capture into a CUDA graph
(runtime/step_graph.py), shown on the CPU: a captured graph replays
the device operations it recorded and none of the host code around
them, so a body may read no host value that changes between calls.

Each body here runs twice on the same state objects with an `add`
between the calls that moves the replay's fill and write cursor, and
while it runs the host's copies of those values, and the host step
count, hold garbage: the body must read the device mirrors. The results
must match the JAX learner on the same fed noise (the helpers and the
tolerances of tests/test_torch_learner.py: params 2e-6 absolute, loss
and diagnostics 1e-4 relative, the tree 1e-5 relative, cursors and step
counts exact). The frame-ring case runs K=4 macro-steps with a target
sync every 3 grad-steps, so a sync falls inside each macro-step."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.configs import LearnerConfig, NetworkConfig
from ape_x_dqn_tpu.envs.base import EnvSpec as JaxEnvSpec
from ape_x_dqn_tpu.models import build_network as jax_build_network
from ape_x_dqn_tpu.replay.frame_ring import FrameRingReplay as JaxRing
from ape_x_dqn_tpu.replay.prioritized import PrioritizedReplay as JaxPER
from ape_x_dqn_tpu.runtime.learner import DQNLearner as JaxLearner
from ape_x_dqn_tpu.runtime.learner import (
    transition_item_spec as jax_item_spec)
from ape_x_dqn_tpu_torch.configs import LearnerConfig as TLearnerConfig
from ape_x_dqn_tpu_torch.configs import NetworkConfig as TNetworkConfig
from ape_x_dqn_tpu_torch.envs.base import EnvSpec
from ape_x_dqn_tpu_torch.models import build_network
from ape_x_dqn_tpu_torch.models.convert import from_flax
from ape_x_dqn_tpu_torch.ops import sum_tree
from ape_x_dqn_tpu_torch.replay.frame_ring import FrameRingReplay
from ape_x_dqn_tpu_torch.replay.prioritized import (PrioritizedReplay,
                                                    ReplayState,
                                                    UniformReplayDevice)
from ape_x_dqn_tpu_torch.runtime.learner import (ClipAdam, DQNLearner,
                                                 transition_item_spec)
from ape_x_dqn_tpu_torch.runtime.step_graph import (StepGraph,
                                                    pack_metrics,
                                                    unpack_metrics)
from ape_x_dqn_tpu_torch.utils.rng import component_generator
from tests.test_torch_learner import _compare

GARBAGE = -10 ** 9


@contextlib.contextmanager
def _host_values_poisoned(ts):
    """The host's cursor, fill and step count hold garbage for the
    duration (the device mirrors keep the truth)."""
    saved = (ts.replay._pos, ts.replay._size, ts.step)
    ts.replay._pos = ts.replay._size = ts.step = GARBAGE
    try:
        yield
    finally:
        ts.replay._pos, ts.replay._size, ts.step = saved


def _ring_segments(g, seed, obs=(42, 42, 4), seg=8, nstep=3):
    rng = np.random.default_rng(seed)
    f = seg + nstep + obs[2] - 1
    next_off = rng.integers(1, nstep + 1, (g, seg)).astype(np.int32)
    next_off[:, -1] = 0            # one dead pad slot per segment
    td = rng.uniform(0.1, 2.0, (g, seg)).astype(np.float32)
    td[next_off == 0] = 0.0
    return {
        "seg_frames": rng.integers(0, 255, (g, f, *obs[:2])).astype(
            np.uint8),
        "action": rng.integers(0, 6, (g, seg)).astype(np.int32),
        "reward": rng.normal(size=(g, seg)).astype(np.float32),
        "discount": np.full((g, seg), 0.99 ** 3, np.float32),
        "next_off": next_off,
    }, td


def _flat_items(b, seed, obs=(32, 32, 4)):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.integers(0, 255, (b, *obs)).astype(np.uint8),
        "action": rng.integers(0, 6, b).astype(np.int32),
        "reward": rng.normal(size=b).astype(np.float32),
        "next_obs": rng.integers(0, 255, (b, *obs)).astype(np.uint8),
        "discount": np.full(b, 0.97, np.float32),
    }, rng.uniform(0.1, 2.0, b).astype(np.float32)


def _pair(net_kw, obs, lcfg, jax_replay, torch_replay, torch_init):
    jspec = JaxEnvSpec(obs, np.dtype(np.uint8), True, 6)
    jnet = jax_build_network(NetworkConfig(**net_kw), jspec)
    params = jnet.init(jax.random.key(0), jnp.zeros((1, *obs), jnp.uint8))
    jl = JaxLearner(jnet.apply, jax_replay, LearnerConfig(**lcfg))
    js = jl.init(params, jax_replay.init(), jax.random.key(3))
    tnet = build_network(TNetworkConfig(**net_kw),
                         EnvSpec(obs, np.dtype(np.uint8), True, 6))
    tnet.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    tl = DQNLearner(torch_replay, TLearnerConfig(**lcfg))
    ts = tl.init(tnet, torch_init(), component_generator(0, "learner"))
    return jl, js, tl, ts


def _add(jl, js, tl, ts, items, td):
    js = jl.add(js, {k: jnp.asarray(v) for k, v in items.items()},
                jnp.asarray(td))
    tl.add(ts, {k: torch.from_numpy(v) for k, v in items.items()},
           torch.from_numpy(td))
    return js


def _next_noise(js, batch):
    _, sk = jax.random.split(js.rng)
    return torch.from_numpy(np.array(jax.random.uniform(sk, (batch,))))


def test_k4_body_with_a_sync_inside_reads_only_device_state():
    """Frame ring, K=4, target sync every 3: two macro-step bodies
    (grad-steps 1-4 and 5-8, syncs at 3 and 6) with an add between."""
    lcfg = dict(batch_size=8, sample_chunk=4, target_sync_every=3, lr=1e-3)
    net = dict(kind="nature_cnn", cnn_channels=(4, 8, 8), torso_dense=32,
               compute_dtype="float32")
    obs = (42, 42, 4)
    tr = FrameRingReplay(64, 8, 3, obs, device="cpu")
    jl, js, tl, ts = _pair(net, obs, lcfg, JaxRing(64, 8, 3, obs), tr,
                           tr.init)
    js = _add(jl, js, tl, ts, *_ring_segments(3, 0))
    for call in range(2):
        noise = _next_noise(js, 4 * lcfg["batch_size"])
        js, jm = jl.train_step_k(js, 4)
        with _host_values_poisoned(ts):
            tm = tl._step_body_k(ts, 4, noise)
        ts.step += 4
        _compare(jl, js, jm, tl, ts, tm)
        # the add moves the fill and the cursor before the next call
        size0 = ts.replay.size
        js = _add(jl, js, tl, ts, *_ring_segments(2, call + 1))
        assert ts.replay.size > size0
        assert int(ts.replay.size_dev) == ts.replay.size
        assert int(tr.cursor_transitions(ts.replay)) \
            == int(jl.replay.cursor_transitions(js.replay))
    assert int(ts.opt_state.count) == ts.step == 8


def test_single_step_body_over_flat_replay_reads_only_device_state():
    """Flat prioritized replay (packed pixel leaves), the exact
    single-step body twice with an add between. At lr 1e-4, as
    tests/test_torch_r2d2_learner_frames.py trains its raw-pixel torso:
    a first layer over 4096 raw bytes gets gradient elements at
    rounding level whose normalised Adam updates, of the order of the
    learning rate, can differ between the packages (at 1e-3 one element
    of 65,536 moved 2.06e-6 apart in two steps; ROADMAP Queue C)."""
    lcfg = dict(batch_size=8, target_sync_every=2, lr=1e-4)
    net = dict(kind="mlp", mlp_hidden=(16,), dueling=True,
               compute_dtype="float32")
    obs = (32, 32, 4)
    tr = PrioritizedReplay(128, device="cpu",
                           item_spec=transition_item_spec(obs, np.uint8))
    jl, js, tl, ts = _pair(
        net, obs, lcfg, JaxPER(128, item_spec=jax_item_spec(obs, np.uint8)),
        tr, tr.init)
    js = _add(jl, js, tl, ts, *_flat_items(40, 0))
    for call in range(2):
        noise = _next_noise(js, lcfg["batch_size"])
        js, jm = jl.train_step(js)
        with _host_values_poisoned(ts):
            tm = tl._step_body(ts, noise)
        ts.step += 1
        _compare(jl, js, jm, tl, ts, tm)
        js = _add(jl, js, tl, ts, *_flat_items(24, call + 1))


def test_replay_state_mirrors_follow_every_write():
    tree = sum_tree.init(16)
    rs = ReplayState({}, tree, pos=3, size=5)
    assert (int(rs.pos_dev), int(rs.size_dev)) == (3, 5)
    pos_ptr = rs.pos_dev.data_ptr()
    rs.pos, rs.size = 7, 11
    assert (int(rs.pos_dev), int(rs.size_dev)) == (7, 11)
    assert rs.pos_dev.data_ptr() == pos_ptr          # written in place
    ur = UniformReplayDevice(16, device="cpu",
                             item_spec={"x": transition_item_spec(
                                 (2,), np.float32)["reward"]})
    us = ur.init()
    ur.add(us, {"x": torch.ones(6)})
    assert (us.pos, us.size) == (6, 6)
    assert (int(us.pos_dev), int(us.size_dev)) == (6, 6)
    assert int(ur.cursor_transitions(us)) == 6


def test_descent_clamps_on_a_device_size_as_on_a_host_one():
    tree = sum_tree.init(64)
    sum_tree.update(tree, torch.arange(64),
                    torch.from_numpy(np.random.default_rng(0).uniform(
                        0.1, 1.0, 64).astype(np.float32)))
    noise = torch.rand(32, generator=torch.Generator().manual_seed(1))
    for size in (1, 17, 64):
        a = sum_tree.sample(tree, 32, size=size, noise=noise)
        b = sum_tree.sample(tree, 32, size=torch.tensor(size), noise=noise)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_adam_count_and_bias_corrections_live_on_the_device():
    """The count is a 0-dim int32 tensor, advanced in place; the float32
    bias corrections equal optax's formula, (1 - b^t) in float32, for
    the first ten steps."""
    opt = ClipAdam(max_norm=10.0, lr=1e-3)
    p = [torch.ones(3)]
    st = opt.init(p)
    ptr = st.count.data_ptr()
    for t in range(1, 11):
        g = [torch.full((3,), 0.5)]
        u = opt.update(g, st)
        assert st.count.dtype == torch.int32 and int(st.count) == t
        bc1 = np.float32(1) - np.float32(0.9) ** np.float32(t)
        bc2 = np.float32(1) - np.float32(0.999) ** np.float32(t)
        mu, nu = st.mu[0][0].item(), st.nu[0][0].item()
        want = np.float32(-1e-3) * (np.float32(mu) / bc1) / (
            np.sqrt(np.float32(nu) / bc2) + np.float32(1e-8))
        np.testing.assert_allclose(u[0][0].item(), want, rtol=1e-6)
    assert st.count.data_ptr() == ptr


def test_metrics_pack_and_unpack():
    m = {"loss": torch.tensor(1.5), "n": torch.tensor(3, dtype=torch.int32),
         "diag": {"a": torch.tensor([2.0]), "b": torch.tensor(-1.0)}}
    vec, paths = pack_metrics(m)
    assert vec.dtype == torch.float32 and vec.shape == (4,)
    out = unpack_metrics(vec.clone(), paths)
    assert out.keys() == m.keys() and out["diag"].keys() == m["diag"].keys()
    assert out["n"].item() == 3 and out["diag"]["a"].item() == 2.0
    with pytest.raises(ValueError, match="not a scalar"):
        pack_metrics({"v": torch.ones(2)})


def test_cpu_step_graph_runs_the_body_eagerly():
    """On the CPU a StepGraph is the body itself: no warm-up state, no
    capture, and the learner reports that it replays no graph."""
    calls = []
    g = StepGraph(lambda s, u: calls.append(u) or {"x": u.sum()})
    for _ in range(3):
        out = g(object(), torch.ones(2), capture=True)
        assert out["x"].item() == 2.0
    assert len(calls) == 3 and not g.captured
    tr = PrioritizedReplay(16, device="cpu")
    assert not DQNLearner(tr, TLearnerConfig()).graphed
