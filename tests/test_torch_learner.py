"""The whole slice: the port's DQNLearner over its frame-ring replay
(ape_x_dqn_tpu_torch/runtime/learner.py) against the JAX package's, from
identical converted params, identical replay contents and JAX's own
stratification noise, in float32. One exact train_step, then one K=4
macro-step; target_sync_every=2 makes hard syncs happen inside both.

Tolerances: the trained params to 2e-6 absolute and the loss and
diagnostics to 1e-4 relative (float32 arithmetic summed in another
order, through 5 Adam steps whose updates are ~lr = 1e-3 in size);
the step count and the replay cursors exact; the tree to 1e-5 relative
(priorities are a float32 power of |TD|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.configs import LearnerConfig, NetworkConfig
from ape_x_dqn_tpu.envs.base import EnvSpec as JaxEnvSpec
from ape_x_dqn_tpu.models import build_network as jax_build_network
from ape_x_dqn_tpu.replay.frame_ring import FrameRingReplay as JaxRing
from ape_x_dqn_tpu.runtime.learner import DQNLearner as JaxLearner
from ape_x_dqn_tpu_torch.configs import LearnerConfig as TLearnerConfig
from ape_x_dqn_tpu_torch.configs import NetworkConfig as TNetworkConfig
from ape_x_dqn_tpu_torch.envs.base import EnvSpec
from ape_x_dqn_tpu_torch.models import build_network
from ape_x_dqn_tpu_torch.models.convert import from_flax
from ape_x_dqn_tpu_torch.replay.frame_ring import FrameRingReplay
from ape_x_dqn_tpu_torch.runtime.learner import DQNLearner
from ape_x_dqn_tpu_torch.utils.rng import component_generator

OBS = (42, 42, 4)
NET = dict(kind="nature_cnn", cnn_channels=(4, 8, 8), torso_dense=32,
           compute_dtype="float32")
LCFG = dict(batch_size=8, sample_chunk=4, target_sync_every=2, lr=1e-3)
CAP, SEG, NSTEP = 64, 8, 3


def _segments(g_outer, g, seed=0):
    rng = np.random.default_rng(seed)
    f = SEG + NSTEP + OBS[2] - 1
    next_off = rng.integers(1, NSTEP + 1, (g_outer, g, SEG)).astype(np.int32)
    next_off[:, :, -1] = 0            # one dead pad slot per segment
    td = rng.uniform(0.1, 2.0, (g_outer, g, SEG)).astype(np.float32)
    td[next_off == 0] = 0.0
    items = {
        "seg_frames": rng.integers(0, 255, (g_outer, g, f, *OBS[:2])).astype(
            np.uint8),
        "action": rng.integers(0, 6, (g_outer, g, SEG)).astype(np.int32),
        "reward": rng.normal(size=(g_outer, g, SEG)).astype(np.float32),
        "discount": np.full((g_outer, g, SEG), 0.99 ** 3, np.float32),
        "next_off": next_off,
    }
    return items, td


@pytest.fixture(scope="module")
def learners():
    jspec = JaxEnvSpec(OBS, np.dtype(np.uint8), True, 6)
    jnet = jax_build_network(NetworkConfig(**NET), jspec)
    params = jnet.init(jax.random.key(0), jnp.zeros((1, *OBS), jnp.uint8))
    jr = JaxRing(CAP, SEG, NSTEP, OBS)
    jl = JaxLearner(jnet.apply, jr, LearnerConfig(**LCFG))
    js = jl.init(params, jr.init(), jax.random.key(3))

    tnet = build_network(TNetworkConfig(**NET),
                         EnvSpec(OBS, np.dtype(np.uint8), True, 6))
    tnet.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    tr = FrameRingReplay(CAP, SEG, NSTEP, OBS, device="cpu")
    tl = DQNLearner(tr, TLearnerConfig(**LCFG))
    ts = tl.init(tnet, tr.init(), component_generator(0, "learner"))

    items, td = _segments(2, 3)
    js = jl.add_many(js, {k: jnp.asarray(v) for k, v in items.items()},
                     jnp.asarray(td))
    tl.add_many(ts, {k: torch.from_numpy(v) for k, v in items.items()},
                torch.from_numpy(td))
    return jl, js, tl, ts


def _next_noise(js, batch):
    """The noise JAX's learner will draw from js.rng for this step."""
    _, sk = jax.random.split(js.rng)
    return torch.from_numpy(np.array(jax.random.uniform(sk, (batch,))))


def _compare(jl, js, jm, tl, ts, tm):
    assert ts.step == int(js.step)
    for name, got, want in (("params", ts.net, js.params),
                            ("target", ts.target_net, js.target_params)):
        want = from_flax(jax.tree.map(np.asarray, want))
        for k, v in got.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                       atol=2e-6, err_msg=f"{name}.{k}")
    np.testing.assert_allclose(ts.replay.tree.numpy(),
                               np.asarray(js.replay.tree), rtol=1e-5)
    assert (ts.replay.pos, ts.replay.size) == (int(js.replay.pos),
                                               int(js.replay.size))
    for k in ("loss", "q_mean", "td_abs_mean", "grad_norm"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    assert set(tm["diag"]) == set(jm["diag"])
    for k, v in tm["diag"].items():
        np.testing.assert_allclose(v.item(), float(jm["diag"][k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)


def test_train_step_then_train_step_k_match_jax(learners):
    jl, js, tl, ts = learners
    b = LCFG["batch_size"]
    # one exact step (no sync at step 1)
    noise = _next_noise(js, b)
    root = ts.replay.tree[1].item()
    js, jm = jl.train_step(js)
    ts, tm = tl.train_step(ts, noise)
    _compare(jl, js, jm, tl, ts, tm)
    assert ts.replay.tree[1].item() != root     # write-back happened
    # one K=4 macro-step: steps 2..5, syncs at 2 and 4 inside it
    noise = _next_noise(js, 4 * b)
    js, jm = jl.train_step_k(js, 4)
    ts, tm = tl.train_step_k(ts, 4, noise)
    _compare(jl, js, jm, tl, ts, tm)
    assert ts.step == 5
    # step 5 did not sync: target holds the step-4 params, not the online
    diff = [float((t - p).detach().abs().max()) for t, p in
            zip(ts.target_net.parameters(), ts.net.parameters())]
    assert max(diff) > 0


def test_train_many_runs_remainder_first(learners):
    """train_many(6) with K=4 runs the 2 remainder singles FIRST, then
    one macro-step: 6 grad-steps in all."""
    _, _, tl, ts = learners
    step0 = ts.step
    calls = []
    orig_single, orig_k = tl._train_step, tl._train_step_k
    tl._train_step = lambda s, *a: calls.append(1) or orig_single(s, *a)
    tl._train_step_k = lambda s, k, *a: calls.append(k) or orig_k(s, k, *a)
    try:
        ts, m = tl.train_many(ts, 6)
    finally:
        del tl._train_step, tl._train_step_k
    assert calls == [1, 1, 4]
    assert ts.step == step0 + 6
    assert np.isfinite(m["loss"].item())
    published = tl.publish_params(ts)
    for k, v in ts.net.state_dict().items():
        assert torch.equal(published[k], v)
        assert published[k].data_ptr() != v.data_ptr()


def test_build_learner_sizes_the_ring_like_the_jax_driver():
    from ape_x_dqn_tpu.configs import get_config as jax_get_config
    from ape_x_dqn_tpu.runtime.driver import build_prioritized_replay
    from ape_x_dqn_tpu.utils.misc import next_pow2
    from ape_x_dqn_tpu_torch.configs import ReplayConfig, get_config
    from ape_x_dqn_tpu_torch.runtime.build import build_learner

    replay = dict(kind="prioritized", capacity=1000, storage="frame_ring",
                  seg_transitions=16)
    cfg = get_config("pong").replace(replay=ReplayConfig(**replay),
                                     network=TNetworkConfig(**NET))
    spec = EnvSpec((84, 84, 4), np.dtype(np.uint8), True, 18)
    learner, state = build_learner(cfg, spec, device="cpu")
    jcfg = jax_get_config("pong")
    jcfg = jcfg.replace(replay=type(jcfg.replay)(**replay))
    jr = build_prioritized_replay(jcfg, spec, next_pow2(1000), True)
    tr = learner.replay
    assert (tr.capacity, tr.S, tr.F, tr.frame_row, tr.alpha, tr.beta) == \
        (jr.capacity, jr.S, jr.F, jr.frame_row, jr.alpha, jr.beta)
    js = jr.init()
    for k, v in state.replay.storage.items():
        assert tuple(v.shape) == js.storage[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(js.storage[k].dtype), k
    assert state.step == 0 and state.replay.size == 0
    assert all(p.device.type == "cpu" for p in state.net.parameters())


def test_build_learner_asks_for_cuda_by_default():
    """No silent CPU fallback: without a card, the default device raises."""
    from ape_x_dqn_tpu_torch.configs import get_config
    from ape_x_dqn_tpu_torch.runtime.build import build_learner

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    spec = EnvSpec((84, 84, 4), np.dtype(np.uint8), True, 18)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_learner(get_config("pong"), spec)
