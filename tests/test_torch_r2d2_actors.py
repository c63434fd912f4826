"""The port's recurrent actors (ape_x_dqn_tpu_torch/runtime/actor.py
`RecurrentActor`, runtime/vector_actor.py `RecurrentVectorActor`)
against the JAX package's, from the same config, seeds and fake
recurrent query function: the shipped sequence batches bitwise (obs or
single frames, actions, rewards, terminals, masks, stored states,
env-frame counts), priorities to rtol 1e-6 (float32 of the same float64
arithmetic). Masked CartPole (vector obs, stacked storage) and
synthetic catch under frame_ring storage (single frames per sequence)
with a short episode cap, so that terminals and time-limit truncations
both occur."""

import numpy as np
import pytest

from ape_x_dqn_tpu import configs as jcfgs
from ape_x_dqn_tpu.comm.transport import LoopbackTransport as JaxTransport
from ape_x_dqn_tpu.runtime.actor import RecurrentActor as JaxRecurrentActor
from ape_x_dqn_tpu.runtime.vector_actor import (
    RecurrentVectorActor as JaxRecurrentVectorActor)
from ape_x_dqn_tpu_torch import configs as tcfgs
from ape_x_dqn_tpu_torch.comm.transport import LoopbackTransport
from ape_x_dqn_tpu_torch.envs import make_env
from ape_x_dqn_tpu_torch.runtime.actor import RecurrentActor
from ape_x_dqn_tpu_torch.runtime.vector_actor import RecurrentVectorActor

KEYS = ("actions", "rewards", "terminals", "mask", "init_c", "init_h")


def _cfg(pkg, pixels: bool, num_actors=2, envs_per_actor=1):
    if pixels:
        env = pkg.EnvConfig(id="catch", kind="synthetic_atari",
                            max_episode_frames=120)
        replay = pkg.ReplayConfig(kind="sequence", capacity=256,
                                  seq_length=12, seq_overlap=6, burn_in=4,
                                  min_fill=16, storage="frame_ring")
    else:
        env = pkg.EnvConfig(id="CartPolePO", kind="cartpole_po")
        # episodes of ~10 steps under this policy: short sequences, so
        # that some start mid-episode with a non-zero stored state
        replay = pkg.ReplayConfig(kind="sequence", capacity=256,
                                  seq_length=6, seq_overlap=3, burn_in=2,
                                  min_fill=16)
    return pkg.get_config("r2d2").replace(
        env=env, replay=replay,
        network=pkg.NetworkConfig(kind="lstm_q", lstm_size=4,
                                  torso_dense=8, compute_dtype="float32"),
        learner=pkg.LearnerConfig(batch_size=8, n_step=3, gamma=0.97),
        actors=pkg.ActorConfig(num_actors=num_actors, base_eps=0.5,
                               envs_per_actor=envs_per_actor,
                               ingest_batch=32),
        parallel=pkg.ParallelConfig(dp=1, tp=1))


def _fake_net(num_actions: int):
    """A fake recurrent net as (scalar query, vector query): Q varies
    with the observation and the state (greedy choices vary), the state
    with both."""

    def q(obs, c, h):
        x = np.asarray(obs, np.float32).reshape(obs.shape[0], -1)
        s = x.mean(axis=1, keepdims=True)
        qs = np.sin(s * 0.7 + np.arange(num_actions)[None]
                    + c.mean(axis=1, keepdims=True))
        return {"q": qs.astype(np.float32),
                "c": np.tanh(0.9 * c + 0.1 * s).astype(np.float32),
                "h": np.tanh(0.5 * h - 0.2 * s + 0.1).astype(np.float32)}

    def scalar(inp):
        out = q(np.asarray(inp["obs"])[None], np.asarray(inp["c"])[None],
                np.asarray(inp["h"])[None])
        return {k: v[0] for k, v in out.items()}

    def vector(inp, n):
        assert np.asarray(inp["obs"]).shape[0] == n
        return q(np.asarray(inp["obs"]), np.asarray(inp["c"]),
                 np.asarray(inp["h"]))

    return scalar, vector


def _net_for(cfg):
    return _fake_net(make_env(cfg.env).spec.num_actions)


def _drain(transport) -> list[dict]:
    out = []
    while True:
        b = transport.recv_experience(timeout=0.01)
        if b is None:
            return out
        out.append(b)


def _cat(batches, key):
    return np.concatenate([np.asarray(b[key]) for b in batches])


def _same_stream(bt, bj, obs_key):
    assert len(bt) == len(bj) > 3
    for key in (obs_key, *KEYS):
        np.testing.assert_array_equal(_cat(bt, key), _cat(bj, key),
                                      err_msg=key)
    assert [b["frames"] for b in bt] == [b["frames"] for b in bj]
    assert [b["actor"] for b in bt] == [b["actor"] for b in bj]
    np.testing.assert_allclose(_cat(bt, "priorities"),
                               _cat(bj, "priorities"), rtol=1e-6)
    # greedy choices, stored non-zero states and padded tails happened
    assert len(np.unique(_cat(bt, "actions"))) > 1
    assert np.any(_cat(bt, "init_c") != 0)
    assert np.any(_cat(bt, "mask") == 0)


@pytest.mark.parametrize("pixels", [False, True],
                         ids=["cartpole_po", "catch_frames"])
def test_recurrent_actor_ships_the_originals_sequences(pixels):
    t, j = LoopbackTransport(), JaxTransport()
    query, _ = _net_for(_cfg(tcfgs, pixels))
    ft = RecurrentActor(_cfg(tcfgs, pixels), 1, query, t, seed=3).run(400)
    fj = JaxRecurrentActor(_cfg(jcfgs, pixels), 1, query, j,
                           seed=3).run(400)
    assert ft == fj == 400
    bt, bj = _drain(t), _drain(j)
    _same_stream(bt, bj, "seq_frames" if pixels else "obs")
    assert sum(b["frames"] for b in bt) == 400
    if pixels:
        assert bt[0]["seq_frames"].shape[1:] == (12 + 3, 84, 84)


@pytest.mark.parametrize("pixels", [False, True],
                         ids=["cartpole_po", "catch_frames"])
def test_recurrent_vector_actor_ships_the_originals_sequences(pixels):
    t, j = LoopbackTransport(), JaxTransport()
    _, query = _net_for(_cfg(tcfgs, pixels))
    ft = RecurrentVectorActor(_cfg(tcfgs, pixels, envs_per_actor=3), 1,
                              query, t, seed=4).run(450)
    fj = JaxRecurrentVectorActor(_cfg(jcfgs, pixels, envs_per_actor=3), 1,
                                 query, j, seed=4).run(450)
    assert ft == fj >= 450
    bt, bj = _drain(t), _drain(j)
    _same_stream(bt, bj, "seq_frames" if pixels else "obs")
    assert sum(b["frames"] for b in bt) == ft


def test_vector_actor_with_one_env_matches_the_scalar_actor():
    """K=1: the vector actor ships what the scalar actor ships."""
    cfg = _cfg(tcfgs, False, num_actors=1)
    scalar, vector = _net_for(cfg)
    t_s, t_v = LoopbackTransport(), LoopbackTransport()
    RecurrentActor(cfg, 0, scalar, t_s, seed=5).run(300)
    RecurrentVectorActor(cfg, 0, vector, t_v, seed=5).run(300)
    bs, bv = _drain(t_s), _drain(t_v)
    for key in ("obs", *KEYS, "priorities"):
        np.testing.assert_allclose(_cat(bs, key), _cat(bv, key), rtol=1e-6,
                                   err_msg=key)
