"""The port's environments and n-step folding
(ape_x_dqn_tpu_torch/envs/, ops/nstep.py) against the JAX package's:
the same seed and the same action sequence through both. Everything is
host numpy arithmetic in the same order, so observations, rewards,
dones, info dicts and emitted transitions must be bitwise equal."""

import dataclasses

import numpy as np
import pytest

from ape_x_dqn_tpu.configs import EnvConfig as JEnvConfig
from ape_x_dqn_tpu.envs import make_env as jax_make_env
from ape_x_dqn_tpu.ops.nstep import NStepBuilder as JaxNStep
from ape_x_dqn_tpu_torch.configs import EnvConfig
from ape_x_dqn_tpu_torch.envs import make_env
from ape_x_dqn_tpu_torch.ops.nstep import NStepBuilder


def _run_both(cfg_kw, steps, seed):
    """Step both packages' envs with one random action stream; returns
    the count of (episode ends, life losses) seen."""
    jenv = jax_make_env(JEnvConfig(**cfg_kw), seed=seed)
    tenv = make_env(EnvConfig(**cfg_kw), seed=seed)
    assert dataclasses.astuple(tenv.spec) == dataclasses.astuple(jenv.spec)
    np.testing.assert_array_equal(tenv.reset(), jenv.reset())
    rng = np.random.default_rng(seed)
    ends = lives_lost = 0
    for _ in range(steps):
        a = int(rng.integers(tenv.spec.num_actions))
        tobs, tr, td, ti = tenv.step(a)
        jobs, jr, jd, ji = jenv.step(a)
        np.testing.assert_array_equal(tobs, jobs)
        assert tobs.dtype == jobs.dtype
        assert (tr, td) == (jr, jd)
        assert ti == ji
        if td:
            ends += 1
            lives_lost += "lives" in ti and "episode_return" not in ti
            np.testing.assert_array_equal(tenv.reset(), jenv.reset())
    return ends, lives_lost


@pytest.mark.parametrize("kind", ["cartpole", "cartpole_po"])
def test_cartpole_steps_bitwise_equal(kind):
    ends, _ = _run_both(dict(kind=kind), steps=400, seed=3)
    assert ends >= 5  # random actions end episodes within ~20 steps


def test_catch_env_steps_bitwise_equal_across_life_loss():
    """make_env on the catch config (the synthetic Atari game under the
    full preprocessing stack): resets, life losses (episodic-life
    pseudo-resets) and a game over all happen in 300 steps."""
    ends, lives_lost = _run_both(dict(id="catch", kind="synthetic_atari"),
                                 steps=300, seed=1)
    assert lives_lost >= 2 and ends > lives_lost


def test_control_kind_waits_for_its_slice():
    """The control kind, refused until the DPG slice, now builds what
    the original builds from the same config: the native pendulum, and
    a dm_control task for an id with an underscore (dm_control imports
    here), with the same spec and the same first observation."""
    for env_id in ("pendulum", "humanoid_stand"):
        t = make_env(EnvConfig(id=env_id, kind="control"), seed=3)
        j = jax_make_env(JEnvConfig(id=env_id, kind="control"), seed=3)
        assert dataclasses.asdict(t.spec) == dataclasses.asdict(j.spec)
        np.testing.assert_array_equal(t.reset(), j.reset())


def test_nstep_builder_emits_identical_transitions():
    """One stream with a terminal ending, a truncated ending and an
    unfinished tail, through both builders (n=3, gamma=0.9)."""
    rng = np.random.default_rng(0)
    jb, tb = JaxNStep(3, 0.9), NStepBuilder(3, 0.9)
    ends = {6: (True, False), 13: (False, True)}
    emitted = 0
    for t in range(18):
        obs = rng.normal(size=4).astype(np.float32)
        nxt = rng.normal(size=4).astype(np.float32)
        a, r = int(rng.integers(2)), float(rng.normal())
        term, trunc = ends.get(t, (False, False))
        jo = jb.append(obs, a, r, nxt, term, trunc, aux=t)
        to = tb.append(obs, a, r, nxt, term, trunc, aux=t)
        assert len(to) == len(jo)
        for x, y in zip(to, jo):
            np.testing.assert_array_equal(x.obs, y.obs)
            np.testing.assert_array_equal(x.next_obs, y.next_obs)
            assert (x.action, x.reward, x.discount, x.aux, x.span) == \
                (y.action, y.reward, y.discount, y.aux, y.span)
        emitted += len(to)
    # each step of the two ended 7-step episodes emits once; the
    # unfinished 4-step tail has emitted its 2 full windows
    assert emitted == 7 + 7 + 2
