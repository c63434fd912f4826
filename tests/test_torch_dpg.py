"""The port's Ape-X DPG slice against the JAX package's: `soft_update`
(models/base.py), the actor and critic through `from_flax`
(models/dpg.py, models/convert.py), the critic and policy losses
(ops/losses.py), `DPGLearner` (runtime/dpg_learner.py), the native
pendulum (envs/control.py) and the continuous actors (runtime/actor.py,
runtime/vector_actor.py).

Tolerances (float32 throughout): the soft update 1e-7 absolute (lerp
and the original's (1 - tau) t + tau p round differently, by a few
float32 ulps of values below 1); network outputs 1e-6 absolute; losses
and gradients 1e-5 relative plus 1e-7 absolute (summed in another
order); the learner's params and targets 2e-6 absolute after six
grad-steps, the tree 1e-5 relative, the metrics 1e-4 relative, as for
the DQN learner (tests/test_torch_learner.py). The pendulum, driven by
the same actions, and the actors, fed the same query function, ship
bitwise-equal streams (priorities to rtol 1e-6, as in
tests/test_torch_actors.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ape_x_dqn_tpu import configs as jcfgs
from ape_x_dqn_tpu.comm.transport import LoopbackTransport as JaxTransport
from ape_x_dqn_tpu.envs.control import PendulumSwingUp as JaxPendulum
from ape_x_dqn_tpu.models import DPGActor as JaxActorNet
from ape_x_dqn_tpu.models import DPGCritic as JaxCriticNet
from ape_x_dqn_tpu.models.base import soft_update as jax_soft_update
from ape_x_dqn_tpu.ops.losses import ContinuousBatch as JaxBatch
from ape_x_dqn_tpu.ops.losses import make_dpg_losses as jax_make_dpg_losses
from ape_x_dqn_tpu.replay.prioritized import PrioritizedReplay as JaxPER
from ape_x_dqn_tpu.runtime.actor import ContinuousActor as JaxContActor
from ape_x_dqn_tpu.runtime.dpg_learner import DPGLearner as JaxDPGLearner
from ape_x_dqn_tpu.runtime.dpg_learner import (
    continuous_item_spec as jax_item_spec)
from ape_x_dqn_tpu.runtime.vector_actor import (
    ContinuousVectorActor as JaxContVectorActor)
from ape_x_dqn_tpu_torch import configs as tcfgs
from ape_x_dqn_tpu_torch.comm.transport import LoopbackTransport
from ape_x_dqn_tpu_torch.envs.control import PendulumSwingUp
from ape_x_dqn_tpu_torch.models import DPGActor, DPGCritic, soft_update
from ape_x_dqn_tpu_torch.models.convert import from_flax
from ape_x_dqn_tpu_torch.ops.losses import ContinuousBatch, make_dpg_losses
from ape_x_dqn_tpu_torch.replay.prioritized import PrioritizedReplay
from ape_x_dqn_tpu_torch.runtime.actor import ContinuousActor
from ape_x_dqn_tpu_torch.runtime.dpg_learner import (DPGLearner,
                                                     continuous_item_spec)
from ape_x_dqn_tpu_torch.runtime.vector_actor import ContinuousVectorActor
from ape_x_dqn_tpu_torch.utils.rng import component_generator

HIDDEN = (16, 16)


def _flax_pair(obs_dim=3, action_dim=1, low=-2.0, high=2.0):
    ja = JaxActorNet(action_dim=action_dim, action_low=low,
                     action_high=high, hidden=HIDDEN)
    jc = JaxCriticNet(hidden=HIDDEN)
    o0 = jnp.zeros((1, obs_dim), jnp.float32)
    a0 = jnp.zeros((1, action_dim), jnp.float32)
    pa = ja.init(jax.random.key(0), o0)
    pc = jc.init(jax.random.key(1), o0, a0)
    ta = DPGActor(obs_dim, action_dim, low, high, HIDDEN)
    tc = DPGCritic(obs_dim, action_dim, HIDDEN)
    ta.load_state_dict(from_flax(jax.tree.map(np.asarray, pa)))
    tc.load_state_dict(from_flax(jax.tree.map(np.asarray, pc)))
    return ja, jc, pa, pc, ta, tc


def _batch(rng, b=32, obs_dim=3, action_dim=1):
    x = {"obs": rng.normal(size=(b, obs_dim)).astype(np.float32),
         "action": rng.uniform(-2, 2, (b, action_dim)).astype(np.float32),
         "reward": rng.normal(size=b).astype(np.float32),
         "next_obs": rng.normal(size=(b, obs_dim)).astype(np.float32),
         "discount": np.full(b, 0.95, np.float32)}
    return x


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def test_soft_update_matches_jax():
    rng = np.random.default_rng(0)
    _, _, _, pc, _, tc = _flax_pair()
    online = jax.tree.map(
        lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32), pc)
    want = jax_soft_update(pc, online, 0.05)
    tonline = DPGCritic(4 - 1, 1, HIDDEN)
    tonline.load_state_dict(from_flax(jax.tree.map(np.asarray, online)))
    ptr = next(tc.parameters()).data_ptr()
    assert soft_update(tc, tonline, 0.05) is tc
    assert next(tc.parameters()).data_ptr() == ptr       # in place
    want = from_flax(jax.tree.map(np.asarray, want))
    for k, v in tc.state_dict().items():
        _close(v.numpy(), want[k].numpy(), 0, 1e-7, k)


def test_actor_and_critic_through_from_flax_match_jax():
    rng = np.random.default_rng(1)
    ja, jc, pa, pc, ta, tc = _flax_pair()
    obs = rng.normal(size=(64, 3)).astype(np.float32) * 3
    act = rng.uniform(-2, 2, (64, 1)).astype(np.float32)
    a_j = ja.apply(pa, jnp.asarray(obs))
    q_j = jc.apply(pc, jnp.asarray(obs), jnp.asarray(act))
    with torch.no_grad():
        a_t = ta(torch.from_numpy(obs))
        q_t = tc(torch.from_numpy(obs), torch.from_numpy(act))
    assert a_t.shape == (64, 1) and q_t.shape == (64,)
    assert a_t.dtype == q_t.dtype == torch.float32
    assert float(a_t.abs().max()) <= 2.0
    _close(a_t.numpy(), a_j, 0, 1e-6)
    _close(q_t.numpy(), q_j, 0, 1e-6)


def test_dpg_losses_values_and_gradients_match_jax():
    rng = np.random.default_rng(2)
    ja, jc, pa, pc, ta, tc = _flax_pair()
    # distinct targets: perturbed copies of the online nets
    pa_t = jax.tree.map(lambda p: p * 0.9, pa)
    pc_t = jax.tree.map(lambda p: p * 1.1, pc)
    ta_t = DPGActor(3, 1, -2.0, 2.0, HIDDEN)
    tc_t = DPGCritic(3, 1, HIDDEN)
    ta_t.load_state_dict(from_flax(jax.tree.map(np.asarray, pa_t)))
    tc_t.load_state_dict(from_flax(jax.tree.map(np.asarray, pc_t)))
    x = _batch(rng)
    w = rng.uniform(0.2, 1.0, 32).astype(np.float32)
    jb = JaxBatch(*(jnp.asarray(x[k]) for k in
                    ("obs", "action", "reward", "next_obs", "discount")))
    tb = ContinuousBatch(*(torch.from_numpy(x[k]) for k in
                           ("obs", "action", "reward", "next_obs",
                            "discount")))
    j_closs, j_ploss = jax_make_dpg_losses(ja.apply, jc.apply)
    t_closs, t_ploss = make_dpg_losses()

    (jl, jaux), jg = jax.value_and_grad(j_closs, has_aux=True)(
        pc, pc_t, pa_t, jb, jnp.asarray(w))
    tl, taux = t_closs(tc, tc_t, ta_t, tb, torch.from_numpy(w))
    names = [k for k, _ in tc.named_parameters()]
    tg = torch.autograd.grad(tl, list(tc.parameters()))
    _close(tl.item(), float(jl), 1e-5, 1e-7, "critic loss")
    for k in jaux:
        _close(taux[k].numpy(), jaux[k], 1e-5, 1e-7, k)
    jg = from_flax(jax.tree.map(np.asarray, jg))
    for k, g in zip(names, tg):
        _close(g.numpy(), jg[k].numpy(), 1e-5, 1e-7, f"critic grad {k}")

    (jl, jaux), jg = jax.value_and_grad(j_ploss, has_aux=True)(pa, pc, jb)
    tl, taux = t_ploss(ta, tc, tb)
    names = [k for k, _ in ta.named_parameters()]
    tg = torch.autograd.grad(tl, list(ta.parameters()))
    _close(tl.item(), float(jl), 1e-5, 1e-7, "policy loss")
    _close(taux["a_abs_mean"].item(), float(jaux["a_abs_mean"]), 1e-5, 1e-7)
    jg = from_flax(jax.tree.map(np.asarray, jg))
    for k, g in zip(names, tg):
        _close(g.numpy(), jg[k].numpy(), 1e-5, 1e-7, f"policy grad {k}")


def _noise_chain(rng, n, b):
    out = []
    for _ in range(n):
        rng, sk = jax.random.split(rng)
        out.append(torch.from_numpy(np.array(jax.random.uniform(sk, (b,)))))
    return out


def test_dpg_learner_matches_jax_over_six_steps():
    """Two train_step calls, then train_many(4), from identical params,
    replay contents and JAX's own key chain: critic update, policy
    ascent on the updated critic, both soft updates and the write-back
    in the original's order."""
    lkw = dict(batch_size=32, n_step=5, critic_lr=1e-3, policy_lr=1e-4,
               tau=0.05)
    ja, jc, pa, pc, ta, tc = _flax_pair()
    jr = JaxPER(256)
    jl = JaxDPGLearner(ja.apply, jc.apply, jr, jcfgs.LearnerConfig(**lkw))
    js = jl.init(pa, pc, jr.init(jax_item_spec((3,), np.float32, 1)),
                 jax.random.key(2))
    tr = PrioritizedReplay(256, device="cpu")
    tl = DPGLearner(tr, tcfgs.LearnerConfig(**lkw))
    ts = tl.init(ta, tc, tr.init(continuous_item_spec((3,), np.float32, 1)),
                 component_generator(0, "learner"))
    x = _batch(np.random.default_rng(3), b=64)
    td = np.random.default_rng(4).uniform(0.1, 2.0, 64).astype(np.float32)
    js = jl.add(js, {k: jnp.asarray(v) for k, v in x.items()},
                jnp.asarray(td))
    tl.add(ts, {k: torch.from_numpy(v) for k, v in x.items()},
           torch.from_numpy(td))

    noise = _noise_chain(js.rng, 6, 32)
    for i in range(2):
        js, jm = jl.train_step(js)
        ts, tm = tl.train_step(ts, noise[i])
    js, jm = jl.train_many(js, 4)
    ts, tm = tl.train_many(ts, 4, noise[2:])

    assert ts.step == int(js.step) == 6
    for name, got, want in (("actor", ts.actor, js.actor_params),
                            ("critic", ts.critic, js.critic_params),
                            ("target_actor", ts.target_actor,
                             js.target_actor),
                            ("target_critic", ts.target_critic,
                             js.target_critic)):
        want = from_flax(jax.tree.map(np.asarray, want))
        for k, v in got.state_dict().items():
            _close(v.numpy(), want[k].numpy(), 0, 2e-6, f"{name}.{k}")
    _close(ts.replay.tree.numpy(), js.replay.tree, 1e-5, 1e-6, "tree")
    for k in ("loss", "policy_loss", "q_mean", "td_abs_mean", "a_abs_mean"):
        _close(tm[k].item(), float(jm[k]), 1e-4, 0, k)
    assert set(tm["diag"]) == set(jm["diag"])
    for k, v in tm["diag"].items():
        _close(v.item(), float(jm["diag"][k]), 1e-4, 1e-7, k)
    assert int(ts.actor_opt.count) == int(ts.critic_opt.count) == 6
    published = tl.publish_params(ts)
    assert {k.split(".")[0] for k in published} == {"actor", "critic"}
    for k, v in ts.critic.state_dict().items():
        assert torch.equal(published[f"critic.{k}"], v)
        assert published[f"critic.{k}"].data_ptr() != v.data_ptr()


def test_dpg_learner_rejects_k_batch_and_prefetch():
    tr = PrioritizedReplay(64, device="cpu")
    for kw in (dict(sample_chunk=4), dict(sample_prefetch=True)):
        try:
            DPGLearner(tr, tcfgs.LearnerConfig(**kw))
        except ValueError as e:
            assert "DPG learner" in str(e)
        else:
            raise AssertionError(f"{kw} was accepted")


def test_pendulum_steps_like_the_original():
    """One seed, the same clipped random torques (some beyond the
    limit), 450 steps across two episode ends: obs, rewards, dones and
    infos bitwise."""
    t, j = PendulumSwingUp(seed=7), JaxPendulum(seed=7)
    assert dataclasses.asdict(t.spec) == dataclasses.asdict(j.spec)
    np.testing.assert_array_equal(t.reset(), j.reset())
    rng = np.random.default_rng(0)
    ends = 0
    for _ in range(450):
        a = rng.uniform(-3, 3, 1).astype(np.float32)
        to, tr, td, ti = t.step(a)
        jo, jr, jd, ji = j.step(a)
        np.testing.assert_array_equal(to, jo)
        assert (tr, td, ti) == (jr, jd, ji)
        if td:
            ends += 1
            np.testing.assert_array_equal(t.reset(), j.reset())
    assert ends == 2


def _dpg_cfg(pkg, num_actors=1, envs_per_actor=1):
    return pkg.get_config("apex_dpg").replace(
        env=pkg.EnvConfig(id="pendulum", kind="control"),
        network=pkg.NetworkConfig(kind="dpg", dpg_hidden=(64, 64),
                                  compute_dtype="float32"),
        actors=pkg.ActorConfig(num_actors=num_actors,
                               envs_per_actor=envs_per_actor,
                               ingest_batch=32, noise_sigma=0.15))


def _query(obs, n=None):
    """A fixed, obs-dependent {a, q} reply, the same for both
    packages."""
    x = np.asarray(obs, np.float32).reshape(1 if n is None else n, -1)
    out = {"a": np.tanh(x[:, :1] + x[:, 2:3]).astype(np.float32),
           "q": (x.sum(axis=1) * 0.5).astype(np.float32)}
    return {k: v[0] for k, v in out.items()} if n is None else out


def _drain(transport) -> list[dict]:
    out = []
    while (b := transport.recv_experience(timeout=0.01)) is not None:
        out.append(b)
    return out


def _same_streams(got, want):
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            if key == "priorities":
                np.testing.assert_allclose(g[key], w[key], rtol=1e-6)
            else:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
                assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype


def test_continuous_actor_ships_the_original_stream():
    tt, jt = LoopbackTransport(), JaxTransport()
    t = ContinuousActor(_dpg_cfg(tcfgs), 0, _query, tt)
    j = JaxContActor(_dpg_cfg(jcfgs), 0, _query, jt)
    assert t.run(max_frames=450) == j.run(max_frames=450) == 450
    got, want = _drain(tt), _drain(jt)
    _same_streams(got, want)
    b0 = got[0]
    assert b0["obs"].shape[1:] == (3,) and b0["action"].shape[1:] == (1,)
    assert b0["action"].dtype == np.float32
    assert np.std(b0["action"]) > 0.01          # exploration noise
    assert (np.abs(b0["action"]) <= 2.0).all()
    assert sum(b["frames"] for b in got) == 450


def test_continuous_vector_actor_ships_the_original_stream():
    tt, jt = LoopbackTransport(), JaxTransport()
    t = ContinuousVectorActor(_dpg_cfg(tcfgs, 2, 4), 1, _query, tt)
    j = JaxContVectorActor(_dpg_cfg(jcfgs, 2, 4), 1, _query, jt)
    assert t.run(max_frames=1000) == j.run(max_frames=1000)
    _same_streams(_drain(tt), _drain(jt))
