"""The port's double-buffered learner path (ape_x_dqn_tpu_torch/runtime/
learner.py: sample_k, learn_k and train_many with sample_prefetch) over
the flat prioritized replay, against the JAX package's, from identical
converted params, identical replay contents and JAX's own draws: the
test rebuilds the split chain of `sk` keys the JAX learner walks
(singles, the prologue, then one draw per macro-step) and feeds the
port each key's uniform noise. A dueling MLP over 32x32x4 uint8 obs
(4096 bytes, the smallest leaf the packer packs), so the packed pixel
leaves go through the row gather.

Tolerances, as in test_torch_learner.py: params 2e-6 absolute, loss and
diagnostics 1e-4 relative, step counts exact; the tree 1e-5 relative
plus 1e-6 absolute (a leaf holds (|td| + 1e-6)^0.6, whose slope grows
without bound near td = 0, so a float32-level TD difference on a small
|TD| moves it by more than 1e-5 of its value)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ape_x_dqn_tpu.configs import LearnerConfig, NetworkConfig
from ape_x_dqn_tpu.envs.base import EnvSpec as JaxEnvSpec
from ape_x_dqn_tpu.models import build_network as jax_build_network
from ape_x_dqn_tpu.replay.prioritized import PrioritizedReplay as JaxPER
from ape_x_dqn_tpu.runtime.learner import DQNLearner as JaxLearner
from ape_x_dqn_tpu.runtime.learner import (
    transition_item_spec as jax_item_spec)
from ape_x_dqn_tpu_torch.configs import LearnerConfig as TLearnerConfig
from ape_x_dqn_tpu_torch.configs import NetworkConfig as TNetworkConfig
from ape_x_dqn_tpu_torch.envs.base import EnvSpec
from ape_x_dqn_tpu_torch.models import build_network
from ape_x_dqn_tpu_torch.models.convert import from_flax
from ape_x_dqn_tpu_torch.replay.prioritized import PrioritizedReplay
from ape_x_dqn_tpu_torch.runtime.learner import (DQNLearner,
                                                 transition_item_spec)
from ape_x_dqn_tpu_torch.utils.rng import component_generator

OBS = (32, 32, 4)
NET = dict(kind="mlp", mlp_hidden=(16,), dueling=True,
           compute_dtype="float32")
LCFG = dict(batch_size=8, sample_chunk=4, sample_prefetch=True,
            target_sync_every=3, lr=1e-3)
CAP = 128


def _learners():
    jspec = JaxEnvSpec(OBS, np.dtype(np.uint8), True, 6)
    jnet = jax_build_network(NetworkConfig(**NET), jspec)
    params = jnet.init(jax.random.key(0), jnp.zeros((1, *OBS), jnp.uint8))
    jr = JaxPER(CAP, item_spec=jax_item_spec(OBS, np.uint8))
    jl = JaxLearner(jnet.apply, jr, LearnerConfig(**LCFG))
    js = jl.init(params, jr.init(), jax.random.key(3))

    tnet = build_network(TNetworkConfig(**NET),
                         EnvSpec(OBS, np.dtype(np.uint8), True, 6))
    tnet.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    tr = PrioritizedReplay(CAP, device="cpu",
                           item_spec=transition_item_spec(OBS, np.uint8))
    tl = DQNLearner(tr, TLearnerConfig(**LCFG))
    ts = tl.init(tnet, tr.init(), component_generator(0, "learner"))

    rng = np.random.default_rng(0)
    for _ in range(2):
        b = 50
        items = {
            "obs": rng.integers(0, 255, (b, *OBS)).astype(np.uint8),
            "action": rng.integers(0, 6, b).astype(np.int32),
            "reward": rng.normal(size=b).astype(np.float32),
            "next_obs": rng.integers(0, 255, (b, *OBS)).astype(np.uint8),
            "discount": np.full(b, 0.97, np.float32),
        }
        td = rng.uniform(0.1, 2.0, b).astype(np.float32)
        js = jl.add(js, {k: jnp.asarray(v) for k, v in items.items()},
                    jnp.asarray(td))
        tl.add(ts, {k: torch.from_numpy(v) for k, v in items.items()},
               torch.from_numpy(td))
    return jl, js, tl, ts


def _noise_chain(rng, batches):
    """JAX's draws, in order: each draw splits the carried key."""
    out = []
    for b in batches:
        rng, sk = jax.random.split(rng)
        out.append(torch.from_numpy(np.array(jax.random.uniform(sk, (b,)))))
    return out


def _compare(js, jm, ts, tm):
    assert ts.step == int(js.step)
    for name, got, want in (("params", ts.net, js.params),
                            ("target", ts.target_net, js.target_params)):
        want = from_flax(jax.tree.map(np.asarray, want))
        for k, v in got.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                       atol=2e-6, err_msg=f"{name}.{k}")
    np.testing.assert_allclose(ts.replay.tree.numpy(),
                               np.asarray(js.replay.tree), rtol=1e-5,
                               atol=1e-6)
    for k in ("loss", "q_mean", "td_abs_mean", "grad_norm"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    assert set(tm["diag"]) == set(jm["diag"])
    for k, v in tm["diag"].items():
        np.testing.assert_allclose(v.item(), float(jm["diag"][k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)


def test_train_many_prefetch_matches_jax():
    """train_many(13) with K=4 and sample_prefetch: 1 remainder single,
    a prologue draw, then 3 macro-steps that each draw the next sample
    before learning on the pending one; the last draw is discarded."""
    jl, js, tl, ts = _learners()
    b, k = LCFG["batch_size"], LCFG["sample_chunk"]
    noise = _noise_chain(js.rng, [b] + [k * b] * 4)
    js, jm = jl.train_many(js, 13)
    ts, tm = tl.train_many(ts, 13, noise)
    _compare(js, jm, ts, tm)
    assert ts.step == 13


def test_sample_k_then_learn_k_matches_one_train_step_k():
    """The split dispatch against the JAX package's fused macro-step;
    sample_k itself changes nothing but the generator."""
    jl, js, tl, ts = _learners()
    k = LCFG["sample_chunk"]
    noise, = _noise_chain(js.rng, [k * LCFG["batch_size"]])
    js, jm = jl.train_step_k(js, k)
    tree0 = ts.replay.tree.clone()
    sample = tl.sample_k(ts, k, noise)
    assert torch.equal(ts.replay.tree, tree0) and ts.step == 0
    items_k, idx_k, is_w_k, pri_k = sample
    assert items_k["obs"].shape == (k, LCFG["batch_size"], *OBS)
    ts, tm = tl.learn_k(ts, sample, k)
    _compare(js, jm, ts, tm)
