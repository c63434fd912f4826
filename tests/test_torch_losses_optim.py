"""The port's DQN loss (ape_x_dqn_tpu_torch/ops/losses.py) and its
clip+Adam optimizer (runtime/learner.py ClipAdam) against the JAX
package's loss under jax.value_and_grad and optax's chain, on the same
converted weights and numpy-seeded batches, in float32.

Tolerances: loss, |TD| and grads to 1e-5 relative / 1e-6 absolute (the
same float32 arithmetic, summed in another order); params after 10
optimizer steps to 1e-6 absolute (elementwise arithmetic written with
optax's formulas; the bias corrections' float32 powers may differ in
the last bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ape_x_dqn_tpu.configs import LearnerConfig, NetworkConfig
from ape_x_dqn_tpu.envs.base import EnvSpec as JaxEnvSpec
from ape_x_dqn_tpu.models import build_network as jax_build_network
from ape_x_dqn_tpu.ops import losses as jlosses
from ape_x_dqn_tpu.ops import value_rescale as jvr
from ape_x_dqn_tpu.runtime.learner import make_optimizer as jax_optimizer
from ape_x_dqn_tpu_torch.configs import NetworkConfig as TNetworkConfig
from ape_x_dqn_tpu_torch.envs.base import EnvSpec
from ape_x_dqn_tpu_torch.models import build_network
from ape_x_dqn_tpu_torch.models.convert import from_flax
from ape_x_dqn_tpu_torch.ops import losses as tlosses
from ape_x_dqn_tpu_torch.ops import value_rescale as tvr
from ape_x_dqn_tpu_torch.runtime.learner import ClipAdam, make_optimizer

SHAPE = (42, 42, 4)
NET = dict(kind="nature_cnn", cnn_channels=(4, 8, 8), torso_dense=32,
           compute_dtype="float32")


def _nets():
    jnet = jax_build_network(NetworkConfig(**NET),
                             JaxEnvSpec(SHAPE, np.dtype(np.uint8), True, 6))
    params = jnet.init(jax.random.key(0), jnp.zeros((1, *SHAPE), jnp.uint8))
    target = jax.tree.map(lambda p: p * 0.9, params)
    nets = []
    for p in (params, target):
        t = build_network(TNetworkConfig(**NET),
                          EnvSpec(SHAPE, np.dtype(np.uint8), True, 6))
        t.load_state_dict(from_flax(jax.tree.map(np.asarray, p)))
        nets.append(t)
    return jnet, params, target, nets[0], nets[1]


def _batch(b=16, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.integers(0, 255, (b, *SHAPE)).astype(np.uint8),
        actions=rng.integers(0, 6, b).astype(np.int32),
        rewards=rng.normal(size=b).astype(np.float32),
        next_obs=rng.integers(0, 255, (b, *SHAPE)).astype(np.uint8),
        discounts=np.where(rng.uniform(size=b) < 0.2, 0.0,
                           0.99 ** 3).astype(np.float32)), \
        rng.uniform(0.2, 1.0, b).astype(np.float32)


@pytest.mark.parametrize("double,rescale", [(True, False), (False, False),
                                            (True, True)])
def test_dqn_loss_td_and_grads_match_jax(double, rescale):
    jnet, params, target, tnet, ttarget = _nets()
    np_batch, is_w = _batch()
    jloss_fn = jlosses.make_dqn_loss(jnet.apply, double=double,
                                     huber_delta=1.0, rescale=rescale)
    (jl, jaux), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(
        params, target,
        jlosses.TransitionBatch(**{k: jnp.asarray(v)
                                   for k, v in np_batch.items()}),
        jnp.asarray(is_w))
    tloss_fn = tlosses.make_dqn_loss(double=double, huber_delta=1.0,
                                     rescale=rescale)
    tl, taux = tloss_fn(tnet, ttarget,
                        tlosses.TransitionBatch(
                            **{k: torch.from_numpy(v)
                               for k, v in np_batch.items()}),
                        torch.from_numpy(is_w))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for key in ("td_abs", "loss_per_sample", "q_mean", "td_mean", "q_max",
                "target_q_mean", "q_gap"):
        np.testing.assert_allclose(taux[key].numpy(), np.asarray(jaux[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    want = from_flax(jax.tree.map(np.asarray, jgrads))
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_huber_and_value_rescale_match_jax():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    for delta in (0.5, 1.0, 2.0):
        np.testing.assert_allclose(
            tlosses.huber(torch.from_numpy(x), delta).numpy(),
            np.asarray(jlosses.huber(jnp.asarray(x), delta)), rtol=1e-6)
    # h_inv divides a difference of two nearly equal float32 square
    # roots by 2e-3, which magnifies their last-bit rounding ~1e3-fold
    for f, g, rtol in ((tvr.h, jvr.h, 1e-5), (tvr.h_inv, jvr.h_inv, 1e-4)):
        np.testing.assert_allclose(f(torch.from_numpy(x)).numpy(),
                                   np.asarray(g(jnp.asarray(x))),
                                   rtol=rtol, atol=1e-6)


def test_clip_adam_matches_optax_over_10_steps():
    """Gradients alternate between below and above the clip norm, so
    both branches of optax's clip_by_global_norm are held."""
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (3,), (2, 4, 4)]
    lcfg = LearnerConfig(lr=1e-2, adam_eps=1.5e-7, max_grad_norm=1.0)
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jp = [jnp.asarray(p) for p in params]
    jopt = jax_optimizer(lcfg)
    jstate = jopt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    topt = make_optimizer(lcfg)
    assert isinstance(topt, ClipAdam)
    tstate = topt.init(tp)
    clipped = 0
    for step in range(10):
        scale = 0.05 if step % 2 else 3.0
        grads = [(scale * rng.normal(size=s)).astype(np.float32)
                 for s in shapes]
        clipped += float(optax.global_norm(grads)) >= lcfg.max_grad_norm
        upd, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate,
                                  jp)
        jp = optax.apply_updates(jp, upd)
        tupd = topt.update([torch.from_numpy(g) for g in grads], tstate)
        for p, u in zip(tp, tupd):
            p.add_(u)
    assert 0 < clipped < 10
    assert tstate.count == 10
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
