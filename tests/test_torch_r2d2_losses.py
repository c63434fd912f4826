"""The port's R2D2 sequence loss (ape_x_dqn_tpu_torch/ops/losses.py:
``nstep_targets_in_sequence``, ``make_r2d2_loss``) against the JAX
package's, on numpy-seeded sequences and converted weights.

Tolerances: the n-step targets are float32 arithmetic of the same
formula in the same order, held to 1e-6 relative (hand-computed cases)
and 1e-5 relative with 1e-5 absolute (random raw cases). Through the
value rescaling they get 1e-4 relative: ``h_inv`` takes
``(sqrt(1 + 4 eps (|x| + 1 + eps)) - 1) / (2 eps)`` with eps = 1e-3,
which turns one float32 rounding of the square root into ~500 times
as much relative error before it is squared. The loss, aux and
gradients of an 8-sequence batch of a float32 recurrent net agree to
1e-5 relative with 1e-6 absolute (sums taken in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.models import ApeXLSTMQNet as JaxLSTMQNet
from ape_x_dqn_tpu.ops.losses import SequenceBatch as JaxSequenceBatch
from ape_x_dqn_tpu.ops.losses import make_r2d2_loss as jax_make_r2d2_loss
from ape_x_dqn_tpu.ops.losses import (
    nstep_targets_in_sequence as jax_nstep_targets)
from ape_x_dqn_tpu_torch.models import ApeXLSTMQNet
from ape_x_dqn_tpu_torch.models.convert import from_flax
from ape_x_dqn_tpu_torch.ops.losses import (SequenceBatch, make_r2d2_loss,
                                            nstep_targets_in_sequence)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _targets(rewards, terminals, boot, mask, n_step, gamma, rescale=False):
    target, valid = nstep_targets_in_sequence(
        _t(rewards), _t(terminals), _t(boot), _t(mask), n_step, gamma,
        rescale)
    return target.numpy(), valid.numpy()


# -- hand-computed cases (those of tests/test_losses.py) -------------------


def test_nstep_targets_hand_computed():
    target, valid = _targets([[1.0, 2.0, 4.0, 8.0]], np.zeros((1, 4)),
                             [[10.0, 20.0, 30.0, 40.0]], np.ones((1, 4)),
                             n_step=2, gamma=0.5)
    # t=0: 1 + 0.5*2 + 0.25*boot[2]; t=1: 2 + 0.5*4 + 0.25*boot[3]
    np.testing.assert_allclose(target[0, :2], [9.5, 14.0], rtol=1e-6)
    np.testing.assert_allclose(valid[0], [1, 1, 0, 0])


def test_nstep_targets_respect_terminals():
    target, _ = _targets([[1.0, 5.0, 7.0]], [[1.0, 0.0, 0.0]],
                         np.full((1, 3), 100.0), np.ones((1, 3)),
                         n_step=2, gamma=0.9)
    np.testing.assert_allclose(target[0, 0], 1.0, rtol=1e-6)


def test_nstep_targets_never_bootstrap_from_padding():
    _, valid = _targets([[1.0, 1.0, 1.0, 0.0]], np.zeros((1, 4)),
                        np.full((1, 4), 100.0), [[1.0, 1.0, 1.0, 0.0]],
                        n_step=1, gamma=0.9)
    np.testing.assert_allclose(valid[0], [1.0, 1.0, 0.0, 0.0])


def test_nstep_targets_terminal_window_valid_at_sequence_end():
    target, valid = _targets([[1.0, 2.0, 4.0, 8.0]], [[0.0, 0.0, 0.0, 1.0]],
                             np.full((1, 4), 100.0), np.ones((1, 4)),
                             n_step=2, gamma=0.5)
    np.testing.assert_allclose(target[0, 2:], [8.0, 8.0], rtol=1e-6)
    np.testing.assert_allclose(valid[0], [1, 1, 1, 1])


def test_nstep_targets_terminal_then_padding():
    target, valid = _targets([[1.0, 2.0, 4.0, 0.0]], [[0.0, 0.0, 1.0, 0.0]],
                             np.full((1, 4), 100.0), [[1.0, 1.0, 1.0, 0.0]],
                             n_step=2, gamma=1.0)
    np.testing.assert_allclose(target[0, :3], [103.0, 6.0, 4.0], rtol=1e-6)
    np.testing.assert_allclose(valid[0], [1, 1, 1, 0])


def test_nstep_targets_no_wraparound_leak():
    """A terminal at t=0 must not leak, through the roll's wrap, into
    windows hanging off the tail."""
    target, valid = _targets([[1.0, 2.0, 4.0, 8.0]], [[1.0, 0.0, 0.0, 0.0]],
                             np.zeros((1, 4)), np.ones((1, 4)),
                             n_step=2, gamma=1.0)
    np.testing.assert_allclose(target[0], [1.0, 6.0, 12.0, 8.0], rtol=1e-6)
    np.testing.assert_allclose(valid[0], [1, 1, 0, 0])


# -- against the JAX package -----------------------------------------------


def _random_sequences(b, length, seed):
    rng = np.random.default_rng(seed)
    rewards = rng.normal(size=(b, length)).astype(np.float32)
    terminals = (rng.random((b, length)) < 0.08).astype(np.float32)
    mask = np.ones((b, length), np.float32)
    for i in range(b):  # padded tails of several lengths
        mask[i, length - int(rng.integers(0, length // 2)):] = 0.0
    boot = rng.normal(size=(b, length)).astype(np.float32) * 3.0
    return rewards, terminals * mask, mask, boot


@pytest.mark.parametrize("rescale", [False, True],
                         ids=["raw", "rescaled"])
@pytest.mark.parametrize("n_step", [1, 3, 5])
def test_nstep_targets_match_jax(n_step, rescale):
    rewards, terminals, mask, boot = _random_sequences(6, 20, n_step)
    jt, jv = jax_nstep_targets(jnp.asarray(rewards), jnp.asarray(terminals),
                               jnp.asarray(boot), jnp.asarray(mask),
                               n_step, 0.97, rescale)
    tt, tv = _targets(rewards, terminals, boot, mask, n_step, 0.97,
                      rescale)
    np.testing.assert_array_equal(tv, np.asarray(jv))
    np.testing.assert_allclose(tt * tv, np.asarray(jt) * tv,
                               rtol=1e-4 if rescale else 1e-5, atol=1e-5)


def _loss_inputs(b, length, lstm, seed):
    rng = np.random.default_rng(seed)
    rewards, terminals, mask, _ = _random_sequences(b, length, seed)
    return {
        "obs": rng.normal(size=(b, length, 2)).astype(np.float32),
        "actions": rng.integers(0, 3, (b, length)).astype(np.int32),
        "rewards": rewards, "terminals": terminals, "mask": mask,
        "init_c": (0.3 * rng.normal(size=(b, lstm))).astype(np.float32),
        "init_h": (0.3 * rng.normal(size=(b, lstm))).astype(np.float32),
        "is_w": rng.uniform(0.2, 1.0, b).astype(np.float32),
    }


@pytest.mark.parametrize("double,burn_in", [(True, 4), (False, 4),
                                            (True, 0)],
                         ids=["double", "max", "no-burn-in"])
def test_r2d2_loss_aux_and_grads_match_jax(double, burn_in):
    """loss, every aux entry and the gradient of every parameter against
    ``jax.value_and_grad`` of the original loss, online and target nets
    differing (the target is the online net one perturbation away)."""
    lstm, b, length = 8, 8, 12
    kw = dict(num_actions=3, lstm_size=lstm, dense=16,
              compute_dtype="float32", mlp_torso=True)
    jnet = JaxLSTMQNet(**kw)
    z = jnp.zeros((1, lstm), jnp.float32)
    params = jnet.init(jax.random.key(0), jnp.zeros((1, 1, 2)), (z, z))
    target_params = jax.tree.map(
        lambda p: p + 0.05 * jax.random.normal(jax.random.key(1), p.shape),
        params)
    x = _loss_inputs(b, length, lstm, seed=7)
    loss_kw = dict(burn_in=burn_in, n_step=3, gamma=0.97, double=double,
                   rescale=True, priority_eta=0.9)
    jloss = jax_make_r2d2_loss(lambda p, o, s: jnet.apply(p, o, s),
                               **loss_kw)
    jbatch = JaxSequenceBatch(
        obs=jnp.asarray(x["obs"]), actions=jnp.asarray(x["actions"]),
        rewards=jnp.asarray(x["rewards"]),
        terminals=jnp.asarray(x["terminals"]), mask=jnp.asarray(x["mask"]),
        init_state=(jnp.asarray(x["init_c"]), jnp.asarray(x["init_h"])))
    (jl, jaux), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params, target_params, jbatch, jnp.asarray(x["is_w"]))

    net, target = ApeXLSTMQNet((2,), **kw), ApeXLSTMQNet((2,), **kw)
    net.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    target.load_state_dict(from_flax(jax.tree.map(np.asarray,
                                                  target_params)))
    target.requires_grad_(False)
    batch = SequenceBatch(
        obs=torch.from_numpy(x["obs"]),
        actions=torch.from_numpy(x["actions"]),
        rewards=torch.from_numpy(x["rewards"]),
        terminals=torch.from_numpy(x["terminals"]),
        mask=torch.from_numpy(x["mask"]),
        init_state=(torch.from_numpy(x["init_c"]),
                    torch.from_numpy(x["init_h"])))
    loss, aux = make_r2d2_loss(**loss_kw)(net, target, batch,
                                          torch.from_numpy(x["is_w"]))
    names = [n for n, _ in net.named_parameters()]
    grads = torch.autograd.grad(loss, list(net.parameters()))

    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert set(aux) == set(jaux)
    for k, v in aux.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jaux[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    want = from_flax(jax.tree.map(np.asarray, jgrads))
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    # the target net takes no gradient
    assert all(p.grad is None for p in target.parameters())
