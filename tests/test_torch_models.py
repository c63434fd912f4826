"""The PyTorch port's Q-networks and flax weight converter
(ape_x_dqn_tpu_torch/models/) against the JAX package's flax modules,
on the same numpy-seeded frames and converted weights.

Tolerances: float32 compute agrees to 1e-5 (sums taken in another
order); bfloat16 compute rounds each layer's inputs and outputs to 8
mantissa bits, in different places in the two frameworks, so Q values
are held to 3e-2 absolute at these O(0.1-1) magnitudes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.configs import NetworkConfig
from ape_x_dqn_tpu.envs.base import EnvSpec as JaxEnvSpec
from ape_x_dqn_tpu.models import build_network as jax_build_network
from ape_x_dqn_tpu.models.base import param_count as jax_param_count
from ape_x_dqn_tpu_torch.configs import NetworkConfig as TNetworkConfig
from ape_x_dqn_tpu_torch.envs.base import EnvSpec
from ape_x_dqn_tpu_torch.models import (build_network, init_params,
                                        param_count)
from ape_x_dqn_tpu_torch.models.convert import dense_weight, from_flax
from ape_x_dqn_tpu_torch.utils.rng import component_generator

NARROW = dict(cnn_channels=(4, 8, 8), torso_dense=32)


def _pair(kind: str, obs_shape, num_actions: int, obs_dtype, **net_kw):
    """(flax net, its numpy params, port net with converted weights)."""
    jspec = JaxEnvSpec(obs_shape, np.dtype(obs_dtype), True, num_actions)
    tspec = EnvSpec(obs_shape, np.dtype(obs_dtype), True, num_actions)
    jnet = jax_build_network(NetworkConfig(kind=kind, **net_kw), jspec)
    params = jnet.init(jax.random.key(0),
                       jnp.zeros((1, *obs_shape), obs_dtype))
    np_params = jax.tree.map(np.asarray, params)
    tnet = build_network(TNetworkConfig(kind=kind, **net_kw), tspec)
    tnet.load_state_dict(from_flax(np_params))
    return jnet, params, np_params, tnet


def _frames(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 255, shape) \
        .astype(np.uint8)


def _q(jnet, params, tnet, obs):
    qj = np.asarray(jnet.apply(params, jnp.asarray(obs)))
    with torch.no_grad():
        qt = tnet(torch.from_numpy(obs)).numpy()
    return qj, qt


@pytest.mark.parametrize("hw,dueling", [((42, 42), True),
                                        ((52, 52), True),
                                        ((52, 52), False)])
def test_nature_dqn_fp32_parity(hw, dueling):
    shape = (*hw, 4)
    jnet, params, _, tnet = _pair("nature_cnn", shape, 6, np.uint8,
                                  dueling=dueling,
                                  compute_dtype="float32", **NARROW)
    qj, qt = _q(jnet, params, tnet, _frames((5, *shape)))
    assert qt.dtype == np.float32 and qt.shape == (5, 6)
    np.testing.assert_allclose(qt, qj, rtol=1e-5, atol=1e-5)
    assert param_count(tnet) == jax_param_count(params)


def test_nature_dqn_bf16_parity():
    shape = (42, 42, 4)
    jnet, params, _, tnet = _pair("nature_cnn", shape, 6, np.uint8,
                                  compute_dtype="bfloat16", **NARROW)
    qj, qt = _q(jnet, params, tnet, _frames((5, *shape), seed=1))
    assert qt.dtype == np.float32
    np.testing.assert_allclose(qt, qj, atol=3e-2)


def test_hwc_flatten_permutation_is_load_bearing():
    """At 52x52 the last conv output is 3x3x8, so flax's HWC flatten
    and the port's CHW flatten differ: converting `torso_out` with a
    plain transpose (no permutation) must break parity, while the
    converter's permutation restores it."""
    shape = (52, 52, 4)
    jnet, params, np_params, tnet = _pair(
        "nature_cnn", shape, 6, np.uint8, compute_dtype="float32",
        **NARROW)
    obs = _frames((5, *shape), seed=2)
    qj, qt = _q(jnet, params, tnet, obs)
    np.testing.assert_allclose(qt, qj, rtol=1e-5, atol=1e-5)
    wrong = from_flax(np_params)
    wrong["torso.torso_out.weight"] = dense_weight(
        np_params["params"]["torso"]["torso_out"]["kernel"])
    tnet.load_state_dict(wrong)
    _, q_wrong = _q(jnet, params, tnet, obs)
    assert np.abs(q_wrong - qj).max() > 1e-3


@pytest.mark.parametrize("dueling", [False, True])
def test_mlp_qnet_fp32_parity(dueling):
    jnet, params, _, tnet = _pair("mlp", (4,), 3, np.float32,
                                  mlp_hidden=(16, 16), dueling=dueling,
                                  compute_dtype="float32")
    obs = np.random.default_rng(3).normal(size=(7, 4)).astype(np.float32)
    qj, qt = _q(jnet, params, tnet, obs)
    np.testing.assert_allclose(qt, qj, rtol=1e-5, atol=1e-6)


def test_init_params_is_seeded_lecun_normal():
    spec = EnvSpec((84, 84, 4), np.dtype(np.uint8), True, 18)
    nets = [init_params(build_network(TNetworkConfig(kind="nature_cnn"),
                                      spec),
                        component_generator(7, "net_init"))
            for _ in range(2)]
    for a, b in zip(nets[0].parameters(), nets[1].parameters()):
        assert torch.equal(a, b)
    w = nets[0].torso.torso_out.weight.detach()   # fan_in 3136
    assert abs(float(w.std()) - 3136 ** -0.5) < 0.05 * 3136 ** -0.5
    assert float(nets[0].torso.torso_out.bias.detach().abs().max()) == 0.0
    assert param_count(nets[0]) == 1_693_875
