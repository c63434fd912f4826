"""The port's recurrent Q-network (ape_x_dqn_tpu_torch/models/lstm_q.py)
and its weight conversion against the JAX package's flax
``ApeXLSTMQNet``, on the same numpy-seeded observations, states and
converted weights, for both torsos (one dense layer over vectors, the
Nature-CNN over 52x52x4 frames, whose 3x3 last conv output makes the
HWC/CHW flatten permutation matter).

Tolerances: float32 compute agrees to 1e-5 (sums taken in another
order). bfloat16 compute rounds every layer's output and every gate
operation to 8 mantissa bits, in different places in the two
frameworks; over a 40-step unroll (the preset's burn-in) the Q values
and the returned state are held to 3e-2 absolute at these O(0.1-1)
magnitudes, the band of the bf16 Nature-CNN test in
tests/test_torch_models.py."""

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
from ape_x_dqn_tpu_torch.models import (ApeXLSTMQNet, build_network,
                                        init_params, param_count)
from ape_x_dqn_tpu_torch.models.convert import from_flax
from ape_x_dqn_tpu_torch.utils.rng import component_generator

TORSOS = {"mlp": (4,), "cnn": (52, 52, 4)}


def _pair(torso: str, dtype: str, dueling: bool = True, lstm: int = 16):
    """(flax net, params, port net with converted weights) built from
    the same NetworkConfig by each package's build_network."""
    shape = TORSOS[torso]
    odt = np.float32 if torso == "mlp" else np.uint8
    kw = dict(kind="lstm_q", lstm_size=lstm, torso_dense=32,
              dueling=dueling, compute_dtype=dtype)
    jnet = jax_build_network(NetworkConfig(**kw),
                             JaxEnvSpec(shape, np.dtype(odt), True, 3))
    z = jnp.zeros((1, lstm), jnp.float32)
    params = jnet.init(jax.random.key(0), jnp.zeros((1, 1, *shape), odt),
                       (z, z))
    tnet = build_network(TNetworkConfig(**kw),
                         EnvSpec(shape, np.dtype(odt), True, 3))
    tnet.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    return jnet, params, tnet


def _inputs(torso: str, b: int, t: int, lstm: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    shape = TORSOS[torso]
    if torso == "mlp":
        obs = rng.normal(size=(b, t, *shape)).astype(np.float32)
    else:
        obs = rng.integers(0, 255, (b, t, *shape)).astype(np.uint8)
    c = (0.5 * rng.normal(size=(b, lstm))).astype(np.float32)
    h = (0.5 * rng.normal(size=(b, lstm))).astype(np.float32)
    return obs, c, h


def _port(tnet, obs, c, h, step=False):
    fn = tnet.step if step else tnet
    with torch.no_grad():
        q, (c2, h2) = fn(torch.from_numpy(obs),
                         (torch.from_numpy(c), torch.from_numpy(h)))
    return q.numpy(), c2.numpy(), h2.numpy()


@pytest.mark.parametrize("dueling", [True, False],
                         ids=["dueling", "plain"])
@pytest.mark.parametrize("torso", list(TORSOS))
def test_unroll_and_step_fp32_parity(torso, dueling):
    jnet, params, tnet = _pair(torso, "float32", dueling)
    obs, c, h = _inputs(torso, 3, 6, 16)
    qj, (cj, hj) = jnet.apply(params, jnp.asarray(obs),
                              (jnp.asarray(c), jnp.asarray(h)))
    qt, ct, ht = _port(tnet, obs, c, h)
    assert qt.shape == (3, 6, 3) and qt.dtype == np.float32
    assert ct.dtype == np.float32 and ht.dtype == np.float32
    for got, want in ((qt, qj), (ct, cj), (ht, hj)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    qj1, (cj1, hj1) = jnet.apply(params, jnp.asarray(obs[:, 0]),
                                 (jnp.asarray(c), jnp.asarray(h)),
                                 method=jnet.step)
    qt1, ct1, ht1 = _port(tnet, obs[:, 0], c, h, step=True)
    for got, want in ((qt1, qj1), (ct1, cj1), (ht1, hj1)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert param_count(tnet) == jax_param_count(params)


@pytest.mark.parametrize("torso", list(TORSOS))
def test_unroll_matches_stepwise(torso):
    """The full-sequence unroll == repeated single steps (the port's
    own two entry points, as tests/test_models.py holds the
    original's)."""
    _, _, tnet = _pair(torso, "float32")
    obs, c, h = _inputs(torso, 2, 5, 16, seed=1)
    q_seq, c_seq, h_seq = _port(tnet, obs, c, h)
    qs = []
    for i in range(obs.shape[1]):
        q, c, h = _port(tnet, obs[:, i], c, h, step=True)
        qs.append(q)
    np.testing.assert_allclose(q_seq, np.stack(qs, axis=1), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(c_seq, c, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h_seq, h, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("torso", list(TORSOS))
def test_bf16_carry_over_a_burn_in_length_unroll(torso):
    """bf16 compute over 40 steps stays inside the stated band of the
    original: the carry is cast once and kept bf16 across the steps."""
    jnet, params, tnet = _pair(torso, "bfloat16", lstm=32)
    obs, c, h = _inputs(torso, 2, 40, 32, seed=2)
    qj, (cj, hj) = jnet.apply(params, jnp.asarray(obs),
                              (jnp.asarray(c), jnp.asarray(h)))
    qt, ct, ht = _port(tnet, obs, c, h)
    assert ct.dtype == np.float32
    for got, want in ((qt, qj), (ct, cj), (ht, hj)):
        np.testing.assert_allclose(got, np.asarray(want), atol=3e-2)


def test_init_params_lstm_is_seeded_and_orthogonal():
    """The port's own seeded init: LeCun-normal input kernels,
    orthogonal recurrent kernels per gate, zero biases; the same
    generator seed gives the same weights."""
    spec = EnvSpec((84, 84, 4), np.dtype(np.uint8), True, 18)
    nets = [init_params(build_network(TNetworkConfig(kind="lstm_q"), spec),
                        component_generator(3, "net_init"))
            for _ in range(2)]
    for a, b in zip(nets[0].parameters(), nets[1].parameters()):
        assert torch.equal(a, b)
    cell = nets[0].lstm
    eye = torch.eye(512)
    for gate in cell.weight_hh.detach().view(4, 512, 512):
        torch.testing.assert_close(gate @ gate.T, eye, atol=1e-4, rtol=0)
    w = cell.weight_ih.detach()                      # fan_in 512
    assert abs(float(w.std()) - 512 ** -0.5) < 0.05 * 512 ** -0.5
    assert float(cell.bias_hh.detach().abs().max()) == 0.0
    assert isinstance(nets[0], ApeXLSTMQNet) and not nets[0].mlp_torso
    # Nature torso 1,684,128 + LSTM 4 * (512 + 512 + 1) * 512 + dueling
    # head 512 * 19 + 19
    assert param_count(nets[0]) == 1_684_128 + 2_099_200 + 9_747
