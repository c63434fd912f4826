"""The tp column split across distinct devices
(parallel/tensor_parallel.py), on the CPU over ``cpu:0`` and ``cpu:1``:
the split `torso_out` of the Nature CNN and a 40-step unroll of the
split LSTM (over vector observations, its dense torso split too), and
their gradients, against the same nets with their layers whole and
against flax (the original's nets on the same params, models/
convert.py).

Tolerances: float32 1e-5 (absolute and relative), bfloat16 3e-2 (the
band of tests/test_torch_r2d2_models.py: bf16 rounds each layer in
different places in the two frameworks). The split and the whole port
nets differ only in where the gathers sit, so they agree bitwise on the
CPU here; the tests hold them to the stated bands, not to bitwise."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.configs import NetworkConfig as JNetworkConfig
from ape_x_dqn_tpu.envs.base import EnvSpec as JEnvSpec
from ape_x_dqn_tpu.models import build_network as jax_build_network
from ape_x_dqn_tpu_torch.configs import NetworkConfig
from ape_x_dqn_tpu_torch.envs.base import EnvSpec
from ape_x_dqn_tpu_torch.models import build_network
from ape_x_dqn_tpu_torch.models.convert import from_flax
from ape_x_dqn_tpu_torch.parallel.tensor_parallel import (
    ColumnSplitLinear, ColumnSplitLSTMCell, load_whole, split_module,
    whole_tensors)

DEVS = ["cpu:0", "cpu:1"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
CNN = dict(kind="nature_cnn", cnn_channels=(8, 16, 16), torso_dense=32,
           dueling=True)
# the LSTM net over vector observations (its 128-wide dense torso): the
# four gates of 32 units split at min_dim 16, with no conv to leave whole
LSTM = dict(kind="lstm_q", lstm_size=32, dueling=True)


def _nets(cfg, obs, dtype, min_dim, seq):
    """(flax net, flax params, whole port net, split port net) on the
    same params; `min_dim` leaves the conv biases whole."""
    cfg = dict(cfg, compute_dtype=dtype)
    odt = np.dtype(np.float32 if len(obs) == 1 else np.uint8)
    jnet = jax_build_network(JNetworkConfig(**cfg),
                             JEnvSpec(obs, odt, True, 5))
    x = jnp.zeros((1, 1, *obs) if seq else (1, *obs), odt)
    if seq:
        z = jnp.zeros((1, cfg["lstm_size"]), jnp.float32)
        params = jnet.init(jax.random.key(0), x, (z, z))
    else:
        params = jnet.init(jax.random.key(0), x)
    whole = build_network(NetworkConfig(**cfg), EnvSpec(obs, odt, True, 5))
    whole.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    split = copy.deepcopy(whole)
    names = split_module(split, DEVS, min_dim=min_dim)
    return jnet, params, whole, split, names


def _grads(net) -> dict:
    return whole_tensors(net, [p.grad for p in net.parameters()])


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_torso_out_and_its_gradient(dtype):
    obs_shape = (52, 52, 4)        # a 3x3 last conv: the flatten order
    jnet, params, whole, split, names = _nets(CNN, obs_shape, dtype, 32,
                                              False)
    assert names == ["torso.torso_out"]
    layer = split.torso.torso_out
    assert isinstance(layer, ColumnSplitLinear)
    assert [w.shape for w in layer.weight] == [(16, 144), (16, 144)]
    tol = TOL[dtype]
    obs = np.random.default_rng(0).integers(
        0, 255, (6, *obs_shape)).astype(np.uint8)
    x = torch.from_numpy(obs)
    q_whole, q_split = whole(x), split(x)
    _close(q_split.detach(), q_whole.detach(), tol, "q split vs whole")

    def flax_loss(p):
        q = jnet.apply(p, jnp.asarray(obs))
        return q.sum(), q

    (_, qj), gj = jax.value_and_grad(flax_loss, has_aux=True)(params)
    _close(q_split.detach(), qj, tol, "q split vs flax")
    # the gradient of sum(q): per whole parameter, pieces joined
    q_whole.sum().backward()
    q_split.sum().backward()
    gj = from_flax(jax.tree.map(np.asarray, gj))
    for k, g in _grads(split).items():
        _close(g, _grads(whole)[k], tol, f"grad {k} split vs whole")
        _close(g, gj[k], tol, f"grad {k} split vs flax")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_lstm_over_a_40_step_unroll(dtype):
    obs_shape, t, b = (8,), 40, 3
    jnet, params, whole, split, names = _nets(LSTM, obs_shape, dtype, 16,
                                              True)
    assert names == ["torso", "lstm"]
    cell = split.lstm
    assert isinstance(cell, ColumnSplitLSTMCell)
    # four strided gate blocks of 16 hidden units per device
    assert [w.shape for w in cell.weight_hh] == [(64, 32), (64, 32)]
    tol = TOL[dtype]
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(b, t, *obs_shape)).astype(np.float32)
    c = (0.5 * rng.normal(size=(b, 32))).astype(np.float32)
    h = (0.5 * rng.normal(size=(b, 32))).astype(np.float32)
    state = (torch.from_numpy(c), torch.from_numpy(h))
    x = torch.from_numpy(obs)
    (qw, (cw, hw)), (qs, (cs, hs)) = whole(x, state), split(x, state)

    def flax_loss(p):
        q, (cc, hh) = jnet.apply(p, jnp.asarray(obs),
                                 (jnp.asarray(c), jnp.asarray(h)))
        return q.sum() + cc.sum() + hh.sum(), (q, cc, hh)

    (_, (qj, cj, hj)), gj = jax.value_and_grad(flax_loss,
                                               has_aux=True)(params)
    for got, w_port, w_flax, what in ((qs, qw, qj, "q"), (cs, cw, cj, "c"),
                                      (hs, hw, hj, "h")):
        assert got.dtype == torch.float32
        _close(got.detach(), w_port.detach(), tol, f"{what} split vs whole")
        _close(got.detach(), w_flax, tol, f"{what} split vs flax")

    def loss_port(q, cc, hh):
        return q.sum() + cc.sum() + hh.sum()

    loss_port(qw, cw, hw).backward()
    loss_port(qs, cs, hs).backward()
    gj = from_flax(jax.tree.map(np.asarray, gj))
    gw = _grads(whole)
    for k, g in _grads(split).items():
        scale = max(1.0, float(gw[k].abs().max()))
        _close(g / scale, gw[k] / scale, tol, f"grad {k} split vs whole")
        _close(g / scale, gj[k] / scale, tol, f"grad {k} split vs flax")
    # one step of the acting entry point through the split cell
    q1s, (c1s, h1s) = split.step(x[:, 0], state)
    q1w, (c1w, h1w) = whole.step(x[:, 0], state)
    for got, want in ((q1s, q1w), (c1s, c1w), (h1s, h1w)):
        _close(got.detach(), want.detach(), tol, "step split vs whole")


def test_no_device_holds_a_whole_split_kernel():
    """Each piece lives on its device with 1/tp of the rows; the whole
    tensors come back bitwise, and load_whole writes pieces in place."""
    _, _, whole, split, _ = _nets(LSTM, (8,), "float32", 16, True)
    params = list(split.parameters())
    sd = whole.state_dict()
    for name, mod in (("torso", split.torso), ("lstm", split.lstm)):
        assert mod.devices == [torch.device(d) for d in DEVS]
        for key in mod.kinds:
            pieces = list(getattr(mod, key))
            assert len(pieces) == 2
            for piece in pieces:
                assert piece.shape[0] * 2 == sd[f"{name}.{key}"].shape[0]
    got = whole_tensors(split, params)
    assert list(got) == list(whole.state_dict())
    for k, v in whole.state_dict().items():
        assert torch.equal(got[k], v), k
    ptrs = [p.data_ptr() for p in params]
    doubled = {k: 2 * v for k, v in whole.state_dict().items()}
    load_whole(split, params, doubled)
    assert [p.data_ptr() for p in params] == ptrs
    for k, v in whole_tensors(split, params).items():
        assert torch.equal(v, doubled[k]), k
