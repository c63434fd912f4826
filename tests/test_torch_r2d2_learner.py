"""The port's R2D2 learner (ape_x_dqn_tpu_torch/runtime/sequence_learner.py)
against the JAX package's `SequenceLearner`, from identical converted
params, identical replay contents and JAX's own stratification draws
(the split chain of keys the JAX learner walks, turned into the uniform
noise the port takes): 8 grad-steps of train_many over the exact path
(K=1), the K-batch relaxation (K=4) and the double-buffered sampler,
with a float32 dueling LSTM net whose dense torso reads vector obs (the
masked-CartPole shape). tests/test_torch_r2d2_learner_frames.py holds
the frame-mode sequences, the remainder path and the target sync.

Tolerances, as in tests/test_torch_learner.py: params and target
params 2e-6 absolute, loss and diagnostics 1e-4 relative, step counts
exact; the tree 1e-5 relative plus 1e-6 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.configs import LearnerConfig, ReplayConfig
from ape_x_dqn_tpu.models import ApeXLSTMQNet as JaxLSTMQNet
from ape_x_dqn_tpu.replay.prioritized import PrioritizedReplay as JaxPER
from ape_x_dqn_tpu.replay.sequence import (
    sequence_item_spec as jax_item_spec)
from ape_x_dqn_tpu.runtime.sequence_learner import (
    SequenceLearner as JaxSequenceLearner)
from ape_x_dqn_tpu_torch.configs import LearnerConfig as TLearnerConfig
from ape_x_dqn_tpu_torch.configs import ReplayConfig as TReplayConfig
from ape_x_dqn_tpu_torch.models import ApeXLSTMQNet
from ape_x_dqn_tpu_torch.models.convert import from_flax
from ape_x_dqn_tpu_torch.replay.prioritized import PrioritizedReplay
from ape_x_dqn_tpu_torch.replay.sequence import sequence_item_spec
from ape_x_dqn_tpu_torch.runtime.sequence_learner import SequenceLearner
from ape_x_dqn_tpu_torch.utils.rng import component_generator

SEQ, LSTM, CAP, N_ITEMS = 6, 8, 128, 64
LCFG = dict(batch_size=8, n_step=2, value_rescale=True,
            target_sync_every=3, lr=1e-3)
RCFG = dict(kind="sequence", seq_length=SEQ, burn_in=2)
FRAMES = (36, 36, 4)


def _items(frames: bool, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    n = N_ITEMS
    if frames:
        h, w, stack = FRAMES
        obs = {"seq_frames": rng.integers(
            0, 255, (n, SEQ + stack - 1, h, w)).astype(np.uint8)}
    else:
        obs = {"obs": rng.normal(size=(n, SEQ, 2)).astype(np.float32)}
    mask = np.ones((n, SEQ), np.float32)
    mask[::5, SEQ - 2:] = 0.0                      # some padded tails
    return {**obs,
            "actions": rng.integers(0, 2, (n, SEQ)).astype(np.int32),
            "rewards": rng.normal(size=(n, SEQ)).astype(np.float32),
            "terminals": np.zeros((n, SEQ), np.float32),
            "mask": mask,
            "init_c": (0.3 * rng.normal(size=(n, LSTM))).astype(np.float32),
            "init_h": (0.3 * rng.normal(size=(n, LSTM))).astype(np.float32),
            "td": (rng.random(n) + 0.1).astype(np.float32)}


def _learners(frames: bool, **lkw):
    obs_shape = FRAMES if frames else (2,)
    odt = np.uint8 if frames else np.float32
    kw = dict(num_actions=2, lstm_size=LSTM, dense=16,
              compute_dtype="float32", mlp_torso=not frames)
    jnet = JaxLSTMQNet(**kw)
    z = jnp.zeros((1, LSTM), jnp.float32)
    params = jax.jit(jnet.init)(jax.random.key(0),
                                jnp.zeros((1, 1, *obs_shape), odt), (z, z))
    lcfg = {**LCFG, **lkw}
    jr = JaxPER(CAP)
    jl = JaxSequenceLearner(lambda p, o, s: jnet.apply(p, o, s), jr,
                            LearnerConfig(**lcfg), ReplayConfig(**RCFG))
    js = jl.init(params, jr.init(jax_item_spec(obs_shape, odt, SEQ, LSTM,
                                               frame_mode=frames)),
                 jax.random.key(1))

    tnet = ApeXLSTMQNet(obs_shape, **kw)
    tnet.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    tr = PrioritizedReplay(CAP, device="cpu")
    tl = SequenceLearner(tr, TLearnerConfig(**lcfg), TReplayConfig(**RCFG))
    ts = tl.init(tnet, tr.init(sequence_item_spec(
        obs_shape, odt, SEQ, LSTM, frame_mode=frames)),
        component_generator(0, "learner"))

    items = _items(frames)
    td = items.pop("td")
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
    for k in ("loss", "q_mean", "td_abs_mean", "valid_frac", "grad_norm"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    assert set(tm["diag"]) == set(jm["diag"])
    for k, v in tm["diag"].items():
        np.testing.assert_allclose(v.item(), float(jm["diag"][k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)


# (learner overrides, grad-steps, draw sizes in units of batch_size)
CASES = {
    "k1": (dict(sample_chunk=1), 8, [1] * 8),
    "k4": (dict(sample_chunk=4), 8, [4, 4]),
    # a prologue draw, then one draw ahead per macro-step
    "k4_prefetch": (dict(sample_chunk=4, sample_prefetch=True), 8,
                    [4, 4, 4]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_many_matches_jax(case):
    lkw, n, draws = CASES[case]
    jl, js, tl, ts = _learners(frames=False, **lkw)
    tree0 = ts.replay.tree.clone()
    noise = _noise_chain(js.rng, [d * LCFG["batch_size"] for d in draws])
    js, jm = jl.train_many(js, n)
    ts, tm = tl.train_many(ts, n, noise)
    _compare(js, jm, ts, tm)
    assert ts.step == n
    assert not torch.equal(ts.replay.tree, tree0)  # priorities written
