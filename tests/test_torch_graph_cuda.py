"""The learners' captured CUDA graphs against their eager step bodies, on
the card (runtime/step_graph.py). Every test here is marked `cuda` and
skips without a card: a CUDA graph has no CPU mode. The file imports no
JAX, so on a machine with the card it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_graph_cuda.py

Each case builds one learner twice from the same seeds, once with
`capture` on (a warm-up step, then a capture and replays) and once with
it off (the same bodies, eager, on the card), and drives both through
the same five steps (macro-steps at K=4) from the same generator
stream, with an `add` between steps that moves the replay's fill and
write cursor. After the first and the fifth step the params, the
target params, Adam's moments and count, the sum-tree, the cursors and
every metric must be bitwise equal. Two sources of run-to-run
difference that have nothing to do with the graph are switched off in
this file, so that even two eager runs agree: cuDNN runs its
deterministic algorithms (its default convolution backward may sum in
another order from run to run), and PyTorch its deterministic
algorithms (``torch.use_deterministic_algorithms``, warnings only),
so the priority write-back of a K=4 macro-step that drew one leaf in
two chunks, with two different |TD|s, keeps the later one on every
run (the default scatter keeps either, unordered; ROADMAP Queue C). A
leaf that straddles a stratum boundary can be drawn by both strata
however full the replay is."""

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch.configs import (LearnerConfig, NetworkConfig,
                                         ReplayConfig)
from ape_x_dqn_tpu_torch.envs.base import EnvSpec
from ape_x_dqn_tpu_torch.models import (ApeXLSTMQNet, build_network,
                                        init_params)
from ape_x_dqn_tpu_torch.ops import frame_gather as tfg
from ape_x_dqn_tpu_torch.replay.frame_ring import FrameRingReplay
from ape_x_dqn_tpu_torch.replay.prioritized import PrioritizedReplay
from ape_x_dqn_tpu_torch.replay.sequence import sequence_item_spec
from ape_x_dqn_tpu_torch.runtime.dpg_learner import (DPGLearner,
                                                     continuous_item_spec)
from ape_x_dqn_tpu_torch.runtime.learner import (DQNLearner,
                                                 transition_item_spec)
from ape_x_dqn_tpu_torch.runtime.sequence_learner import SequenceLearner
from ape_x_dqn_tpu_torch.runtime.step_graph import pack_metrics
from ape_x_dqn_tpu_torch.utils.rng import component_generator


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import: every xdist worker
    must collect the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a captured CUDA graph has no CPU "
                    "mode")
    old = (torch.backends.cudnn.deterministic,
           torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = old[0]
    torch.use_deterministic_algorithms(old[1], warn_only=old[2])


def _net(module, seed="net_init"):
    return init_params(module, component_generator(0, seed))


# -- the four learners, each with its per-step add ----------------------


def _frame_ring(dev):
    obs = (42, 42, 4)
    spec = EnvSpec(obs, np.dtype(np.uint8), True, 6)
    lcfg = LearnerConfig(batch_size=32, sample_chunk=4, target_sync_every=3)
    net = _net(build_network(NetworkConfig(
        kind="nature_cnn", cnn_channels=(8, 16, 16), torso_dense=64,
        compute_dtype="bfloat16"), spec)).to(dev)
    replay = FrameRingReplay(4096, 16, 3, obs, device=dev)
    learner = DQNLearner(replay, lcfg)
    state = learner.init(net, replay.init(),
                         component_generator(0, "learner", device=dev))

    def add(state, rng, g):
        f, g = replay.F, 2 * g
        items = {
            "seg_frames": torch.from_numpy(rng.integers(
                0, 255, (g, f, 42, 42)).astype(np.uint8)),
            "action": torch.from_numpy(
                rng.integers(0, 6, (g, 16)).astype(np.int32)),
            "reward": torch.from_numpy(
                rng.normal(size=(g, 16)).astype(np.float32)),
            "discount": torch.full((g, 16), 0.97),
            "next_off": torch.full((g, 16), 3, dtype=torch.int32),
        }
        td = torch.from_numpy(rng.uniform(0.1, 2.0, (g, 16)).astype(
            np.float32))
        return learner.add(state, items, td)

    return learner, state, add, 4


def _flat(dev):
    obs = (32, 32, 4)
    spec = EnvSpec(obs, np.dtype(np.uint8), True, 6)
    lcfg = LearnerConfig(batch_size=32, sample_chunk=4, target_sync_every=3)
    net = _net(build_network(NetworkConfig(
        kind="mlp", mlp_hidden=(64,), dueling=True,
        compute_dtype="float32"), spec)).to(dev)
    replay = PrioritizedReplay(4096, device=dev,
                               item_spec=transition_item_spec(obs, np.uint8))
    learner = DQNLearner(replay, lcfg)
    state = learner.init(net, replay.init(),
                         component_generator(0, "learner", device=dev))

    def add(state, rng, g):
        b = 32 * g
        items = {
            "obs": rng.integers(0, 255, (b, *obs)).astype(np.uint8),
            "action": rng.integers(0, 6, b).astype(np.int32),
            "reward": rng.normal(size=b).astype(np.float32),
            "next_obs": rng.integers(0, 255, (b, *obs)).astype(np.uint8),
            "discount": np.full(b, 0.97, np.float32),
        }
        td = rng.uniform(0.1, 2.0, b).astype(np.float32)
        return learner.add(state, {k: torch.from_numpy(v)
                                   for k, v in items.items()},
                           torch.from_numpy(td))

    return learner, state, add, 4


def _sequence(dev):
    seq, lstm, frames = 8, 32, (36, 36, 4)
    lcfg = LearnerConfig(batch_size=8, sample_chunk=4, n_step=2,
                         value_rescale=True, target_sync_every=3)
    rcfg = ReplayConfig(kind="sequence", seq_length=seq, burn_in=2)
    net = _net(ApeXLSTMQNet(frames, num_actions=2, lstm_size=lstm,
                            dense=32, compute_dtype="bfloat16")).to(dev)
    replay = PrioritizedReplay(1024, device=dev)
    learner = SequenceLearner(replay, lcfg, rcfg)
    state = learner.init(net, replay.init(sequence_item_spec(
        frames, np.uint8, seq, lstm, frame_mode=True)),
        component_generator(0, "learner", device=dev))

    def add(state, rng, g):
        n = 8 * g
        h, w, stack = frames
        items = {
            "seq_frames": rng.integers(
                0, 255, (n, seq + stack - 1, h, w)).astype(np.uint8),
            "actions": rng.integers(0, 2, (n, seq)).astype(np.int32),
            "rewards": rng.normal(size=(n, seq)).astype(np.float32),
            "terminals": np.zeros((n, seq), np.float32),
            "mask": np.ones((n, seq), np.float32),
            "init_c": (0.3 * rng.normal(size=(n, lstm))).astype(np.float32),
            "init_h": (0.3 * rng.normal(size=(n, lstm))).astype(np.float32),
        }
        td = (rng.random(n) + 0.1).astype(np.float32)
        return learner.add(state, {k: torch.from_numpy(v)
                                   for k, v in items.items()},
                           torch.from_numpy(td))

    return learner, state, add, 4


def _dpg(dev):
    lcfg = LearnerConfig(batch_size=64, n_step=5, critic_lr=1e-3,
                         policy_lr=1e-4, tau=0.05)
    spec = EnvSpec((3,), np.dtype(np.float32), False, action_dim=1,
                   action_low=-2.0, action_high=2.0)
    actor, critic = build_network(NetworkConfig(
        kind="dpg", dpg_hidden=(300, 200), compute_dtype="float32"), spec)
    actor = _net(actor, "actor_init").to(dev)
    critic = _net(critic, "critic_init").to(dev)
    replay = PrioritizedReplay(4096, device=dev,
                               item_spec=continuous_item_spec((3,),
                                                              np.float32, 1))
    learner = DPGLearner(replay, lcfg)
    state = learner.init(actor, critic, replay.init(),
                         component_generator(0, "learner", device=dev))

    def add(state, rng, g):
        b = 64 * g
        items = {
            "obs": rng.normal(size=(b, 3)).astype(np.float32),
            "action": rng.uniform(-2, 2, (b, 1)).astype(np.float32),
            "reward": rng.normal(size=b).astype(np.float32),
            "next_obs": rng.normal(size=(b, 3)).astype(np.float32),
            "discount": np.full(b, 0.95, np.float32),
        }
        td = rng.uniform(0.1, 2.0, b).astype(np.float32)
        return learner.add(state, {k: torch.from_numpy(v)
                                   for k, v in items.items()},
                           torch.from_numpy(td))

    return learner, state, add, 1


# name: (make(dev) -> (learner, state, add, K), gather launches per draw:
# one a side for transitions, one for a sequence draw, none for DPG's
# vector observations)
CASES = {"frame_ring": (_frame_ring, 2), "flat": (_flat, 2),
         "sequence": (_sequence, 1), "dpg": (_dpg, 0)}


def _snapshot(state, metrics) -> dict:
    nets = ({"actor": state.actor, "critic": state.critic,
             "target_actor": state.target_actor,
             "target_critic": state.target_critic}
            if hasattr(state, "actor")
            else {"net": state.net, "target": state.target_net})
    opts = ({"actor_opt": state.actor_opt, "critic_opt": state.critic_opt}
            if hasattr(state, "actor") else {"opt": state.opt_state})
    snap = {f"{name}.{k}": v.detach().clone()
            for name, net in nets.items()
            for k, v in net.state_dict().items()}
    for name, opt in opts.items():
        snap[f"{name}.count"] = opt.count.clone()
        for i, (mu, nu) in enumerate(zip(opt.mu, opt.nu)):
            snap[f"{name}.mu{i}"] = mu.clone()
            snap[f"{name}.nu{i}"] = nu.clone()
    snap["tree"] = state.replay.tree.clone()
    snap["cursors"] = torch.tensor([state.replay.pos, state.replay.size,
                                    int(state.replay.pos_dev),
                                    int(state.replay.size_dev)])
    snap["metrics"] = pack_metrics(metrics)[0].clone()
    return snap


def _run(make, dev, capture: bool):
    learner, state, add, k = make(dev)
    learner.capture = capture
    rng = np.random.default_rng(0)
    state = add(state, rng, 64 if k > 1 else 8)
    tfg.gather_rows.launches = 0
    snaps, sizes = [], []
    for i in range(5):
        if k > 1:
            state, m = learner.train_step_k(state, k)
        else:
            state, m = learner.train_step(state)
        if i in (0, 4):
            snaps.append(_snapshot(state, m))
        sizes.append(state.replay.size)
        state = add(state, rng, 1)   # moves the fill and the cursor
    torch.cuda.synchronize()
    return learner, state, snaps, sizes, tfg.gather_rows.launches


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_graph_replays_match_the_eager_body(cuda_device, case):
    make, per_draw = CASES[case]
    gl, gs, gsnaps, sizes, g_launches = _run(make, cuda_device, True)
    el, es, esnaps, _, e_launches = _run(make, cuda_device, False)
    assert len(set(sizes)) == 5, sizes   # every replay saw another fill
    key = ("k", 4) if case != "dpg" else "step"
    assert gl.graphed and gl.step_graphs()[key].captured
    assert not el.graphed and not el.step_graphs()[key].captured
    for after, g, e in zip((1, 5), gsnaps, esnaps):
        assert g.keys() == e.keys()
        for name in g:
            assert torch.equal(g[name], e[name]), \
                f"{case}: {name} differs after {after} steps"
    # gather launches, the four replays included
    assert g_launches == e_launches == 5 * per_draw
    assert gs.step == es.step == 5 * (4 if case != "dpg" else 1)


@pytest.mark.cuda
def test_a_capture_that_fails_raises(cuda_device):
    """A body that synchronises with the host cannot be captured: the
    endpoint raises on the capturing call, and nothing falls back to
    the eager body."""
    learner, state, add, k = _flat(cuda_device)
    state = add(state, np.random.default_rng(0), 8)

    class Syncing(DQNLearner):
        def _sgd_step(self, state, items, is_w):
            td, m = super()._sgd_step(state, items, is_w)
            m["host"] = torch.tensor(float(m["loss"]), device=td.device)
            return td, m

    learner.__class__ = Syncing
    state, _ = learner.train_step_k(state, k)        # the eager warm-up
    with pytest.raises(RuntimeError):
        learner.train_step_k(state, k)               # the capture
