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
however full the replay is.

The dp-sharded learners (parallel/dist_learner.py) are cases of the
same tests, on their presets' dp=4 x tp=2 mesh of the card repeated:
the step graphs, the lockstep add graph of (g, dp, chunk) blocks across
a wrap, and the per-shard evict and add_at graphs of the swap."""

import gc

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch.configs import (LearnerConfig, NetworkConfig,
                                         ReplayConfig)
from ape_x_dqn_tpu_torch.envs.base import EnvSpec
from ape_x_dqn_tpu_torch.models import (ApeXLSTMQNet, build_network,
                                        init_params)
from ape_x_dqn_tpu_torch.ops import frame_gather as tfg
from ape_x_dqn_tpu_torch.parallel.dist_learner import (DistDQNLearner,
                                                       DistSequenceLearner)
from ape_x_dqn_tpu_torch.parallel.mesh import make_mesh
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
    # free whatever this test left in reference cycles now, not at a
    # collection that may fall inside a later test's capture (destroying
    # a graph there invalidates the capture); the graphs themselves
    # reach their learner through a weak reference
    gc.collect()
    torch.cuda.synchronize()


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


def _dist_frame_ring(dev, exchange=None):
    """The frame ring's DistDQNLearner on a dp=4 x tp=2 mesh of the card
    (4 shards of 1024 transitions), lockstep adds of [4, g, ...]; with
    an `exchange`, its multi-process form (tests/test_torch_multihost_
    cuda.py)."""
    dp, obs = 4, (42, 42, 4)
    spec = EnvSpec(obs, np.dtype(np.uint8), True, 6)
    lcfg = LearnerConfig(batch_size=32, sample_chunk=4, target_sync_every=3)
    net = _net(build_network(NetworkConfig(
        kind="nature_cnn", cnn_channels=(8, 16, 16), torso_dense=64,
        compute_dtype="bfloat16"), spec)).to(dev)
    replay = FrameRingReplay(1024, 16, 3, obs, device=dev)
    learner = DistDQNLearner(replay, lcfg,
                             make_mesh(dp=dp, tp=2, devices=[dev] * 8),
                             exchange=exchange)
    state = learner.init(net, None,
                         component_generator(0, "learner", device=dev))

    def add(state, rng, g):
        f, lead = replay.F, (dp, max(g // 2, 1))
        items = {
            "seg_frames": torch.from_numpy(rng.integers(
                0, 255, lead + (f, 42, 42)).astype(np.uint8)),
            "action": torch.from_numpy(
                rng.integers(0, 6, lead + (16,)).astype(np.int32)),
            "reward": torch.from_numpy(
                rng.normal(size=lead + (16,)).astype(np.float32)),
            "discount": torch.full(lead + (16,), 0.97),
            "next_off": torch.full(lead + (16,), 3, dtype=torch.int32),
        }
        td = torch.from_numpy(rng.uniform(0.1, 2.0, lead + (16,)).astype(
            np.float32))
        return learner.add(state, items, td)

    return learner, state, add, 4


def _dist_sequence(dev, exchange=None):
    """The R2D2 DistSequenceLearner on a dp=4 x tp=2 mesh of the card
    (with an `exchange`, its multi-process form)."""
    dp, seq, lstm, frames = 4, 8, 32, (36, 36, 4)
    lcfg = LearnerConfig(batch_size=16, sample_chunk=4, n_step=2,
                         value_rescale=True, target_sync_every=3)
    rcfg = ReplayConfig(kind="sequence", seq_length=seq, burn_in=2)
    net = _net(ApeXLSTMQNet(frames, num_actions=2, lstm_size=lstm,
                            dense=32, compute_dtype="bfloat16")).to(dev)
    replay = PrioritizedReplay(256, device=dev)
    learner = DistSequenceLearner(replay, lcfg, rcfg,
                                  make_mesh(dp=dp, tp=2, devices=[dev] * 8),
                                  exchange=exchange)
    state = learner.init(net, sequence_item_spec(
        frames, np.uint8, seq, lstm, frame_mode=True),
        component_generator(0, "learner", device=dev))

    def add(state, rng, g):
        lead = (dp, 2 * g)
        h, w, stack = frames
        items = {
            "seq_frames": rng.integers(
                0, 255, lead + (seq + stack - 1, h, w)).astype(np.uint8),
            "actions": rng.integers(0, 2, lead + (seq,)).astype(np.int32),
            "rewards": rng.normal(size=lead + (seq,)).astype(np.float32),
            "terminals": np.zeros(lead + (seq,), np.float32),
            "mask": np.ones(lead + (seq,), np.float32),
            "init_c": (0.3 * rng.normal(size=lead + (lstm,))).astype(
                np.float32),
            "init_h": (0.3 * rng.normal(size=lead + (lstm,))).astype(
                np.float32),
        }
        td = (rng.random(lead) + 0.1).astype(np.float32)
        return learner.add(state, {k: torch.from_numpy(v)
                                   for k, v in items.items()},
                           torch.from_numpy(td))

    return learner, state, add, 4


# name: (make(dev) -> (learner, state, add, K), gather launches per draw:
# one a side for transitions, one for a sequence draw, none for DPG's
# vector observations; the dist learners' draws gather every shard in
# the same launches)
CASES = {"frame_ring": (_frame_ring, 2), "flat": (_flat, 2),
         "sequence": (_sequence, 1), "dpg": (_dpg, 0),
         "dist_frame_ring": (_dist_frame_ring, 2),
         "dist_sequence": (_dist_sequence, 1)}


def _cursors(rs) -> torch.Tensor:
    """The host cursor and fill (per shard) beside their device
    mirrors."""
    return torch.tensor(np.concatenate([
        np.ravel(rs.pos), np.ravel(rs.size),
        rs.pos_dev.cpu().numpy().ravel(), rs.size_dev.cpu().numpy().ravel()
    ]).astype(np.int64))


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
    snap["cursors"] = _cursors(state.replay)
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
        sizes.append(int(np.sum(state.replay.size)))
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


# -- the ingest add ----------------------------------------------------------


def _add_replay(layout: str, dev):
    """(replay, item spec or None, block units, the block's host items
    maker) of one layout the driver ships to."""
    if layout == "frame_ring":
        replay = FrameRingReplay(64, 8, 3, (42, 42, 4), device=dev)

        def block(lead, rng):
            next_off = rng.integers(1, 4, lead + (8,)).astype(np.int32)
            next_off[..., -1] = 0
            return {"seg_frames": rng.integers(0, 255, lead + (14, 42, 42)
                                               ).astype(np.uint8),
                    "action": rng.integers(0, 6, lead + (8,)).astype(
                        np.int32),
                    "reward": rng.normal(size=lead + (8,)).astype(
                        np.float32),
                    "discount": np.full(lead + (8,), 0.97, np.float32),
                    "next_off": next_off,
                    "priorities": rng.uniform(0.1, 2, lead + (8,)).astype(
                        np.float32)}

        return replay, replay.init(), 3, block
    spec, cap, chunk = {
        "flat": (transition_item_spec((84, 84, 4), np.uint8), 64, 24),
        "dpg": (continuous_item_spec((3,), np.float32, 1), 64, 24),
        "sequences": (sequence_item_spec((84, 84, 4), np.uint8, 80, 512,
                                         frame_mode=True), 16, 5)}[layout]
    replay = PrioritizedReplay(cap, device=dev, item_spec=spec)

    def block(lead, rng):
        out = {}
        for k, s in sorted(spec.items()):
            dtype = torch.zeros(0, dtype=s.dtype).numpy().dtype
            shape = lead + tuple(s.shape)
            out[k] = (rng.integers(0, 200, shape).astype(dtype)
                      if np.issubdtype(dtype, np.integer)
                      else rng.normal(size=shape).astype(dtype))
        out["priorities"] = rng.uniform(0.1, 2, lead).astype(np.float32)
        return out

    return replay, replay.init(), chunk, block


def _adds(layout: str, dev, capture: bool):
    replay, rs, chunk, block = _add_replay(layout, dev)
    learner = DQNLearner(replay, LearnerConfig())
    learner.capture = capture
    state = type("S", (), {"replay": rs})()
    rng = np.random.default_rng(11)
    cursor_units = getattr(replay, "S", replay.capacity)
    wrapped = False
    for g in (1, 4, 1, 4, 1, 4, 4, 1):
        lead = (g, chunk) if g > 1 else (chunk,)
        items = block(lead, rng)
        views = {k: torch.from_numpy(v.reshape(g * chunk, *v.shape[
            len(lead):])).pin_memory() for k, v in items.items()}
        before = rs.pos
        learner.add_landed(state, g, learner.land_add(g, views, lead))
        wrapped |= before + g * chunk > cursor_units
    torch.cuda.synchronize()
    assert wrapped
    snap = {f"storage/{k}": v.clone() for k, v in rs.storage.items()}
    snap.update(tree=rs.tree.clone(), pos_dev=rs.pos_dev.clone(),
                size_dev=rs.size_dev.clone())
    return learner, (rs.pos, rs.size), snap


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["frame_ring", "flat", "dpg",
                                    "sequences"])
def test_add_graphs_match_the_eager_add(cuda_device, layout):
    """One captured graph per (replay, g): after single blocks and
    coalesced groups of 4 past a wrap of the ring, the graphed adds and
    the eager adds leave the replay bitwise equal."""
    gl, gcur, gsnap = _adds(layout, cuda_device, True)
    el, ecur, esnap = _adds(layout, cuda_device, False)
    assert gcur == ecur
    assert (int(gsnap["pos_dev"]), int(gsnap["size_dev"])) == gcur
    for name in gsnap:
        assert torch.equal(gsnap[name], esnap[name]), f"{layout}: {name}"
    graphs = gl.add_graphs()
    assert sorted(graphs) == [1, 4]
    # a warm-up, a capture (and its replay), then replays
    assert all(a.captured and a.replays == 3 for a in graphs.values())
    assert not any(a.captured for a in el.add_graphs().values())


@pytest.mark.cuda
def test_an_add_capture_that_fails_raises(cuda_device):
    """An add body that synchronises with the host cannot be captured:
    the capturing call raises, with no eager fallback."""
    replay, rs, chunk, block = _add_replay("flat", cuda_device)

    class Syncing(DQNLearner):
        def _add_body(self, state, inputs, g):
            super()._add_body(state, inputs, g)
            float(state.replay.pos_dev)

    learner = Syncing(replay, LearnerConfig())
    state = type("S", (), {"replay": rs})()
    rng = np.random.default_rng(0)

    def views():
        return {k: torch.from_numpy(v) for k, v in
                block((chunk,), rng).items()}

    learner.add_landed(state, 1, learner.land_add(1, views(), (chunk,)))
    with pytest.raises(RuntimeError):
        learner.add_landed(state, 1, learner.land_add(1, views(),
                                                      (chunk,)))


# -- the cold tier's eviction swap ------------------------------------------


def _swaps(layout: str, dev, capture: bool, n: int = 6):
    """Fill the replay past a wrap with adds, then `n` eviction swaps
    as the driver runs them (evict, region to the host, directed add at
    the device start). -> (learner, the host cursor, the replay's
    tensors, the regions and starts read out)."""
    replay, rs, chunk, block = _add_replay(layout, dev)
    learner = DQNLearner(replay, LearnerConfig())
    learner.capture = capture
    state = type("S", (), {"replay": rs})()
    rng = np.random.default_rng(17)

    def pinned(items):
        return {k: torch.from_numpy(v).pin_memory() for k, v in items.items()}

    cursor_units = getattr(replay, "S", replay.capacity)
    wrapped = False
    for _ in range(4):
        before = rs.pos
        learner.add_landed(state, 1, learner.land_add(
            1, pinned(block((chunk,), rng)), (chunk,)))
        wrapped |= before + chunk > cursor_units
    assert wrapped
    regions = []
    for _ in range(n):
        inputs = learner.land_add_at(pinned(block((chunk,), rng)),
                                     (chunk,))
        start, items, pri = learner.evict_landed(state, chunk)
        host = {k: v.cpu() for k, v in items.items()}
        host.update(priorities=pri.cpu(), start=start.cpu())
        learner.add_at_landed(state, inputs, start, int(host["start"]))
        assert (rs.pos, rs.size) == (int(rs.pos_dev), int(rs.size_dev))
        regions.append(host)
    torch.cuda.synchronize()
    snap = {f"storage/{k}": v.clone() for k, v in rs.storage.items()}
    snap.update(tree=rs.tree.clone(), pos_dev=rs.pos_dev.clone(),
                size_dev=rs.size_dev.clone())
    return learner, (rs.pos, rs.size), snap, regions


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["frame_ring", "flat"])
def test_swap_graphs_match_the_eager_swap(cuda_device, layout):
    """The evict graph (plan and read) and the add_at graph (the
    directed add reading the start on the device), after a fill that
    wraps and six swaps: the regions read out, their starts, the host
    cursor and the replay's storage, tree and device cursor are
    bitwise the eager bodies'."""
    gl, gcur, gsnap, greg = _swaps(layout, cuda_device, True)
    el, ecur, esnap, ereg = _swaps(layout, cuda_device, False)
    assert gcur == ecur
    for name in gsnap:
        assert torch.equal(gsnap[name], esnap[name]), f"{layout}: {name}"
    for i, (g, e) in enumerate(zip(greg, ereg)):
        for k in e:
            assert torch.equal(g[k], e[k]), f"{layout}: swap {i} {k}"
    swaps = gl.swap_graphs()
    assert sorted(swaps) == ["add_at", "evict"]
    # a warm-up, a capture (and its replay), then replays
    assert all(s.captured and s.replays == 5 for s in swaps.values())
    assert not any(s.captured for s in el.swap_graphs().values())


@pytest.mark.cuda
def test_a_swap_capture_that_fails_raises(cuda_device):
    """An evict body that synchronises with the host cannot be captured:
    the capturing call raises, with no eager fallback."""
    replay, rs, chunk, block = _add_replay("flat", cuda_device)

    class Syncing(DQNLearner):
        def _evict_body(self, state, block):
            out = super()._evict_body(state, block)
            int(out[0])
            return out

    learner = Syncing(replay, LearnerConfig())
    state = type("S", (), {"replay": rs})()
    learner.add_landed(state, 1, learner.land_add(1, {
        k: torch.from_numpy(v) for k, v in
        block((chunk,), np.random.default_rng(0)).items()}, (chunk,)))
    learner.evict_landed(state, chunk)               # the eager warm-up
    with pytest.raises(RuntimeError):
        learner.evict_landed(state, chunk)           # the capture


# -- the dp-sharded learner's lockstep add and per-shard swap ---------------


def _dist_adds(layout: str, dev, capture: bool, dp: int = 2):
    """`_adds` for a DistDQNLearner over dp stacked shards: single
    [dp, chunk] blocks and coalesced [4, dp, chunk] groups past a
    wrap."""
    replay, _, chunk, block = _add_replay(layout, dev)
    learner = DistDQNLearner(replay, LearnerConfig(batch_size=32),
                             make_mesh(dp=dp, tp=1, devices=[dev] * dp))
    learner.capture = capture
    rs = replay.init_sharded(dp)
    state = type("S", (), {"replay": rs})()
    rng = np.random.default_rng(11)
    cursor_units = getattr(replay, "S", replay.capacity)
    wrapped = False
    for g in (1, 4, 1, 4, 1, 4, 4, 1):
        lead = ((g,) if g > 1 else ()) + (dp, chunk)
        items = block(lead, rng)
        views = {k: torch.from_numpy(v.reshape(g * dp * chunk, *v.shape[
            len(lead):])).pin_memory() for k, v in items.items()}
        before = int(rs.pos[0])
        learner.add_landed(state, g, learner.land_add(g, views, lead))
        assert len(set(rs.pos.tolist())) == 1      # lockstep
        wrapped |= before + g * chunk > cursor_units
    torch.cuda.synchronize()
    assert wrapped
    snap = {f"storage/{k}": v.clone() for k, v in rs.storage.items()}
    snap.update(tree=rs.tree.clone(), cursors=_cursors(rs))
    return learner, snap


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["frame_ring", "flat", "sequences"])
def test_dist_add_graphs_match_the_eager_lockstep_add(cuda_device, layout):
    """The (g, dp, chunk) add graphs of the dp-sharded learner against
    its eager lockstep add, across a wrap: bitwise, with host and device
    cursors equal per shard."""
    gl, gsnap = _dist_adds(layout, cuda_device, True)
    el, esnap = _dist_adds(layout, cuda_device, False)
    for name in gsnap:
        assert torch.equal(gsnap[name], esnap[name]), f"{layout}: {name}"
    cur = gsnap["cursors"].reshape(4, -1)
    assert torch.equal(cur[0], cur[2]) and torch.equal(cur[1], cur[3])
    graphs = gl.add_graphs()
    assert sorted(graphs) == [1, 4]
    assert all(a.captured and a.replays == 3 for a in graphs.values())
    assert not any(a.captured for a in el.add_graphs().values())


def _dist_swaps(layout: str, dev, capture: bool, dp: int = 2, n: int = 6):
    """`_swaps` for the dp-sharded learner: each shard plans, reads and
    overwrites its own region ([dp] starts)."""
    replay, _, chunk, block = _add_replay(layout, dev)
    learner = DistDQNLearner(replay, LearnerConfig(batch_size=32),
                             make_mesh(dp=dp, tp=1, devices=[dev] * dp))
    learner.capture = capture
    rs = replay.init_sharded(dp)
    state = type("S", (), {"replay": rs})()
    rng = np.random.default_rng(17)
    lead = (dp, chunk)

    def pinned(items):
        return {k: torch.from_numpy(v.reshape(dp * chunk, *v.shape[2:]))
                .pin_memory() for k, v in items.items()}

    for _ in range(4):
        learner.add_landed(state, 1, learner.land_add(
            1, pinned(block(lead, rng)), lead))
    regions = []
    for _ in range(n):
        inputs = learner.land_add_at(pinned(block(lead, rng)), lead)
        start, items, pri = learner.evict_landed(state, chunk)
        host = {k: v.cpu() for k, v in items.items()}
        host.update(priorities=pri.cpu(), start=start.cpu())
        learner.add_at_landed(state, inputs, start, host["start"].numpy())
        assert rs.pos.tolist() == rs.pos_dev.tolist()
        assert rs.size.tolist() == rs.size_dev.tolist()
        regions.append(host)
    torch.cuda.synchronize()
    snap = {f"storage/{k}": v.clone() for k, v in rs.storage.items()}
    snap.update(tree=rs.tree.clone(), cursors=_cursors(rs))
    return learner, snap, regions


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["frame_ring", "flat"])
def test_dist_swap_graphs_match_the_eager_swap(cuda_device, layout):
    """The per-shard evict graph and add_at graph against the eager
    swap, six swaps after a fill: regions, [dp] starts, the cursors,
    storage and trees bitwise."""
    gl, gsnap, greg = _dist_swaps(layout, cuda_device, True)
    el, esnap, ereg = _dist_swaps(layout, cuda_device, False)
    for name in gsnap:
        assert torch.equal(gsnap[name], esnap[name]), f"{layout}: {name}"
    for i, (g, e) in enumerate(zip(greg, ereg)):
        assert g["start"].shape == (2,)
        for k in e:
            assert torch.equal(g[k], e[k]), f"{layout}: swap {i} {k}"
    swaps = gl.swap_graphs()
    assert all(s.captured and s.replays == 5 for s in swaps.values())
