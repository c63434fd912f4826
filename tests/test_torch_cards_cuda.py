"""The dp-sharded learner over distinct cards in one process
(parallel/cards.py) on two or more cards: its captured graphs against
its eager step bodies, bitwise, and the learner against the stacked
learner on one card. Every test here but the last is marked `cuda`
and skips, with its reason, when fewer than two cards are visible (a
mesh over distinct cards needs them; a CUDA graph has no CPU mode); the
last runs the comparison with the stacked learner and its control over
two CPU devices. The file imports no JAX, so on a machine with the
cards it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_cards_cuda.py

Layouts, over the first cards: "dp_over_cards" ([c0, c1] * 2 at dp=4 x
tp=1: two card groups of two rows, the exchange an NCCL all-gather),
"tp_across_cards" ([c0, c1] * 4 at dp=4 x tp=2: one group on c0, its
torso_out and LSTM column-split with c1, each stretch one graph over
both cards) and, with four cards, "both" ([c0 .. c3] * 2: two groups,
each split). The learners are tests/test_torch_graph_cuda.py's dist
cases at a width that the split divides (min_dim 64 for the frame ring's
64-wide torso_out, 128 for a 128-unit LSTM whose convs stay whole).

Graph against eager: the same five K=4 macro-steps with an add between
them, deterministic algorithms on (that file's rule); params, target,
Adam's moments, the stacked trees, the cursors and every metric equal
after the first and the fifth. Against the stacked learner on c0 (the
layers whole, every shard on one card) from the same state and noise,
in float32 with TF32 off: the params' change over the five macro-steps
within REL_TOL of the stacked learner's, as ||d_cards - d_stacked|| /
||d_stacked|| over every param, and the first macro-step's loss,
gradient norm, q and |td| means within REL_TOL alike. Adam moves every param by about lr a step, so a
bound on the largest param difference cannot tell a fault from
rounding; this one can: a learner left unchanged scores 1, and the
control here, the same learner with each group's exchange skipped (it
trains on its own rows only), must score at least 100 x REL_TOL."""

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
from ape_x_dqn_tpu_torch.parallel.cards import (CardExchange, CardsLearner,
                                               group_learner)
from ape_x_dqn_tpu_torch.parallel.dist_learner import (DistDQNLearner,
                                                       DistSequenceLearner)
from ape_x_dqn_tpu_torch.parallel.mesh import make_mesh
from ape_x_dqn_tpu_torch.replay.frame_ring import FrameRingReplay
from ape_x_dqn_tpu_torch.replay.prioritized import PrioritizedReplay
from ape_x_dqn_tpu_torch.replay.sequence import sequence_item_spec
from ape_x_dqn_tpu_torch.runtime.learner import checkpoint_tree
from ape_x_dqn_tpu_torch.runtime.step_graph import pack_metrics
from ape_x_dqn_tpu_torch.utils.rng import component_generator

LAYOUTS = {"dp_over_cards": (2, 1, 2), "tp_across_cards": (2, 2, 4),
           "both": (4, 2, 2)}   # cards, tp, times the card list repeats
REL_TOL = 1e-4


@pytest.fixture
def cards():
    """Decided when the test runs, never at import: every xdist worker
    must collect the same tests."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"needs two CUDA cards for a mesh over distinct cards, "
                    f"{n} visible")
    old = (torch.backends.cudnn.deterministic,
           torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    # float32 means float32 in the comparison with the stacked learner
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield n
    torch.backends.cudnn.deterministic = old[0]
    torch.use_deterministic_algorithms(old[1], warn_only=old[2])
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    gc.collect()
    for i in range(n):
        torch.cuda.synchronize(i)


def _mesh_devices(layout, n):
    ncards, tp, times = LAYOUTS[layout]
    if n < ncards:
        pytest.skip(f"layout {layout} needs {ncards} cards, {n} visible")
    return [torch.device("cuda", i) for i in range(ncards)] * times, tp


def _net(net):
    init_params(net, torch.Generator().manual_seed(0))
    return net


def _frame_ring(devices, tp, dtype):
    dp, obs = 4, (42, 42, 4)
    dev = devices[0]
    spec = EnvSpec(obs, np.dtype(np.uint8), True, 6)
    lcfg = LearnerConfig(batch_size=32, sample_chunk=4, target_sync_every=3)
    net = _net(build_network(NetworkConfig(
        kind="nature_cnn", cnn_channels=(8, 16, 16), torso_dense=64,
        compute_dtype=dtype), spec)).to(dev)
    mesh = make_mesh(dp=dp, tp=tp, devices=devices)
    if mesh.distinct:
        learner = CardsLearner(group_learner(DistDQNLearner, lcfg),
                               lambda d: FrameRingReplay(1024, 16, 3, obs,
                                                         device=d),
                               lcfg, mesh, min_dim=64)
    else:
        learner = DistDQNLearner(FrameRingReplay(1024, 16, 3, obs,
                                                 device=dev), lcfg, mesh)
    state = learner.init(net, None,
                         component_generator(0, "learner", device=dev))

    def add(state, rng, g):
        lead = (dp, max(g // 2, 1))
        f = learner.replay.F
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

    return learner, state, add


def _sequence(devices, tp, dtype):
    dp, seq, lstm, frames = 4, 8, 128, (36, 36, 4)
    dev = devices[0]
    lcfg = LearnerConfig(batch_size=16, sample_chunk=4, n_step=2,
                         value_rescale=True, target_sync_every=3)
    rcfg = ReplayConfig(kind="sequence", seq_length=seq, burn_in=2)
    net = _net(ApeXLSTMQNet(frames, num_actions=2, lstm_size=lstm,
                            dense=128, compute_dtype=dtype)).to(dev)
    mesh = make_mesh(dp=dp, tp=tp, devices=devices)
    if mesh.distinct:
        learner = CardsLearner(
            group_learner(DistSequenceLearner, lcfg, rcfg),
            lambda d: PrioritizedReplay(256, device=d), lcfg, mesh,
            min_dim=128)
    else:
        learner = DistSequenceLearner(PrioritizedReplay(256, device=dev),
                                      lcfg, rcfg, mesh)
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

    return learner, state, add


CASES = {"frame_ring": (_frame_ring, 2), "sequence": (_sequence, 1)}


def _snapshot(state, metrics) -> dict:
    tree = checkpoint_tree(state, with_replay=True)
    snap = {f"{part}.{k}": v.detach().cpu().clone()
            for part in ("params", "target_params")
            for k, v in tree[part].items()}
    opt = tree["opt_state"]
    snap["opt.count"] = opt["count"].cpu().clone()
    for i, (mu, nu) in enumerate(zip(opt["mu"], opt["nu"])):
        # copies: on the CPU .cpu() returns the live moment itself
        snap[f"opt.mu{i}"] = mu.cpu().clone()
        snap[f"opt.nu{i}"] = nu.cpu().clone()
    snap["tree"] = tree["replay"]["tree"].cpu().clone()
    snap["cursors"] = torch.tensor(tree["replay"]["pos"]
                                   + tree["replay"]["size"])
    snap["metrics"] = pack_metrics(metrics)[0].cpu()
    for k, v in metrics.items():
        if k != "diag":       # the diagnostics are per group's rows
            snap[f"metric.{k}"] = v.detach().float().cpu().reshape(-1)
    return snap


def _params(state) -> dict:
    return {k: v.detach().cpu().clone()
            for k, v in checkpoint_tree(state)["params"].items()}


def _run(make, devices, tp, capture: bool, dtype="bfloat16"):
    learner, state, add = make(devices, tp, dtype)
    learner.capture = capture
    rng = np.random.default_rng(0)
    state = add(state, rng, 64)
    init = _params(state)
    tfg.gather_rows.launches = 0
    tfg.gather_rows.by_device.clear()
    snaps = []
    for i in range(5):
        state, m = learner.train_step_k(state, 4)
        if i in (0, 4):
            snaps.append(_snapshot(state, m))
        state = add(state, rng, 1)
    for d in {torch.device(x) for x in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    return learner, snaps, dict(tfg.gather_rows.by_device), init


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("case", list(CASES))
def test_card_graphs_match_the_eager_bodies(cards, case, layout):
    make, per_draw = CASES[case]
    devices, tp = _mesh_devices(layout, cards)
    gl, gsnaps, g_launch, _ = _run(make, devices, tp, True)
    el, esnaps, e_launch, _ = _run(make, devices, tp, False)
    assert isinstance(gl, CardsLearner) and gl.graphed and not el.graphed
    assert bool(gl.split_layers) == (tp > 1)
    graph = gl.step_graphs()[("k", 4)]
    assert graph.captured and graph.graphs == (
        len(gl.groups) * 5)           # four exchanges: five stretches
    for after, g, e in zip((1, 5), gsnaps, esnaps):
        assert g.keys() == e.keys()
        for name in g:
            assert torch.equal(g[name], e[name]), \
                f"{case}/{layout}: {name} differs after {after} steps"
    # one launch per draw and side on every owner, replays included
    owners = {str(g.owner) for g in gl.groups}
    assert set(g_launch) == set(e_launch) == owners
    assert all(v == 5 * per_draw for v in g_launch.values())
    # one exchange per SGD step (none while capturing)
    assert gl.exchange.calls == el.exchange.calls == 20
    del gl, el
    gc.collect()


def _skipped_exchange(self, sends, outs=None):
    """The control's fault: each group gets back its own vector only,
    the other groups' slots zero, so it trains on its own rows."""
    n = sends[0].numel()
    if outs is None:
        outs = [torch.empty((self.nproc, n), device=s.device) for s in sends]
    for g, (s, out) in enumerate(zip(sends, outs)):
        out.zero_()
        out[g].copy_(s)
    self.count([n])
    return outs


def _rel(got: dict, want: dict, base: dict | None = None) -> float:
    """||(got - base) - (want - base)|| / ||want - base|| over every
    param (every metric without `base`)."""
    def d(x, k):
        return x[k].double() - (base[k].double() if base else 0)

    num = sum(float(((d(got, k) - d(want, k)) ** 2).sum()) for k in want)
    den = sum(float((d(want, k) ** 2).sum()) for k in want)
    return (num / den) ** 0.5


def _params_of(snap) -> dict:
    return {k[len("params."):]: v for k, v in snap.items()
            if k.startswith("params.")}


def _metrics_of(snap) -> dict:
    return {k: v for k, v in snap.items() if k.startswith("metric.")}


def _hold(make, devices, tp, monkeypatch) -> tuple:
    """The learner over `devices` against the stacked one on the first,
    float32 -> (the params' change, the first metrics, the control's
    param change with the exchange skipped: None for one card group)."""
    learner, got, _, init = _run(make, devices, tp, True, "float32")
    groups = len(learner.groups)
    del learner
    _, want, _, init_s = _run(make, [devices[0]] * len(devices), tp, True,
                              "float32")
    assert all(torch.equal(init[k], init_s[k]) for k in init)
    change = _rel(_params_of(got[-1]), _params_of(want[-1]), init)
    first = _rel(_metrics_of(got[0]), _metrics_of(want[0]))
    assert torch.equal(got[-1]["cursors"], want[-1]["cursors"])
    # the controls: no update at all, and (with two card groups or more;
    # one group has nothing to exchange) each group's exchange skipped
    assert _rel(init, _params_of(want[-1]), init) == 1.0
    skipped = None
    if groups > 1:
        with monkeypatch.context() as mp:
            mp.setattr(CardExchange, "__call__", _skipped_exchange)
            _, ctl, _, _ = _run(make, devices, tp, True, "float32")
        skipped = _rel(_params_of(ctl[-1]), _params_of(want[-1]), init)
    gc.collect()
    return change, first, skipped


def _check_hold(label, change, first, skipped) -> None:
    print(f"{label}: param change {change:.3g}, first metrics {first:.3g}, "
          f"exchange skipped {skipped} (REL_TOL {REL_TOL})")
    assert change <= REL_TOL, f"{label}: param change {change}"
    assert first <= REL_TOL, f"{label}: first metrics {first}"
    assert skipped is None or skipped >= 100 * REL_TOL, \
        f"{label}: the check misses a skipped exchange: {skipped}"


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("case", list(CASES))
def test_card_learner_holds_against_the_stacked_one(cards, case, layout,
                                                    monkeypatch):
    make, _ = CASES[case]
    devices, tp = _mesh_devices(layout, cards)
    _check_hold(f"{case}/{layout}",
                *_hold(make, devices, tp, monkeypatch))


@pytest.mark.parametrize("case", list(CASES))
def test_the_stacked_check_catches_a_skipped_exchange_on_cpu(case,
                                                             monkeypatch):
    """The comparison above over two CPU devices (`cpu:0`, `cpu:1`: the
    card groups' code, the exchange as copies), where it runs without a
    card: within REL_TOL of the stacked learner, its control (each
    group's exchange skipped) 100 x REL_TOL or more away."""
    make, _ = CASES[case]
    change, first, skipped = _hold(make, ["cpu:0", "cpu:1"] * 2, 1,
                                   monkeypatch)
    assert skipped is not None
    _check_hold(f"{case}/cpu", change, first, skipped)
