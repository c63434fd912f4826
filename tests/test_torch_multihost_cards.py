"""A multi-host rank that holds several cards (parallel/cards.py:
`CardsLearner` with a cross-rank `GradExchange`, parallel/mesh.py:
`rank_mesh`), on the CPU: two gloo processes, each holding ``cpu:0,
cpu:1`` (distinct device objects whose tensors land on ``cpu``),
against the one-process `CardsLearner` over ``cpu:0 .. cpu:3`` at the
same global dp x tp. tests/test_torch_dist_cards.py holds that
one-process learner against the JAX package's dist learners.

Cases: DQN at dp=4 x tp=1 (each rank's two rows on its two devices: two
card groups a rank, so the exchange's in-process level runs) and R2D2
at dp=2 x tp=2 (each rank's one row column-split over its two devices,
min_dim 16), float32, one K=4 macro-step from the same params, replay
and generator. Held, as ||got - want|| / ||want|| over every element
(`_rel`, the rule of tests/test_torch_cards_cuda.py): Adam's first
moment, the first metrics and the params' change over the macro-step
within REL_TOL; the params' CRC-32 equal on both ranks. The control, a
rank whose cross-rank exchange is skipped (its own groups' vectors in
the other rank's slots, so it trains on its own rows only), must score
at least 100 x REL_TOL on the params' change. Then the layouts
`rank_mesh` refuses, and two CLI ranks with ``--device cpu:0,cpu:1`` in
lockstep (tests/test_torch_multihost_cli.py's pair)."""

import os
import time
import zlib

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from ape_x_dqn_tpu_torch.configs import (LearnerConfig, NetworkConfig,
                                         ReplayConfig)
from ape_x_dqn_tpu_torch.envs.base import EnvSpec
from ape_x_dqn_tpu_torch.models import build_network, init_params
from ape_x_dqn_tpu_torch.parallel.cards import CardsLearner, group_learner
from ape_x_dqn_tpu_torch.parallel.dist_learner import (DistDQNLearner,
                                                       DistSequenceLearner)
from ape_x_dqn_tpu_torch.parallel.mesh import make_mesh, rank_mesh
from ape_x_dqn_tpu_torch.replay.prioritized import PrioritizedReplay
from ape_x_dqn_tpu_torch.replay.sequence import sequence_item_spec
from ape_x_dqn_tpu_torch.runtime.learner import (checkpoint_tree,
                                                 transition_item_spec)
from ape_x_dqn_tpu_torch.utils.rng import component_generator
from tests.test_torch_cards_cuda import _rel
from tests.test_torch_multihost_cli import _SETS, free_port, run_pair

NPROC = 2
RANK_DEVICES = ["cpu:0", "cpu:1"]
CPUS = [f"cpu:{i}" for i in range(4)]
REL_TOL = 1e-4
TIMEOUT_S = 60


def _dqn():
    """An MLP of 256 on 4 floats, batch 32 over dp=4."""
    dp, tp, n = 4, 1, 40
    spec = EnvSpec((4,), np.dtype(np.float32), True, 2)
    ncfg = NetworkConfig(kind="mlp", mlp_hidden=(256,), dueling=False,
                         compute_dtype="float32")
    lcfg = LearnerConfig(batch_size=32, sample_chunk=4, lr=1e-3,
                         target_sync_every=100)
    rng = np.random.default_rng(3)
    items = {
        "obs": rng.normal(size=(dp, n, 4)).astype(np.float32),
        "action": rng.integers(0, 2, (dp, n)).astype(np.int32),
        "reward": rng.normal(size=(dp, n)).astype(np.float32),
        "next_obs": rng.normal(size=(dp, n, 4)).astype(np.float32),
        "discount": np.full((dp, n), 0.99, np.float32)}
    td = rng.uniform(0.1, 2.0, (dp, n)).astype(np.float32)
    td[1] *= 1e-2                        # a lighter shard
    return (dp, tp, spec, ncfg, lcfg, None,
            transition_item_spec((4,), np.float32), items, td, 256)


def _r2d2():
    """An LSTM of 32 over 8 floats (a 64-wide torso), sequences of 6
    with burn-in 2, batch 16 over dp=2, its torso and gates split at
    min_dim 16."""
    dp, tp, n, seq, lstm, obs = 2, 2, 24, 6, 32, (8,)
    spec = EnvSpec(obs, np.dtype(np.float32), True, 3)
    ncfg = NetworkConfig(kind="lstm_q", lstm_size=lstm, mlp_hidden=(64,),
                         dueling=True, compute_dtype="float32")
    lcfg = LearnerConfig(batch_size=16, n_step=2, value_rescale=True,
                         target_sync_every=100, lr=1e-3, sample_chunk=4)
    rcfg = ReplayConfig(kind="sequence", seq_length=seq, burn_in=2)
    rng = np.random.default_rng(4)
    mask = np.ones((dp, n, seq), np.float32)
    mask[:, ::5, seq - 2:] = 0.0
    items = {
        "obs": rng.normal(size=(dp, n, seq, *obs)).astype(np.float32),
        "actions": rng.integers(0, 3, (dp, n, seq)).astype(np.int32),
        "rewards": rng.normal(size=(dp, n, seq)).astype(np.float32),
        "terminals": np.zeros((dp, n, seq), np.float32),
        "mask": mask,
        "init_c": (0.3 * rng.normal(size=(dp, n, lstm))).astype(np.float32),
        "init_h": (0.3 * rng.normal(size=(dp, n, lstm))).astype(np.float32)}
    td = rng.uniform(0.1, 2.0, (dp, n)).astype(np.float32)
    return (dp, tp, spec, ncfg, lcfg, rcfg,
            sequence_item_spec(obs, np.float32, seq, lstm), items, td, 16)


CASES = {"dqn_dp4xtp1": _dqn, "r2d2_dp2xtp2": _r2d2}


class _OwnRowsOnly:
    """The control's fault: a cross-rank exchange that never crosses,
    each rank's slot filled with this rank's own vector."""

    def __init__(self, nproc: int):
        self.nproc = nproc

    def __call__(self, send, out=None):
        out[:] = send
        return out

    def reset(self):
        pass

    def stats(self):
        return {}


def _macro_step(case: str, mesh, cross=None, row_start: int = 0,
                steps: int = 1) -> dict:
    """Build the case's `CardsLearner` over `mesh` (this rank's rows from
    `row_start` with `cross`, or every row), add its rows, run `steps`
    K=4 macro-steps (on the card: the eager warm-up, then the capture
    and its replay). -> Adam's first moment, the first metrics, the
    params before and after (whole, on the host)."""
    (dp, tp, spec, ncfg, lcfg, rcfg, item_spec, items, td,
     min_dim) = CASES[case]()
    net = build_network(ncfg, spec)
    init_params(net, component_generator(0, "net_init"))
    cls = DistSequenceLearner if rcfg is not None else DistDQNLearner
    learner = CardsLearner(group_learner(cls, lcfg, rcfg),
                           lambda d: PrioritizedReplay(capacity=64,
                                                       device=d),
                           lcfg, mesh, min_dim=min_dim, cross=cross,
                           row_start=row_start)
    cuda = mesh.device.type == "cuda"
    state = learner.init(net, item_spec, component_generator(
        0, "learner", device=mesh.device if cuda else "cpu"))
    rows = slice(row_start, row_start + mesh.dp)
    learner.add(state, {k: torch.from_numpy(v[rows])
                        for k, v in items.items()},
                torch.from_numpy(td[rows]))

    def params():
        return {k: v.detach().cpu().clone()
                for k, v in checkpoint_tree(state)["params"].items()}

    before = params()
    first = None
    for _ in range(steps):
        state, m = learner.train_step_k(state, 4)
        first = first or {k: v.detach().float().cpu().reshape(-1)
                          for k, v in m.items() if k != "diag"}
    tree = checkpoint_tree(state)
    out = {"before": before, "after": params(),
           "mu": {str(i): t.detach().cpu().clone()
                  for i, t in enumerate(tree["opt_state"]["mu"])},
           "metrics": first, "calls": learner.exchange.calls,
           "groups": len(learner.groups),
           "graphs": {str(k): g.graphs
                      for k, g in learner.step_graphs().items()}}
    if cuda:
        for d in mesh.cards:
            torch.cuda.synchronize(d)
    return out


def _crc(params: dict) -> int:
    crc = 0
    for k in sorted(params):
        crc = zlib.crc32(params[k].numpy().tobytes(), crc)
    return crc


def _worker(rank: int, case: str, port: int, out_dir: str) -> None:
    from ape_x_dqn_tpu_torch.parallel import multihost

    torch.set_num_threads(1)   # small; the suite's workers share the cores
    multihost.init_multihost(f"127.0.0.1:{port}", NPROC, rank,
                             device=",".join(RANK_DEVICES))
    try:
        dp, tp = CASES[case]()[:2]
        start, stop = multihost.process_rows(dp)
        devices = multihost.local_devices(",".join(RANK_DEVICES))
        mesh = rank_mesh(stop - start, tp, devices)
        assert mesh.distinct
        out = _macro_step(case, mesh, multihost.GradExchange(), start)
        out["mode"] = multihost.agreed_exchange_mode(
            False, multihost.processes_on_devices(mesh.cards))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_over_two_devices_match_the_one_process_learner(case,
                                                             tmp_path):
    dp, tp = CASES[case]()[:2]
    want = _macro_step(case, make_mesh(dp=dp, tp=tp, devices=CPUS))
    assert want["groups"] == 4 // tp
    ctx = mp.start_processes(_worker, args=(case, free_port(),
                                            str(tmp_path)),
                             nprocs=NPROC, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "a rank hung"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    outs = [torch.load(tmp_path / f"rank{r}.pt") for r in range(NPROC)]
    base = want["before"]
    for rank, got in enumerate(outs):
        assert got["mode"] == "gloo"           # both ranks on the CPU
        assert got["groups"] == 2 // tp
        assert got["calls"] == want["calls"] == 4
        for k in base:
            assert torch.equal(got["before"][k], base[k]), k
        change = _rel(got["after"], want["after"], base)
        mu = _rel(got["mu"], want["mu"])
        first = _rel(got["metrics"], want["metrics"])
        print(f"{case} rank {rank}: params' change {change:.3g}, first "
              f"moment {mu:.3g}, metrics {first:.3g} (REL_TOL {REL_TOL})")
        assert change <= REL_TOL and mu <= REL_TOL and first <= REL_TOL
    assert _crc(outs[0]["after"]) == _crc(outs[1]["after"])
    # the control: rank 0 with its cross-rank exchange skipped
    ctl = _macro_step(case, rank_mesh(dp // NPROC, tp, RANK_DEVICES),
                      _OwnRowsOnly(NPROC), 0)
    skipped = _rel(ctl["after"], want["after"], base)
    print(f"{case}: the skipped cross-rank exchange scores {skipped:.3g}")
    assert skipped >= 100 * REL_TOL


@pytest.mark.parametrize("dp,tp,cards,why", [
    (2, 2, ["cpu:0", "cpu:1", "cpu:2"], "must divide"),
    (1, 1, ["cpu:0", "cpu:1"], "cover its"),
    (3, 1, ["cpu:0", "cpu:1"], "cover its")])
def test_rank_mesh_refuses_a_row_across_ranks(dp, tp, cards, why):
    """tp partners that would straddle ranks (tp not dividing the rank's
    cards), or positions that leave a card without its share, raise
    ValueError; one card holds every position, as before."""
    with pytest.raises(ValueError, match=why):
        rank_mesh(dp, tp, cards)
    one = rank_mesh(dp, tp, ["cpu"])
    assert not one.distinct and one.size == dp * tp


def test_device_lists_parse_and_refuse():
    from ape_x_dqn_tpu_torch.parallel import multihost

    assert multihost.local_devices("cpu:0, cpu:1") == [
        torch.device("cpu:0"), torch.device("cpu:1")]
    assert multihost.local_devices("cpu") == [torch.device("cpu")]
    for bad in ("cpu:0,cpu:0", "cpu:0,cpu", "cpu:0,cuda:1"):
        with pytest.raises(ValueError):
            multihost.local_devices(bad)
    assert multihost.group_backend("cpu:0,cpu:1") == "gloo"


def test_cli_ranks_over_two_devices_end_in_lockstep(tmp_path):
    """Two CLI ranks, each `--device cpu:0,cpu:1` (dp=4: two rows a
    rank, one on each of its devices): a clean end in lockstep."""
    sets = [s for s in _SETS if not s.startswith("parallel.dp")] + [
        "parallel.dp=4"]
    outs = run_pair(["--device", "cpu:0,cpu:1", "--total-env-frames",
                     "1200", "--max-grad-steps", "8"], sets=sets)
    mh = [o["multihost"] for o in outs]
    assert outs[0]["grad_steps"] == outs[1]["grad_steps"] >= 8
    assert outs[0]["loss"] == pytest.approx(outs[1]["loss"], rel=1e-5)
    assert mh[0]["params_crc32"] == mh[1]["params_crc32"]
    assert [m["rows"] for m in mh] == [[0, 2], [2, 4]]
    for m, out in zip(mh, outs):
        assert out["actor_errors"] == [] and out["frames_local"] > 0
        cards = m["cards"]
        assert cards["cards"] == ["cpu:0", "cpu:1"]
        assert cards["rows_per_card"] == {"cpu:0": [0], "cpu:1": [1]}
        # one cross-rank exchange per SGD step, from the rank's first
        # owner, and one in-process all-gather of its two groups
        assert m["exchange"]["calls"] == out["grad_steps"]
        assert cards["local_exchange"]["calls"] == out["grad_steps"]
        assert cards["local_exchange"]["groups"] == 4
