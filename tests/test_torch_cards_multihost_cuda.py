"""The cold tier's swap over distinct cards and a multi-host rank that
holds several cards, on the card (parallel/cards.py), where two or more
cards are visible. Every test is marked `cuda` and skips, with its
reason, when fewer cards are visible than its layout needs (a mesh over
distinct cards needs them; a CUDA graph has no CPU mode). The file
imports no JAX, so on a machine with the cards it runs with

    python -m pytest --noconftest -m cuda -s tests/test_torch_cards_multihost_cuda.py

- The swap: `CardsLearner`'s `evict_landed` / `land_add_at` /
  `add_at_landed` over [c0, c1] at dp=2 and [c0, c1] * 2 at dp=4 (two
  rows a card), against the stacked `DistDQNLearner` on c0, from the
  same replay, capture on (the first call of each swap graph warms up,
  the second captures and replays): the [dp] starts, the regions, their
  priorities, and after the directed add the storage, the cursors and
  the sum-trees, bitwise; then a second swap the same way (the graphs'
  replays).
- Two ranks, each holding two cards, against the one-process learner
  over the same cards (four, or [c0, c1] * 2; its generator on cuda:0
  as the ranks' are) (tests/test_torch_multihost_cards.py's cases: DQN
  at dp=4 x tp=1, R2D2 at dp=2 x tp=2), float32 without TF32, two K=4
  macro-steps (the eager warm-up, then the capture and its replay):
  Adam's first moment, the first metrics and the params' change within
  REL_TOL, relative; the CRC-32 of the params equal on both ranks. With
  four cards the ranks' cards are their own, so the group agrees on
  NCCL ("own_cards"); with two, both ranks hold cuda:0 and cuda:1, so it
  agrees on gloo ("shared_cards")."""

import contextlib
import gc
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from ape_x_dqn_tpu_torch.configs import LearnerConfig, NetworkConfig
from ape_x_dqn_tpu_torch.envs.base import EnvSpec
from ape_x_dqn_tpu_torch.models import build_network, init_params
from ape_x_dqn_tpu_torch.parallel.cards import CardsLearner, group_learner
from ape_x_dqn_tpu_torch.parallel.dist_learner import DistDQNLearner
from ape_x_dqn_tpu_torch.parallel.mesh import make_mesh, rank_mesh
from ape_x_dqn_tpu_torch.replay.prioritized import PrioritizedReplay
from ape_x_dqn_tpu_torch.runtime.learner import (checkpoint_tree,
                                                 transition_item_spec)
from ape_x_dqn_tpu_torch.utils.rng import component_generator
from tests.test_torch_multihost_cards import (CASES, NPROC, REL_TOL, _crc,
                                              _macro_step, _rel, free_port)

BLOCK = 16
TIMEOUT_S = 180
RANK_LAYOUTS = {"own_cards": (4, "nccl"), "shared_cards": (2, "gloo")}


def _need(n: int) -> int:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        pytest.skip(f"needs {n} CUDA cards for this layout, {have} visible")
    return have


@pytest.fixture
def float32_cards():
    """Float32 means float32 (no TF32), and deterministic algorithms
    (tests/test_torch_cards_cuda.py's rule); put back after."""
    old = (torch.backends.cudnn.deterministic,
           torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.deterministic = old[0]
    torch.use_deterministic_algorithms(old[1], warn_only=old[2])
    torch.backends.cuda.matmul.allow_tf32 = old[3]
    torch.backends.cudnn.allow_tf32 = old[4]
    gc.collect()


def _swap_learner(devices, dp):
    lcfg = LearnerConfig(batch_size=32, sample_chunk=4)
    mesh = make_mesh(dp=dp, tp=1, devices=devices)
    if mesh.distinct:
        lrn = CardsLearner(group_learner(DistDQNLearner, lcfg),
                           lambda d: PrioritizedReplay(capacity=64,
                                                       device=d),
                           lcfg, mesh)
    else:
        lrn = DistDQNLearner(PrioritizedReplay(capacity=64,
                                               device=devices[0]),
                             lcfg, mesh)
    net = build_network(NetworkConfig(kind="mlp", mlp_hidden=(64,),
                                      compute_dtype="float32"),
                        EnvSpec((4,), np.dtype(np.float32), True, 2))
    init_params(net, component_generator(0, "net_init"))
    st = lrn.init(net, transition_item_spec((4,), np.float32),
                  component_generator(0, "learner", device=devices[0]))
    return lrn, st


def _block(rng, dp, n):
    items = {
        "obs": rng.normal(size=(dp, n, 4)).astype(np.float32),
        "action": rng.integers(0, 2, (dp, n)).astype(np.int32),
        "reward": rng.normal(size=(dp, n)).astype(np.float32),
        "next_obs": rng.normal(size=(dp, n, 4)).astype(np.float32),
        "discount": np.full((dp, n), 0.99, np.float32)}
    return items, rng.uniform(0.1, 2.0, (dp, n)).astype(np.float32)


def _swap(lrn, st, views, dp) -> dict:
    """One swap as the driver makes it: land, evict, read, add_at. ->
    the region (starts, items, priorities) in row order."""
    cards = isinstance(lrn, CardsLearner)
    inputs = lrn.land_add_at(views, (dp, BLOCK))
    with lrn.on_cards() if cards else contextlib.nullcontext():
        evicted = lrn.evict_landed(st, BLOCK)
        parts = evicted if cards else [evicted]
        rows = ([list(g.rows) for g in lrn.groups] if cards
                else [list(range(dp))])
        region = {}
        for r, (start, items, pri) in zip(rows, parts):
            for k, v in dict(items, priorities=pri, start=start).items():
                v = v.cpu().numpy()
                region.setdefault(k, np.empty((dp, *v.shape[1:]), v.dtype))
                region[k][r] = v
        lrn.add_at_landed(st, inputs,
                          [p[0] for p in parts] if cards else parts[0][0],
                          region["start"])
    return region


@pytest.mark.cuda
@pytest.mark.parametrize("dp,times", [(2, 1), (4, 2)],
                         ids=["dp2_on_two", "dp4_on_two"])
def test_card_swap_matches_the_stacked_learner(dp, times):
    _need(2)
    cards = [torch.device("cuda", i) for i in range(2)] * times
    cl, cs = _swap_learner(cards, dp)
    sl, ss = _swap_learner([cards[0]] * dp, dp)
    assert cl.graphed and sl.graphed
    rng = np.random.default_rng(5)
    for n in (40, 24):
        items, td = _block(rng, dp, n)
        for lrn, st, dev in ((cl, cs, "cpu"), (sl, ss, cards[0])):
            lrn.add(st, {k: torch.from_numpy(v).to(dev)
                         for k, v in items.items()},
                    torch.from_numpy(td).to(dev))
    for swap in range(3):      # warm-up, capture and replay, replay
        items, td = _block(rng, dp, BLOCK)
        views = {k: torch.from_numpy(v.reshape(dp * BLOCK, *v.shape[2:]))
                 for k, v in dict(items, priorities=td).items()}
        got = _swap(cl, cs, views, dp)
        want = _swap(sl, ss, views, dp)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"{swap}: {k}")
        a = checkpoint_tree(cs, with_replay=True)["replay"]
        b = checkpoint_tree(ss, with_replay=True)["replay"]
        assert a["pos"] == b["pos"] and a["size"] == b["size"]
        assert torch.equal(a["tree"].cpu(), b["tree"].cpu()), swap
        for k, v in a["storage"].items():
            assert torch.equal(v.cpu(), b["storage"][k].cpu()), k
    graphs = cl.swap_graphs()
    assert graphs["evict"].replays == graphs["add_at"].replays == 2
    del cl, cs, sl, ss
    gc.collect()


def _rank_worker(rank: int, case: str, port: int, ncards: int,
                 out_dir: str) -> None:
    from ape_x_dqn_tpu_torch.parallel import multihost

    per = ncards // NPROC if ncards >= 2 * NPROC else ncards
    first = rank * per if ncards >= 2 * NPROC else 0
    devices = ",".join(f"cuda:{first + i}" for i in range(per))
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.init_multihost(f"127.0.0.1:{port}", NPROC, rank,
                             device=devices)
    try:
        cards = multihost.local_devices(devices)
        torch.cuda.set_device(cards[0])
        dp, tp = CASES[case]()[:2]
        start, stop = multihost.process_rows(dp)
        mesh = rank_mesh(stop - start, tp, cards)
        mode = multihost.agreed_exchange_mode(
            True, multihost.processes_on_devices(mesh.cards))
        out = _macro_step(case, mesh, multihost.GradExchange(mode, cards[0]),
                          start, steps=2)
        out["mode"] = mode
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        gc.collect()
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(RANK_LAYOUTS))
@pytest.mark.parametrize("case", list(CASES))
def test_ranks_over_cards_match_the_one_process_learner(case, layout,
                                                       float32_cards,
                                                       tmp_path):
    ncards, mode = RANK_LAYOUTS[layout]
    _need(ncards)
    dp, tp = CASES[case]()[:2]
    # the one-process learner over the same cards, its generator on
    # cuda:0 as the ranks' are (the CPU's would draw other noise)
    cards = [torch.device("cuda", i) for i in range(ncards)]
    want = _macro_step(case, make_mesh(dp=dp, tp=tp,
                                       devices=cards * (4 // ncards)),
                       steps=2)
    gc.collect()
    ctx = mp.start_processes(_rank_worker,
                             args=(case, free_port(), ncards,
                                   str(tmp_path)),
                             nprocs=NPROC, join=False, start_method="spawn")
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
        assert got["mode"] == mode
        assert got["calls"] == want["calls"] == 8
        # on the card: the eager warm-up, then 5 g graphs a macro-step
        assert list(got["graphs"].values()) == [5 * got["groups"]]
        change = _rel(got["after"], want["after"], base)
        mu = _rel(got["mu"], want["mu"])
        first = _rel(got["metrics"], want["metrics"])
        print(f"{case}/{layout} rank {rank} ({mode}): params' change "
              f"{change:.3g}, first moment {mu:.3g}, metrics {first:.3g} "
              f"(REL_TOL {REL_TOL})")
        assert change <= REL_TOL and mu <= REL_TOL and first <= REL_TOL
    assert _crc(outs[0]["after"]) == _crc(outs[1]["after"])
