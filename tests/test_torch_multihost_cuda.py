"""The multi-process dist learner's exchanged step graphs against their
eager bodies, on the card (runtime/step_graph.py: `SegmentedStep`,
`ExchangedStep`). Every test here is marked `cuda` and skips without a
card. Run on a machine with the card with

    python -m pytest --noconftest -m cuda tests/test_torch_multihost_cuda.py

The dp-sharded learners of tests/test_torch_graph_cuda.py, built with a
`GradExchange` in a one-process group. As there, the same learner is
built several times, replaying its graphs or running the same bodies
eagerly on the card, and after the first and the fifth macro-step
everything must be bitwise equal:

- in a gloo group, each SGD step's gradient goes through the host
  collective between captured segments (K=4: five segments a
  macro-step);
- in a group with NCCL (one rank, alone on its card), the exchange is a
  device all-gather and the K=4 macro-step is ONE captured graph, equal
  to its eager body and to the gloo segments of the same learner (the
  gathered vector is the same bytes).

With two cards, two NCCL ranks, one on each, train the two-process CPU
test's cases (tests/test_torch_multihost_learner.py) within 1e-5 of the
one-process dist learner, with equal params CRC-32, and bitwise like
the same two ranks sharing card 0 over gloo; with one card that case
skips. Run it where two cards are visible with

    python -m pytest --noconftest -m cuda -k two_cards tests/test_torch_multihost_cuda.py

The CLI's two-rank forms run in `chip_smoke.py`'s `mh_*` phases."""

import gc
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ape_x_dqn_tpu_torch.parallel import multihost
from ape_x_dqn_tpu_torch.runtime.evaluation import params_crc32
from ape_x_dqn_tpu_torch.runtime.step_graph import (ExchangedStep,
                                                    SegmentedStep)
from tests.test_torch_graph_cuda import (_dist_frame_ring, _dist_sequence,
                                         _run, cuda_device)  # noqa: F401
from tests.test_torch_multihost_learner import (CASES, DP, K, MACRO, TOL,
                                                _train)

MAKERS = {"dist_frame_ring": (_dist_frame_ring, 2),
          "dist_sequence": (_dist_sequence, 1)}
NPROC = 2
TIMEOUT_S = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def group1():
    """A one-process gloo group."""
    multihost.init_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                             device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture
def nccl1(cuda_device):
    """A one-process group with NCCL for CUDA tensors (gloo for CPU
    ones): one rank, alone on its card."""
    multihost.init_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                             device=cuda_device)
    try:
        assert "nccl" in str(dist.get_backend())
        assert multihost.agreed_exchange_mode(
            True, multihost.processes_on_device(cuda_device)) == "nccl"
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MAKERS))
def test_segmented_graphs_match_the_eager_body(cuda_device, group1, case):
    make, per_draw = MAKERS[case]

    def make_exchanged(dev):
        return make(dev, exchange=multihost.GradExchange())

    gl, gs, gsnaps, sizes, g_launches = _run(make_exchanged, cuda_device,
                                             True)
    el, es, esnaps, _, e_launches = _run(make_exchanged, cuda_device, False)
    assert len(set(sizes)) == 5, sizes
    graph = gl.step_graphs()[("k", 4)]
    assert isinstance(graph, SegmentedStep) and graph.captured
    assert graph.graphs == 5         # four exchanges in a K=4 macro-step
    assert not el.step_graphs()[("k", 4)].captured
    for after, g, e in zip((1, 5), gsnaps, esnaps):
        assert g.keys() == e.keys()
        for name in g:
            assert torch.equal(g[name], e[name]), \
                f"{case}: {name} differs after {after} macro-steps"
    assert g_launches == e_launches == 5 * per_draw
    assert gl.exchange.calls == el.exchange.calls == 5 * 4
    assert gs.step == es.step == 20


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MAKERS))
def test_one_nccl_graph_matches_the_eager_body_and_the_segments(
        cuda_device, nccl1, case):
    make, per_draw = MAKERS[case]

    def nccl(dev):
        return make(dev, exchange=multihost.GradExchange("nccl", dev))

    def gloo(dev):
        return make(dev, exchange=multihost.GradExchange())

    runs = {"graph": _run(nccl, cuda_device, True),
            "eager": _run(nccl, cuda_device, False),
            "segments": _run(gloo, cuda_device, True)}
    graph = runs["graph"][0].step_graphs()[("k", 4)]
    assert isinstance(graph, ExchangedStep) and graph.captured
    assert graph.graphs == 1         # the four exchanges inside one graph
    stats = runs["graph"][0].exchange.stats()
    assert stats["backend"] == "nccl"
    assert stats["bytes_sent"] == stats["bytes_received"] > 0   # world 1
    assert not runs["eager"][0].step_graphs()[("k", 4)].captured
    segments = runs["segments"][0].step_graphs()[("k", 4)]
    assert isinstance(segments, SegmentedStep) and segments.graphs == 5
    ref = runs["graph"][2]
    for other in ("eager", "segments"):
        for after, g, e in zip((1, 5), ref, runs[other][2]):
            assert g.keys() == e.keys()
            for name in g:
                assert torch.equal(g[name], e[name]), \
                    f"{case}: {name} differs from {other} after {after} " \
                    f"macro-steps"
    for name, (learner, state, _, _, launches) in runs.items():
        assert launches == 5 * per_draw, name
        assert learner.exchange.calls == 5 * 4, name
        assert state.step == 20, name


@pytest.mark.cuda
def test_a_segmented_capture_that_fails_raises(cuda_device, group1):
    """A segment that synchronises with the host cannot be captured: the
    capturing call raises, and nothing falls back to the eager body."""
    _capture_raises(cuda_device, multihost.GradExchange())


@pytest.mark.cuda
def test_a_one_graph_capture_that_fails_raises(cuda_device, nccl1):
    """The same for the NCCL exchange's one graph."""
    _capture_raises(cuda_device,
                    multihost.GradExchange("nccl", cuda_device))


def _capture_raises(dev, exchange) -> None:
    learner, state, add, k = _dist_frame_ring(dev, exchange=exchange)
    state = add(state, np.random.default_rng(0), 64)
    diag = learner._diag

    def syncing(*args):
        out = diag(*args)
        out["host"] = torch.tensor(float(out["shard_td_mean_max"]),
                                   device=dev)
        return out

    learner._diag = syncing
    state, _ = learner.train_step_k(state, k)        # the eager warm-up
    with pytest.raises(RuntimeError):
        learner.train_step_k(state, k)               # the capture


@pytest.fixture
def two_cards(cuda_device):
    if torch.cuda.device_count() < NPROC:
        pytest.skip(f"needs {NPROC} CUDA cards, one NCCL rank on each; "
                    f"{torch.cuda.device_count()} visible")


def _pair_worker(rank: int, case: str, port: int, out_dir: str,
                 placement: str) -> None:
    """One rank of a two-process pair: "cards" puts rank r alone on card
    r (NCCL), "one_card" both ranks on card 0 (gloo)."""
    dev = torch.device("cuda", rank if placement == "cards" else 0)
    torch.cuda.set_device(dev)
    # as the reference runs (the `cuda_device` fixture): a K=2 draw can
    # take one leaf twice, and only the deterministic write-back keeps
    # the same one of its two |TD|s on every run
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    multihost.init_multihost(f"127.0.0.1:{port}", NPROC, rank, device=dev)
    try:
        per = DP // NPROC
        mode = multihost.agreed_exchange_mode(
            True, multihost.processes_on_device(dev))
        exchange = multihost.GradExchange(mode, dev)
        out = _train(case, slice(rank * per, (rank + 1) * per), exchange,
                     device=dev)
        out["mode"] = mode
        out["crc32"] = params_crc32(out["params"])
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        # the learner's graphs before the group: NCCL destroys no
        # communicator that a live graph's collective holds
        gc.collect()
        dist.destroy_process_group()


def _pair(case: str, placement: str, out_dir) -> list[dict]:
    ctx = mp.start_processes(_pair_worker,
                             args=(case, _free_port(), str(out_dir),
                                   placement),
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
    return [torch.load(out_dir / f"rank{r}.pt") for r in range(NPROC)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_two_cards_match_the_one_process_learner(two_cards, case,
                                                 tmp_path):
    """Two NCCL ranks on two cards: equal params CRC-32, within 1e-5 of
    the one-process learner, and bitwise equal to the same two ranks
    sharing card 0 over gloo (the gathered vector is the same bytes)."""
    ref = _train(case, slice(0, DP), device=torch.device("cuda", 0))
    (tmp_path / "cards").mkdir()
    (tmp_path / "one_card").mkdir()
    outs = _pair(case, "cards", tmp_path / "cards")
    gloo = _pair(case, "one_card", tmp_path / "one_card")
    per = DP // NPROC
    for rank, (out, same) in enumerate(zip(outs, gloo)):
        assert out["mode"] == "nccl" and same["mode"] == "gloo"
        assert set(out["graphs"].values()) == {"ExchangedStep"}
        assert set(same["graphs"].values()) == {"SegmentedStep"}
        assert out["step"] == ref["step"] == MACRO * K
        for name, want in ref["params"].items():
            np.testing.assert_allclose(out["params"][name].numpy(),
                                       want.numpy(), rtol=TOL, atol=TOL,
                                       err_msg=name)
            assert torch.equal(out["params"][name], same["params"][name]), \
                f"{case}: rank {rank}'s {name} differs from gloo's"
        np.testing.assert_allclose(
            out["tree"].numpy(), ref["tree"][rank * per:(rank + 1) * per]
            .numpy(), rtol=TOL, atol=TOL)
        assert torch.equal(out["tree"], same["tree"])
    assert outs[0]["crc32"] == outs[1]["crc32"]
