"""The multi-process dist learner's segmented step graphs against their
eager bodies, on the card (runtime/step_graph.py: `SegmentedStep`).
Every test here is marked `cuda` and skips without a card. Run on a
machine with the card with

    python -m pytest --noconftest -m cuda tests/test_torch_multihost_cuda.py

The dp-sharded learners of tests/test_torch_graph_cuda.py, built with a
`GradExchange` in a one-process gloo group: each SGD step's gradient
goes through the host collective between captured segments (K=4: five
segments a macro-step). As there, the same learner is built twice, once
replaying its graphs and once running the same bodies eagerly on the
card, and after the first and the fifth macro-step everything must be
bitwise equal. The two-process form runs in `chip_smoke.py`'s `mh_*`
phases (two ranks on the card)."""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ape_x_dqn_tpu_torch.parallel import multihost
from ape_x_dqn_tpu_torch.runtime.step_graph import SegmentedStep
from tests.test_torch_graph_cuda import (_dist_frame_ring, _dist_sequence,
                                         _run, cuda_device)  # noqa: F401

MAKERS = {"dist_frame_ring": (_dist_frame_ring, 2),
          "dist_sequence": (_dist_sequence, 1)}


@pytest.fixture
def group1():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.init_multihost(f"127.0.0.1:{port}", 1, 0)
    try:
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
    assert graph.segments == 5       # four exchanges in a K=4 macro-step
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
def test_a_segmented_capture_that_fails_raises(cuda_device, group1):
    """A segment that synchronises with the host cannot be captured: the
    capturing call raises, and nothing falls back to the eager body."""
    learner, state, add, k = _dist_frame_ring(
        cuda_device, exchange=multihost.GradExchange())
    state = add(state, np.random.default_rng(0), 64)
    diag = learner._diag

    def syncing(*args):
        out = diag(*args)
        out["host"] = torch.tensor(float(out["shard_td_mean_max"]),
                                   device=cuda_device)
        return out

    learner._diag = syncing
    state, _ = learner.train_step_k(state, k)        # the eager warm-up
    with pytest.raises(RuntimeError):
        learner.train_step_k(state, k)               # the capture
