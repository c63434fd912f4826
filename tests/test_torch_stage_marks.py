"""The learners' stage markers (obs/stages.py).

On the CPU the launcher is replaced by a recorder, and each learner's
step bodies must open their stages in order: an exact step, a K=2
macro-step of `DQNLearner`, the prefetch split (`sample_k`, then
`learn_k`), the dp-sharded R2D2 learner's macro-step, with and without
its gradient exchange, and DPG's step.

On the card (marked `cuda`, skipped here; the file imports no JAX):
`python -m pytest --noconftest -m cuda tests/test_torch_stage_marks.py`
captures a frame-ring macro-step, profiles two replays and finds the
markers in every replay, in order, with every stage's device time above
0; and the params after three macro-steps are bitwise those of the same
run with the launcher stubbed out: a marker changes no number.
"""

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch.obs import stages
from tests.test_torch_graph_cuda import (_dist_sequence, _dpg, _frame_ring,
                                         cuda_device)  # noqa: F401

SGD = ("loss", "backward", "optimizer", "diag")
DRAW = ("sample", "gather", "sample")
CLOSE = ("diag", "writeback", "end")


@pytest.fixture
def marks(monkeypatch):
    seen = []
    monkeypatch.setattr(stages, "_launch",
                        lambda i, device: seen.append(stages.STAGES[i]))
    return seen


class _OneProcess:
    """The gradient exchange of a world of one: [1, L] of what it is
    sent."""

    nproc = 1
    capturable = False

    def __call__(self, send):
        return send[None]


def _filled(make, g=64):
    learner, state, add, _ = make("cpu")
    return learner, add(state, np.random.default_rng(0), g)


def test_an_exact_step(marks):
    learner, state = _filled(_frame_ring)
    learner.train_step(state)
    assert marks == [*DRAW, *SGD, *CLOSE]


def test_a_macro_step(marks):
    learner, state = _filled(_frame_ring)
    learner.train_step_k(state, 2)
    assert marks == [*DRAW, *SGD * 2, *CLOSE]


def test_the_prefetch_split(marks):
    learner, state = _filled(_frame_ring)
    sample = learner.sample_k(state, 2)
    assert marks == [*DRAW, "end"]
    marks.clear()
    learner.learn_k(state, sample, 2)
    assert marks == [*SGD * 2, *CLOSE]


@pytest.mark.parametrize("exchanged", [False, True])
def test_a_dist_r2d2_macro_step(marks, exchanged):
    exchange = _OneProcess() if exchanged else None
    learner, state = _filled(lambda dev: _dist_sequence(dev, exchange), 4)
    learner.train_step_k(state, 2)
    sgd = ("loss", "backward", "exchange", "optimizer", "diag") \
        if exchanged else SGD
    assert marks == [*DRAW, *sgd * 2, *CLOSE]


def test_a_dpg_step(marks):
    learner, state = _filled(_dpg, 8)
    learner.train_step(state)
    # vector observations: no gather; the critic's update, then the
    # policy's
    assert marks == ["sample", *("loss", "backward", "optimizer") * 2,
                     *CLOSE]


def test_an_unknown_stage_is_refused():
    with pytest.raises(KeyError):
        stages.mark_stage("forward", torch.device("cpu"))


# -- on the card -------------------------------------------------------------


def _three_macro_steps(dev):
    learner, state, add, k = _frame_ring(dev)
    state = add(state, np.random.default_rng(0), 64)
    for _ in range(3):       # the eager warm-up, the capture, a replay
        state, _ = learner.train_step_k(state, k)
    torch.cuda.synchronize()
    params = {n: p.detach().clone() for n, p in
              state.net.state_dict().items()}
    return learner, state, k, params


@pytest.mark.cuda
def test_the_markers_replay_in_the_graph(cuda_device, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    from apex_bench.stages import stage_seconds
    from apex_bench.trace import DeviceTrace, read_profile

    learner, state, k, params = _three_macro_steps(cuda_device)
    assert learner.step_graphs()[("k", k)].captured
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            state, _ = learner.train_step_k(state, k)
        torch.cuda.synchronize()
    ops, _ = read_profile(prof)
    names = [n[len("apex_stage_"):] for _, n in sorted(
        (s, n) for n, s, _, _ in ops if n.startswith("apex_stage_"))]
    assert names == [*DRAW, *SGD * k, *CLOSE] * 2
    per_stage = stage_seconds(DeviceTrace(ops=ops), cuda_device.index or 0)
    for stage in ("sample", "gather", "loss", "backward", "optimizer",
                  "diag", "writeback", "marks"):
        assert per_stage.get(stage, 0.0) > 0.0, (stage, per_stage)

    del learner, state
    monkeypatch.setattr(stages, "_launch", lambda i, device: None)
    _, _, _, unmarked = _three_macro_steps(cuda_device)
    for n in params:
        assert torch.equal(params[n], unmarked[n]), n

