"""The port's R2D2 learner against the JAX package's `SequenceLearner`
(the helpers and tolerances of tests/test_torch_r2d2_learner.py): the
frame-mode sequences of the preset (single frames per sequence, one
packed byte row each, gathered by the row gather and rebuilt into
stacks for a Nature-CNN torso over 36x36x4 frames), the remainder
path of train_many, and the target sync inside a macro-step.

The frame-mode case trains at the r2d2 preset's learning rate, 1e-4:
convs over raw pixels get a few gradient elements at rounding level,
whose normalised Adam updates (of the order of the learning rate) can
differ between the packages; at the tests' usual 1e-3 one element of
32,768 moved 2.25e-6 apart within 4 steps."""

import dataclasses

import numpy as np
import torch

from tests.test_torch_r2d2_learner import (LCFG, _compare, _learners,
                                           _noise_chain)


def test_frame_mode_k4_matches_jax():
    jl, js, tl, ts = _learners(frames=True, sample_chunk=4, lr=1e-4)
    assert ts.replay.storage["seq_frames"].dtype == torch.uint8
    noise = _noise_chain(js.rng, [4 * LCFG["batch_size"]] * 2)
    js, jm = jl.train_many(js, 8)
    ts, tm = tl.train_many(ts, 8, noise)
    _compare(js, jm, ts, tm)


def test_remainder_then_macro_step_matches_jax():
    """train_many(6) at K=4: two exact single steps first, then one
    macro-step."""
    jl, js, tl, ts = _learners(frames=False, sample_chunk=4)
    b = LCFG["batch_size"]
    noise = _noise_chain(js.rng, [b, b, 4 * b])
    js, jm = jl.train_many(js, 6)
    ts, tm = tl.train_many(ts, 6, noise)
    _compare(js, jm, ts, tm)


def test_target_sync_inside_the_macro_step():
    """train_many(5) at K=4 with target_sync_every=5: a remainder
    single, then a macro-step whose last SGD step is the sync boundary,
    so the target equals the online net after it."""
    _, _, tl, ts = _learners(frames=False, sample_chunk=4)
    tl.lcfg = dataclasses.replace(tl.lcfg, target_sync_every=5)
    ts, m = tl.train_many(ts, 5)
    assert ts.step == 5 and np.isfinite(m["loss"].item())
    for a, b in zip(ts.target_net.parameters(), ts.net.parameters()):
        assert torch.equal(a, b)
