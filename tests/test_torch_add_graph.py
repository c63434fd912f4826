"""The ingest add's body is safe to capture into a CUDA graph
(runtime/step_graph.py: AddGraph), shown on the CPU for the three replay
layouts the driver ships to: the frame ring (pong), flat transitions
(flat pong; and DPG's, which has no pixel leaf) and stored sequences
(r2d2, its single frames packed into one byte row).

Each case lands g staged blocks the way the driver does (`land_add`),
runs the add body while the host's copies of the write cursor and the
fill hold garbage (the body must read the device mirrors), then moves
the host cursor by the blocks it wrote. Blocks go in until the ring has
wrapped (skip-to-head) at least once. After every add the replay must
equal the JAX package's after the same `add`s: storage bitwise, the
sum-tree leaves within 1e-6 and the inner sums within 1e-6 relative
(float32 additions), and the host and device cursors exact."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.replay.frame_ring import FrameRingReplay as JaxRing
from ape_x_dqn_tpu.replay.prioritized import PrioritizedReplay as JaxPER
from ape_x_dqn_tpu.replay.sequence import (
    sequence_item_spec as jax_sequence_spec)
from ape_x_dqn_tpu.runtime.dpg_learner import (
    continuous_item_spec as jax_continuous_spec)
from ape_x_dqn_tpu.runtime.learner import (
    transition_item_spec as jax_transition_spec)
from ape_x_dqn_tpu_torch.configs import LearnerConfig
from ape_x_dqn_tpu_torch.replay.frame_ring import FrameRingReplay
from ape_x_dqn_tpu_torch.replay.prioritized import PrioritizedReplay
from ape_x_dqn_tpu_torch.replay.sequence import sequence_item_spec
from ape_x_dqn_tpu_torch.runtime.dpg_learner import continuous_item_spec
from ape_x_dqn_tpu_torch.runtime.learner import (DQNLearner,
                                                 transition_item_spec)
from ape_x_dqn_tpu_torch.runtime.step_graph import AddGraph

GARBAGE = -10 ** 9


@contextlib.contextmanager
def _host_cursor_poisoned(rs):
    saved = (rs._pos, rs._size)
    rs._pos = rs._size = GARBAGE
    try:
        yield
    finally:
        rs._pos, rs._size = saved


def _random_items(spec: dict, lead: tuple, rng) -> dict:
    """{key: numpy [*lead, *shape]} for an item spec of torch dtypes."""
    out = {}
    for k, s in sorted(spec.items()):
        dtype = torch.zeros(0, dtype=s.dtype).numpy().dtype
        shape = lead + tuple(s.shape)
        if np.issubdtype(dtype, np.integer):
            out[k] = rng.integers(0, 200, shape).astype(dtype)
        else:
            out[k] = rng.normal(size=shape).astype(dtype)
    return out


def _ring_layout():
    obs = (42, 42, 4)
    seg, nstep = 8, 3
    tr = FrameRingReplay(capacity=64, seg_transitions=seg, n_step=nstep,
                         obs_shape=obs, device="cpu")
    jr = JaxRing(capacity=64, seg_transitions=seg, n_step=nstep,
                 obs_shape=obs)
    f = seg + nstep + obs[2] - 1

    def block(lead, rng):
        next_off = rng.integers(1, nstep + 1, lead + (seg,)).astype(
            np.int32)
        next_off[..., -1] = 0                    # a dead pad slot
        items = {
            "seg_frames": rng.integers(0, 255, lead + (f, *obs[:2])
                                       ).astype(np.uint8),
            "action": rng.integers(0, 6, lead + (seg,)).astype(np.int32),
            "reward": rng.normal(size=lead + (seg,)).astype(np.float32),
            "discount": np.full(lead + (seg,), 0.97, np.float32),
            "next_off": next_off}
        td = rng.uniform(0.1, 2.0, lead + (seg,)).astype(np.float32)
        return items, td

    # 3 segments a block over 8 segment slots: the third block skips
    return tr, tr.init(), jr, jr.init(), block, 3


def _flat_layout(kind: str):
    rng_spec = {"transitions": (transition_item_spec((32, 32, 4),
                                                     np.uint8),
                                jax_transition_spec((32, 32, 4), np.uint8)),
                "dpg": (continuous_item_spec((3,), np.float32, 1),
                        jax_continuous_spec((3,), np.float32, 1)),
                "sequences": (sequence_item_spec((42, 42, 4), np.uint8, 16,
                                                 8, frame_mode=True),
                              jax_sequence_spec((42, 42, 4), np.uint8, 16,
                                                8, frame_mode=True))}
    tspec, jspec = rng_spec[kind]
    cap, chunk = (16, 5) if kind == "sequences" else (64, 24)
    tr = PrioritizedReplay(capacity=cap, device="cpu", item_spec=tspec)
    jr = JaxPER(capacity=cap)

    def block(lead, rng):
        return (_random_items(tspec, lead, rng),
                rng.uniform(0.1, 2.0, lead).astype(np.float32))

    return tr, tr.init(), jr, jr.init(jspec), block, chunk


LAYOUTS = {
    "frame_ring": _ring_layout,
    "flat_transitions": lambda: _flat_layout("transitions"),
    "flat_dpg": lambda: _flat_layout("dpg"),
    "sequences": lambda: _flat_layout("sequences"),
}


def _assert_same(jrs, trs, cap):
    assert (trs.pos, trs.size) == (int(jrs.pos), int(jrs.size))
    assert (int(trs.pos_dev), int(trs.size_dev)) == (trs.pos, trs.size)
    for key, v in trs.storage.items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(jrs.storage[key]),
                                      err_msg=key)
    tree, jtree = trs.tree.numpy(), np.asarray(jrs.tree)
    np.testing.assert_allclose(tree[cap:], jtree[cap:], rtol=0, atol=1e-6)
    np.testing.assert_allclose(tree, jtree, rtol=1e-6)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_add_body_reads_only_device_state_across_a_wrap(layout):
    tr, trs, jr, jrs, block, chunk = LAYOUTS[layout]()
    learner = DQNLearner(tr, LearnerConfig())
    state = type("S", (), {"replay": trs})()
    rng = np.random.default_rng(7)
    cursor_units = tr.S if isinstance(tr, FrameRingReplay) else tr.capacity
    wrapped = False
    # single blocks and coalesced pairs, as the stager ships them
    for g in (1, 2, 1, 2, 2, 1):
        lead = (g, chunk) if g > 1 else (chunk,)
        items, td = block(lead, rng)
        for j in range(g):
            jitems = {k: jnp.asarray(v[j] if g > 1 else v)
                      for k, v in items.items()}
            jrs = jr.add(jrs, jitems, jnp.asarray(td[j] if g > 1 else td))
        views = {k: torch.from_numpy(v.reshape(g * chunk, *v.shape[
            len(lead):])) for k, v in items.items()}
        views["priorities"] = torch.from_numpy(td.reshape(
            g * chunk, *td.shape[len(lead):]))
        pos_before = trs.pos
        inputs = learner.land_add(g, views, lead)
        graph = learner.add_graphs()[g]
        assert isinstance(graph, AddGraph) and not graph.captured
        with _host_cursor_poisoned(trs):
            graph(state, inputs, capture=True)   # the CPU runs the body
        block_units = chunk
        for _ in range(g):
            tr.advance_host(trs, block_units)
        wrapped |= pos_before + g * block_units > cursor_units
        _assert_same(jrs, trs, tr.capacity)
    assert wrapped, "the blocks never reached the end of the ring"


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_add_landed_equals_the_eager_add(layout):
    """The learner's landed add (body + host cursor) and its eager
    `add`/`add_many` write the same replay."""
    tr, trs, _, _, block, chunk = LAYOUTS[layout]()
    tr2, trs2 = tr, tr.init()
    learner = DQNLearner(tr, LearnerConfig())
    got = type("S", (), {"replay": trs})()
    want = type("S", (), {"replay": trs2})()
    rng = np.random.default_rng(3)
    for g in (1, 2, 2, 1, 2):
        lead = (g, chunk) if g > 1 else (chunk,)
        items, td = block(lead, rng)
        views = {k: torch.from_numpy(v.reshape(g * chunk, *v.shape[
            len(lead):])) for k, v in items.items()}
        views["priorities"] = torch.from_numpy(td.reshape(
            g * chunk, *td.shape[len(lead):]))
        learner.add_landed(got, g, learner.land_add(g, views, lead))
        titems = {k: torch.from_numpy(v) for k, v in items.items()}
        if g > 1:
            learner.add_many(want, titems, torch.from_numpy(td))
        else:
            learner.add(want, titems, torch.from_numpy(td))
        assert (trs.pos, trs.size) == (trs2.pos, trs2.size)
        for key in trs.storage:
            assert torch.equal(trs.storage[key], trs2.storage[key]), key
        assert torch.equal(trs.tree, trs2.tree)
        assert torch.equal(trs.pos_dev, trs2.pos_dev)
        assert torch.equal(trs.size_dev, trs2.size_dev)
