"""The port's sequence replay (ape_x_dqn_tpu_torch/replay/sequence.py)
against the JAX package's: the SequenceBuilder's items bitwise (host
numpy on both sides, stacked and frame mode, over terminals,
truncations and the shutdown flush), the learner's batch view
`batch_to_sequence_batch` bitwise, the item spec, and sequences through
the flat prioritized replay with the frame-mode leaf packed into one
byte row per sequence (the preset's row is 585,728 bytes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.replay.prioritized import PrioritizedReplay as JaxPER
from ape_x_dqn_tpu.replay.sequence import (
    SequenceBuilder as JaxSequenceBuilder)
from ape_x_dqn_tpu.replay.sequence import (
    batch_to_sequence_batch as jax_batch_view)
from ape_x_dqn_tpu.replay.sequence import (
    sequence_item_spec as jax_item_spec)
from ape_x_dqn_tpu_torch.replay.packing import PixelPacker, torch_dtype
from ape_x_dqn_tpu_torch.replay.prioritized import PrioritizedReplay
from ape_x_dqn_tpu_torch.replay.sequence import (SequenceBuilder,
                                                 batch_to_sequence_batch,
                                                 sequence_item_spec,
                                                 split_priorities,
                                                 stack_items)

STACK = 4


def _episodes(lengths, h=6, w=6, seed=0):
    """Sliding-stack pixel observations as the Atari wrapper makes them
    (frame log [0] * 3 + [f0, f1, ...]; obs_t = log[t:t + stack]), one
    list per episode."""
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        log = [np.zeros((h, w), np.uint8)] * (STACK - 1)
        log += [rng.integers(0, 255, (h, w)).astype(np.uint8)
                for _ in range(n + 1)]
        out.append([np.stack(log[t:t + STACK], axis=-1)
                    for t in range(n + 1)])
    return out


def _script(seed=0):
    """(obs, action, reward, terminal, pre_state, td, episode_end) steps:
    an episode that ends in a terminal, one cut by a time limit (episode
    end without a terminal), and an open one the flush closes."""
    rng = np.random.default_rng(seed)
    steps = []
    for e, ep in enumerate(_episodes([27, 13, 9], seed=seed)):
        for t, obs in enumerate(ep[:-1]):
            last = t == len(ep) - 2
            pre = (rng.normal(size=3).astype(np.float32),
                   rng.normal(size=3).astype(np.float32))
            steps.append((obs, int(rng.integers(0, 4)),
                          float(rng.normal()), last and e == 0, pre,
                          float(rng.normal()), last and e < 2))
    return steps


def _run(builder_cls, frame_mode, steps):
    sb = builder_cls(seq_len=8, overlap=4, lstm_size=3,
                     priority_eta=0.9, frame_mode=frame_mode)
    out = []
    for obs, a, r, term, pre, td, end in steps:
        out += sb.append(obs, a, r, term, pre, td=td, episode_end=end)
    return out + sb.flush()


@pytest.mark.parametrize("frame_mode", [False, True],
                         ids=["stacked", "frames"])
def test_builder_matches_the_original_bitwise(frame_mode):
    steps = _script()
    got, want = (_run(SequenceBuilder, frame_mode, steps),
                 _run(JaxSequenceBuilder, frame_mode, steps))
    assert len(got) == len(want) > 6
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k]),
                                          np.asarray(w[k]), err_msg=k)
    items, pris = split_priorities(got)
    assert "priority" not in items[0]
    np.testing.assert_array_equal(
        pris, np.asarray([w["priority"] for w in want], np.float32))
    batch = stack_items(got)
    obs_key = "seq_frames" if frame_mode else "obs"
    assert batch[obs_key].shape[0] == len(got)
    assert "priority" not in batch


def test_builder_priority_is_the_eta_mix():
    sb = SequenceBuilder(seq_len=4, overlap=0, lstm_size=2,
                         priority_eta=0.9)
    pre = (np.zeros(2), np.zeros(2))
    out = []
    for t, td in enumerate([1.0, 2.0, 3.0, 4.0]):
        out += sb.append(np.array([t]), t, 0.0, False, pre, td=td)
    assert len(out) == 1
    np.testing.assert_allclose(out[0]["priority"], 0.9 * 4 + 0.1 * 2.5)


def test_frame_mode_rebuild_matches_stacked_storage():
    """The frame-mode items, rebuilt by batch_to_sequence_batch, give
    exactly the stacked builder's obs on every live step."""
    steps = _script(seed=1)
    stacked = _run(SequenceBuilder, False, steps)
    frames = _run(SequenceBuilder, True, steps)
    for si, fi in zip(stacked, frames):
        assert fi["seq_frames"].shape == (8 + STACK - 1, 6, 6)
        batch = {k: torch.from_numpy(np.asarray(v))[None]
                 for k, v in fi.items() if k != "priority"}
        rebuilt = batch_to_sequence_batch(batch).obs[0].numpy()
        live = si["mask"].astype(bool)
        np.testing.assert_array_equal(rebuilt[live], si["obs"][live])


@pytest.mark.parametrize("frame_mode", [False, True],
                         ids=["stacked", "frames"])
def test_batch_view_matches_the_original_bitwise(frame_mode):
    items = stack_items(_run(SequenceBuilder, frame_mode, _script(seed=2)))
    got = batch_to_sequence_batch(
        {k: torch.from_numpy(v) for k, v in items.items()})
    want = jax_batch_view({k: jnp.asarray(v) for k, v in items.items()})
    assert got.obs.shape == want.obs.shape
    for name in ("obs", "actions", "rewards", "terminals", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for g, w in zip(got.init_state, want.init_state):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("frame_mode", [False, True],
                         ids=["stacked", "frames"])
def test_item_spec_matches_the_original(frame_mode):
    got = sequence_item_spec((84, 84, 4), np.uint8, 80, 512, frame_mode)
    want = jax_item_spec((84, 84, 4), np.uint8, 80, 512, frame_mode)
    assert list(got) == list(want)
    for k, spec in got.items():
        assert tuple(spec.shape) == tuple(want[k].shape), k
        assert spec.dtype == torch_dtype(want[k].dtype), k


def test_preset_sequence_row_is_585728_bytes():
    """The r2d2 preset's frame-mode leaf, 83 x 84 x 84 uint8, packs into
    one 128-byte-padded row per sequence (what the row-gather kernel
    reads at the `sequence` site)."""
    spec = sequence_item_spec((84, 84, 4), np.uint8, 80, 512, True)
    packer = PixelPacker(spec)
    assert packer.packed("seq_frames")
    assert packer.storage_spec(spec)["seq_frames"].shape == (585_728,)
    assert not any(packer.packed(k) for k in spec if k != "seq_frames")


def test_sequences_through_prioritized_replay_match_the_original():
    """Frame-mode sequences (26 x 52 x 52 frames: 70,304 bytes, packed
    into a 70,400-byte row each) added to the port's and the original's
    flat prioritized replay, then one draw from the same noise: the
    same slots, the same items bitwise and the same IS weights."""
    seq, h = 23, 52
    spec_t = sequence_item_spec((h, h, STACK), np.uint8, seq, 8, True)
    spec_j = jax_item_spec((h, h, STACK), np.uint8, seq, 8, True)
    rng = np.random.default_rng(3)
    n = 24
    items = {
        "seq_frames": rng.integers(0, 255, (n, seq + STACK - 1, h, h)
                                   ).astype(np.uint8),
        "actions": rng.integers(0, 4, (n, seq)).astype(np.int32),
        "rewards": rng.normal(size=(n, seq)).astype(np.float32),
        "terminals": np.zeros((n, seq), np.float32),
        "mask": np.ones((n, seq), np.float32),
        "init_c": rng.normal(size=(n, 8)).astype(np.float32),
        "init_h": rng.normal(size=(n, 8)).astype(np.float32),
    }
    td = rng.uniform(0.1, 2.0, n).astype(np.float32)
    tr = PrioritizedReplay(32, device="cpu", item_spec=spec_t)
    ts = tr.init()
    jr = JaxPER(32, item_spec=spec_j)
    js = jr.init()
    for lo in (0, 12):
        blk = {k: v[lo:lo + 12] for k, v in items.items()}
        tr.add(ts, {k: torch.from_numpy(v) for k, v in blk.items()},
               torch.from_numpy(td[lo:lo + 12]))
        js = jr.add(js, {k: jnp.asarray(v) for k, v in blk.items()},
                    jnp.asarray(td[lo:lo + 12]))
    assert ts.storage["seq_frames"].shape == (32, 70_400)
    key = jax.random.key(5)
    jitems, jidx, jw = jr.sample(js, key, 16)
    noise = torch.from_numpy(np.array(jax.random.uniform(key, (16,))))
    titems, tidx, tw = tr.sample(ts, 16, noise)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    for k, v in titems.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jitems[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(v.numpy(), items[k][tidx.numpy()],
                                      err_msg=k)
