"""The port's sum-tree and frame-ring prioritized replay
(ape_x_dqn_tpu_torch/ops/sum_tree.py, replay/frame_ring.py) against the
JAX package's, on the same numpy-seeded segments. JAX's stratification
noise, jax.random.uniform(key, (batch,)) as sum_tree.sample draws it, is
fed to the port, so both descend the same way.

Tolerances: indices, frames, fields and cursors exact; tree sums and
probabilities to 1e-6 relative (float32 sums of the same values);
IS weights to 1e-5 relative (a float32 power of those)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ape_x_dqn_tpu.ops import sum_tree as jtree
from ape_x_dqn_tpu.replay.frame_ring import FrameRingReplay as JaxRing
from ape_x_dqn_tpu_torch.ops import sum_tree as ttree
from ape_x_dqn_tpu_torch.replay.frame_ring import FrameRingReplay

OBS = (10, 10, 4)        # 100-byte frames: rows padded to 128
CAP, SEG, NSTEP = 64, 8, 3


def _noise(key, batch):
    return np.array(jax.random.uniform(key, (batch,)))


def test_sum_tree_update_and_sample_match_jax():
    rng = np.random.default_rng(0)
    cap = 16
    jt, tt = jtree.init(cap), ttree.init(cap)
    for _ in range(3):
        idx = rng.permutation(cap)[:6].astype(np.int32)  # no duplicates
        pri = rng.uniform(0.0, 2.0, 6).astype(np.float32)
        jt = jtree.update(jt, jnp.asarray(idx), jnp.asarray(pri))
        ttree.update(tt, torch.from_numpy(idx), torch.from_numpy(pri))
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
    for size in (None, 11):
        key = jax.random.key(size or 0)
        jl, jp = jtree.sample(jt, key, 32,
                              size=None if size is None else jnp.int32(size))
        tl, tp = ttree.sample(tt, 32, size=size,
                              noise=torch.from_numpy(_noise(key, 32)))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
        if size is not None:
            assert int(tl.max()) < size


def _segments(rng, g, dead_tail=0):
    f = SEG + NSTEP + OBS[2] - 1
    next_off = rng.integers(1, NSTEP + 1, (g, SEG)).astype(np.int32)
    td = rng.uniform(0.1, 2.0, (g, SEG)).astype(np.float32)
    if dead_tail:
        next_off[:, -dead_tail:] = 0
        td[:, -dead_tail:] = 0.0
    items = {
        "seg_frames": rng.integers(0, 255, (g, f, *OBS[:2])).astype(
            np.uint8),
        "action": rng.integers(0, 6, (g, SEG)).astype(np.int32),
        "reward": rng.normal(size=(g, SEG)).astype(np.float32),
        "discount": np.full((g, SEG), 0.99 ** 3, np.float32),
        "next_off": next_off,
    }
    return items, td


def _assert_state_equal(ts, js):
    for k, v in ts.storage.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(js.storage[k]),
                                      err_msg=k)
    np.testing.assert_allclose(ts.tree.numpy(), np.asarray(js.tree),
                               rtol=1e-6)
    assert (ts.pos, ts.size) == (int(js.pos), int(js.size))


def test_frame_ring_add_sample_update_match_jax():
    rng = np.random.default_rng(1)
    jr = JaxRing(CAP, SEG, NSTEP, OBS)
    tr = FrameRingReplay(CAP, SEG, NSTEP, OBS, device="cpu")
    assert (tr.F, tr.S, tr.frame_row) == (jr.F, jr.S, jr.frame_row)
    js, ts = jr.init(), tr.init()
    # 3 segments per add into an 8-segment ring: the 3rd add skips to
    # the head and the 4th overwrites the oldest segments
    for step in range(4):
        items, td = _segments(rng, 3, dead_tail=2 if step % 2 else 0)
        js = jr.add(js, {k: jnp.asarray(v) for k, v in items.items()},
                    jnp.asarray(td))
        tr.add(ts, {k: torch.from_numpy(v) for k, v in items.items()},
               torch.from_numpy(td))
        _assert_state_equal(ts, js)
    assert int(tr.live_transitions(ts)) == int(jr.live_transitions(js))
    assert tr.cursor_transitions(ts) == int(jr.cursor_transitions(js))

    key = jax.random.key(5)
    jitems, jidx, jw = jr.sample(js, key, 24)
    titems, tidx, tw = tr.sample(ts, 24,
                                 noise=torch.from_numpy(_noise(key, 24)))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5)
    for k in ("obs", "next_obs", "action", "reward", "discount"):
        np.testing.assert_array_equal(titems[k].numpy(),
                                      np.asarray(jitems[k]), err_msg=k)
    assert titems["obs"].shape == (24, *OBS)

    # dead slots: valid_mask zero there, and a write-back keeps them dead
    dead = np.flatnonzero(ts.storage["next_off"].numpy() == 0)
    assert dead.size
    idx = np.concatenate([dead[:3], np.asarray(jidx)[:5]])
    idx = np.unique(idx).astype(np.int32)
    np.testing.assert_array_equal(
        tr.valid_mask(ts, torch.from_numpy(idx)).numpy(),
        np.asarray(jr.valid_mask(js, jnp.asarray(idx))))
    td = rng.uniform(0.0, 3.0, idx.size).astype(np.float32)
    js = jr.update_priorities(js, jnp.asarray(idx), jnp.asarray(td))
    tr.update_priorities(ts, torch.from_numpy(idx), torch.from_numpy(td))
    _assert_state_equal(ts, js)
    assert float(ts.tree[CAP + dead[0]]) == 0.0
