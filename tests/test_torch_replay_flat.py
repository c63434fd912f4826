"""The port's flat replay (ape_x_dqn_tpu_torch/replay/packing.py
PixelPacker, replay/prioritized.py PrioritizedReplay and
UniformReplayDevice) against the JAX package's, on the same
numpy-seeded transitions. JAX's draws (the stratification noise
jax.random.uniform(key, (B,)) and the uniform indices
jax.random.randint(key, (B,), 0, size)) are fed to the port.

Tolerances: packed rows, stored items, sampled items, indices and
cursors exact (they are copies); tree sums to 1e-6 relative after adds
(float32 sums of the same values) and 1e-5 after a priority update (a
float32 power of |TD|); IS weights to 1e-6 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ape_x_dqn_tpu.replay.packing import make_packer as jax_make_packer
from ape_x_dqn_tpu.replay.prioritized import PrioritizedReplay as JaxPER
from ape_x_dqn_tpu.replay.prioritized import UniformReplayDevice as JaxUni
from ape_x_dqn_tpu.runtime.learner import (
    transition_item_spec as jax_item_spec)
from ape_x_dqn_tpu_torch.replay.packing import ItemSpec, make_packer
from ape_x_dqn_tpu_torch.replay.prioritized import (PrioritizedReplay,
                                                    UniformReplayDevice)
from ape_x_dqn_tpu_torch.runtime.learner import transition_item_spec

OBS = (42, 42, 4)          # 7056 bytes: packed into 7168-byte rows


def _transitions(rng, b):
    return {
        "obs": rng.integers(0, 255, (b, *OBS)).astype(np.uint8),
        "action": rng.integers(0, 6, b).astype(np.int32),
        "reward": rng.normal(size=b).astype(np.float32),
        "next_obs": rng.integers(0, 255, (b, *OBS)).astype(np.uint8),
        "discount": np.full(b, 0.97, np.float32),
    }


def _both(items):
    return ({k: jnp.asarray(v) for k, v in items.items()},
            {k: torch.from_numpy(v) for k, v in items.items()})


def _assert_storage_equal(ts, js):
    assert sorted(ts.storage) == sorted(js.storage)
    for k, v in ts.storage.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(js.storage[k]),
                                      err_msg=k)
    assert (ts.pos, ts.size) == (int(js.pos), int(js.size))


def test_pixel_packer_matches_jax():
    """Storage spec, encoded rows and decoded frames, for a spec with a
    packed stack, a small uint8 leaf that stays unpacked, and scalars."""
    spec = {**transition_item_spec(OBS, np.uint8),
            "small": ItemSpec((10, 10), torch.uint8)}
    jspec = {**jax_item_spec(OBS, np.uint8),
             "small": jax.ShapeDtypeStruct((10, 10), jnp.uint8)}
    tp, tss = make_packer(spec)
    jp, jss = jax_make_packer(jspec)
    assert list(tss) == sorted(jss)
    for k, s in tss.items():
        assert tuple(s.shape) == jss[k].shape, k
        assert str(s.dtype).split(".")[-1] == str(jss[k].dtype), k
    assert tss["obs"].shape == (7168,) and tss["small"].shape == (10, 10)

    rng = np.random.default_rng(0)
    items = {**_transitions(rng, 5),
             "small": rng.integers(0, 255, (5, 10, 10)).astype(np.uint8)}
    jitems, titems = _both(items)
    tenc, jenc = tp.encode(titems), jp.encode(jitems)
    for k in jenc:
        np.testing.assert_array_equal(tenc[k].numpy(), np.asarray(jenc[k]),
                                      err_msg=k)
    assert not tenc["obs"][:, 7056:].any()          # zero pad
    tdec = tp.decode(tenc)
    for k, v in items.items():
        np.testing.assert_array_equal(tdec[k].numpy(), v, err_msg=k)
    # decode is a view of the gathered rows
    assert tdec["obs"].data_ptr() == tenc["obs"].data_ptr()
    # nothing packable: no packer, the spec passes through
    assert make_packer(transition_item_spec((4,), np.float32))[0] is None


def test_flat_prioritized_add_sample_update_match_jax():
    """Blocks of 50 into capacity 256: the sixth add skips to the head,
    retiring tail slots 250..255 (size stays 250, no priority there),
    and the seventh overwrites the next-oldest slots. Then one
    stratified draw with JAX's noise and one priority write-back."""
    rng = np.random.default_rng(1)
    cap, block = 256, 50
    jr = JaxPER(cap, item_spec=jax_item_spec(OBS, np.uint8))
    tr = PrioritizedReplay(cap, device="cpu",
                           item_spec=transition_item_spec(OBS, np.uint8))
    js, ts = jr.init(), tr.init()
    assert ts.storage["obs"].shape == (cap, 7168)
    for _ in range(7):
        jitems, titems = _both(_transitions(rng, block))
        td = rng.uniform(0.1, 2.0, block).astype(np.float32)
        js = jr.add(js, jitems, jnp.asarray(td))
        tr.add(ts, titems, torch.from_numpy(td))
        _assert_storage_equal(ts, js)
        np.testing.assert_allclose(ts.tree.numpy(), np.asarray(js.tree),
                                   rtol=1e-6)
    assert (ts.pos, ts.size) == (100, 250)
    assert not ts.tree[cap + 250:].any()

    key = jax.random.key(7)
    jitems, jidx, jw = jr.sample(js, key, 64)
    titems, tidx, tw = tr.sample(ts, 64, noise=torch.from_numpy(
        np.array(jax.random.uniform(key, (64,)))))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert int(tidx.max()) < 250
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    for k in jitems:
        np.testing.assert_array_equal(titems[k].numpy(),
                                      np.asarray(jitems[k]), err_msg=k)
    assert titems["obs"].shape == (64, *OBS)

    idx = np.unique(np.asarray(jidx)).astype(np.int32)  # no duplicates
    td = rng.uniform(0.0, 3.0, idx.size).astype(np.float32)
    js = jr.update_priorities(js, jnp.asarray(idx), jnp.asarray(td))
    tr.update_priorities(ts, torch.from_numpy(idx), torch.from_numpy(td))
    np.testing.assert_allclose(ts.tree.numpy(), np.asarray(js.tree),
                               rtol=1e-5)


def test_uniform_replay_add_and_sample_with_fed_indices_match_jax():
    rng = np.random.default_rng(2)
    cap = 64
    jr = JaxUni(cap)
    tr = UniformReplayDevice(cap, device="cpu")
    js = jr.init(jax_item_spec(OBS, np.uint8))
    ts = tr.init(transition_item_spec(OBS, np.uint8))
    for b in (24, 24, 24):            # the third add skips to the head
        jitems, titems = _both(_transitions(rng, b))
        js = jr.add(js, jitems)
        tr.add(ts, titems)
        _assert_storage_equal(ts, js)
    key = jax.random.key(3)
    jitems, jidx, jw = jr.sample(js, key, 32)
    idx = jax.random.randint(key, (32,), 0, jnp.maximum(js.size, 1))
    titems, tidx, tw = tr.sample(ts, 32, torch.from_numpy(np.array(idx)))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    for k in jitems:
        np.testing.assert_array_equal(titems[k].numpy(),
                                      np.asarray(jitems[k]), err_msg=k)
    # no tree: write-backs are no-ops and priorities read as zeros
    assert tr.update_state(ts, tidx, torch.ones(32)) is ts
    assert not tr.leaf_priorities(ts, tidx).any()
    assert tr.cursor_transitions(ts) == int(jr.cursor_transitions(js))
    # a draw from the generator stays inside the filled slots
    g = torch.Generator().manual_seed(0)
    _, idx2, _ = tr.sample_state(ts, 256, None, g)
    assert 0 <= int(idx2.min()) and int(idx2.max()) < ts.size
