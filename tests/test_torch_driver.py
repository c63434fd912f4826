"""The port's ingest staging and driver against the JAX package's, hand
stepped (no threads):

- IngestStager (runtime/ingest.py) against the original with recording
  ship callbacks: the same puts give the same shipped blocks (bitwise),
  the same coalesce widths g in the same order, the same tail and the
  same discard;
- the driver's force-flush tail-drop accounting, flat and frame ring
  (the single-chip forms of tests/test_ingest.py);
- the whole slice: one actor stream recorded from the JAX VectorActor
  (synthetic catch, frame-ring mode, a fixed query function) goes
  through `_ingest_one` and `_flush_stage(force=True)` of a JAX
  ApexDriver and of the port's, both from one config and seed, the
  port's weights converted from JAX's. The replay storage must then be
  bitwise equal, the leaf priorities within 1e-6 and the inner sums to
  1e-6 relative; then train_many(state, 8)
  (two K=4 macro-steps, JAX's own stratification noise fed to the port)
  gives loss and params within 2e-6 (float32, 8 Adam steps: under the
  13-step limit where rounding-level gradients can flip an update)."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu import configs as jcfgs
from ape_x_dqn_tpu.comm.transport import LoopbackTransport as JaxTransport
from ape_x_dqn_tpu.runtime.driver import ApexDriver as JaxDriver
from ape_x_dqn_tpu.runtime.ingest import IngestStager as JaxStager
from ape_x_dqn_tpu.runtime.vector_actor import VectorActor as JaxVectorActor
from ape_x_dqn_tpu_torch import configs as tcfgs
from ape_x_dqn_tpu_torch.models.convert import from_flax
from ape_x_dqn_tpu_torch.replay.packing import ItemSpec
from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
from ape_x_dqn_tpu_torch.runtime.ingest import IngestStager

# -- IngestStager ----------------------------------------------------------

SPEC = {"obs": ((3, 2), np.uint8), "action": ((), np.int32),
        "reward": ((), np.float32)}


def _stagers():
    shipped = ([], [])

    def tship(views, g):
        shipped[0].append((g, {k: v.numpy().copy()
                               for k, v in views.items()}))
        return []

    def jship(views, g):
        shipped[1].append((g, {k: np.array(v) for k, v in views.items()}))
        return []

    t = IngestStager({k: ItemSpec(s, torch.from_numpy(np.zeros(0, d)).dtype)
                      for k, (s, d) in SPEC.items()}, (4,), block_units=3,
                     coalesce=2, buffers=2, ship=tship)
    j = JaxStager({k: SimpleNamespace(shape=s, dtype=d)
                   for k, (s, d) in SPEC.items()}, (4,), block_units=3,
                  coalesce=2, buffers=2, ship=jship)
    return t, j, shipped


def test_stager_ships_the_originals_blocks():
    t, j, shipped = _stagers()
    rng = np.random.default_rng(0)
    # puts that split across buffer boundaries, drains with and without
    # a remainder, then a tail that is discarded
    for n, drain in ((2, False), (5, False), (4, True), (7, False),
                     (3, True), (3, True), (2, False)):
        batch = {k: rng.integers(0, 100, (n, *s)).astype(d)
                 for k, (s, d) in SPEC.items()}
        batch["priorities"] = rng.random((n, 4)).astype(np.float32)
        for s in (t, j):
            s.put(batch)
            if drain:
                assert s.drain() >= 0
    assert [g for g, _ in shipped[0]] == [g for g, _ in shipped[1]]
    assert [g for g, _ in shipped[0]] == [2, 1, 2, 2, 1]
    for (_, got), (_, want) in zip(*shipped):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert t.tail_units() == j.tail_units() > 0
    np.testing.assert_array_equal(t.tail_view("obs"), j.tail_view("obs"))
    assert t.tail_shard_units(1) == j.tail_shard_units(1)
    assert t.occupancy() == j.occupancy()
    for s in (t, j):
        s.discard_tail()
    assert t.tail_units() == j.tail_units() == 0


# -- tail-drop accounting (tests/test_ingest.py, single-chip forms) --------


def _flat_cfg(pkg):
    return pkg.get_config("cartpole_smoke").replace(
        replay=pkg.ReplayConfig(kind="prioritized", capacity=2048,
                                min_fill=64),
        learner=pkg.LearnerConfig(batch_size=32, n_step=3,
                                  target_sync_every=100, publish_every=20),
        actors=pkg.ActorConfig(num_actors=1, base_eps=0.5, ingest_batch=16),
        inference=pkg.InferenceConfig(max_batch=4, deadline_ms=0.5),
        eval_every_steps=0, eval_episodes=0)


def _ring_cfg(pkg, **learner):
    lcfg = dict(batch_size=32, n_step=3, target_sync_every=100,
                publish_every=20)
    lcfg.update(learner)
    return pkg.RunConfig(
        name="catch",
        env=pkg.EnvConfig(id="catch", kind="synthetic_atari", frame_skip=4,
                          max_noop_start=4),
        network=pkg.NetworkConfig(kind="nature_cnn", dueling=True,
                                  cnn_channels=(8, 16, 16), torso_dense=32,
                                  compute_dtype="float32"),
        replay=pkg.ReplayConfig(kind="prioritized", capacity=1024,
                                min_fill=128, storage="frame_ring",
                                seg_transitions=8, segs_per_add=2),
        learner=pkg.LearnerConfig(**lcfg),
        actors=pkg.ActorConfig(num_actors=1, base_eps=0.5, ingest_batch=8,
                               envs_per_actor=3),
        inference=pkg.InferenceConfig(max_batch=4, deadline_ms=0.5),
        eval_every_steps=0, eval_episodes=0)


def _synth_batch(driver, n, seed=0, frames=None):
    rng = np.random.default_rng(seed)
    batch = {}
    for k, s in driver._item_spec.items():
        dtype = torch.zeros(0, dtype=s.dtype).numpy().dtype
        shape = (n,) + tuple(s.shape)
        if np.issubdtype(dtype, np.integer):
            batch[k] = rng.integers(0, 3, size=shape).astype(dtype)
        else:
            batch[k] = (rng.random(shape) * 4).astype(dtype)
    ptail = (driver.cfg.replay.seg_transitions,) if driver._frame_mode \
        else ()
    batch["priorities"] = rng.random((n,) + ptail).astype(np.float32)
    if frames is not None:
        batch["frames"] = frames
    return batch


@pytest.fixture
def drivers():
    made = []

    def make(cls, cfg, **kw):
        d = cls(cfg, **kw)
        made.append(d)
        return d

    yield make
    for d in made:
        d.server.stop()


def test_flat_tail_drop_accounting(drivers):
    """Flat: 1 unit = 1 env frame; the dropped tail comes OFF the frame
    count so frames reconcile with replay contents."""
    d = drivers(ApexDriver, _flat_cfg(tcfgs), device="cpu")
    block = d.dp * d._stage_chunk
    tail = 3
    d._ingest_one(_synth_batch(d, block + tail), block + tail)
    d._flush_stage(force=True)
    assert d._stage_dropped == tail
    assert d._stage_dropped_per_shard.tolist() == [tail]
    assert d._frames_total == block
    assert d._replay_filled == block * d._unit_items
    assert d.state.replay.size == block


def test_frame_ring_tail_drop_accounting(drivers):
    """Frame ring: dropped segments count their LIVE transitions
    (next_off > 0); the frame count stays."""
    d = drivers(ApexDriver, _ring_cfg(tcfgs), device="cpu")
    block = d.dp * d._stage_chunk
    batch = _synth_batch(d, block + 1, frames=37)
    batch["next_off"][block:] = 0
    batch["next_off"][block:, :5] = 2  # 5 live transitions in the tail
    d._ingest_one(batch, block + 1)
    d._flush_stage(force=True)
    assert d._stage_dropped == 5
    assert d._frames_total == 37
    assert d._replay_filled == block * d._unit_items
    assert d.state.replay.pos == block


# -- the whole slice, hand stepped -----------------------------------------


def _fixed_q(obs, n):
    x = np.asarray(obs, np.float32).reshape(n, -1)
    return np.stack([np.cos(x[:, a::5].sum(axis=1) * 0.003 + a)
                     for a in range(6)], axis=1).astype(np.float32)


def test_whole_slice_matches_the_jax_driver(drivers):
    k, b = 4, 16
    lcfg = dict(batch_size=b, sample_chunk=k, target_sync_every=3, lr=1e-3)
    tcfg, jcfg = _ring_cfg(tcfgs, **lcfg), _ring_cfg(jcfgs, **lcfg)
    # one recorded actor stream, from the JAX vector actor
    jt = JaxTransport(max_pending=10**6)
    JaxVectorActor(jcfg, 0, _fixed_q, jt).run(240)
    stream = []
    while (batch := jt.recv_experience(timeout=0.01)) is not None:
        stream.append(batch)
    assert len(stream) >= 20

    jd = drivers(JaxDriver, jcfg)
    td = drivers(ApexDriver, tcfg, device="cpu")
    sd = from_flax(jax.tree.map(np.asarray, jd.state.params))
    td.state.net.load_state_dict(sd)
    td.state.target_net.load_state_dict(sd)
    # the reference ships a snapshot of its staged rows: on the CPU
    # backend jax.device_put aliases float32 and int32 numpy rows instead
    # of copying them, so the JAX stager's wait on the put handles
    # returns at once, and an add dispatched asynchronously could read
    # rows that the stager has meanwhile rewritten with the next batch
    # (a buffer's reuse, or a drain's compaction): on a loaded machine
    # the JAX replay then held the wrong transitions
    jship = jd._stager._ship
    jd._stager._ship = lambda views, g: jship(
        {k: np.array(v, copy=True) for k, v in views.items()}, g)
    for batch in stream:
        n = int(np.shape(batch["priorities"])[0])
        jd._ingest_one(dict(batch), n)
        td._ingest_one(dict(batch), n)
    jd._flush_stage(force=True)
    td._flush_stage(force=True)

    # ingest: the same accounting, the same replay bits
    assert td._frames_total == jd._frames_total == 240
    assert td._stage_dropped == jd._stage_dropped
    assert td._replay_filled == jd._replay_filled > 0
    jr, tr = jd.state.replay, td.state.replay
    assert (tr.pos, tr.size) == (int(jr.pos), int(jr.size))
    for key, v in tr.storage.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jr.storage[key]),
                                      err_msg=key)
    cap = td.capacity
    np.testing.assert_allclose(tr.tree.numpy()[cap:],
                               np.asarray(jr.tree)[cap:], rtol=0, atol=1e-6)
    # inner sums: float32 additions of those leaves
    np.testing.assert_allclose(tr.tree.numpy(), np.asarray(jr.tree),
                               rtol=1e-6)

    # learning: train_many(8) = two K=4 macro-steps on JAX's draws
    rng, noise = jd.state.rng, []
    for _ in range(2):
        rng, sk = jax.random.split(rng)
        noise.append(torch.from_numpy(np.array(
            jax.random.uniform(sk, (k * b,)))))
    jstate, jm = jd.learner.train_many(jd.state, 8)
    tstate, tm = td.learner.train_many(td.state, 8, noise)
    assert tstate.step == int(jstate.step) == 8
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=0, atol=2e-6)
    for name, got, want in (("params", tstate.net, jstate.params),
                            ("target", tstate.target_net,
                             jstate.target_params)):
        want = from_flax(jax.tree.map(np.asarray, want))
        for key, v in got.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[key].numpy(), rtol=0,
                                       atol=2e-6, err_msg=f"{name}.{key}")
    np.testing.assert_allclose(tstate.replay.tree.numpy(),
                               np.asarray(jstate.replay.tree), rtol=1e-5,
                               atol=1e-6)
