"""The port's actor side against the JAX package's: the loopback
transport (ape_x_dqn_tpu_torch/comm/transport.py), the frame-segment
builder (replay/frame_ring.py), the scalar and vector actors
(runtime/actor.py, runtime/vector_actor.py) and the native frame
preprocessing (envs/native.py, cpp/preproc.cpp).

The actors are host numpy seeded exactly as the originals, so the same
config, seed and query function give the same shipped streams: obs,
frames, actions and env-frame counts bitwise; priorities to rtol 1e-6
(float32 |TD| of float64 arithmetic, same formula, same order)."""

import numpy as np
import pytest

from ape_x_dqn_tpu import configs as jcfgs
from ape_x_dqn_tpu.comm.transport import LoopbackTransport as JaxTransport
from ape_x_dqn_tpu.replay.frame_ring import (
    FrameSegmentBuilder as JaxSegmentBuilder)
from ape_x_dqn_tpu.runtime.actor import Actor as JaxActor
from ape_x_dqn_tpu.runtime.vector_actor import VectorActor as JaxVectorActor
from ape_x_dqn_tpu_torch import configs as tcfgs
from ape_x_dqn_tpu_torch.comm.transport import LoopbackTransport, batch_rows
from ape_x_dqn_tpu_torch.envs import native
from ape_x_dqn_tpu_torch.envs.atari import bilinear_resize, grayscale
from ape_x_dqn_tpu_torch.replay.frame_ring import (FrameSegmentBuilder,
                                                   frame_segment_spec)
from ape_x_dqn_tpu_torch.runtime.actor import Actor, actor_epsilon
from ape_x_dqn_tpu_torch.runtime.vector_actor import VectorActor


def _drain(transport) -> list[dict]:
    out = []
    while True:
        b = transport.recv_experience(timeout=0.01)
        if b is None:
            return out
        out.append(b)


def _cat(batches, key):
    return np.concatenate([np.asarray(b[key]) for b in batches])


def _q(obs, n=None):
    """A fixed, obs-dependent Q function (greedy choices vary with the
    observation), the same object for both packages."""
    x = np.asarray(obs, np.float32).reshape(1 if n is None else n, -1)
    cols = [np.sin(x[:, a::7].sum(axis=1) * 0.01 + a) for a in range(6)]
    q = np.stack(cols, axis=1).astype(np.float32)
    return q[0] if n is None else q


# -- transport -------------------------------------------------------------


def test_loopback_drops_oldest_and_counts_like_the_original():
    t, j = LoopbackTransport(max_pending=4), JaxTransport(max_pending=4)
    for i in range(7):
        batch = {"priorities": np.zeros(i + 1, np.float32), "i": i}
        t.send_experience(batch)
        j.send_experience(batch)
    assert t.dropped == j.dropped == 3
    assert t.pending == j.pending == 4
    got = [b["i"] for b in _drain(t)]
    assert got == [b["i"] for b in _drain(j)] == [3, 4, 5, 6]
    assert batch_rows({"priorities": np.zeros((5, 16))}) == 5
    t.publish_params({"w": 1}, 3)
    assert t.get_params() == ({"w": 1}, 3)
    assert t.recv_experience(timeout=0.01) is None


# -- frame segments --------------------------------------------------------


def test_segment_builder_matches_the_original_bitwise():
    """A scripted stream: two episodes (the first ends mid-segment and
    is padded), an episodic-life style reset carrying frames over, and a
    shutdown flush."""
    rng = np.random.default_rng(0)
    b, n, stack = 5, 3, 4
    builders = (FrameSegmentBuilder(b, n, stack),
                JaxSegmentBuilder(b, n, stack))
    out = ([], [])
    for episode_len in (13, 4, 9):
        obs = rng.integers(0, 255, (6, 7, stack), dtype=np.uint8)
        for sb in builders:
            sb.on_reset(obs)
        for t in range(episode_len):
            nxt = rng.integers(0, 255, (6, 7, stack), dtype=np.uint8)
            span = int(rng.integers(1, n + 1))
            fields = (int(rng.integers(6)), float(rng.normal()),
                      float(rng.uniform()), span, float(rng.uniform()))
            for k, sb in enumerate(builders):
                sb.on_step(nxt)
                sb.add(*fields)
                out[k].extend(sb.take_ready())
    for k, sb in enumerate(builders):
        out[k].extend(sb.flush())
    assert len(out[0]) == len(out[1]) > 4
    for got, want in zip(*out):
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    spec = frame_segment_spec(b, n, (6, 7, stack), np.uint8)
    for key, s in spec.items():
        assert out[0][0][key].shape[1:] == s.shape, key


# -- actors ----------------------------------------------------------------


def _actor_cfgs(pkg, num_actors=1):
    return pkg.get_config("cartpole_smoke").replace(
        actors=pkg.ActorConfig(num_actors=num_actors, base_eps=0.6,
                               ingest_batch=16),
        learner=pkg.LearnerConfig(batch_size=32, n_step=3))


def test_epsilon_schedule_matches_the_original():
    from ape_x_dqn_tpu.runtime.actor import actor_epsilon as jax_eps
    for n in (1, 2, 8, 128):
        for i in range(n):
            assert actor_epsilon(i, n) == jax_eps(i, n)


def test_actor_ships_the_originals_stream():
    """cartpole_smoke, 200 frames: the shipped transitions, bitwise."""
    t, j = LoopbackTransport(), JaxTransport()
    assert Actor(_actor_cfgs(tcfgs, 2), 1, _q, t).run(200) == 200
    assert JaxActor(_actor_cfgs(jcfgs, 2), 1, _q, j).run(200) == 200
    bt, bj = _drain(t), _drain(j)
    assert len(bt) == len(bj) > 5
    for key in ("obs", "next_obs", "action", "reward", "discount"):
        np.testing.assert_array_equal(_cat(bt, key), _cat(bj, key),
                                      err_msg=key)
    assert [b["frames"] for b in bt] == [b["frames"] for b in bj]
    assert sum(b["frames"] for b in bt) == 200
    np.testing.assert_allclose(_cat(bt, "priorities"),
                               _cat(bj, "priorities"), rtol=1e-6)


def _catch_cfg(pkg):
    # the original's frame-ring vector actor config
    # (tests/test_vector_actor.py: test_vector_actor_frame_ring_segments)
    return pkg.get_config("pong").replace(
        env=pkg.EnvConfig(id="catch", kind="synthetic_atari"),
        actors=pkg.ActorConfig(num_actors=1, envs_per_actor=3,
                               ingest_batch=16),
        replay=pkg.ReplayConfig(kind="prioritized", capacity=4096,
                                min_fill=64, storage="frame_ring",
                                seg_transitions=8),
        learner=pkg.LearnerConfig(batch_size=16, n_step=3))


def test_vector_actor_ships_the_originals_segments():
    """Synthetic catch in frame-ring mode, 3 envs, 300 frames: the
    shipped segments' frames and fields bitwise."""
    t, j = LoopbackTransport(), JaxTransport()
    ft = VectorActor(_catch_cfg(tcfgs), 0, _q, t).run(300)
    fj = JaxVectorActor(_catch_cfg(jcfgs), 0, _q, j).run(300)
    assert ft == fj >= 300
    bt, bj = _drain(t), _drain(j)
    assert len(bt) == len(bj) > 10
    for key in ("seg_frames", "action", "reward", "discount", "next_off"):
        np.testing.assert_array_equal(_cat(bt, key), _cat(bj, key),
                                      err_msg=key)
    assert [b["frames"] for b in bt] == [b["frames"] for b in bj]
    np.testing.assert_allclose(_cat(bt, "priorities"),
                               _cat(bj, "priorities"), rtol=1e-6)
    # greedy choices happened (the fixed Q varies with the obs)
    assert len(np.unique(_cat(bt, "action"))) > 1


# -- native preprocessing --------------------------------------------------


@pytest.mark.parametrize("two_frames", [True, False])
def test_native_preproc_is_bit_equal_to_numpy_and_the_original(two_frames):
    from ape_x_dqn_tpu.envs import native as jax_native

    assert native.available(), "g++ could not build cpp/preproc.cpp"
    rng = np.random.default_rng(3)
    for h, w, out in ((210, 160, 84), (64, 48, 30), (84, 84, 84)):
        a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        b = rng.integers(0, 256, (h, w, 3), dtype=np.uint8) \
            if two_frames else None
        got = native.preproc(a, b, out, out)
        fm = a if b is None else np.maximum(a, b)
        want = np.clip(bilinear_resize(grayscale(fm), out, out),
                       0, 255).astype(np.uint8)
        np.testing.assert_array_equal(got, want)
        ref = jax_native.preproc(a, b, out, out)
        if ref is not None:
            np.testing.assert_array_equal(got, ref)


def test_native_library_builds_into_the_package_build_dir():
    assert native.available()
    so = list(native.BUILD_DIR.glob("libapex_preproc.*.so"))
    assert so, f"no library under {native.BUILD_DIR}"
