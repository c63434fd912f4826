"""The port's socket transport (comm/socket_transport.py), ported from
tests/test_comm.py: the learner-side server and the actor-side client
over real loopback sockets, the wire-codec negotiation matrix, the
bf16 param wire, connection tracking and lossy sends. Against the JAX
package: a client of either package talks to a server of the other
(experience both ways, coded param pulls), and the port's server counts
telemetry frames and drops them while no fleet aggregator is
installed."""

import threading
import time

import numpy as np
import pytest

from ape_x_dqn_tpu.comm import socket_transport as jax_st
from ape_x_dqn_tpu_torch.comm.socket_transport import (
    SocketIngestServer, SocketTransport, decode_batch, encode_batch)


def _codec_batch(seed=0, n=16):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 60, (4, 84, 84), dtype=np.uint8)
    frames = np.stack([np.roll(base, i, axis=1) for i in range(n)])
    return {
        "seg_frames": frames,
        "action": rng.integers(0, 18, (n,)).astype(np.int32),
        "done": rng.random(n) < 0.1,
        "priorities": (rng.random(n) + 0.1).astype(np.float32),
        "actor": 1, "frames": n,
    }


def _assert_batches_equal(got, batch):
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def test_server_get_params_caches_deserialized_tree():
    """The learner-host local param pull must not pay a pickle
    round-trip per call: the deserialized tree is cached per version
    and invalidated on the next publish."""
    server = SocketIngestServer("127.0.0.1", 0)
    try:
        server.publish_params({"w": np.ones(3, np.float32)}, 5)
        p1, v1 = server.get_params()
        p2, v2 = server.get_params()
        assert v1 == v2 == 5
        assert p1["w"] is p2["w"]  # cached, not re-deserialized
        server.publish_params({"w": np.full(3, 2.0, np.float32)}, 6)
        p3, v3 = server.get_params()
        assert v3 == 6
        np.testing.assert_array_equal(p3["w"], np.full(3, 2.0))
    finally:
        server.stop()


def test_server_stop_drains_parked_batches():
    """stop() must drain the bounded ingest queue and release()
    whatever is parked in it — a batch stranded there at shutdown pins
    its resources (for an shm slot batch, the ring slot AND the
    mapping)."""
    class Releasable(dict):
        released = 0

        def release(self):
            type(self).released += 1

    server = SocketIngestServer("127.0.0.1", 0)
    try:
        for i in range(3):
            server.send_experience(Releasable(actor=i))
        assert server._q.qsize() == 3
    finally:
        server.stop()
    assert server._q.qsize() == 0
    assert Releasable.released == 3


def test_loopback_close_drains_queue():
    """LoopbackTransport.close() drains the bounded queue, so parked
    batches are not pinned by a transport nobody will read again."""
    from ape_x_dqn_tpu_torch.comm.transport import LoopbackTransport

    t = LoopbackTransport(max_pending=4)
    for i in range(3):
        t.send_experience({"actor": i})
    assert t.pending == 3
    t.close()
    assert t.pending == 0
    t.close()  # idempotent on an empty queue


def test_wire_codec_interop_matrix():
    """Every (server wire_codec) x (client wire_codec) combination over
    a REAL socket pair delivers bitwise-identical experience, and the
    negotiated codec is delta-deflate iff both sides want it."""
    batch = _codec_batch(seed=3)
    for srv_codec in ("raw", "delta-deflate"):
        for cli_codec in ("raw", "delta-deflate"):
            server = SocketIngestServer("127.0.0.1", 0,
                                        wire_codec=srv_codec)
            client = SocketTransport("127.0.0.1", server.port,
                                     wire_codec=cli_codec)
            try:
                client.send_experience(batch)
                got = server.recv_experience(timeout=5.0)
                assert got is not None, (srv_codec, cli_codec)
                _assert_batches_equal(got, batch)
                want = "delta-deflate" \
                    if srv_codec == cli_codec == "delta-deflate" else "raw"
                assert client.negotiated_codec == want
                if want == "delta-deflate":
                    assert server.wire_compression_ratio > 1.5
                    assert client.wire_compression_ratio > 1.5
            finally:
                client.close()
                server.stop()


def test_wire_codec_raw_fallback_on_silent_server():
    """An OLD server never acks MSG_HELLO (unknown types fall through
    its reader) — the client must time out and degrade to raw, and the
    raw message must still arrive. Simulated with a minimal reader that
    ignores everything but experience messages."""
    import socket as socket_mod

    from ape_x_dqn_tpu_torch.comm.socket_transport import (
        MSG_EXPERIENCE, _recv_msg)

    listener = socket_mod.socket(socket_mod.AF_INET,
                                 socket_mod.SOCK_STREAM)
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    got: list = []

    def old_server():
        conn, _ = listener.accept()
        while True:
            msg = _recv_msg(conn)
            if msg is None:
                return
            if msg[0] == MSG_EXPERIENCE:  # hellos silently ignored
                got.append(msg[1])
                return

    thread = threading.Thread(target=old_server, daemon=True)
    thread.start()
    client = SocketTransport("127.0.0.1", listener.getsockname()[1],
                             hello_timeout=0.3)
    try:
        batch = _codec_batch(seed=4)
        client.send_experience(batch)
        assert client.negotiated_codec == "raw"
        thread.join(timeout=5)
        assert got, "old server never received the raw experience"
        _assert_batches_equal(decode_batch(got[0]), batch)
    finally:
        client.close()
        listener.close()


def test_socket_transport_experience_and_params():
    server = SocketIngestServer("127.0.0.1", 0)
    client = SocketTransport("127.0.0.1", server.port)
    try:
        # params flow learner -> actor
        server.publish_params({"w": np.ones(3, np.float32)}, 5)
        params, version = client.get_params()
        assert version == 5
        np.testing.assert_array_equal(params["w"], np.ones(3))

        # experience flows actor -> learner
        batch = {"obs": np.zeros((4, 2), np.float32),
                 "priorities": np.ones(4, np.float32), "actor": 0,
                 "frames": 4}
        client.send_experience(batch)
        got = server.recv_experience(timeout=5.0)
        assert got is not None and got["frames"] == 4
        np.testing.assert_array_equal(got["priorities"], batch["priorities"])
    finally:
        client.close()
        server.stop()


def test_param_wire_dtype_bf16_halves_blob():
    """The weight broadcast ships f32 params as bf16 (half the bytes)
    and the receiver upcasts back to f32 with only bf16 rounding
    applied — ml_dtypes' rounding, made here with torch."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(256, 256)).astype(np.float32),
              "b": rng.normal(size=256).astype(np.float32),
              "frames": np.zeros((4, 4), np.uint8)}  # non-float: as-is
    bf = SocketIngestServer("127.0.0.1", 0)  # default bfloat16
    f32 = SocketIngestServer("127.0.0.1", 0,
                             param_wire_dtype="float32")
    try:
        bf.publish_params(params, 3)
        f32.publish_params(params, 3)
        assert len(bf._param_blob()) < 0.6 * len(f32._param_blob())
        got, version = bf.get_params()
        assert version == 3
        assert got["w"].dtype == np.float32  # receiver upcasts
        assert got["frames"].dtype == np.uint8
        # values survive with bf16 rounding only (~2^-8 relative)
        np.testing.assert_allclose(got["w"], params["w"],
                                   rtol=1 / 128, atol=1e-6)
        exact = np.asarray(params["w"]).astype(
            ml_dtypes.bfloat16).astype(np.float32)
        np.testing.assert_array_equal(got["w"], exact)
        # the exact path stays bit-identical
        got32, _ = f32.get_params()
        np.testing.assert_array_equal(got32["w"], params["w"])
    finally:
        bf.stop()
        f32.stop()


def test_conn_tracking_under_connect_disconnect_hammer():
    """_conns is mutated by the accept + reader threads while the
    driver's idle check reads it: hammer
    connect/disconnect cycles against concurrent active_connections /
    quiesced readers and assert the count settles to exactly zero with
    the debounce behaving."""
    import socket as socketlib
    import threading
    import time

    server = SocketIngestServer("127.0.0.1", 0, idle_grace_s=2.0)
    stop = threading.Event()
    snapshots: list[int] = []

    def reader():
        while not stop.is_set():
            n = server.active_connections
            assert n >= 0
            snapshots.append(n)
            server.quiesced()  # must never raise mid-churn

    rthreads = [threading.Thread(target=reader, daemon=True)
                for _ in range(2)]
    for t in rthreads:
        t.start()
    try:
        saw_open = False
        for it in range(30):
            socks = [socketlib.create_connection(("127.0.0.1", server.port),
                                                 timeout=5)
                     for _ in range(4)]
            if not saw_open:
                # observe a live count at least once while socks are open
                # (the accept thread needs a moment on a 1-core host)
                deadline = time.monotonic() + 5
                while (server.active_connections == 0
                       and time.monotonic() < deadline):
                    time.sleep(0.01)
                saw_open = server.active_connections > 0
            for s in socks:
                s.close()
        assert saw_open, "accept loop never registered a connection"
        deadline = time.monotonic() + 5
        while server.active_connections and time.monotonic() < deadline:
            time.sleep(0.05)
        assert server.active_connections == 0
        assert snapshots, "concurrent readers never ran"
        # a disconnect just happened: the idle verdict must debounce
        assert not server.quiesced()
        # ... and eventually clear. Poll rather than a single sleep:
        # sockets closed before being accepted can be accepted LATE by
        # the 0.2s-poll accept loop, refreshing the disconnect stamp
        # after the settle check (seen flaky under full-suite load)
        deadline = time.monotonic() + 20
        while not server.quiesced() and time.monotonic() < deadline:
            time.sleep(0.2)
        assert server.quiesced()
    finally:
        stop.set()
        for t in rthreads:
            t.join(timeout=2)
        server.stop()


def test_socket_client_survives_dead_server():
    """Ingest is lossy-tolerant: a broken connection must not raise into
    the actor loop — batches count as dropped."""
    server = SocketIngestServer("127.0.0.1", 0)
    port = server.port
    client = SocketTransport("127.0.0.1", port)
    batch = {"x": np.ones(2, np.float32), "priorities": np.ones(2),
             "actor": 0}
    client.send_experience(batch)
    assert server.recv_experience(timeout=5.0) is not None
    server.stop()
    time.sleep(0.2)
    # the first sends may land in the kernel buffer before the RST
    # surfaces; keep sending until the client notices and starts dropping
    for _ in range(20):
        client.send_experience(batch)  # must never raise
        if client.dropped:
            break
        time.sleep(0.05)
    assert client.dropped >= 1
    client.close()


def test_param_only_probe_is_not_a_producer():
    """ever_connected must latch on the first EXPERIENCE message, not
    on accept: a param-only client (monitoring probe, or an actor host
    that died waiting for params) that comes and goes during learner
    construction would otherwise skip the boot grace AND read as a
    departed producer, and end a remote-only learner at once."""
    server = SocketIngestServer("127.0.0.1", 0)
    client = SocketTransport("127.0.0.1", server.port)
    try:
        server.publish_params({"w": np.ones(2, np.float32)}, 1)
        params, _ = client.get_params()   # param-only connection
        assert params is not None
        client.close()
        time.sleep(0.3)
        assert server.ever_connected is False  # probe, not producer

        client2 = SocketTransport("127.0.0.1", server.port)
        client2.send_experience({"obs": np.zeros((2, 2), np.float32),
                                 "priorities": np.ones(2, np.float32),
                                 "frames": 2})
        got = server.recv_experience(timeout=5.0)
        assert got is not None
        assert server.ever_connected is True   # real producer
        client2.close()
    finally:
        client.close()
        server.stop()


def test_non_f32_leaves_keep_dtype_on_the_wire():
    """Only leaves the SENDER downcast are upcast at the receiver:
    float16 and integer leaves keep their dtype under both wire
    dtypes."""
    params = {"w32": np.ones((8, 8), np.float32),
              "w16": np.full((8, 8), 1.5, np.float16),
              "n": np.arange(4, dtype=np.int64)}
    for wire in ("bfloat16", "float32"):
        srv = SocketIngestServer("127.0.0.1", 0, param_wire_dtype=wire)
        try:
            srv.publish_params(params, 1)
            got, _ = srv.get_params()
            assert got["w32"].dtype == np.float32, wire
            assert got["w16"].dtype == np.float16, wire
            np.testing.assert_array_equal(got["w16"], params["w16"])
            np.testing.assert_array_equal(got["n"], params["n"])
        finally:
            srv.stop()


def test_telemetry_frames_are_counted_and_dropped():
    """A host that ships telemetry (negotiated in the hello) reaches a
    server with no fleet aggregator: the frames are counted, nothing
    crashes, and experience keeps flowing on the same connection."""
    srv = SocketIngestServer("127.0.0.1", 0)
    client = SocketTransport("127.0.0.1", srv.port, telemetry=True)
    try:
        client.send_experience(_codec_batch(n=2))
        assert srv.recv_experience(timeout=5.0) is not None
        assert client.telemetry_negotiated
        for i in range(3):
            assert client.send_telemetry({"peer": "host-a", "seq": i})
        deadline = time.monotonic() + 5
        while srv.telemetry_frames < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert srv.telemetry_frames == 3
        client.send_experience(_codec_batch(seed=1, n=2))
        got = srv.recv_experience(timeout=5.0)
        assert got is not None and got["frames"] == 2
        assert client.reconnects == 0 and srv.wire_decode_errors == 0
    finally:
        client.close()
        srv.stop()


@pytest.mark.parametrize("codec", ["raw", "delta-deflate"])
@pytest.mark.parametrize("pair", ["jax_client_torch_server",
                                  "torch_client_jax_server"])
def test_packages_interoperate_over_a_socket(pair, codec):
    """One package's actor-side client and the other's learner-side
    server: the hello negotiates the codec, experience arrives bitwise,
    and coded param pulls (a full, then a q8 delta) decode to the same
    values the server's own package reconstructs."""
    import ml_dtypes

    if pair == "jax_client_torch_server":
        cli_cls = jax_st.SocketTransport
        srv = SocketIngestServer("127.0.0.1", 0, wire_codec=codec,
                                 param_codec="delta-q8")
    else:
        srv = jax_st.SocketIngestServer("127.0.0.1", 0, wire_codec=codec,
                                        param_codec="delta-q8")
        cli_cls = SocketTransport
    client = cli_cls("127.0.0.1", srv.port, wire_codec=codec,
                     param_codec="delta-q8", connect_timeout=5.0)
    try:
        batch = _codec_batch(seed=7)
        client.send_experience(batch)
        got = srv.recv_experience(timeout=5.0)
        assert got is not None
        _assert_batches_equal(got, batch)
        assert client.negotiated_codec == codec
        rng = np.random.default_rng(3)
        w = rng.standard_normal((64, 32)).astype(np.float32)
        srv.publish_params({"w": w, "n": np.arange(3)}, 0)
        p, v = client.get_params()
        assert v == 0
        np.testing.assert_array_equal(
            p["w"], w.astype(ml_dtypes.bfloat16).astype(np.float32))
        w1 = (w + 0.01 * rng.standard_normal(w.shape)).astype(np.float32)
        srv.publish_params({"w": w1, "n": np.arange(3)}, 1)
        p, v = client.get_params()
        assert v == 1
        want = w1.astype(ml_dtypes.bfloat16).astype(np.float32)
        assert np.abs(p["w"] - want).max() < 4e-3
        assert srv.param_compression_ratio > 1.0
    finally:
        client.close()
        srv.stop()
