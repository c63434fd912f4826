"""The port's param-plane codec (comm/param_codec.py), ported from
tests/test_param_codec.py: delta+q8 chain
encode/decode, never-inflate floors, resync-on-missed-version and
epoch-bump semantics, old<->new interop in both directions, the raw
escape hatch's bitwise compatibility, cross-impl quantizer bit-parity
(a wire contract — native kernel vs numpy fallback), per-subscriber
fan-out isolation, and the cross-plane consistency of the one
versioned-blob provider (legacy blob == APXV reply == coded full ==
local get_params). Against the JAX package: coded full and delta
payloads cross-decode in both directions on the same numpy tree, the
port's flattener keeps JAX's leaf order, and the bf16 wire rounding
(torch, no ml_dtypes) equals ml_dtypes byte for byte. The port's push
dispatcher pairs each version with the epoch it was published under,
so test_push_delta_chain_and_epoch_bump is steady here."""

import json
import pickle
import threading
import time

import numpy as np
import pytest

from ape_x_dqn_tpu_torch.comm import native
from ape_x_dqn_tpu_torch.comm import socket_transport as st
from ape_x_dqn_tpu_torch.comm.param_codec import (
    _CODEC_HDR, _PARAMS_HDR, PARAMS_CODEC_MAGIC, PARAMS_HDR_MAGIC,
    ParamBlobProvider, ParamChainDecoder, check_param_codec)
from ape_x_dqn_tpu_torch.comm.socket_transport import (
    MSG_PARAMS_REQ, SocketIngestServer, SocketTransport)


def _bf16(x: np.ndarray) -> np.ndarray:
    import ml_dtypes
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


def _tree(rng, n=257):
    """Mixed tree: two f32 leaves, one int leaf (non-float path)."""
    return {"w": (rng.standard_normal((n,)) * 0.1).astype(np.float32),
            "k": {"b": (rng.standard_normal((7, 5)) * 0.1
                        ).astype(np.float32),
                  "steps": np.array([3], np.int64)}}


def _step(tree, rng):
    """Heavy-tailed f32 update; the int leaf stays put ("s" path)."""
    return {"w": (tree["w"] + 0.01 * rng.standard_normal(
        tree["w"].shape) ** 3).astype(np.float32),
        "k": {"b": (tree["k"]["b"] + 0.01 * rng.standard_normal(
            tree["k"]["b"].shape) ** 3).astype(np.float32),
        "steps": tree["k"]["steps"]}}


def _flat(tree):
    return [tree["w"], tree["k"]["b"], tree["k"]["steps"]]


def _max_err(a, b):
    return max(float(np.abs(x.astype(np.float64)
                            - y.astype(np.float64)).max())
               for x, y in zip(_flat(a), _flat(b)))


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _client(port, **kw):
    kw.setdefault("connect_timeout", 5.0)
    return SocketTransport("127.0.0.1", port, **kw)


def _batch(n=4):
    return {"obs": np.zeros((n, 4), np.float32),
            "action": np.zeros((n,), np.int32),
            "priorities": np.ones((n,), np.float32),
            "actor": 0, "frames": n}


# -- provider/decoder units --------------------------------------------------


def test_check_param_codec_rejects_unknown():
    assert check_param_codec("raw") == "raw"
    assert check_param_codec("delta-q8") == "delta-q8"
    with pytest.raises(ValueError):
        check_param_codec("zstd")


def test_full_then_delta_roundtrip():
    rng = np.random.default_rng(0)
    t0 = _tree(rng)
    provider = ParamBlobProvider("bfloat16", "delta-q8")
    decoder = ParamChainDecoder()
    provider.publish(t0, 0)
    payload, kind, ver, raw_cost = provider.coded_reply(7, -1, 7)
    assert kind in ("full", "raw_full") and ver == 0
    assert len(payload) <= raw_cost
    status, got, ver, ep = decoder.apply(payload)
    assert status == "full" and ver == 0 and ep == 7
    # a coded full is BITWISE the wire tree (bf16 roundtrip on f32,
    # exact on everything else) — same values the raw path delivers
    assert np.array_equal(got["w"], _bf16(t0["w"]))
    assert np.array_equal(got["k"]["b"], _bf16(t0["k"]["b"]))
    assert np.array_equal(got["k"]["steps"], t0["k"]["steps"])
    assert got["k"]["steps"].dtype == np.int64

    t1 = _step(t0, rng)
    provider.publish(t1, 1)
    payload, kind, ver, raw_cost = provider.coded_reply(7, 0, 7)
    assert kind == "delta" and ver == 1
    assert len(payload) < raw_cost  # the point of the codec
    status, got, ver, _ = decoder.apply(payload)
    assert status == "full" and ver == 1
    # delta error: half a quantization step plus bf16 rounding
    assert _max_err(got, {"w": _bf16(t1["w"]),
                          "k": {"b": _bf16(t1["k"]["b"]),
                                "steps": t1["k"]["steps"]}}) < 4e-3
    assert np.array_equal(got["k"]["steps"], t1["k"]["steps"])


def test_delta_error_does_not_accumulate():
    """The encoder advances its chain through the DEQUANTIZED delta, so
    a 40-step chain carries the same error bound as a 1-step chain."""
    rng = np.random.default_rng(1)
    t = _tree(rng)
    provider = ParamBlobProvider("bfloat16", "delta-q8", window=4)
    decoder = ParamChainDecoder()
    provider.publish(t, 0)
    status, _, _, _ = decoder.apply(provider.coded_reply(0, -1, 0)[0])
    assert status == "full"
    have = 0
    for v in range(1, 41):
        t = _step(t, rng)
        provider.publish(t, v)
        payload, kind, ver, _ = provider.coded_reply(0, have, 0)
        assert kind == "delta"
        status, got, ver, _ = decoder.apply(payload)
        assert status == "full" and ver == v
        have = v
        wire = {"w": _bf16(t["w"]), "k": {"b": _bf16(t["k"]["b"]),
                                          "steps": t["k"]["steps"]}}
        assert _max_err(got, wire) < 4e-3, f"error grew by step {v}"


def test_constant_shift_ships_zero_bytes():
    """A global +c shift is a "z" leaf: bias in the meta, no buffer —
    the whole delta payload stays near header-sized."""
    rng = np.random.default_rng(2)
    # multiples of 0.25 are exact in bf16, and stay exact under a
    # +0.25 shift -- the wire-space delta is EXACTLY constant
    t0 = {"w": (rng.integers(0, 64, 4096) * 0.25).astype(np.float32)}
    provider = ParamBlobProvider("bfloat16", "delta-q8")
    decoder = ParamChainDecoder()
    provider.publish(t0, 0)
    decoder.apply(provider.coded_reply(0, -1, 0)[0])
    t1 = {"w": (t0["w"] + np.float32(0.25)).astype(np.float32)}
    provider.publish(t1, 1)
    payload, kind, _, _ = provider.coded_reply(0, 0, 0)
    assert kind == "delta" and len(payload) < 256
    status, got, ver, _ = decoder.apply(payload)
    assert status == "full" and ver == 1
    assert np.allclose(got["w"], _bf16(t1["w"]), atol=1e-6)


def test_unchanged_is_header_only_both_planes():
    provider = ParamBlobProvider("bfloat16", "delta-q8")
    provider.publish({"w": np.ones(8, np.float32)}, 5)
    payload, kind, ver, raw_cost = provider.coded_reply(3, 5, 3)
    assert kind == "unchanged" and ver == 5
    assert len(payload) == _PARAMS_HDR.size == raw_cost
    payload, kind, _, _ = provider.versioned_reply(3, 5, 3)
    assert kind == "unchanged" and len(payload) == _PARAMS_HDR.size


def test_blob_level_never_inflate():
    """Adversarial (incompressible, full-range) trees: every coded
    reply still fits under the raw APXV cost — the ratio >= 1.0 floor
    obs --check gates can't be broken by payload choice."""
    rng = np.random.default_rng(3)
    provider = ParamBlobProvider("bfloat16", "delta-q8")
    decoder = ParamChainDecoder()
    have = -1
    for v in range(4):
        t = {"w": rng.uniform(-1e6, 1e6, 2048).astype(np.float32),
             "blob": rng.integers(0, 256, 4096).astype(np.uint8)}
        provider.publish(t, v)
        payload, kind, ver, raw_cost = provider.coded_reply(0, have, 0)
        assert len(payload) <= raw_cost, f"inflated at v{v} ({kind})"
        status, _, ver, _ = decoder.apply(payload)
        assert status == "full" and ver == v
        have = v


def test_decoder_resync_on_unknown_base_and_epoch():
    rng = np.random.default_rng(4)
    provider = ParamBlobProvider("bfloat16", "delta-q8")
    provider.publish(_tree(rng), 0)
    provider.coded_reply(0, -1, 0)  # make v0 a chain node
    provider.publish(_step(_tree(rng), rng), 1)
    delta, kind, _, _ = provider.coded_reply(0, 0, 0)
    assert kind == "delta"

    cold = ParamChainDecoder()  # no state at all
    status, got, ver, _ = cold.apply(delta)
    assert status == "resync" and got is None and ver == 1

    seeded = ParamChainDecoder()
    seeded.apply(provider.coded_reply(0, -1, 0)[0])  # holds v1 now
    wrong_base = ParamChainDecoder()
    wrong_base.apply(provider.coded_reply(0, -1, 0)[0])
    wrong_base._version = 7  # pretend it holds a version never encoded
    assert wrong_base.apply(delta)[0] == "resync"

    stale_epoch = ParamChainDecoder()
    stale_epoch.apply(provider.coded_reply(0, -1, 0)[0])
    stale_epoch._epoch = 99  # chain from a dead incarnation
    assert stale_epoch.apply(delta)[0] == "resync"


def test_window_overrun_and_epoch_bump_force_full():
    rng = np.random.default_rng(5)
    t = _tree(rng)
    provider = ParamBlobProvider("bfloat16", "delta-q8", window=2)
    provider.publish(t, 0)
    provider.coded_reply(0, -1, 0)
    for v in range(1, 5):
        t = _step(t, rng)
        provider.publish(t, v)
        provider.coded_reply(0, v - 1, 0)  # encode each step
    assert provider.chain_len == 2  # window trims the tail
    # base v0 fell out of the window: full resync, not a delta
    payload, kind, ver, _ = provider.coded_reply(0, 0, 0)
    assert kind in ("full", "raw_full") and ver == 4
    # recent base still rides the chain
    assert provider.coded_reply(0, 3, 0)[1] == "delta"
    # epoch bump: even a perfect base resyncs full
    payload, kind, ver, _ = provider.coded_reply(0, 3, 1)
    assert kind in ("full", "raw_full")
    decoder = ParamChainDecoder()
    status, got, ver, ep = decoder.apply(
        provider.coded_reply(1, -1, 1)[0])
    assert status == "full" and ep == 1
    assert np.array_equal(got["w"], _bf16(t["w"]))


def test_structure_change_resets_chain():
    """Model surgery (leaf shape change) between versions: the chain
    restarts, outstanding bases get a full, nothing corrupts."""
    rng = np.random.default_rng(6)
    provider = ParamBlobProvider("bfloat16", "delta-q8")
    provider.publish({"w": np.ones(16, np.float32)}, 0)
    provider.coded_reply(0, -1, 0)
    provider.publish({"w": np.ones(32, np.float32)}, 1)  # new shape
    payload, kind, ver, _ = provider.coded_reply(0, 0, 0)
    assert kind in ("full", "raw_full") and ver == 1
    decoder = ParamChainDecoder()
    status, got, _, _ = decoder.apply(provider.coded_reply(0, -1, 0)[0])
    assert status == "full" and got["w"].shape == (32,)


def test_q8_native_numpy_bit_parity(monkeypatch):
    """Wire contract: a native-enabled learner and a Python-only actor
    host must reconstruct the SAME chain bytes. Both q8 directions are
    compared bit-for-bit against the numpy mirror."""
    if not native.have_q8_native():
        pytest.skip("native q8 kernels unavailable")
    rng = np.random.default_rng(7)
    d = (rng.standard_normal(10007) ** 3 * 0.01).astype(np.float32)
    lo = float(d.min())
    scale = float(np.float32((float(d.max()) - lo) / 254.0))
    q_native = native.q8_encode(d, lo, scale)
    base_native = (rng.standard_normal(10007) * 0.1).astype(np.float32)
    base_numpy = base_native.copy()
    native.q8_dequant_add(base_native, np.frombuffer(q_native, np.int8),
                          lo, scale)
    monkeypatch.setattr(native, "_has_q8", False)
    q_numpy = native.q8_encode(d, lo, scale)
    assert q_native == q_numpy
    native.q8_dequant_add(base_numpy, np.frombuffer(q_numpy, np.int8),
                          lo, scale)
    assert np.array_equal(base_native, base_numpy)


def test_cross_plane_consistency():
    """The one versioned-blob provider: legacy blob, APXV reply body,
    coded full and local get_tree all agree bitwise for a version."""
    rng = np.random.default_rng(8)
    t = _tree(rng)
    provider = ParamBlobProvider("bfloat16", "delta-q8")
    provider.publish(t, 3)
    blob = provider.raw_blob()
    apxv, kind, ver, _ = provider.versioned_reply(-1, -1, 9)
    assert kind == "raw_full" and ver == 3
    assert bytes(apxv[_PARAMS_HDR.size:]) == blob
    blob2, ver2, _ = provider.raw_blob_versioned()
    assert blob2 == blob and ver2 == 3
    from ape_x_dqn_tpu_torch.comm.param_codec import _upcast_bf16
    blob_tree = _upcast_bf16(pickle.loads(blob)[0])
    local_tree, ver3 = provider.get_tree()
    assert ver3 == 3
    decoder = ParamChainDecoder()
    _, coded_tree, _, _ = decoder.apply(provider.coded_reply(9, -1, 9)[0])
    for a, b, c in zip(_flat(blob_tree), _flat(local_tree),
                       _flat(coded_tree)):
        assert np.array_equal(a, b) and np.array_equal(a, c)


def test_quantized_policy_greedy_parity():
    """Learning-parity smoke: greedy actions from a
    chain-reconstructed policy match the fp32 policy >= 0.99 of the
    time after a 12-step delta chain."""
    rng = np.random.default_rng(9)
    dims = (32, 64, 18)
    w = {f"l{i}": (rng.standard_normal((a, b)) * 0.3).astype(np.float32)
         for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}
    provider = ParamBlobProvider("bfloat16", "delta-q8")
    decoder = ParamChainDecoder()
    have = -1
    for v in range(13):
        if v:
            w = {k: (a + 0.01 * rng.standard_normal(a.shape) ** 3
                     ).astype(np.float32) for k, a in w.items()}
        provider.publish(w, v)
        status, _, ver, _ = decoder.apply(
            provider.coded_reply(0, have, 0)[0])
        assert status == "full"
        have = ver

    def greedy(params, x):
        h = np.maximum(x @ params["l0"], 0.0)
        return (h @ params["l1"]).argmax(axis=1)

    states = rng.standard_normal((512, dims[0])).astype(np.float32)
    got = decoder._tree()
    agree = float((greedy(w, states) == greedy(got, states)).mean())
    assert agree >= 0.99, f"greedy agreement {agree}"


# -- socket integration ------------------------------------------------------


@pytest.mark.parametrize("server_codec,client_codec", [
    ("delta-q8", "delta-q8"), ("delta-q8", "raw"),
    ("raw", "delta-q8"), ("raw", "raw")])
def test_pull_interop_matrix(server_codec, client_codec):
    """Every old<->new pairing pulls correct values; only the
    both-coded cell compresses, every other cell degrades silently to
    the raw APXV plane (ratio exactly 1.0)."""
    rng = np.random.default_rng(10)
    t0 = _tree(rng)
    srv = SocketIngestServer("127.0.0.1", 0, param_codec=server_codec)
    client = _client(srv.port, param_codec=client_codec)
    try:
        srv.publish_params(t0, 0)
        p, v = client.get_params()
        assert v == 0
        assert np.array_equal(p["w"], _bf16(t0["w"]))
        assert np.array_equal(p["k"]["steps"], t0["k"]["steps"])
        p, v = client.get_params()  # conditional pull: header only
        assert p is None and v == 0
        t1 = _step(t0, rng)
        srv.publish_params(t1, 1)
        p, v = client.get_params()
        assert v == 1
        wire = {"w": _bf16(t1["w"]), "k": {"b": _bf16(t1["k"]["b"]),
                                           "steps": t1["k"]["steps"]}}
        coded = server_codec == client_codec == "delta-q8"
        assert _max_err(p, wire) < (4e-3 if coded else 1e-12)
        if coded:
            assert srv.param_compression_ratio > 1.0
        else:
            assert srv.param_compression_ratio == pytest.approx(1.0)
    finally:
        client.close()
        srv.stop()


def test_raw_escape_hatch_is_bitwise_precodec(monkeypatch):
    """param_codec="raw": the pull request carries exactly the
    pre-codec {v, epoch} JSON (no codec key — bitwise what an old
    build sends) and every reply is plain APXV."""
    sent = []
    real_send = st._send_msg

    def spy(sock, mtype, payload):
        if mtype == MSG_PARAMS_REQ:
            sent.append(bytes(payload))
        return real_send(sock, mtype, payload)

    monkeypatch.setattr(st, "_send_msg", spy)
    srv = SocketIngestServer("127.0.0.1", 0, param_codec="raw")
    client = _client(srv.port, param_codec="raw")
    try:
        srv.publish_params({"w": np.ones(64, np.float32)}, 0)
        p, v = client.get_params()
        assert v == 0 and p is not None
        assert sent, "no MSG_PARAMS_REQ captured"
        assert set(json.loads(sent[0])) == {"v", "epoch"}
        assert srv.param_compression_ratio == pytest.approx(1.0)
    finally:
        client.close()
        srv.stop()


def test_pull_resync_counted_and_retried():
    """A delta whose base the client no longer holds: the client counts
    param_resyncs, clears its chain, and the immediate retry lands the
    full — one get_params call, correct params out."""
    rng = np.random.default_rng(11)
    t0 = _tree(rng)
    srv = SocketIngestServer("127.0.0.1", 0, param_codec="delta-q8")
    client = _client(srv.port, param_codec="delta-q8")
    try:
        srv.publish_params(t0, 0)
        p, v = client.get_params()
        assert v == 0
        t1 = _step(t0, rng)
        srv.publish_params(t1, 1)
        real_reply = srv._provider.coded_reply
        fired = []

        def bogus_base_once(have_ep, have_v, epoch):
            if not fired:
                fired.append(1)
                payload = _CODEC_HDR.pack(
                    PARAMS_CODEC_MAGIC, epoch, 1, 555) \
                    + native.pack_records([])
                return payload, "delta", 1, len(payload)
            return real_reply(have_ep, have_v, epoch)

        srv._provider.coded_reply = bogus_base_once
        p, v = client.get_params()
        assert v == 1 and p is not None
        assert _max_err(p, {"w": _bf16(t1["w"]),
                            "k": {"b": _bf16(t1["k"]["b"]),
                                  "steps": t1["k"]["steps"]}}) < 1e-3
        assert client.param_resyncs == 1
    finally:
        client.close()
        srv.stop()


def test_server_counts_resyncs_on_window_overrun():
    """Client B parked on v0 while client A's pulls advance a window=2
    chain past it: B's next pull is a counted full resync with correct
    values — a routine overrun costs one full, never a wrong tree."""
    rng = np.random.default_rng(12)
    t = _tree(rng)
    srv = SocketIngestServer("127.0.0.1", 0, param_codec="delta-q8",
                             param_delta_window=2)
    a = _client(srv.port, param_codec="delta-q8")
    b = _client(srv.port, param_codec="delta-q8")
    try:
        srv.publish_params(t, 0)
        assert a.get_params()[1] == 0
        assert b.get_params()[1] == 0
        for v in range(1, 5):
            t = _step(t, rng)
            srv.publish_params(t, v)
            assert a.get_params()[1] == v  # encodes each chain step
        assert srv.param_resyncs == 0
        p, v = b.get_params()  # base v0 is out of the window
        assert v == 4
        assert np.array_equal(p["w"], _bf16(t["w"]))  # full => bitwise
        assert srv.param_resyncs == 1
        assert b.param_resyncs == 0  # server-side full, no client churn
    finally:
        a.close()
        b.close()
        srv.stop()


def test_push_delta_chain_and_epoch_bump():
    """Coded pushes: negotiate, receive the seed full, ride deltas
    version to version, then resync across a server epoch bump."""
    rng = np.random.default_rng(13)
    t = _tree(rng, n=8192)  # big enough that meta overhead is noise
    srv = SocketIngestServer("127.0.0.1", 0, epoch=4,
                             param_codec="delta-q8")
    client = _client(srv.port, params_push=True, param_codec="delta-q8")
    try:
        client.send_experience(_batch())
        assert srv.recv_experience(timeout=5.0) is not None
        assert client.params_push_negotiated
        assert client.param_codec_negotiated
        srv.publish_params(t, 0)
        assert _wait(lambda: client.poll_pushed_params()[1] == 0)
        for v in range(1, 4):
            t = _step(t, rng)
            srv.publish_params(t, v)
            assert _wait(
                lambda v=v: client.poll_pushed_params()[1] == v)
        # one seed full + three q8 deltas (~half a bf16 full each)
        # must beat four raw fulls by a clear margin
        assert srv.param_compression_ratio > 1.3
        srv.bump_epoch()
        t = _step(t, rng)
        srv.publish_params(t, 0)  # version counter restarted
        got = {}

        def seen_new_epoch():
            p, v = client.poll_pushed_params()
            if p is not None and v == 0:
                got["p"] = p
                return True
            return False

        assert _wait(seen_new_epoch)
        assert np.array_equal(got["p"]["w"], _bf16(t["w"]))
    finally:
        client.close()
        srv.stop()


def test_slow_subscriber_does_not_stall_fanout():
    """One wedged subscriber (its push sends blocked) must not delay
    the healthy peer: deposits to the wedged peer supersede in its
    one-deep cell (counted per-reason) while the healthy peer keeps
    consuming every version."""
    rng = np.random.default_rng(14)
    t = _tree(rng)
    srv = SocketIngestServer("127.0.0.1", 0, param_codec="delta-q8")
    wedge = threading.Event()
    wedged = _client(srv.port, params_push=True, param_codec="delta-q8")
    try:
        wedged.send_experience(_batch())
        assert srv.recv_experience(timeout=5.0) is not None
        assert _wait(lambda: len(srv._push_subs) == 1)
        with srv._conns_lock:
            wedged_ids = set(srv._push_subs)
        real_send_on = srv._send_on

        def send_on(conn, mtype, payload):
            if (mtype == st.MSG_PARAMS_PUSH
                    and id(conn) in wedged_ids):
                wedge.wait(timeout=30.0)
            return real_send_on(conn, mtype, payload)

        srv._send_on = send_on
        healthy = _client(srv.port, params_push=True,
                          param_codec="delta-q8")
        try:
            healthy.send_experience(_batch())
            assert srv.recv_experience(timeout=5.0) is not None
            assert _wait(lambda: len(srv._push_subs) == 2)
            for v in range(5):
                t = _step(t, rng)
                srv.publish_params(t, v)
                assert _wait(
                    lambda v=v: healthy.poll_pushed_params()[1] == v), \
                    f"healthy subscriber starved at v{v}"
            drops = srv.param_push_queue_drops
            assert drops["superseded"] >= 1, drops
            assert healthy.param_resyncs == 0
        finally:
            wedge.set()
            healthy.close()
    finally:
        wedge.set()
        wedged.close()
        srv.stop()


# -- against the JAX package -------------------------------------------------


def test_tree_flatten_keeps_jax_leaf_order():
    import jax

    from ape_x_dqn_tpu_torch.comm.param_codec import (
        tree_flatten, tree_unflatten)

    tree = {"z": [np.arange(2), (np.ones(1), None)], "a": {"k": np.zeros(3),
            "b": 7}, "m": ()}
    leaves, skel = tree_flatten(tree)
    want, treedef = jax.tree_util.tree_flatten(tree)
    assert len(leaves) == len(want)
    assert all(x is y for x, y in zip(leaves, want))
    assert skel == jax.tree_util.tree_unflatten(treedef,
                                                list(range(len(want))))
    back = tree_unflatten(skel, leaves)
    assert back["z"][1][1] is None and back["a"]["b"] == 7
    assert back["m"] == ()


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("wire_dtype", ["bfloat16", "float32"])
def test_coded_payloads_cross_decode(direction, wire_dtype):
    """The same numpy tree through one package's provider and the
    other's decoder: the seed full, a 3-step delta chain, a catch-up
    delta spanning two versions and an epoch-bump resync all decode to
    what the encoding package's own decoder holds, bitwise."""
    from ape_x_dqn_tpu.comm import param_codec as jax_pc
    from ape_x_dqn_tpu_torch.comm import param_codec as torch_pc

    enc, dec = ((jax_pc, torch_pc) if direction == "jax_to_torch"
                else (torch_pc, jax_pc))
    rng = np.random.default_rng(30)
    t = _tree(rng, n=4096)
    provider = enc.ParamBlobProvider(wire_dtype, "delta-q8")
    theirs, ours = dec.ParamChainDecoder(), enc.ParamChainDecoder()
    provider.publish(t, 0)
    payload, kind, _, _ = provider.coded_reply(2, -1, 2)
    assert kind == "full"
    for d in (theirs, ours):
        d.apply(payload)
    have = 0
    for v in range(1, 4):
        t = _step(t, rng)
        provider.publish(t, v)
        payload, kind, _, _ = provider.coded_reply(2, have, 2)
        assert kind == "delta"
        _, got, ver, ep = theirs.apply(payload)
        _, want, _, _ = ours.apply(payload)
        assert (ver, ep) == (v, 2)
        for a, b in zip(_flat(got), _flat(want)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        have = v
    # catch-up: a base two versions back replays two segments
    lag = dec.ParamChainDecoder()
    provider2 = enc.ParamBlobProvider(wire_dtype, "delta-q8")
    t2 = _tree(rng)
    provider2.publish(t2, 0)
    lag.apply(provider2.coded_reply(0, -1, 0)[0])
    for v in (1, 2):
        t2 = _step(t2, rng)
        provider2.publish(t2, v)
        provider2.coded_reply(0, v - 1, 0)  # each step a chain node
    status, got, ver, _ = lag.apply(provider2.coded_reply(0, 0, 0)[0])
    assert status == "full" and ver == 2
    # an epoch bump resyncs with a coded full: bitwise the wire tree
    payload, kind, _, _ = provider.coded_reply(2, have, 3)
    assert kind == "full"
    _, got, _, ep = theirs.apply(payload)
    wire = _bf16 if wire_dtype == "bfloat16" else (lambda x: x)
    assert ep == 3 and np.array_equal(got["w"], wire(t["w"]))
    assert np.array_equal(got["k"]["steps"], t["k"]["steps"])


def test_bf16_wire_rounding_matches_ml_dtypes_bytewise():
    """The port rounds f32 to bf16 with torch (the card's machine has no
    ml_dtypes): round to nearest even on random bit patterns with ties
    forced, NaNs of both signs, infinities, subnormals and zeros, equal
    to ml_dtypes byte for byte; the upcast is exact."""
    import ml_dtypes

    from ape_x_dqn_tpu_torch.comm.param_codec import (
        bf16_bits, bf16_bits_to_f32, bf16_round)

    rng = np.random.default_rng(31)
    bits = rng.integers(0, 2**32, size=100_000, dtype=np.uint64) \
        .astype(np.uint32)
    bits[:5000] = (bits[:5000] & 0xFFFF0000) | 0x8000   # exact ties
    bits[5000:6000] &= 0x807FFFFF                        # subnormals
    bits[6000:7000] |= 0x7F800000                        # inf / NaN
    special = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0,
                        1e-45, -1e-40, 3.4028235e38, 1.0 + 2**-8],
                       np.float32)
    x = np.concatenate([bits.view(np.float32), special]).reshape(10, -1)
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16)
    got = bf16_bits(x)
    assert got.dtype == np.uint16 and got.shape == x.shape
    assert got.tobytes() == want.tobytes()
    up = bf16_bits_to_f32(got)
    assert up.tobytes() == want.astype(np.float32).tobytes()
    assert bf16_round(x[:, :64]).tobytes() == \
        want[:, :64].astype(np.float32).tobytes()


def test_published_blob_carries_no_torch_tensor():
    """The learner side may hand the provider torch tensors; the raw
    blob, the coded full and get_tree still hold numpy arrays only."""
    import torch

    from ape_x_dqn_tpu_torch.comm.param_codec import (
        _Bf16Wire, tree_flatten)

    provider = ParamBlobProvider("bfloat16", "delta-q8")
    provider.publish({"w": torch.ones(4), "n": torch.arange(3)}, 1)
    tree, _ = pickle.loads(provider.raw_blob())
    for leaf in tree_flatten(tree)[0]:
        assert isinstance(leaf, (np.ndarray, _Bf16Wire))
    got, _ = provider.get_tree()
    assert got["w"].dtype == np.float32 and got["n"].dtype == np.int64
    _, coded, _, _ = ParamChainDecoder().apply(
        provider.coded_reply(0, -1, 0)[0])
    assert all(isinstance(x, np.ndarray) for x in tree_flatten(coded)[0])
