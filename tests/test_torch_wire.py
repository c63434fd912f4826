"""The port's experience wire and native framing codec
(comm/native.py -> cpp/framing.cpp, comm/socket_transport.py's
encode/decode), ported from tests/test_comm.py, plus cross-decoding
against the JAX package: a batch either package encodes, under every
wire codec, decodes bitwise through the other's `decode_batch` and
`decode_batch_into`."""

import os
import zlib

import numpy as np
import pytest

from ape_x_dqn_tpu.comm import socket_transport as jax_st
from ape_x_dqn_tpu_torch.comm import native
from ape_x_dqn_tpu_torch.comm import socket_transport as st
from ape_x_dqn_tpu_torch.comm.socket_transport import (
    decode_batch, encode_batch)


# -- native codec ------------------------------------------------------------


def test_native_codec_compiles_and_loads():
    """With g++ present the C++ data plane must actually build, every
    symbol of it (the chip run checks the same on the card's machine)."""
    assert native.have_native() and native.available()


def test_native_crc32_matches_zlib():
    data = os.urandom(4096)
    assert native.crc32(data) == zlib.crc32(data) & 0xFFFFFFFF
    assert native.crc32(b"") == 0
    # seeded/rolling form matches too
    a, b = data[:100], data[100:]
    assert native.crc32(b, native.crc32(a)) == zlib.crc32(data) & 0xFFFFFFFF


def test_pack_unpack_roundtrip():
    chunks = [b"", b"x", os.urandom(1000), b"tail"]
    frame = native.pack_records(chunks)
    assert native.unpack_records(frame) == chunks
    with pytest.raises(ValueError):
        native.unpack_records(frame[:-1])  # truncated record


def test_batch_codec_roundtrip():
    batch = {
        "obs": np.random.randint(0, 255, (7, 84, 84, 4), dtype=np.uint8),
        "action": np.arange(7, dtype=np.int32),
        "priorities": np.random.rand(7).astype(np.float32),
        "actor": 3,
        "frames": 42,
    }
    out = decode_batch(encode_batch(batch))
    assert out["actor"] == 3 and out["frames"] == 42
    for k in ("obs", "action", "priorities"):
        np.testing.assert_array_equal(out[k], batch[k])
        assert out[k].dtype == batch[k].dtype


def test_unpack_records_mv_zero_copy():
    """The memoryview unpack path returns views ALIASING the frame (no
    copies) with contents identical to the copying path."""
    chunks = [b"", b"x", os.urandom(1000), b"tail"]
    frame = native.pack_records(chunks)
    mvs = native.unpack_records_mv(frame)
    assert [bytes(m) for m in mvs] == chunks
    for m in mvs:
        assert isinstance(m, memoryview)
        assert m.obj is frame  # view into the frame itself, not a copy
    # bytearray frames (what _recv_exact returns) work identically
    mvs2 = native.unpack_records_mv(bytearray(frame))
    assert [bytes(m) for m in mvs2] == chunks
    with pytest.raises(ValueError):
        native.unpack_records_mv(frame[:-1])


def test_decode_batch_into_matches_decode_batch():
    """Decode-into-staging lands bitwise what decode_batch returns, for
    the whole batch and for arbitrary [start, start+limit) windows at
    arbitrary staging offsets."""
    from ape_x_dqn_tpu_torch.comm.socket_transport import decode_batch_into
    batch = {
        "obs": np.random.randint(0, 255, (7, 8, 8, 2), dtype=np.uint8),
        "action": np.arange(7, dtype=np.int32),
        "priorities": np.random.rand(7).astype(np.float32),
        "actor": 3, "frames": 42,
    }
    payload = encode_batch(batch)
    ref = decode_batch(payload)

    def fresh(cap):
        return {k: np.zeros((cap,) + v.shape[1:], v.dtype)
                for k, v in ref.items() if isinstance(v, np.ndarray)}

    dest = fresh(7)
    k, rows, scalars = decode_batch_into(payload, dest, 0)
    assert (k, rows) == (7, 7)
    assert scalars == {"actor": 3, "frames": 42}
    for key, v in dest.items():
        np.testing.assert_array_equal(v, ref[key], err_msg=key)
    # partial window [2, 5) landing at offset 4
    dest = fresh(16)
    k, rows, _ = decode_batch_into(payload, dest, 4, start=2, limit=3)
    assert (k, rows) == (3, 7)
    for key, v in dest.items():
        np.testing.assert_array_equal(v[4:7], ref[key][2:5], err_msg=key)
        assert not v[:4].any() and not v[7:].any(), key
    # limit past the end clamps
    dest = fresh(16)
    k, _, _ = decode_batch_into(payload, dest, 0, start=5, limit=99)
    assert k == 2


def test_wire_batch_dict_protocol():
    """WireBatch serves every consumer that treated the queue payload as
    a decoded dict: item access, .get defaults, scalars, row count."""
    from ape_x_dqn_tpu_torch.comm.socket_transport import WireBatch, batch_rows
    batch = {
        "obs": np.random.rand(5, 3).astype(np.float32),
        "priorities": np.random.rand(5).astype(np.float32),
        "actor": 1, "frames": 9,
    }
    wb = WireBatch(encode_batch(batch))
    assert wb.rows == 5 and batch_rows(wb) == 5
    assert batch_rows(batch) == 5  # dict form reads priorities
    assert wb.get("frames", 5) == 9 and wb.get("missing") is None
    assert wb["actor"] == 1
    np.testing.assert_array_equal(wb["obs"], batch["obs"])
    assert wb["obs"] is wb["obs"]  # materialized arrays are cached
    assert "priorities" in wb and "nope" not in wb
    assert set(wb.keys()) == set(batch.keys())
    with pytest.raises(KeyError):
        wb["nope"]


# -- wire codec (delta-deflate experience compression) ----------------------


def _codec_batch(seed=0, n=16):
    """Frame-heavy batch with every leaf class the codec handles:
    frame-like uint8 (xd), bools (bp), small ints (d), floats (raw)."""
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


def test_wire_codec_shrinks_and_roundtrips():
    """Frame traffic must compress >=2x (the adoption bar) and decode
    bitwise-identically, through both decode forms."""
    from ape_x_dqn_tpu_torch.comm.socket_transport import (
        WireBatch, decode_batch_into)

    batch = _codec_batch()
    raw = encode_batch(batch, "raw")
    comp = encode_batch(batch, "delta-deflate")
    assert len(comp) * 2 < len(raw)
    _assert_batches_equal(decode_batch(comp), batch)
    wb = WireBatch(comp)
    assert wb.raw_nbytes > wb.wire_nbytes
    dest = {k: np.zeros_like(v) for k, v in batch.items()
            if isinstance(v, np.ndarray)}
    k1, rows, scalars = decode_batch_into(comp, dest, 0, 0, 9)
    wb.decode_into(dest, 9, 9)  # split continuation on a fresh WireBatch
    assert rows == 16 and scalars["actor"] == 1
    for k in dest:
        np.testing.assert_array_equal(dest[k], batch[k], err_msg=k)


def test_decode_leaf_full_copies_are_load_bearing():
    """The .copy()s in _decode_leaf_full are ownership, not
    convenience: a materialized leaf must survive
    its source buffer being scribbled over — a ShmSlotBatch's ring
    slot is REUSED by the writer the moment release() frees it, and a
    zlib-inflated codec leaf lives in a per-payload cache the array
    must outlive — and "xd" leaves need writable memory for the
    in-place XOR undo. Dropping either copy silently corrupts
    delivered batches; this pins them."""
    from ape_x_dqn_tpu_torch.comm.socket_transport import WireBatch

    batch = _codec_batch(seed=11)
    # raw path: decode from a writable buffer (what a ring slot is),
    # then scribble over it as a reusing writer would
    payload = bytearray(encode_batch(batch, "raw"))
    wb = WireBatch(memoryview(payload))
    frames = wb["seg_frames"]
    pris = wb["priorities"]
    want_f, want_p = batch["seg_frames"].copy(), batch["priorities"].copy()
    payload[:] = b"\xaa" * len(payload)  # slot reuse
    np.testing.assert_array_equal(frames, want_f)
    np.testing.assert_array_equal(pris, want_p)
    # ownership, not a view into the (now-scribbled) transport buffer
    assert frames.base is None or frames.flags["OWNDATA"]
    # codec path: "d"/"xd" leaves must come back writable (the xd
    # decode XORs rows in place; a frombuffer view of immutable zlib
    # output would raise) and detached from the decode cache
    comp = encode_batch(batch, "delta-deflate")
    wc = WireBatch(comp)
    arr = wc["seg_frames"]
    np.testing.assert_array_equal(arr, want_f)
    assert arr.flags["WRITEABLE"]
    arr[0, 0, 0, 0] ^= 0xFF  # must not raise, must not poison the cache
    np.testing.assert_array_equal(wc["action"], batch["action"])


def test_wire_codec_cross_decode_native_python(monkeypatch):
    """The C++ delta transform and the numpy fallback must be
    wire-compatible in BOTH directions: payloads encoded with one must
    decode bitwise through the other (a C++-enabled learner host talks
    to a Python-only actor host and vice versa)."""
    if not native.have_delta_native():
        pytest.skip("native delta unavailable; nothing to cross-check")
    batch = _codec_batch(seed=5)
    native_payload = encode_batch(batch, "delta-deflate")
    native_decode = decode_batch(native_payload)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "_has_delta", False)
    python_payload = encode_batch(batch, "delta-deflate")
    _assert_batches_equal(decode_batch(native_payload), batch)
    monkeypatch.undo()
    assert native.have_delta_native()
    _assert_batches_equal(decode_batch(python_payload), batch)
    _assert_batches_equal(native_decode, batch)


@pytest.mark.parametrize("seed", range(4))
def test_wire_codec_fuzz_roundtrip(seed):
    """Random leaf shapes/dtypes/row sizes round-trip bitwise under the
    codec, through decode_batch AND the staged decode_batch_into with a
    random split point."""
    from ape_x_dqn_tpu_torch.comm.socket_transport import decode_batch_into

    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    batch = {"priorities": rng.random(n).astype(np.float32)}
    dtypes = [np.uint8, np.int8, np.int32, np.int64, np.float32,
              np.float64, np.bool_]
    for i in range(int(rng.integers(1, 6))):
        nd = int(rng.integers(0, 3))
        tail = tuple(int(rng.integers(1, 64)) for _ in range(nd))
        dt = dtypes[int(rng.integers(0, len(dtypes)))]
        shape = (n,) + tail
        if dt == np.bool_:
            batch[f"leaf{i}"] = rng.random(shape) < 0.2
        elif np.issubdtype(dt, np.integer):
            batch[f"leaf{i}"] = rng.integers(0, 7, shape).astype(dt)
        else:
            batch[f"leaf{i}"] = rng.random(shape).astype(dt)
    payload = encode_batch(batch, "delta-deflate")
    _assert_batches_equal(decode_batch(payload), batch)
    dest = {k: np.zeros_like(v) for k, v in batch.items()}
    cut = int(rng.integers(0, n + 1))
    decode_batch_into(payload, dest, 0, 0, cut)
    decode_batch_into(payload, dest, cut, cut)
    for k in dest:
        np.testing.assert_array_equal(dest[k], batch[k], err_msg=k)


def test_wire_codec_truncated_and_corrupt_rejected():
    """Corrupt/truncated codec streams must reject with ValueError (the
    server reader drops such connections), never decode garbage."""
    import json as json_mod

    from ape_x_dqn_tpu_torch.comm import native as native_mod

    batch = _codec_batch(seed=7)
    payload = encode_batch(batch, "delta-deflate")
    # flip bytes inside the compressed frame region
    corrupt = bytearray(payload)
    corrupt[len(corrupt) // 2] ^= 0xFF
    corrupt[-100] ^= 0xFF
    with pytest.raises(ValueError):
        decode_batch(bytes(corrupt))
    # truncate a leaf's deflate stream but keep the framing valid:
    # re-pack with the last record cut short
    recs = [bytes(r) for r in native_mod.unpack_records_mv(payload)]
    meta = json_mod.loads(recs[0])
    assert any(m.get("enc") for m in meta)  # codec leaves present
    truncated = native_mod.pack_records(recs[:-1] + [recs[-1][:10]])
    with pytest.raises(ValueError):
        decode_batch(truncated)
    # a stream inflating to the WRONG size (valid zlib, bad length):
    # swap one encoded leaf's bytes for a short valid deflate stream
    xd_idx = 1 + [j for j, m in enumerate(
        [m for m in meta if m["nd"]]) if m.get("enc") == "xd"][0]
    recs[xd_idx] = zlib.compress(b"short", 1)
    with pytest.raises(ValueError):
        decode_batch(native_mod.pack_records(recs))


# -- cross-decoding against the JAX package ---------------------------------


def _staged(batch):
    return {k: np.zeros_like(v) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


@pytest.mark.parametrize("codec", st.WIRE_CODECS)
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_experience_wire_cross_decodes(codec, direction):
    """Same wire: the codec tuple matches, and a payload encoded by one
    package decodes bitwise through the other's decode_batch, through a
    split decode_batch_into (the staging path), and through WireBatch's
    header-only accounting."""
    assert st.WIRE_CODECS == jax_st.WIRE_CODECS
    assert (st.MAGIC, st._HDR.format, st._DOORBELL.format) == \
        (jax_st.MAGIC, jax_st._HDR.format, jax_st._DOORBELL.format)
    enc, dec = (jax_st, st) if direction == "jax_to_torch" else (st, jax_st)
    batch = _codec_batch(seed=21)
    payload = enc.encode_batch(batch, codec)
    assert payload == dec.encode_batch(batch, codec)  # identical bytes
    _assert_batches_equal(dec.decode_batch(payload), batch)
    dest = _staged(batch)
    k, rows, scalars = dec.decode_batch_into(payload, dest, 0, 0, 7)
    dec.WireBatch(payload).decode_into(dest, 7, 7)
    assert (k, rows) == (7, 16) and scalars == {"actor": 1, "frames": 16}
    for key in dest:
        np.testing.assert_array_equal(dest[key], batch[key], err_msg=key)
    wb = dec.WireBatch(payload)
    assert wb.rows == 16 and wb.wire_nbytes == len(payload)


@pytest.mark.parametrize("codec", st.WIRE_CODECS)
def test_experience_wire_frames_cross_decode(codec):
    """A whole framed message (header, crc) the JAX package frames is
    read by the port's frame reader, and the other way round."""
    import socket as socket_mod

    batch = _codec_batch(seed=22, n=4)
    for send, recv in ((jax_st, st), (st, jax_st)):
        a, b = socket_mod.socketpair()
        try:
            payload = send.encode_batch(batch, codec)
            send._send_msg(a, send.MSG_EXPERIENCE_C if codec != "raw"
                           else send.MSG_EXPERIENCE, payload)
            mtype, got = recv._recv_msg(b)
            assert mtype in (recv.MSG_EXPERIENCE, recv.MSG_EXPERIENCE_C)
            _assert_batches_equal(recv.decode_batch(got), batch)
        finally:
            a.close()
            b.close()
