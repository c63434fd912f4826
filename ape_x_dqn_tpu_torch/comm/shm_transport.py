"""Same-host shared-memory data plane: experience ring + seqlock params.

Counterpart of ``ape_x_dqn_tpu/comm/shm_transport.py``, copied with
its segment layout unchanged, so both packages' peers share one format.

Every actor->learner byte on a single host otherwise pays the full TCP
loopback tax — encode into a send buffer, kernel copy down, kernel copy
up, decode into staging — plus the delta-deflate codec built for
bandwidth-constrained links. This module is the mechanism half of the
shm transport: fixed-slot rings and a seqlock param area in
`multiprocessing.shared_memory` segments, so a same-host peer ships
experience as ONE copy (actor arrays -> claimed slot; the learner's
staging landing is the same one copy the TCP mv path already pays) and
pulls params with zero per-client serialization.

The PROTOCOL half stays in socket_transport.py: segments are negotiated
over the existing MSG_HELLO/MSG_HELLO_ACK capability exchange, data
slots are announced with tiny MSG_SHM_DOORBELL frames on the existing
TCP control socket (so reconnect/backoff, epoch machinery, backpressure
latches, chaos injection and drop accounting all keep working
untouched), and every shm failure mode degrades to plain TCP.

Correctness model (no cross-process locks anywhere):

- Ring slots are single-writer/single-freeer: the CLIENT is the only
  process that marks a slot claimed (its sends serialize under the
  transport's _send_lock), the SERVER is the only one that marks it
  free. The slot-state byte array in the segment IS the free-list
  doorbell — freeing is one byte store, claiming is a scan for
  SLOT_FREE.
- A doorbell carries (slot, seq, nbytes, crc); the server re-reads the
  slot header and re-checksums the payload before delivering. A writer
  dying mid-write either never rings (the server reclaims the lease on
  disconnect) or rings with a mismatched crc/seq — the torn slot is
  counted and freed, NEVER delivered.
- The param area is a classic even/odd seqlock: the server bumps the
  sequence to odd, writes blob+metadata, bumps to even. A reader that
  observes an odd or changed sequence (or a crc mismatch) retries and
  eventually falls back to the TCP param path.
"""

from __future__ import annotations

import json
import secrets
import struct
import time
from multiprocessing import resource_tracker, shared_memory

import numpy as np

from ape_x_dqn_tpu_torch.comm import native
from ape_x_dqn_tpu_torch.obs.health import make_lock

RING_MAGIC = 0x53524E47   # 'SRNG'
PARAM_MAGIC = 0x53505231  # 'SPR1'

_RING_HDR = struct.Struct("<IIQ")  # magic, slot count, slot payload bytes
_SLOT_HDR = struct.Struct("<QQ")   # seq, payload nbytes

SLOT_FREE = 0
SLOT_CLAIMED = 1

# param-area header layout (fixed offsets, not one packed struct: the
# seq field is written twice per publish and read standalone)
_PAR_MAGIC_OFF = 0     # u32
_PAR_SEQ_OFF = 8       # u64, even = stable, odd = write in progress
_PAR_NBYTES_OFF = 16   # u64, 0 = no blob (unpublished or oversize)
_PAR_CRC_OFF = 24      # u32 over the blob bytes
_PAR_EPOCH_OFF = 32    # i64 membership epoch of the held blob
_PAR_VERSION_OFF = 40  # i64 param version of the held blob
_PAR_HDR_SIZE = 48

_PROBE_BYTES = 16

_BOOT_ID: str | None = None


def boot_id() -> str:
    """This host's boot id — the cheap first gate of the same-host
    probe (two processes on one boot share it; distinct hosts or a
    rebooted peer cannot). Empty string when unreadable, which refuses
    shm on both sides."""
    global _BOOT_ID
    if _BOOT_ID is None:
        try:
            with open("/proc/sys/kernel/random/boot_id") as fh:
                _BOOT_ID = fh.read().strip()
        except OSError:  # apexlint: lossy(no boot id -> shm never negotiates, TCP fallback)
            _BOOT_ID = ""
    return _BOOT_ID


_ATTACH_LOCK = make_lock("shm_transport._ATTACH_LOCK")


def attach(name: str) -> shared_memory.SharedMemory:
    """Attach an existing segment WITHOUT adopting cleanup ownership.

    Before Python 3.13, SharedMemory registers every attach with the
    resource tracker, which then unlinks segments it never owned at
    interpreter exit (3.13 adds track=False; the port runs on 3.12) —
    an attacher that outlives the creator would tear the segment out
    from under other peers and spam leak warnings. Registration is
    suppressed for the attach only (unregistering after the fact would
    double-unregister when creator and attacher share a process, e.g.
    every loopback test); creator-side registration is kept, so if the
    owning process dies the tracker still reclaims /dev/shm space."""
    with _ATTACH_LOCK:
        orig = resource_tracker.register
        try:
            resource_tracker.register = lambda *a, **k: None
            seg = shared_memory.SharedMemory(name=name)
        finally:
            resource_tracker.register = orig
    return seg


def make_probe() -> tuple[shared_memory.SharedMemory, str]:
    """Create the client's namespace probe: a tiny segment holding a
    random token. A server that can attach it and read the token back
    shares the client's /dev/shm namespace (containers on one host
    with private IPC namespaces fail here even though boot ids match).
    The client unlinks the probe after the hello exchange."""
    seg = shared_memory.SharedMemory(create=True, size=_PROBE_BYTES)
    token = secrets.token_bytes(_PROBE_BYTES)
    seg.buf[:_PROBE_BYTES] = token
    return seg, token.hex()


def check_probe(name: str, token_hex: str, peer_boot: str) -> bool:
    """Server-side same-host verification of a hello shm offer: boot
    ids must match AND the client's probe segment must be attachable
    with the advertised token. Any failure refuses the grant (the
    connection stays plain TCP)."""
    if not name or not token_hex or not peer_boot \
            or peer_boot != boot_id():
        return False
    try:
        seg = attach(name)
    except (OSError, ValueError):  # apexlint: lossy(probe unreachable -> different namespace, grant refused)
        return False
    try:
        return bytes(seg.buf[:_PROBE_BYTES]).hex() == token_hex
    finally:
        seg.close()


def pack_batch_into(batch: dict, dest: memoryview) -> int | None:
    """Pack an experience dict into `dest` in EXACTLY the raw
    encode_batch wire layout (pack_records framing, JSON meta as the
    first record) — a slot decodes with the same WireBatch machinery
    as a TCP payload. Returns bytes written, or None when the batch
    does not fit (the caller ships that batch over TCP instead).

    This is the actor-side half of the one-copy invariant: each array's
    bytes move STRAIGHT from the actor's buffer into the shared
    segment — no codec, no intermediate frame, no sendall."""
    meta: list[dict] = []
    arrays: list[np.ndarray] = []
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            if not v.flags["C_CONTIGUOUS"]:
                v = np.ascontiguousarray(v)
            meta.append({"k": k, "nd": True, "dt": v.dtype.str,
                         "sh": list(v.shape)})
            arrays.append(v)
        else:
            meta.append({"k": k, "nd": False, "v": v})
    hdr = json.dumps(meta).encode()
    total = 8 + len(hdr) + sum(8 + a.nbytes for a in arrays)
    if total > len(dest):
        return None
    off = 0
    dest[off:off + 8] = len(hdr).to_bytes(8, "little")
    off += 8
    dest[off:off + len(hdr)] = hdr
    off += len(hdr)
    for a in arrays:
        n = a.nbytes
        dest[off:off + 8] = n.to_bytes(8, "little")
        off += 8
        if n:
            dest[off:off + n] = memoryview(a).cast("B")
            off += n
    return off


class ShmRingServer:
    """Server-owned experience ring: creates the segment, validates
    doorbells against the in-slot header + crc, and frees slots once
    the consumer has landed the rows (ShmSlotBatch.release). Lives
    exactly as long as its client connection; `retire` reclaims the
    leases of a dead writer.

    Segment layout:
        [_RING_HDR][state byte x slots][(_SLOT_HDR + slot_bytes) x slots]
    """

    def __init__(self, slots: int, slot_bytes: int):
        self.slots = int(slots)
        self.slot_bytes = int(slot_bytes)
        size = _RING_HDR.size + self.slots \
            + self.slots * (_SLOT_HDR.size + self.slot_bytes)
        # apexlint: releases(_seg, unlink<close)
        self._seg = shared_memory.SharedMemory(create=True, size=size)
        buf = self._seg.buf
        _RING_HDR.pack_into(buf, 0, RING_MAGIC, self.slots,
                            self.slot_bytes)
        for i in range(self.slots):
            buf[_RING_HDR.size + i] = SLOT_FREE
        self.name = self._seg.name
        self._lock = make_lock("shm_ring._lock")
        # slots delivered to the consumer and not yet freed — they pin
        # the mapping open past retire() (their memoryviews alias it)
        self._delivered: set[int] = set()  # guarded-by: _lock
        self._doomed = False  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock

    def _slot_off(self, slot: int) -> int:
        return _RING_HDR.size + self.slots \
            + slot * (_SLOT_HDR.size + self.slot_bytes)

    def take(self, slot: int, seq: int, nbytes: int,
             crc: int) -> memoryview | None:
        """Validate one doorbell and return the slot's payload
        memoryview (zero-copy; freed via free()), or None when the
        slot is torn — wrong index/size, header mismatch, or crc
        failure. A torn slot is freed here and never delivered."""
        if not (0 <= slot < self.slots) \
                or not (0 < nbytes <= self.slot_bytes):
            return None
        with self._lock:
            if self._closed or slot in self._delivered:
                return None
            off = self._slot_off(slot)
            sseq, snbytes = _SLOT_HDR.unpack_from(self._seg.buf, off)
            if sseq != seq or snbytes != nbytes:
                self._free_locked(slot)
                return None
            view = self._seg.buf[off + _SLOT_HDR.size:
                                 off + _SLOT_HDR.size + nbytes]
            if native.crc32(view) != crc:
                view.release()
                self._free_locked(slot)
                return None
            self._delivered.add(slot)
        return view

    def free(self, slot: int) -> None:
        """Return a slot to the writer's free list (idempotent) — the
        one-byte state store IS the free-list doorbell the client's
        claim scan watches."""
        if not (0 <= slot < self.slots):
            return
        with self._lock:
            self._free_locked(slot)

    def _free_locked(self, slot: int) -> None:
        self._delivered.discard(slot)  # apexlint: unguarded(caller holds _lock)
        if not self._closed:
            self._seg.buf[_RING_HDR.size + slot] = SLOT_FREE
        self._close_if_drained_locked()

    @property
    def inflight(self) -> int:
        """Slots currently claimed by the writer (including delivered
        batches the consumer has not freed yet)."""
        with self._lock:
            if self._closed:
                return 0
            base = _RING_HDR.size
            return sum(1 for i in range(self.slots)
                       if self._seg.buf[base + i] != SLOT_FREE)

    def retire(self) -> int:
        """Reclaim the ring when its writer's connection is gone:
        unlink the segment name and count the leases the dead writer
        held (claimed but never delivered — a doorbell that DID arrive
        is either queued, consumed, or was counted torn). The unmap is
        deferred until delivered-but-unconsumed batches drain; their
        views stay valid because unlink only removes the name."""
        with self._lock:
            if self._doomed:
                return 0
            self._doomed = True  # apexlint: unguarded(holds _lock)
            base = _RING_HDR.size
            claimed = 0 if self._closed else \
                sum(1 for i in range(self.slots)
                    if self._seg.buf[base + i] != SLOT_FREE)
            reclaimed = max(claimed - len(self._delivered), 0)
            try:
                self._seg.unlink()
            except OSError:  # apexlint: lossy(name already gone; nothing left to reclaim)
                pass
            self._close_if_drained_locked()
        return reclaimed

    def _close_if_drained_locked(self) -> None:
        if self._doomed and not self._delivered and not self._closed:
            try:
                self._seg.close()
                self._closed = True  # apexlint: unguarded(caller holds _lock)
            except BufferError:
                # a stray exported view (e.g. an unreleased batch held
                # by a test) still pins the mapping; the next free()
                # retries, process exit unmaps regardless
                pass

    def destroy(self) -> None:
        """Server-shutdown teardown: retire if not already retired."""
        self.retire()


class ShmRingWriter:
    """Client half of the ring: attaches the server-granted segment
    and packs batches straight into claimed slots. Single-threaded by
    contract — the transport's sends serialize under _send_lock."""

    def __init__(self, name: str):
        self._seg = attach(name)
        magic, slots, slot_bytes = _RING_HDR.unpack_from(self._seg.buf, 0)
        if magic != RING_MAGIC:
            self._seg.close()
            raise ValueError("not a shm ring segment")
        self.slots = int(slots)
        self.slot_bytes = int(slot_bytes)
        self._seq = 0
        self._hint = 0
        self._closed = False

    def _claim(self) -> int | None:
        base = _RING_HDR.size
        buf = self._seg.buf
        for d in range(self.slots):
            i = (self._hint + d) % self.slots
            if buf[base + i] == SLOT_FREE:
                buf[base + i] = SLOT_CLAIMED
                self._hint = (i + 1) % self.slots
                return i
        return None

    def post(self, batch: dict) -> tuple[int, int, int, int] | None:
        """Claim a slot and pack `batch` into it (the one copy).
        Returns the doorbell tuple (slot, seq, nbytes, crc), or None
        when every slot is in flight or the batch outsizes a slot —
        the caller ships that batch over TCP and counts the
        fallback."""
        if self._closed:
            return None
        slot = self._claim()
        if slot is None:
            return None
        off = _RING_HDR.size + self.slots \
            + slot * (_SLOT_HDR.size + self.slot_bytes)
        payload = self._seg.buf[off + _SLOT_HDR.size:
                                off + _SLOT_HDR.size + self.slot_bytes]
        try:
            n = pack_batch_into(batch, payload)
            if n is None:
                self.release(slot)
                return None
            self._seq += 1
            _SLOT_HDR.pack_into(self._seg.buf, off, self._seq, n)
            crc = native.crc32(payload[:n])
        finally:
            payload.release()
        return slot, self._seq, n, crc

    def release(self, slot: int) -> None:
        """Undo a claim whose doorbell never reached the server (send
        failure, oversize batch) so the slot is not leaked."""
        if 0 <= slot < self.slots and not self._closed:
            self._seg.buf[_RING_HDR.size + slot] = SLOT_FREE

    @property
    def free_slots(self) -> int:
        if self._closed:
            return 0
        base = _RING_HDR.size
        return sum(1 for i in range(self.slots)
                   if self._seg.buf[base + i] == SLOT_FREE)

    def close(self) -> None:
        """Detach (never unlink — the server owns the segment)."""
        if not self._closed:
            self._closed = True
            try:
                self._seg.close()
            except BufferError:
                pass  # stray view; process exit unmaps


class ShmParamArea:
    """Server-side seqlock param publication area: ONE region every
    local client reads, replacing per-client pickled MSG_PARAMS blobs.
    Written only by the server's push thread; torn reads are the
    reader's problem by design (detected via seq/crc, retried)."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        # apexlint: releases(_seg, unlink<close)
        self._seg = shared_memory.SharedMemory(
            create=True, size=_PAR_HDR_SIZE + self.capacity)
        buf = self._seg.buf
        struct.pack_into("<I", buf, _PAR_MAGIC_OFF, PARAM_MAGIC)
        struct.pack_into("<Q", buf, _PAR_SEQ_OFF, 0)
        struct.pack_into("<Q", buf, _PAR_NBYTES_OFF, 0)
        struct.pack_into("<q", buf, _PAR_EPOCH_OFF, -1)
        struct.pack_into("<q", buf, _PAR_VERSION_OFF, -1)
        self.name = self._seg.name
        # (epoch, version) currently held — the push loop's dedupe, so
        # a late shm grant can republish current params without a new
        # publish_params call
        self.holds: tuple[int, int] = (-1, -1)
        self.writes = 0
        self._seq = 0
        self._destroyed = False

    def write(self, blob: bytes, epoch: int, version: int) -> bool:
        """Publish one blob under the seqlock. An oversize blob
        publishes an nbytes=0 marker instead — readers see the fresh
        (epoch, version), find no blob, and fall back to the TCP param
        path. Returns whether the blob itself landed."""
        if self._destroyed:
            return False
        buf = self._seg.buf
        n = len(blob)
        fits = n <= self.capacity
        self._seq += 1  # odd: write in progress
        struct.pack_into("<Q", buf, _PAR_SEQ_OFF, self._seq)
        if fits:
            buf[_PAR_HDR_SIZE:_PAR_HDR_SIZE + n] = blob
        struct.pack_into("<Q", buf, _PAR_NBYTES_OFF, n if fits else 0)
        struct.pack_into("<I", buf, _PAR_CRC_OFF,
                         native.crc32(blob) if fits else 0)
        struct.pack_into("<q", buf, _PAR_EPOCH_OFF, epoch)
        struct.pack_into("<q", buf, _PAR_VERSION_OFF, version)
        self._seq += 1  # even: stable
        struct.pack_into("<Q", buf, _PAR_SEQ_OFF, self._seq)
        self.holds = (epoch, version)
        self.writes += 1
        return fits

    def destroy(self) -> None:
        if not self._destroyed:
            self._destroyed = True
            try:
                self._seg.unlink()
            except OSError:  # apexlint: lossy(name already gone)
                pass
            try:
                self._seg.close()
            except BufferError:
                pass  # stray reader view in-process; exit unmaps


class ShmParamReader:
    """Client half of the param seqlock: attaches the server's area
    and reads (blob, epoch, version) snapshots, detecting torn reads
    via the sequence counter and the blob crc."""

    def __init__(self, name: str):
        self._seg = attach(name)
        (magic,) = struct.unpack_from("<I", self._seg.buf, _PAR_MAGIC_OFF)
        if magic != PARAM_MAGIC:
            self._seg.close()
            raise ValueError("not a shm param area")
        self.capacity = self._seg.size - _PAR_HDR_SIZE
        self.torn_retries = 0
        self._closed = False

    def _hdr(self) -> tuple[int, int, int, int, int]:
        buf = self._seg.buf
        (seq,) = struct.unpack_from("<Q", buf, _PAR_SEQ_OFF)
        (n,) = struct.unpack_from("<Q", buf, _PAR_NBYTES_OFF)
        (crc,) = struct.unpack_from("<I", buf, _PAR_CRC_OFF)
        (ep,) = struct.unpack_from("<q", buf, _PAR_EPOCH_OFF)
        (ver,) = struct.unpack_from("<q", buf, _PAR_VERSION_OFF)
        return seq, n, crc, ep, ver

    def _seq_now(self) -> int:
        (seq,) = struct.unpack_from("<Q", self._seg.buf, _PAR_SEQ_OFF)
        return seq

    def read(self, have_epoch: int, have_version: int,
             retries: int = 8) -> tuple[str, bytes | None, int, int] | None:
        """One coherent snapshot: (status, blob, epoch, version) with
        status "full" (blob attached), "unchanged" (caller already
        holds this (epoch, version)), "empty" (nothing published yet)
        or "oversize" (blob only available over TCP). None after
        `retries` torn attempts — the caller falls back to the TCP
        param path, which is always correct."""
        if self._closed:
            return None
        for attempt in range(retries):
            if attempt:
                self.torn_retries += 1
                time.sleep(0.0002 * attempt)  # let the writer finish
            seq0, n, crc, ep, ver = self._hdr()
            if seq0 & 1:
                continue  # writer mid-publish
            if (ep, ver) == (-1, -1):
                if self._seq_now() != seq0:
                    continue
                return "empty", None, -1, -1
            if (ep, ver) == (have_epoch, have_version):
                if self._seq_now() != seq0:
                    continue
                return "unchanged", None, ep, ver
            if n == 0:
                if self._seq_now() != seq0:
                    continue
                return "oversize", None, ep, ver
            if n > self.capacity:
                continue  # header torn across a resize-free area: retry
            blob = bytes(self._seg.buf[_PAR_HDR_SIZE:_PAR_HDR_SIZE + n])
            if self._seq_now() != seq0 or native.crc32(blob) != crc:
                continue
            return "full", blob, ep, ver
        return None

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._seg.close()
            except BufferError:
                pass  # stray view; process exit unmaps
