"""TCP transport: actor hosts -> learner host.

Counterpart of ``ape_x_dqn_tpu/comm/socket_transport.py``, copied with
the wire unchanged: the same frames, message types, hello negotiation,
experience codecs and param codecs, so a peer of either package talks
to a peer of the other (tests/test_torch_wire.py cross-decodes both
directions). The Ape-X paper's actors feed the learner over gRPC; this
plain TCP layer carries the host-side paths: experience ingest into
the learner host and parameter pulls by actor hosts. What the port
changes: params publish as a numpy tree (comm/param_codec.py), and a
push now carries the membership epoch its version was PUBLISHED under
(`publish_params`), so a `bump_epoch` between two publications can no
longer pair the new epoch with the old incarnation's version (the
original pushes that pair, and its subscriber then holds a chain base
the next publication deltas from instead of resyncing).

Wire format (both directions), assembled/verified by the native codec
(comm/native.py -> cpp/framing.cpp, Python-fallback compatible):

    [u32 magic 'APEX'][u8 type][u32 crc32(payload)][u64 len][payload]

Experience payloads are pack_records([json header, raw array bytes...])
— zero pickle on the hot path. Parameter payloads (low-rate control
plane) are pickled pytrees.

Semantics match LoopbackTransport: ingest is lossy-tolerant (bounded
queue, drop-oldest under backpressure; a dead learner connection drops
batches rather than killing the actor), so actor loss / learner restart
degrade gracefully.

WIRE-FORMAT COMPATIBILITY: the bf16 param wire is a pickle-level
break — param blobs now carry _Bf16Wire marker objects, which a PRE-bf16
actor-host build cannot unpickle (its get_params fails the load and the
actor silently stays on stale params; only builds at/after the change
log the skew warning). Mixed-build fleets must either upgrade actor
hosts first or run the learner with --param-wire-dtype float32, whose
blobs remain loadable by every build. Same-build fleets (the supported
deployment) are unaffected.

WIRE CODEC ("delta-deflate", default-on, CommConfig.wire_codec): on a
bandwidth-constrained link the ingest wire is the bottleneck (about
9.7 KB per pong transition raw), so experience leaves are
compressed per-leaf before framing: uint8 frame rows ship as XOR-delta
against the previous row in the block (temporally adjacent frames ->
mostly-zero deltas; native fast path in cpp/framing.cpp) followed by
stdlib zlib deflate; bool leaves bit-pack (np.packbits) + deflate;
integer leaves deflate (RLE-grade on action/done streams); float leaves
stay raw (incompressible). Each leaf's encoding rides the JSON meta
header ("enc" tag), with a per-leaf raw fallback whenever compression
would not shrink it — so a codec payload is fully self-describing.
Codec payloads use a distinct message type (MSG_EXPERIENCE_C) and are
only sent after a connect-time hello/ack negotiation: a new client
offers its codec (MSG_HELLO), a new server answers with the agreed
choice (MSG_HELLO_ACK), an OLD server silently ignores the hello (its
reader drops unknown types) and the client falls back to raw on the ack
timeout. Old clients never send a hello and keep sending raw
MSG_EXPERIENCE, which every server still accepts — old<->new peers
interoperate in both directions.

TELEMETRY (MSG_TELEMETRY): per-peer obs snapshot frames — JSON objects
carrying a peer id, heartbeat ages, counter/gauge scalars, histogram
snapshots, and span aggregates — ride the experience socket as a
low-rate control plane, so the learner's fleet aggregator
(obs/fleet.py) can merge every peer's instruments into the single run
JSONL and feed remote heartbeats to the stall watchdog. The capability
negotiates over the same hello/ack: a new client adds "telemetry" to
its offer (sending the hello even when its codec is raw), a new server
echoes the grant in the ack, an old server times the hello out (the
client then never ships frames), and an old client never offers it.
A connection that carried at least one telemetry frame is an
IDENTIFIED peer: its socket closing is attributed (peer_disconnects +
a warning naming the peer + the on_disconnect hook) instead of being
silent actor loss.

MEMBERSHIP EPOCH (MSG_HELLO_ACK "epoch"): every server incarnation
stamps a fresh epoch id into its hello ack, so a client can tell "the
same learner blipped" from "a NEW learner took the address" (restart,
upgrade, failover). The client's supervised reconnect loop (capped
jittered exponential backoff, per-reason drop accounting) reruns the
hello on every reconnect — codec and telemetry renegotiate for free —
and an epoch CHANGE additionally resets the push cell and warns, so
params re-converge to the live incarnation even when its version
counter restarted below the old one. Old peers never see the field
(an old client sends no hello; an old server sends no epoch) and keep
the pre-epoch poll/raw behavior — no protocol break.

PARAM VERSIONING (MSG_PARAMS header + MSG_PARAMS_PUSH): a new client's
MSG_PARAMS_REQ carries the (epoch, version) it already has as a JSON
payload; a new server answers MSG_PARAMS with a small
[magic, epoch, version] header, followed by the pickled blob only when
the client is actually behind — an up-to-date replica costs one
header-sized round-trip instead of re-shipping megabytes of weights.
Peers that negotiated "params_push" in the hello additionally receive
server-initiated MSG_PARAMS_PUSH frames (same header+blob shape) on
the experience socket at publish time, turning the param path from
per-actor polling into epoch-versioned publication. An old server
ignores the request payload and replies with the legacy raw pickle;
an old client sends an empty request and gets exactly that — the
param path interops both ways with pre-epoch builds.

PARAM CODEC ("delta-q8", CommConfig.param_codec, comm/param_codec.py):
the cross-host param broadcast — `model_bytes x peers x publish_rate`
of learner egress — would be the last uncompressed high-volume wire
path, so it negotiates a delta+quantized codec the way the experience
wire does: params ship as per-leaf int8-quantized deltas against the
version the peer last received, with per-leaf and whole-payload
never-inflate guards and automatic full resync when a peer misses a
version, falls out of the delta window, or crosses an epoch bump. The
codec is granted per channel: pushes negotiate a "param_codecs" offer /
"param_codec" grant over the same hello/ack, pulls state a "codec"
field in the MSG_PARAMS_REQ JSON (the param socket has no hello; an
old server ignores the unknown key and replies the versioned/legacy
shape, which the client parses as before). Coded payloads lead with
their own magic ('APXC'), so every receiver sniffs the right parser —
old<->new interop degrades silently to the raw paths both ways, the
shm seqlock area always carries the raw blob (local bandwidth is
free), and param_codec="raw" keeps the TCP path bitwise identical to
the pre-codec build. One ParamBlobProvider owns the bytes for every
(epoch, version) — legacy blob, versioned replies, coded chain, shm
area and local get_params all read it, so pull and push can never
disagree about a version's bytes. Fan-out isolation rides the same
change: the push loop is now a dispatcher that deposits the target
version into per-subscriber one-deep latest-wins cells drained by
per-subscriber sender threads — a wedged peer wedges only its own
thread, and the versions it missed are counted as superseded drops
(param_push_queue_drops), never queued behind.

SHARED-MEMORY SAME-HOST PLANE (MSG_SHM_DOORBELL, comm/shm_transport.py):
a client whose hello carries an "shm" offer — boot id plus a namespace
probe segment the server must attach and read back, so only a true
same-host/same-IPC-namespace peer ever qualifies — is granted a
per-connection experience ring and the shared seqlock param area, named
in the hello ack. Experience then packs STRAIGHT into a claimed ring
slot (no codec, no sendall of the body; the actor-side pack is the one
copy, the learner-side staging landing the other half of the existing
invariant) and a ~24-byte MSG_SHM_DOORBELL frame on this same TCP
socket names the slot, so reconnect/backoff, epoch machinery,
backpressure latches, chaos injection and drop accounting all keep
working on the control plane they already own. The server validates
seq + crc before delivering — torn slots (writer died mid-write, wild
writes) are counted and freed, never delivered — and reclaims every
lease when the connection drops. Params publish once into the seqlock
area; granted clients read it locally (per-client MSG_PARAMS blob
pulls and params_push frames stop entirely for them). EVERY shm
failure mode — old peer (the offer/grant keys are ignored like any
unknown capability), cross-host peer, probe failure, full ring,
oversize batch or blob, torn read — degrades silently to the TCP paths
above, which remain bitwise unchanged when comm.shm is off.
"""

from __future__ import annotations

import json
import logging
import pickle
import queue
import random
import socket
import struct
import threading
import time
import zlib
from collections import deque
from typing import Any

import numpy as np

from ape_x_dqn_tpu_torch.comm import native, shm_transport
from ape_x_dqn_tpu_torch.comm.param_codec import (  # noqa: F401 - re-exports
    _PARAMS_HDR, PARAM_CODECS, PARAMS_CODEC_MAGIC, PARAMS_HDR_MAGIC,
    ParamBlobProvider, ParamChainDecoder, _Bf16Wire, _downcast_f32,
    _upcast_bf16, check_param_codec, tree_to_numpy)
from ape_x_dqn_tpu_torch.obs.health import make_lock

MAGIC = 0x41504558  # 'APEX'
MSG_EXPERIENCE = 1
MSG_PARAMS_REQ = 2
MSG_PARAMS = 3
MSG_HELLO = 4          # client codec offer (JSON), sent on connect
MSG_HELLO_ACK = 5      # server's codec choice (JSON)
MSG_EXPERIENCE_C = 6   # experience payload with codec-encoded leaves
MSG_TELEMETRY = 7      # per-peer obs snapshot frame (JSON), negotiated
MSG_PARAMS_PUSH = 8    # server-initiated params (negotiated subscribers)
MSG_SHM_DOORBELL = 9   # same-host shm slot announcement (negotiated)

# doorbell payload: slot index, slot seq, payload nbytes, payload crc.
# ~24 bytes on the control socket announce a multi-MB slot — the whole
# experience body moved through shared memory (comm/shm_transport.py)
_DOORBELL = struct.Struct("<IQQI")

WIRE_CODECS = ("raw", "delta-deflate")

_HDR = struct.Struct("<IBIQ")  # magic, type, crc, payload_len
MAX_PAYLOAD = 1 << 31
_WARNED_BAD_BLOB = False
# _PARAMS_HDR / PARAMS_HDR_MAGIC (the versioned 'APXV' reply prefix)
# and PARAMS_CODEC_MAGIC (the coded 'APXC' payload prefix) live in
# comm/param_codec.py with the codec and are re-exported above — the
# three param payload shapes (legacy pickle 0x80, APXV, APXC) are
# sniffed by first bytes, none of which collide.
# samples kept for the reconnect/recovery-latency instrument
_RECONNECT_SAMPLES = 256

# delta+deflate only pays on frame-sized rows; small rows (actions,
# rewards) would spend more header than they save
_DELTA_MIN_ROW_BYTES = 1024
# Z_BEST_SPEED: the encoder runs on actor-host CPUs next to env
# stepping; on mostly-zero XOR deltas level 1 already collapses runs,
# higher levels buy single-digit % ratio for multiples of encode time
_DEFLATE_LEVEL = 1


def _check_codec(codec: str) -> str:
    if codec not in WIRE_CODECS:
        raise ValueError(
            f"wire_codec must be one of {WIRE_CODECS}, got {codec!r}")
    return codec


# -- codec ------------------------------------------------------------------


def _encode_leaf(v: np.ndarray) -> tuple[str, bytes] | None:
    """(enc tag, compressed bytes) for one array leaf under the
    delta-deflate codec, or None to ship it raw. Per-leaf policy:
    frame-like uint8 rows -> XOR-delta vs the previous row + deflate
    ("xd"); bools -> bit-pack + deflate ("bp"); other integers ->
    deflate ("d"); floats raw. Any leaf whose compressed form would not
    shrink falls back to raw — the codec can never inflate a message."""
    if v.dtype == np.uint8 and v.ndim >= 2 and v.shape[0] >= 2 \
            and v[0].nbytes >= _DELTA_MIN_ROW_BYTES:
        delta = native.delta_encode(v.reshape(v.shape[0], -1))
        comp = zlib.compress(delta, _DEFLATE_LEVEL)
        return ("xd", comp) if len(comp) < v.nbytes else None
    if v.dtype == np.bool_:
        comp = zlib.compress(np.packbits(v.reshape(-1)).tobytes(),
                             _DEFLATE_LEVEL)
        return ("bp", comp) if len(comp) < v.nbytes else None
    if np.issubdtype(v.dtype, np.integer):
        buf = memoryview(v).cast("B") if v.flags["WRITEABLE"] \
            else v.tobytes()
        comp = zlib.compress(buf, _DEFLATE_LEVEL)
        return ("d", comp) if len(comp) < v.nbytes else None
    return None


def encode_batch(batch: dict, codec: str = "raw") -> bytes:
    """Experience dict (numpy arrays + scalars) -> framed payload.

    Already-contiguous arrays hand their buffer straight to
    pack_records (which memcpys into the frame) — zero extra copies;
    the old ascontiguousarray + tobytes() path copied every array
    twice before the frame copy.

    codec="delta-deflate" compresses leaves per _encode_leaf's policy
    and tags each compressed leaf in the JSON meta ("enc"), keeping the
    payload self-describing; callers must only ship such payloads to
    peers that negotiated the codec (as MSG_EXPERIENCE_C)."""
    _check_codec(codec)
    meta, arrays = [], []
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            if not v.flags["C_CONTIGUOUS"]:
                v = np.ascontiguousarray(v)
            m = {"k": k, "nd": True, "dt": v.dtype.str, "sh": list(v.shape)}
            encoded = _encode_leaf(v) if codec != "raw" else None
            if encoded is not None:
                m["enc"] = encoded[0]
                arrays.append(encoded[1])
            else:
                arrays.append(memoryview(v).cast("B")
                              if v.flags["WRITEABLE"] else v.tobytes())
            meta.append(m)
        else:
            meta.append({"k": k, "nd": False, "v": v})
    return native.pack_records([json.dumps(meta).encode()] + arrays)


def _leaf_nbytes(m: dict) -> int:
    """Decoded (raw) byte size of an array leaf, from its meta alone."""
    return int(np.prod(m["sh"], dtype=np.int64)) * np.dtype(m["dt"]).itemsize


def _new_cache() -> dict:
    """Per-payload decode scratch for codec leaves: inflated deflate
    streams (reused by every decode_into split of the same payload),
    per-leaf delta continuation (next expected start row + the last
    decoded ABSOLUTE row — the XOR anchor when a batch splits across
    staging buffers), and fully-materialized small leaves."""
    return {"inflated": {}, "prev": {}, "full": {}}


def _inflate_leaf(cache: dict, m: dict, rec) -> bytes:
    """Inflate one compressed leaf record, cached per payload. The
    inflate OUTPUT takes over the wire buffer's role on the zero-copy
    path: landing it in the staging block stays the one copy per
    (decoded) byte. Truncated/corrupt streams reject with ValueError —
    the server reader drops such a connection like any misframed one."""
    key = m["k"]
    buf = cache["inflated"].get(key)
    if buf is None:
        expected = _leaf_nbytes(m) if m["enc"] != "bp" \
            else (int(np.prod(m["sh"], dtype=np.int64)) + 7) // 8
        try:
            buf = zlib.decompress(rec)
        except zlib.error as e:
            raise ValueError(f"corrupt codec stream for leaf {key!r}: {e}")
        if len(buf) != expected:
            raise ValueError(
                f"codec stream for leaf {key!r} inflates to {len(buf)} "
                f"bytes, expected {expected}")
        cache["inflated"][key] = buf
    return buf


def _decode_leaf_full(m: dict, rec, cache: dict | None = None) -> np.ndarray:
    """Materialize one array leaf (any encoding) as a fresh array."""
    dt, sh, enc = np.dtype(m["dt"]), m["sh"], m.get("enc")
    if enc is None:
        # the .copy() is load-bearing, not a convenience: the returned
        # array must OWN its memory because `rec` aliases a transport
        # buffer with a shorter lifetime — for a ShmSlotBatch it is a
        # ring slot that the writer REUSES the moment release() frees
        # it (a view would silently mutate under the consumer), and
        # even for TCP payloads a view would pin the entire multi-MB
        # frame alive for the lifetime of one decoded leaf. The
        # one-copy hot path is decode_into (no copy here, lands
        # straight in staging); this full-materialize path only serves
        # dict-protocol consumers. Pinned by test_comm.py
        # (test_decode_leaf_full_copies_are_load_bearing).
        return np.frombuffer(rec, dtype=dt).reshape(sh).copy()
    cache = cache if cache is not None else _new_cache()
    full = cache["full"].get(m["k"])
    if full is not None:
        return full
    buf = _inflate_leaf(cache, m, rec)
    if enc == "bp":
        n = int(np.prod(sh, dtype=np.int64))
        arr = np.unpackbits(np.frombuffer(buf, np.uint8),
                            count=n).view(np.bool_).reshape(sh)
    elif enc in ("d", "xd"):
        # load-bearing copy #2: zlib.decompress returns immutable
        # bytes, and the "xd" undo below XORs rows IN PLACE — the copy
        # is what buys writable memory. It doubles as ownership for
        # "d" leaves: `buf` lives in the per-payload cache, which this
        # returned array must outlive. Pinned by the same test as the
        # raw-leaf copy above.
        arr = np.frombuffer(buf, dtype=dt).reshape(sh).copy()
        if enc == "xd" and arr.shape[0] > 1:
            native.delta_undo_inplace(
                arr.reshape(arr.shape[0], -1).view(np.uint8))
    else:
        raise ValueError(f"unknown wire codec leaf encoding {enc!r}")
    cache["full"][m["k"]] = arr
    return arr


def decode_batch(payload) -> dict:
    meta, recs = _parse_payload(payload)
    out: dict = {}
    i = 1
    for m in meta:
        if m["nd"]:
            out[m["k"]] = _decode_leaf_full(m, recs[i])
            i += 1
        else:
            out[m["k"]] = m["v"]
    return out


def _parse_payload(payload) -> tuple[list, list[memoryview]]:
    """(meta, per-array memoryview records) of a wire payload — the
    zero-copy front half shared by every decode form."""
    recs = native.unpack_records_mv(payload)
    meta = json.loads(bytes(recs[0]))
    return meta, recs


def _land_delta_rows(m: dict, dslice: np.ndarray, buf: bytes, start: int,
                     k: int, cache: dict) -> None:
    """Land delta rows [start, start+k) of an "xd" leaf at dslice and
    undo the XOR IN PLACE in the staging memory: copy the inflated
    delta rows in (the one landing copy), XOR row 0 against the
    previous landed ABSOLUTE row when the batch split across staging
    buffers, then prefix-undo the rest (native fast path, numpy
    accumulate fallback)."""
    sh = m["sh"]
    dt = np.dtype(m["dt"])
    row = int(np.prod(sh[1:], dtype=np.int64))
    src = np.frombuffer(buf, dtype=dt, count=k * row,
                        offset=start * row * dt.itemsize)
    dslice[...] = src.reshape((k, *sh[1:]))
    flat = dslice.reshape(k, -1).view(np.uint8)
    if start > 0:
        prev = None
        cont = cache["prev"].get(m["k"])
        if cont is not None and cont[0] == start:
            prev = cont[1]
        if prev is None:
            # non-sequential access (no continuation): the absolute
            # row before `start` is the XOR-prefix of all delta rows
            # up to it — rare path, the stager always advances start
            # sequentially
            allrows = np.frombuffer(buf, dtype=np.uint8,
                                    count=start * row * dt.itemsize)
            prev = np.bitwise_xor.reduce(
                allrows.reshape(start, -1), axis=0)
        np.bitwise_xor(flat[0], prev, out=flat[0])
    native.delta_undo_inplace(flat)
    cache["prev"][m["k"]] = (start + k, flat[-1].copy())


def _decode_rows_into(meta: list, recs: list[memoryview], dest: dict,
                      offset: int, start: int, limit: int,
                      cache: dict | None = None) -> int:
    """Land rows [start, start+k) of every array record directly in
    dest[key][offset:offset+k] — ONE copy per (decoded) wire byte,
    contiguous by construction. Returns k (rows written). Wire arrays
    without a matching dest key are skipped (the legacy stage likewise
    only read the item keys it knew). Codec leaves ("enc" meta tag)
    inflate once per payload (cached) and land with the delta-undo
    applied in place in the staging rows."""
    written = None
    i = 1
    for m in meta:
        if not m["nd"]:
            continue
        rec, i = recs[i], i + 1
        d = dest.get(m["k"])
        if d is None:
            continue
        sh = m["sh"]
        total = int(sh[0]) if sh else 0
        k = max(min(limit, total - start), 0)
        enc = m.get("enc")
        if enc is None:
            dt = np.dtype(m["dt"])
            row = int(np.prod(sh[1:], dtype=np.int64))
            src = np.frombuffer(rec, dtype=dt, count=k * row,
                                offset=start * row * dt.itemsize)
            d[offset:offset + k] = src.reshape((k, *sh[1:]))
        elif k > 0:
            if cache is None:
                cache = _new_cache()
            if enc == "xd":
                buf = _inflate_leaf(cache, m, rec)
                _land_delta_rows(m, d[offset:offset + k], buf, start, k,
                                 cache)
            elif enc == "d":
                buf = _inflate_leaf(cache, m, rec)
                dt = np.dtype(m["dt"])
                row = int(np.prod(sh[1:], dtype=np.int64))
                src = np.frombuffer(buf, dtype=dt, count=k * row,
                                    offset=start * row * dt.itemsize)
                d[offset:offset + k] = src.reshape((k, *sh[1:]))
            else:
                # bit-packed bools (tiny leaves): materialize once per
                # payload, then row-slice — not worth a fused landing
                full = _decode_leaf_full(m, rec, cache)
                d[offset:offset + k] = full[start:start + k]
        written = k
    return written or 0


def decode_batch_into(payload, dest: dict, offset: int, start: int = 0,
                      limit: int | None = None) -> tuple[int, int, dict]:
    """Decode a wire experience payload DIRECTLY into preallocated
    staging arrays at a write cursor.

    dest maps array keys -> preallocated [cap, ...] numpy rows; rows
    [start, start+k) of the batch land at dest[key][offset:offset+k],
    where k = min(limit, rows-start). Returns (k, rows, scalars) —
    scalars are the non-array entries (e.g. "frames", "actor"). Callers
    split a batch across staging-buffer boundaries by calling again
    with an advanced `start` (use WireBatch.decode_into for split
    decodes of codec payloads — it carries the inflate + delta
    continuation cache across calls)."""
    meta, recs = _parse_payload(payload)
    rows = batch_rows_meta(meta)
    if limit is None:
        limit = rows
    k = _decode_rows_into(meta, recs, dest, offset, start, limit)
    scalars = {m["k"]: m["v"] for m in meta if not m["nd"]}
    return k, rows, scalars


def batch_rows_meta(meta: list) -> int:
    """Staging units in a wire batch: priorities' leading dim (the
    driver's unit count), falling back to the first array record."""
    first = None
    for m in meta:
        if m["nd"]:
            if first is None:
                first = int(m["sh"][0]) if m["sh"] else 0
            if m["k"] == "priorities":
                return int(m["sh"][0])
    return first or 0


class WireBatch:
    """A received experience payload, decoded lazily.

    The ingest staging fast path (runtime/ingest.py) calls decode_into
    to land the wire bytes straight in a staging block with one copy;
    every other consumer (the multihost driver's stage, tests reading
    the queue directly) treats it like the dict decode_batch used to
    return — item access materializes arrays on demand and caches them.
    Scalar metadata ("frames", "actor") and the row count come from the
    JSON header alone, with no array copies.

    Codec payloads (MSG_EXPERIENCE_C) decode through the same interface:
    _cache holds the per-leaf inflate output and the delta-undo
    continuation so a batch split across staging buffers inflates each
    leaf ONCE and chains the XOR across decode_into calls."""

    __slots__ = ("payload", "_meta", "_recs", "_arrays", "_cache")

    def __init__(self, payload):
        self.payload = payload
        self._meta: list | None = None
        self._recs: list[memoryview] | None = None
        self._arrays: dict = {}
        self._cache: dict | None = None

    def _parsed(self) -> tuple[list, list[memoryview]]:
        if self._meta is None:
            self._meta, self._recs = _parse_payload(self.payload)
        return self._meta, self._recs

    @property
    def rows(self) -> int:
        """Staging units in this batch (header-only, no array copies)."""
        meta, _ = self._parsed()
        return batch_rows_meta(meta)

    @property
    def wire_nbytes(self) -> int:
        """Bytes this batch occupied on the wire (payload size)."""
        return len(self.payload)

    @property
    def raw_nbytes(self) -> int:
        """Bytes the array leaves would occupy uncompressed — the
        numerator of the wire compression ratio (header-only)."""
        meta, _ = self._parsed()
        return sum(_leaf_nbytes(m) for m in meta if m["nd"])

    def decode_into(self, dest: dict, offset: int, start: int = 0,
                    limit: int | None = None) -> int:
        """One-copy landing of rows [start, start+k) at dest[...][offset:].
        Returns k. See decode_batch_into."""
        meta, recs = self._parsed()
        if limit is None:
            limit = self.rows
        if self._cache is None:
            self._cache = _new_cache()
        return _decode_rows_into(meta, recs, dest, offset, start, limit,
                                 self._cache)

    def __getitem__(self, key):
        if key in self._arrays:
            return self._arrays[key]
        meta, recs = self._parsed()
        i = 1
        for m in meta:
            if m["nd"]:
                if m["k"] == key:
                    if self._cache is None:
                        self._cache = _new_cache()
                    arr = _decode_leaf_full(m, recs[i], self._cache)
                    self._arrays[key] = arr
                    return arr
                i += 1
            elif m["k"] == key:
                return m["v"]
        raise KeyError(key)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def keys(self):
        meta, _ = self._parsed()
        return [m["k"] for m in meta]

    def __contains__(self, key) -> bool:
        meta, _ = self._parsed()
        return any(m["k"] == key for m in meta)


class ShmSlotBatch(WireBatch):
    """An experience batch living in a server-owned shm ring slot.

    The payload memoryview aliases the shared segment (zero copies so
    far — the actor's pack into the slot was the only one); all the
    WireBatch decode machinery works unchanged because the slot holds
    an exact raw wire payload. release() hands the slot back to the
    writer once the consumer has landed the rows (IngestStager.put, the
    legacy stage path, or a queue drop-oldest eviction); it must drop
    every memoryview into the segment first, or the ring could never
    unmap after its connection dies. Idempotent, with a __del__ net so
    an exotic consumer that never releases (tests poking the queue)
    leaks a slot for a bounded time, not forever."""

    __slots__ = ("_ring", "_slot", "_released")

    def __init__(self, view: memoryview, ring, slot: int):
        super().__init__(view)
        self._ring = ring
        self._slot = slot
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        recs, self._recs = self._recs, None
        self._cache = None
        if recs is not None:
            for r in recs:
                try:
                    r.release()
                except BufferError:
                    pass  # aliased by a live array; __del__/GC frees it
        payload, self.payload = self.payload, b""
        try:
            payload.release()
        except (BufferError, AttributeError):
            pass
        self._ring.free(self._slot)

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass


def batch_rows(batch) -> int:
    """Staging units in an ingest message, cheap for both forms: wire
    batches read their JSON header; dict batches read priorities."""
    if isinstance(batch, WireBatch):
        return batch.rows
    return int(batch["priorities"].shape[0])


def _send_msg(sock: socket.socket, mtype: int, payload: bytes) -> None:
    hdr = _HDR.pack(MAGIC, mtype, native.crc32(payload), len(payload))
    sock.sendall(hdr + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytearray | None:
    """Read exactly n bytes into ONE preallocated buffer via recv_into —
    multi-MB experience frames land without per-chunk copies or
    bytearray regrowth. Returns the bytearray itself (crc32, struct
    unpack, and the record walk all take buffers, so no bytes() copy)."""
    buf = bytearray(n)
    mv = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(mv[got:], n - got)
        if r == 0:
            return None
        got += r
    return buf


def _recv_msg(sock: socket.socket) -> tuple[int, bytearray] | None:
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    magic, mtype, crc, ln = _HDR.unpack(hdr)
    if magic != MAGIC or ln > MAX_PAYLOAD:
        raise ValueError("bad frame header")
    payload = _recv_exact(sock, ln)
    if payload is None:
        return None
    if native.crc32(payload) != crc:
        raise ValueError("checksum mismatch")
    return mtype, payload


# -- learner-host side ------------------------------------------------------


class _PushSub:
    """Per-subscriber push fan-out state. The bounded send queue the
    drop-to-resync semantics call for is a ONE-DEEP latest-wins target
    cell: a param subscriber only ever needs the newest version (the
    codec's chain covers any gap, and a full resync covers the rest),
    so anything deeper would just delay it — depth-1 with supersede
    counting IS the bounded queue. `last` is what this subscriber last
    received (its delta base); sender-thread-private."""

    __slots__ = ("conn", "coded", "wake", "lock", "target", "last", "stop")

    def __init__(self, conn: socket.socket, coded: bool):
        self.conn = conn
        self.coded = bool(coded)
        self.wake = threading.Event()
        self.lock = make_lock("ingest_server.push_sub")
        self.target: tuple[int, int] | None = None  # guarded-by: lock
        self.last: tuple[int, int] = (-1, -1)
        self.stop = False


class SocketIngestServer:
    """Transport implementation that listens for remote actor hosts.

    Drop-in for LoopbackTransport on the learner host: recv_experience
    drains a bounded queue fed by per-connection reader threads;
    publish_params caches a pickled blob that MSG_PARAMS_REQ replies
    serve without re-serializing per client.
    """

    def __init__(self, host: str = "0.0.0.0", port: int = 0,
                 max_pending: int = 64, idle_grace_s: float = 5.0,
                 param_wire_dtype: str = "bfloat16",
                 wire_codec: str = "delta-deflate",
                 param_codec: str = "delta-q8",
                 param_delta_window: int = 8,
                 epoch: int | None = None, shm: bool = False,
                 shm_slots: int = 8, shm_slot_bytes: int = 1 << 22,
                 shm_param_bytes: int = 1 << 26):
        """param_wire_dtype: dtype for float params on the wire.
        "bfloat16" (default) halves the weight-broadcast bytes — param
        pulls can saturate a bandwidth-constrained link, and actors
        compute in bf16 anyway (the receiver upcasts to f32, so only
        the bf16 rounding of the values survives — a behavior-policy
        perturbation far below the eps-greedy noise floor). Set
        "float32" for bit-exact distribution.

        wire_codec: experience codec this server is willing to grant in
        the connect-time hello negotiation ("delta-deflate" default;
        "raw" is the escape hatch that forces every peer to plain
        payloads). Decode is always codec-capable — the setting only
        controls what MSG_HELLO_ACK offers.

        param_codec: param-plane codec this server is willing to grant
        ("delta-q8" default: per-leaf int8-quantized deltas vs the
        peer's last-received version, full resync on missed versions /
        epoch bumps — comm/param_codec.py). Granted only to peers that
        ASK (hello "param_codecs" offer for pushes, a "codec" field in
        MSG_PARAMS_REQ for pulls); "raw" keeps the whole param path
        bitwise identical to the pre-codec build. param_delta_window
        caps how many encoded delta segments are kept for catch-up — a
        peer further behind than the window gets a full resync.

        epoch: membership epoch id stamped into every MSG_HELLO_ACK
        and versioned params header. Defaults to a wall-clock-derived
        id, so a restarted server (a new incarnation at the same
        address) presents a different epoch and clients re-converge;
        pass an explicit value to pin it (tests, deterministic
        fleets).

        shm: grant same-host shared-memory transport to clients whose
        hello offer passes the boot-id + namespace probe
        (comm/shm_transport.py). shm_slots/shm_slot_bytes cap the
        per-connection experience ring a client may request;
        shm_param_bytes sizes the one shared seqlock param area. Off
        by default — TCP-only paths are bitwise unchanged when
        disabled."""
        if param_wire_dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"param_wire_dtype must be 'bfloat16' or 'float32', "
                f"got {param_wire_dtype!r}")
        self._wire_dtype = param_wire_dtype
        self._codec = _check_codec(wire_codec)
        self._param_codec = check_param_codec(param_codec)
        # membership epoch: wall-clock-derived by default so a restarted
        # incarnation at the same address stamps a DIFFERENT id (tests
        # pin it; collisions need two restarts in the same millisecond)
        self.epoch = (int(epoch) if epoch is not None
                      else (time.time_ns() // 1_000_000) & 0x7FFF_FFFF)
        self._q: queue.Queue[dict] = queue.Queue(maxsize=max_pending)
        self._dropped = 0  # guarded-by: _conns_lock
        # wire accounting (payload bytes; headers are ~17B noise):
        # lets a driver publish the link's MB/s budget — experience in
        # vs params out is THE contended resource on
        # bandwidth-constrained links
        self._bytes_in = 0  # guarded-by: _conns_lock
        self._raw_bytes_in = 0  # guarded-by: _conns_lock
        self._bytes_out = 0  # guarded-by: _conns_lock
        # what the param replies WOULD have cost with no codec — the
        # numerator of param_compression_ratio (raw-path replies count
        # their own length, so the ratio is exactly 1.0 under
        # param_codec="raw" and >= 1.0 under the never-inflate guard)
        self._param_raw_bytes_out = 0  # guarded-by: _conns_lock
        # coded peers that held a real base yet needed a full payload
        # (missed version / out of window / epoch bump)
        self._param_resyncs = 0  # guarded-by: _conns_lock
        # push fan-out drops by reason: "superseded" (a deposited
        # version was overwritten before the subscriber's sender
        # consumed it — drop-to-resync, never queued behind) and
        # "disconnect" (send failed, subscriber dropped)
        self._push_drop_reasons = {"superseded": 0,
                                   "disconnect": 0}  # guarded-by: _conns_lock
        # the one versioned-blob provider (comm/param_codec.py): legacy
        # blob, versioned replies, coded chain, shm area writes and
        # local get_params all read IT, so pull and push can never
        # disagree about the bytes for a version
        self._provider = ParamBlobProvider(
            param_wire_dtype, param_codec, param_delta_window)
        self._lock = make_lock("ingest_server._lock")
        # (epoch, version) of the latest publication, read by the push
        # dispatcher
        self._published: tuple[int, int] = (self.epoch, -1)  # guarded-by: _lock
        self._stop = threading.Event()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(128)
        self._listener.settimeout(0.2)
        self.port = self._listener.getsockname()[1]
        # _conns is mutated by the accept thread and every reader thread
        # and read by the driver's idle/termination check — the check is
        # load-bearing for fleet lifetime (a stale read can terminate a
        # multihost run early), so mutations take an explicit lock
        # rather than leaning on the GIL's list-op atomicity
        self._conns: list[socket.socket] = []  # guarded-by: _conns_lock
        self._conns_lock = make_lock("ingest_server._conns_lock")
        self._idle_grace_s = idle_grace_s
        # fleet telemetry plane: a connection that ships at least one
        # MSG_TELEMETRY frame identifies itself as a peer; its loss is
        # then attributed (counter + warning + hook) instead of silent
        self._conn_peers: dict[int, str] = {}  # guarded-by: _conns_lock
        # serving-tier tenant tags: a connection that offered a serve
        # tag in its hello is attributed to (policy_id, priority
        # class) — the learner-side admission controller and report
        # can then name WHICH tenant's actors a connection carries
        self._conn_serve: dict[int, tuple[str, int]] = {}  # guarded-by: _conns_lock
        self._telemetry_frames = 0  # guarded-by: _conns_lock
        self._telemetry_bytes_in = 0  # guarded-by: _conns_lock
        self._peer_disconnects = 0  # guarded-by: _conns_lock
        # hooks the driver installs before traffic; called from reader
        # threads, so implementations must be thread-safe
        self.on_telemetry: Any = None  # (peer_id: str, frame: dict) -> None
        self.on_disconnect: Any = None  # (peer_id: str) -> None
        # byzantine-peer accounting: a truncated/garbled frame is an
        # attributed counter + hook call, not just a silently-ended
        # connection (a corrupting proxy or skewed build would
        # otherwise churn connections with no observable trace)
        self.on_decode_error: Any = None  # (peer_id: str, reason: str) -> None
        self._wire_decode_errors = 0  # guarded-by: _conns_lock
        self._last_disconnect: float | None = None  # guarded-by: _conns_lock
        self._ever_connected = False  # guarded-by: _conns_lock
        # params-push plane: subscribers registered at hello time. A
        # dispatcher thread (_push_loop) deposits the target
        # (epoch, version) into each subscriber's one-deep cell at
        # publish boundaries; PER-SUBSCRIBER sender threads
        # (_push_sender) build and ship that subscriber's payload — a
        # slow or wedged peer wedges only its own thread, never the
        # learner thread and never the other subscribers.
        # Per-connection send locks serialize the reader's replies
        # (acks, poll responses) against push writes.
        self._push_subs: dict[int, _PushSub] = {}  # guarded-by: _conns_lock
        self._conn_send_locks: dict[int, Any] = {}  # guarded-by: _conns_lock
        self._param_pushes = 0  # guarded-by: _conns_lock
        self._push_wake = threading.Event()
        self._push_thread: threading.Thread | None = None
        # same-host shm plane (comm/shm_transport.py): one experience
        # ring per granted connection, one param seqlock area for all
        self._shm_enabled = bool(shm)
        self._shm_slots = int(shm_slots)
        self._shm_slot_bytes = int(shm_slot_bytes)
        self._shm_param_bytes = int(shm_param_bytes)
        self._conn_shm: dict[int, Any] = {}  # guarded-by: _conns_lock
        self._shm_param_area: Any = None  # guarded-by: _lock
        self._shm_doorbells = 0  # guarded-by: _conns_lock
        self._shm_torn_slots = 0  # guarded-by: _conns_lock
        self._shm_fallbacks = 0  # guarded-by: _conns_lock
        self._shm_reclaimed = 0  # guarded-by: _conns_lock
        self._shm_dropped = 0  # guarded-by: _conns_lock
        self._shm_bytes_in = 0  # guarded-by: _conns_lock
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="ingest-accept", daemon=True)
        self._accept_thread.start()

    # Transport interface (learner side)

    def recv_experience(self, timeout: float | None = None) -> dict | None:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def send_experience(self, batch: dict) -> None:
        """Local actors on the learner host share the same queue."""
        while True:
            try:
                self._q.put_nowait(batch)
                return
            except queue.Full:
                try:
                    old = self._q.get_nowait()
                    # every reader thread and local actors land here on
                    # a full queue; a bare += across threads loses drops
                    with self._conns_lock:
                        self._dropped += 1
                        if isinstance(old, ShmSlotBatch):
                            self._shm_dropped += 1
                    # an evicted shm batch must hand its slot back, or
                    # backpressure would leak the writer's ring dry
                    rel = getattr(old, "release", None)
                    if rel is not None:
                        rel()
                except queue.Empty:
                    pass

    def publish_params(self, params: Any, version: int) -> None:
        # store the tree and serialize/encode lazily on the first reply
        # per version: device->host transfer + pickling a multi-MB CNN
        # tree would otherwise run synchronously on the learner thread at
        # every publish boundary, stalling training dispatches — and is
        # pure waste when no remote host is connected
        with self._lock:
            self._provider.publish(params, version)
            # the epoch this version belongs to: pushes and the shm area
            # carry this pair, never (a later epoch, this version)
            self._published = (self.epoch, version)
        # wake the push dispatcher (no-op when nothing ever subscribed)
        self._push_wake.set()

    def bump_epoch(self) -> None:
        """Advance the membership epoch in place — the drill/test hook
        for 'a new incarnation took over' without tearing the listener
        down. New hellos and versioned param replies carry the new id;
        connected epoch-aware clients converge on their next exchange:
        a pull at once, a push subscriber with the next publication
        (pushes carry the epoch each version was published under, so
        the bump itself pushes nothing)."""
        with self._lock:
            self.epoch += 1

    def _param_blob(self) -> bytes:
        return self._provider.raw_blob()

    def _versioned_params_reply(self, have_epoch: int,
                                have_version: int) -> bytes:
        """Versioned MSG_PARAMS/MSG_PARAMS_PUSH payload:
        [magic, epoch, version] header, plus the pickled blob only when
        the client's (epoch, version) is behind — an up-to-date replica
        costs a header-sized reply instead of megabytes of weights."""
        payload, _kind, _ver, _raw = self._provider.versioned_reply(
            have_epoch, have_version, self.epoch)
        return payload

    def get_params(self) -> tuple[Any, int]:
        """Local loopback callers get the deserialized tree directly,
        cached per published version — no pickle round-trip per pull;
        the pickled blob stays wire-only. The cache still holds the
        BLOB-roundtripped values (bf16 wire rounding and all), so local
        and remote pulls see bit-identical params."""
        return self._provider.get_tree()

    @property
    def dropped(self) -> int:
        return self._dropped

    @property
    def bytes_in(self) -> int:
        """Experience payload bytes received from remote actor hosts."""
        return self._bytes_in

    @property
    def raw_bytes_in(self) -> int:
        """What bytes_in would have been with no wire codec (the
        decoded size of every received experience leaf)."""
        return self._raw_bytes_in

    @property
    def wire_compression_ratio(self) -> float:
        """raw/wire byte ratio over all experience received so far
        (1.0 = no savings; larger is better). 0.0 before any traffic."""
        with self._conns_lock:
            return (self._raw_bytes_in / self._bytes_in
                    if self._bytes_in else 0.0)

    @property
    def bytes_out(self) -> int:
        """Param blob bytes served to remote actor hosts."""
        return self._bytes_out

    @property
    def telemetry_frames(self) -> int:
        """MSG_TELEMETRY frames received from remote peers."""
        with self._conns_lock:
            return self._telemetry_frames

    @property
    def telemetry_bytes_in(self) -> int:
        """Telemetry payload bytes received (control-plane budget)."""
        with self._conns_lock:
            return self._telemetry_bytes_in

    @property
    def peer_disconnects(self) -> int:
        """Identified telemetry peers whose connection closed."""
        with self._conns_lock:
            return self._peer_disconnects

    @property
    def wire_decode_errors(self) -> int:
        """Truncated/garbled/misframed frames received (each one also
        dropped its connection and fired on_decode_error)."""
        with self._conns_lock:
            return self._wire_decode_errors

    @property
    def param_pushes(self) -> int:
        """MSG_PARAMS_PUSH frames shipped to subscribed peers."""
        with self._conns_lock:
            return self._param_pushes

    @property
    def param_bytes_out(self) -> int:
        """Param payload bytes served (poll replies + push frames) —
        the param plane's half of the link budget; bytes_out is its
        alias on this server (experience flows IN only)."""
        with self._conns_lock:
            return self._bytes_out

    @property
    def param_raw_bytes_out(self) -> int:
        """What the served param replies would have cost with no codec
        (the APXV header+blob equivalent of every reply)."""
        with self._conns_lock:
            return self._param_raw_bytes_out

    @property
    def param_compression_ratio(self) -> float:
        """raw/wire ratio over all param bytes served (exactly 1.0
        under param_codec="raw"; >= 1.0 always — the never-inflate
        guard degrades any coded reply that would not undercut the raw
        one). 0.0 before any param traffic."""
        with self._conns_lock:
            return (self._param_raw_bytes_out / self._bytes_out
                    if self._bytes_out else 0.0)

    @property
    def param_resyncs(self) -> int:
        """Full param payloads served to coded peers that held a REAL
        base (missed version, out of the delta window, epoch bump) —
        initial fulls to fresh peers don't count."""
        with self._conns_lock:
            return self._param_resyncs

    @property
    def param_push_queue_drops(self) -> dict[str, int]:
        """Per-reason push fan-out drops: "superseded" (a deposited
        version was overwritten by a newer one before that subscriber's
        sender consumed it — the slow peer skips straight to the newest
        version, by design) and "disconnect" (send failed)."""
        with self._conns_lock:
            return dict(self._push_drop_reasons)

    @property
    def push_subscribers(self) -> int:
        """Connections that negotiated params_push and are still up."""
        with self._conns_lock:
            return len(self._push_subs)

    @property
    def serve_peers(self) -> dict[str, int]:
        """Live connections per serving-tier tenant tag, as
        policy_id -> connection count (untagged connections — old
        clients, single-tenant fleets — simply don't appear)."""
        with self._conns_lock:
            out: dict[str, int] = {}
            for policy, _cls in self._conn_serve.values():
                out[policy] = out.get(policy, 0) + 1
            return out

    @property
    def shm_doorbells(self) -> int:
        """Experience batches delivered through shm ring slots."""
        with self._conns_lock:
            return self._shm_doorbells

    @property
    def shm_torn_slots(self) -> int:
        """Doorbells whose slot failed seq/crc/framing validation —
        detected torn, freed, never delivered."""
        with self._conns_lock:
            return self._shm_torn_slots

    @property
    def shm_fallbacks(self) -> int:
        """TCP experience frames received from connections that hold
        an shm grant (ring-full / oversize degradations)."""
        with self._conns_lock:
            return self._shm_fallbacks

    @property
    def shm_reclaimed(self) -> int:
        """Slot leases reclaimed from writers that disconnected with
        claims outstanding (died mid-write or before the doorbell)."""
        with self._conns_lock:
            return self._shm_reclaimed

    @property
    def shm_dropped(self) -> int:
        """Shm-delivered batches evicted by the drop-oldest queue
        policy (their slots were freed at eviction)."""
        with self._conns_lock:
            return self._shm_dropped

    @property
    def shm_bytes_in(self) -> int:
        """Experience payload bytes that crossed via shm slots (the
        loopback bytes the TCP accounting no longer sees)."""
        with self._conns_lock:
            return self._shm_bytes_in

    @property
    def shm_slots_inflight(self) -> int:
        """Ring slots currently claimed across all granted
        connections (writer-claimed + delivered-not-yet-freed)."""
        with self._conns_lock:
            rings = list(self._conn_shm.values())
        return sum(r.inflight for r in rings)

    @property
    def shm_rings(self) -> int:
        """Connections currently holding an shm grant."""
        with self._conns_lock:
            return len(self._conn_shm)

    @property
    def pending(self) -> int:
        return self._q.qsize()

    @property
    def active_connections(self) -> int:
        """Live remote actor-host connections (readers deregister on
        disconnect). Drivers use this for idle/termination checks — a
        drained queue does not mean producers are done."""
        with self._conns_lock:
            return len(self._conns)

    @property
    def ever_connected(self) -> bool:
        """True once ANY remote producer has SENT EXPERIENCE — drivers
        use this for their boot-grace check instead of polling
        active_connections, which can miss a producer that connected
        and vanished entirely inside a warmup/compile window. Latching
        on the first experience message (not on accept) keeps
        param-only probes from masquerading as producers."""
        with self._conns_lock:
            return self._ever_connected

    def quiesced(self) -> bool:
        """True when no remote producer is connected AND none has
        disconnected within the last idle_grace_s. The grace period
        debounces transient drops: SocketTransport reconnects a broken
        send inside the same call, so an actor host that blipped is
        back within milliseconds — an idle verdict taken in that window
        would terminate a fleet whose producers all intend to return.

        INVARIANT vs the supervised reconnect loop: the client's
        reconnect backoff cap (CommConfig.reconnect_cap_s, 2.0 default)
        must stay BELOW idle_grace_s (5.0 default). A client backing
        off from a connection this server dropped retries — and, with
        the server healthy, reconnects — within one cap interval, well
        inside the grace window that its own disconnect opened, so a
        fleet merely riding out a blip never reads as quiesced. Stretch
        the backoff cap past the grace and the debounce breaks; tests
        pin the ordering (test_chaos.py)."""
        with self._conns_lock:
            if self._conns:
                return False
            if self._last_disconnect is None:
                return True
            return (time.monotonic() - self._last_disconnect
                    >= self._idle_grace_s)

    def stop(self) -> None:
        self._stop.set()
        self._push_wake.set()  # unblock the push dispatcher's wait
        with self._conns_lock:
            subs = list(self._push_subs.values())
        for sub in subs:  # unblock every per-subscriber sender
            sub.stop = True
            sub.wake.set()
        self._accept_thread.join(timeout=2)
        if self._push_thread is not None:
            self._push_thread.join(timeout=2)
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:  # apexlint: lossy(shutdown close best effort)
                pass
        self._listener.close()
        # drain the ingest queue: a batch parked at shutdown is never
        # consumed, and a parked ShmSlotBatch pins its ring slot (and
        # with it the mapping) until released — drain BEFORE destroying
        # the rings so every slot is handed back first
        while True:
            try:
                old = self._q.get_nowait()
            except queue.Empty:
                break
            rel = getattr(old, "release", None)
            if rel is not None:
                rel()
        # shm teardown: the server owns every segment it granted
        with self._conns_lock:
            rings = list(self._conn_shm.values())
            self._conn_shm.clear()
        for ring in rings:
            ring.destroy()
        with self._lock:
            area, self._shm_param_area = self._shm_param_area, None
        if area is not None:
            area.destroy()

    # internals

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:  # apexlint: lossy(idle accept tick, nothing lost)
                continue
            except OSError:  # apexlint: lossy(listener closed by stop())
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.append(conn)
                self._conn_send_locks[id(conn)] = make_lock(
                    "ingest_server.conn_send")
            # apexlint: detached(reader exits when its socket dies; stop() closes every conn)
            threading.Thread(target=self._reader, args=(conn,),
                             name="ingest-reader", daemon=True).start()

    def _send_on(self, conn: socket.socket, mtype: int,
                 payload: bytes) -> None:
        """Send one frame on a connection, serialized against the other
        writer (the reader's replies vs the push thread). The per-conn
        lock is fetched under _conns_lock but HELD WITHOUT it — a slow
        subscriber's sendall must never stall accept/disconnect
        bookkeeping for the whole fleet."""
        with self._conns_lock:
            lock = self._conn_send_locks.get(id(conn))
        if lock is None:  # connection already torn down
            raise OSError("connection closed")
        with lock:
            _send_msg(conn, mtype, payload)

    def _ensure_push_thread(self) -> None:
        """Lazily start the push thread on the first subscription —
        poll-only fleets (and every pre-push build's usage) never pay
        for it."""
        with self._conns_lock:
            if self._push_thread is not None or self._stop.is_set():
                return
            self._push_thread = threading.Thread(
                target=self._push_loop, name="params-push", daemon=True)
            self._push_thread.start()

    def _push_loop(self) -> None:
        """Push DISPATCHER: at publish/epoch boundaries, write the shm
        param area (always raw — local bandwidth is free) and deposit
        the target (epoch, version) into every subscriber's one-deep
        cell. No socket write happens on this thread anymore — the
        per-subscriber _push_sender threads own the sendall, so one
        wedged peer can no longer serialize the broadcast for everyone
        (a single sending loop would)."""
        while not self._stop.is_set():
            if not self._push_wake.wait(timeout=0.2):
                continue
            self._push_wake.clear()
            with self._lock:
                cur = self._published
                area = self._shm_param_area
            version = cur[1]
            # the shm param area rides this thread (same serialization
            # cost, same publish boundary) but dedupes on ITS OWN held
            # (epoch, version): a grant arriving after the last publish
            # must still land current params for the new attacher, even
            # when every TCP subscriber is already up to date
            if area is not None and version >= 0 and area.holds != cur:
                blob, aver, _key = self._provider.raw_blob_versioned()
                if aver == version:  # else a newer publish wakes us again
                    area.write(blob, cur[0], aver)
            if version < 0:
                continue
            with self._conns_lock:
                subs = list(self._push_subs.values())
            for sub in subs:
                self._deposit(sub, cur)

    def _deposit(self, sub: _PushSub, cur: tuple[int, int]) -> None:
        """Latest-wins deposit into one subscriber's target cell. An
        unconsumed DIFFERENT target getting overwritten means the
        subscriber was still sending (or wedged) when a newer version
        landed: that stale version is superseded — counted, never
        queued behind (the codec chain spans the gap; a resync covers
        the rest)."""
        with sub.lock:
            prev, sub.target = sub.target, cur
        if prev is not None and prev != cur:
            with self._conns_lock:
                self._push_drop_reasons["superseded"] += 1
        sub.wake.set()

    def _push_sender(self, sub: _PushSub) -> None:
        """One subscriber's sender: consume the latest deposited
        target, build THIS subscriber's payload — coded subscribers get
        a delta against what they last received (or a full resync),
        raw subscribers the versioned header+blob exactly as before —
        and ship it. Building per subscriber is the price of fan-out
        isolation; the provider's blob/chain/full caches make every
        subscriber in the same state share the encode cost."""
        while not self._stop.is_set() and not sub.stop:
            if not sub.wake.wait(timeout=0.2):
                continue
            sub.wake.clear()
            with sub.lock:
                target, sub.target = sub.target, None
            if target is None or target == sub.last:
                continue
            epoch = target[0]
            had_base = sub.coded and sub.last[1] >= 0
            try:
                if sub.coded:
                    payload, kind, ver, raw_cost = \
                        self._provider.coded_reply(
                            sub.last[0], sub.last[1], epoch)
                else:
                    payload, kind, ver, raw_cost = \
                        self._provider.versioned_reply(-1, -1, epoch)
                self._send_on(sub.conn, MSG_PARAMS_PUSH, payload)
            except OSError:  # apexlint: lossy(subscriber dropped; reader attributes the disconnect)
                with self._conns_lock:
                    self._push_subs.pop(id(sub.conn), None)
                    self._push_drop_reasons["disconnect"] += 1
                return
            sub.last = (epoch, ver)
            with self._conns_lock:
                self._param_pushes += 1
                self._bytes_out += len(payload)
                self._param_raw_bytes_out += raw_cost
                if had_base and kind in ("full", "raw_full"):
                    self._param_resyncs += 1

    def _grant_shm(self, conn: socket.socket,
                   req: dict) -> dict[str, Any] | None:
        """Verify a hello shm offer and, if it proves same-host, build
        the grant: a fresh per-connection experience ring plus the
        (shared, lazily created) param seqlock area. Any failure —
        probe refused, /dev/shm unavailable, garbage offer — returns
        None and the connection stays plain TCP."""
        try:
            if not shm_transport.check_probe(
                    str(req.get("probe", "")), str(req.get("token", "")),
                    str(req.get("boot", ""))):
                return None
            slots = max(1, min(int(req.get("slots") or self._shm_slots),
                               self._shm_slots))
            slot_bytes = max(1 << 16,
                             min(int(req.get("slot_bytes")
                                     or self._shm_slot_bytes),
                                 self._shm_slot_bytes))
            ring = shm_transport.ShmRingServer(slots, slot_bytes)
        except (OSError, ValueError, TypeError):  # apexlint: lossy(shm unavailable -> grant refused, TCP still works)
            return None
        with self._conns_lock:
            self._conn_shm[id(conn)] = ring
        grant: dict[str, Any] = {"ring": ring.name, "slots": ring.slots,
                                 "slot_bytes": ring.slot_bytes}
        area = self._ensure_param_area()
        if area is not None:
            grant["params"] = area.name
        return grant

    def _ensure_param_area(self) -> Any:
        """Create the shared param seqlock area on the first shm grant
        and (re)arm the push thread so CURRENT params land in it — a
        client attaching long after the last publish must not read an
        empty area until the next training publish."""
        with self._lock:
            if self._shm_param_area is None:
                try:
                    self._shm_param_area = shm_transport.ShmParamArea(
                        self._shm_param_bytes)
                except (OSError, ValueError):  # apexlint: lossy(area unavailable -> clients pull params over TCP)
                    return None
            area = self._shm_param_area
        self._ensure_push_thread()
        self._push_wake.set()
        return area

    def _reader(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                msg = _recv_msg(conn)
                if msg is None:
                    return  # peer closed: actor loss is tolerated
                mtype, payload = msg
                if mtype in (MSG_EXPERIENCE, MSG_EXPERIENCE_C):
                    # enqueue the payload with decode deferred (WireBatch):
                    # the ingest thread lands the bytes straight in its
                    # staging block with one copy instead of this reader
                    # materializing a full dict of array copies per
                    # message. Parse the header here so a corrupt frame
                    # faults THIS connection, not the consumer. Codec
                    # payloads (MSG_EXPERIENCE_C) are self-describing
                    # per leaf, so decode needs no per-connection state.
                    batch = WireBatch(payload)
                    batch.rows  # noqa: B018 - framing validation
                    raw = batch.raw_nbytes if mtype == MSG_EXPERIENCE_C \
                        else len(payload)
                    # ever_connected latches HERE, not on accept: a
                    # param-only probe (monitoring, or an actor host
                    # that died waiting for params) is not a producer,
                    # and counting it once terminated a remote-only
                    # learner 0.1s into run() — the probe had come and
                    # gone during construction, so boot grace was
                    # skipped and quiesced() read idle)
                    # byte counters under the lock too: every reader
                    # thread increments them, and a bare `+=` interleaved
                    # across threads loses counts — they are the
                    # link-budget accounting, so they must be exact
                    with self._conns_lock:
                        self._ever_connected = True
                        self._bytes_in += len(payload)
                        self._raw_bytes_in += raw
                        # a TCP experience frame from a connection that
                        # holds an shm grant is a FALLBACK (ring full /
                        # oversize batch) — the server-visible half of
                        # the client's degradation accounting
                        if id(conn) in self._conn_shm:
                            self._shm_fallbacks += 1
                    self.send_experience(batch)
                elif mtype == MSG_SHM_DOORBELL:
                    # same-host data plane: the payload crossed in a
                    # shared-memory slot; this tiny frame only names it.
                    # Validation (seq + crc over the slot) runs before
                    # anything is delivered — a torn slot (writer died
                    # mid-write, wild write, stale doorbell) is counted
                    # and freed, never enqueued, and does NOT fault the
                    # connection: the control socket itself framed fine.
                    with self._conns_lock:
                        ring = self._conn_shm.get(id(conn))
                    if ring is None:
                        raise ValueError("shm doorbell without a grant")
                    try:
                        slot, seq, nbytes, crc = _DOORBELL.unpack(payload)
                    except struct.error:
                        raise ValueError("bad shm doorbell frame")
                    view = ring.take(slot, seq, nbytes, crc)
                    batch = None
                    if view is not None:
                        batch = ShmSlotBatch(view, ring, slot)
                        try:
                            batch.rows  # noqa: B018 - framing validation
                        except (ValueError, KeyError):
                            batch.release()  # frees the slot
                            batch = None
                    if batch is None:
                        with self._conns_lock:
                            self._shm_torn_slots += 1
                            who = self._conn_peers.get(
                                id(conn), "unidentified")
                        cb = self.on_decode_error
                        if cb is not None and not self._stop.is_set():
                            cb(who, "torn shm slot")
                        continue
                    with self._conns_lock:
                        self._ever_connected = True
                        self._shm_doorbells += 1
                        self._shm_bytes_in += nbytes
                    self.send_experience(batch)
                elif mtype == MSG_HELLO:
                    # codec negotiation: grant the configured codec iff
                    # the client offered it; else raw. An OLD client
                    # never sends a hello and keeps raw MSG_EXPERIENCE.
                    # Telemetry is a capability echo on the same
                    # exchange: granted iff the client offered it (an
                    # old client never does, so this server never
                    # expects frames from it).
                    serve_tag: tuple[str, int] | None = None
                    shm_req: dict | None = None
                    try:
                        hello = json.loads(bytes(payload))
                        offered = hello.get("codecs", [])
                        wants_tel = bool(hello.get("telemetry"))
                        wants_push = bool(hello.get("params_push"))
                        # param-plane codec offer (push channel only —
                        # pulls negotiate per-request in MSG_PARAMS_REQ
                        # since the param socket has no hello). Old
                        # clients never offer; old servers ignore the
                        # key — raw pushes both ways.
                        pc_offer = hello.get("param_codecs", [])
                        if not isinstance(pc_offer, list):
                            pc_offer = []
                        # serving-tier tenant tag, negotiated like the
                        # telemetry capability: an OLD client never
                        # offers one, an OLD server (this code absent)
                        # ignores unknown offer keys — both directions
                        # degrade to untagged traffic
                        serve = hello.get("serve")
                        if isinstance(serve, dict) and serve.get("policy"):
                            serve_tag = (str(serve["policy"]),
                                         int(serve.get("class", 0)))
                        # same-host shm offer (the capability idiom
                        # again): an old client never offers, an
                        # old server ignores the key — TCP either way
                        req = hello.get("shm")
                        if isinstance(req, dict):
                            shm_req = req
                    except (ValueError, AttributeError, TypeError):
                        offered, wants_tel, wants_push = [], False, False
                        pc_offer = []
                        serve_tag = None
                        shm_req = None
                    grant = self._codec if self._codec in offered \
                        else "raw"
                    pc_grant: str | None = None
                    if pc_offer:
                        pc_grant = self._param_codec \
                            if self._param_codec in pc_offer else "raw"
                    shm_grant = self._grant_shm(conn, shm_req) \
                        if self._shm_enabled and shm_req is not None \
                        else None
                    # the epoch rides every ack: an old client never
                    # hellos (never sees it), a new client uses it to
                    # distinguish a blip from a new incarnation
                    ack: dict[str, Any] = {"codec": grant,
                                           "epoch": self.epoch}
                    if wants_tel:
                        ack["telemetry"] = True
                    # the shm param area SUPERSEDES per-connection param
                    # pushes for a granted client: its get_params reads
                    # the seqlock area, so shipping the same blob down
                    # this socket too would be pure duplicate bytes
                    if wants_push and shm_grant is None:
                        ack["params_push"] = True
                    if pc_grant is not None:
                        ack["param_codec"] = pc_grant
                    if shm_grant is not None:
                        ack["shm"] = shm_grant
                    if serve_tag is not None:
                        with self._conns_lock:
                            self._conn_serve[id(conn)] = serve_tag
                        ack["serve"] = True
                    # ack FIRST, subscribe after: if a publish is already
                    # pending, a push thread registered before the ack is
                    # on the wire could win the conn's send lock and make
                    # MSG_PARAMS_PUSH the connection's first frame — the
                    # client reads that as a failed negotiation, degrades
                    # to raw, and never drains the pushes, eventually
                    # wedging the push thread in sendall on a full window
                    self._send_on(conn, MSG_HELLO_ACK,
                                  json.dumps(ack).encode())
                    if wants_push and shm_grant is None:
                        sub = _PushSub(
                            conn, pc_grant not in (None, "raw"))
                        with self._conns_lock:
                            self._push_subs[id(conn)] = sub
                        # apexlint: detached(per-subscriber sender exits on sub.stop, set by stop() and by disconnect)
                        threading.Thread(
                            target=self._push_sender, args=(sub,),
                            name="params-push-send",
                            daemon=True).start()
                        self._ensure_push_thread()
                        # deposit CURRENT params right away: a
                        # subscriber joining after the last publish
                        # used to wait for the next one; now its
                        # sender ships what's already published
                        self._push_wake.set()
                elif mtype == MSG_TELEMETRY:
                    # per-peer obs snapshot: remember which peer this
                    # connection is (disconnect attribution), count the
                    # frame, and hand it to the fleet aggregator hook.
                    # A garbled frame faults this connection like any
                    # misframed message.
                    frame = json.loads(bytes(payload))
                    if not isinstance(frame, dict):
                        raise ValueError("telemetry frame is not an object")
                    peer = str(frame.get("peer", "peer?"))
                    with self._conns_lock:
                        self._conn_peers[id(conn)] = peer
                        self._telemetry_frames += 1
                        self._telemetry_bytes_in += len(payload)
                    cb = self.on_telemetry
                    if cb is not None:
                        cb(peer, frame)
                elif mtype == MSG_PARAMS_REQ:
                    # empty payload = legacy client: raw pickled blob.
                    # JSON payload = epoch-aware client stating what it
                    # already has: versioned header, blob only if
                    # behind. A "codec" field is the pull channel's
                    # per-request codec negotiation (the param socket
                    # has no hello): the coded reply is served iff the
                    # client asked AND this server's param_codec
                    # matches — any other combination, including this
                    # code absent on either side, degrades to the
                    # versioned/legacy shapes the client already
                    # parses.
                    resync = False
                    if len(payload) == 0:
                        reply = self._param_blob()
                        raw_cost = len(reply)
                    else:
                        try:
                            req = json.loads(bytes(payload))
                            have_ep = int(req.get("epoch", -1))
                            have_v = int(req.get("v", -1))
                            want = str(req.get("codec", "raw"))
                        except (ValueError, AttributeError, TypeError):
                            have_ep, have_v, want = -1, -1, "raw"
                        if want != "raw" and want == self._param_codec:
                            reply, kind, _ver, raw_cost = \
                                self._provider.coded_reply(
                                    have_ep, have_v, self.epoch)
                            resync = (have_v >= 0
                                      and kind in ("full", "raw_full"))
                        else:
                            reply, _kind, _ver, raw_cost = \
                                self._provider.versioned_reply(
                                    have_ep, have_v, self.epoch)
                    with self._conns_lock:
                        self._bytes_out += len(reply)
                        self._param_raw_bytes_out += raw_cost
                        if resync:
                            self._param_resyncs += 1
                    self._send_on(conn, MSG_PARAMS, reply)
        except OSError:
            # dead connection: drop it, keep serving others — the loss
            # is accounted where it is attributable (peer_disconnects
            # in the finally path below)
            return  # apexlint: lossy(disconnect counted in reader finally)
        except ValueError as e:
            # truncated / garbled / misframed traffic: the connection
            # still drops (framing state is unrecoverable mid-stream),
            # but the fault is COUNTED and attributed so a byzantine or
            # proxied peer can't silently churn connections
            with self._conns_lock:
                self._wire_decode_errors += 1
                who = self._conn_peers.get(id(conn), "unidentified")
            cb = self.on_decode_error
            if cb is not None and not self._stop.is_set():
                cb(who, str(e))
            return
        finally:
            with self._conns_lock:
                try:
                    self._conns.remove(conn)  # churn must not leak socks
                except ValueError:
                    pass
                self._conn_send_locks.pop(id(conn), None)
                sub = self._push_subs.pop(id(conn), None)
                if sub is not None:
                    # stop this subscriber's sender thread (it may also
                    # have exited on its own after a failed send)
                    sub.stop = True
                    sub.wake.set()
                self._conn_serve.pop(id(conn), None)
                ring = self._conn_shm.pop(id(conn), None)
                self._last_disconnect = time.monotonic()
                peer = self._conn_peers.pop(id(conn), None)
                if peer is not None:
                    self._peer_disconnects += 1
            if ring is not None:
                # lease reclaim: a writer that died mid-write left
                # claimed slots no doorbell will ever name — retire()
                # counts them, unlinks the segment, and defers the
                # unmap until queued batches drain
                reclaimed = ring.retire()
                with self._conns_lock:
                    self._shm_reclaimed += reclaimed
            if peer is not None and not self._stop.is_set():
                # a lost actor is an attributed event, never silence
                logging.getLogger(__name__).warning(
                    "[fleet] telemetry peer %r disconnected — its actors "
                    "stop producing until it reconnects", peer)
                cb = self.on_disconnect
                if cb is not None:
                    cb(peer)
            try:
                conn.close()
            except OSError:  # apexlint: lossy(close of dead connection)
                pass


# tree_to_numpy / _Bf16Wire / _downcast_f32 / _upcast_bf16 live in
# comm/param_codec.py with the param codec (re-exported at the top of
# this module).


# -- actor-host side --------------------------------------------------------


class SocketTransport:
    """Transport for a remote actor host: pushes experience, pulls params.

    send_experience never raises into the actor loop: on a broken
    connection it runs a SUPERVISED RECONNECT LOOP — one immediate
    retry inside the failing call, then capped jittered exponential
    backoff across calls (reconnect_base_s doubling to reconnect_cap_s,
    full jitter so a restarted learner is not hit by the whole fleet at
    once). Batches that fall in a backoff window are dropped without
    touching the network; every drop is accounted by reason
    (refused / reset / timeout / backpressure / other) so a run can
    tell a dead learner from a saturated link (Ape-X ingest is
    lossy-tolerant; the actor keeps generating experience for when the
    learner returns).

    wire_codec is OFFERED at connect time (MSG_HELLO) and used only if
    the server acks it; an old server ignores the hello, the ack read
    times out (hello_timeout), and the connection falls back to raw —
    negotiation reruns on every reconnect, so a learner restart onto a
    different build renegotiates transparently. The ack also carries
    the server's membership epoch: an epoch CHANGE (new incarnation)
    resets the pushed-params cell and is counted/logged, so the param
    path re-converges even when the new learner's version counter
    restarted below the old one.
    """

    def __init__(self, host: str, port: int, connect_timeout: float = 10.0,
                 wire_codec: str = "delta-deflate",
                 hello_timeout: float = 2.0, telemetry: bool = True,
                 reconnect_base_s: float = 0.05,
                 reconnect_cap_s: float = 2.0,
                 params_push: bool = False,
                 param_codec: str = "delta-q8",
                 serve_policy: str = "", serve_class: int = 0,
                 shm: bool = False, shm_slots: int = 8,
                 shm_slot_bytes: int = 1 << 22):
        """telemetry: offer the fleet-telemetry capability in the
        connect-time hello. send_telemetry only ships frames after the
        server granted it, so leaving this on against an old server
        costs one hello-timeout per (re)connect and nothing after.

        reconnect_base_s/reconnect_cap_s: supervised-reconnect backoff
        window. The cap must stay below the server's idle_grace_s (see
        SocketIngestServer.quiesced) so a backing-off fleet never reads
        as quiesced.

        params_push: offer the server-initiated param publication
        capability; when granted, MSG_PARAMS_PUSH frames arrive on the
        experience socket and poll_pushed_params() hands them over —
        against an old server the offer is ignored and polling is the
        only path.

        param_codec: param-plane codec to ask for ("delta-q8" default
        — per-leaf int8-quantized deltas vs the version last received,
        comm/param_codec.py). Pulls state it per request in
        MSG_PARAMS_REQ; pushes offer it in the hello. A server that
        doesn't speak it (old build, or configured raw) replies the
        versioned/legacy shapes, which parse exactly as before — and
        param_codec="raw" here keeps the request bytes and the whole
        TCP param path bitwise identical to the pre-codec build.

        serve_policy/serve_class: serving-tier tenant tag offered in
        the hello ("" = untagged, the single-tenant default). A new
        server records the tag for per-tenant attribution and echoes
        the capability; an old server ignores the unknown offer key —
        experience flows untagged either way. The tag also arms
        set_backpressure: the serving tier's admission controller can
        then shed THIS host's sends during overload windows.

        shm: offer the same-host shared-memory transport in the hello
        (with a boot-id + namespace probe proving same-host). When the
        server grants it, experience packs straight into ring slots
        (MSG_SHM_DOORBELL on this socket names them) and params read
        from the server's seqlock area; every shm failure mode —
        cross-host peer, old server, full ring, oversize batch, torn
        read — degrades to the plain TCP paths, counted. shm_slots/
        shm_slot_bytes shape the ring requested from the server."""
        self._addr = (host, port)
        self._timeout = connect_timeout
        self._codec = _check_codec(wire_codec)
        self._hello_timeout = hello_timeout
        self._telemetry = bool(telemetry)
        self._params_push = bool(params_push)
        self._param_codec = check_param_codec(param_codec)
        self._serve_policy = str(serve_policy)
        self._serve_class = int(serve_class)
        self._reconnect_base_s = max(float(reconnect_base_s), 1e-3)
        self._reconnect_cap_s = max(float(reconnect_cap_s),
                                    self._reconnect_base_s)
        self._negotiated: str = "raw"  # guarded-by: _send_lock
        self._telemetry_ok = False  # guarded-by: _send_lock
        self._push_ok = False  # guarded-by: _send_lock
        self._serve_ok = False  # guarded-by: _send_lock
        # serving-tier backpressure latch: while engaged, experience
        # sends drop host-side (counted under the existing
        # "backpressure" drop reason) instead of deepening an already
        # over-SLO admission queue. A plain bool flipped by
        # set_backpressure from the tier's controller thread and read
        # in the send path — GIL-atomic, deliberately lock-free so the
        # controller never blocks on a slow send
        self._bp_engaged = False
        self._telemetry_frames_out = 0  # guarded-by: _send_lock
        self._telemetry_bytes_out = 0  # guarded-by: _send_lock
        self._sock: socket.socket | None = None  # guarded-by: _send_lock
        self._param_sock: socket.socket | None = None  # guarded-by: _param_lock
        # every client-side drop is attributed to exactly one reason
        # bucket — the fleet report's drop_reasons table sums to
        # `dropped` because lint proves it, not because tests noticed
        # apexlint: closure(_dropped == _drop_reasons)
        self._dropped = 0  # guarded-by: _send_lock
        self._bytes_out = 0  # guarded-by: _send_lock
        self._raw_bytes_out = 0  # guarded-by: _send_lock
        self._encode_ms = 0.0  # guarded-by: _send_lock
        # supervised-reconnect state (all guarded-by: _send_lock):
        # consecutive failures drive the exponential backoff; the
        # disconnect timestamp feeds the reconnect-latency instrument
        self._consec_fails = 0  # guarded-by: _send_lock
        self._backoff_until = 0.0  # guarded-by: _send_lock
        self._reconnects = 0  # guarded-by: _send_lock
        self._disconnected_at: float | None = None  # guarded-by: _send_lock
        self._reconnect_latencies: deque[float] = deque(
            maxlen=_RECONNECT_SAMPLES)  # guarded-by: _send_lock
        self._drop_reasons = {"refused": 0, "reset": 0, "timeout": 0,
                              "backpressure": 0, "other": 0}  # guarded-by: _send_lock
        self._bytes_in = 0  # guarded-by: _param_lock
        self._param_version = -1  # guarded-by: _param_lock
        self._param_epoch = -1  # guarded-by: _param_lock
        self._param_pull_errors = 0  # guarded-by: _param_lock
        self._param_unchanged = 0  # guarded-by: _param_lock
        # coded payloads whose base this decoder didn't hold (server
        # chain window overrun, epoch bump, state lost) — each one
        # reset the chain and re-pulled full
        self._param_resyncs = 0  # guarded-by: _param_lock
        # param-codec chain state: the float32 reconstruction coded
        # payloads advance. Its own lock because BOTH the pull path and
        # the push reader thread decode through it.
        self._param_decoder = ParamChainDecoder()  # guarded-by: _codec_lock
        # push-channel codec grant from the hello ack (the pull channel
        # negotiates per request and needs no latch)
        self._param_codec_ok = False  # guarded-by: _send_lock
        # membership epoch as last seen from any server message; its
        # own lock because both the send path (hello ack) and the param
        # path (versioned replies) update it
        self._epoch = -1  # guarded-by: _meta_lock
        self._epoch_changes = 0  # guarded-by: _meta_lock
        # server-pushed params land here (reader thread) until the
        # puller consumes them via poll_pushed_params
        self._pushed: tuple[Any, int, int] | None = None  # guarded-by: _push_lock
        self._param_pushes_in = 0  # guarded-by: _push_lock
        # independent locks: a param pull blocking on the network (up to
        # the connect timeout) must not stall the actor threads' experience
        # sends — they use different sockets and share no state.
        # (_bytes_out and friends: payload bytes shipped vs their
        # uncompressed size, cumulative encode wall-ms, param blob
        # bytes pulled — the link-budget accounting)
        # same-host shm plane: the ring writer lives under _send_lock
        # with the socket it was negotiated with; the param reader is
        # assigned whole under _send_lock but READ lock-free in
        # get_params (GIL-atomic reference swap, the _bp_engaged idiom)
        # because the param path must never contend with sends
        self._shm_enabled = bool(shm)
        self._shm_slots = int(shm_slots)
        self._shm_slot_bytes = int(shm_slot_bytes)
        self._shm_boot_id = shm_transport.boot_id()  # test seam
        self._shm_ring: Any = None  # guarded-by: _send_lock
        self._shm_param_reader: Any = None
        self._shm_posts = 0  # guarded-by: _send_lock
        self._shm_fallbacks = 0  # guarded-by: _send_lock
        self._shm_bytes_out = 0  # guarded-by: _send_lock
        self._shm_param_reads = 0  # guarded-by: _param_lock
        self._shm_param_fallbacks = 0  # guarded-by: _param_lock
        self._send_lock = make_lock("transport._send_lock")
        self._param_lock = make_lock("transport._param_lock")
        self._meta_lock = make_lock("transport._meta_lock")
        self._push_lock = make_lock("transport._push_lock")
        self._codec_lock = make_lock("transport._codec_lock")

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self._addr, timeout=self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    @staticmethod
    def _classify_drop(exc: BaseException) -> str:
        """Per-reason drop accounting bucket for a send/connect failure.
        socket.timeout is TimeoutError is an OSError subclass — test
        the narrow classes before the broad one."""
        if isinstance(exc, ConnectionRefusedError):
            return "refused"
        if isinstance(exc, (ConnectionResetError, BrokenPipeError,
                            ConnectionAbortedError)):
            return "reset"
        if isinstance(exc, (socket.timeout, TimeoutError)):
            return "timeout"
        return "other"

    def _note_send_failure(self, exc: BaseException) -> str:
        """Record one failed send/connect on the experience path and
        arm the backoff window (caller holds _send_lock). Exponential
        with FULL jitter: a fleet of actors that lost the same learner
        decorrelates instead of reconnect-storming the restarted one.
        Returns the drop-reason bucket."""
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:  # apexlint: lossy(close of an already-dead socket)
                pass
            self._sock = None  # apexlint: unguarded(caller holds _send_lock)
        # shm rode this connection's grant: the server reclaims the
        # segments once it notices the disconnect, so detach now and
        # renegotiate on reconnect
        self._detach_shm()
        if self._disconnected_at is None:
            self._disconnected_at = time.monotonic()  # apexlint: unguarded(caller holds _send_lock)
        self._consec_fails += 1  # apexlint: unguarded(caller holds _send_lock)
        backoff = min(self._reconnect_cap_s,
                      self._reconnect_base_s
                      * (2 ** min(self._consec_fails - 1, 16)))
        self._backoff_until = (time.monotonic()  # apexlint: unguarded(caller holds _send_lock)
                               + backoff * (0.5 + 0.5 * random.random()))
        return self._classify_drop(exc)

    def _note_connected(self) -> None:
        """Reset the backoff after a successful (re)connect and sample
        the outage length into the recovery-latency instrument (caller
        holds _send_lock)."""
        self._consec_fails = 0  # apexlint: unguarded(caller holds _send_lock)
        self._backoff_until = 0.0  # apexlint: unguarded(caller holds _send_lock)
        if self._disconnected_at is not None:
            self._reconnect_latencies.append(
                time.monotonic() - self._disconnected_at)
            self._disconnected_at = None  # apexlint: unguarded(caller holds _send_lock)
            self._reconnects += 1  # apexlint: unguarded(caller holds _send_lock)

    def _note_epoch(self, ep: int) -> None:
        """Record the server epoch from an ack / versioned reply; an
        epoch CHANGE (new server incarnation) clears the pushed-params
        cell (it came from the dead incarnation) and warns — version
        counters may have restarted, so downstream updates must key on
        the epoch, not on version monotonicity. The serving tier's
        backpressure latch clears for the same reason: it was engaged
        by the DEAD incarnation's admission controller, and left set it
        would shed every send into the new incarnation forever — the
        new controller re-engages within one SLO window if its queue
        really is over the line."""
        with self._meta_lock:
            old = self._epoch
            self._epoch = ep
            changed = old != -1 and old != ep
            if changed:
                self._epoch_changes += 1
        if changed:
            with self._push_lock:
                self._pushed = None
            self._bp_engaged = False
            logging.getLogger(__name__).warning(
                "[fleet] learner epoch changed %d -> %d (restart or "
                "failover); params will re-converge to the new "
                "incarnation and any stale backpressure latch is "
                "released", old, ep)

    def _connect_experience(self) -> socket.socket:
        """Connect the experience socket and negotiate codec, telemetry
        and params-push. Sets self._negotiated; any failure mode (old
        server ignoring the hello, timeout, garbled ack) degrades to
        raw, never to an error — raw MSG_EXPERIENCE is universally
        understood."""
        sock = self._connect()
        # only send_experience/send_telemetry call this, under _send_lock
        self._negotiated = "raw"  # apexlint: unguarded(caller holds _send_lock)
        self._telemetry_ok = False  # apexlint: unguarded(caller holds _send_lock)
        self._push_ok = False  # apexlint: unguarded(caller holds _send_lock)
        self._param_codec_ok = False  # apexlint: unguarded(caller holds _send_lock)
        self._serve_ok = False  # apexlint: unguarded(caller holds _send_lock)
        # shm attachments belong to the PREVIOUS connection's grant —
        # the server retires those segments on our disconnect, so a
        # reconnect always renegotiates fresh ones
        self._detach_shm()
        probe = None
        if self._shm_enabled:
            try:
                probe, probe_token = shm_transport.make_probe()
            except (OSError, ValueError):  # apexlint: lossy(/dev/shm unavailable -> offer skipped, TCP as before)
                probe = None
        if (self._codec != "raw" or self._telemetry
                or self._params_push or self._serve_policy
                or probe is not None):
            # the hello now also fires with a raw codec when telemetry
            # is wanted — an old server still just ignores it
            try:
                offer: dict[str, Any] = {"codecs": [self._codec],
                                         "telemetry": self._telemetry}
                if self._params_push:
                    offer["params_push"] = True
                    if self._param_codec != "raw":
                        # coded pushes ride the same subscription; a
                        # server without this key's code ignores it
                        offer["param_codecs"] = [self._param_codec]
                if self._serve_policy:
                    offer["serve"] = {"policy": self._serve_policy,
                                      "class": self._serve_class}
                if probe is not None:
                    offer["shm"] = {"boot": self._shm_boot_id,
                                    "probe": probe.name,
                                    "token": probe_token,
                                    "slots": self._shm_slots,
                                    "slot_bytes": self._shm_slot_bytes}
                _send_msg(sock, MSG_HELLO, json.dumps(offer).encode())
                sock.settimeout(self._hello_timeout)
                msg = _recv_msg(sock)
                if msg is not None and msg[0] == MSG_HELLO_ACK:
                    ack = json.loads(bytes(msg[1]))
                    grant = ack.get("codec")
                    if grant in WIRE_CODECS:
                        self._negotiated = grant  # apexlint: unguarded(caller holds _send_lock)
                    if self._telemetry and bool(ack.get("telemetry")):
                        self._telemetry_ok = True  # apexlint: unguarded(caller holds _send_lock)
                    if self._params_push and bool(ack.get("params_push")):
                        self._push_ok = True  # apexlint: unguarded(caller holds _send_lock)
                    if (self._param_codec != "raw"
                            and ack.get("param_codec")
                            == self._param_codec):
                        self._param_codec_ok = True  # apexlint: unguarded(caller holds _send_lock)
                    if self._serve_policy and bool(ack.get("serve")):
                        self._serve_ok = True  # apexlint: unguarded(caller holds _send_lock)
                    ep = ack.get("epoch")
                    if isinstance(ep, int):
                        self._note_epoch(ep)
                    if probe is not None:
                        self._attach_shm_grant(ack.get("shm"))
            except (OSError, ValueError, AttributeError):
                pass  # apexlint: lossy(old server / timeout / garbage ack -> raw fallback)
            finally:
                sock.settimeout(self._timeout)
                if probe is not None:
                    # the probe's job ended with the ack; unlink FIRST
                    # (needs only the name — the filesystem entry is
                    # what leaks), then close the mapping: a close()
                    # failure (BufferError on a stray export) must not
                    # leave the name behind in /dev/shm
                    try:
                        probe.unlink()
                        probe.close()
                    except (OSError, BufferError):  # apexlint: lossy(probe already gone)
                        pass
        self._note_connected()
        if self._push_ok:
            # apexlint: detached(push reader dies with its socket; close() and reconnect both close it)
            threading.Thread(target=self._push_reader, args=(sock,),
                             name="params-push-reader",
                             daemon=True).start()
        return sock

    def _attach_shm_grant(self, grant: Any) -> None:
        """Attach the segments a hello ack granted (caller holds
        _send_lock). Attach failure of either segment degrades that
        plane to TCP — never to an error."""
        if not isinstance(grant, dict):
            return
        try:
            self._shm_ring = shm_transport.ShmRingWriter(  # apexlint: unguarded(caller holds _send_lock)
                str(grant.get("ring", "")))
        except (OSError, ValueError):  # apexlint: lossy(ring unattachable -> TCP experience, counted at first send)
            self._shm_ring = None  # apexlint: unguarded(caller holds _send_lock)
        params = grant.get("params")
        if params:
            try:
                self._shm_param_reader = shm_transport.ShmParamReader(
                    str(params))
            except (OSError, ValueError):  # apexlint: lossy(area unattachable -> TCP param pulls)
                self._shm_param_reader = None

    def _detach_shm(self) -> None:
        """Drop shm attachments (caller holds _send_lock). Detach
        only — the segments are server-owned; it unlinks them when it
        notices our disconnect."""
        ring, self._shm_ring = self._shm_ring, None  # apexlint: unguarded(caller holds _send_lock)
        if ring is not None:
            ring.close()
        reader, self._shm_param_reader = self._shm_param_reader, None
        if reader is not None:
            reader.close()

    def _push_reader(self, sock: socket.socket) -> None:
        """Reader for server-initiated MSG_PARAMS_PUSH frames on the
        experience socket; one thread per negotiated connection, exits
        when that socket dies (the next reconnect spawns a fresh one).
        Waits on select so an idle socket never trips the IO timeout
        mid-frame; once bytes are available, a timeout inside the frame
        read means a wedged sender and drops the connection."""
        import select
        while True:
            try:
                ready, _, _ = select.select([sock], [], [], 0.25)
                if not ready:
                    if sock.fileno() < 0:
                        return
                    continue
                msg = _recv_msg(sock)
            except (OSError, ValueError):  # apexlint: lossy(push reader exits; reconnect respawns it)
                return
            if msg is None:
                return
            if msg[0] != MSG_PARAMS_PUSH:
                continue  # unexpected control traffic: ignore
            parsed = self._parse_params_payload(msg[1])
            if parsed is None:
                continue
            status, params, version, ep = parsed
            if ep is None:
                continue  # push frames are always versioned
            self._note_epoch(ep)
            if status == "resync":
                # a pushed delta's base is not what we hold (e.g. a
                # pull advanced the chain past the push channel's
                # last-sent): clear the held version so the next pull
                # asks baseless and comes back full
                self._note_param_resync()
                continue
            if params is not None:
                with self._push_lock:
                    self._pushed = (params, version, ep)
                    self._param_pushes_in += 1
            # the poll path now knows this (epoch, version) is in hand,
            # so its next conditional pull is a header-sized round-trip
            with self._param_lock:
                self._param_epoch = ep
                self._param_version = version

    def _note_param_resync(self) -> None:
        """A coded payload's base was not what the chain held: count
        it, drop the chain, and clear the held version so the next
        request states no base and the server answers full."""
        with self._codec_lock:
            self._param_decoder.reset()
        with self._param_lock:
            self._param_resyncs += 1
            self._param_version = -1

    def poll_pushed_params(self) -> tuple[Any, int]:
        """Consume the latest server-pushed params, if any arrived
        since the last call: (params, version), or (None, -1). Never
        blocks; safe alongside get_params polling (the push cell is
        epoch-cleared on incarnation change)."""
        with self._push_lock:
            cell, self._pushed = self._pushed, None
        if cell is None:
            return None, -1
        return cell[0], cell[1]

    def _parse_params_payload(self, payload) -> \
            tuple[str, Any, int, int | None] | None:
        """Parse a MSG_PARAMS / MSG_PARAMS_PUSH payload of any shape:
        ("unchanged"|"full"|"resync", params, version, epoch|None), or
        None when the blob is undecodable. The first bytes name the
        shape unambiguously: a coded payload leads with
        PARAMS_CODEC_MAGIC, a versioned reply with PARAMS_HDR_MAGIC,
        and a legacy raw pickle with neither (pickle streams start with
        the 0x80 opcode). "resync" means a coded payload's base is not
        what this decoder holds — the caller clears its held version
        and re-pulls; params is None."""
        if len(payload) >= 4:
            sniff = struct.unpack_from("<I", payload)[0]
            if sniff == PARAMS_CODEC_MAGIC:
                return self._parse_coded_payload(payload)
        if len(payload) >= _PARAMS_HDR.size:
            magic, ep, ver = _PARAMS_HDR.unpack_from(payload)
            if magic == PARAMS_HDR_MAGIC:
                if len(payload) == _PARAMS_HDR.size:
                    return "unchanged", None, ver, ep
                try:
                    params, version = pickle.loads(
                        memoryview(payload)[_PARAMS_HDR.size:])
                except Exception as e:
                    self._warn_bad_blob(e)
                    return None
                tree = _upcast_bf16(params)
                if self._param_codec != "raw":
                    # seed the delta chain from this raw-path full, so
                    # a client bootstrapped over APXV (never-inflate
                    # degradation, mixed negotiation) rides deltas
                    # afterwards
                    with self._codec_lock:
                        self._param_decoder.note_full(tree, version, ep)
                return "full", tree, version, ep
        try:
            params, version = pickle.loads(payload)
        except Exception as e:
            self._warn_bad_blob(e)
            return None
        return "full", _upcast_bf16(params), version, None

    def _parse_coded_payload(self, payload) -> \
            tuple[str, Any, int, int | None] | None:
        """Apply one coded (PARAMS_CODEC_MAGIC) payload through the
        chain decoder. A malformed payload warns like a bad blob and
        returns None; a base mismatch surfaces as "resync"."""
        try:
            with self._codec_lock:
                status, tree, ver, ep = self._param_decoder.apply(
                    payload)
        except Exception as e:
            self._warn_bad_blob(e)
            return None
        return status, tree, ver, ep

    @staticmethod
    def _warn_bad_blob(e: BaseException) -> None:
        # an undecodable blob usually means wire-format skew (e.g. a
        # learner host on a newer build): swallowing it silently would
        # leave the actor on stale params forever with a
        # healthy-looking connection — log once per process
        global _WARNED_BAD_BLOB
        if not _WARNED_BAD_BLOB:
            _WARNED_BAD_BLOB = True
            logging.getLogger(__name__).warning(
                "param blob undecodable (%r) — version skew between "
                "actor and learner hosts? Actor continues on its "
                "current params.", e)

    def send_experience(self, batch: dict) -> None:
        # encode under the send lock: the payload's codec must match
        # THIS connection's negotiation, which a mid-call reconnect can
        # change (it re-encodes in that case — reconnects are rare)
        with self._send_lock:
            # backoff gate: inside a backoff window the batch drops
            # WITHOUT touching the network — hammering a dead learner
            # from every actor thread at full send rate is how
            # reconnect storms start. The serving tier's backpressure
            # latch drops through the same accounted path: an over-SLO
            # learner asked this host to stop deepening the queue.
            if self._bp_engaged or (self._sock is None
                                    and time.monotonic()
                                    < self._backoff_until):
                self._dropped += 1
                self._drop_reasons["backpressure"] += 1
                return
            payload: bytes | None = None
            payload_codec: str | None = None
            reason = "other"
            for _ in range(2):  # current socket, then one reconnect
                try:
                    if self._sock is None:
                        self._sock = self._connect_experience()
                    ring = self._shm_ring
                    if ring is not None:
                        # same-host fast path: pack straight into a
                        # ring slot (the one copy — no codec, no
                        # sendall of the body) and ring the doorbell
                        # on this socket. A full ring or oversize
                        # batch falls through to TCP for THIS batch
                        # only, counted.
                        t0 = time.perf_counter()
                        post = ring.post(batch)
                        self._encode_ms += (time.perf_counter()
                                            - t0) * 1e3
                        if post is not None:
                            db = _DOORBELL.pack(*post)
                            try:
                                _send_msg(self._sock, MSG_SHM_DOORBELL,
                                          db)
                            except OSError:
                                # the doorbell never left: un-claim the
                                # slot before the reconnect path drops
                                # the whole ring attachment
                                ring.release(post[0])
                                raise
                            self._shm_posts += 1
                            # shm bytes stay OUT of the raw/wire codec
                            # ratio — only the doorbell touched TCP
                            self._shm_bytes_out += post[2]
                            self._bytes_out += len(db)
                            return
                        self._shm_fallbacks += 1
                    codec = self._negotiated
                    if payload is None or payload_codec != codec:
                        t0 = time.perf_counter()
                        payload = encode_batch(batch, codec)
                        self._encode_ms += (time.perf_counter() - t0) * 1e3
                        payload_codec = codec
                    mtype = MSG_EXPERIENCE_C if codec != "raw" \
                        else MSG_EXPERIENCE
                    _send_msg(self._sock, mtype, payload)
                    self._bytes_out += len(payload)
                    self._raw_bytes_out += sum(
                        v.nbytes for v in batch.values()
                        if isinstance(v, np.ndarray))
                    return
                except OSError as e:
                    reason = self._note_send_failure(e)
            self._dropped += 1
            self._drop_reasons[reason] += 1

    def set_backpressure(self, engaged: bool) -> None:
        """Engage/release the serving-tier backpressure latch: while
        engaged, send_experience drops host-side under the existing
        accounted "backpressure" reason instead of pushing more load
        at an over-SLO learner. Called by the admission controller's
        on_backpressure hook; thread-safe (plain bool flip)."""
        self._bp_engaged = bool(engaged)

    @property
    def backpressure_engaged(self) -> bool:
        """Current state of the serving-tier backpressure latch (read
        by the remediation plane's stale-controller watchdog and the
        chaos bench's remediated arm)."""
        return self._bp_engaged

    def kick(self) -> bool:
        """Remediation actuator: collapse the pending reconnect
        backoff so the NEXT send retries immediately, for a supervisor
        that has verified the learner is reachable again while this
        sender still sits out a backoff window armed during the
        outage. A driver-side slot restart gets this for free (a fresh
        transport has no backoff state); kick() is the same remedy
        without discarding the connection's negotiated codec and
        accounting. The backoff POLICY is untouched — the next failure
        re-arms it at the same escalation point. Returns False when no
        backoff was pending (outcome "skipped" in the remediation
        plane's attribution)."""
        with self._send_lock:
            if self._sock is not None \
                    or time.monotonic() >= self._backoff_until:
                return False
            self._backoff_until = 0.0  # apexlint: unguarded(holds _send_lock)
            return True

    def send_telemetry(self, frame: dict) -> bool:
        """Best-effort ship of one obs snapshot frame (MSG_TELEMETRY,
        JSON). Returns False — never raises into the pump thread — when
        the server did not grant telemetry (old build), the connection
        is down or backing off, or the send fails; the caller simply
        tries again at its next cadence."""
        with self._send_lock:
            if self._sock is None \
                    and time.monotonic() < self._backoff_until:
                return False  # backoff window: don't probe the learner
            try:
                if self._sock is None:
                    self._sock = self._connect_experience()
                if not self._telemetry_ok:
                    return False
                payload = json.dumps(frame).encode()
                _send_msg(self._sock, MSG_TELEMETRY, payload)
                self._telemetry_frames_out += 1
                self._telemetry_bytes_out += len(payload)
                return True
            except OSError as e:
                self._note_send_failure(e)
                return False

    def recv_experience(self, timeout: float | None = None) -> dict | None:
        raise RuntimeError("actor-side transport cannot receive experience")

    def publish_params(self, params: Any, version: int) -> None:
        raise RuntimeError("actor-side transport cannot publish params")

    def get_params(self) -> tuple[Any, int]:
        """Pull params, CONDITIONALLY when the server is epoch-aware:
        the request states the (epoch, version) already in hand, and an
        up-to-date puller gets back a header-sized "unchanged" reply —
        (None, current_version) — instead of megabytes of weights. An
        old server ignores the request payload and replies the legacy
        raw pickle, which parses through the same path (epoch stays
        unknown, every pull ships the full blob). Any failure returns
        (None, -1) and bumps param_pull_errors; it never raises into
        the puller thread.

        With an shm grant on the current connection, the pull is a
        LOCAL seqlock read of the server's param area — no socket, no
        per-client blob; torn/oversize/unpublished reads fall back to
        the TCP pull below, which is always correct."""
        reader = self._shm_param_reader
        if reader is not None:
            got = self._shm_get_params(reader)
            if got is not None:
                return got
        # two attempts: a "resync" reply (the server's delta chain no
        # longer reaches our base) clears the held version and retries
        # immediately — the second request states no base and comes
        # back full, so one poll cadence never leaves the actor a
        # version behind over a routine window overrun
        for attempt in (0, 1):
            with self._param_lock:
                req_obj: dict[str, Any] = {"v": self._param_version,
                                           "epoch": self._param_epoch}
                if self._param_codec != "raw":
                    # the pull channel's codec ask; absent under
                    # param_codec="raw" so the request bytes match the
                    # pre-codec build exactly
                    req_obj["codec"] = self._param_codec
                req = json.dumps(req_obj).encode()
                try:
                    if self._param_sock is None:
                        self._param_sock = self._connect()
                    _send_msg(self._param_sock, MSG_PARAMS_REQ, req)
                    msg = _recv_msg(self._param_sock)
                    # a corrupt/misframed reply (ValueError from
                    # _recv_msg, or an unexpected type) is treated like
                    # a dead connection: reset the socket and report no
                    # params — the caller polls again. It must never
                    # escape into the param-puller thread.
                    if msg is not None and msg[0] != MSG_PARAMS:
                        raise ValueError(
                            f"unexpected reply type {msg[0]}")
                except (OSError, ValueError):
                    msg = None  # apexlint: lossy(counted as param_pull_errors just below)
                if msg is None:
                    self._param_pull_errors += 1
                    if self._param_sock is not None:
                        try:
                            self._param_sock.close()
                        except OSError:  # apexlint: lossy(close of an already-dead socket)
                            pass
                    self._param_sock = None
                    return None, -1
                self._bytes_in += len(msg[1])
            # the blob decode deliberately runs outside _param_lock (it
            # can be hundreds of ms for a big tree); re-take the lock
            # only for the state updates
            parsed = self._parse_params_payload(msg[1])
            if parsed is None:
                with self._param_lock:
                    self._param_pull_errors += 1
                return None, -1
            status, params, version, ep = parsed
            if ep is not None:
                self._note_epoch(ep)
            if status == "resync":
                self._note_param_resync()
                if attempt == 0:
                    continue
                return None, -1
            with self._param_lock:
                if ep is not None:
                    self._param_epoch = ep
                    self._param_version = version
                if status == "unchanged":
                    self._param_unchanged += 1
            if status == "unchanged":
                return None, version
            return params, version
        return None, -1  # unreachable: the loop returns on attempt 1

    def _shm_get_params(self, reader: Any) -> tuple[Any, int] | None:
        """One attempt at a seqlock param read: (params, version) /
        (None, version) for "unchanged", or None meaning 'use the TCP
        pull' (nothing published to the area yet, blob oversize, torn
        reads exhausted, or an undecodable blob)."""
        with self._param_lock:
            have = (self._param_epoch, self._param_version)
        try:
            res = reader.read(*have)
        except (OSError, ValueError):  # apexlint: lossy(counted as shm_param_fallbacks below)
            res = None
        if res is None or res[0] in ("empty", "oversize"):
            with self._param_lock:
                self._shm_param_fallbacks += 1
            return None
        status, blob, ep, version = res
        self._note_epoch(ep)
        if status == "unchanged":
            with self._param_lock:
                self._param_unchanged += 1
                self._shm_param_reads += 1
            return None, version
        try:
            params, _ = pickle.loads(blob)
        except Exception as e:
            self._warn_bad_blob(e)
            with self._param_lock:
                self._shm_param_fallbacks += 1
            return None
        with self._param_lock:
            self._param_epoch = ep
            self._param_version = version
            self._shm_param_reads += 1
        return _upcast_bf16(params), version

    @property
    def dropped(self) -> int:
        return self._dropped

    @property
    def drop_reasons(self) -> dict[str, int]:
        """Per-reason breakdown of dropped experience batches:
        refused / reset / timeout / backpressure (dropped inside a
        backoff window without touching the network) / other. Sums to
        `dropped` for drops on the experience path."""
        with self._send_lock:
            return dict(self._drop_reasons)

    @property
    def reconnects(self) -> int:
        """Successful experience-socket reconnects after an outage."""
        with self._send_lock:
            return self._reconnects

    @property
    def reconnect_latencies(self) -> list[float]:
        """Outage lengths (seconds, first failure -> reconnect) for the
        last _RECONNECT_SAMPLES recoveries — the chaos lane's
        recovery-latency instrument."""
        with self._send_lock:
            return list(self._reconnect_latencies)

    @property
    def epoch(self) -> int:
        """Server membership epoch last seen (-1 before any epoch-aware
        exchange, e.g. against a pre-epoch server)."""
        with self._meta_lock:
            return self._epoch

    @property
    def epoch_changes(self) -> int:
        """Times the server's epoch CHANGED under us (learner restart
        or failover observed by this transport)."""
        with self._meta_lock:
            return self._epoch_changes

    @property
    def param_epoch(self) -> int:
        """Epoch the currently-held params came from (-1 when unknown;
        pullers key force-updates on changes of this, since a new
        incarnation's version counter may restart below the old one)."""
        with self._param_lock:
            return self._param_epoch

    @property
    def param_pull_errors(self) -> int:
        """get_params failures (connect/IO/decode) survived without
        raising into the puller thread."""
        with self._param_lock:
            return self._param_pull_errors

    @property
    def param_unchanged(self) -> int:
        """Conditional pulls answered with a header-only "unchanged"
        reply (bytes the versioned param path saved shipping)."""
        with self._param_lock:
            return self._param_unchanged

    @property
    def param_resyncs(self) -> int:
        """Coded param payloads whose delta base this client no longer
        held (server chain window overrun, epoch bump) — each one
        dropped the chain and re-pulled a full."""
        with self._param_lock:
            return self._param_resyncs

    @property
    def param_codec_negotiated(self) -> bool:
        """True iff the current connection's hello/ack granted the
        param codec on the PUSH channel (pulls negotiate per request
        and need no latch; False against an old server or under
        param_codec="raw")."""
        return self._param_codec_ok

    @property
    def params_push_negotiated(self) -> bool:
        """True iff the current connection's hello/ack granted
        server-initiated param publication."""
        return self._push_ok

    @property
    def param_pushes_in(self) -> int:
        """MSG_PARAMS_PUSH frames received from the learner."""
        with self._push_lock:
            return self._param_pushes_in

    @property
    def bytes_out(self) -> int:
        """Experience payload bytes shipped to the learner host."""
        return self._bytes_out

    @property
    def raw_bytes_out(self) -> int:
        """Uncompressed array bytes of everything shipped — the
        numerator of wire_compression_ratio."""
        return self._raw_bytes_out

    @property
    def wire_compression_ratio(self) -> float:
        """raw/wire ratio over all experience shipped (1.0 = no
        savings; larger is better). 0.0 before any traffic."""
        return (self._raw_bytes_out / self._bytes_out
                if self._bytes_out else 0.0)

    @property
    def negotiated_codec(self) -> str:
        """Codec agreed with the current learner connection ("raw"
        until a hello/ack has succeeded)."""
        return self._negotiated

    @property
    def shm_negotiated(self) -> bool:
        """True while the current connection holds an shm experience
        ring grant (False cross-host, against an old server, or after
        any connection failure until the reconnect renegotiates)."""
        return self._shm_ring is not None

    @property
    def shm_posts(self) -> int:
        """Experience batches shipped through shm ring slots."""
        with self._send_lock:
            return self._shm_posts

    @property
    def shm_fallbacks(self) -> int:
        """Batches that degraded to TCP despite a live shm grant
        (ring full or batch outsized a slot)."""
        with self._send_lock:
            return self._shm_fallbacks

    @property
    def shm_bytes_out(self) -> int:
        """Experience payload bytes that crossed via shm slots."""
        with self._send_lock:
            return self._shm_bytes_out

    @property
    def shm_param_reads(self) -> int:
        """Param pulls satisfied by the seqlock area (incl. header-
        only "unchanged" reads) — pulls that cost zero socket bytes."""
        with self._param_lock:
            return self._shm_param_reads

    @property
    def shm_param_fallbacks(self) -> int:
        """Param pulls that fell back to TCP with a reader attached
        (area unpublished/oversize, torn reads exhausted, bad blob)."""
        with self._param_lock:
            return self._shm_param_fallbacks

    @property
    def serve_negotiated(self) -> bool:
        """True when the server acknowledged this host's serving-tier
        tenant tag on the current connection (False against an old
        server or before the first send connects)."""
        with self._send_lock:
            return self._serve_ok

    @property
    def telemetry_negotiated(self) -> bool:
        """True iff the current connection's hello/ack granted the
        telemetry capability (always False against an old server)."""
        return self._telemetry_ok

    @property
    def telemetry_frames_out(self) -> int:
        """MSG_TELEMETRY frames shipped to the learner host."""
        return self._telemetry_frames_out

    @property
    def telemetry_bytes_out(self) -> int:
        """Telemetry payload bytes shipped (control-plane budget)."""
        return self._telemetry_bytes_out

    @property
    def encode_ms(self) -> float:
        """Cumulative wall-ms spent encoding experience payloads."""
        return self._encode_ms

    @property
    def bytes_in(self) -> int:
        """Param blob bytes pulled from the learner host."""
        return self._bytes_in

    @property
    def pending(self) -> int:
        return 0

    def close(self) -> None:
        with self._send_lock, self._param_lock:
            self._detach_shm()
            for s in (self._sock, self._param_sock):
                if s is not None:
                    try:
                        s.close()
                    except OSError:  # apexlint: lossy(close best effort)
                        pass
            self._sock = self._param_sock = None
