"""Disk-spill rung under the host-RAM cold store.

A pinned copy of ``ape_x_dqn_tpu/replay/disk_store.py``: its code is
the original's but for the import paths (tests/test_torch_isolation.py).

The ColdStore (replay/cold_store.py) turns replay retention into a
host-RAM knob; this module turns it into a DISK-provisioning knob.
When the RAM store's admission door would drop a candidate segment or
displace a stored one, the loser spills here instead of vanishing:
ColdStore hands the already-compressed segment to `DiskStore.offer`,
which enqueues it on a bounded queue serviced by a single writeback
thread. The ingest thread NEVER blocks on disk — a full queue counts
(`queue_full`) and drops, it does not wait; zero ship-path blocking is
structural, not tuned.

On-disk format: append-only segment files `segments-<id:08d>.cold`,
each a concatenation of records

    [52-byte header][cold_pack payload]

with header `<4sIIddQQII` = magic b"APXD", units u32, live u32,
mass_sum f64, mass_max f64, seq u64, raw_bytes u64, payload_len u32,
crc32(payload) u32. Files roll at `file_bytes`. The index is in RAM
only: an ascending bisect list of (mass_sum, seq) -> (file_id, offset,
length, crc) mirroring ColdStore's key discipline, plus a per-file
summary (live bytes, dead bytes, max live mass) that drives both
compaction and the mass_max readback skip.

Readback (`promote`): pops the HEAVIEST index entries whose mass beats
the RAM store's current displacement floor, groups reads by file, and
skips whole files whose recorded max live mass is at or below the
floor — the consumer of ColdSegment.mass_max. Payloads are CRC-checked on read; a mismatch is counted
and skipped, never returned.

Compaction: when a sealed file's dead fraction exceeds
`compact_frac`, the writeback thread rewrites its live records into
the active file (updating the index under the lock) and unlinks it.

Crash safety: the index is rebuilt at open by scanning record headers
sequentially. A torn tail (short header, short payload, bad magic) is
TRUNCATED at the last whole record — an fsync-less append can only
tear at the end. A CRC mismatch with intact framing (bit rot) is
skipped with an attributed error and the scan continues past it.
Appends after recovery always start a FRESH file so a truncated tail
is never extended through a stale buffered handle.

Threading: `offer` is called from the ingest thread (via ColdStore's
spill hook); `promote`/`stats`/`displacement_floor` from the ingest
thread's idle tick; the writeback/compaction work runs on the daemon
thread. `_lock` guards the index + per-file summaries + counters;
file appends happen outside the lock (single writer thread), index
mutations inside it.
"""

from __future__ import annotations

import bisect
import logging
import os
import queue
import struct
import threading
import time
import zlib

from ape_x_dqn_tpu_torch.replay.cold_store import ColdSegment

log = logging.getLogger(__name__)

_MAGIC = b"APXD"
# magic, units, live, mass_sum, mass_max, seq, raw_bytes, payload_len, crc
_HEADER = struct.Struct("<4sIIddQQII")
HEADER_BYTES = _HEADER.size  # 52


class _FileInfo:
    """Per-segment-file summary driving compaction + readback skip."""

    __slots__ = ("live_bytes", "dead_bytes", "records", "mass_max")

    def __init__(self) -> None:
        self.live_bytes = 0   # bytes of records still in the index
        self.dead_bytes = 0   # bytes of promoted/displaced/rotten records
        self.records = 0      # live record count
        self.mass_max = 0.0   # max mass_sum over LIVE records (monotone
        #                       upper bound: not lowered on removal, so
        #                       the readback skip is conservative-safe)


class _IndexEntry:
    __slots__ = ("mass_sum", "seq", "file_id", "offset", "length",
                 "units", "live", "raw_bytes", "mass_max", "crc")

    def __init__(self, mass_sum: float, seq: int, file_id: int,
                 offset: int, length: int, units: int, live: int,
                 raw_bytes: int, mass_max: float, crc: int):
        self.mass_sum = mass_sum
        self.seq = seq              # disk-local admission order (tiebreak)
        self.file_id = file_id
        self.offset = offset        # payload offset (past the header)
        self.length = length        # payload length
        self.units = units
        self.live = live
        self.raw_bytes = raw_bytes
        self.mass_max = mass_max
        self.crc = crc

    def key(self) -> tuple[float, int]:
        return (self.mass_sum, self.seq)

    def record_bytes(self) -> int:
        return HEADER_BYTES + self.length


class DiskStore:
    """Append-only segment-file spill store, mass-ordered like ColdStore.

    capacity_transitions bounds live transitions on disk; the disk door
    mirrors the RAM door (displace strictly lighter, else drop), so the
    heaviest retained transitions across RAM+disk survive end-to-end.
    """

    def __init__(self, directory: str, capacity_transitions: int,
                 queue_depth: int = 16,
                 file_bytes: int = 64 * 1024 * 1024,
                 compact_frac: float = 0.5):
        self.dir = str(directory)
        self.capacity = int(capacity_transitions)
        self.file_bytes = int(file_bytes)
        self.compact_frac = float(compact_frac)
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.Lock()
        # ascending (mass_sum, seq), mirroring ColdStore._keys
        self._entries: list[_IndexEntry] = []
        self._keys: list[tuple[float, int]] = []
        self._files: dict[int, _FileInfo] = {}
        self._seq = 0               # next disk-local record seq
        self._next_file_id = 0
        self._active_id = -1
        self._active_fh = None
        self._active_size = 0
        # counters (mutated under _lock once the thread runs; stats()
        # snapshots them)
        self.transitions = 0
        self.bytes_stored = 0       # live header+payload bytes indexed
        self.spilled = 0            # segments accepted off the queue
        self.promoted = 0           # segments handed back via promote()
        self.dropped = 0            # disk-door drops (lighter than floor)
        self.queue_full = 0         # offer() rejections — never waited on
        self.io_errors = 0          # IO OSErrors (segment lost/file kept)
        self.corrupt_segments = 0   # CRC/framing rejects (recovery + read)
        self.compactions = 0
        self._recover()
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, queue_depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._writeback_loop, name="cold-disk-writeback",
            daemon=True)
        self._thread.start()

    # -- ingest-thread API -------------------------------------------------

    def offer(self, seg: ColdSegment) -> bool:
        """Enqueue a segment for async writeback. NEVER blocks: a full
        queue counts queue_full and returns False (the segment is lost,
        exactly as it would have been without a disk tier)."""
        try:
            self._queue.put_nowait(seg)
            return True
        except queue.Full:
            with self._lock:
                self.queue_full += 1
            return False

    def promote(self, k: int, floor: float = 0.0) -> list[ColdSegment]:
        """Pop up to k of the heaviest disk segments with mass_sum >
        floor (the RAM store's displacement floor — promoting anything
        lighter would bounce off the RAM door and ping-pong).

        Readback is FILE-granular (the batched mass-ordered path):
        files are visited by descending per-file mass bound, and a file
        whose recorded max segment mass is at or below the floor is
        skipped without touching its entries or the disk — the
        reader of the recorded ColdSegment.mass_max. The
        bound is monotone (not lowered on removal), so a visit that
        finds nothing above the floor tightens it to the true max and
        the next tick skips the file outright. Within a file the
        heaviest segments pop first; CRC mismatches are counted,
        attributed, and skipped."""
        picked: list[_IndexEntry] = []
        with self._lock:
            order = sorted(self._files.items(),
                           key=lambda kv: -kv[1].mass_max)
            for file_id, fi in order:
                if len(picked) >= int(k):
                    break
                if fi.records <= 0 or fi.mass_max <= floor:
                    continue        # file-granular skip: bound says no
                                    # live segment can clear the door
                mine = [e for e in self._entries
                        if e.file_id == file_id and e.mass_sum > floor]
                if not mine:
                    # stale bound (heaviest record already left):
                    # tighten to the true max so the skip fires next
                    fi.mass_max = max(
                        (e.mass_sum for e in self._entries
                         if e.file_id == file_id), default=0.0)
                    continue
                mine.sort(key=lambda e: (-e.mass_sum, -e.seq))
                take = mine[:int(k) - len(picked)]
                gone = {id(e) for e in take}
                self._entries = [e for e in self._entries
                                 if id(e) not in gone]
                self._keys = [e.key() for e in self._entries]
                for e in take:
                    self._remove_accounting(e)
                picked.extend(take)
        out: list[ColdSegment] = []
        by_file: dict[int, list[_IndexEntry]] = {}
        for e in picked:
            by_file.setdefault(e.file_id, []).append(e)
        for file_id, entries in by_file.items():
            entries.sort(key=lambda e: e.offset)
            path = self._path(file_id)
            try:
                with open(path, "rb") as fh:
                    for e in entries:
                        fh.seek(e.offset)
                        payload = fh.read(e.length)
                        if (len(payload) != e.length
                                or zlib.crc32(payload) != e.crc):
                            with self._lock:
                                self.corrupt_segments += 1
                            log.error(
                                "cold disk: CRC/length mismatch reading "
                                "seq=%d from %s offset=%d — segment "
                                "dropped", e.seq, path, e.offset)
                            continue
                        out.append(ColdSegment(
                            payload, e.units, e.live, e.raw_bytes,
                            e.mass_sum, e.mass_max, e.seq))
            except OSError as err:
                with self._lock:
                    self.io_errors += 1
                log.error("cold disk: read failed on %s: %s — %d "
                          "segments dropped", path, err, len(entries))
        # reads batch in file/offset order for IO locality; the caller
        # contract is still heaviest-first (mirror of ColdStore.recall)
        out.sort(key=lambda s: (-s.mass_sum, -s.seq))
        with self._lock:
            self.promoted += len(out)
        return out

    def displacement_floor(self) -> float:
        """Lightest indexed mass when at capacity, else 0.0 (mirror of
        ColdStore's door: below this, a spill would be dropped)."""
        with self._lock:
            if self.transitions < self.capacity or not self._entries:
                return 0.0
            return self._entries[0].mass_sum

    def stats(self) -> dict:
        with self._lock:
            return {
                "segments": len(self._entries),
                "transitions": self.transitions,
                "bytes": self.bytes_stored,
                "files": len(self._files),
                "spilled": self.spilled,
                "promoted": self.promoted,
                "dropped": self.dropped,
                "queue_full": self.queue_full,
                "io_errors": self.io_errors,
                "corrupt_segments": self.corrupt_segments,
                "compactions": self.compactions,
            }

    def drain(self, timeout: float = 10.0) -> None:
        """Block until queued segments are durably indexed
        (tests/shutdown only — never called from the ship path)."""
        deadline = time.monotonic() + timeout
        done = threading.Event()
        try:
            self._queue.put(done, timeout=timeout)
        except queue.Full as err:
            raise TimeoutError(
                "disk writeback queue did not accept the drain "
                "handshake") from err
        if not done.wait(max(0.0, deadline - time.monotonic())):
            raise TimeoutError("disk writeback thread did not drain")

    def close(self) -> None:
        self._stop.set()
        try:
            self._queue.put_nowait(None)   # wake the thread promptly
        except queue.Full:
            pass                           # 0.1s get-timeout wakes it
        self._thread.join(timeout=10.0)
        if self._active_fh is not None:
            try:
                self._active_fh.close()
            except OSError:  # apexlint: lossy(handle close at shutdown)
                pass
            self._active_fh = None

    # -- writeback thread --------------------------------------------------

    def _writeback_loop(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                continue                    # close() wake-up token
            if isinstance(item, threading.Event):
                item.set()                  # drain() handshake: every
                continue                    # earlier segment is indexed
            self._write_one(item)
            self._maybe_compact()

    def _write_one(self, seg: ColdSegment) -> None:
        # disk door (mirrors ColdStore.put): displace strictly lighter
        # indexed segments, else drop the candidate
        with self._lock:
            freed = 0
            victims = 0
            while (self.transitions + seg.live - freed > self.capacity
                   and victims < len(self._entries)
                   and self._keys[victims][0] < seg.mass_sum):
                freed += self._entries[victims].live
                victims += 1
            if self.transitions + seg.live - freed > self.capacity:
                self.dropped += 1
                return
            for e in self._entries[:victims]:
                self._remove_accounting(e)
            del self._entries[:victims], self._keys[:victims]
            disk_seq = self._seq
            self._seq += 1
        try:
            file_id, offset = self._append_record(seg, disk_seq)
        except OSError as err:
            with self._lock:
                self.io_errors += 1
            log.error("cold disk: writeback append failed (%s) — "
                      "segment seq=%d lost", err, disk_seq)
            return
        with self._lock:
            self._insert(_IndexEntry(
                seg.mass_sum, disk_seq, file_id, offset,
                len(seg.payload), seg.units, seg.live, seg.raw_bytes,
                seg.mass_max, zlib.crc32(seg.payload)))
            self.spilled += 1

    def _append_record(self, seg: ColdSegment,
                       disk_seq: int) -> tuple[int, int]:
        """Append one record to the active file -> (file_id, payload
        offset). Writeback thread only; raises OSError to the caller."""
        if (self._active_fh is None
                or self._active_size >= self.file_bytes):
            self._roll_file()
        header = _HEADER.pack(
            _MAGIC, seg.units, seg.live, seg.mass_sum, seg.mass_max,
            disk_seq, seg.raw_bytes, len(seg.payload),
            zlib.crc32(seg.payload))
        offset = self._active_size + HEADER_BYTES
        self._active_fh.write(header)
        self._active_fh.write(seg.payload)
        self._active_fh.flush()
        self._active_size += HEADER_BYTES + len(seg.payload)
        return self._active_id, offset

    def _roll_file(self) -> None:
        if self._active_fh is not None:
            self._active_fh.close()
            self._active_fh = None
        new_id = self._next_file_id
        self._next_file_id += 1
        self._active_fh = open(self._path(new_id), "wb")
        self._active_id = new_id
        self._active_size = 0
        with self._lock:
            self._files.setdefault(new_id, _FileInfo())

    # -- compaction --------------------------------------------------------

    def _maybe_compact(self) -> None:
        with self._lock:
            target = None
            for file_id, fi in self._files.items():
                if file_id == self._active_id:
                    continue
                total = fi.live_bytes + fi.dead_bytes
                if total > 0 and fi.dead_bytes / total > self.compact_frac:
                    target = file_id
                    break
                if total <= 0 and fi.records == 0:
                    target = file_id     # empty sealed file: just unlink
                    break
            if target is None:
                return
            moved = [e for e in self._entries if e.file_id == target]
        path = self._path(target)
        rewritten: list[tuple[_IndexEntry, bytes]] = []
        if moved:
            try:
                with open(path, "rb") as fh:
                    for e in sorted(moved, key=lambda e: e.offset):
                        fh.seek(e.offset)
                        payload = fh.read(e.length)
                        if (len(payload) != e.length
                                or zlib.crc32(payload) != e.crc):
                            with self._lock:
                                self.corrupt_segments += 1
                            log.error(
                                "cold disk: CRC mismatch compacting "
                                "seq=%d from %s — record dropped",
                                e.seq, path)
                            continue
                        rewritten.append((e, payload))
            except OSError as err:
                with self._lock:
                    self.io_errors += 1
                log.error("cold disk: compaction read failed on %s: %s "
                          "— file kept", path, err)
                return
        for e, payload in rewritten:
            seg = ColdSegment(payload, e.units, e.live, e.raw_bytes,
                              e.mass_sum, e.mass_max, e.seq)
            try:
                file_id, offset = self._append_record(seg, e.seq)
            except OSError as err:
                with self._lock:
                    self.io_errors += 1
                log.error("cold disk: compaction append failed (%s) — "
                          "aborting compaction of %s", err, path)
                return
            with self._lock:
                if not any(x is e for x in self._entries):
                    continue    # promoted mid-compaction: stale copy
                old_fi = self._files.get(e.file_id)
                if old_fi is not None:
                    old_fi.live_bytes -= e.record_bytes()
                    old_fi.dead_bytes += e.record_bytes()
                    old_fi.records -= 1
                e.file_id = file_id
                e.offset = offset
                fi = self._files[file_id]
                fi.live_bytes += e.record_bytes()
                fi.records += 1
                fi.mass_max = max(fi.mass_max, e.mass_sum)
        with self._lock:
            if any(e.file_id == target for e in self._entries):
                return              # some records still live there
            self._files.pop(target, None)
            self.compactions += 1
        try:
            os.unlink(path)
        except OSError as err:
            with self._lock:
                self.io_errors += 1
            log.error("cold disk: unlink failed on %s: %s", path, err)

    # -- recovery (runs before the writeback thread starts) ----------------

    def _recover(self) -> None:
        """Rebuild the index by scanning segment headers. Torn tails
        (short/garbled framing at EOF) are truncated; CRC mismatches
        with intact framing are skipped with an attributed error."""
        try:
            names = sorted(os.listdir(self.dir))
        except OSError as err:
            raise RuntimeError(
                f"cold disk: cannot list {self.dir}: {err}") from err
        for name in names:
            if not (name.startswith("segments-")
                    and name.endswith(".cold")):
                continue
            try:
                file_id = int(name[len("segments-"):-len(".cold")])
            except ValueError:
                log.error("cold disk: ignoring unparseable segment "
                          "file name %s", name)
                continue
            self._next_file_id = max(self._next_file_id, file_id + 1)
            self._scan_file(file_id)
        # appends resume in a FRESH file (forced roll on first write):
        # never extend a just-truncated tail through a new handle
        self._active_fh = None
        self._active_size = self.file_bytes

    def _scan_file(self, file_id: int) -> None:
        path = self._path(file_id)
        fi = _FileInfo()
        offset = 0
        valid_end = 0
        try:
            with open(path, "rb") as fh:
                size = os.fstat(fh.fileno()).st_size
                while offset + HEADER_BYTES <= size:
                    fh.seek(offset)
                    raw = fh.read(HEADER_BYTES)
                    if len(raw) < HEADER_BYTES:
                        break               # torn tail
                    (magic, units, live, mass_sum, mass_max, seq,
                     raw_bytes, plen, crc) = _HEADER.unpack(raw)
                    if magic != _MAGIC:
                        log.error(
                            "cold disk: bad magic at %s offset %d — "
                            "truncating torn tail", path, offset)
                        break
                    if offset + HEADER_BYTES + plen > size:
                        log.error(
                            "cold disk: short payload at %s offset %d "
                            "(%d bytes past EOF) — truncating torn "
                            "tail", path, offset,
                            offset + HEADER_BYTES + plen - size)
                        break               # torn tail
                    payload = fh.read(plen)
                    next_off = offset + HEADER_BYTES + plen
                    if zlib.crc32(payload) != crc:
                        # intact framing, rotten payload: skip the
                        # record, keep scanning, and count the bytes as
                        # dead weight so compaction reclaims them
                        self.corrupt_segments += 1
                        fi.dead_bytes += HEADER_BYTES + plen
                        log.error(
                            "cold disk: CRC mismatch at %s offset %d "
                            "(seq=%d) — record skipped", path, offset,
                            seq)
                        offset = next_off
                        valid_end = next_off
                        continue
                    self._insert_into(fi, _IndexEntry(
                        mass_sum, seq, file_id, offset + HEADER_BYTES,
                        plen, units, live, raw_bytes, mass_max, crc))
                    self._seq = max(self._seq, seq + 1)
                    offset = next_off
                    valid_end = next_off
            if valid_end < size:
                with open(path, "r+b") as fh:
                    fh.truncate(valid_end)
                log.warning("cold disk: truncated %s from %d to %d "
                            "bytes (torn tail)", path, size, valid_end)
        except OSError as err:
            self.io_errors += 1
            log.error("cold disk: recovery scan failed on %s: %s — "
                      "file ignored", path, err)
            return
        self._files[file_id] = fi

    # -- index helpers (caller holds _lock, or runs pre-thread) ------------

    def _insert(self, entry: _IndexEntry) -> None:
        fi = self._files.setdefault(entry.file_id, _FileInfo())
        self._insert_into(fi, entry)

    def _insert_into(self, fi: _FileInfo, entry: _IndexEntry) -> None:
        key = entry.key()
        at = bisect.bisect(self._keys, key)
        self._entries.insert(at, entry)
        self._keys.insert(at, key)
        self.transitions += entry.live
        self.bytes_stored += entry.record_bytes()
        fi.live_bytes += entry.record_bytes()
        fi.records += 1
        fi.mass_max = max(fi.mass_max, entry.mass_sum)

    def _remove_accounting(self, entry: _IndexEntry) -> None:
        self.transitions -= entry.live
        self.bytes_stored -= entry.record_bytes()
        fi = self._files.get(entry.file_id)
        if fi is not None:
            fi.live_bytes -= entry.record_bytes()
            fi.dead_bytes += entry.record_bytes()
            fi.records -= 1

    def _path(self, file_id: int) -> str:
        return os.path.join(self.dir, f"segments-{file_id:08d}.cold")
