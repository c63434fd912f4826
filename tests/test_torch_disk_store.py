"""The port's disk-spill rung (replay/disk_store.py, a pinned copy of
the original's, tests/test_torch_isolation.py) under the original's
tests/test_disk_store.py, unchanged but for the package name:

- bitwise offer -> writeback -> promote round trips, heaviest first;
- the disk door mirrors the RAM door (displace strictly lighter, else
  drop) and offer() never blocks (a full queue counts, returns False);
- file-granular promote: whole files below the displacement floor are
  skipped through the recorded per-file mass_max bound, and stale
  bounds tighten themselves;
- durability: reopen recovery rebuilds the index bitwise; torn tails
  are truncated, never trusted; bit-flipped payloads are rejected with
  an attributed error while intact records in the same file survive;
- compaction unlinks files whose live records have all left.
"""

import logging
import os
import struct
import time

import numpy as np
import pytest

from ape_x_dqn_tpu_torch.replay.cold_store import ColdSegment
from ape_x_dqn_tpu_torch.replay.disk_store import (
    _HEADER, _MAGIC, HEADER_BYTES, DiskStore)

LIVE = 8  # live transitions per test segment


def _seg(mass: float, tag: int, seq: int = 0) -> ColdSegment:
    """Deterministic distinct payload per tag (bitwise comparisons)."""
    rng = np.random.default_rng(1000 + tag)
    payload = rng.integers(0, 256, 96, dtype=np.uint8).tobytes()
    return ColdSegment(payload, 1, LIVE, 3 * len(payload),
                       float(mass), float(mass), seq)


def _store(tmp_path, capacity=10 * LIVE, **kw) -> DiskStore:
    return DiskStore(str(tmp_path / "disk"), capacity, **kw)


def _stopped_store(tmp_path, **kw) -> DiskStore:
    """Store with the writeback thread retired — queued offers stay
    queued, so queue behavior is testable deterministically."""
    st = _store(tmp_path, **kw)
    st._stop.set()
    st._thread.join(timeout=5.0)
    assert not st._thread.is_alive()
    return st


def test_offer_writeback_promote_bitwise(tmp_path):
    st = _store(tmp_path)
    segs = [_seg(mass=m, tag=m) for m in (3, 1, 5, 2, 4)]
    for s in segs:
        assert st.offer(s)
    st.drain(timeout=10.0)
    stats = st.stats()
    assert stats["spilled"] == 5
    assert stats["segments"] == 5
    assert stats["transitions"] == 5 * LIVE
    assert stats["queue_full"] == 0 and stats["io_errors"] == 0
    out = st.promote(5)
    # heaviest first, payloads bitwise identical to what was offered
    assert [s.mass_sum for s in out] == [5.0, 4.0, 3.0, 2.0, 1.0]
    by_mass = {s.mass_sum: s.payload for s in segs}
    for s in out:
        assert s.payload == by_mass[s.mass_sum]
        assert (s.units, s.live, s.raw_bytes) == (1, LIVE, 3 * 96)
    assert st.stats()["transitions"] == 0
    assert st.stats()["promoted"] == 5
    st.close()


def test_promote_respects_floor(tmp_path):
    st = _store(tmp_path)
    for m in (1, 2, 3, 4):
        st.offer(_seg(mass=m, tag=m))
    st.drain(timeout=10.0)
    out = st.promote(10, floor=2.5)
    assert sorted(s.mass_sum for s in out) == [3.0, 4.0]
    # the lighter segments stay resident for a later, lower floor
    assert st.stats()["segments"] == 2
    assert st.promote(10, floor=2.5) == []
    st.close()


def test_promote_skips_whole_files_below_floor(tmp_path):
    # tiny file_bytes -> one record per file, so the per-file mass_max
    # bound is exercised at file granularity
    st = _store(tmp_path, file_bytes=64)
    for m in (1, 2, 9):
        st.offer(_seg(mass=m, tag=m))
    st.drain(timeout=10.0)
    assert st.stats()["files"] == 3
    out = st.promote(10, floor=5.0)
    assert [s.mass_sum for s in out] == [9.0]
    # light files were skipped purely on their recorded bound: their
    # entries are untouched and a later floor drop frees them
    assert st.stats()["segments"] == 2
    assert [s.mass_sum for s in st.promote(10, floor=0.0)] == [2.0, 1.0]
    st.close()


def test_promote_tightens_stale_file_bound(tmp_path):
    st = _store(tmp_path, file_bytes=1 << 20)  # both in one file
    st.offer(_seg(mass=9, tag=9))
    st.offer(_seg(mass=1, tag=1))
    st.drain(timeout=10.0)
    [file_id] = list(st._files)
    assert st._files[file_id].mass_max == 9.0
    assert [s.mass_sum for s in st.promote(1, floor=0.0)] == [9.0]
    # bound is monotone (still 9.0) until a visit finds nothing above
    # the floor and tightens it to the true max of what is left
    assert st._files[file_id].mass_max == 9.0
    assert st.promote(1, floor=5.0) == []
    assert st._files[file_id].mass_max == 1.0
    st.close()


def test_disk_door_displaces_lighter_drops_heavier(tmp_path):
    st = _store(tmp_path, capacity=2 * LIVE)
    st.offer(_seg(mass=5, tag=5))
    st.offer(_seg(mass=6, tag=6))
    st.drain(timeout=10.0)
    # heavier candidate displaces the lightest stored segment
    st.offer(_seg(mass=7, tag=7))
    st.drain(timeout=10.0)
    assert st.stats()["transitions"] == 2 * LIVE
    # lighter candidate is dropped at the disk door
    st.offer(_seg(mass=1, tag=1))
    st.drain(timeout=10.0)
    stats = st.stats()
    assert stats["dropped"] == 1
    assert stats["spilled"] == 3
    masses = sorted(s.mass_sum for s in st.promote(10))
    assert masses == [6.0, 7.0]
    st.close()


def test_offer_full_queue_counts_never_blocks(tmp_path):
    st = _stopped_store(tmp_path, queue_depth=1)
    assert st.offer(_seg(mass=1, tag=1))
    t0 = time.monotonic()
    assert not st.offer(_seg(mass=2, tag=2))
    assert not st.offer(_seg(mass=3, tag=3))
    # put_nowait by construction: a refusal is immediate, not a wait
    assert time.monotonic() - t0 < 0.5
    assert st.stats()["queue_full"] == 2
    assert st.stats()["spilled"] == 0
    st.close()


def test_reopen_recovery_roundtrips_bitwise(tmp_path):
    st = _store(tmp_path)
    segs = [_seg(mass=m, tag=m) for m in (2, 7, 4)]
    for s in segs:
        st.offer(s)
    st.drain(timeout=10.0)
    before = st.stats()
    st.close()
    st2 = _store(tmp_path)
    after = st2.stats()
    assert after["segments"] == before["segments"] == 3
    assert after["transitions"] == before["transitions"]
    assert after["bytes"] == before["bytes"]
    out = st2.promote(10)
    assert [s.mass_sum for s in out] == [7.0, 4.0, 2.0]
    by_mass = {s.mass_sum: s.payload for s in segs}
    for s in out:
        assert s.payload == by_mass[s.mass_sum]
    st2.close()


def test_recovery_appends_go_to_fresh_file(tmp_path):
    st = _store(tmp_path)
    st.offer(_seg(mass=1, tag=1))
    st.drain(timeout=10.0)
    files_before = set(os.listdir(st.dir))
    st.close()
    st2 = _store(tmp_path)
    st2.offer(_seg(mass=2, tag=2))
    st2.drain(timeout=10.0)
    new = set(os.listdir(st2.dir)) - files_before
    assert len(new) == 1  # never extends a pre-crash file
    st2.close()


def _only_file(st: DiskStore) -> str:
    names = [n for n in os.listdir(st.dir) if n.endswith(".cold")]
    assert len(names) == 1
    return os.path.join(st.dir, names[0])


def test_torn_garbage_tail_truncated(tmp_path, caplog):
    st = _store(tmp_path)
    st.offer(_seg(mass=3, tag=3))
    st.drain(timeout=10.0)
    path = _only_file(st)
    st.close()
    good_size = os.path.getsize(path)
    with open(path, "ab") as fh:
        fh.write(b"\x00garbage-after-a-crash" * 4)
    with caplog.at_level(logging.WARNING,
                         logger="ape_x_dqn_tpu_torch.replay.disk_store"):
        st2 = _store(tmp_path)
    assert os.path.getsize(path) == good_size
    assert st2.stats()["segments"] == 1
    assert any("torn tail" in r.message for r in caplog.records)
    [out] = st2.promote(1)
    assert out.payload == _seg(mass=3, tag=3).payload
    st2.close()


def test_kill_mid_writeback_partial_record_truncated(tmp_path):
    """A record torn mid-append (intact header, short payload) is the
    kill-mid-writeback shape; recovery truncates it and every earlier
    record round-trips bitwise."""
    st = _store(tmp_path)
    st.offer(_seg(mass=5, tag=5))
    st.drain(timeout=10.0)
    path = _only_file(st)
    st.close()
    good_size = os.path.getsize(path)
    torn = _seg(mass=8, tag=8)
    import zlib
    header = _HEADER.pack(_MAGIC, torn.units, torn.live, torn.mass_sum,
                          torn.mass_max, 99, torn.raw_bytes,
                          len(torn.payload), zlib.crc32(torn.payload))
    with open(path, "ab") as fh:
        fh.write(header + torn.payload[:10])  # killed 10 bytes in
    st2 = _store(tmp_path)
    assert os.path.getsize(path) == good_size  # torn record gone
    assert st2.stats()["segments"] == 1
    [out] = st2.promote(1)
    assert out.mass_sum == 5.0
    assert out.payload == _seg(mass=5, tag=5).payload
    st2.close()


def test_bitflip_rejected_attributed_scan_continues(tmp_path, caplog):
    """Bit rot inside a payload (framing intact): the record is
    rejected with an attributed error, counted, and the scan recovers
    every OTHER record in the same file."""
    st = _store(tmp_path, file_bytes=1 << 20)
    st.offer(_seg(mass=2, tag=2))
    st.offer(_seg(mass=6, tag=6))
    st.drain(timeout=10.0)
    path = _only_file(st)
    # flip one byte inside the FIRST record's payload
    with open(path, "r+b") as fh:
        fh.seek(HEADER_BYTES + 5)
        b = fh.read(1)
        fh.seek(HEADER_BYTES + 5)
        fh.write(bytes([b[0] ^ 0xFF]))
    st.close()
    with caplog.at_level(logging.ERROR,
                         logger="ape_x_dqn_tpu_torch.replay.disk_store"):
        st2 = _store(tmp_path)
    stats = st2.stats()
    assert stats["corrupt_segments"] == 1
    assert stats["segments"] == 1
    attributed = [r for r in caplog.records
                  if "CRC mismatch" in r.message]
    assert attributed and path in attributed[0].getMessage()
    [out] = st2.promote(1)  # the intact record past the rot survives
    assert out.mass_sum == 6.0
    assert out.payload == _seg(mass=6, tag=6).payload
    st2.close()


def test_bitflip_on_read_rejected(tmp_path, caplog):
    """Rot that lands AFTER the index was built (or a stale index) is
    caught by the read-side CRC check in promote()."""
    st = _store(tmp_path, file_bytes=1 << 20)
    st.offer(_seg(mass=4, tag=4))
    st.drain(timeout=10.0)
    path = _only_file(st)
    with open(path, "r+b") as fh:
        fh.seek(HEADER_BYTES + 3)
        b = fh.read(1)
        fh.seek(HEADER_BYTES + 3)
        fh.write(bytes([b[0] ^ 0x01]))
    with caplog.at_level(logging.ERROR,
                         logger="ape_x_dqn_tpu_torch.replay.disk_store"):
        out = st.promote(1)
    assert out == []
    assert st.stats()["corrupt_segments"] == 1
    assert any("CRC/length mismatch" in r.message
               for r in caplog.records)
    st.close()


def test_compaction_unlinks_emptied_files(tmp_path):
    # one record per file; promoting a file's only record makes its
    # dead fraction 1.0 and the next writeback pass compacts it away
    st = _store(tmp_path, file_bytes=64, compact_frac=0.5)
    for m in (1, 2, 3):
        st.offer(_seg(mass=m, tag=m))
    st.drain(timeout=10.0)
    assert st.stats()["files"] == 3
    [heavy] = st.promote(1)
    assert heavy.mass_sum == 3.0
    st.offer(_seg(mass=4, tag=4))  # writeback pass runs compaction
    st.drain(timeout=10.0)
    deadline = time.monotonic() + 10.0
    while st.stats()["compactions"] < 1 \
            and time.monotonic() < deadline:
        time.sleep(0.01)  # compaction runs after the drain handshake
    stats = st.stats()
    assert stats["compactions"] >= 1
    assert stats["segments"] == 3  # 1, 2 and the new 4
    # surviving payloads are untouched by the compaction pass
    out = {s.mass_sum: s.payload for s in st.promote(10)}
    assert out[1.0] == _seg(mass=1, tag=1).payload
    assert out[2.0] == _seg(mass=2, tag=2).payload
    st.close()


def test_displacement_floor(tmp_path):
    st = _stopped_store(tmp_path, capacity=2 * LIVE)
    assert st.displacement_floor() == 0.0
    st._write_one(_seg(mass=3, tag=3))
    assert st.displacement_floor() == 0.0  # below capacity
    st._write_one(_seg(mass=5, tag=5))
    assert st.displacement_floor() == 3.0  # at capacity: lightest mass
    st.close()


def test_drain_times_out_when_writeback_is_dead(tmp_path):
    st = _stopped_store(tmp_path)
    with pytest.raises(TimeoutError):
        st.drain(timeout=0.2)
    st.close()
