"""Host-RAM cold tier behind the device replay ring.

A pinned copy of ``ape_x_dqn_tpu/replay/cold_store.py``: its code is
the original's but for the import paths (tests/test_torch_isolation.py).

The device-resident ring (flat or frame ring) is the HOT set, and its
capacity is bounded by the card's memory. This module turns retention
into a provisioning knob: when the ring is full, the driver evicts the
ring's lowest-priority-mass region (the replay's evict_plan and
read_region) to a ColdStore segment compressed with the delta+deflate
codec (replay/packing.py cold_pack, on the C++ kernels of
cpp/framing.cpp through comm/native.py, or their bit-identical numpy
fallback), and an idle-time refill recalls the highest-mass cold
segments back through the IngestStager, so recalled data rides the
same staging->add path as fresh actor data.

Priority-mass bookkeeping: each segment carries the sum and max of the
sum-tree mass its transitions held at eviction (p = (|td|+eps)^alpha,
exactly the leaf values). Admission and displacement order by mass_sum
(what sampling probability the segment would contribute back);
recall pops the highest mass first. When the store is full, a new
segment displaces the lowest-mass stored segments only if it carries
more mass than they do; otherwise it is dropped at the door. The
driver pins the resulting closure: evicted == cold_stored +
cold_dropped (displacements are a separate counter; a displaced
segment was stored first, so the closure stays exact).

Pure host code: numpy and zlib. Thread ownership: the driver's ingest
thread is the only caller (evict on ship, recall on the idle tick), so
there is no locking here.
"""

from __future__ import annotations

import bisect
import logging
from typing import Any

import numpy as np

from ape_x_dqn_tpu_torch.replay.packing import cold_pack, cold_plan, cold_unpack

log = logging.getLogger(__name__)


def codec_status() -> tuple[bool, str]:
    """-> (available, detail). The cold tier needs the delta+deflate
    codec from comm/native.py; `available` is False only when that
    module genuinely fails to import (broken install), because a
    stale/missing libapex_framing.so degrades to a bit-identical numpy
    fallback — detail says which path is live ("native" /
    "numpy-fallback") so ColdStore can log the one-liner."""
    try:
        from ape_x_dqn_tpu_torch.comm import native
    except Exception as e:  # pragma: no cover - broken install only
        return False, f"{type(e).__name__}: {e}"
    return True, ("native" if native.have_delta_native()
                  else "numpy-fallback")


class ColdSegment:
    """One compressed eviction region (host bytes + priority summary)."""

    __slots__ = ("payload", "units", "live", "raw_bytes",
                 "mass_sum", "mass_max", "seq")

    def __init__(self, payload: bytes, units: int, live: int,
                 raw_bytes: int, mass_sum: float, mass_max: float,
                 seq: int):
        self.payload = payload
        self.units = units          # staging units (segments / transitions)
        self.live = live            # live transitions (pri > 0)
        self.raw_bytes = raw_bytes  # uncompressed leaf bytes
        self.mass_sum = mass_sum    # sum-tree mass at eviction
        self.mass_max = mass_max
        self.seq = seq              # admission order (stable tiebreak)


class ColdStore:
    """Fixed-capacity host-RAM store of compressed eviction segments,
    ordered by priority mass.

    capacity_transitions bounds LIVE transitions held (dead frame-ring
    pad slots ride along in the payload but don't count — they carry
    zero mass and zero sampling probability). unit_items converts
    staging units to transitions for the ring-multiple stats
    (seg_transitions in frame mode, 1 flat).
    """

    def __init__(self, item_spec: Any, capacity_transitions: int,
                 unit_items: int = 1, ptail: tuple = (),
                 compress_level: int = 1, spill: Any = None):
        ok, detail = codec_status()
        if not ok:  # configs.py validation normally rejects this earlier
            raise RuntimeError(f"cold tier codec unavailable: {detail}")
        if detail != "native":
            log.warning(
                "cold tier: libapex_framing.so missing or stale — using "
                "the bit-identical numpy delta codec (slower, same bytes)")
        self.capacity = int(capacity_transitions)
        self.unit_items = int(unit_items)
        self.level = int(compress_level)
        # optional disk rung (replay/disk_store.py): door losers —
        # displaced victims and live door-dropped candidates — are
        # offered there instead of vanishing. offer() never blocks.
        self.spill = spill
        self._plan = cold_plan(item_spec, ptail)
        # ascending (mass_sum, seq): [0] is the next displacement
        # victim, [-1] the next recall
        self._segs: list[ColdSegment] = []
        self._keys: list[tuple[float, int]] = []
        self._seq = 0
        self.transitions = 0        # live transitions stored
        self.bytes_compressed = 0
        self.bytes_raw = 0
        # door counters (driver closure: evicted == stored + dropped)
        self.stored = 0
        self.dropped = 0
        self.displaced = 0
        self.recalled = 0
        self.spilled = 0            # door losers offered to the disk rung

    # -- admission ---------------------------------------------------------

    def put(self, items: dict, priorities: np.ndarray, live: int) -> str:
        """Admit one eviction region -> "stored" | "dropped".

        items: {key: [n, *unit_shape]} host arrays in STAGING layout;
        priorities: the evicted sum-tree leaf values (shape [n, B] in
        frame mode, [n] flat) — stored in the payload so a recall can
        restage at eviction-time mass. live: count of pri > 0 slots.
        """
        n = int(priorities.shape[0])
        pri = np.asarray(priorities, np.float32)
        mass_sum = float(pri.sum())
        mass_max = float(pri.max()) if pri.size else 0.0
        if live <= 0 or mass_sum <= 0.0:
            self.dropped += 1           # all-dead region: nothing to keep
            return "dropped"
        # door policy before paying for compression: displace only
        # strictly lighter segments, never heavier ones
        freed = 0
        victims = 0
        while (self.transitions + live - freed > self.capacity
               and victims < len(self._segs)
               and self._keys[victims][0] < mass_sum):
            freed += self._segs[victims].live
            victims += 1
        if self.transitions + live - freed > self.capacity:
            self.dropped += 1
            if self.spill is not None:
                # the candidate lost the RAM door but still carries
                # live mass: pack it and offer it to the disk rung
                # (non-blocking; a full queue loses it exactly as the
                # drop would have)
                payload, raw = cold_pack(dict(items, priorities=pri),
                                         self._plan, self.level)
                if self.spill.offer(ColdSegment(
                        payload, n, int(live), raw, mass_sum, mass_max,
                        self._seq)):
                    self.spilled += 1
                self._seq += 1
            return "dropped"
        for seg in self._segs[:victims]:
            self.transitions -= seg.live
            self.bytes_compressed -= len(seg.payload)
            self.bytes_raw -= seg.raw_bytes
            if self.spill is not None and self.spill.offer(seg):
                self.spilled += 1
        del self._segs[:victims], self._keys[:victims]
        self.displaced += victims

        payload, raw = cold_pack(dict(items, priorities=pri),
                                 self._plan, self.level)
        seg = ColdSegment(payload, n, int(live), raw, mass_sum, mass_max,
                          self._seq)
        self._seq += 1
        key = (seg.mass_sum, seg.seq)
        at = bisect.bisect(self._keys, key)
        self._segs.insert(at, seg)
        self._keys.insert(at, key)
        self.transitions += seg.live
        self.bytes_compressed += len(payload)
        self.bytes_raw += raw
        self.stored += 1
        return "stored"

    def put_segment(self, seg: ColdSegment) -> str:
        """Admit an already-packed segment (a disk promotion) through
        the same door -> "stored" | "dropped". Displaced victims spill
        back to disk, but a door-dropped CANDIDATE is intentionally
        lost rather than re-spilled: re-offering a segment the door
        just rejected would ping-pong it between the rungs forever
        (the promote() floor makes this path rare — it only fires when
        the floor rose mid-tick). Does NOT touch the eviction-door
        stored/dropped counters: the driver's closure evicted ==
        cold_stored + cold_dropped is denominated in ring evictions,
        and promotions are not evictions."""
        if seg.live <= 0 or seg.mass_sum <= 0.0:
            return "dropped"
        freed = 0
        victims = 0
        while (self.transitions + seg.live - freed > self.capacity
               and victims < len(self._segs)
               and self._keys[victims][0] < seg.mass_sum):
            freed += self._segs[victims].live
            victims += 1
        if self.transitions + seg.live - freed > self.capacity:
            return "dropped"
        for victim in self._segs[:victims]:
            self.transitions -= victim.live
            self.bytes_compressed -= len(victim.payload)
            self.bytes_raw -= victim.raw_bytes
            if self.spill is not None and self.spill.offer(victim):
                self.spilled += 1
        del self._segs[:victims], self._keys[:victims]
        self.displaced += victims
        seg.seq = self._seq         # re-key in RAM admission order
        self._seq += 1
        key = (seg.mass_sum, seg.seq)
        at = bisect.bisect(self._keys, key)
        self._segs.insert(at, seg)
        self._keys.insert(at, key)
        self.transitions += seg.live
        self.bytes_compressed += len(seg.payload)
        self.bytes_raw += seg.raw_bytes
        return "stored"

    def displacement_floor(self) -> float:
        """Minimum mass_sum a candidate needs to clear the door right
        now: the lightest stored segment's mass when the store is full,
        else 0.0 (free space admits anything live). The disk rung's
        promote() uses this to skip segments — and whole files — that
        would bounce."""
        if not self._segs or self.transitions < self.capacity:
            return 0.0
        return self._keys[0][0]

    # -- recall ------------------------------------------------------------

    def recall(self, k: int = 1) -> list[dict]:
        """Pop the k highest-mass segments, decompressed back to
        STAGING layout ({item keys: [n, ...]} + "priorities" holding
        the eviction-time sum-tree leaf values). Bitwise equal to what
        was evicted (tests/test_cold_store.py)."""
        out = []
        for _ in range(min(int(k), len(self._segs))):
            seg = self._segs.pop()
            self._keys.pop()
            self.transitions -= seg.live
            self.bytes_compressed -= len(seg.payload)
            self.bytes_raw -= seg.raw_bytes
            self.recalled += 1
            out.append(cold_unpack(seg.payload, self._plan, seg.units))
        return out

    # -- stats -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._segs)

    def compression_ratio(self) -> float:
        """raw/compressed bytes over the resident set, floored at 1.0:
        the per-leaf never-inflate guard (packing.cold_pack) bounds any
        overshoot to the constant 9-byte/leaf framing, so the floor is
        the honest healthy-range bound the obs row warns below."""
        if self.bytes_compressed <= 0:
            return 1.0
        return max(1.0, self.bytes_raw / self.bytes_compressed)
