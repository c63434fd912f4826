"""Metric registry: counters, gauges, fixed-bucket histograms.

`utils/metrics.py` is a flat scalar JSONL sink; what Ape-X health
actually needs are DISTRIBUTIONS — sampled-transition age, actor
parameter lag, |TD| priorities — whose tails (not means) are where the
staleness pathologies live (Horgan et al. 2018 §4; Kapturowski et al.
2019 on recency). This module adds the distribution layer while keeping
the JSONL stream canonical: a registry `publish()` snapshots every
instrument into one metrics record (`ctr/...`, `gauge/...` scalars and
`hist/...` plain-dict snapshots with precomputed percentiles), so a
run's JSONL remains a single self-contained artifact that
`obs/report.py` can summarize offline.

Hot-path cost: a scalar `observe()` is a `bisect` on a Python tuple of
edges plus integer bumps — no numpy allocation; the bulk `observe_many`
pays one `searchsorted` + `bincount` per call, amortized over the batch
(both hold a small per-instrument lock, uncontended in practice because
each component owns its instruments).

The PyTorch package's copy of ``ape_x_dqn_tpu/obs/registry.py``, the same
code (tests/test_torch_isolation.py pins it).
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Any, Iterable

import numpy as np

from ape_x_dqn_tpu_torch.obs.health import make_lock


def geometric_edges(lo: float = 1.0, hi: float = 1e6,
                    per_decade: int = 4) -> tuple[float, ...]:
    """Geometric bucket edges covering [lo, hi] — the right shape for
    age/lag/priority distributions whose interesting structure spans
    orders of magnitude."""
    n = max(int(np.ceil(np.log10(hi / lo) * per_decade)), 1)
    return tuple(float(lo * (hi / lo) ** (i / n)) for i in range(n + 1))


class Counter:
    """Monotonic event counter."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0  # guarded-by: _lock
        self._lock = make_lock("registry.instrument")

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0  # guarded-by: _lock
        self._lock = make_lock("registry.instrument")

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Histogram:
    """Fixed-bucket histogram: bucket i counts values in
    (edges[i-1], edges[i]]; bucket 0 is the underflow (<= edges[0]) and
    the last bucket the overflow (> edges[-1])."""

    __slots__ = ("name", "_edges", "_edges_np", "_counts", "_count",
                 "_sum", "_min", "_max", "_lock")

    def __init__(self, name: str, edges: Iterable[float]):
        self.name = name
        self._edges = tuple(float(e) for e in edges)
        assert self._edges == tuple(sorted(self._edges)) and self._edges, \
            f"histogram {name!r} needs ascending, non-empty edges"
        self._edges_np = np.asarray(self._edges, np.float64)
        self._counts = np.zeros(len(self._edges) + 1, np.int64)  # guarded-by: _lock
        self._count = 0  # guarded-by: _lock
        self._sum = 0.0  # guarded-by: _lock
        self._min = float("inf")  # guarded-by: _lock
        self._max = float("-inf")  # guarded-by: _lock
        self._lock = make_lock("registry.instrument")

    def observe(self, v: float) -> None:
        v = float(v)
        if v != v:  # NaN: a diverged TD must not poison the buckets
            return
        i = bisect_left(self._edges, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def observe_many(self, values: np.ndarray) -> None:
        v = np.asarray(values, np.float64).ravel()
        v = v[~np.isnan(v)]
        if not v.size:
            return
        idx = np.searchsorted(self._edges_np, v, side="left")
        binned = np.bincount(idx, minlength=self._counts.size)
        with self._lock:
            self._counts += binned
            self._count += int(v.size)
            self._sum += float(v.sum())
            self._min = min(self._min, float(v.min()))
            self._max = max(self._max, float(v.max()))

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def percentile(self, q: float) -> float | None:
        """Approximate q-th percentile (q in [0, 100]) from the bucket
        upper edges — the resolution is the bucket width, which is what
        fixed buckets buy. None when empty."""
        with self._lock:
            return self._percentile_locked(q)

    def _percentile_locked(self, q: float) -> float | None:
        if self._count == 0:
            return None
        target = self._count * q / 100.0
        cum = 0
        for i, c in enumerate(self._counts):
            cum += int(c)
            if cum >= target:
                if i == 0:
                    return min(self._edges[0], self._max)
                if i >= len(self._edges):
                    return self._max
                return min(self._edges[i], self._max)
        return self._max

    def snapshot(self) -> dict[str, Any]:
        """Plain-python dict (JSON-safe: no numpy scalars, no NaN/Inf)
        for the metrics JSONL stream."""
        with self._lock:
            empty = self._count == 0
            return {
                "count": int(self._count),
                "sum": float(self._sum),
                "min": None if empty else float(self._min),
                "max": None if empty else float(self._max),
                "edges": list(self._edges),
                "counts": [int(c) for c in self._counts],
                "p50": self._percentile_locked(50),
                "p90": self._percentile_locked(90),
                "p99": self._percentile_locked(99),
            }


class MetricRegistry:
    """Get-or-create instrument registry + one-record JSONL publish."""

    def __init__(self):
        self._lock = make_lock("registry.tables")
        self._counters: dict[str, Counter] = {}  # guarded-by: _lock
        self._gauges: dict[str, Gauge] = {}  # guarded-by: _lock
        self._hists: dict[str, Histogram] = {}  # guarded-by: _lock

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str,
                  edges: Iterable[float] | None = None) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(
                    name, edges if edges is not None else geometric_edges())
            return h

    def snapshot_frame(self) -> dict[str, Any]:
        """Every instrument's current value as one JSON-safe dict
        (`{"ctr": {...}, "gauge": {...}, "hist": {...}}`) — the
        instrument payload of a fleet telemetry frame (obs/fleet.py).
        Same snapshots publish() folds into the JSONL, minus the
        kind-prefix flattening: the frame keeps them nested so the
        aggregator can re-prefix them per peer."""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._hists.values())
        return {
            "ctr": {c.name: c.value for c in counters},
            "gauge": {g.name: g.value for g in gauges},
            "hist": {h.name: h.snapshot() for h in hists},
        }

    def publish(self, metrics, step: int,
                extra: dict[str, Any] | None = None) -> None:
        """One JSONL record carrying every instrument's current value:
        `ctr/<n>` and `gauge/<n>` scalars, `hist/<n>` snapshot dicts
        (the Metrics sink passes dicts through to JSON untouched)."""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._hists.values())
        payload: dict[str, Any] = dict(extra or {})
        for c in counters:
            payload[f"ctr/{c.name}"] = c.value
        for g in gauges:
            payload[f"gauge/{g.name}"] = g.value
        for h in hists:
            payload[f"hist/{h.name}"] = h.snapshot()
        if payload:
            metrics.log(step, **payload)
