"""Host-side span tracing in Chrome/Perfetto `trace_event` format.

The runtime's stage structure (actor inference+env step, replay
add/sample, learner SGD, priority write-back, target sync, checkpoint
I/O, inference-server batch assembly) is invisible to `jax.profiler`:
the XLA trace shows device ops, not which HOST loop was waiting on
which dispatch. This tracer records wall-clock spans from the Python
side into the `trace_event` JSON that chrome://tracing and
https://ui.perfetto.dev load directly — one timeline row per thread,
so the actor/ingest/learner overlap (or lack of it) is readable at a
glance.

Design constraints:
- Low overhead: a span costs two `perf_counter` calls and one
  lock-guarded list append; nothing is formatted or written until
  `close()`. A bounded buffer (`max_events`) caps memory on long runs
  — once full, new events are counted as dropped, never resized.
- Fused stages: stages that execute INSIDE one XLA dispatch (the
  priority write-back and target sync live inside the learn jit)
  cannot be timed from the host; `mark()` emits a zero-ish-duration
  event with `args["fused_into"]` naming the enclosing dispatch, so
  the trace still shows *when* they happened and *that* they are
  fused.
- Stage aggregates: every span also folds into a per-name
  (count, total_s, max_s) table so the JSONL stream can carry a
  stage-time breakdown (obs/report.py) without parsing the trace file.

The no-op twin `NullTracer` keeps every call site branch-free when
tracing is off (ObsConfig.trace_path empty / obs disabled).

The PyTorch package's copy of ``ape_x_dqn_tpu/obs/trace.py``, the same
code (tests/test_torch_isolation.py pins it).
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator


class NullTracer:
    """API-compatible no-op tracer (shared singleton `NULL_TRACER`)."""

    enabled = False

    @contextmanager
    def span(self, name: str, **args: Any) -> Iterator[None]:
        yield

    def mark(self, name: str, **args: Any) -> None:
        pass

    def remote_span(self, name: str, dur_s: float, age_s: float = 0.0,
                    peer: str = "", **args: Any) -> None:
        pass

    def aggregates(self) -> dict[str, dict[str, float]]:
        return {}

    def close(self) -> None:
        pass


NULL_TRACER = NullTracer()


class SpanTracer:
    """Thread-safe span recorder writing one `trace_event` JSON file.

    Events use the 'X' (complete) phase with microsecond ts/dur
    relative to tracer construction; pid/tid map to the OS process and
    Python thread ids, with 'M' metadata events naming each thread so
    Perfetto's track labels read "learner", "actor-3", ... instead of
    raw ids.
    """

    enabled = True

    def __init__(self, path: str, max_events: int = 200_000):
        self._path = path
        self._max = max_events
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._dropped = 0
        self._thread_names: dict[int, str] = {}
        self._peer_tids: dict[str, int] = {}  # synthetic remote tracks
        self._agg: dict[str, list[float]] = {}  # name -> [count, total, max]
        self._t0 = time.perf_counter()
        self._closed = False

    @contextmanager
    def span(self, name: str, **args: Any) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self._record(name, t0, t1, args)

    def mark(self, name: str, **args: Any) -> None:
        """Instant-ish event for a stage fused inside a device dispatch
        (1us nominal duration so 'X' renderers still draw it)."""
        t = time.perf_counter()
        self._record(name, t, t + 1e-6, args, fused=True)

    def remote_span(self, name: str, dur_s: float, age_s: float = 0.0,
                    peer: str = "", **args: Any) -> None:
        """Record a span REPORTED by a remote peer over the telemetry
        wire. The peer's clock domain does not cross the wire; only the
        event's AGE does — the event lands at local-now minus age_s on
        a synthetic `peer/<id>` track. That keeps cross-process
        correlation honest: ordering within a track and the shared
        correlation args (batch_id) are exact, absolute alignment
        across tracks is age-accurate only."""
        now = time.perf_counter()
        t1 = now - max(float(age_s), 0.0)
        t0 = t1 - max(float(dur_s), 0.0)
        label = f"peer/{peer or '?'}"
        with self._lock:
            tid = self._peer_tids.get(label)
            if tid is None:
                # high base keeps synthetic tids clear of OS thread ids
                tid = self._peer_tids[label] = 1 << 40 | len(self._peer_tids)
                self._thread_names[tid] = label
        self._record(name, t0, t1, dict(args, peer=peer), tid=tid)

    def _record(self, name: str, t0: float, t1: float, args: dict,
                fused: bool = False, tid: int | None = None) -> None:
        local = tid is None
        if local:
            tid = threading.get_ident()
        ev = {"name": name, "cat": "apex", "ph": "X",
              "ts": (t0 - self._t0) * 1e6, "dur": (t1 - t0) * 1e6,
              "pid": os.getpid(), "tid": tid}
        if args:
            ev["args"] = args
        with self._lock:
            if local and tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            a = self._agg.get(name)
            if a is None:
                a = self._agg[name] = [0, 0.0, 0.0]
            a[0] += 1
            if not fused:  # marks carry no host-measurable duration
                a[1] += t1 - t0
                a[2] = max(a[2], t1 - t0)
            if len(self._events) >= self._max:
                self._dropped += 1
                return
            self._events.append(ev)

    def aggregates(self) -> dict[str, dict[str, float]]:
        """Per-span-name stage totals (counts every event, including
        ones dropped from the bounded trace buffer)."""
        with self._lock:
            return {name: {"count": int(c), "total_s": t, "max_s": mx}
                    for name, (c, t, mx) in sorted(self._agg.items())}

    def close(self) -> None:
        """Write the trace file (valid JSON even with zero events)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            events = self._events
            self._events = []
            meta = [{"name": "thread_name", "ph": "M", "pid": os.getpid(),
                     "tid": tid, "args": {"name": tname}}
                    for tid, tname in sorted(self._thread_names.items())]
            dropped = self._dropped
        payload = {"traceEvents": meta + events,
                   "displayTimeUnit": "ms",
                   "otherData": {"dropped_events": dropped}}
        os.makedirs(os.path.dirname(self._path) or ".", exist_ok=True)
        tmp = self._path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, self._path)


def load_trace(path: str) -> dict:
    """Load a trace file back (tests / report CLI)."""
    with open(path) as fh:
        return json.load(fh)


def span_names(trace: dict) -> set[str]:
    """Distinct span ('X' event) names in a loaded trace."""
    return {ev["name"] for ev in trace.get("traceEvents", ())
            if ev.get("ph") == "X"}
