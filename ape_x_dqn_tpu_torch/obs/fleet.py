"""Fleet telemetry plane: per-peer obs snapshots over the wire.

The per-process observability layer is strictly per-process: each actor host,
inference server, and learner writes its own metrics stream, spans
never cross a socket, and the stall watchdog only attributes stalls it
can see locally — "today a lost actor is silence" (ROADMAP item 4).
This module closes that gap on top of the existing transport and obs
stack, in three pieces:

- `StampingTransport` (actor-host side): wraps the experience
  transport, stamping every shipped batch with a monotonically-
  assigned `batch_id` and the origin `peer` id as scalar meta (they
  ride the JSON header of the wire payload, readable without decoding
  any array — comm/socket_transport.WireBatch.get). Each ship is also
  recorded as a correlation event so the learner can reconstruct the
  actor->encode->wire->decode->staging->add journey of a transition
  batch as ONE cross-process trace.

- `TelemetryEmitter` (actor-host side): a low-rate pump thread that
  snapshots the local Obs — heartbeat ages, counters/gauges/histogram
  snapshots, span aggregates, recent ship events — into a compact
  JSON frame and ships it as MSG_TELEMETRY (send_telemetry is
  best-effort and capability-gated: against an old server the frame
  is simply never sent).

- `FleetAggregator` (learner/driver side): installed on the ingest
  server's `on_telemetry`/`on_disconnect` hooks. Each arriving frame
  is merged into the single run JSONL under `peer/<id>/...` keys
  (one self-contained artifact per run stays the invariant), remote
  heartbeats are re-beaten into the local `HeartbeatRegistry` with
  `now = local_now - age_s` — ages cross clock domains, absolute
  stamps do not — so the driver's existing `check_stalled()` poll
  raises an attributed StallError for a wedged REMOTE actor, and ship
  events become `remote_span` entries on a `peer/<id>` track of the
  learner's trace. A peer's socket closing bumps the
  `peer_disconnects` counter and logs an attributed record instead of
  silence.

The PyTorch package's copy of ``ape_x_dqn_tpu/obs/fleet.py``, the same
code (tests/test_torch_isolation.py pins it).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

from ape_x_dqn_tpu_torch.obs.health import make_lock

# correlation events kept between telemetry pumps; at the default
# 2s cadence this caps frame growth while covering hundreds of ships
_EVENT_RING = 256
# span-arg batch_id attribution lists are truncated to this many ids
MAX_SPAN_IDS = 8


class StampingTransport:
    """Experience-transport wrapper that stamps origin correlation
    metadata on every shipped batch.

    Drop-in where a Transport goes (actors only call send_experience;
    everything else delegates). Stamps are plain scalar entries —
    `batch_id` (monotonic per origin) and `peer` — so they survive any
    wire codec and are header-readable on the learner side."""

    def __init__(self, inner: Any, peer: str):
        self._inner = inner
        self.peer = peer
        self._lock = make_lock("fleet.stamper")
        self._next_id = 0  # guarded-by: _lock
        self._rows_out = 0  # guarded-by: _lock
        self._events: deque = deque(maxlen=_EVENT_RING)  # guarded-by: _lock

    def send_experience(self, batch: dict) -> None:
        rows = 0
        pri = batch.get("priorities")
        if pri is not None:
            rows = int(pri.shape[0])
        with self._lock:
            bid = self._next_id
            self._next_id += 1
            self._rows_out += rows
            self._events.append(
                ("actor.ship", 0.0, time.monotonic(),
                 {"batch_id": bid, "rows": rows}))
        batch["batch_id"] = bid
        batch["peer"] = self.peer
        self._inner.send_experience(batch)

    def drain_events(self, now: float | None = None
                     ) -> list[list]:
        """Correlation events since the last drain, each as
        [name, dur_s, age_s, args] — ages computed at drain time so
        they are fresh when the frame ships."""
        now = time.monotonic() if now is None else now
        with self._lock:
            events = list(self._events)
            self._events.clear()
        return [[name, dur, max(now - t_end, 0.0), args]
                for name, dur, t_end, args in events]

    @property
    def rows_out(self) -> int:
        """Cumulative transition rows shipped (the aggregator derives
        per-peer ingest rate from deltas of this across frames)."""
        with self._lock:
            return self._rows_out

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)


def build_frame(obs: Any, peer: str, seq: int,
                events: list | None = None,
                rows_out: int | None = None) -> dict:
    """One compact telemetry frame from a live Obs: peer identity,
    heartbeat AGES (clock-domain free), instrument snapshots, span
    aggregates, and correlation events. Everything JSON-safe."""
    frame: dict[str, Any] = {"peer": peer, "seq": int(seq)}
    frame["hb"] = {name: [round(age, 3), note]
                   for name, (age, note) in obs.heartbeats.ages().items()}
    frame.update(obs.registry.snapshot_frame())
    frame["span"] = obs.tracer.aggregates()
    if events:
        frame["events"] = events
    if rows_out is not None:
        frame["rows_out"] = int(rows_out)
    return frame


class TelemetryEmitter:
    """Actor-host pump: every `interval_s`, build a frame from the
    local Obs and ship it (best-effort) over the transport.

    The transport may or may not be a StampingTransport; when it is,
    its ship events and rows_out ride along for correlation and
    per-peer rate. A final frame ships at stop() so the learner sees
    shutdown-fresh heartbeat ages."""

    def __init__(self, transport: Any, obs: Any, peer: str,
                 interval_s: float = 2.0):
        self._transport = transport
        self._obs = obs
        self.peer = peer
        self._interval = interval_s
        self._seq = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="telemetry-pump", daemon=True)

    def pump_once(self) -> bool:
        events = None
        rows = None
        drain = getattr(self._transport, "drain_events", None)
        if drain is not None:
            events = drain()
            rows = self._transport.rows_out
        frame = build_frame(self._obs, self.peer, self._seq,
                            events=events, rows_out=rows)
        sent = bool(self._transport.send_telemetry(frame))
        if sent:
            self._seq += 1
        return sent

    def start(self) -> None:
        if self._interval > 0:
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2)
        # shutdown-fresh final frame (also covers interval_s=0 callers
        # that never started the thread but want one frame at exit)
        self.pump_once()

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self.pump_once()


class FleetAggregator:
    """Learner/driver-side merge of per-peer telemetry into the run's
    single obs surface. Construct with the driver's (enabled) Obs and
    install on the ingest transport; both hooks are called from
    transport reader threads and are thread-safe."""

    def __init__(self, obs: Any, metrics: Any = None):
        self._obs = obs
        self._metrics = metrics if metrics is not None else obs.metrics
        self._lock = make_lock("fleet.aggregator")
        # peer -> {"seq", "rows_out", "t", "rate", "connected"}
        self._peers: dict[str, dict] = {}  # guarded-by: _lock

    def install(self, transport: Any) -> bool:
        """Attach to a transport exposing on_telemetry/on_disconnect
        (SocketIngestServer, LoopbackTransport). Returns False for
        transports without a telemetry plane — callers need no
        hasattr-dance."""
        if not hasattr(transport, "on_telemetry"):
            return False
        transport.on_telemetry = self.on_frame
        if hasattr(transport, "on_disconnect"):
            transport.on_disconnect = self.on_disconnect
        if hasattr(transport, "on_decode_error"):
            transport.on_decode_error = self.on_decode_error
        return True

    @property
    def peers(self) -> list[str]:
        with self._lock:
            return sorted(self._peers)

    def _step(self) -> int:
        return int(getattr(self._obs, "_learner_step", 0))

    def on_frame(self, peer: str, frame: dict) -> None:
        obs = self._obs
        now = time.monotonic()
        seq = int(frame.get("seq", 0))
        rows_out = frame.get("rows_out")
        with self._lock:
            st = self._peers.setdefault(
                peer, {"seq": -1, "rows_out": None, "t": now,
                       "rate": 0.0, "connected": True})
            st["connected"] = True
            if seq <= st["seq"]:
                return  # duplicate/reordered frame: keep state monotonic
            st["seq"] = seq
            # forensics retention (obs/postmortem.py): the LAST frame
            # from each peer is kept even after disconnect — for a peer
            # that dies without dumping its own black box, this is the
            # black box of last resort
            st["frame"] = frame
            st["recv_unix"] = time.time()
            if rows_out is not None and st["rows_out"] is not None \
                    and now > st["t"]:
                st["rate"] = (max(int(rows_out) - st["rows_out"], 0)
                              / (now - st["t"]))
            if rows_out is not None:
                st["rows_out"] = int(rows_out)
            st["t"] = now
            n_connected = sum(1 for p in self._peers.values()
                              if p["connected"])
            rate = st["rate"]
        obs.count("telemetry_frames")
        obs.gauge("fleet_peers", n_connected)
        # per-peer perf-regression baseline (obs/profiling.PerfMonitor):
        # a peer whose experience output collapses below its own EWMA
        # baseline fires an attributed PerfDegradation record carrying
        # the peer id — warn-only, distinct from the stall watchdog
        if rate > 0.0:
            obs.perf_rate("ingest_rows_per_s", rate, step=self._step(),
                          peer=peer)
        # the peer itself heartbeats by sending frames at all; each
        # remote component re-beats at local_now - reported_age so the
        # driver's check_stalled() attributes a wedged REMOTE component
        # exactly like a local one (component name "<peer>/<name>")
        obs.heartbeats.beat(peer, f"telemetry seq {seq}", now=now)
        for name, entry in dict(frame.get("hb", {})).items():
            try:
                age, note = float(entry[0]), str(entry[1])
            except (TypeError, ValueError, IndexError):
                continue
            obs.heartbeats.beat(f"{peer}/{name}", note, now=now - age)
        # correlation events -> synthetic peer track in the trace
        for ev in frame.get("events", ()):
            try:
                name, dur, age, args = ev
            except (TypeError, ValueError):
                continue
            obs.tracer.remote_span(str(name), float(dur), float(age),
                                   peer=peer, **dict(args))
        # merge the peer's instruments into the run JSONL with
        # peer/<id>/ attribution (dynamic keys: the report groups them
        # back per peer; the obs-names checker scans literals only)
        rec: dict[str, Any] = {f"peer/{peer}/seq": seq,
                               f"peer/{peer}/gauge/ingest_rate": rate}
        for kind in ("ctr", "gauge"):
            for k, v in dict(frame.get(kind, {})).items():
                rec[f"peer/{peer}/{kind}/{k}"] = v
        for k, v in dict(frame.get("hist", {})).items():
            if isinstance(v, dict):
                rec[f"peer/{peer}/hist/{k}"] = v
        for k, v in dict(frame.get("span", {})).items():
            if isinstance(v, dict):
                rec[f"peer/{peer}/span/{k}"] = v
        for k, v in dict(frame.get("hb", {})).items():
            try:
                rec[f"peer/{peer}/hb/{k}"] = float(v[0])
            except (TypeError, ValueError, IndexError):
                continue
        self._metrics.log(self._step(), **rec)

    def on_disconnect(self, peer: str) -> None:
        """An identified peer's socket closed: attributed, counted,
        logged — never silence. Its heartbeat entries stay registered,
        so if nothing reconnects the stall watchdog ALSO raises with
        the peer's name (the chaos-lane contract: kill an actor
        mid-run and the run says so twice, loudly)."""
        obs = self._obs
        with self._lock:
            st = self._peers.get(peer)
            if st is not None:
                st["connected"] = False
                st["rows_out"] = None  # a reconnect restarts the rate
            n_connected = sum(1 for p in self._peers.values()
                              if p["connected"])
        obs.count("peer_disconnects")
        obs.gauge("fleet_peers", n_connected)
        bb = getattr(obs, "blackbox", None)
        if bb is not None:
            bb.record("peer_disconnect", peer=peer)
        self._metrics.log(self._step(), peer_disconnect=peer)

    def retained_frames(self) -> dict[str, dict]:
        """Last telemetry frame per peer (connected or not), for the
        postmortem bundler: ``{peer: {frame, recv_unix, connected}}``.
        Peers that never completed a frame are omitted."""
        with self._lock:
            return {peer: {"frame": st["frame"],
                           "recv_unix": st["recv_unix"],
                           "connected": bool(st["connected"])}
                    for peer, st in self._peers.items()
                    if st.get("frame") is not None}

    def on_decode_error(self, peer: str, reason: str) -> None:
        """A truncated/garbled frame arrived (and dropped its
        connection): counter + attributed JSONL record, so a byzantine
        or proxy-mangled peer shows up as ITSELF in the run artifact —
        peer is "unidentified" when the connection never sent
        telemetry."""
        self._obs.count("wire_decode_errors")
        self._metrics.log(self._step(), wire_decode_error=peer,
                          wire_decode_reason=str(reason)[:200])
