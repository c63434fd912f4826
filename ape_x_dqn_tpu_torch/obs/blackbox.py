"""Per-process flight recorder — the forensics plane's black box.

Every prior obs plane (trace spans, fleet telemetry, perf events,
learning health) is forward-streaming: it survives only as long as the
process that produced it. The FlightRecorder is the opposite — a
fixed-size, allocation-free ring of recent *significant* records
(attributed events: remediation, perf/learning degradation, reconnects,
drops, stalls; plus a short log tail) that is dumped atomically to a
per-process ``blackbox-<peer>.json`` when the process dies or is asked
to explain itself:

- unhandled exception (chained ``sys.excepthook``) and ``atexit``
- ``StallError`` (the Obs facade dumps in ``check_stalled`` before
  closing and re-raising)
- ``SIGUSR2`` — live, non-fatal "explain yourself" (main thread only;
  installation is silently skipped off the main thread)
- watchdog / supervisor request (the driver archives the victim's ring
  on every restart / quarantine decision)

Expensive context — span aggregates, ctr/gauge snapshots, heartbeat
ages, and thread stacks via ``sys._current_frames`` — is captured at
DUMP time, not per record, so ``record()`` stays cheap enough for hot
paths. The dump itself is torn-write safe (tmp + ``os.replace``); the
bundler (obs/postmortem.py) skips and counts any partial that an
unlucky kill still manages to leave behind.

Gated by ``ObsConfig.blackbox*`` knobs with the same disabled-⇒-no-op
contract as ``NULL_OBS``: a disabled config yields ``NULL_BLACKBOX``,
which records nothing and writes no files.

The PyTorch package's copy of ``ape_x_dqn_tpu/obs/blackbox.py``, the same
code but for one fix (tests/test_torch_isolation.py pins it): `uninstall`
restores the previous ``sys.excepthook``, which the original's identity
test of a bound method never does.
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import socket
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable

from ape_x_dqn_tpu_torch.obs.health import make_lock

_STACK_DEPTH = 24  # frames kept per thread in a dump's stack snapshot


def default_peer() -> str:
    """Stable-enough per-process identity for the dump filename."""
    return f"{socket.gethostname()}-{os.getpid()}"


def _thread_stacks(limit: int = _STACK_DEPTH) -> dict[str, list[str]]:
    """``sys._current_frames`` rendered as short ``file:line func``
    strings, keyed by thread name (ident when unnamed)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: dict[str, list[str]] = {}
    for ident, frame in sys._current_frames().items():
        stack = traceback.extract_stack(frame, limit=limit)
        out[names.get(ident, f"thread-{ident}")] = [
            f"{os.path.basename(fs.filename)}:{fs.lineno} {fs.name}"
            for fs in stack]
    return out


class NullBlackBox:
    """Disabled recorder: records nothing, dumps nothing, installs
    nothing. Method-for-method parity with FlightRecorder."""

    enabled = False
    peer = ""

    def set_peer(self, peer: str) -> None:
        pass

    def record(self, kind: str, **fields) -> None:
        pass

    def log_line(self, line: str) -> None:
        pass

    def add_context_provider(self, fn: Callable[[], dict]) -> None:
        pass

    def dump(self, reason: str, component: str = "", step: int = 0,
             extra: dict | None = None) -> str | None:
        return None

    def install(self, signals: bool = True) -> None:
        pass

    def uninstall(self) -> None:
        pass


NULL_BLACKBOX = NullBlackBox()


class FlightRecorder:
    """Fixed-capacity ring of (wall_time, kind, fields) records.

    The ring is preallocated and overwritten in place — recording never
    grows it past capacity; overwrites are counted as drops so the
    ``blackbox_dropped / blackbox_records`` fraction is a published,
    checkable quantity (report --check warns when most of the window
    was lost).
    """

    enabled = True

    def __init__(self, obs: Any, peer: str = "", out_dir: str = ".",
                 capacity: int = 512, log_lines: int = 64):
        self._obs = obs  # counters ride the obs facade (may be minimal)
        self.peer = peer or default_peer()
        self._dir = out_dir or "."
        self._cap = max(int(capacity), 1)
        self._ring: list = [None] * self._cap  # guarded-by: _lock
        self._pos = 0  # guarded-by: _lock
        self._n = 0  # guarded-by: _lock
        self._recorded = 0  # guarded-by: _lock
        self._dropped = 0  # guarded-by: _lock
        self._log: deque = deque(maxlen=max(int(log_lines), 1))
        self._lock = make_lock("blackbox.recorder")
        self._providers: list[Callable[[], dict]] = []
        self._dumps = 0
        self._last_dump_path: str | None = None
        self._installed = False
        self._prev_excepthook: Any = None
        self._prev_sigusr2: Any = None
        self._sig_installed = False

    # -- recording (hot path) -------------------------------------------

    def set_peer(self, peer: str) -> None:
        if peer:
            self.peer = peer

    def record(self, kind: str, **fields) -> None:
        """Append one significant record, overwriting the oldest when
        full. Cheap by design: one tuple, no snapshotting."""
        dropped = False
        with self._lock:
            if self._n == self._cap:
                dropped = True
                self._dropped += 1
            else:
                self._n += 1
            self._ring[self._pos] = (time.time(), kind, fields)
            self._pos = (self._pos + 1) % self._cap
            self._recorded += 1
        # counters outside the ring lock: registry locks are leaves,
        # never held while taking blackbox.recorder
        self._obs.count("blackbox_records")
        if dropped:
            self._obs.count("blackbox_dropped")

    def log_line(self, line: str) -> None:
        """Keep the last N log lines (separate from the event ring so
        chatty logging can't evict attributed events)."""
        self._log.append((time.time(), str(line)))

    def add_context_provider(self, fn: Callable[[], dict]) -> None:
        """Register a callable whose dict result is merged into every
        dump (e.g. the driver contributes the fleet's retained per-peer
        telemetry frames — the remote's black box of last resort)."""
        self._providers.append(fn)

    # -- dumping --------------------------------------------------------

    @property
    def path(self) -> str:
        return os.path.abspath(
            os.path.join(self._dir, f"blackbox-{self.peer}.json"))

    def _snapshot(self) -> tuple[list[dict], int, int, int]:
        with self._lock:
            n, pos = self._n, self._pos
            oldest = (pos - n) % self._cap
            recs = [self._ring[(oldest + i) % self._cap]
                    for i in range(n)]
            recorded, dropped = self._recorded, self._dropped
        out = []
        for t, kind, fields in recs:
            rec = {"t": t, "kind": kind}
            rec.update(fields)
            out.append(rec)
        return out, recorded, dropped, len(out)

    def dump(self, reason: str, component: str = "", step: int = 0,
             extra: dict | None = None) -> str | None:
        """Write the box atomically; returns the path (None on failure
        — the dump path must never mask the crash it documents)."""
        try:
            records, recorded, dropped, n = self._snapshot()
            payload: dict[str, Any] = {
                "blackbox": 1,
                "peer": self.peer,
                "host": socket.gethostname(),
                "pid": os.getpid(),
                "reason": reason,
                "component": component,
                "step": int(step),
                "wall_unix": time.time(),
                "records": records,
                "recorded": recorded,
                "dropped": dropped,
                "log_tail": [[t, line] for t, line in list(self._log)],
            }
            try:
                payload["threads"] = _thread_stacks()
            except Exception:
                pass
            # instrument + span + heartbeat context when riding a full
            # Obs (minimal facades — e.g. the chaos bench sink — only
            # need .count)
            reg = getattr(self._obs, "registry", None)
            if reg is not None:
                payload.update(reg.snapshot_frame())
            tracer = getattr(self._obs, "tracer", None)
            if tracer is not None:
                try:
                    payload["span"] = tracer.aggregates()
                except Exception:
                    pass
            hb = getattr(self._obs, "heartbeats", None)
            if hb is not None:
                payload["hb"] = {name: [round(age, 3), note]
                                 for name, (age, note)
                                 in hb.ages().items()}
            for fn in self._providers:
                try:
                    payload.update(fn() or {})
                except Exception:
                    pass
            if extra:
                payload["extra"] = extra
            path = self.path
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(payload, fh)
            os.replace(tmp, path)
            self._dumps += 1
            self._last_dump_path = path
            self._obs.count("blackbox_dumps")
            # correlate into the run JSONL so `report --check` can
            # demand a dump on disk for every terminal stall/quarantine
            metrics = getattr(self._obs, "metrics", None)
            if metrics is not None:
                metrics.log(int(step), blackbox_dump=path,
                            blackbox_reason=reason,
                            blackbox_peer=self.peer,
                            blackbox_component=component,
                            blackbox_ring_recorded=recorded,
                            blackbox_ring_dropped=dropped)
            return path
        except Exception:
            return None

    # -- crash-path installation ----------------------------------------

    def install(self, signals: bool = True) -> None:
        """Chain the crash hooks: excepthook + atexit, and (main thread
        only) a live SIGUSR2 dump. Idempotent."""
        if self._installed:
            return
        self._installed = True
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._excepthook
        atexit.register(self._atexit_dump)
        if signals and hasattr(signal, "SIGUSR2"):
            try:
                self._prev_sigusr2 = signal.signal(
                    signal.SIGUSR2, self._sigusr2)
                self._sig_installed = True
            except (ValueError, OSError):
                # signal.signal only works on the main thread; embedded
                # runs (tests spawning actor hosts in threads) skip it
                self._sig_installed = False

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        # == (a bound method is made anew at each access, so `is` never
        # holds and the original leaves its hook chained)
        if sys.excepthook == self._excepthook:
            sys.excepthook = self._prev_excepthook
        try:
            atexit.unregister(self._atexit_dump)
        except Exception:
            pass
        if self._sig_installed:
            try:
                signal.signal(signal.SIGUSR2, self._prev_sigusr2)
            except (ValueError, OSError):
                pass
            self._sig_installed = False

    def _excepthook(self, exc_type, exc, tb) -> None:
        try:
            self.record("crash", error=repr(exc)[:200])
            self.dump("crash", component=exc_type.__name__, extra={
                "traceback": traceback.format_exception(
                    exc_type, exc, tb)[-_STACK_DEPTH:]})
        finally:
            prev = self._prev_excepthook or sys.__excepthook__
            prev(exc_type, exc, tb)

    def _atexit_dump(self) -> None:
        # only when nothing else dumped: a crash/stall dump already has
        # the attributed reason — don't overwrite it with "atexit"
        if self._dumps == 0:
            self.dump("atexit")

    def _sigusr2(self, signum, frame) -> None:
        self.record("sigusr2")
        self.dump("sigusr2")
