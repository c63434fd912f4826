"""Heartbeats, the stall watchdog and the lock-order witness.

Counterpart of ``ape_x_dqn_tpu/obs/health.py``:

- `HeartbeatRegistry` + `HeartbeatWatchdog`: the driver's components
  (actors, ingest, learner, inference server; remote peers through
  their telemetry frames) stamp heartbeats as they make progress; the
  driver's poll loop calls `watchdog.check()` and gets a `StallError`
  naming WHICH component went silent, for HOW long and what it last
  reported, instead of a run that silently stops producing grad-steps.
  Components that finish legitimately `clear()` themselves out.
- The lock factory: every transport lock is built through
  ``make_lock("owner.name")``; in production that is a plain
  ``threading.Lock`` with no overhead, but under
  ``APEX_LOCK_WITNESS=1`` (tests/conftest.py sets it) each acquisition
  is recorded into a process-global lock-ORDER graph, and an
  acquisition that closes a cycle raises `LockOrderError` at once: a
  deadlock that needs a precise two-thread interleave to bite becomes a
  deterministic failure on the first test whose code path merely
  acquires in the conflicting order.
- `StallWatchdog`: the multi-host driver's lockstep watchdog
  (runtime/multihost_driver.py). A peer process that dies mid-round
  leaves every survivor blocked inside a collective; the watchdog turns
  that silence into a diagnostic and then an exit.
"""

from __future__ import annotations

import os
import sys
import threading
import time


class StallError(RuntimeError):
    """A component stopped heartbeating: attributed stall diagnostic."""

    def __init__(self, component: str, staleness_s: float,
                 last_note: str = "", timeout_s: float = 0.0):
        self.component = component
        self.staleness_s = staleness_s
        self.last_note = last_note
        note = f"; last report: {last_note!r}" if last_note else ""
        super().__init__(
            f"[stall-watchdog] component {component!r} silent for "
            f"{staleness_s:.1f}s (timeout {timeout_s:.1f}s){note} — "
            f"raising instead of hanging; check that component's thread "
            f"or its upstream queue")


class LockOrderError(RuntimeError):
    """Two code paths acquire the same locks in conflicting order."""


class LockOrderRecorder:
    """Witness-style lock-order graph with cycle detection.

    Keyed by lock *name* (not instance): every `WitnessLock` acquire
    adds edges held-name -> acquired-name, and an edge that makes the
    directed graph cyclic raises `LockOrderError` with both paths.
    Name-keying means all instances sharing a name collapse to one
    node — same-name edges (a -> a) are ignored rather than treated as
    recursive deadlock, so per-instrument leaf locks can share a name
    without false positives.
    """

    def __init__(self):
        self._mu = threading.Lock()
        # edges and the first acquisition site that created each edge
        self._edges: dict[str, set[str]] = {}
        self._sites: dict[tuple[str, str], str] = {}
        self._tls = threading.local()

    def _held(self) -> list[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _path(self, src: str, dst: str) -> list[str] | None:
        """DFS path src -> dst in the edge graph, or None."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def note_acquire(self, name: str, site: str = "") -> None:
        """Record held -> name edges; raises LockOrderError if any new
        edge closes a cycle. Called BEFORE blocking on the lock, so
        the conflicting order is reported instead of deadlocking."""
        held = self._held()
        if not held:
            return
        # Fast path: every held -> name edge is already recorded. An
        # edge only enters the graph after passing the cycle check, so
        # seeing it present (GIL-atomic dict reads) means this order
        # was already validated — skip the global mutex entirely.
        edges = self._edges
        if all(prior == name or name in edges.get(prior, ())
               for prior in held):
            return
        with self._mu:
            for prior in held:
                if prior == name or name in self._edges.get(prior, ()):
                    continue
                back = self._path(name, prior)
                if back is not None:
                    fwd = " -> ".join([prior, name])
                    rev = " -> ".join(back)
                    first = self._sites.get((back[0], back[1]), "")
                    where = f" (first seen: {first})" if first else ""
                    raise LockOrderError(
                        f"lock-order cycle: this thread holds "
                        f"{prior!r} and acquires {name!r} ({fwd}), but "
                        f"the recorded order already has {rev}{where} "
                        f"— two such threads interleaved would "
                        f"deadlock")
                self._edges.setdefault(prior, set()).add(name)
                self._sites.setdefault((prior, name), site)

    def push(self, name: str) -> None:
        self._held().append(name)

    def pop(self, name: str) -> None:
        held = self._held()
        # release order may differ from acquire order; drop the most
        # recent occurrence of this name
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._sites.clear()


_RECORDER = LockOrderRecorder()


def lock_witness_recorder() -> LockOrderRecorder:
    """The process-global recorder `make_lock` witnesses feed."""
    return _RECORDER


class WitnessLock:
    """threading.Lock wrapper that reports acquisition order to a
    LockOrderRecorder. Drop-in for plain `with lock:` / acquire /
    release use (no Condition/RLock semantics — the runtime uses
    neither)."""

    def __init__(self, name: str,
                 recorder: LockOrderRecorder | None = None):
        self.name = name
        self._lock = threading.Lock()
        self._recorder = recorder or _RECORDER

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        self._recorder.note_acquire(self.name)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._recorder.push(self.name)
        return ok

    def release(self) -> None:
        self._lock.release()
        self._recorder.pop(self.name)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "WitnessLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"WitnessLock({self.name!r})"


def make_lock(name: str):
    """Runtime lock factory: a plain threading.Lock in production, a
    WitnessLock feeding the global order recorder when
    APEX_LOCK_WITNESS is set (tests/conftest.py sets it, turning any
    lock-order inversion the suite merely *executes* into a
    deterministic LockOrderError)."""
    if os.environ.get("APEX_LOCK_WITNESS"):
        return WitnessLock(name)
    return threading.Lock()


class HeartbeatRegistry:
    """Thread-safe component -> (last_beat, note) table.

    `register` seeds the stamp so a component that never beats at all
    (wedged before its first loop iteration) is still attributed;
    `clear` removes a component that finished legitimately."""

    def __init__(self):
        self._lock = make_lock("health.heartbeats")
        self._beats: dict[str, tuple[float, str]] = {}  # guarded-by: _lock

    def register(self, name: str, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._beats.setdefault(name, (now, "registered"))

    def beat(self, name: str, note: str = "",
             now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._beats[name] = (now, note)

    def clear(self, name: str) -> None:
        with self._lock:
            self._beats.pop(name, None)

    def snapshot(self) -> dict[str, tuple[float, str]]:
        with self._lock:
            return dict(self._beats)

    def ages(self, now: float | None = None) -> dict[str, tuple[float, str]]:
        """component -> (age_s, last_note). The clock-domain-free view
        a fleet telemetry frame ships: an AGE survives the wire where
        an absolute monotonic stamp from another host would not — the
        receiver re-beats with `now = local_now - age_s` and the stall
        watchdog covers the remote component as if it were local."""
        now = time.monotonic() if now is None else now
        with self._lock:
            return {name: (max(now - t, 0.0), note)
                    for name, (t, note) in self._beats.items()}

    def stale(self, timeout_s: float, now: float | None = None
              ) -> list[tuple[str, float, str]]:
        """(component, staleness_s, last_note) for every component
        silent past timeout_s, stalest first."""
        now = time.monotonic() if now is None else now
        with self._lock:
            out = [(name, now - t, note)
                   for name, (t, note) in self._beats.items()
                   if now - t >= timeout_s]
        out.sort(key=lambda x: -x[1])
        return out


class HeartbeatWatchdog:
    """Poll-style watchdog over a HeartbeatRegistry: `check()` raises
    StallError for the stalest silent component. Lives in the caller's
    (alive) supervisory loop — the whole point is that the DRIVER
    thread still runs when a worker thread wedges, so the driver can
    convert the hang into an attributed error and tear down."""

    def __init__(self, registry: HeartbeatRegistry, timeout_s: float):
        assert timeout_s > 0
        self.registry = registry
        self.timeout_s = timeout_s

    def check(self, now: float | None = None) -> None:
        stale = self.registry.stale(self.timeout_s, now=now)
        if stale:
            name, staleness, note = stale[0]
            raise StallError(name, staleness, note,
                             timeout_s=self.timeout_s)


def _process_index() -> int:
    """This process's rank in the torch.distributed group (0 without
    one). Deferred import: the report and offline tools import this
    module without torch."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class StallWatchdog:
    """Surfaces collective hangs: a peer process dying mid-round leaves
    every survivor blocked inside a collective with no error (the
    failure domain of a process group). This host-local daemon watches
    a progress stamp the round loop bumps; after `timeout_s` of silence
    it emits a diagnostic (which process, how long, what the loop last
    reported), and after TWO consecutive silent windows calls `fatal`
    (default os._exit) so the job-level restart-from-checkpoint
    recovery triggers instead of the fleet hanging until a human or
    scheduler notices.

    Purely host-local: it never issues collectives, so it cannot
    perturb the lockstep call sequence."""

    def __init__(self, timeout_s: float, describe, fatal=None,
                 emit=None):
        """describe() -> str: host-local state for the diagnostic.
        fatal/emit injectable for tests."""
        self.timeout_s = timeout_s
        self._describe = describe
        self._fatal = fatal or (lambda code: os._exit(code))
        self._emit = emit or (lambda msg: print(msg, file=sys.stderr,
                                                flush=True))
        self._stamp = time.monotonic()
        self._stop = threading.Event()
        self._fired = 0
        self._thread = threading.Thread(target=self._watch,
                                        name="stall-watchdog",
                                        daemon=True)

    def start(self) -> None:
        if self.timeout_s > 0:
            self._thread.start()

    def stamp(self) -> None:
        self._stamp = time.monotonic()
        self._fired = 0

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)

    def _watch(self) -> None:
        poll = min(self.timeout_s / 4, 10.0)
        while not self._stop.wait(poll):
            silent = time.monotonic() - self._stamp
            if silent < self.timeout_s:
                continue
            self._fired += 1
            rank = _process_index()
            self._emit(
                f"[stall-watchdog] process {rank}: no "
                f"round progress for {silent:.0f}s (timeout "
                f"{self.timeout_s:.0f}s, strike {self._fired}/2) — a "
                f"peer process has likely died inside a collective. "
                f"State: {self._describe()}")
            if self._fired >= 2:
                self._emit(
                    f"[stall-watchdog] process {rank}: "
                    f"aborting so the job restarts from the latest "
                    f"checkpoint (the hung collective cannot be "
                    f"recovered in-process)")
                self._fatal(70)
                return
            self._stamp = time.monotonic()  # strike window restarts
