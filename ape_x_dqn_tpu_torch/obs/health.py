"""Lock-order witness: the runtime's lock factory.

Counterpart of the part of ``ape_x_dqn_tpu/obs/health.py`` the
transports need: `make_lock`, `WitnessLock` and `LockOrderRecorder`.
Every transport lock is built through ``make_lock("owner.name")``; in
production that is a plain ``threading.Lock`` with no overhead, but
under ``APEX_LOCK_WITNESS=1`` (tests/conftest.py sets it) each
acquisition is recorded into a process-global lock-ORDER graph, and an
acquisition that closes a cycle raises `LockOrderError` at once: a
deadlock that needs a precise two-thread interleave to bite becomes a
deterministic failure on the first test whose code path merely acquires
in the conflicting order. The heartbeat registry and the stall
watchdogs of the original module belong to the operations planes
(ROADMAP Queue A item 19).
"""

from __future__ import annotations

import os
import threading


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
