"""Transport layer: actor -> replay ingest and learner -> actor params.

Counterpart of ``ape_x_dqn_tpu/comm/transport.py``. In one process the
actors, the inference server and the learner talk through thread-safe
queues (`LoopbackTransport`); remote actor hosts reach the learner
through comm/socket_transport.py (``--listen``). Both carry fleet
telemetry: `send_telemetry(frame)` ships a compact per-peer obs
snapshot, and the driver's fleet aggregator (obs/fleet.py) installs
itself as the receiving side's `on_telemetry(peer_id, frame)` hook. On
loopback the frame goes to the hook directly.

Messages are dicts of numpy arrays; an ingest message holds stacked
transition fields (or frame segments) plus "priorities", and the
actor's "actor" and "frames" scalars.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Protocol

import numpy as np

from ape_x_dqn_tpu_torch.comm.socket_transport import WireBatch


class Transport(Protocol):
    def send_experience(self, batch: dict) -> None: ...
    def recv_experience(self, timeout: float | None = None) -> dict | None: ...
    def publish_params(self, params: Any, version: int) -> None: ...
    def get_params(self) -> tuple[Any, int]: ...
    def send_telemetry(self, frame: dict) -> bool: ...


class LoopbackTransport:
    """In-process transport: bounded queue + versioned param cell."""

    def __init__(self, max_pending: int = 64):
        self._q: queue.Queue[dict] = queue.Queue(maxsize=max_pending)
        self._params: Any = None
        self._version = -1
        self._lock = threading.Lock()
        self._dropped = 0
        self._telemetry_frames = 0
        # fleet hook (set by the driver); called inline from the sender
        self.on_telemetry: Any = None  # (peer_id: str, frame: dict) -> None

    # experience path (actor -> replay ingest)

    def send_experience(self, batch: dict) -> None:
        """Non-blocking; drops the oldest batch under backpressure and
        counts it (actors never stall the env loop: Ape-X replay ingest
        is lossy-tolerant)."""
        while True:
            try:
                self._q.put_nowait(batch)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()
                    self._dropped += 1
                except queue.Empty:
                    pass

    def recv_experience(self, timeout: float | None = None) -> dict | None:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    @property
    def dropped(self) -> int:
        return self._dropped

    @property
    def pending(self) -> int:
        return self._q.qsize()

    def close(self) -> None:
        """Drain parked batches so their arrays are not pinned by a
        queue nobody will read again."""
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    # parameter path (learner -> actors/server)

    def publish_params(self, params: Any, version: int) -> None:
        with self._lock:
            self._params = params
            self._version = version

    def get_params(self) -> tuple[Any, int]:
        with self._lock:
            return self._params, self._version

    # telemetry path (peer obs snapshots -> fleet aggregator)

    def send_telemetry(self, frame: dict) -> bool:
        """In-process delivery straight to the aggregator hook; True
        iff a hook was installed (the socket transport returns whether
        the peer negotiated telemetry)."""
        cb = self.on_telemetry
        if cb is None:
            return False
        with self._lock:
            self._telemetry_frames += 1
        cb(str(frame.get("peer", "peer?")), frame)
        return True

    @property
    def telemetry_frames(self) -> int:
        with self._lock:
            return self._telemetry_frames


def batch_rows(batch) -> int:
    """Staging units in one ingest message, cheap for both forms: a
    WireBatch reads its JSON header, a dict the length of its
    priorities (``comm/socket_transport.py: batch_rows``)."""
    if isinstance(batch, WireBatch):
        return batch.rows
    return int(np.shape(batch["priorities"])[0])
