"""Multi-process learner support over torch.distributed.

Counterpart of ``ape_x_dqn_tpu/parallel/multihost.py``. There, every
learner process joins JAX's coordination service, builds ONE global
(dp, tp) mesh over all processes' devices and runs the same jitted
programs on globally sharded arrays; XLA inserts the cross-host
collectives. Here every learner process joins a ``torch.distributed``
process group (`init_multihost`), holds its own contiguous dp rows
(`process_rows`) as a process-local mesh of its own card, and makes the
cross-process steps explicit:

- `global_stats`: ONE collective per round of the host-local control
  scalars (ingest readiness, idleness, frame counts). Every
  control-flow decision of the multi-host driver
  (runtime/multihost_driver.py) derives from it or from values every
  process computes alike, which keeps all processes' call sequences in
  lockstep: a process branching on a host-local value would leave the
  others waiting inside a collective.
- `global_min_scalar`: one collective for a one-off agreement (the
  checkpoint step every process can restore).
- `GradExchange`: the learner's one collective per SGD step
  (parallel/dist_learner.py packs its gradient, loss terms and IS
  max into one float32 vector; every process gets all of them, in rank
  order, and reduces them alike).

The backend is gloo for every collective, on the CPU and on the card
alike: a card's tensors are staged explicitly through pinned host
buffers, so the code path is one. (NCCL refuses two ranks on one card,
the placement one card forces; NCCL over distinct cards is ROADMAP
Queue A item 6.)

There are no global arrays in torch, so the original's `make_global`
has no counterpart: each process keeps its [dp_local, ...] block, and
its dist learner holds dp_local replay shards.
"""

from __future__ import annotations

import datetime
import socket
import time

import torch
import torch.distributed as dist

BACKEND = "gloo"
# how long the rendezvous and each collective wait for the other ranks
TIMEOUT = datetime.timedelta(seconds=600)


def init_multihost(coordinator: str, num_processes: int,
                   process_id: int) -> None:
    """Join the process group at ``tcp://<coordinator>`` (HOST:PORT) as
    rank `process_id` of `num_processes`, over gloo. Must run before the
    learner is built (the CLI calls it first)."""
    dist.init_process_group(
        BACKEND, init_method=f"tcp://{coordinator}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=TIMEOUT)


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def process_rows(dp: int) -> tuple[int, int]:
    """[start, stop) of the global mesh's `dp` rows that this process
    owns: contiguous, rank-ordered. The port's mesh is process-local
    (parallel/mesh.py: this process's dp_local x tp rows on its own
    card), so the global row count comes from the config."""
    nproc = process_count()
    rows_per_proc = dp // nproc
    assert rows_per_proc * nproc == dp, \
        f"dp={dp} must divide by process count {nproc}"
    start = process_index() * rows_per_proc
    return start, start + rows_per_proc


def local_device(device: str | torch.device) -> torch.device:
    """The card this process runs on: `device` as given when it names
    an index (or is not CUDA), else card rank % the visible cards (on
    one card every rank takes cuda:0)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None \
            and torch.cuda.is_available():
        return torch.device("cuda", process_index()
                            % torch.cuda.device_count())
    return device


def processes_on_device(device: torch.device) -> int:
    """How many of the group's processes run on `device`'s card (this
    one included): a one-off all_gather of the card's UUID (the CPU
    counts as one device per host). 1 without a group."""
    if not initialized():
        return 1
    device = torch.device(device)
    if device.type == "cuda":
        key = str(torch.cuda.get_device_properties(device).uuid)
    else:
        key = f"cpu@{socket.gethostname()}"
    keys: list = [None] * dist.get_world_size()
    dist.all_gather_object(keys, key)
    return keys.count(key)


def _gather_ints(values: list[int]) -> torch.Tensor:
    """Every process's int64 `values` -> [nproc, len] in rank order (one
    all_gather; the identity in one process)."""
    local = torch.tensor(values, dtype=torch.int64)
    if not initialized():
        return local[None]
    out = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(out, local)
    return torch.stack(out)


def global_min_scalar(value: int) -> int:
    """Min of each process's integer scalar: a one-off agreement value
    outside the hot loop (which checkpoint step every process can
    restore; min handles a host whose filesystem lacks the files)."""
    return int(_gather_ints([int(value)])[:, 0].min())


def global_stats(ready: float, idle: float,
                 frames: float) -> tuple[bool, bool, float]:
    """One per-round collective: (all_ready, all_idle, frames_total).
    The lanes are int64, so frame counts stay exact (the original packs
    int32 limbs for the same reason); the flags reduce by min, the frame
    counts by sum."""
    rows = _gather_ints([int(ready), int(idle), int(frames)])
    mins = rows.min(dim=0).values
    return bool(mins[0] >= 1), bool(mins[1] >= 1), float(rows[:, 2].sum())


class GradExchange:
    """The dist learner's per-SGD-step collective: this process's packed
    float32 vector `send` ([L], on its device) -> every process's, [nproc,
    L] in rank order, written into `out` on the device.

    On the card: a copy into a pinned host buffer on the caller's
    stream, a wait for that stream, one gloo all_gather into a pinned
    [nproc, L] buffer, and a copy back on the caller's stream (ordered
    before whatever the caller enqueues next; the next exchange's wait
    covers it before the buffers are rewritten). On the CPU the same
    calls, without pinning. Counts the calls, the bytes each process
    sends and receives, the seconds spent waiting for the device before
    the collective and the seconds inside it."""

    def __init__(self):
        self.nproc = dist.get_world_size()
        self._send: torch.Tensor | None = None
        self._recv: torch.Tensor | None = None
        self.calls = 0
        self.bytes_sent = 0
        self.bytes_received = 0
        self.wait_s = 0.0
        self.collective_s = 0.0

    def _buffers(self, send: torch.Tensor) -> None:
        n = send.numel()
        if self._send is None or self._send.numel() != n:
            pin = send.device.type == "cuda"
            self._send = torch.empty(n, dtype=torch.float32, pin_memory=pin)
            self._recv = torch.empty((self.nproc, n), dtype=torch.float32,
                                     pin_memory=pin)

    def __call__(self, send: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
        """-> `out` (a fresh device tensor when None) holding [nproc, L]."""
        self._buffers(send)
        cuda = send.device.type == "cuda"
        t0 = time.perf_counter()
        self._send.copy_(send, non_blocking=cuda)
        if cuda:
            torch.cuda.current_stream(send.device).synchronize()
        t1 = time.perf_counter()
        dist.all_gather(list(self._recv.unbind(0)), self._send)
        t2 = time.perf_counter()
        if out is None:
            out = torch.empty((self.nproc, send.numel()),
                              dtype=torch.float32, device=send.device)
        out.copy_(self._recv, non_blocking=cuda)
        self.calls += 1
        self.bytes_sent += self._send.numel() * 4
        self.bytes_received += self._recv.numel() * 4
        self.wait_s += t1 - t0
        self.collective_s += t2 - t1
        return out

    def reset(self) -> None:
        """Restart the counts (after a warm-up)."""
        self.calls = self.bytes_sent = self.bytes_received = 0
        self.wait_s = self.collective_s = 0.0

    def stats(self) -> dict:
        return {"calls": self.calls, "bytes_sent": self.bytes_sent,
                "bytes_received": self.bytes_received,
                "wait_s": self.wait_s, "collective_s": self.collective_s,
                "processes": self.nproc, "backend": BACKEND}
