"""Multi-process learner support over torch.distributed.

Counterpart of ``ape_x_dqn_tpu/parallel/multihost.py``. There, every
learner process joins JAX's coordination service, builds ONE global
(dp, tp) mesh over all processes' devices and runs the same jitted
programs on globally sharded arrays; XLA inserts the cross-host
collectives (the gradient psum, the publication all-gather) into those
programs, on the device. Here every learner process joins a
``torch.distributed`` process group (`init_multihost`), holds its own
contiguous dp rows (`process_rows`) as a process-local mesh of its own
card, and makes the cross-process steps explicit:

- `global_stats`: ONE collective per round of the host-local control
  scalars (ingest readiness, idleness, frame counts). Every
  control-flow decision of the multi-host driver
  (runtime/multihost_driver.py) derives from it or from values every
  process computes alike, which keeps all processes' call sequences in
  lockstep: a process branching on a host-local value would leave the
  others waiting inside a collective.
- `global_min_scalar`: one collective for a one-off agreement (the
  checkpoint step every process can restore); `barrier`.
- `GradExchange`: the learner's one collective per SGD step
  (parallel/dist_learner.py packs its gradient, loss terms and IS
  max into one float32 vector; every process gets all of them, in rank
  order, and reduces them alike).

The group. On a card of a CUDA build with NCCL, `init_multihost` joins
ONE group whose CPU tensors go through gloo and whose CUDA tensors go
through NCCL (backend ``"cpu:gloo,cuda:nccl"``; NCCL's communicator is
made at its first collective). Elsewhere (``--device cpu``, a CPU-only
build) the group is gloo. The host collectives above all run over CPU
int64 tensors, so through gloo, whatever the placement.

The exchange has one mode for the whole group (`agreed_exchange_mode`,
one collective over every rank's count of processes on its card):

- ``"nccl"`` when EVERY rank runs on a card it has to itself: one
  ``all_gather_into_tensor`` from the caller's device tensor into its
  device output, on the caller's stream, with no host buffer and no
  host wait. A CUDA graph can hold it (`GradExchange.capturable`), so
  on the card an exchanged macro-step is ONE captured graph
  (runtime/step_graph.py: `ExchangedStep`), as the one-process
  learners' are, with each collective between one chunk's backward
  and the next chunk's update.
- ``"gloo"`` otherwise: ranks that share a card (NCCL refuses two ranks
  on one card) and the CPU. The vector is staged through pinned host
  buffers around a gloo all_gather, and the macro-step is captured as
  segments around it (`SegmentedStep`).

A mode chosen from a host-local value could leave one rank inside NCCL
and another inside gloo, deadlocked; hence the collective. There is no
fallback: when every rank is alone on its card, an NCCL that this build
lacks, a group without it, or a first collective that fails raises,
naming the cause, and the run does not go on over gloo.

There are no global arrays in torch, so the original's `make_global`
has no counterpart: each process keeps its [dp_local, ...] block, and
its dist learner holds dp_local replay shards.
"""

from __future__ import annotations

import datetime
import hashlib
import socket
import time

import torch
import torch.distributed as dist

# how long the rendezvous and each collective wait for the other ranks
TIMEOUT = datetime.timedelta(seconds=600)
# the exchange's modes (module docstring)
MODES = ("gloo", "nccl")

def group_backend(device: str | torch.device) -> str:
    """The backend `init_multihost` joins with for a process that runs
    on `device`: gloo for CPU tensors and NCCL for CUDA tensors when
    `device` is a card of a CUDA build with NCCL, else gloo alone."""
    if torch.device(device).type == "cuda" and torch.cuda.is_available() \
            and dist.is_nccl_available():
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   device: str | torch.device = "cuda") -> None:
    """Join the process group at ``tcp://<coordinator>`` (HOST:PORT) as
    rank `process_id` of `num_processes`, over `group_backend(device)`.
    Must run before the learner is built (the CLI calls it first)."""
    dist.init_process_group(
        group_backend(device), init_method=f"tcp://{coordinator}",
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


def _gather_ints(values: list[int]) -> torch.Tensor:
    """Every process's int64 `values` -> [nproc, len] in rank order (one
    all_gather of a CPU tensor, so through gloo; the identity in one
    process)."""
    local = torch.tensor(values, dtype=torch.int64)
    if not initialized():
        return local[None]
    out = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(out, local)
    return torch.stack(out)


def _device_key(device: torch.device) -> int:
    """A 56-bit digest naming `device`'s card (its UUID) or host (the
    CPU counts as one device per host)."""
    if device.type == "cuda":
        key = str(torch.cuda.get_device_properties(device).uuid)
    else:
        key = f"cpu@{socket.gethostname()}"
    return int.from_bytes(hashlib.sha256(key.encode()).digest()[:7], "big")


def processes_on_device(device: torch.device) -> int:
    """How many of the group's processes run on `device`'s card (this
    one included): a one-off gather of each card's digest. 1 without a
    group."""
    keys = _gather_ints([_device_key(torch.device(device))])[:, 0]
    return int((keys == keys[process_index()]).sum())


def agreed_exchange_mode(on_card: bool, processes_on_card: int) -> str:
    """The exchange's mode for the whole group, from ONE collective:
    "nccl" when every rank runs on a card (`on_card`) that it has to
    itself (`processes_on_card` 1), else "gloo" (module docstring)."""
    rows = _gather_ints([int(on_card), int(processes_on_card)])
    alone = bool(rows[:, 0].min() == 1 and rows[:, 1].max() == 1)
    return "nccl" if alone else "gloo"


def global_min_scalar(value: int) -> int:
    """Min of each process's integer scalar: a one-off agreement value
    outside the hot loop (which checkpoint step every process can
    restore; min handles a host whose filesystem lacks the files)."""
    return int(_gather_ints([int(value)])[:, 0].min())


def barrier() -> None:
    """Wait until every process gets here (one host collective)."""
    _gather_ints([0])


def global_stats(ready: float, idle: float,
                 frames: float) -> tuple[bool, bool, float]:
    """One per-round collective: (all_ready, all_idle, frames_total).
    The lanes are int64, so frame counts stay exact (the original packs
    int32 limbs for the same reason); the flags reduce by min, the frame
    counts by sum."""
    rows = _gather_ints([int(ready), int(idle), int(frames)])
    mins = rows.min(dim=0).values
    return bool(mins[0] >= 1), bool(mins[1] >= 1), float(rows[:, 2].sum())


def _require_nccl(device) -> torch.device:
    """The device exchange's preconditions; each missing one raises,
    naming it (no fallback to gloo)."""
    why = "the NCCL exchange (every rank alone on its card) was asked for"
    if not dist.is_nccl_available():
        raise RuntimeError(f"{why}, but this torch build has no NCCL "
                           f"(torch.distributed.is_nccl_available() is "
                           f"False); not falling back to gloo")
    backend = str(dist.get_backend())
    if "nccl" not in backend:
        raise RuntimeError(f"{why}, but the process group's backend is "
                           f"{backend!r}; join it with init_multihost on "
                           f"the card; not falling back to gloo")
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"{why} on {device}: it needs a CUDA device")
    return device


class GradExchange:
    """The dist learner's per-SGD-step collective: this process's packed
    float32 vector `send` ([L], on its device) -> every process's, [nproc,
    L] in rank order, written into `out` (a fresh device tensor when
    None), in one of the module docstring's two modes.

    "gloo": a copy into a pinned host buffer on the caller's stream, a
    wait for that stream, one gloo all_gather into a pinned [nproc, L]
    buffer, and a copy back on the caller's stream (ordered before
    whatever the caller enqueues next; the next exchange's wait covers
    it before the buffers are rewritten). On the CPU the same calls,
    without pinning. Each call's host seconds are counted: waiting for
    the device before the collective, and inside it.

    "nccl": one all_gather_into_tensor on the caller's stream (`device`
    is the card; the constructor makes NCCL's communicator with one
    small collective, so none is made inside a capture). Called while
    a CUDA graph captures, the collective is recorded, not run, and not
    counted here: the graph counts the calls it replays
    (runtime/step_graph.py: `ExchangedStep`). Host seconds mean nothing
    inside a replayed graph, so this mode times nothing; chip_smoke.py
    (`nccl_probe`) measures the collective's device time and NCCL's
    memory apart.

    Both count the calls and the bytes each process sends and
    receives."""

    def __init__(self, mode: str = "gloo",
                 device: str | torch.device | None = None):
        if mode not in MODES:
            raise ValueError(f"exchange mode {mode!r} is not one of {MODES}")
        self.mode = mode
        self.nproc = dist.get_world_size()
        # a CUDA graph can hold the collective (module docstring)
        self.capturable = mode == "nccl"
        self._send: torch.Tensor | None = None
        self._recv: torch.Tensor | None = None
        self.reset()
        if mode == "nccl":
            self._make_communicator(_require_nccl(device))

    def _make_communicator(self, device: torch.device) -> None:
        x = torch.zeros(1, device=device)
        out = torch.empty(self.nproc, device=device)
        try:
            dist.all_gather_into_tensor(out, x)
            torch.cuda.synchronize(device)
        except RuntimeError as e:   # torch.distributed.DistBackendError too
            raise RuntimeError(f"NCCL's first collective failed on "
                               f"{device}: {e}; not falling back to "
                               f"gloo") from e

    def _buffers(self, send: torch.Tensor) -> None:
        n = send.numel()
        if self._send is None or self._send.numel() != n:
            pin = send.device.type == "cuda"
            self._send = torch.empty(n, dtype=torch.float32, pin_memory=pin)
            self._recv = torch.empty((self.nproc, n), dtype=torch.float32,
                                     pin_memory=pin)

    def __call__(self, send: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
        """-> `out` holding [nproc, L]."""
        if out is None:
            out = torch.empty((self.nproc, send.numel()),
                              dtype=torch.float32, device=send.device)
        if self.mode == "nccl":
            dist.all_gather_into_tensor(out, send)
            if not torch.cuda.is_current_stream_capturing():
                self.count([send.numel()])
            return out
        self._buffers(send)
        cuda = send.device.type == "cuda"
        t0 = time.perf_counter()
        self._send.copy_(send, non_blocking=cuda)
        if cuda:
            torch.cuda.current_stream(send.device).synchronize()
        t1 = time.perf_counter()
        dist.all_gather(list(self._recv.unbind(0)), self._send)
        t2 = time.perf_counter()
        out.copy_(self._recv, non_blocking=cuda)
        self.count([send.numel()])
        self.wait_s += t1 - t0
        self.collective_s += t2 - t1
        return out

    def count(self, sizes: list[int]) -> None:
        """Count calls of `sizes` elements each (a replayed graph adds
        the calls it recorded)."""
        for n in sizes:
            self.calls += 1
            self.bytes_sent += n * 4
            self.bytes_received += self.nproc * n * 4

    def reset(self) -> None:
        """Restart the counts (after a warm-up)."""
        self.calls = self.bytes_sent = self.bytes_received = 0
        self.wait_s = self.collective_s = 0.0

    def stats(self) -> dict:
        out = {"calls": self.calls, "bytes_sent": self.bytes_sent,
               "bytes_received": self.bytes_received,
               "processes": self.nproc, "backend": self.mode}
        if self.mode == "gloo":
            out.update(wait_s=self.wait_s, collective_s=self.collective_s,
                       timing="host clock around every call")
        else:
            out.update(timing="none: the calls a replayed graph makes are "
                              "counted, not timed (chip_smoke.py: "
                              "nccl_probe times the collective alone)")
        return out
