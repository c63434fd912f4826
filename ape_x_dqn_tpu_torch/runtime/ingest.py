"""Pipelined ingest staging (actor batches -> device replay).

Counterpart of ``ape_x_dqn_tpu/runtime/ingest.py``. Preallocated,
fixed-shape staging buffers replace per-batch list appends:

- Each ingest message lands with ONE copy into a contiguous staging
  row at a write cursor: a dict batch (local actors) by slice
  assignment, a `WireBatch` from the socket transport by
  ``decode_into`` straight out of the received payload (inflate and
  delta-undo in the staging rows, no intermediate arrays). A
  `ShmSlotBatch` hands its shared-memory slot back once its bytes are
  in staging.
- Double buffering: while buffer N's host-to-device copy is in flight,
  the next batches land in buffer N+1; the stager waits on buffer N's
  copy only when it is about to overwrite that memory.
- Coalescing: a buffer holds `coalesce` fixed-size blocks, and a FULL
  buffer ships as one `add_many` under one acquisition of the driver's
  state lock instead of g small adds interleaving with train_many.

On CUDA the buffers are PINNED host tensors, written through their
``.numpy()`` views, so the ship callback's copies run asynchronously
(``non_blocking=True``); the callback returns a ``torch.cuda.Event``
recorded after them, and `_wait` synchronises on it before the memory
is rewritten. A pinned buffer rewritten before its copy has landed
would corrupt the replay silently: that wait is the guard. On the CPU
nothing is pinned and nothing is waited on (the callback consumes the
buffer before it returns, and returns no handles).

Latency bound: the driver calls drain() whenever the transport queue
runs dry, which ships every COMPLETE block of the partial buffer
block by block and compacts the remainder to the buffer front, so
coalescing never holds experience hostage behind a slow actor stream.
The sub-block tail drops (counted by the driver) only at the
force-flush of teardown.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

# ship(views, g): views is {key: host tensor of [g*block_units, ...]}
# including "priorities"; g is the number of coalesced blocks. Returns
# the handles (CUDA events) of the asynchronous host-to-device copies;
# the stager waits on them before reusing the staging memory.
ShipFn = Callable[[dict, int], list]


class IngestStager:
    def __init__(self, item_spec: dict, ptail: tuple, block_units: int,
                 coalesce: int, buffers: int, ship: ShipFn,
                 pin: bool = False):
        """item_spec: {key: ItemSpec (shape, torch dtype)} for one
        staging unit; ptail: trailing priority axes ((seg_transitions,)
        in frame-ring mode, () otherwise); block_units: units per device
        add; coalesce: blocks fused per full-buffer add_many; buffers:
        staging buffers to rotate (>= 2 overlaps landing with the
        copy); pin: allocate page-locked buffers (the CUDA path)."""
        self.block = int(block_units)
        self.coalesce = max(int(coalesce), 1)
        self.rows = self.block * self.coalesce
        self.nb = max(int(buffers), 1)
        self._ship = ship
        self._keys = tuple(item_spec.keys()) + ("priorities",)
        shapes = {k: tuple(s.shape) for k, s in item_spec.items()}
        dtypes = {k: s.dtype for k, s in item_spec.items()}
        shapes["priorities"] = tuple(ptail)
        dtypes["priorities"] = torch.float32
        # the tensors (what ships) and their numpy views (what lands)
        self._tbufs = [
            {k: torch.zeros((self.rows,) + shapes[k], dtype=dtypes[k],
                            pin_memory=pin)
             for k in self._keys}
            for _ in range(self.nb)]
        self._bufs = [{k: t.numpy() for k, t in tb.items()}
                      for tb in self._tbufs]
        self._inflight: list[list] = [[] for _ in range(self.nb)]
        self._active = 0
        self._cursor = 0  # rows staged in the active buffer
        # cumulative / last wall-ms spent landing batches (the one copy)
        self.decode_ms = 0.0
        self.last_put_decode_ms = 0.0
        # host wall-ms inside the ship callback (copy enqueue + the add
        # under the state lock; not device time)
        self.ship_ms = 0.0
        self.last_ship_ms = 0.0

    # -- write side --------------------------------------------------------

    def _wait(self, i: int) -> None:
        """Block until buffer i's previous host-to-device copy has
        landed: only then may its host memory be rewritten. With >= 2
        buffers this rarely waits (the copy overlapped the other
        buffer's landing)."""
        if self._inflight[i]:
            for ev in self._inflight[i]:
                ev.synchronize()
            self._inflight[i] = []

    def put(self, batch) -> None:
        """Stage one ingest message (a WireBatch or a dict of arrays),
        splitting across buffer boundaries; full buffers ship as one
        coalesced add_many."""
        wire = hasattr(batch, "decode_into")
        total = batch.rows if wire \
            else int(np.shape(batch["priorities"])[0])
        start = 0
        put_ms = 0.0
        while start < total:
            self._wait(self._active)
            buf = self._bufs[self._active]
            k = min(total - start, self.rows - self._cursor)
            t0 = time.perf_counter()
            if wire:
                batch.decode_into(buf, self._cursor, start, k)
            else:
                for key in self._keys:
                    buf[key][self._cursor:self._cursor + k] = \
                        np.asarray(batch[key])[start:start + k]
            put_ms += (time.perf_counter() - t0) * 1e3
            self._cursor += k
            start += k
            if self._cursor == self.rows:
                self._ship_buffer()
        self.last_put_decode_ms = put_ms
        self.decode_ms += put_ms
        # a shm slot batch aliases a shared-memory ring slot: its bytes
        # are in staging now, so the slot goes back to the writer
        rel = getattr(batch, "release", None)
        if rel is not None:
            rel()

    def _ship_buffer(self) -> None:
        """Full buffer -> one add_many; rotate to the next buffer while
        the copy flies."""
        tbuf = self._tbufs[self._active]
        t0 = time.perf_counter()
        self._inflight[self._active] = list(
            self._ship({k: tbuf[k] for k in self._keys}, self.coalesce))
        self.last_ship_ms = (time.perf_counter() - t0) * 1e3
        self.ship_ms += self.last_ship_ms
        self._active = (self._active + 1) % self.nb
        self._cursor = 0

    # -- drain / teardown --------------------------------------------------

    def drain(self) -> int:
        """Ship every COMPLETE block of the partial active buffer, one
        block per add. Remainder rows compact to the buffer front.
        Called by the driver whenever the transport queue runs dry, so
        coalescing costs bounded latency. Returns blocks shipped."""
        nblocks = self._cursor // self.block
        if nblocks == 0:
            return 0
        tbuf = self._tbufs[self._active]
        buf = self._bufs[self._active]
        shipped = nblocks * self.block
        handles: list = []
        t0 = time.perf_counter()
        for b in range(nblocks):
            views = {k: tbuf[k][b * self.block:(b + 1) * self.block]
                     for k in self._keys}
            handles += list(self._ship(views, 1))
        self.last_ship_ms = (time.perf_counter() - t0) * 1e3
        self.ship_ms += self.last_ship_ms
        rem = self._cursor - shipped
        if rem:
            # the shipped region becomes the compaction destination:
            # wait for its copies before overwriting. Non-overlapping
            # copy: rem < block <= shipped.
            for ev in handles:
                ev.synchronize()
            for k in self._keys:
                buf[k][:rem] = buf[k][shipped:self._cursor]
        else:
            self._inflight[self._active] = handles
        self._cursor = rem
        return nblocks

    def tail_units(self) -> int:
        """Staged rows that cannot form a complete block (valid after
        drain()); the driver's force-flush drop accounting reads it."""
        return self._cursor

    def tail_view(self, key: str) -> np.ndarray:
        """View of the staged sub-block tail for `key` (frame-ring drop
        accounting counts live transitions through next_off)."""
        return self._bufs[self._active][key][:self._cursor]

    def tail_shard_units(self, dp: int) -> list[int]:
        """Unit count of the sub-block tail per dp shard under a
        [dp, chunk] block split (chunk = block // dp): tail unit i would
        have landed on shard i // chunk."""
        chunk = self.block // max(dp, 1)
        tail = self.tail_units()
        return [max(0, min(tail - d * chunk, chunk)) for d in range(dp)]

    def discard_tail(self) -> None:
        self._cursor = 0

    def occupancy(self) -> float:
        """Fill fraction of the active staging buffer."""
        return self._cursor / self.rows
