"""Batched inference server on the card for actor policy evaluation.

Counterpart of the single-policy half of
``ape_x_dqn_tpu/parallel/inference_server.py`` (``BatchedInferenceServer``).
Many actor threads send observations to one server thread, which pads
them into a power-of-two bucket, runs one forward on the device and
scatters the results back.

Dynamic batching: the server collects requests until `max_batch` ITEMS
are waiting or the oldest has waited `deadline_ms`. A vector actor's
K-item request fills K slots of the budget; a request that would
overflow it is HELD (never split) for a later batch, in arrival order,
and a single request larger than the budget serves alone. Batches pad
to the next power of two, which bounds the set of shapes cuDNN sees
(a later change can capture one CUDA graph per bucket).

Requests are numpy arrays (or dicts of them): one item without a batch
dim (`query`), or n items with a leading [n] dim (`query_batch`). On
CUDA each batch is assembled in a pinned host buffer per bucket and
moves with one non-blocking host-to-device copy; the reply is one
device-to-host copy, which is the batch's one synchronisation (the
reply needs it anyway) and also guarantees the pinned buffer is free
before the next batch rewrites it.

The forward is ``apply_fn(params, batch)`` under
``torch.inference_mode()``; `update_params` swaps the server's own
param dict under the lock. The server never shares tensors with the
learner: the learner's ``publish_params`` hands over copies.

The mesh-sharded mode waits for the multi-GPU slice (ROADMAP Queue A
item 14), and the multi-tenant serving tier (``MultiPolicyInferenceServer``,
``TenantClient``, ``build_serving_tier``) for item 16.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from ape_x_dqn_tpu_torch.obs.core import NULL_OBS
from ape_x_dqn_tpu_torch.utils.misc import next_pow2, resolve_device


def _tree_map(fn: Callable, tree):
    """fn over the leaves of a request or reply: an array, or a flat
    dict of arrays."""
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return fn(tree)


class _Request:
    __slots__ = ("inputs", "n", "event", "result", "t_enq")

    def __init__(self, inputs: Any, n: int = 0):
        """n == 0: a single item, no batch dim on any leaf. n >= 1: a
        multi-item request whose leaves carry a leading [n] batch dim
        (vector actors send one request per vector step)."""
        self.inputs = inputs
        self.n = n
        self.event = threading.Event()
        self.result: Any = None
        self.t_enq = time.perf_counter()  # serving latency anchor

    @property
    def items(self) -> int:
        return self.n if self.n else 1


class BatchedInferenceServer:
    def __init__(self, apply_fn: Callable, params: Any,
                 max_batch: int = 64, deadline_ms: float = 2.0,
                 mesh: Any = None, obs: Any = None,
                 device: str | torch.device = "cuda"):
        """apply_fn(params, batched inputs) -> batched outputs (tensors,
        or a dict of them). device: where the forward runs (a CUDA
        request without a card raises). obs: the observability facade
        (NULL_OBS when omitted)."""
        if mesh is not None:
            raise NotImplementedError(
                "a mesh-sharded inference server is not ported to the "
                "PyTorch package yet: it waits for the multi-GPU slice "
                "(ROADMAP Queue A item 14)")
        self.device = resolve_device(device)
        self._pinned = self.device.type == "cuda"
        self._apply = apply_fn
        self._params = params  # guarded-by: _lock
        self._params_version = 0  # guarded-by: _lock
        self._max_batch = max_batch
        self._deadline_s = deadline_ms / 1000.0
        self._q: queue.Queue[_Request] = queue.Queue()
        # popped-but-not-admitted requests (would overflow max_batch),
        # held in arrival order for later batches; serve thread only
        self._held: deque[_Request] = deque()
        # pinned staging buffers, one per (leaf, bucket); serve thread
        # only (warmup runs before traffic)
        self._staging: dict[tuple, torch.Tensor] = {}
        self._stop = threading.Event()
        # _lock guards the published params (swapped by the learner
        # thread, read by the serve thread) and the served-stat counters
        self._lock = threading.Lock()
        self._batches_served = 0  # guarded-by: _lock
        self._items_served = 0  # guarded-by: _lock
        self._obs = obs if obs is not None else NULL_OBS
        self._obs.register("inference-server")
        self._thread = threading.Thread(target=self._serve_loop,
                                        name="inference-server", daemon=True)
        self._thread.start()

    # -- client side -------------------------------------------------------

    def query(self, inputs: Any, timeout: float = 60.0) -> Any:
        """Blocking single-item query; inputs carry no batch dim."""
        req = _Request(inputs)
        self._q.put(req)
        if not req.event.wait(timeout):
            raise TimeoutError("inference server did not reply")
        if isinstance(req.result, Exception):
            raise req.result
        return req.result

    def query_batch(self, inputs: Any, n: int, timeout: float = 60.0) -> Any:
        """Blocking multi-item query: every leaf of `inputs` carries a
        leading [n] batch dim, and so do the reply's. One request per
        vector-actor step: K observations ride one queue entry and one
        scatter instead of K."""
        assert n >= 1
        req = _Request(inputs, n)
        self._q.put(req)
        if not req.event.wait(timeout):
            raise TimeoutError("inference server did not reply")
        if isinstance(req.result, Exception):
            raise req.result
        return req.result

    def warmup(self, example_input: Any,
               extra_sizes: tuple[int, ...] = ()) -> None:
        """One forward per bucket a request can land in (every pow2
        request size up to max_batch, plus `extra_sizes`, e.g. the
        vector actors' envs_per_actor), before actors start querying:
        it allocates the pinned buffers and the device workspace and
        initialises the cuDNN/cuBLAS handles. Nothing compiles in the
        port; the forward changes no state. example_input: one request
        WITHOUT the batch dim (only shapes and dtypes matter)."""
        for b in sorted(_pow2_bucket_sizes(self._bucket, self._max_batch,
                                           extra_sizes)):
            zeros = _tree_map(
                lambda x: np.zeros((b, *np.shape(x)), np.asarray(x).dtype),
                example_input)
            self._forward(self._stack([zeros], b))

    # -- learner side ------------------------------------------------------

    def update_params(self, params: Any, version: int) -> None:
        with self._lock:
            self._params = params
            self._params_version = version

    @property
    def params_version(self) -> int:
        with self._lock:
            return self._params_version

    @property
    def queue_depth(self) -> int:
        """Requests waiting now (the eval worker shares this server with
        the actors, and the driver logs the depth around evals)."""
        return self._q.qsize()

    @property
    def stats(self) -> dict:
        with self._lock:
            return {"batches": self._batches_served,
                    "items": self._items_served,
                    "avg_batch": (self._items_served
                                  / max(self._batches_served, 1))}

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    # -- server loop -------------------------------------------------------

    def _collect(self) -> list[_Request]:
        # max_batch counts ITEMS, not requests. A request that would
        # overflow the budget is HELD for a later batch (never split); a
        # single oversized request still serves alone (its bucket is
        # warmed through extra_sizes). Holding is not a barrier: held
        # requests keep arrival order while collection keeps admitting
        # smaller requests that fit.
        reqs: list[_Request] = []
        items = 0
        kept: deque[_Request] = deque()
        while self._held:
            r = self._held.popleft()
            if (items + r.items <= self._max_batch
                    or (not reqs and r.items >= self._max_batch)):
                reqs.append(r)
                items += r.items
            else:
                kept.append(r)
        self._held = kept
        if not reqs:
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                return []
            reqs.append(first)
            items = first.items
        deadline = time.monotonic() + self._deadline_s
        while items < self._max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                r = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if items + r.items > self._max_batch:
                self._held.append(r)
                continue
            reqs.append(r)
            items += r.items
        return reqs

    def _serve_loop(self) -> None:
        while not self._stop.is_set():
            reqs = self._collect()
            if not reqs:
                # an idle but polling server is alive, not stalled
                self._obs.beat("inference-server", "idle")
                continue
            try:
                self._serve_batch(reqs)
            except Exception as e:  # propagate to callers, keep serving
                self._obs.blackbox.record(
                    "serve_error", component="inference-server",
                    error=repr(e)[:200])
                for r in reqs:
                    r.result = e
                    r.event.set()

    def _bucket(self, n: int) -> int:
        """Padded batch size: the next power of two."""
        return next_pow2(max(n, 1))

    def _stack(self, leads: list, padded: int) -> Any:
        """Requests' inputs (each an array, or a flat dict of arrays,
        with a leading batch dim) -> one padded device batch of the same
        form."""
        if isinstance(leads[0], dict):
            return {k: self._stage(k, [r[k] for r in leads], padded)
                    for k in leads[0]}
        return self._stage(None, leads, padded)

    def _stage(self, leaf: str | None, xs: list,
               padded: int) -> torch.Tensor:
        """Concatenate one leaf's request arrays and zero-pad to
        `padded` rows, on the server's device: through the leaf's own
        pinned buffer and one non-blocking copy on CUDA (two leaves of
        one shape must not share a buffer: the second would overwrite
        the first before its copy lands), as a host tensor on the
        CPU."""
        if not self._pinned:
            return torch.from_numpy(_pad_concat(xs, padded))
        arrs = [np.asarray(x) for x in xs]
        key = (leaf, padded, arrs[0].shape[1:], arrs[0].dtype.str)
        buf = self._staging.get(key)
        if buf is None:
            buf = torch.from_numpy(
                np.zeros((padded, *arrs[0].shape[1:]), arrs[0].dtype)
            ).pin_memory()
            self._staging[key] = buf
        host = buf.numpy()
        off = 0
        for a in arrs:
            host[off:off + a.shape[0]] = a
            off += a.shape[0]
        host[off:] = 0
        return buf.to(self.device, non_blocking=True)

    def _forward(self, stacked) -> Any:
        """One forward on the current params -> numpy outputs (one
        device-to-host copy per output leaf)."""
        with self._lock:
            params = self._params
        with torch.inference_mode():
            out = self._apply(params, stacked)
            return _tree_map(lambda t: t.cpu().numpy(), out)

    def _serve_batch(self, reqs: list[_Request]) -> None:
        n = sum(r.items for r in reqs)
        padded = self._bucket(n)
        with self._obs.span("server.batch", items=n, padded=padded):
            # every request's leaves get a leading batch dim (single-
            # item requests gain one), then requests concatenate
            leads = [r.inputs if r.n else
                     _tree_map(lambda x: np.asarray(x)[None], r.inputs)
                     for r in reqs]
            stacked = self._stack(leads, padded)
            with self._lock:
                version = self._params_version
            out_np = self._forward(stacked)
        off = 0
        t_done = time.perf_counter()
        for r in reqs:
            if r.n:
                lo, hi = off, off + r.n
                r.result = _tree_map(lambda x: x[lo:hi], out_np)
            else:
                idx = off
                r.result = _tree_map(lambda x: x[idx], out_np)
            off += r.items
            # enqueue -> result ready: what an actor blocks on
            self._obs.observe("infer_latency_ms", (t_done - r.t_enq) * 1e3)
            r.event.set()
        with self._lock:
            self._batches_served += 1
            self._items_served += n
        self._obs.on_server_batch(n, version, self._q.qsize())


def _pad_concat(xs: list, padded: int) -> np.ndarray:
    arr = (np.asarray(xs[0]) if len(xs) == 1
           else np.concatenate([np.asarray(x) for x in xs]))
    if arr.shape[0] < padded:
        pad_width = [(0, padded - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
        arr = np.pad(arr, pad_width)
    return arr


def _pow2_bucket_sizes(bucket_fn: Callable[[int], int], max_batch: int,
                       extra_sizes: tuple[int, ...]) -> set[int]:
    """Every bucket a pow2 REQUEST size up to max_batch can land in,
    plus the buckets of `extra_sizes`."""
    sizes = set()
    n = 1
    while n < max_batch:
        sizes.add(bucket_fn(n))
        n *= 2
    sizes.add(bucket_fn(max_batch))
    sizes.update(bucket_fn(s) for s in extra_sizes if s >= 1)
    return sizes
