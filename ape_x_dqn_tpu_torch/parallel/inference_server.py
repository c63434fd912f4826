"""Batched inference server on the card for actor policy evaluation.

Counterpart of ``ape_x_dqn_tpu/parallel/inference_server.py``: the
single-policy ``BatchedInferenceServer`` and the multi-tenant serving
tier. Many actor threads send observations to one server thread, which pads
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

Multi-tenant serving tier: `MultiPolicyInferenceServer` serves MANY
policies from one card behind one continuous-batching admission queue.
Requests are tagged (policy_id, priority class); an admission thread
moves them into per-family priority deques while the dispatch thread
forwards, so admission never waits on a collect-then-serve round. A
batch of one tenant runs the plain forward; a batch that mixes
same-family tenants runs ONE forward over per-row gathered params
(`torch.func.vmap` over `functional_call`, which turns each convolution
into a grouped one), so 57 tenants never mean 57 forwards. The
admission controller sheds from the lowest priority class when the
queue depth crosses the SLO line (class 0 is never shed), expires
requests past their deadline with errors naming the policy, and raises
and clears a backpressure signal the transport acts on. Callers talk to
the tier through `register_policy`'s `TenantClient`, which keeps the
exact `BatchedInferenceServer` surface. The device parts follow
`BatchedInferenceServer`: pinned staging per (leaf, bucket), one
non-blocking copy in, one device-to-host copy out.

Mesh-sharded mode (both servers): pass a parallel/mesh.py `Mesh` and
buckets round up to a multiple of the mesh size, so every shard of a
batch gets identical work, as in the original. On a mesh of one card
(repeated) the forward runs whole on that card. On a mesh over several
distinct cards each batch splits over the mesh positions
(`batch_sharding`: a card takes the rows of its positions) and every
card runs its part on its own replica of the params (`replicated`;
`update_params` copies a publication to each card and waits for the
copies); the batch is staged on the host and the replies are gathered
there, in batch order (`_MeshSplit`).
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
from ape_x_dqn_tpu_torch.obs.health import make_lock
from ape_x_dqn_tpu_torch.parallel.mesh import batch_sharding, replicated
from ape_x_dqn_tpu_torch.utils.misc import next_pow2, resolve_device


def _tree_map(fn: Callable, tree):
    """fn over the leaves of a request or reply: an array, or a flat
    dict of arrays."""
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return fn(tree)


def _lead(tree) -> int:
    return (next(iter(tree.values())) if isinstance(tree, dict)
            else tree).shape[0]


class _MeshSplit:
    """A server's mesh over several distinct cards: `place` puts a
    replica of the params on every card (waiting for the copies, so the
    serving thread never reads a replica in flight), `apply` runs
    ``fn(replica, part)`` (or ``fn(replica, rows part, part)``) on every
    card's rows of a host batch and gathers the outputs on the host in
    batch order, as torch tensors. Every card's rows go up from pinned
    memory without blocking and every card's forward is enqueued before
    the first reply is waited for, so the cards' forwards overlap; the
    replies come back into pinned buffers, one wait per card."""

    def __init__(self, mesh: Any):
        self.split = batch_sharding(mesh)
        self.replicas = replicated(mesh)
        self.cards = mesh.cards

    def place(self, params: Any) -> Any:
        if params is None:
            return None
        out = self.replicas.put(params)
        for dev in self.cards:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        return out

    def apply(self, fn: Callable, placed: dict, batch: Any,
              rows: torch.Tensor | None = None) -> Any:
        n = _lead(batch)
        idx = self.split.rows(n)
        outs = {}
        for dev, i in idx.items():
            part = _tree_map(lambda t: _rows_to(t, i, dev), batch)
            if rows is None:
                outs[dev] = fn(placed[dev], part)
            else:
                outs[dev] = fn(placed[dev], _rows_to(rows, i, dev), part)
        host = {dev: _tree_map(_to_pinned_host, o)
                for dev, o in outs.items()}
        for dev in host:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        first = next(iter(host.values()))
        if isinstance(first, dict):
            return {k: self.split.gather({d: o[k] for d, o in host.items()},
                                         n) for k in first}
        return self.split.gather(host, n)


def _rows_to(t: torch.Tensor, i: torch.Tensor,
             dev: torch.device) -> torch.Tensor:
    """Rows `i` (ascending) of the host tensor `t` on `dev`: on a card,
    a slice of `t` where they are contiguous, else gathered, copied
    from pinned memory without blocking (the caller waits for the
    card before it rewrites `t`)."""
    if dev.type != "cuda":
        return t.index_select(0, i).to(dev)
    lo, m = int(i[0]), i.numel()
    part = t[lo:lo + m] if int(i[-1]) - lo + 1 == m else t.index_select(0, i)
    if not part.is_pinned():
        part = part.pin_memory()
    return part.to(dev, non_blocking=True)


def _to_pinned_host(t: torch.Tensor) -> torch.Tensor:
    """A card's reply copied into pinned host memory without blocking
    (read only after the card's stream is waited for)."""
    if t.device.type != "cuda":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


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
        request without a card raises; a mesh's own card when `mesh` is
        given). obs: the observability facade (NULL_OBS when
        omitted)."""
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        self._min_bucket = mesh.size if mesh is not None else 1
        # a mesh over several cards splits every batch over them
        self._split = (_MeshSplit(mesh) if mesh is not None
                       and mesh.distinct else None)
        self._batcher = _DeviceBatcher(self.device,
                                       host=self._split is not None)
        self._warm: set[int] = set()  # warmed buckets (before traffic)
        self._apply = apply_fn
        self._params = self._place(params)  # guarded-by: _lock
        self._params_version = 0  # guarded-by: _lock
        self._max_batch = max_batch
        self._deadline_s = deadline_ms / 1000.0
        self._q: queue.Queue[_Request] = queue.Queue()
        # popped-but-not-admitted requests (would overflow max_batch),
        # held in arrival order for later batches; serve thread only
        self._held: deque[_Request] = deque()
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
        port; the forward changes no state. Deduped per bucket: a
        publication changes values, not shapes, so warming again costs
        only the buckets not yet warm. example_input: one request
        WITHOUT the batch dim (only shapes and dtypes matter)."""
        sizes = _pow2_bucket_sizes(self._bucket, self._max_batch,
                                   extra_sizes)
        for b in sorted(sizes - self._warm):
            self._forward(self._batcher.stack(
                [_zeros_like_batch(example_input, b)], b))
            self._warm.add(b)

    # -- learner side ------------------------------------------------------

    def _place(self, params: Any) -> Any:
        """Params as the forward reads them: on every card of a split
        mesh (`_MeshSplit.place`), else as given."""
        return params if self._split is None else self._split.place(params)

    def update_params(self, params: Any, version: int) -> None:
        params = self._place(params)
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
        """Padded batch size: the next power of two, rounded up to a
        multiple of the mesh size in sharded mode."""
        return _mesh_bucket(n, self._min_bucket)

    def _forward(self, stacked) -> Any:
        """One forward on the current params -> numpy outputs (one
        device-to-host copy per output leaf)."""
        with self._lock:
            params = self._params
        with torch.inference_mode():
            if self._split is not None:
                out = self._split.apply(self._apply, params, stacked)
            else:
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
            stacked = self._batcher.stack(leads, padded)
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


def _mesh_bucket(n: int, min_bucket: int) -> int:
    """The next power of two of n, rounded up to a multiple of
    `min_bucket` (the mesh size; 1 without a mesh)."""
    b = next_pow2(max(n, 1))
    if b % min_bucket:
        b = -(-b // min_bucket) * min_bucket
    return b


class _DeviceBatcher:
    """Requests' leaves -> one padded batch on the device: through one
    pinned host buffer per (leaf, bucket) and one non-blocking copy per
    leaf on CUDA, as host tensors on the CPU. Used by one thread at a
    time (a server's serve or dispatch thread; warm-ups run before
    traffic)."""

    def __init__(self, device: torch.device, host: bool = False):
        """host: leave the batch on the host (pinned on CUDA), for a
        server that splits it over several cards."""
        self.device = device
        self._pinned = device.type == "cuda"
        self._host = host
        self._staging: dict[tuple, torch.Tensor] = {}

    def stack(self, leads: list, padded: int) -> Any:
        """Requests' inputs (each an array, or a flat dict of arrays,
        with a leading batch dim) -> one padded device batch of the same
        form."""
        if isinstance(leads[0], dict):
            return {k: self.stage(k, [r[k] for r in leads], padded)
                    for k in leads[0]}
        return self.stage(None, leads, padded)

    def stage(self, leaf: str | None, xs: list,
              padded: int) -> torch.Tensor:
        """Concatenate one leaf's request arrays and zero-pad to
        `padded` rows, on the device. Two leaves of one shape must not
        share a pinned buffer: the second would overwrite the first
        before its copy lands. A buffer is rewritten only after the
        previous batch's reply, a device-to-host copy that follows this
        copy on the same stream, has synchronised."""
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
        if self._host:
            return buf
        return buf.to(self.device, non_blocking=True)


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


# -- multi-tenant serving tier ----------------------------------------------


class ServeShed(RuntimeError):
    """Request shed by the admission controller: queue depth crossed
    the SLO line and this request sat in a sheddable (non-top) priority
    class. Attributed so the caller knows WHICH tenant lost work."""

    def __init__(self, policy_id: str, priority: int):
        super().__init__(
            f"request for policy {policy_id!r} (class {priority}) shed: "
            f"admission queue over the SLO line")
        self.policy_id = policy_id
        self.priority = priority


class ServeDeadlineExceeded(TimeoutError):
    """Request expired in the admission queue before dispatch. The
    timeout is ATTRIBUTED (it names the policy_id and class), so an
    overloaded tenant shows up in actor logs as itself, not as a
    generic server stall."""

    def __init__(self, policy_id: str, priority: int, waited_ms: float):
        super().__init__(
            f"request for policy {policy_id!r} (class {priority}) "
            f"expired after {waited_ms:.0f}ms in the admission queue")
        self.policy_id = policy_id
        self.priority = priority


class _ServeRequest:
    __slots__ = ("policy", "prio", "inputs", "n", "event", "result",
                 "t_enq")

    def __init__(self, policy: str, prio: int, inputs: Any, n: int = 0):
        self.policy = policy
        self.prio = prio
        self.inputs = inputs
        self.n = n
        self.event = threading.Event()
        self.result: Any = None
        self.t_enq = time.perf_counter()

    @property
    def items(self) -> int:
        return self.n if self.n else 1

    def wait(self, timeout: float = 60.0) -> Any:
        """Block until served; raises the attributed shed/deadline
        error if the admission controller rejected the request."""
        if not self.event.wait(timeout):
            raise TimeoutError("inference server did not reply")
        if isinstance(self.result, Exception):
            raise self.result
        return self.result


class _Policy:
    """One registered tenant: epoch-versioned params plus its row in
    the family's stacked params and per-tenant accounting."""

    __slots__ = ("policy_id", "family", "params", "version", "row",
                 "offered", "admitted", "shed", "pending_items",
                 "lat_ms")

    def __init__(self, policy_id: str, family: str, params: Any,
                 version: int, row: int):
        self.policy_id = policy_id
        self.family = family
        self.params = params
        self.version = version
        self.row = row
        self.offered = 0
        self.admitted = 0
        self.shed = 0
        self.pending_items = 0
        # recent end-to-end latencies (ms) for the per-tenant p50/p99
        # gauges: a bounded reservoir, appended only by the dispatch
        # thread, snapshotted by the stats publisher
        self.lat_ms: deque[float] = deque(maxlen=512)


class _Family:
    """One apply-fn family: the tenants it serves, their stacked params
    for the coalesced forward, per-class pending deques, and the
    warm-bucket memo of both forward paths."""

    __slots__ = ("name", "apply_plain", "apply_gather", "policies",
                 "stacked", "dirty", "pending", "pending_items",
                 "warm_plain", "warm_gather")

    def __init__(self, name: str, apply_plain: Callable,
                 apply_gather: Callable, classes: int):
        self.name = name
        self.apply_plain = apply_plain
        self.apply_gather = apply_gather
        self.policies: list[_Policy] = []
        self.stacked: Any = None
        self.dirty = True
        self.pending: list[deque[_ServeRequest]] = [
            deque() for _ in range(classes)]
        self.pending_items = 0
        self.warm_plain: set[int] = set()
        self.warm_gather: set[int] = set()


def _make_gather_apply(apply_fn: Callable) -> Callable:
    """Coalesced multi-tenant forward: the params' leaves carry a
    leading [n_policies] axis, `rows` [B] maps each batch item to its
    tenant's row, and `torch.func.vmap` over (gathered per-example
    params, batch) runs every head in ONE forward: each convolution
    becomes one grouped convolution, each dense layer one batched
    matmul. Never one forward per tenant. The gather materialises
    per-example params, so it costs B x one tenant's params on the
    device (utils/hbm.py prices it)."""

    def one(p: dict, x: Any) -> Any:
        out = apply_fn(p, _tree_map(lambda leaf: leaf[None], x))
        return _tree_map(lambda leaf: leaf[0], out)

    batched = torch.func.vmap(one)

    def run(stacked_params: dict, rows: torch.Tensor, batch: Any) -> Any:
        per = {k: v.index_select(0, rows)
               for k, v in stacked_params.items()}
        return batched(per, batch)

    return run


class TenantClient:
    """Per-tenant view of a MultiPolicyInferenceServer with the exact
    BatchedInferenceServer client/learner surface (query, query_batch,
    warmup, update_params, params_version, queue_depth, stats, stop),
    so drivers, actor hosts and the eval worker are tenant-tagged
    without signature changes. Every query it submits carries this
    view's (policy_id, priority class)."""

    def __init__(self, tier: "MultiPolicyInferenceServer",
                 policy_id: str, priority: int):
        self._tier = tier
        self.policy_id = policy_id
        self.priority = priority

    def submit(self, inputs: Any, n: int = 0) -> _ServeRequest:
        """Non-blocking admission: returns a ticket whose .wait()
        yields the result (or raises the attributed shed/deadline
        error). The open-loop path for benches and load generators."""
        return self._tier.submit(self.policy_id, self.priority,
                                 inputs, n)

    def query(self, inputs: Any, timeout: float = 60.0) -> Any:
        return self.submit(inputs).wait(timeout)

    def query_batch(self, inputs: Any, n: int,
                    timeout: float = 60.0) -> Any:
        assert n >= 1
        return self.submit(inputs, n).wait(timeout)

    def warmup(self, example_input: Any,
               extra_sizes: tuple[int, ...] = ()) -> None:
        self._tier.warmup(self.policy_id, example_input,
                          extra_sizes=extra_sizes)

    def update_params(self, params: Any, version: int) -> None:
        self._tier.update_params(self.policy_id, params, version)

    @property
    def params_version(self) -> int:
        return self._tier.policy_version(self.policy_id)

    @property
    def queue_depth(self) -> int:
        return self._tier.queue_depth

    @property
    def stats(self) -> dict:
        return self._tier.tenant_stats(self.policy_id)

    def stop(self) -> None:
        # views share the tier; stop is idempotent there
        self._tier.stop()


class MultiPolicyInferenceServer:
    """Continuous-batching multi-policy serving tier (the module
    docstring has the sketch).

    Threads: "serving-admission" drains the intake queue into
    per-family per-class pending deques, shedding from the lowest
    class when depth crosses `queue_slo_items` and driving the
    backpressure signal; "serving-dispatch" builds priority-ordered
    batches (class 0 first, FIFO within a class, oversize requests
    parked without head-of-line blocking) and runs one forward per
    batch: the plain forward when the batch is single-tenant, the
    gathered coalesced forward when tenants mix. Admission keeps running
    while a forward is in flight: capacity freeing IS the admission
    signal, there are no collect-then-serve rounds. A dispatch error
    goes to that batch's callers and the tier keeps serving."""

    def __init__(self, max_batch: int = 64, deadline_ms: float = 2.0,
                 *, mesh: Any = None, obs: Any = None,
                 priority_classes: int = 3, queue_slo_items: int = 256,
                 request_deadline_ms: float = 0.0,
                 stats_every_s: float = 1.0, coalesce: bool = True,
                 device: str | torch.device = "cuda"):
        """priority_classes: number of admission classes; class 0 is
        the top class and is NEVER shed. queue_slo_items: pending-item
        depth above which the admission controller sheds lower classes
        and engages backpressure (hysteresis: disengages at half).
        request_deadline_ms: per-request admission-queue deadline
        (0 disables); expiry raises ServeDeadlineExceeded naming the
        policy_id. coalesce: allow the gathered multi-tenant forward
        (single-tenant batches always take the plain path; without it a
        mixed batch runs one plain forward per tenant). device: where
        the forwards run (a CUDA request without a card raises)."""
        assert priority_classes >= 1
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        self._min_bucket = mesh.size if mesh is not None else 1
        # a mesh over several cards splits every batch over them; the
        # tenants' params (and a family's stack) then live on every card
        self._split = (_MeshSplit(mesh) if mesh is not None
                       and mesh.distinct else None)
        self._batcher = _DeviceBatcher(   # dispatch thread
            self.device, host=self._split is not None)
        self._classes = int(priority_classes)
        self._max_batch = max_batch
        self._deadline_s = deadline_ms / 1000.0
        self._slo_items = int(queue_slo_items)
        self._req_deadline_s = request_deadline_ms / 1000.0
        self._stats_every_s = float(stats_every_s)
        self._coalesce = bool(coalesce)
        self._q: queue.Queue[_ServeRequest] = queue.Queue()
        # _lock guards the registry, every pending deque, the stacked
        # param caches and all serve accounting; admission, dispatch,
        # register/update and stats readers all cross it
        self._lock = make_lock("serving_tier._lock")
        self._policies: dict[str, _Policy] = {}  # guarded-by: _lock
        self._families: dict[str, _Family] = {}  # guarded-by: _lock
        self._pending_items = 0  # guarded-by: _lock
        self._offered = 0  # guarded-by: _lock
        self._admitted = 0  # guarded-by: _lock
        self._shed_by_class = [0] * self._classes  # guarded-by: _lock
        self._expired = 0  # guarded-by: _lock
        self._batches_served = 0  # guarded-by: _lock
        self._items_served = 0  # guarded-by: _lock
        self._gather_batches = 0  # guarded-by: _lock
        self._bp_engaged = False  # guarded-by: _lock
        self._stats_last = time.monotonic()  # dispatch thread only
        # transport hook: called with True/False on backpressure
        # transitions (engage when depth crosses the SLO line, release
        # at half); installed by the host before traffic, called from
        # the admission/dispatch threads
        self.on_backpressure: Callable[[bool], None] | None = None
        self._stop_evt = threading.Event()
        self._work = threading.Event()
        self._obs = obs if obs is not None else NULL_OBS
        self._obs.register("inference-server")
        self._admit_thread = threading.Thread(
            target=self._admit_loop, name="serving-admission",
            daemon=True)
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, name="serving-dispatch",
            daemon=True)
        self._admit_thread.start()
        self._dispatch_thread.start()

    # -- registry ----------------------------------------------------------

    def register_policy(self, policy_id: str, apply_fn: Callable,
                        params: Any, *, family: str = "default",
                        priority: int = 0,
                        version: int = 0) -> TenantClient:
        """Register one tenant and return its TenantClient view.

        Tenants sharing `family` must share apply semantics (the same
        net applied to per-tenant params): the family's forwards come
        from the FIRST registration; only params differ per tenant.
        Registration invalidates the family's stacked params and its
        coalesced warm set (the stack gains a row)."""
        params = self._place(params)
        with self._lock:
            if policy_id in self._policies:
                raise ValueError(f"policy {policy_id!r} already "
                                 f"registered")
            fam = self._families.get(family)
            if fam is None:
                plain, gather = apply_fn, _make_gather_apply(apply_fn)
                if self._split is not None:
                    split = self._split
                    plain = (lambda placed, batch, fn=plain:
                             split.apply(fn, placed, batch))
                    gather = (lambda stacked, rows, batch, fn=gather:
                              split.apply(fn, stacked, batch, rows))
                fam = _Family(family, plain, gather, self._classes)
                self._families[family] = fam
            pol = _Policy(policy_id, family, params, version,
                          row=len(fam.policies))
            fam.policies.append(pol)
            fam.dirty = True
            fam.warm_gather.clear()
            self._policies[policy_id] = pol
            n_tenants = len(self._policies)
        self._obs.gauge("serve_tenants", float(n_tenants))
        prio = min(max(int(priority), 0), self._classes - 1)
        return TenantClient(self, policy_id, prio)

    def _place(self, params: Any) -> Any:
        """A tenant's params as the forwards read them: {card: replica}
        on a split mesh (`_MeshSplit.place`), else as given."""
        return params if self._split is None else self._split.place(params)

    def update_params(self, policy_id: str, params: Any,
                      version: int) -> None:
        params = self._place(params)
        with self._lock:
            pol = self._policies[policy_id]
            pol.params = params
            pol.version = version
            # values changed, shapes did not: the stacked params must
            # rebuild, the warm-bucket memos stay valid
            self._families[pol.family].dirty = True

    def policy_version(self, policy_id: str) -> int:
        with self._lock:
            return self._policies[policy_id].version

    def warmup(self, policy_id: str, example_input: Any,
               extra_sizes: tuple[int, ...] = ()) -> None:
        """One forward per bucket a request can land in, deduped
        against the family's warm sets (re-warming after a publication
        or for a same-family sibling costs nothing): the plain path
        always, the coalesced path once the family has more than one
        tenant (warm AFTER registering all same-family tenants).
        Nothing compiles in the port; the forwards allocate the pinned
        buffers and the device workspace and let cuDNN choose its
        algorithms before the first real batch. Call it before traffic:
        it shares the dispatch thread's staging buffers."""
        with self._lock:
            pol = self._policies[policy_id]
            fam = self._families[pol.family]
            params = pol.params
            n_pols = len(fam.policies)
            stacked = (self._stacked_locked(fam)
                       if self._coalesce and n_pols > 1 else None)
        sizes = _pow2_bucket_sizes(self._bucket, self._max_batch,
                                   extra_sizes)
        with torch.inference_mode():
            for b in sorted(sizes - fam.warm_plain):
                zeros = self._batcher.stack(
                    [_zeros_like_batch(example_input, b)], b)
                _tree_map(lambda t: t.cpu(), fam.apply_plain(params, zeros))
                fam.warm_plain.add(b)
            if stacked is not None:
                for b in sorted(sizes - fam.warm_gather):
                    zeros = self._batcher.stack(
                        [_zeros_like_batch(example_input, b)], b)
                    rows = self._batcher.stage(
                        "__rows__", [np.zeros(b, np.int64)], b)
                    _tree_map(lambda t: t.cpu(),
                              fam.apply_gather(stacked, rows, zeros))
                    fam.warm_gather.add(b)

    # -- client side -------------------------------------------------------

    def submit(self, policy_id: str, priority: int, inputs: Any,
               n: int = 0) -> _ServeRequest:
        prio = min(max(int(priority), 0), self._classes - 1)
        req = _ServeRequest(policy_id, prio, inputs, n)
        self._q.put(req)
        return req

    # -- admission controller ----------------------------------------------

    def _admit_loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                r = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            with self._lock:
                pol = self._policies.get(r.policy)
            if pol is None:
                r.result = KeyError(
                    f"unknown policy {r.policy!r}: not registered "
                    f"with this serving tier")
                r.event.set()
                continue
            shed: list[_ServeRequest] = []
            with self._lock:
                fam = self._families[pol.family]
                fam.pending[r.prio].append(r)
                fam.pending_items += r.items
                self._pending_items += r.items
                pol.pending_items += r.items
                pol.offered += 1
                self._offered += 1
                if self._pending_items > self._slo_items:
                    shed = self._shed_locked()
                transition = self._bp_transition_locked(bool(shed))
                depth = self._pending_items
            self._obs.count("serve_offered", 1)
            for s in shed:
                s.result = ServeShed(s.policy, s.prio)
                s.event.set()
                self._obs.count("serve_shed", 1)
            self._obs.gauge("serve_queue_items", float(depth))
            if transition is not None:
                self._fire_backpressure(transition)
            self._work.set()

    def _shed_locked(self) -> list[_ServeRequest]:
        """Shed newest-first from the lowest priority class until the
        pending depth is back under the SLO line. Class 0 is never
        shed: under pure top-class overload the queue stays deep and
        backpressure is the only relief valve."""
        shed: list[_ServeRequest] = []
        for cls in range(self._classes - 1, 0, -1):
            for fam in self._families.values():
                dq = fam.pending[cls]
                while dq and self._pending_items > self._slo_items:
                    r = dq.pop()
                    fam.pending_items -= r.items
                    self._pending_items -= r.items  # apexlint: unguarded(caller holds _lock)
                    pol = self._policies[r.policy]
                    pol.pending_items -= r.items
                    pol.shed += 1
                    self._shed_by_class[cls] += 1  # apexlint: unguarded(caller holds _lock)
                    shed.append(r)
            if self._pending_items <= self._slo_items:
                break
        return shed

    def _bp_transition_locked(self, shed_now: bool) -> bool | None:
        """Hysteresis on the backpressure signal: engage when depth
        crosses the SLO line (or shedding fired), release only once
        the queue drains to half the line. Returns the new state on a
        transition, None otherwise."""
        depth = self._pending_items
        if not self._bp_engaged and (shed_now
                                     or depth > self._slo_items):
            self._bp_engaged = True  # apexlint: unguarded(caller holds _lock)
            return True
        if self._bp_engaged and depth <= self._slo_items // 2:
            self._bp_engaged = False  # apexlint: unguarded(caller holds _lock)
            return False
        return None

    def _fire_backpressure(self, engaged: bool) -> None:
        self._obs.gauge("serve_backpressure", 1.0 if engaged else 0.0)
        # backpressure flips are the significant recent events a
        # post-crash ring should narrate
        self._obs.blackbox.record("backpressure",
                                  component="inference-server",
                                  engaged=bool(engaged))
        cb = self.on_backpressure
        if cb is not None:
            cb(engaged)

    # -- dispatch ----------------------------------------------------------

    def _dispatch_loop(self) -> None:
        while not self._stop_evt.is_set():
            picked = self._take_batch()
            if picked is None:
                self._work.wait(timeout=0.005)
                self._work.clear()
                self._obs.beat("inference-server", "idle")
                self._maybe_publish_stats()
                continue
            fam, reqs, items = picked
            try:
                self._forward(fam, reqs, items)
            except Exception as e:  # propagate to callers, keep serving
                self._obs.blackbox.record(
                    "serve_error", component="inference-server",
                    error=repr(e)[:200])
                for r in reqs:
                    r.result = e
                    r.event.set()
            self._maybe_publish_stats()

    def _take_batch(self) -> tuple[_Family, list[_ServeRequest],
                                   int] | None:
        """Pick the family whose head-of-queue request is most urgent
        (highest class, then oldest) and build a batch from its
        pending deques, class 0 first, FIFO within a class, parking
        non-fitting requests in place (no head-of-line blocking).
        Dispatches at once on a full batch; otherwise waits out the
        batching deadline from the oldest pending admit."""
        now = time.perf_counter()
        expired: list[_ServeRequest] = []
        batch: tuple[_Family, list[_ServeRequest], int] | None = None
        transition: bool | None = None
        with self._lock:
            expired = self._sweep_expired_locked(now)
            best: tuple[int, float, _Family] | None = None
            for fam in self._families.values():
                for cls, dq in enumerate(fam.pending):
                    if dq:
                        if (best is None
                                or (cls, dq[0].t_enq) < best[:2]):
                            best = (cls, dq[0].t_enq, fam)
                        break
            if best is not None:
                fam = best[2]
                oldest = min(dq[0].t_enq
                             for dq in fam.pending if dq)
                if (fam.pending_items >= self._max_batch
                        or now - oldest >= self._deadline_s
                        or self._stop_evt.is_set()):
                    reqs: list[_ServeRequest] = []
                    items = 0
                    for dq in fam.pending:
                        kept: deque[_ServeRequest] = deque()
                        while dq:
                            r = dq.popleft()
                            if (items + r.items <= self._max_batch
                                    or (not reqs
                                        and r.items >= self._max_batch)):
                                reqs.append(r)
                                items += r.items
                            else:
                                kept.append(r)
                        dq.extend(kept)
                        if items >= self._max_batch:
                            break
                    fam.pending_items -= items
                    self._pending_items -= items
                    for r in reqs:
                        pol = self._policies[r.policy]
                        pol.pending_items -= r.items
                        pol.admitted += 1
                    self._admitted += len(reqs)
                    batch = (fam, reqs, items)
            if expired or batch:
                transition = self._bp_transition_locked(False)
        for r in expired:
            r.result = ServeDeadlineExceeded(
                r.policy, r.prio, (now - r.t_enq) * 1e3)
            r.event.set()
            self._obs.count("serve_expired", 1)
            self._obs.count("serve_shed", 1)
        if batch is not None:
            self._obs.count("serve_admitted", len(batch[1]))
        if transition is not None:
            self._fire_backpressure(transition)
        return batch

    def _sweep_expired_locked(self, now: float) -> list[_ServeRequest]:
        """Deadline-aware shedding: pending deques are FIFO, so the
        expired requests are exactly the stale heads."""
        if self._req_deadline_s <= 0:
            return []
        expired: list[_ServeRequest] = []
        for fam in self._families.values():
            for cls, dq in enumerate(fam.pending):
                while dq and now - dq[0].t_enq > self._req_deadline_s:
                    r = dq.popleft()
                    fam.pending_items -= r.items
                    self._pending_items -= r.items  # apexlint: unguarded(caller holds _lock)
                    pol = self._policies[r.policy]
                    pol.pending_items -= r.items
                    pol.shed += 1
                    self._shed_by_class[cls] += 1  # apexlint: unguarded(caller holds _lock)
                    self._expired += 1  # apexlint: unguarded(caller holds _lock)
                    expired.append(r)
        return expired

    def _bucket(self, n: int) -> int:
        """Padded batch size: the next power of two, rounded up to a
        multiple of the mesh size in sharded mode."""
        return _mesh_bucket(n, self._min_bucket)

    def _stacked_locked(self, fam: _Family) -> dict:
        """(Re)build the family's stacked params if a tenant registered
        or published since the last coalesced forward: one torch.stack
        per leaf, on the tier's device, per publication, never per
        batch. Caller holds _lock (publications are rare, so the device
        work under the lock is bounded)."""
        if fam.dirty:
            def stack(params: list[dict], device) -> dict:
                return {k: torch.stack([p[k] for p in params]).to(device)
                        for k in params[0]}

            if self._split is None:
                fam.stacked = stack([p.params for p in fam.policies],
                                    self.device)
            else:
                fam.stacked = {
                    dev: stack([p.params[dev] for p in fam.policies], dev)
                    for dev in self._split.cards}
            fam.dirty = False
        return fam.stacked

    def _forward(self, fam: _Family, reqs: list[_ServeRequest],
                 items: int) -> None:
        padded = self._bucket(items)
        with self._obs.span("server.batch", items=items,
                            padded=padded):
            leads = [r.inputs if r.n else
                     _tree_map(lambda x: np.asarray(x)[None], r.inputs)
                     for r in reqs]
            stacked = self._batcher.stack(leads, padded)
            with self._lock:
                pols = [self._policies[r.policy] for r in reqs]
                version = max(p.version for p in pols)
                mixed = len({p.policy_id for p in pols}) > 1
                stacked_params = (self._stacked_locked(fam)
                                  if mixed and self._coalesce else None)
            with torch.inference_mode():
                if not mixed:
                    # single-tenant batch: the plain forward, as in
                    # BatchedInferenceServer
                    out_np = _tree_map(
                        lambda t: t.cpu().numpy(),
                        fam.apply_plain(pols[0].params, stacked))
                elif stacked_params is not None:
                    # mixed tenants: one gathered forward; padding rows
                    # point at row 0 and compute discarded garbage
                    rows = np.zeros(padded, np.int64)
                    off = 0
                    for r, p in zip(reqs, pols):
                        rows[off:off + r.items] = p.row
                        off += r.items
                    out_np = _tree_map(
                        lambda t: t.cpu().numpy(),
                        fam.apply_gather(
                            stacked_params,
                            self._batcher.stage("__rows__", [rows], padded),
                            stacked))
                    with self._lock:
                        self._gather_batches += 1
                else:
                    out_np = _per_tenant(fam.apply_plain, reqs, pols,
                                         stacked)
        off = 0
        t_done = time.perf_counter()
        for r, p in zip(reqs, pols):
            if r.n:
                lo, hi = off, off + r.n
                r.result = _tree_map(lambda x: x[lo:hi], out_np)
            else:
                idx = off
                r.result = _tree_map(lambda x: x[idx], out_np)
            off += r.items
            lat_ms = (t_done - r.t_enq) * 1e3
            self._obs.observe("infer_latency_ms", lat_ms)
            p.lat_ms.append(lat_ms)
            r.event.set()
        with self._lock:
            self._batches_served += 1
            self._items_served += items
            depth = self._pending_items
        self._obs.on_server_batch(items, version,
                                  depth + self._q.qsize())

    def _maybe_publish_stats(self) -> None:
        """Per-tenant serve/<tenant>/ gauges at the stats cadence:
        p50/p99 of the latency reservoir, pending depth, offered,
        admitted and shed counts (dynamic keys by design; the report
        regroups them)."""
        now = time.monotonic()
        if now - self._stats_last < self._stats_every_s:
            return
        self._stats_last = now
        with self._lock:
            snap = [(p.policy_id, list(p.lat_ms), p.pending_items,
                     p.offered, p.admitted, p.shed)
                    for p in self._policies.values()]
        for pid, lats, depth, offered, admitted, shed in snap:
            if lats:
                q50, q99 = np.percentile(np.asarray(lats), (50, 99))
                self._obs.gauge(f"serve/{pid}/p50_ms", float(q50))
                self._obs.gauge(f"serve/{pid}/p99_ms", float(q99))
            self._obs.gauge(f"serve/{pid}/queue_depth", float(depth))
            self._obs.gauge(f"serve/{pid}/offered", float(offered))
            self._obs.gauge(f"serve/{pid}/admitted", float(admitted))
            self._obs.gauge(f"serve/{pid}/shed", float(shed))

    # -- aggregate surface -------------------------------------------------

    @property
    def queue_depth(self) -> int:
        with self._lock:
            pending = self._pending_items
        return pending + self._q.qsize()

    @property
    def backpressure_engaged(self) -> bool:
        with self._lock:
            return self._bp_engaged

    def force_backpressure(self, engaged: bool) -> bool:
        """Externally set the backpressure flag (the remediation
        plane's queue-SLO actuator, runtime/remediation.py). Fires the
        same gauge and transport callback as the admission controller's
        own transitions; the controller keeps running, so if its
        depth-based hysteresis disagrees it re-transitions on the next
        shed or drain: a nudge with a live fallback, not an override
        that can wedge. -> False on a no-op (already in that state)."""
        with self._lock:
            if self._bp_engaged == bool(engaged):
                return False
            self._bp_engaged = bool(engaged)
        self._fire_backpressure(bool(engaged))
        return True

    @property
    def stats(self) -> dict:
        with self._lock:
            return {"offered": self._offered,
                    "admitted": self._admitted,
                    "shed": sum(self._shed_by_class),
                    "shed_by_class": list(self._shed_by_class),
                    "expired": self._expired,
                    "batches": self._batches_served,
                    "items": self._items_served,
                    "avg_batch": (self._items_served
                                  / max(self._batches_served, 1)),
                    "gather_batches": self._gather_batches,
                    "tenants": len(self._policies)}

    def tenant_stats(self, policy_id: str) -> dict:
        with self._lock:
            pol = self._policies[policy_id]
            lats = list(pol.lat_ms)
            out = {"offered": pol.offered, "admitted": pol.admitted,
                   "shed": pol.shed, "pending": pol.pending_items,
                   "version": pol.version}
        if lats:
            q50, q99 = np.percentile(np.asarray(lats), (50, 99))
            out["p50_ms"], out["p99_ms"] = float(q50), float(q99)
        return out

    def stop(self) -> None:
        if self._stop_evt.is_set():
            return
        self._stop_evt.set()
        self._work.set()
        self._admit_thread.join(timeout=5)
        self._dispatch_thread.join(timeout=5)
        # unblock anyone still waiting: queued and pending requests
        # fail loudly instead of hitting their full client timeout
        leftovers: list[_ServeRequest] = []
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except queue.Empty:
                break
        with self._lock:
            for fam in self._families.values():
                for dq in fam.pending:
                    leftovers.extend(dq)
                    dq.clear()
                fam.pending_items = 0
            self._pending_items = 0
        for r in leftovers:
            if not r.event.is_set():
                r.result = RuntimeError("serving tier stopped")
                r.event.set()


def _per_tenant(apply_fn: Callable, reqs: list, pols: list,
                batch: Any) -> Any:
    """A mixed batch without coalescing: each tenant's plain forward
    over the padded batch, each row taken from its own tenant's (never
    another tenant's params on a row). -> numpy outputs."""
    outs: dict = {}
    for p in pols:
        if p.policy_id not in outs:
            outs[p.policy_id] = _tree_map(lambda t: t.cpu().numpy(),
                                          apply_fn(p.params, batch))
    out = _tree_map(np.copy, outs[pols[0].policy_id])
    off = 0
    for r, p in zip(reqs, pols):
        lo, hi = off, off + r.items
        mine = outs[p.policy_id]
        if isinstance(out, dict):
            for k in out:
                out[k][lo:hi] = mine[k][lo:hi]
        else:
            out[lo:hi] = mine[lo:hi]
        off += r.items
    return out


def _zeros_like_batch(example_input: Any, b: int) -> Any:
    return _tree_map(
        lambda x: np.zeros((b, *np.asarray(x).shape),
                           np.asarray(x).dtype), example_input)


def build_serving_tier(serving: Any, *, max_batch: int,
                       deadline_ms: float, mesh: Any = None,
                       obs: Any = None,
                       device: str | torch.device = "cuda"
                       ) -> MultiPolicyInferenceServer:
    """Construct the serving tier from a configs.ServingConfig: the one
    place every serving knob is read, so drivers and actor hosts stay
    one-call sites."""
    return MultiPolicyInferenceServer(
        max_batch=max_batch, deadline_ms=deadline_ms, mesh=mesh,
        obs=obs,
        priority_classes=serving.priority_classes,
        queue_slo_items=serving.queue_slo_items,
        request_deadline_ms=serving.request_deadline_ms,
        stats_every_s=serving.stats_every_s,
        coalesce=serving.coalesce, device=device)
