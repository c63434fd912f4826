"""One learner step body, run eagerly or replayed as a captured CUDA graph.

The PyTorch counterpart of the JAX learner's one jitted, donated
dispatch per endpoint (``ape_x_dqn_tpu/runtime/learner.py:253``). A
learner hands a `StepGraph` the body of one endpoint,
``body(state, noise) -> metrics``, which updates `state` in place with
device operations only: it reads no host value that changes between
calls (the replay's cursor and fill, and Adam's count, which also counts
the grad-steps, are device tensors), makes no host synchronisation, and
takes the stratification noise, drawn by the caller outside the body,
as `noise`.

- On the CPU, and on the card while the learner's `capture` is off, the
  body runs eagerly. That is the CPU path and the card's reference, not
  a fallback.
- On the card the first call runs the body eagerly on a side stream, as
  a real step (cuBLAS and cuDNN pick their algorithms and workspaces
  there). The second call captures it into a ``torch.cuda.CUDAGraph`` on
  that stream and replays it at once, since capturing runs nothing.
  Every later call copies the noise into the graph's static input and
  replays. A capture that fails raises: there is no eager fallback.
- The graph holds the addresses of the state's tensors, so the state is
  updated in place and never reallocated (the replay's `add`, the
  priority write-back and the optimizer all write in place). A call
  with another state object warms up and captures anew.
- The metrics leave the graph as one packed float32 vector that the
  next replay overwrites; each call returns views of a fresh copy, so
  callers may keep them.
- A replay runs on the caller's current stream and is ordered with
  whatever the caller orders that stream with (runtime/driver.py orders
  ingest's adds and the learner by events). Calls from two streams must
  be ordered by the caller.
- `frame_gather.gather_rows` counts the launches recorded into a graph
  while it is captured (``gather_rows.captured``); each replay adds them
  to ``gather_rows.launches``.

`AddGraph` is the same for the ingest add (the counterpart of the JAX
driver's one donated `add`/`add_many` dispatch,
``ape_x_dqn_tpu/runtime/ingest.py``): its body writes g staged blocks at
the replay's DEVICE cursor and advances it, reading its inputs from
static device buffers that the caller's host-to-device copies land in
(`land`); the host cursor is the learner's to advance. One graph per
(replay, g).

A multi-process dp-sharded learner (parallel/dist_learner.py) exchanges
each SGD step's packed gradient across processes (parallel/
multihost.py: `GradExchange`). Its step body is then a generator that
yields each vector to exchange and is sent back the exchanged [nproc,
L] result; `drive` runs it with the exchanges in between. Which graph
holds it depends on the exchange:

- `ExchangedStep`, for an exchange a CUDA graph can hold (NCCL on the
  device, every rank alone on its card): the body is driven inside ONE
  capture, so each collective is recorded between chunk j's backward
  and chunk j+1's update, and a K=4 macro-step replays as one graph,
  like a one-process learner's. The replays of every rank must come in
  the same order (a replayed collective waits on the device for its
  peers, with no host timeout): the lockstep round protocol
  (runtime/multihost_driver.py) issues the same dispatches on every
  rank.
- `SegmentedStep`, for the host-staged gloo exchange, which no graph
  can hold: each stretch between two yields is captured as a graph of
  its own (the draw and gather and chunk j's forward and backward into
  the packed vector; the exchange's copies and collective on the host;
  then the clip, Adam and target-sync segment with chunk j+1's forward
  and backward; the last segment ends with the write-back), five a
  K=4 macro-step.

On the CPU and with capture off both are `drive`, eagerly. A capture
that fails raises here too.

A one-process mesh over several cards (parallel/cards.py) runs one such
generator per card group, in lockstep (`drive_cards`: every group's
stretch, then one in-process exchange of the vectors they yielded).
`CardsStep` captures each group's stretches as segments, with the
exchange (an NCCL all-gather over the owners' streams) between them; a
group whose rows split their layers across tp partner cards captures
each stretch as one graph over its cards (the partners' streams join
the owner's capture by events). A K=4 macro-step over g groups replays
5 g graphs and 4 exchanges.

`EvictGraph` and an `AddGraph` of the directed add are the tiered cold
store's eviction swap (the counterparts of the JAX learner's
`evict_region` and `add_at` jits): the evict graph writes the start of
the ring's lowest-priority-mass region, the region in staging layout
and its leaf priorities into static outputs; the add_at graph overwrites
that region with a staged block, reading the start from a static device
input that the caller fills from the evict graph's output on the device
(no host int). One of each per replay layout.

The graphs reach their learner through a weak reference
(`GraphedEndpoints._weak_body`): a learner holds its graphs, and a
graph whose body held the learner back made a reference cycle that only
a collection frees, at a moment that could fall inside a later
capture and destroy graphs there. Now the last reference to a learner
frees it and its graphs at once.

Every capture is logged in `CAPTURES` (name, milliseconds, the caching
allocator's growth across it), which the observability layer publishes
as `graph_captures`, `graph_capture_ms` and `hbm/<graph>/...`
(obs/profiling.py). While a cost is wanted (`profiling.want_costs`),
the first eager run of a body (the warm-up on the card) is counted for
its FLOPs and bytes (`profiling.count_cost`), kept as `cost`.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import Any, Callable

import torch

from ape_x_dqn_tpu_torch.obs import profiling
from ape_x_dqn_tpu_torch.ops.frame_gather import count_launches, gather_rows


def _leaves(tree: dict, prefix: tuple = ()):
    for key, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (key,))
        else:
            yield prefix + (key,), v


def pack_metrics(metrics: dict) -> tuple[torch.Tensor, list[tuple]]:
    """A nested dict of scalar tensors -> (one float32 vector, the key
    paths in its order)."""
    paths, vals = [], []
    for path, v in _leaves(metrics):
        if v.numel() != 1:
            raise ValueError(f"metric {'/'.join(path)} is not a scalar: "
                             f"{tuple(v.shape)}")
        paths.append(path)
        vals.append(v.reshape(()).to(torch.float32))
    return torch.stack(vals), paths


def unpack_metrics(vec: torch.Tensor, paths: list[tuple]) -> dict:
    """Inverse of `pack_metrics`: 0-dim views of `vec`."""
    out: dict = {}
    for i, path in enumerate(paths):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = vec[i]
    return out


class CaptureLog:
    """Every graph captured in this process, in order: {"name", "ms",
    "allocated_bytes", "reserved_bytes"} (the allocator's growth across
    the capture: the graph's private pool, plus whatever other threads
    allocated meanwhile)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.entries: list[dict] = []   # guarded-by: _lock

    def add(self, entry: dict) -> None:
        with self._lock:
            self.entries.append(entry)

    def since(self, n: int) -> list[dict]:
        with self._lock:
            return list(self.entries[n:])


CAPTURES = CaptureLog()


def _memory(device: torch.device) -> tuple[int, int]:
    st = torch.cuda.memory_stats(device)
    return (int(st.get("allocated_bytes.all.current", 0)),
            int(st.get("reserved_bytes.all.current", 0)))


class _Captured:
    """Warm-up, capture and the capture log, shared by `StepGraph` and
    `AddGraph`. `run(state, x)` is the body on the static or fed input
    `x`; subclasses say what `x` is."""

    def __init__(self, name: str, steps: int):
        self.name = name
        self.steps = steps         # grad-steps (or add units) one run does
        self.cost: tuple[float, float] | None = None  # (flops, bytes)
        self._warm = None          # the state the eager warm-up ran on
        self._bound = None         # the state the graph was captured on
        self._graph: torch.cuda.CUDAGraph | None = None
        self._stream: torch.cuda.Stream | None = None

    @property
    def captured(self) -> bool:
        return self._graph is not None

    @property
    def graphs(self) -> int:
        """Captured graphs one call replays."""
        return 1 if self.captured else 0

    def _eager(self, run: Callable, state, x):
        """One eager run, counted for its cost the first time a cost is
        wanted."""
        if self.cost is None and profiling.costs_wanted():
            out, flops, nbytes = profiling.count_cost(lambda: run(state, x))
            self.cost = (flops, nbytes)
            return out
        return run(state, x)

    def _side_stream(self, device: torch.device) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=device)
        return self._stream

    def _warm_up(self, run: Callable, state, x: Any, device):
        cur = torch.cuda.current_stream(device)
        side = self._side_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self._eager(run, state, x)
        cur.wait_stream(side)
        self._warm = state
        return out

    def _capture(self, run: Callable, state, x: Any, device):
        """Capture `run(state, x)` (which runs nothing) and log it. ->
        what the body returned while capturing (static outputs)."""
        self._graph = self._bound = None    # a graph of another state
        graph = torch.cuda.CUDAGraph()
        mem0 = _memory(device)
        t0 = time.perf_counter()
        # thread_local: the driver's other threads keep using the card
        # (on other streams) while this thread captures
        with torch.cuda.graph(graph, stream=self._side_stream(device),
                              capture_error_mode="thread_local"):
            out = run(state, x)
        ms = (time.perf_counter() - t0) * 1e3
        mem1 = _memory(device)
        CAPTURES.add({"name": self.name, "ms": ms,
                      "allocated_bytes": mem1[0] - mem0[0],
                      "reserved_bytes": mem1[1] - mem0[1]})
        self._graph, self._bound = graph, state
        return out


class StepGraph(_Captured):
    def __init__(self, body: Callable[[Any, torch.Tensor], dict],
                 name: str = "step", steps: int = 1):
        super().__init__(name, steps)
        self.body = body
        self.gathers = 0           # gather launches one replay carries
        self._noise: torch.Tensor | None = None   # static input
        self._out: torch.Tensor | None = None     # static packed metrics
        self._paths: list[tuple] = []

    def __call__(self, state, noise: torch.Tensor, capture: bool) -> dict:
        if noise.device.type != "cuda" or not capture:
            return self._eager(self.body, state, noise)
        if self._graph is None or self._bound is not state:
            if self._warm is not state:
                out = self._warm_up(self.body, state, noise, noise.device)
                cur = torch.cuda.current_stream(noise.device)
                for _, v in _leaves(out):
                    v.record_stream(cur)
                return out
            static = torch.empty_like(noise)
            before = gather_rows.captured
            self._out, self._paths = self._capture(
                lambda s, u: pack_metrics(self.body(s, u)), state, static,
                noise.device)
            self.gathers = gather_rows.captured - before
            self._noise = static
        return self._replay(noise)

    def _replay(self, noise: torch.Tensor) -> dict:
        self._noise.copy_(noise)
        self._graph.replay()
        count_launches(noise.device, self.gathers)
        return unpack_metrics(self._out.clone(), self._paths)


class ExchangedStep(StepGraph):
    """A `StepGraph` whose body, ``body(state, noise)``, is a generator
    with a capturable `exchange` inside (see the module docstring):
    `drive` runs it, and on the card with capture on the whole of it is
    captured into one graph. The exchange counts its eager calls; the
    calls recorded into the graph are added to its counts at every
    replay."""

    def __init__(self, body: Callable, exchange, name: str = "step",
                 steps: int = 1):
        sizes: list[int] = []   # the recorded calls' element counts

        def exchanged(send: torch.Tensor) -> torch.Tensor:
            if send.is_cuda and torch.cuda.is_current_stream_capturing():
                sizes.append(send.numel())
            return exchange(send)

        # closures over `exchange` and `sizes`, not over self: dropping
        # the graph frees it at once (no reference cycle)
        super().__init__(lambda s, u: drive(body(s, u), exchanged),
                         name=name, steps=steps)
        self.exchange = exchange
        self._sizes = sizes

    def _capture(self, run: Callable, state, x: Any, device):
        self._sizes.clear()
        return super()._capture(run, state, x, device)

    def _replay(self, noise: torch.Tensor) -> dict:
        out = super()._replay(noise)
        self.exchange.count(self._sizes)
        return out


def drive(gen, exchange: Callable) -> Any:
    """Run an exchanged step body (eagerly, or inside an
    `ExchangedStep`'s capture): each vector the generator yields goes
    through `exchange` (-> the [nproc, L] result, sent back in); -> what
    the generator returns."""
    x = None
    while True:
        try:
            send = gen.send(x)
        except StopIteration as stop:
            return stop.value
        x = exchange(send)


class SegmentedStep(_Captured):
    """A `StepGraph` whose body, ``body(state, noise)``, is a generator
    with host collectives inside (see the module docstring). On the
    card with capture on: the first call drives it eagerly on a side
    stream, the second captures one graph per segment (the vectors
    each segment yields are its static outputs, the [nproc, L] buffers
    the next reads are static device inputs) and replays them with the
    exchanges in between; later calls replay. Elsewhere `drive`."""

    def __init__(self, body: Callable, exchange: Callable,
                 name: str = "step", steps: int = 1):
        super().__init__(name, steps)
        self.body = body
        self.exchange = exchange
        self.gathers = 0
        self._graphs: list[torch.cuda.CUDAGraph] = []
        self._sends: list[torch.Tensor] = []    # static outputs
        self._recvs: list[torch.Tensor] = []    # static inputs
        self._noise: torch.Tensor | None = None
        self._out: torch.Tensor | None = None
        self._paths: list[tuple] = []

    @property
    def graphs(self) -> int:
        """Captured segments one call replays."""
        return len(self._graphs)

    def _drive(self, state, noise) -> dict:
        return drive(self.body(state, noise), self.exchange)

    def __call__(self, state, noise: torch.Tensor, capture: bool) -> dict:
        if noise.device.type != "cuda" or not capture:
            return self._eager(self._drive, state, noise)
        if self._graph is None or self._bound is not state:
            if self._warm is not state:
                out = self._warm_up(self._drive, state, noise, noise.device)
                cur = torch.cuda.current_stream(noise.device)
                for _, v in _leaves(out):
                    v.record_stream(cur)
                return out
            before = gather_rows.captured
            self._capture_segments(state, noise)
            self.gathers = gather_rows.captured - before
        return self._replay(noise)

    def _capture_segments(self, state, noise: torch.Tensor) -> None:
        device = noise.device
        self._graph = self._bound = None    # segments of another state
        self._graphs, self._sends, self._recvs = [], [], []
        self._noise = torch.empty_like(noise)
        side = self._side_stream(device)
        mem0 = _memory(device)
        t0 = time.perf_counter()
        gen = x = None
        while True:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                try:
                    if gen is None:
                        # made inside the first capture: whatever the
                        # body runs before its first yield is segment 0
                        gen = self.body(state, self._noise)
                        send = next(gen)
                    else:
                        send = gen.send(x)
                except StopIteration as stop:
                    send = None
                    self._out, self._paths = pack_metrics(stop.value)
            self._graphs.append(graph)
            if send is None:
                break
            self._sends.append(send)
            x = torch.empty((self.exchange.nproc, send.numel()),
                            dtype=torch.float32, device=device)
            self._recvs.append(x)
        mem1 = _memory(device)
        CAPTURES.add({"name": self.name, "ms": (time.perf_counter() - t0)
                      * 1e3, "allocated_bytes": mem1[0] - mem0[0],
                      "reserved_bytes": mem1[1] - mem0[1]})
        self._graph, self._bound = self._graphs[-1], state

    def _replay(self, noise: torch.Tensor) -> dict:
        self._noise.copy_(noise)
        for i, graph in enumerate(self._graphs):
            graph.replay()
            if i < len(self._sends):
                self.exchange(self._sends[i], self._recvs[i])
        count_launches(noise.device, self.gathers)
        return unpack_metrics(self._out.clone(), self._paths)


def drive_cards(gens: list, exchange: Callable) -> list:
    """Run the card groups' exchanged step bodies of a one-process mesh
    over several cards (parallel/cards.py) in lockstep: every
    generator's stretch up to its next yield, then ONE exchange of the
    vectors they yielded (-> one [ngroups, L] result per group, sent
    back in); -> what each generator returned, in group order."""
    xs = [None] * len(gens)
    while True:
        sends, outs = [], []
        for gen, x in zip(gens, xs):
            try:
                sends.append(gen.send(x))
            except StopIteration as stop:
                outs.append(stop.value)
        if outs:
            if sends:
                raise RuntimeError("the card groups' step bodies did not "
                                   "yield alike")
            return outs
        xs = exchange(sends)


def _route_to_pool(device: torch.device, pool) -> Callable[[], None]:
    """While a graph captures on another card, route the allocations
    this thread makes on `device`'s current stream (a tp partner's side
    stream, joined into the capture) into a private pool of that
    device, as the capture does on its own card; -> the call that ends
    the routing. The pool is released with the graph
    (`CardsStep._capture_group`)."""
    idx = device.index
    torch._C._cuda_beginAllocateCurrentStreamToPool(idx, pool)
    return lambda: torch._C._cuda_endAllocateToPool(idx, pool)


class CardsStep(_Captured):
    """The step of a one-process mesh over several cards
    (parallel/cards.py): one exchanged generator body per card group,
    ``body(state, noise)``, driven in lockstep (`drive_cards`) with the
    in-process exchange between their stretches.

    On the CPU and with capture off, `drive_cards` eagerly. On the card
    with capture on: the first call drives them eagerly on side streams
    (one per card), the second captures each group's stretches as
    graphs of their own (segments, as `SegmentedStep` does; the
    vectors they yield are static outputs, the [ngroups, L] buffers the
    next stretch reads static inputs) and replays them with the
    exchange between them, later calls replay. A group whose rows split
    their layers across tp partner cards captures each stretch as ONE
    graph over its cards: the partners' side streams join the owner's
    capture by events, their allocations go to a private pool of their
    own, and they rejoin before the capture ends. The exchange (an NCCL
    all-gather over the owners' streams) runs between the graphs, not
    inside them. A capture that fails raises: there is no eager
    fallback. `graphs` counts the graphs one call replays, over every
    group."""

    def __init__(self, bodies: list[Callable], exchange: Callable,
                 groups: list, name: str = "step", steps: int = 1):
        super().__init__(name, steps)
        self.bodies = bodies
        self.exchange = exchange
        self.groups = groups        # parallel/mesh.py CardGroups
        self.gathers: dict[torch.device, int] = {}   # per replay, by owner
        self._segments: list[list[torch.cuda.CUDAGraph]] = []
        self._sends: list[list[torch.Tensor]] = []   # [segment][group]
        self._recvs: list[list[torch.Tensor]] = []
        self._noise: list[torch.Tensor] = []
        self._outs: list[tuple] = []
        self._sides: dict[torch.device, torch.cuda.Stream] = {}

    @property
    def graphs(self) -> int:
        return sum(len(s) for s in self._segments)

    @property
    def cards(self) -> list[torch.device]:
        return list(dict.fromkeys(d for g in self.groups
                                  for d in g.tp_devices))

    def _drive(self, states: list, noises: list) -> list:
        return drive_cards([body(s, u) for body, s, u in
                            zip(self.bodies, states, noises)],
                           self.exchange)

    def _side(self, device: torch.device) -> torch.cuda.Stream:
        if device not in self._sides:
            self._sides[device] = torch.cuda.Stream(device=device)
        return self._sides[device]

    def __call__(self, states: list, noises: list, capture: bool) -> list:
        if noises[0].device.type != "cuda" or not capture:
            return self._eager(self._drive, states, noises)
        if self._graph is None or self._bound is not states[0]:
            if self._warm is not states[0]:
                return self._warm_up_cards(states, noises)
            self._capture_cards(states, noises)
        return self._replay_cards(noises)

    def _warm_up_cards(self, states: list, noises: list) -> list:
        curs = {d: torch.cuda.current_stream(d) for d in self.cards}
        with contextlib.ExitStack() as stack:
            for d, cur in curs.items():
                self._side(d).wait_stream(cur)
                stack.enter_context(torch.cuda.stream(self._side(d)))
            stack.enter_context(torch.cuda.device(self.groups[0].owner))
            outs = self._eager(self._drive, states, noises)
        for d, cur in curs.items():
            cur.wait_stream(self._side(d))
        for out in outs:
            for _, v in _leaves(out):
                v.record_stream(torch.cuda.current_stream(v.device))
        self._warm = states[0]
        return outs

    @contextlib.contextmanager
    def _capture_group(self, graph: torch.cuda.CUDAGraph, group):
        owner = group.owner
        side = self._side(owner)
        partners = [d for d in dict.fromkeys(group.tp_devices)
                    if d != owner]
        # the graph's private pool, made before the capture so that the
        # partners' allocations can route to a pool of the same id
        pool = torch.cuda.graph_pool_handle()
        with torch.cuda.graph(graph, pool=pool, stream=side,
                              capture_error_mode="thread_local"):
            with contextlib.ExitStack() as stack:
                for d in partners:
                    stack.enter_context(torch.cuda.stream(self._side(d)))
                    stack.callback(_route_to_pool(d, pool))
                    weakref.finalize(graph, torch._C._cuda_releasePool,
                                     d.index, pool)
                    self._side(d).wait_stream(side)   # join the capture
                stack.enter_context(torch.cuda.device(owner))
                yield
                for d in partners:
                    side.wait_stream(self._side(d))   # and rejoin

    def _capture_cards(self, states: list, noises: list) -> None:
        self._graph = self._bound = None    # segments of another state
        n = len(self.groups)
        self._segments = [[] for _ in range(n)]
        self._sends, self._recvs = [], []
        self._outs = [None] * n
        self._noise = [torch.empty_like(u) for u in noises]
        self.gathers = {}
        owner0 = self.groups[0].owner
        mem0 = _memory(owner0)
        t0 = time.perf_counter()
        gens: list = [None] * n
        xs: list = [None] * n
        while True:
            sends = []
            for i, group in enumerate(self.groups):
                graph = torch.cuda.CUDAGraph()
                before = gather_rows.captured
                send = None
                with self._capture_group(graph, group):
                    try:
                        if gens[i] is None:
                            # made inside the first capture: what the
                            # body runs before its first yield is captured
                            gens[i] = self.bodies[i](states[i],
                                                     self._noise[i])
                            send = next(gens[i])
                        else:
                            send = gens[i].send(xs[i])
                    except StopIteration as stop:
                        self._outs[i] = pack_metrics(stop.value)
                self.gathers[group.owner] = (
                    self.gathers.get(group.owner, 0)
                    + gather_rows.captured - before)
                self._segments[i].append(graph)
                sends.append(send)
            if all(s is None for s in sends):
                break
            if any(s is None for s in sends):
                raise RuntimeError("the card groups' step bodies did not "
                                   "yield alike")
            self._sends.append(sends)
            xs = [torch.empty((self.exchange.nproc, s.numel()),
                              dtype=torch.float32, device=s.device)
                  for s in sends]
            self._recvs.append(xs)
        mem1 = _memory(owner0)
        CAPTURES.add({"name": self.name, "ms": (time.perf_counter() - t0)
                      * 1e3, "allocated_bytes": mem1[0] - mem0[0],
                      "reserved_bytes": mem1[1] - mem0[1]})
        self._graph, self._bound = self._segments[0][-1], states[0]

    def _replay_cards(self, noises: list) -> list:
        for buf, u in zip(self._noise, noises):
            buf.copy_(u)
        for s in range(len(self._segments[0])):
            for i, group in enumerate(self.groups):
                with torch.cuda.device(group.owner):
                    self._segments[i][s].replay()
            if s < len(self._sends):
                self.exchange(self._sends[s], self._recvs[s])
        for owner, k in self.gathers.items():
            count_launches(owner, k)
        return [unpack_metrics(vec.clone(), paths)
                for vec, paths in self._outs]


class AddGraph(_Captured):
    """One ingest add of g staged blocks: `body(state, inputs)` writes
    them at the replay's device cursor and advances it (device
    operations only, no host value read). On the card with capture on,
    `land` copies the host views into the graph's static inputs and the
    call warms up, captures and replays as `StepGraph` does; elsewhere
    `land` makes fresh device tensors and the call is the body. The
    caller advances the host cursor."""

    def __init__(self, body: Callable[[Any, dict], None],
                 name: str = "add", steps: int = 1):
        super().__init__(name, steps)
        self.body = body
        self.inputs: dict[str, torch.Tensor] | None = None  # static
        self.replays = 0

    def land(self, views: dict, lead: tuple, device: torch.device,
             graphed: bool) -> dict:
        """The add's host-to-device copies, asynchronous from pinned
        memory, on the caller's stream: into the static inputs when
        `graphed` (a replay of this graph earlier on the same stream has
        read them by then), else into fresh tensors."""
        def shaped(v):
            return v.reshape(lead + tuple(v.shape[1:]))

        if not graphed:
            return {k: shaped(v).to(device, non_blocking=True)
                    for k, v in views.items()}
        if self.inputs is None:
            self.inputs = {k: torch.empty(shaped(v).shape, dtype=v.dtype,
                                          device=device)
                           for k, v in views.items()}
        for k, v in views.items():
            self.inputs[k].copy_(shaped(v), non_blocking=True)
        return self.inputs

    def __call__(self, state, inputs: dict, capture: bool) -> None:
        dev = next(iter(inputs.values())).device
        if dev.type != "cuda" or not capture:
            self._eager(self.body, state, inputs)
            return
        if inputs is not self.inputs:
            raise ValueError(f"{self.name}: a graphed add reads its static "
                             f"inputs; land() the views first")
        if self._graph is None or self._bound is not state:
            if self._warm is not state:
                self._warm_up(self.body, state, inputs, dev)
                return
            self._capture(self.body, state, inputs, dev)
        self._graph.replay()
        self.replays += 1


class EvictGraph(_Captured):
    """The eviction plan and read of one `block`: `body(state)` ->
    (start, items, priorities), device operations only. On the card with
    capture on, the first call runs it eagerly on a side stream, the
    second captures and replays it, later calls replay; the outputs of a
    replay are the graph's static tensors, which the next replay
    overwrites (the caller copies them out first). Elsewhere the call is
    the body."""

    def __init__(self, body: Callable[[Any], tuple], name: str = "evict",
                 steps: int = 1):
        super().__init__(name, steps)
        self.body = body
        self.replays = 0
        self._out: tuple | None = None   # static outputs

    def __call__(self, state, device: torch.device, capture: bool) -> tuple:
        def run(s, _):
            return self.body(s)

        if device.type != "cuda" or not capture:
            return self._eager(run, state, None)
        if self._graph is None or self._bound is not state:
            if self._warm is not state:
                out = self._warm_up(run, state, None, device)
                cur = torch.cuda.current_stream(device)
                start, items, pri = out
                for t in (start, pri, *items.values()):
                    t.record_stream(cur)
                return out
            self._out = self._capture(run, state, None, device)
        self._graph.replay()
        self.replays += 1
        return self._out


class GraphedEndpoints:
    """The graph bookkeeping a learner shares: one `StepGraph` per
    endpoint body, the `capture` switch and the noise draw before a
    body. The host class provides `self.replay` (its `device` places
    the learner); its states carry `.replay` and `.generator`."""

    # on the card, replay captured graphs; False runs the bodies eagerly
    # there (the reference of the graph-vs-eager card tests and of the
    # eager timings), and it is not a fallback
    capture = True
    # leading shard axes of a staged block: 1 for the dp-sharded
    # learner's [dp, chunk, ...] blocks (parallel/dist_learner.py)
    shard_dims = 0
    # the per-SGD-step collective of a multi-process learner
    # (parallel/multihost.py: GradExchange); its step bodies are then
    # generators, run as one `ExchangedStep` graph when the exchange is
    # capturable, else as `SegmentedStep`s
    exchange = None

    def _weak_body(self, fn: Callable) -> Callable:
        """``fn(learner, state, x)`` as a graph body ``(state, x)`` that
        reaches this learner through a weak reference, so the graphs the
        learner holds do not hold it back (no reference cycle)."""
        ref = weakref.ref(self)
        return lambda state, x: fn(ref(), state, x)

    @property
    def graphed(self) -> bool:
        """Whether the endpoints replay captured graphs: on CUDA with
        `capture` on."""
        return self.capture and self.replay.device.type == "cuda"

    def _draw(self, state, batch: int,
              noise: torch.Tensor | None) -> torch.Tensor:
        """One draw's noise: the fed one, else the replay's draw from
        the state's generator (outside any step body)."""
        if noise is not None:
            return noise.to(self.replay.device)
        return self.replay.draw(state.replay, batch, state.generator)

    def _run(self, key, body: Callable, state, noise: torch.Tensor) -> dict:
        """Run the endpoint `key`'s graph; `body` is ``fn(learner,
        state, noise)`` (`_weak_body`)."""
        graphs = self.__dict__.setdefault("_graphs", {})
        if key not in graphs:
            # "step" runs one grad-step, ("k", k) a K-batch macro-step
            steps = key[1] if isinstance(key, tuple) else 1
            name = "train_step" if steps == 1 else f"train_step_k{steps}"
            name = f"{type(self).__name__}.{name}"
            body = self._weak_body(body)
            if self.exchange is None:
                graphs[key] = StepGraph(body, name=name, steps=steps)
            elif self.exchange.capturable:
                graphs[key] = ExchangedStep(body, self.exchange, name=name,
                                            steps=steps)
            else:
                graphs[key] = SegmentedStep(body, self.exchange, name=name,
                                            steps=steps)
        return graphs[key](state, noise, self.capture)

    def step_graphs(self) -> dict:
        """{endpoint key: StepGraph} built so far."""
        return dict(self.__dict__.get("_graphs", {}))

    def release_graphs(self) -> None:
        """Drop the step graphs (the next call captures anew). NCCL
        destroys no communicator while a CUDA graph holding one of its
        collectives lives, so a multi-process learner's graphs go before
        its process group does."""
        self.__dict__.pop("_graphs", None)

    # -- the ingest add ------------------------------------------------------

    def _add_graph(self, g: int) -> AddGraph:
        graphs = self.__dict__.setdefault("_add_graphs", {})
        if g not in graphs:
            graphs[g] = AddGraph(
                self._weak_body(
                    lambda lrn, s, ins: lrn._add_body(s, ins, g)),
                name=f"{type(self).__name__}.add_g{g}", steps=g)
        return graphs[g]

    def add_graphs(self) -> dict:
        """{g: AddGraph} built so far."""
        return dict(self.__dict__.get("_add_graphs", {}))

    def _add_body(self, state, inputs: dict, g: int) -> None:
        """g staged blocks at the replay's device cursor, in order
        (device operations only). g == 1: one block, without the
        leading g axis."""
        td = inputs["priorities"]
        items = {k: v for k, v in inputs.items() if k != "priorities"}
        if g == 1:
            self.replay.add_body(state.replay, items, td)
            return
        for j in range(g):
            self.replay.add_body(state.replay,
                                 {k: v[j] for k, v in items.items()}, td[j])

    def land_add(self, g: int, views: dict, lead: tuple) -> dict:
        """The host-to-device copies of one add of g staged blocks
        (views {key: [g * block, ...]} with "priorities", reshaped to
        `lead` + the leaf shape): into the add graph's static inputs
        when graphed, else fresh device tensors (AddGraph.land)."""
        return self._add_graph(g).land(views, lead, self.replay.device,
                                       self.graphed)

    def add_landed(self, state, g: int, inputs: dict):
        """The add of g landed blocks: one graph replay per (replay, g)
        on the card, the body elsewhere; then the host cursor advances
        by the g blocks it wrote. -> state."""
        self._add_graph(g)(state, inputs, self.capture)
        td = inputs["priorities"]
        block = td.shape[(1 if g > 1 else 0) + self.shard_dims]
        for _ in range(g):
            self.replay.advance_host(state.replay, block)
        return state

    # -- the cold tier's eviction swap -------------------------------------

    def swap_graphs(self) -> dict:
        """{"evict": EvictGraph, "add_at": AddGraph} built so far."""
        return dict(self.__dict__.get("_swap_graphs", {}))

    def _swap_graph(self, key: str, block: int):
        graphs = self.__dict__.setdefault("_swap_graphs", {})
        if key not in graphs:
            name = f"{type(self).__name__}.{key}_b{block}"
            replay = self.replay
            if key == "evict":
                body = self._weak_body(
                    lambda lrn, s, _: lrn._evict_body(s, block))
                graphs[key] = EvictGraph(lambda s: body(s, None), name=name,
                                         steps=block)
            else:
                graphs[key] = AddGraph(
                    lambda s, ins: replay.add_body(
                        s.replay,
                        {k: v for k, v in ins.items()
                         if k not in ("priorities", "start")},
                        ins["priorities"], ins["start"]),
                    name=name, steps=block)
        return graphs[key]

    def _evict_body(self, state, block: int) -> tuple:
        start = self.replay.evict_plan(state.replay, block)
        items, pri = self.replay.read_region(state.replay, start, block)
        return start, items, pri

    def evict_landed(self, state, block: int) -> tuple:
        """The eviction plan and read of `block` units: -> (start 0-dim,
        staging-layout items, leaf priorities) on the device; on the
        card with capture on, the evict graph's static outputs, which
        its next replay overwrites."""
        return self._swap_graph("evict", block)(
            state, self.replay.device, self.capture)

    def land_add_at(self, views: dict, lead: tuple) -> dict:
        """The host-to-device copies of one directed add (views {key:
        [block, ...]} with "priorities", reshaped to `lead` + the leaf
        shape; lead (dp, block) for stacked shards): into the add_at
        graph's static inputs when graphed, else fresh device tensors;
        with a "start" slot the add reads (one per shard)."""
        graph = self._swap_graph("add_at", lead[-1])
        inputs = graph.land(views, lead, self.replay.device, self.graphed)
        if "start" not in inputs:
            inputs["start"] = torch.zeros(lead[:-1], dtype=torch.int64,
                                          device=self.replay.device)
        return inputs

    def add_at_landed(self, state, inputs: dict, start: torch.Tensor,
                      start_host):
        """The directed add of one landed block at the device `start`
        (an evict result, copied into inputs["start"] on the device):
        one replay of the add_at graph on the card, the body elsewhere;
        then the host cursor follows the directed write from
        `start_host`, the same start fetched to the host by the caller
        (one per shard for stacked shards). -> state."""
        inputs["start"].copy_(start)
        block = inputs["priorities"].shape[self.shard_dims]
        self._swap_graph("add_at", block)(state, inputs, self.capture)
        self.replay.advance_host_at(state.replay, start_host, block)
        return state
