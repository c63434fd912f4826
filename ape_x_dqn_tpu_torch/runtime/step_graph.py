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
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ape_x_dqn_tpu_torch.ops.frame_gather import gather_rows


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


class StepGraph:
    def __init__(self, body: Callable[[Any, torch.Tensor], dict]):
        self.body = body
        self.gathers = 0           # gather launches one replay carries
        self._warm = None          # the state the eager warm-up ran on
        self._bound = None         # the state the graph was captured on
        self._graph: torch.cuda.CUDAGraph | None = None
        self._stream: torch.cuda.Stream | None = None
        self._noise: torch.Tensor | None = None   # static input
        self._out: torch.Tensor | None = None     # static packed metrics
        self._paths: list[tuple] = []

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self, state, noise: torch.Tensor, capture: bool) -> dict:
        if noise.device.type != "cuda" or not capture:
            return self.body(state, noise)
        if self._graph is None or self._bound is not state:
            if self._warm is not state:
                return self._warm_up(state, noise)
            self._capture(state, noise)
        return self._replay(noise)

    def _side_stream(self, device: torch.device) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=device)
        return self._stream

    def _warm_up(self, state, noise: torch.Tensor) -> dict:
        cur = torch.cuda.current_stream(noise.device)
        side = self._side_stream(noise.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.body(state, noise)
        cur.wait_stream(side)
        for _, v in _leaves(out):
            v.record_stream(cur)
        self._warm = state
        return out

    def _capture(self, state, noise: torch.Tensor) -> None:
        self._graph = self._bound = None    # a graph of another state
        static = torch.empty_like(noise)
        graph = torch.cuda.CUDAGraph()
        before = gather_rows.captured
        # thread_local: the driver's other threads keep using the card
        # (on other streams) while this thread captures
        with torch.cuda.graph(graph, stream=self._side_stream(noise.device),
                              capture_error_mode="thread_local"):
            out, paths = pack_metrics(self.body(state, static))
        self.gathers = gather_rows.captured - before
        self._graph, self._noise, self._out, self._paths = (
            graph, static, out, paths)
        self._bound = state

    def _replay(self, noise: torch.Tensor) -> dict:
        self._noise.copy_(noise)
        self._graph.replay()
        gather_rows.launches += self.gathers
        return unpack_metrics(self._out.clone(), self._paths)


class GraphedEndpoints:
    """The graph bookkeeping a learner shares: one `StepGraph` per
    endpoint body, the `capture` switch and the noise draw before a
    body. The host class provides `self.replay` (its `device` places
    the learner); its states carry `.replay` and `.generator`."""

    # on the card, replay captured graphs; False runs the bodies eagerly
    # there (the reference of the graph-vs-eager card tests and of the
    # eager timings), and it is not a fallback
    capture = True

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
        graphs = self.__dict__.setdefault("_graphs", {})
        if key not in graphs:
            graphs[key] = StepGraph(body)
        return graphs[key](state, noise, self.capture)

    def step_graphs(self) -> dict:
        """{endpoint key: StepGraph} built so far."""
        return dict(self.__dict__.get("_graphs", {}))
