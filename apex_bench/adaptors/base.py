"""What the learner adaptors share: the seed's weights in the port's
nets, the warm-up and the return to the seed's state, the first
macro-step's readings, and the learner's window.

An adaptor is a module of this package, named by a configuration's
``adaptor`` key. Its ``Program(conf, traffic, seed, devices)`` is the
system under test, and the harness calls, in this order:

- ``set_up(mark)``: everything before the first timed call (`mark(name)`
  records the time of a stage); it keeps ``readings``, what the
  reference module's ``compare`` judges;
- ``window(seconds, spans) -> {"metrics": {end-to-end metric: value},
  "attempted", "failed", "detail"}``: the measured window, timed by the
  adaptor itself, with the benchmark's host spans around its calls;
- ``traced() -> DeviceTrace`` (``--trace 1``): a stretch of the same
  traffic under ``torch.profiler``;
- ``devices()``, ``close()``.

It names its plain reference in ``REFERENCE`` (a module of
``apex_bench/reference/`` with ``follow``, ``compare`` and ``NAMES``).
A learner adaptor subclasses `Learner`: it builds the port's learner and
state with the port's own constructors, as ``ApexDriver`` builds them,
and fills the replay through the port's add path. These modules are the
only part of the benchmark that imports the port.

The learner's window: ``train_many`` dispatches of ``train_chunk``
grad-steps, closed loop, at most ``in_flight`` in flight (each waited
for by its event, as the driver's learner thread waits), and a
publication at every ``publish_every`` boundary the grad-step count
crosses. ``grad_steps_per_s`` is every grad-step dispatched in the
window over the window's seconds, read after a final synchronise.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from apex_bench import inputs
from apex_bench.trace import DeviceTrace, Spans, profiled, sync


def port_config(conf: dict):
    """The port's RunConfig for configuration file `conf`: its preset
    with every size the file states put over it, so that the file is
    what runs even if the preset changes."""
    from ape_x_dqn_tpu_torch.configs import get_config

    cfg = get_config(conf["preset"])
    parts = {}
    for part in ("network", "replay", "learner", "parallel"):
        if part in conf:
            vals = {k: tuple(v) if isinstance(v, list) else v
                    for k, v in conf[part].items()}
            parts[part] = dataclasses.replace(getattr(cfg, part), **vals)
    return cfg.replace(**parts)


def env_spec(conf: dict):
    from ape_x_dqn_tpu_torch.envs.base import EnvSpec

    return EnvSpec(obs_shape=tuple(conf["env"]["obs_shape"]),
                   obs_dtype=np.dtype(np.uint8), discrete=True,
                   num_actions=conf["env"]["num_actions"])


class Learner:
    """One cell's learner and state. Subclasses set ``self.learner``,
    ``self.state`` and ``self.w0`` (the seed's weights, which they load
    with `_load`) in ``__init__`` and define `fill`."""

    def __init__(self, conf: dict, traffic: dict, seed: int,
                 devices: list[torch.device]):
        self.conf, self.traffic, self.seed = conf, traffic, seed
        self.device = devices[0]
        self.cfg = port_config(conf)
        self.chunk = traffic["train_chunk"]
        self.k = conf["learner"]["sample_chunk"]
        self._pinned: dict[str, torch.Tensor] = {}
        self._tree0: torch.Tensor | None = None
        self.readings: dict = {}
        self.done = 0    # grad-steps since the return to the seed's state

    def _load(self, weights: dict) -> None:
        """The seed's weights into the online and target nets, in place
        (the captured graphs hold these tensors)."""
        self.state.net.load_state_dict(weights, strict=True)
        self.state.target_net.load_state_dict(weights, strict=True)

    def devices(self) -> list[torch.device]:
        return [self.device]

    def fill(self) -> None:
        raise NotImplementedError

    def set_up(self, mark) -> None:
        """Fill the whole replay, warm up and settle, then the first
        macro-step through the window's own call (its readings kept)."""
        self.fill()
        sync(self.devices())
        mark("filled")
        self.warm()
        sync(self.devices())
        mark("warm")
        self.readings = self.first_steps()
        self.done = self.k

    def window(self, seconds: float, spans: Spans) -> dict:
        t0 = time.perf_counter()
        steps = self._drive(spans, seconds=seconds)
        sync(self.devices())
        window_s = time.perf_counter() - t0
        return {"metrics": {"grad_steps_per_s": steps / window_s},
                "attempted": steps, "failed": 0,
                "detail": {"window_s": window_s, "grad_steps": steps}}

    def traced(self) -> DeviceTrace:
        """``trace_dispatches`` more dispatches under the profiler."""
        n = self.traffic["trace_dispatches"]
        return profiled(self.devices(), lambda spans: {
            "macro_steps": self._drive(spans, dispatches=n) // self.k})

    def _drive(self, spans: Spans, seconds: float | None = None,
               dispatches: int | None = None) -> int:
        """Closed-loop dispatches until `seconds` pass (or `dispatches`
        have run), publications at ``publish_every`` crossings. ->
        grad-steps dispatched."""
        cuda = self.device.type == "cuda"
        limit, every = self.traffic["in_flight"], self.traffic["publish_every"]
        in_flight = collections.deque()
        start, n = self.done, 0
        end = None if seconds is None else time.perf_counter() + seconds
        while (time.perf_counter() < end) if end is not None \
                else n < dispatches:
            if len(in_flight) >= limit:
                with spans.span("wait"):
                    while len(in_flight) >= limit:
                        in_flight.popleft().synchronize()
            with spans.span("dispatch"):
                self.dispatch()
            if cuda:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(self.device))
                in_flight.append(ev)
            n += 1
            before, self.done = self.done, self.done + self.chunk
            if before // every != self.done // every:
                with spans.span("publish"):
                    self.publish()
        return self.done - start

    def _filled(self) -> None:
        """Keep the full replay's sum-tree, for the return to the
        seed's state after the warm-up."""
        self._tree0 = self.state.replay.tree.clone()

    def warm(self) -> None:
        """The window's shapes once each: two dispatches (the eager
        warm-up, the capture and its replay) and a publication; then
        ``settle_s`` seconds of dispatches, two in flight (a process's
        first seconds of training on a card run up to 9% slower, for a
        time that varies from run to run: PERF.md). Then the state goes
        back to the seed's, in place: weights, Adam, tree, step count,
        and the draw's generator seeded for the first macro-step."""
        for _ in range(2):
            self.dispatch()
        self.publish()
        if self.device.type == "cuda":
            end = time.perf_counter() + self.traffic["settle_s"]
            pending = []
            while time.perf_counter() < end:
                self.dispatch()
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(self.device))
                pending.append(ev)
                if len(pending) >= 2:
                    pending.pop(0).synchronize()
            sync(self.devices())
        self._reset()
        self._tree0 = None
        self.state.generator.manual_seed(inputs.noise_seed(self.seed))

    def _reset(self) -> None:
        """Weights, Adam, sum-tree and step count back to the seed's."""
        st = self.state
        self._load(self.w0)
        opt = st.opt_state
        opt.count.zero_()
        for t in (*opt.mu, *opt.nu):
            t.zero_()
        st.replay.tree.copy_(self._tree0)
        st.step = 0

    def first_steps(self) -> dict:
        """The first macro-step through the window's own call, then one
        publication. -> the readings the check compares (host copies:
        on the CPU `.cpu()` would alias the live tensors)."""
        self.state, m = self.learner.train_many(self.state, self.k)
        pub = self.publish()
        mu, leaves = self._moments_and_leaves()
        return {"loss": float(m["loss"]),
                "mu": {n: t.detach().to("cpu", copy=True)
                       for n, t in mu.items()},
                "published": {n: pub[n].clone() for n in mu},
                "leaves": leaves.to("cpu", copy=True)}

    def _moments_and_leaves(self) -> tuple[dict, torch.Tensor]:
        """-> ({param name: Adam's first moment}, the sum-tree's leaves
        of every shard, flat in global order)."""
        names = [n for n, _ in self.state.net.named_parameters()]
        cap = self.learner.replay.capacity
        return (dict(zip(names, self.state.opt_state.mu)),
                self.state.replay.tree[..., cap:].reshape(-1))

    def dispatch(self) -> None:
        self.state, _ = self.learner.train_many(self.state, self.chunk)

    def publish(self) -> dict:
        """The driver's publication to the inference side: a device
        copy of the params, then into pinned host buffers, waiting for
        the caller's stream (which drains the dispatches in flight). ->
        the host copies."""
        pub = self.learner.publish_params(self.state)
        cuda = self.device.type == "cuda"
        for k, v in pub.items():
            buf = self._pinned.get(k)
            if buf is None:
                buf = self._pinned[k] = torch.empty(
                    v.shape, dtype=v.dtype, pin_memory=cuda)
            buf.copy_(v, non_blocking=cuda)
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()
        return self._pinned

    def close(self) -> None:
        self.learner.release_graphs()
        self.learner = self.state = self.w0 = self.readings = None
