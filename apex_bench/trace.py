"""Host spans and the device trace of a run, as the metric readers see
them.

Spans are the benchmark's own: a host-clock interval around each call
into the program (``dispatch``, ``publish``) and each wait for an
in-flight dispatch (``wait``). In a traced run the same names mark the
profiled stretch as ``torch.profiler.record_function`` ranges
(``bench.<name>``), so each idle gap on the device can be named by the
host span it falls in.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch


class Spans:
    """{name: [seconds]} of the measured window."""

    def __init__(self):
        self.seconds: dict[str, list[float]] = {}
        self.traced = False

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = (torch.profiler.record_function(f"bench.{name}")
               if self.traced else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            yield
        if not self.traced:
            self.seconds.setdefault(name, []).append(
                time.perf_counter() - t0)


@dataclass
class DeviceTrace:
    """The profiled stretch: device operations (name, start_us, end_us,
    device index), the benchmark's host ranges (name, start_us,
    end_us), its length, and what the adaptor counted in it ({name:
    count}, e.g. ``macro_steps``)."""
    ops: list = field(default_factory=list)
    host: list = field(default_factory=list)
    window_s: float = 0.0
    counts: dict = field(default_factory=dict)


def sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def profiled(devices, body) -> DeviceTrace:
    """`body(spans)` under ``torch.profiler``, the spans as
    ``record_function`` ranges, every card synchronised before and
    after. `body` returns its counts ({name: count})."""
    from torch.profiler import ProfilerActivity, profile

    spans = Spans()
    spans.traced = True
    sync(devices)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        counts = body(spans)
        sync(devices)
        window = time.perf_counter() - t0
    ops, host = read_profile(prof)
    return DeviceTrace(ops=ops, host=host, window_s=window, counts=counts)


def _event_us(e) -> tuple[float, float]:
    if hasattr(e, "start_ns"):
        start = e.start_ns() / 1e3
        return start, start + e.duration_ns() / 1e3
    start = e.start_us()
    return start, start + e.duration_us()


def read_profile(prof) -> tuple[list, list]:
    """-> (device operations, bench host ranges) of a finished
    ``torch.profiler.profile``, from its raw kineto events (the parsed
    event tree would cost seconds per 100k kernels)."""
    ops, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith("bench."):
            # the host range, and its copy on the device's timeline (a
            # user annotation, not an operation)
            if e.device_type() != cuda:
                host.append((name[len("bench."):], *_event_us(e)))
        elif e.device_type() == cuda:
            ops.append((name, *_event_us(e), e.device_index()))
    return ops, host


def union_busy_us(intervals: list[tuple[float, float]]) -> tuple[float,
                                                                  list]:
    """-> (length of the union of the intervals, the gaps between its
    pieces as (start, end))."""
    busy, gaps = 0.0, []
    end = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps
