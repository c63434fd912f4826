"""Obs facade: one object the runtime threads spans, metrics and beats
into.

Counterpart of ``ape_x_dqn_tpu/obs/core.py``. Drivers build one `Obs`
from `configs.ObsConfig` and hand it to their components (actors,
ingest, learner loop, inference server). Every call site goes through
this facade, so the disabled path is a method call on the `NullObs`
singleton, with no conditionals in runtime code; observability is off
in every preset.

The enabled facade is the original's, on the card's own means:
- stage windows are CUDA event pairs on the stage's stream, read at
  publish time (obs/profiling.py), never a synchronisation in the loop;
- the stage roofs are analytic costs counted over the eager warm-up
  before each capture (`profiling.count_cost`), not compiler cost
  analyses;
- `log_compiled` logs each captured graph's allocator growth under
  ``hbm/<graph>/...``, and graph captures replace jit compiles in the
  telemetry (`graph_captures`, `graph_capture_ms`);
- ``ObsConfig.jax_profile_dir`` keeps its name (configs.py is a pinned
  copy) and opens a ``torch.profiler`` window (`ProfileWindow`).

First-class Ape-X health instruments (Horgan et al. 2018 §4):
- hist `sample_age_steps`: learner grad-step minus the grad-step at
  which a sampled transition was written (`SampleAgeTracker`, a host
  mirror of the replay's write cursor advanced by the counts the caller
  adds).
- hist `param_lag_steps`: learner grad-step minus the param version
  the inference server served a batch with (actor parameter lag).
- hist `td_abs`: per-dispatch mean |TD| (the priority signal).
- hist `server_batch_items`: dynamic-batching fill.
- gauges `replay_occupancy`, `server_queue_depth`, counters for adds,
  dispatches, stall strikes.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
from typing import Any

import numpy as np

from ape_x_dqn_tpu_torch.obs.blackbox import NULL_BLACKBOX, FlightRecorder
from ape_x_dqn_tpu_torch.obs.health import (
    HeartbeatRegistry, HeartbeatWatchdog, StallError)
from ape_x_dqn_tpu_torch.obs.registry import (MetricRegistry,
                                              geometric_edges)
from ape_x_dqn_tpu_torch.obs.trace import NULL_TRACER, SpanTracer

AGE_EDGES = geometric_edges(1.0, 1e6, per_decade=4)
LAG_EDGES = geometric_edges(1.0, 1e5, per_decade=4)
TD_EDGES = geometric_edges(1e-3, 1e3, per_decade=4)
BATCH_EDGES = tuple(float(2 ** i) for i in range(12))
# inference request latency (enqueue -> result scatter), milliseconds
LATENCY_EDGES = geometric_edges(0.1, 1e4, per_decade=4)
# per-dispatch training loss (learning-health plane, obs/learning.py):
# wide geometric range because a loss spike IS the signal
LOSS_EDGES = geometric_edges(1e-6, 1e3, per_decade=2)


class NullObs:
    """No-op twin: the runtime threads call this when obs is disabled.
    Keeps method-for-method parity with Obs."""

    enabled = False
    tracer = NULL_TRACER
    watchdog = None
    heartbeats = None
    profiler = None
    perf = None
    learn = None
    blackbox = NULL_BLACKBOX

    def span(self, name: str, **args: Any):
        return NULL_TRACER.span(name)

    def stage_window(self, stage: str, steps: int = 1, stream=None):
        return NULL_TRACER.span(stage)

    def stage_attach(self, stage: str, steps: int = 1, cost=None,
                     cost_fn=None) -> None:
        pass

    def stage_attached(self, stage: str) -> bool:
        # True: disabled obs never wants the attach path
        return True

    def perf_rate(self, name: str, value, step: int = 0,
                  peer: str = "") -> None:
        pass

    def learn_health(self, diag, loss, step: int = 0,
                     tenant: str = "") -> None:
        pass

    def mark(self, name: str, **args: Any) -> None:
        pass

    def register(self, name: str) -> None:
        pass

    def beat(self, name: str, note: str = "") -> None:
        pass

    def clear(self, name: str) -> None:
        pass

    def check_stalled(self) -> None:
        pass

    def observe(self, hist: str, value) -> None:
        pass

    def observe_many(self, hist: str, values) -> None:
        pass

    def gauge(self, name: str, value) -> None:
        pass

    def count(self, name: str, n: float = 1.0) -> None:
        pass

    def set_learner_step(self, step: int) -> None:
        pass

    def on_server_batch(self, items: int, params_version: int,
                        queue_depth: int) -> None:
        pass

    def age_tracker(self, capacity: int) -> "SampleAgeTracker | None":
        return None

    def observe_sample_ages(self, ages) -> None:
        pass

    def log_compiled(self, tag: str, compiled) -> None:
        pass

    def maybe_profile(self, step: int) -> None:
        pass

    def publish(self, step: int) -> None:
        pass

    def close(self, step: int = 0) -> None:
        pass


NULL_OBS = NullObs()


class SampleAgeTracker:
    """Host-side mirror of a replay ring's write cursor.

    The device state records no write times, and a step body must not
    read the host. But ring writes are sequential with skip-to-head
    wrap (replay/packing.ring_write_start), so the host can mirror the
    cursor exactly from the block sizes it adds: `on_add` stamps the
    written slots with the current grad-step, and `ages(idx, step)`
    maps sampled slot indices back to write steps. Slots are the
    replay's leaves (transitions, or sequences); the frame ring wraps at
    whole segments, so it calls `on_add` with each segment block's
    transitions. The cursor is never read from the device."""

    def __init__(self, capacity: int):
        self._write_step = np.zeros(capacity, np.int64)
        self._pos = 0
        self._cap = capacity

    def on_add(self, n: int, grad_step: int) -> None:
        if n <= 0:
            return
        n = min(n, self._cap)
        # skip-to-head: a block that would cross the ring boundary
        # restarts at slot 0 (must match replay/packing.ring_write_start)
        start = self._pos if self._pos + n <= self._cap else 0
        self._write_step[start:start + n] = grad_step
        self._pos = (start + n) % self._cap

    def ages(self, idx, grad_step: int) -> np.ndarray:
        slots = np.asarray(idx).ravel()
        return grad_step - self._write_step[slots]

    def ages_at_distances(self, dists, grad_step: int) -> np.ndarray:
        """Ages of the slots `dists` leaves behind the cursor (the ring
        distances the learner's in-graph `sample_age_p50/p90` report):
        the grad-step view of those order statistics."""
        d = np.asarray(dists, np.float64).ravel().astype(np.int64)
        slots = np.remainder(self._pos - 1 - d, self._cap)
        return grad_step - self._write_step[slots]


class ProfileWindow:
    """A ``torch.profiler`` capture of `steps` grad-steps into
    `out_dir`, opened by the first `step` call and closed by the first
    call `steps` later (or `close`): one capture per window. The
    profiler is process-wide, so a window that finds another open skips
    its capture and says so."""

    _active_lock = threading.Lock()
    _active: "ProfileWindow | None" = None  # guarded-by: _active_lock

    def __init__(self, out_dir: str, steps: int):
        self.out_dir = out_dir
        self.steps = max(int(steps), 1)
        self.state: bool | None = False   # armed / tracing / done
        self.path: str | None = None
        self._from = 0
        self._prof = None

    def step(self, step: int) -> bool:
        """-> True when this call closed the capture (its trace is
        written)."""
        if self.state is None:
            return False
        if self.state is False:
            self._open(step)
            return False
        if step - self._from >= self.steps:
            self.close()
            return True
        return False

    def _open(self, step: int) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        with ProfileWindow._active_lock:
            if ProfileWindow._active is not None:
                logging.getLogger(__name__).warning(
                    "a torch.profiler window is already open; %s gets "
                    "no capture", self.out_dir)
                self.state = None
                return
            ProfileWindow._active = self
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._from = step
        self.state = True

    def close(self) -> None:
        if self.state is not True:
            self.state = None
            return
        self.state = None
        try:
            self._prof.__exit__(None, None, None)
            os.makedirs(self.out_dir, exist_ok=True)
            self.path = os.path.join(
                self.out_dir,
                f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json")
            self._prof.export_chrome_trace(self.path)
        finally:
            self._prof = None
            with ProfileWindow._active_lock:
                ProfileWindow._active = None


class Obs:
    """Live observability session for one driver run."""

    enabled = True

    def __init__(self, cfg, metrics):
        """cfg: configs.ObsConfig (enabled already checked by build_obs);
        metrics: the run's utils.metrics.Metrics sink."""
        self.cfg = cfg
        self.metrics = metrics
        self.tracer = (SpanTracer(cfg.trace_path, cfg.trace_max_events)
                       if cfg.trace_path else NULL_TRACER)
        self.registry = MetricRegistry()
        self.heartbeats = HeartbeatRegistry()
        self.watchdog = (HeartbeatWatchdog(self.heartbeats,
                                           cfg.heartbeat_timeout_s)
                         if cfg.heartbeat_timeout_s > 0 else None)
        # seed the first-class instruments so a short run publishes
        # empty histograms rather than omitting the keys entirely
        self.registry.histogram("sample_age_steps", AGE_EDGES)
        self.registry.histogram("param_lag_steps", LAG_EDGES)
        self.registry.histogram("td_abs", TD_EDGES)
        self.registry.histogram("server_batch_items", BATCH_EDGES)
        self.registry.histogram("infer_latency_ms", LATENCY_EDGES)
        self.registry.histogram("learn_loss", LOSS_EDGES)
        self._learner_step = 0
        # the torch.profiler window (ObsConfig.jax_profile_dir keeps the
        # original's name)
        self._prof = (ProfileWindow(cfg.jax_profile_dir,
                                    cfg.jax_profile_steps)
                      if getattr(cfg, "jax_profile_dir", "") else None)
        self._closed = False
        # continuous perf plane (obs/profiling.py): roofline gauges,
        # capture telemetry and the EWMA regression engine, each
        # knob-gated as in the original
        from ape_x_dqn_tpu_torch.obs import learning, profiling

        self.profiler = (profiling.StageProfiler(
            self,
            peak_flops=getattr(cfg, "device_peak_flops", 0.0),
            peak_bw=getattr(cfg, "device_peak_bytes_per_s", 0.0))
            if getattr(cfg, "profile_gauges", True) else None)
        self._wants_costs = self.profiler is not None
        if self._wants_costs:
            profiling.want_costs(True)
        self._capture_telemetry = (
            profiling.CaptureTelemetry()
            if getattr(cfg, "compile_telemetry", True) else None)
        self.perf = (profiling.PerfMonitor(
            self, metrics,
            frac=getattr(cfg, "perf_frac", 0.5),
            alpha=getattr(cfg, "perf_ewma_alpha", 0.1),
            min_samples=getattr(cfg, "perf_min_samples", 8),
            cooldown_s=getattr(cfg, "perf_cooldown_s", 30.0))
            if getattr(cfg, "perf_regression", True) else None)
        # learning-health plane (obs/learning.py): warn-only anomaly
        # engine over the in-graph learner diagnostics
        self.learn = (learning.LearnMonitor(
            self, metrics,
            spike_mult=getattr(cfg, "learn_spike_mult", 10.0),
            alpha=getattr(cfg, "learn_ewma_alpha", 0.2),
            min_samples=getattr(cfg, "learn_min_samples", 8),
            cooldown_s=getattr(cfg, "learn_cooldown_s", 30.0))
            if getattr(cfg, "learn_health", True) else None)
        # forensics plane (obs/blackbox.py): per-process flight
        # recorder, dumped on crash/stall/SIGUSR2/supervisor request.
        # The dump dir rides next to the run JSONL; in-memory-metrics
        # runs fall back to the system temp dir, never the CWD
        if getattr(cfg, "blackbox", True):
            bb_dir = (getattr(cfg, "blackbox_dir", "")
                      or os.path.dirname(
                          getattr(getattr(metrics, "_fh", None),
                                  "name", "") or "")
                      or tempfile.gettempdir())
            self.blackbox = FlightRecorder(
                self, out_dir=bb_dir,
                capacity=getattr(cfg, "blackbox_capacity", 512),
                log_lines=getattr(cfg, "blackbox_log_lines", 64))
            # attributed degradation events flow into the ring so the
            # box tells the story leading up to the dump
            if self.perf is not None:
                self.perf.add_listener(self._blackbox_perf_event)
            if self.learn is not None:
                self.learn.add_listener(self._blackbox_learn_event)
        else:
            self.blackbox = NULL_BLACKBOX

    def _blackbox_perf_event(self, name, value, baseline, step,
                             peer) -> None:
        self.blackbox.record("perf_degradation", component=name,
                             peer=peer, value=round(float(value), 4),
                             baseline=round(float(baseline), 4),
                             step=int(step))

    def _blackbox_learn_event(self, rule, value, baseline, step,
                              tenant) -> None:
        self.blackbox.record("learning_degradation", component=rule,
                             tenant=tenant, value=round(float(value), 4),
                             baseline=round(float(baseline), 4),
                             step=int(step))

    # -- tracing -----------------------------------------------------------

    def span(self, name: str, **args: Any):
        return self.tracer.span(name, **args)

    def mark(self, name: str, **args: Any) -> None:
        self.tracer.mark(name, **args)

    # -- heartbeats / watchdog ---------------------------------------------

    def register(self, name: str) -> None:
        self.heartbeats.register(name)

    def beat(self, name: str, note: str = "") -> None:
        self.heartbeats.beat(name, note)

    def clear(self, name: str) -> None:
        self.heartbeats.clear(name)

    def check_stalled(self) -> None:
        """Called from the driver's (alive) supervisory loop; raises
        StallError attributing the stalest silent component."""
        if self.watchdog is not None:
            try:
                self.watchdog.check()
            except StallError as e:
                # the stall rides the JSONL stream too, so offline
                # report sees it even when the raise is swallowed
                self.count("stall_errors")
                self.metrics.log(self._learner_step,
                                 stall_component=e.component,
                                 stall_staleness_s=e.staleness_s,
                                 stall_note=e.last_note)
                # archive the box BEFORE closing: the StallError is a
                # terminal event and the ring is its evidence
                self.blackbox.record("stall", component=e.component,
                                     staleness_s=round(e.staleness_s, 1),
                                     note=e.last_note)
                self.blackbox.dump("stall", component=e.component,
                                   step=self._learner_step)
                # flush the trace + final snapshot NOW: the artifacts
                # matter most on the crash path
                self.close(self._learner_step)
                raise

    # -- instruments -------------------------------------------------------

    def observe(self, hist: str, value) -> None:
        self.registry.histogram(hist).observe(float(value))

    def observe_many(self, hist: str, values) -> None:
        self.registry.histogram(hist).observe_many(values)

    def gauge(self, name: str, value) -> None:
        self.registry.gauge(name).set(float(value))

    def count(self, name: str, n: float = 1.0) -> None:
        self.registry.counter(name).inc(n)

    # -- staleness hooks ---------------------------------------------------

    def set_learner_step(self, step: int) -> None:
        # plain int attr write: GIL-atomic, read by the server thread
        self._learner_step = int(step)

    def on_server_batch(self, items: int, params_version: int,
                        queue_depth: int) -> None:
        """Inference-server hook, once per served batch: parameter lag
        is how many grad-steps the served params trail the learner."""
        self.observe("server_batch_items", items)
        self.observe("param_lag_steps",
                     max(self._learner_step - int(params_version), 0))
        self.gauge("server_queue_depth", queue_depth)
        self.beat("inference-server", f"batch of {items}")

    def age_tracker(self, capacity: int) -> SampleAgeTracker:
        return SampleAgeTracker(capacity)

    def observe_sample_ages(self, ages) -> None:
        self.observe_many("sample_age_steps", ages)

    # -- continuous perf plane (obs/profiling.py) --------------------------

    def stage_window(self, stage: str, steps: int = 1, stream=None):
        """Device-time window around a stage: CUDA events on `stream`
        (read at publish time), or the host clock without one (the
        synchronous CPU path). Publishes the stage's mfu / hbm_bw_frac
        / device_ms gauges when read. A no-op context when the roofline
        gauges are knob-disabled."""
        if self.profiler is None:
            return NULL_TRACER.span(stage)
        return self.profiler.window(stage, steps, stream=stream)

    def stage_attach(self, stage: str, steps: int = 1, cost=None,
                     cost_fn=None) -> None:
        if self.profiler is not None:
            self.profiler.attach(stage, steps, cost=cost, cost_fn=cost_fn)

    def stage_attached(self, stage: str) -> bool:
        return self.profiler is None or self.profiler.attached(stage)

    def perf_rate(self, name: str, value, step: int = 0,
                  peer: str = "") -> None:
        """Feed one throughput-rate sample to the EWMA regression
        engine (warn-only PerfDegradation events)."""
        if self.perf is not None:
            self.perf.observe(name, value, step=step, peer=peer)

    # -- learning-health plane (obs/learning.py) ---------------------------

    def learn_health(self, diag, loss, step: int = 0,
                     tenant: str = "") -> None:
        """Publish one host-read learner diagnostic snapshot (the
        metrics["diag"] dict, as floats: the caller fetched it where it
        already synchronises) as `learn_*` gauges + the loss hist, and
        feed the warn-only LearnMonitor."""
        from ape_x_dqn_tpu_torch.obs import learning

        vals = {k: float(v) for k, v in dict(diag).items()}
        learning.publish_learn(self, vals, tenant=tenant)
        loss = float(loss)
        self.observe("learn_loss", loss)
        if self.learn is not None:
            self.learn.observe(vals, loss, step=step, tenant=tenant)

    # -- the card ------------------------------------------------------------

    def log_compiled(self, tag: str, compiled) -> None:
        """Record one captured graph's memory into the JSONL under
        ``hbm/<tag>/...``: `compiled` is its capture-log entry
        (runtime/step_graph.py: CAPTURES), whose byte fields are the
        caching allocator's growth across the capture."""
        if not getattr(self.cfg, "hbm_dump", True):
            return
        summary = {k: v for k, v in dict(compiled).items()
                   if k.endswith("_bytes")}
        if summary:
            self.metrics.log(self._learner_step,
                             **{f"hbm/{tag}/{k}": v
                                for k, v in summary.items()})

    def maybe_profile(self, step: int) -> None:
        """Opt-in torch.profiler window (ObsConfig.jax_profile_dir):
        trace `jax_profile_steps` grad-steps starting at the first
        call, device activity included."""
        if self._prof is not None and self._prof.step(step):
            self.metrics.log(step, profile_trace=self._prof.out_dir)

    # -- publication -------------------------------------------------------

    def publish(self, step: int) -> None:
        """Snapshot every instrument + the span aggregates into one
        JSONL record (`span/<name>` dicts carry the stage-time
        breakdown obs/report.py prints), after reading the stage
        windows that have completed."""
        self.set_learner_step(step)
        # cheap periodic anchor: every dump's ring shows when the last
        # healthy publish happened, whatever else it recorded
        self.blackbox.record("publish", step=int(step))
        if self.profiler is not None:
            self.profiler.flush()
        if self._capture_telemetry is not None:
            self._capture_telemetry.publish_into(self)
        agg = self.tracer.aggregates()
        extra = {f"span/{name}": stats for name, stats in agg.items()}
        self.registry.publish(self.metrics, step, extra=extra)

    def close(self, step: int = 0) -> None:
        if self._closed:
            return
        self._closed = True
        if self._prof is not None:  # run ended inside the window
            self._prof.close()
        if self.profiler is not None:
            self.profiler.flush(wait=True)
        self.publish(step)
        self.tracer.close()
        # crash hooks must not outlive the session that owns the ring
        self.blackbox.uninstall()
        if self._wants_costs:
            from ape_x_dqn_tpu_torch.obs import profiling

            profiling.want_costs(False)
            self._wants_costs = False


def build_obs(obs_cfg, metrics) -> Obs | NullObs:
    """NULL_OBS unless the config exists and is enabled — drivers call
    this with `getattr(cfg, "obs", None)` so configs predating ObsConfig
    keep working."""
    if obs_cfg is None or not getattr(obs_cfg, "enabled", False):
        return NULL_OBS
    return Obs(obs_cfg, metrics)
