"""Continuous perf observability: device-time attribution, graph-capture
telemetry, and a perf-regression engine.

Counterpart of ``ape_x_dqn_tpu/obs/profiling.py``, on the card's own
means:

- `StageProfiler` — per-stage windows around the learner's graph
  replays and the ingest adds. On the card a window is a pair of CUDA
  events recorded on the stream the stage runs on (the learner's or
  ingest's), so it measures device time without synchronising anything:
  the pairs wait in a queue and are read at publish time, once their
  end event has fired (`flush`). On the CPU every stage is synchronous
  and a window is the host clock around it, as in the original, queued
  the same way. With the stage's analytic cost each read publishes the
  stage's `mfu`, `hbm_bw_frac` and `device_ms` gauges.
- `count_cost` — the analytic cost of one eager run of a step body,
  which stands in for the original's `compiled.cost_analysis()`: FLOPs
  from ``torch.utils.flop_counter.FlopCounterMode``, bytes from
  `_TrafficMode` (every operator reads each tensor argument once and
  writes each output once; a view moves nothing; an indexed read or
  write moves the rows it touches, not the whole tensor indexed; the
  row-gather kernel's launches add their own bytes). The graphs replay
  the same kernels as the eager run (a CUDA graph fuses nothing), so
  the count is the graph's traffic up to L2 hits and library internals.
- `CaptureTelemetry` — graph captures instead of the original's jit
  compiles: the `graph_captures` and `graph_capture_ms` counters, and
  each capture's allocator growth under ``hbm/<graph>/...`` (from
  runtime/step_graph.py's `CAPTURES`).
- `PerfMonitor` — a copy: rolling EWMA baselines over grad-steps/s,
  env-fps and ingest rows/s with an attributed, warn-only
  `perf_degradation` event when a window falls below a fraction of its
  baseline.

- `publish_multichip` — a copy: the dp-scaling gauges (the per-shard
  replay fill bounds; the dp-scaling efficiency where a caller measured
  it).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ape_x_dqn_tpu_torch.obs.health import make_lock

# -- device peaks ----------------------------------------------------------

# card peak (dense bf16 FLOP/s, HBM bytes/s) by device-name prefix, from
# the data sheet; the MFU and hbm_bw_frac denominators. Overridable via
# ObsConfig so a new card doesn't silently report against the wrong roof.
_PEAKS = (
    ("NVIDIA H100 80GB HBM3", 989.4e12, 3.35e12),
    ("NVIDIA H100 SXM", 989.4e12, 3.35e12),
)
# CPU-host fallback, per core: deliberately generous (AVX-class FMA
# throughput) so a smoke run's MFU stays a sane fraction < 1 — the CPU
# number is a development proxy, not a claim about the host
_CPU_PEAK_FLOPS_PER_CORE = 64e9
_CPU_PEAK_BW = 40e9


def device_peaks(device=None) -> tuple[float, float]:
    """(peak FLOP/s, peak HBM bytes/s) of the card (`device`, default
    the current one) by ``torch.cuda.get_device_name``; the CPU proxy
    without a card, or for a CPU `device`."""
    cpu = device is not None and torch.device(device).type != "cuda"
    if torch.cuda.is_available() and not cpu:
        name = torch.cuda.get_device_name(device)
        for prefix, flops, bw in _PEAKS:
            if name.lower().startswith(prefix.lower()):
                return flops, bw
    cores = os.cpu_count() or 1
    return cores * _CPU_PEAK_FLOPS_PER_CORE, _CPU_PEAK_BW


def train_step_flops_analytic(batch_size: int, num_actions: int = 18,
                              dense: int = 512) -> float:
    """Analytic FLOP/step of the flagship dueling Nature-CNN train step
    (models/qnets.py shapes: 84x84x4 -> conv 32x8s4 -> 64x4s2 -> 64x3s1
    -> dense 512 -> dueling heads), the count of the original's bench
    (``bench.py: train_step_flops_analytic``): the double-DQN loss runs
    the online net on obs with its gradient (~3x a forward), the online
    net on next_obs and the target net on next_obs (1x each), so 5x one
    forward's MACs, 2 FLOPs per MAC. Elementwise, optimizer and replay
    work is left out (bandwidth-, not FLOP-bound). The MFU numerator of
    utils/batch_study.py."""
    convs = [  # (out_h, out_w, c_out, k, c_in)
        (20, 20, 32, 8, 4),
        (9, 9, 64, 4, 32),
        (7, 7, 64, 3, 64),
    ]
    macs = sum(h * w * co * k * k * ci for h, w, co, k, ci in convs)
    macs += 7 * 7 * 64 * dense            # torso dense
    macs += dense * (num_actions + 1)     # dueling heads
    return 2.0 * macs * batch_size * 5.0


# -- analytic cost -----------------------------------------------------------

_costs_lock = threading.Lock()
_costs_wanted = 0  # guarded-by: _costs_lock


def want_costs(on: bool) -> None:
    """Count (on) or release (off) one wish for step costs: while any
    stands, the first eager run of each step body is counted
    (runtime/step_graph.py). An enabled Obs with its roofline gauges on
    holds one for its life."""
    global _costs_wanted
    with _costs_lock:
        _costs_wanted = max(_costs_wanted + (1 if on else -1), 0)


def costs_wanted() -> bool:
    with _costs_lock:
        return _costs_wanted > 0


# operators that read (index) or write (index_put) the rows of a tensor
# that an index selects: the indexed tensor counts for the rows touched,
# which is the output's size (reads) or the values' size (writes)
_INDEXED_READS = {"index", "index_select", "gather", "take", "embedding"}
_INDEXED_WRITES = {"index_put", "index_put_", "index_copy", "index_copy_",
                   "scatter", "scatter_", "index_add", "index_add_",
                   "put_"}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


class _TrafficMode(TorchDispatchMode):
    """Bytes every operator dispatched under it reads and writes (see
    the module docstring for the rule)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        name = func.overloadpacket.__name__
        outs = sum(_nbytes(t) for t in tree_leaves(out))
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if name in _INDEXED_READS:
            # the indexed source: as many bytes as the rows read out
            n = outs + sum(_nbytes(t) for t in ins[1:]) + outs
        elif name in _INDEXED_WRITES:
            # the index and values read, the values' bytes written
            n = sum(_nbytes(t) for t in ins[1:]) + _nbytes(ins[-1])
        else:
            n = outs + sum(_nbytes(t) for t in ins)
        self.bytes += n
        return out


def count_cost(fn: Callable[[], Any]) -> tuple[Any, float, float]:
    """Run `fn()` once, eagerly, counting it. -> (its result, FLOPs,
    bytes moved)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ape_x_dqn_tpu_torch.ops.frame_gather import gather_rows

    moved0 = gather_rows.bytes_moved
    flops = FlopCounterMode(display=False)
    traffic = _TrafficMode()
    with flops, traffic:
        out = fn()
    nbytes = traffic.bytes + gather_rows.bytes_moved - moved0
    return out, float(flops.get_total_flops()), float(nbytes)


# -- graph-capture telemetry -------------------------------------------------


class CaptureTelemetry:
    """Per-Obs view over the process-wide capture log
    (runtime/step_graph.py: CAPTURES): at each publish, the captures
    since the last as counters (so a run's JSONL carries only ITS
    captures, not an earlier run's in the same process), and each one's
    allocator growth through `obs.log_compiled`."""

    def __init__(self):
        from ape_x_dqn_tpu_torch.runtime.step_graph import CAPTURES

        self._log = CAPTURES
        self._seen = len(CAPTURES.since(0))

    def publish_into(self, obs) -> None:
        new = self._log.since(self._seen)
        self._seen += len(new)
        if new:
            obs.count("graph_captures", len(new))
            obs.count("graph_capture_ms", sum(e["ms"] for e in new))
        for e in new:
            obs.log_compiled(e["name"], e)


# -- device-time attribution ----------------------------------------------

# the observed stage vocabulary; every member has literal gauge
# emission sites in _publish_stage below, as in the original
# ("train_dist" is the dp-sharded learner's dispatch)
STAGES = ("sample_k", "learn_k", "train", "train_dist", "ingest")


class StageProfiler:
    """Device-time windows + analytic roofs for the learner's stages.
    A window on a stream queues a CUDA event pair, read by `flush` once
    it has fired (never a synchronisation in the loop); a window without
    a stream is host wall time (the synchronous CPU path)."""

    def __init__(self, obs, peak_flops: float = 0.0,
                 peak_bw: float = 0.0, ewma_alpha: float = 0.25,
                 max_pending: int = 4096):
        self._obs = obs
        self._alpha = ewma_alpha
        self._lock = make_lock("profiling.stages")
        # stage -> {"flops_per_step", "bytes_per_step", "ms"(ewma)}
        self._stages: dict[str, dict[str, float]] = {}  # guarded-by: _lock
        # (stage, steps, start event, end event), oldest first
        self._pending: deque = deque(maxlen=max_pending)  # guarded-by: _lock
        self._peak_flops = peak_flops
        self._peak_bw = peak_bw

    def _peaks(self) -> tuple[float, float]:
        if not self._peak_flops or not self._peak_bw:
            flops, bw = device_peaks()
            self._peak_flops = self._peak_flops or flops
            self._peak_bw = self._peak_bw or bw
        return self._peak_flops, self._peak_bw

    def attached(self, stage: str) -> bool:
        with self._lock:
            st = self._stages.get(stage)
            return st is not None and st["flops_per_step"] + \
                st["bytes_per_step"] > 0

    def attach(self, stage: str, steps: int = 1,
               cost: tuple[float, float] | None = None,
               cost_fn: Callable[[], tuple[float, float] | None]
               | None = None) -> None:
        """Record a stage's per-step FLOP/byte roof from the analytic
        `cost` (flops, bytes) of a run covering `steps` steps (or the
        lazy `cost_fn`). A stage attached without a cost may be attached
        again once one is known."""
        if self.attached(stage):
            return
        if cost is None and cost_fn is not None:
            cost = cost_fn()
        flops, nbytes = cost if cost is not None else (0.0, 0.0)
        steps = max(int(steps), 1)
        with self._lock:
            st = self._stages.setdefault(stage, {"ms": 0.0})
            st["flops_per_step"] = flops / steps
            st["bytes_per_step"] = nbytes / steps

    @contextmanager
    def window(self, stage: str, steps: int = 1, stream=None):
        """Time the body: by a CUDA event pair on `stream`, or by the
        host clock without one. Either way the window waits in the queue
        until `flush` reads it (so a roof attached meanwhile prices it)."""
        if stream is None:
            t0 = time.perf_counter()
            yield
            wall = time.perf_counter() - t0
            with self._lock:
                self._pending.append((stage, steps, wall, None))
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        yield
        end.record(stream)
        with self._lock:
            self._pending.append((stage, steps, start, end))

    def flush(self, wait: bool = False) -> int:
        """Record the queued windows in order: host-clock ones at once,
        event ones whose end has fired (all of them, waiting, when
        `wait`: teardown only). -> the windows recorded."""
        done = []
        with self._lock:
            while self._pending:
                end = self._pending[0][3]
                if not (end is None or wait or end.query()):
                    break
                done.append(self._pending.popleft())
        for stage, steps, start, end in done:
            if end is None:
                self.record(stage, start, steps)
                continue
            end.synchronize()  # fired already, unless `wait`
            self.record(stage, start.elapsed_time(end) / 1e3, steps)
        return len(done)

    def record(self, stage: str, wall_s: float, steps: int = 1) -> None:
        if wall_s <= 0.0:
            return
        peak_flops, peak_bw = self._peaks()
        with self._lock:
            st = self._stages.get(stage)
            if st is None:
                st = self._stages[stage] = {
                    "flops_per_step": 0.0, "bytes_per_step": 0.0,
                    "ms": 0.0}
            ms = wall_s * 1e3
            st["ms"] = ms if st["ms"] == 0.0 else (
                (1 - self._alpha) * st["ms"] + self._alpha * ms)
            flops = st.get("flops_per_step", 0.0) * steps
            nbytes = st.get("bytes_per_step", 0.0) * steps
            dev_ms = st["ms"]
        mfu = (flops / wall_s) / peak_flops if flops else 0.0
        bw = (nbytes / wall_s) / peak_bw if nbytes else 0.0
        _publish_stage(self._obs, stage, mfu, bw, dev_ms)


def _publish_stage(obs, stage: str, mfu: float, bw_frac: float,
                   dev_ms: float) -> None:
    """Literal per-stage gauge emissions (one spelled-out branch per
    stage, as in the original)."""
    if stage == "sample_k":
        obs.gauge("mfu_sample_k", mfu)
        obs.gauge("hbm_bw_frac_sample_k", bw_frac)
        obs.gauge("device_ms_sample_k", dev_ms)
    elif stage == "learn_k":
        obs.gauge("mfu_learn_k", mfu)
        obs.gauge("hbm_bw_frac_learn_k", bw_frac)
        obs.gauge("device_ms_learn_k", dev_ms)
    elif stage == "train":
        obs.gauge("mfu_train", mfu)
        obs.gauge("hbm_bw_frac_train", bw_frac)
        obs.gauge("device_ms_train", dev_ms)
    elif stage == "train_dist":
        obs.gauge("mfu_train_dist", mfu)
        obs.gauge("hbm_bw_frac_train_dist", bw_frac)
        obs.gauge("device_ms_train_dist", dev_ms)
    elif stage == "ingest":
        # staging/ship is a pure-bandwidth stage: no MFU roof
        obs.gauge("hbm_bw_frac_ingest", bw_frac)
        obs.gauge("device_ms_ingest", dev_ms)


# -- perf-regression engine ------------------------------------------------


def publish_multichip(obs, efficiency: float | None = None,
                      fill_min: float | None = None,
                      fill_max: float | None = None) -> None:
    """Literal gauge emissions for the dp-scaling plane:

    - dp_scaling_efficiency: grad-steps/s at dp normalized by dp x the
      dp=1 rate — 1.0 is linear scaling. Published only where a dp=1
      baseline was measured; live driver runs carry the fill gauges.
    - replay_shard_fill_min / _max: bounds of per-shard replay
      occupancy fractions. Lockstep ingest keeps these equal; a gap
      means shards are filling unevenly and the stratified sampler is
      over-sampling (and down-weighting) the starved shards.

    None skips a gauge — callers publish what they actually measured.
    """
    if efficiency is not None:
        obs.gauge("dp_scaling_efficiency", efficiency)
    if fill_min is not None:
        obs.gauge("replay_shard_fill_min", fill_min)
    if fill_max is not None:
        obs.gauge("replay_shard_fill_max", fill_max)


class PerfMonitor:
    """Rolling EWMA baselines over throughput rates; a window below
    `frac` of its baseline emits ONE attributed PerfDegradation obs
    event per cooldown — a warning in the artifact, never an exception
    (deliberately distinct from StallError: slow is survivable,
    silent is not)."""

    def __init__(self, obs, metrics, frac: float = 0.5,
                 alpha: float = 0.1, min_samples: int = 8,
                 cooldown_s: float = 30.0):
        self._obs = obs
        self._metrics = metrics
        self.frac = frac
        self._alpha = alpha
        self._min_samples = min_samples
        self._cooldown_s = cooldown_s
        self._lock = make_lock("profiling.perf_monitor")
        # (peer, name) -> {"ewma", "n", "last_fire"}
        self._series: dict[tuple[str, str], dict] = {}  # guarded-by: _lock
        # fire listeners (the remediation plane subscribes here):
        # called OUTSIDE the monitor lock, once per emitted event, with
        # (name, value, baseline, step, peer). Append-only at wiring
        # time, so iteration is safe without the lock.
        self._listeners: list = []

    def add_listener(self, cb) -> None:
        self._listeners.append(cb)

    def observe(self, name: str, value: float, step: int = 0,
                peer: str = "") -> None:
        value = float(value)
        if value != value or value < 0.0:  # NaN / nonsense rate
            return
        now = time.monotonic()
        fire = False
        baseline = 0.0
        with self._lock:
            s = self._series.setdefault((peer, name), {
                "ewma": value, "n": 0, "last_fire": 0.0})
            baseline = s["ewma"]
            degraded = (s["n"] >= self._min_samples
                        and baseline > 0.0
                        and value < self.frac * baseline)
            if degraded and now - s["last_fire"] >= self._cooldown_s:
                s["last_fire"] = now
                fire = True
            # the baseline keeps absorbing the new regime (slowly):
            # a persistent slowdown fires once per cooldown, then
            # becomes the new normal rather than alerting forever
            s["ewma"] = (1 - self._alpha) * baseline + self._alpha * value
            s["n"] += 1
        if not peer:
            self._publish_local(name, baseline if baseline else value)
        if fire:
            self._obs.count("perf_degradations")
            self._metrics.log(
                step, perf_degradation=name,
                perf_peer=peer or None,
                perf_value=round(value, 3),
                perf_baseline=round(baseline, 3),
                perf_frac=self.frac)
            for cb in self._listeners:
                try:
                    cb(name, value, baseline, step, peer)
                except Exception:  # noqa: BLE001 - warn-only plane
                    logging.getLogger(__name__).warning(
                        "perf-degradation listener failed",
                        exc_info=True)

    def _publish_local(self, name: str, ewma: float) -> None:
        # literal emissions per tracked local rate
        if name == "grad_steps_per_s":
            self._obs.gauge("ewma_grad_steps_per_s", ewma)
        elif name == "env_fps":
            self._obs.gauge("ewma_env_fps", ewma)
        elif name == "ingest_rows_per_s":
            self._obs.gauge("ewma_ingest_rows_per_s", ewma)
