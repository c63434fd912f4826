"""The port's perf plane (obs/profiling.py) against the JAX package's:

- stage windows on one fake clock, with the same per-step roofs (the
  original reads them from a compiled jit's cost analysis, the port
  from its analytic cost), publish the same mfu / hbm_bw_frac /
  device_ms gauges;
- the regression engine fires the same attributed events on one rate
  stream and one clock;
- the analytic FLOPs counted over one eager loss step of a small
  dueling Nature-CNN equal the closed-form count of its convolutions
  and matrix products: three forward passes (online on obs; online and
  target on next_obs, for the double-DQN bootstrap) and the backward of
  the first (a weight gradient for every layer, an input gradient for
  every layer but the first);
- the capture telemetry turns the capture log into counters and
  ``hbm/<graph>/...`` records.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.obs import profiling as jprof
from ape_x_dqn_tpu_torch.configs import (LearnerConfig, NetworkConfig,
                                         ObsConfig)
from ape_x_dqn_tpu_torch.envs.base import EnvSpec
from ape_x_dqn_tpu_torch.models import build_network, init_params
from ape_x_dqn_tpu_torch.obs import profiling as tprof
from ape_x_dqn_tpu_torch.obs.core import build_obs
from ape_x_dqn_tpu_torch.replay.frame_ring import FrameRingReplay
from ape_x_dqn_tpu_torch.runtime import step_graph
from ape_x_dqn_tpu_torch.runtime.learner import DQNLearner
from ape_x_dqn_tpu_torch.utils.rng import component_generator
from tests.test_torch_step_graph import _ring_segments


class GaugeSink:
    def __init__(self):
        self.gauges, self.counts = [], []

    def gauge(self, name, value):
        self.gauges.append((name, round(float(value), 12)))

    def count(self, name, n=1.0):
        self.counts.append((name, n))


class Compiled:
    """What the original reads its roofs from."""

    def __init__(self, flops, nbytes):
        self._cost = {"flops": flops, "bytes accessed": nbytes}

    def cost_analysis(self):
        return [self._cost]


@pytest.mark.parametrize("stage,steps,flops,nbytes", [
    ("train", 8, 3.2e11, 4.1e9),
    ("ingest", 96, 0.0, 2.7e8),
    ("sample_k", 4, 1.0e9, 9.9e8),
    ("learn_k", 4, 2.5e11, 3.0e9),
])
def test_stage_windows_publish_the_same_gauges(monkeypatch, stage, steps,
                                               flops, nbytes):
    durations = [0.012, 0.0131, 0.0119, 0.02, 0.0125]
    out = []
    for mod in (jprof, tprof):
        clock = {"t": 50.0, "i": 0}

        def tick():
            # window start and end alternate: each window lasts the next
            # duration
            if clock["i"] % 2:
                clock["t"] += durations[clock["i"] // 2]
            clock["i"] += 1
            return clock["t"]

        monkeypatch.setattr(mod.time, "perf_counter", tick)
        sink = GaugeSink()
        prof = mod.StageProfiler(sink, peak_flops=989.4e12, peak_bw=3.35e12)
        if mod is jprof:
            prof.attach(stage, steps, compiled=Compiled(flops, nbytes))
        else:
            prof.attach(stage, steps, cost=(flops, nbytes))
        for n in (steps, steps, steps // 2 or 1, steps, steps):
            with prof.window(stage, n):
                pass
        if mod is tprof:
            # the port queues its windows until a publish reads them
            assert sink.gauges == []
            assert prof.flush() == 5
        out.append(sink.gauges)
    assert out[0] == out[1] and len(out[1]) >= 10


def test_the_card_peaks_and_the_cpu_proxy():
    assert tprof._PEAKS[0] == ("NVIDIA H100 80GB HBM3", 989.4e12, 3.35e12)
    if not torch.cuda.is_available():
        assert tprof.device_peaks() == (
            (tprof.os.cpu_count() or 1) * tprof._CPU_PEAK_FLOPS_PER_CORE,
            tprof._CPU_PEAK_BW)


def test_perf_monitor_fires_the_same_events(monkeypatch):
    rates = [100, 101, 99, 100, 102, 98, 100, 101, 100, 30, 31, 100, 20]
    out = []
    for mod in (jprof, tprof):
        now = {"t": 1000.0}
        monkeypatch.setattr(mod.time, "monotonic", lambda: now["t"])
        sink, events, fires = GaugeSink(), [], []
        metrics = SimpleNamespace(log=lambda step, **kw: events.append(
            (step, kw)))
        mon = mod.PerfMonitor(sink, metrics, frac=0.5, alpha=0.1,
                              min_samples=8, cooldown_s=30.0)
        mon.add_listener(lambda *a: fires.append(a))
        for i, r in enumerate(rates):
            now["t"] += 5.0
            mon.observe("grad_steps_per_s", r, step=i)
            mon.observe("env_fps", r * 10, step=i, peer="host-a")
        out.append((sink.gauges, sink.counts, events, fires))
    assert out[0] == out[1]
    assert out[1][2], "no degradation fired"


def _closed_form_flops(obs, channels, kernels, strides, dense, actions,
                       batch):
    """Convolution and matrix-product FLOPs (2 per multiply-add) of one
    loss step: 3 forwards, and the backward of one without the first
    layer's input gradient."""
    h, w, c = obs
    layers = []
    for oc, k, s in zip(channels, kernels, strides):
        h, w = (h - k) // s + 1, (w - k) // s + 1
        layers.append(2 * h * w * oc * k * k * c)
        c = oc
    layers.append(2 * h * w * c * dense)                 # torso_out
    layers.append(2 * dense * 1 + 2 * dense * actions)   # value, advantage
    fwd = batch * sum(layers)
    return 3 * fwd + 2 * fwd - batch * layers[0]


def test_analytic_flops_of_a_dueling_nature_cnn_loss_step():
    obs, batch, actions = (52, 52, 4), 16, 6
    channels, kernels, strides, dense = (8, 16, 16), (8, 4, 3), (4, 2, 1), 32
    spec = EnvSpec(obs, np.dtype(np.uint8), True, actions)
    net = build_network(NetworkConfig(
        kind="nature_cnn", dueling=True, cnn_channels=channels,
        torso_dense=dense, compute_dtype="float32"), spec)
    init_params(net, component_generator(0, "net_init"))
    replay = FrameRingReplay(1024, 8, 3, obs, device="cpu")
    learner = DQNLearner(replay, LearnerConfig(batch_size=batch))
    state = learner.init(net, replay.init(),
                         component_generator(0, "learner"))
    items, td = _ring_segments(64, 0, obs=obs)
    learner.add(state, {k: torch.from_numpy(v) for k, v in items.items()},
                torch.from_numpy(td))
    tprof.want_costs(True)
    try:
        learner.train_step(state)
    finally:
        tprof.want_costs(False)
    graph = learner.step_graphs()["step"]
    flops, nbytes = graph.cost
    assert flops == _closed_form_flops(obs, channels, kernels, strides,
                                       dense, actions, batch)
    # the bytes count at least the gathered frame rows and the network
    params = sum(p.numel() * 4 for p in net.parameters())
    assert nbytes > 2 * batch * 4 * replay.frame_row + 4 * params
    # no cost is counted while nobody wants one
    learner.train_step(state)
    assert learner.step_graphs()["step"].cost == graph.cost


def test_capture_telemetry_publishes_counters_and_memory():
    metrics = SimpleNamespace(records=[])
    metrics.log = lambda step, **kw: metrics.records.append(kw)
    obs = build_obs(ObsConfig(enabled=True), metrics)
    step_graph.CAPTURES.add({"name": "DQNLearner.add_g1", "ms": 12.5,
                             "allocated_bytes": 1024,
                             "reserved_bytes": 2 << 20})
    obs.publish(3)
    obs.publish(4)
    obs.close(5)
    keys = {k: v for r in metrics.records for k, v in r.items()}
    assert keys["hbm/DQNLearner.add_g1/reserved_bytes"] == 2 << 20
    assert keys["hbm/DQNLearner.add_g1/allocated_bytes"] == 1024
    assert keys["ctr/graph_captures"] == 1
    assert keys["ctr/graph_capture_ms"] == 12.5
    # the telemetry counts the captures since the Obs began, once
    assert sum(1 for r in metrics.records
               if "hbm/DQNLearner.add_g1/reserved_bytes" in r) == 1
