"""Fleet telemetry across the two packages (obs/fleet.py): a frame that
one package's `build_frame` writes merges in the other package's
`FleetAggregator` exactly as in its own, both ways, on one fake clock:
the same JSONL records under ``peer/<id>/...``, the same remote
heartbeats for the stall watchdog, the same counters and the same
per-peer rate. Then the wire: an actor host's `StampingTransport` and
`TelemetryEmitter` of one package ship through that package's socket
transport to the other package's `SocketIngestServer`, whose hook hands
the frames to its aggregator."""

import json
import time

import numpy as np
import pytest

from ape_x_dqn_tpu import configs as jcfgs
from ape_x_dqn_tpu.comm import socket_transport as jsock
from ape_x_dqn_tpu.obs import core as jcore
from ape_x_dqn_tpu.obs import fleet as jfleet
from ape_x_dqn_tpu.obs import health as jhealth
from ape_x_dqn_tpu_torch import configs as tcfgs
from ape_x_dqn_tpu_torch.comm import socket_transport as tsock
from ape_x_dqn_tpu_torch.obs import core as tcore
from ape_x_dqn_tpu_torch.obs import fleet as tfleet
from ape_x_dqn_tpu_torch.obs import health as thealth

PKGS = {"jax": (jcfgs, jcore, jfleet, jhealth, jsock),
        "torch": (tcfgs, tcore, tfleet, thealth, tsock)}


class RecMetrics:
    def __init__(self):
        self.records = []

    def log(self, step, **kw):
        self.records.append({"step": int(step), **kw})


def _host_obs(pkg, seed):
    cfgs, core = PKGS[pkg][:2]
    obs = core.build_obs(cfgs.ObsConfig(enabled=True, blackbox=False),
                         RecMetrics())
    rng = np.random.default_rng(seed)
    obs.register("actor-0")
    obs.beat("actor-1", "frame 96")
    obs.observe_many("infer_latency_ms", rng.lognormal(1, 1, 20))
    obs.count("param_pull_errors", 2)
    obs.gauge("server_queue_depth", 3)
    return obs


def _learner(pkg):
    cfgs, core, fleet = PKGS[pkg][:3]
    metrics = RecMetrics()
    obs = core.build_obs(cfgs.ObsConfig(enabled=True, blackbox=False),
                         metrics)
    obs.set_learner_step(40)
    return obs, fleet.FleetAggregator(obs), metrics


@pytest.fixture
def clock(monkeypatch):
    now = {"t": 500.0}
    for mods in PKGS.values():
        for mod in (mods[2], mods[3]):
            monkeypatch.setattr(mod.time, "monotonic", lambda: now["t"])
            monkeypatch.setattr(mod.time, "time", lambda: 1.7e9 + now["t"])
    return now


def _merged(writer, reader, clock, seed):
    host = _host_obs(writer, seed)
    fleet = PKGS[writer][2]
    obs, agg, metrics = _learner(reader)
    for seq, rows in ((0, 100), (1, 340), (2, 580), (2, 999)):
        clock["t"] += 1.0
        frame = json.loads(json.dumps(fleet.build_frame(
            host, "host-a", seq, events=[["actor.ship", 0.0, 0.25,
                                          {"batch_id": seq, "rows": 8}]],
            rows_out=rows)))
        agg.on_frame("host-a", frame)
    agg.on_disconnect("host-a")
    counters = obs.registry.snapshot_frame()
    return (metrics.records, counters, obs.heartbeats.ages(),
            sorted(agg.retained_frames()), obs.tracer.aggregates())


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("seed", [0, 3])
def test_a_frame_merges_alike_in_both_aggregators(clock, writer, seed):
    start = clock["t"]
    theirs = _merged(writer, "jax", clock, seed)
    clock["t"] = start
    ours = _merged(writer, "torch", clock, seed)
    assert ours == theirs
    records = ours[0]
    assert any("peer/host-a/hb/actor-1" in r for r in records)
    assert any(r.get("peer/host-a/gauge/ingest_rate") == 240.0
               for r in records)
    assert ours[1]["ctr"]["telemetry_frames"] == 3


@pytest.mark.parametrize("host_pkg,server_pkg", [("jax", "torch"),
                                                 ("torch", "jax")])
def test_frames_cross_the_wire_both_ways(host_pkg, server_pkg):
    obs, agg, metrics = _learner(server_pkg)
    server = PKGS[server_pkg][4].SocketIngestServer("127.0.0.1", 0)
    assert agg.install(server)
    host_obs = _host_obs(host_pkg, 1)
    fleet = PKGS[host_pkg][2]
    client = fleet.StampingTransport(
        PKGS[host_pkg][4].SocketTransport("127.0.0.1", server.port),
        "host-b")
    emitter = fleet.TelemetryEmitter(client, host_obs, "host-b",
                                     interval_s=0.0)
    try:
        client.send_experience({"priorities": np.ones(4, np.float32),
                                "x": np.arange(4, dtype=np.int32)})
        batch = None
        deadline = time.monotonic() + 10
        while batch is None and time.monotonic() < deadline:
            batch = server.recv_experience(timeout=0.2)
        assert batch is not None
        assert int(batch.get("batch_id")) == 0
        assert str(batch.get("peer")) == "host-b"
        for _ in range(3):
            assert emitter.pump_once()
        deadline = time.monotonic() + 10
        while agg.peers != ["host-b"] or server.telemetry_frames < 3:
            assert time.monotonic() < deadline, "no telemetry arrived"
            time.sleep(0.05)
    finally:
        client.close()
        server.stop()
    assert obs.registry.counter("telemetry_frames").value == 3
    assert "host-b/actor-1" in obs.heartbeats.ages()
    assert any(r.get("peer/host-b/ctr/param_pull_errors") == 2
               for r in metrics.records)
