"""The port's offline report (obs/report.py) and postmortem bundler
(obs/postmortem.py) against the JAX package's: one run's JSONL, written
through the port's enabled facade (spans, staleness histograms, stage
gauges, learning health, fleet telemetry, a stall, remediation
decisions, a flight-recorder dump), prints the same text through both
report modules, in the text, --json and --check modes, and the same
postmortem bundle and timeline."""

import contextlib
import io
import json
import time

import numpy as np
import pytest

from ape_x_dqn_tpu.obs import postmortem as jpm
from ape_x_dqn_tpu.obs import report as jreport
from ape_x_dqn_tpu_torch.configs import ObsConfig
from ape_x_dqn_tpu_torch.obs import postmortem as tpm
from ape_x_dqn_tpu_torch.obs import report as treport
from ape_x_dqn_tpu_torch.obs.core import build_obs
from ape_x_dqn_tpu_torch.obs.fleet import FleetAggregator
from ape_x_dqn_tpu_torch.obs.health import StallError
from ape_x_dqn_tpu_torch.obs.profiling import _publish_stage
from ape_x_dqn_tpu_torch.utils.metrics import Metrics


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A run's JSONL and flight-recorder dump, from the port's facade."""
    d = tmp_path_factory.mktemp("run")
    jsonl = d / "run.jsonl"
    metrics = Metrics(log_path=str(jsonl))
    obs = build_obs(ObsConfig(enabled=True, trace_path=str(d / "t.json"),
                              heartbeat_timeout_s=0.05), metrics)
    metrics.log(0, run_name="pong", version="0.2.0", sample_chunk=4,
                replay_kind="prioritized", replay_storage="frame_ring",
                batch_size=512, train_chunk=8, dp=1, tp=1)
    agg = FleetAggregator(obs)
    rng = np.random.default_rng(0)
    for step in (100, 200, 300):
        obs.set_learner_step(step)
        for _ in range(5):
            with obs.span("learner.train", k=8):
                time.sleep(0.001)
            with obs.span("replay.add", units=96):
                pass
            obs.mark("replay.sample", fused_into="learner.train")
            obs.on_server_batch(int(rng.integers(1, 128)), step - 8, 2)
        obs.observe_many("infer_latency_ms", rng.lognormal(1, 1, 30))
        obs.observe_sample_ages(rng.integers(0, 5000, 16))
        _publish_stage(obs, "train", 0.021 * step / 100, 0.08, 12.6)
        _publish_stage(obs, "ingest", 0.0, 0.011, 0.31)
        obs.count("graph_captures", 3)
        obs.count("graph_capture_ms", 140.0)
        obs.learn_health({"td_abs_p50": 0.4, "td_abs_p90": 1.3,
                          "q_mean": 2.0, "q_max": 7.5, "is_ess_frac": 0.9,
                          "update_ratio": 3e-4, "priority_top_frac": 0.02,
                          "sample_age_p50": 900.0, "sample_age_p90": 4e3},
                         0.05, step=step, tenant="pong")
        agg.on_frame("host-a", {"peer": "host-a", "seq": step,
                                "hb": {"actor-4": [0.2, "frame 9"]},
                                "ctr": {"param_pull_errors": 1},
                                "gauge": {"server_queue_depth": 1.0},
                                "rows_out": step * 10})
        metrics.log(step, loss=0.05, q_mean=2.0, frames=step * 600,
                    frames_per_s=600.0, grad_steps_per_s=9.5,
                    avg_return=-20.0, replay_size=step * 500)
        metrics.log(step, remediation="observed", remediation_rule=
                    "ingest-pressure", remediation_target="slot-3",
                    remediation_action="pause_actor")
        obs.publish(step)
    obs.blackbox.set_peer("driver-1")
    obs.blackbox.record("supervisor_restart", component="actor-2")
    obs.register("actor-2")
    time.sleep(0.1)
    with pytest.raises(StallError):
        obs.check_stalled()           # dumps the box and closes
    metrics.close()
    return d, jsonl


def _main(mod, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(argv)
    return rc, out.getvalue(), err.getvalue()


def _without_captures(text: str) -> str:
    """The port's text less its one line of its own (the graph
    captures, in the roofline section)."""
    lines = text.splitlines(keepends=True)
    kept = [x for x in lines if not x.startswith("  graph captures: ")]
    assert len(lines) - len(kept) == (1 if "roofline" in text else 0)
    return "".join(kept)


@pytest.mark.parametrize("mode", [[], ["--json"], ["--check"]])
def test_both_reports_print_the_same(run, mode):
    _, jsonl = run
    theirs = _main(jreport, [str(jsonl), *mode])
    rc, out, err = _main(treport, [str(jsonl), *mode])
    if mode != ["--json"]:
        out = _without_captures(out)
    assert (rc, out, err) == theirs
    if not mode:
        for section in ("stage-time breakdown", "staleness", "roofline",
                        "learning health", "fleet"):
            assert section in out, section
        assert "stall events: 1" in out


def test_the_report_reads_the_ports_capture_counters(run):
    """The one place the texts differ on purpose: the port's report
    lists the graph captures in its roofline section."""
    _, jsonl = run
    summary = treport.summarize(treport.load_records(str(jsonl)))
    assert "  graph captures: 9 CUDA graphs, 420 ms total" in \
        treport.format_report(summary)
    assert "graph captures" not in jreport.format_report(
        jreport.summarize(jreport.load_records(str(jsonl))))


def test_both_postmortems_bundle_the_same(run, tmp_path):
    d, jsonl = run
    bundles = []
    for mod, name in ((jpm, "jax"), (tpm, "torch")):
        out = tmp_path / f"{name}.json"
        b = mod.build_bundle(str(d), jsonl_path=str(jsonl),
                             out_path=str(out))
        b.pop("created_unix", None)
        b.pop("path", None)
        bundles.append((json.loads(json.dumps(b)), out))
    assert bundles[0][0] == bundles[1][0]
    assert bundles[1][0]["dumps"], "the stall's dump is missing"
    theirs = _main(jreport, ["--postmortem", str(bundles[0][1])])
    ours = _main(treport, ["--postmortem", str(bundles[1][1])])
    assert ours[0] == theirs[0] == 0
    assert ours[1] == theirs[1]
