"""Offline run report: `python -m ape_x_dqn_tpu_torch.obs.report run.jsonl`.

Summarizes one run's metrics JSONL — the single self-contained
artifact every driver writes — into the questions that matter for an
Ape-X run (SURVEY.md §5):

- stage-time breakdown: where host wall-clock went, from the
  `span/<name>` aggregates Obs.publish folds into the stream;
- staleness: sampled-transition-age and actor-parameter-lag
  percentiles from the `hist/<name>` snapshots (the failure mode
  Horgan et al. 2018 §4 and Kapturowski et al. 2019 both name);
- throughput: frames/s, grad-steps/s, totals;
- stall events: every attributed watchdog record.

Stdlib-only on purpose: the report must run anywhere the JSONL can be
copied, with no jax (or even numpy) available.

The PyTorch package's copy of ``ape_x_dqn_tpu/obs/report.py``; it also
reads the port's CUDA-graph capture counters and labels the ``hbm/``
section for captured graphs (tests/test_torch_isolation.py lists the
lines that differ).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any

# The canonical instrument table: one row per metric name the runtime
# can emit, keyed by JSONL name with the registry's kind prefix
# (hist/ gauge/ ctr/). apexlint's obs-names checker cross-references
# this table against every emission site in the package, both ways —
# an emitted name missing here, or a row no code emits, is a lint
# failure — so the report can never silently drop a signal a PR adds.
# "warn" rows carry the healthy-range rule printed next to the value
# (and documented in PERF.md "Observability"): Ape-X tolerates replay
# staleness by design, but tails beyond these suggest the learner is
# overrunning ingest (age) or the publish path is wedged (lag).
INSTRUMENTS = {
    "sample_age_steps": {
        "kind": "hist",
        "warn": ("p99", 200_000,
                 "p99 sampled age beyond ~capacity suggests the "
                 "learner free-runs over stale replay")},
    "param_lag_steps": {
        "kind": "hist",
        "warn": ("p99", 1_000,
                 "p99 actor param lag should stay within a few "
                 "publish_every periods")},
    "td_abs": {"kind": "hist"},
    "server_batch_items": {"kind": "hist"},
    "infer_latency_ms": {
        "kind": "hist",
        "warn": ("p99", 100.0,
                 "p99 inference latency beyond ~100ms means actors "
                 "wait on the server more than they step envs — the "
                 "queue is backing up or a compile stole the window")},
    "ingest_staging_occupancy": {"kind": "gauge"},
    "ingest_coalesce_width": {"kind": "gauge"},
    "ingest_decode_ms": {"kind": "gauge"},
    "wire_compression_ratio": {"kind": "gauge"},
    "replay_occupancy": {"kind": "gauge"},
    "server_queue_depth": {
        "kind": "gauge",
        "warn": ("value", 64,
                 "a queue deeper than max_batch at publish time means "
                 "dynamic batching is saturated — requests wait whole "
                 "extra batch rounds")},
    "stall_errors": {"kind": "ctr"},
    "replay_adds": {"kind": "ctr"},
    # fleet telemetry plane (obs/fleet.py)
    "telemetry_frames": {"kind": "ctr"},
    "peer_disconnects": {"kind": "ctr"},
    "fleet_peers": {"kind": "gauge"},
    # elastic fleet runtime: supervised recovery + chaos lane
    "supervisor_restarts": {"kind": "ctr"},
    "actor_quarantines": {"kind": "ctr"},
    "peer_stall_events": {"kind": "ctr"},
    "param_pull_errors": {"kind": "ctr"},
    "wire_decode_errors": {"kind": "ctr"},
    # continuous perf plane (obs/profiling.py): live roofline
    # gauges per stage (EWMA ms/dispatch + cost-analysis MFU and HBM
    # bandwidth fractions; the compiler FLOP count under-reports convs
    # on this backend, so mfu_* are lower bounds — see PERF.md)
    "mfu_sample_k": {"kind": "gauge"},
    "hbm_bw_frac_sample_k": {"kind": "gauge"},
    "device_ms_sample_k": {"kind": "gauge"},
    "mfu_learn_k": {"kind": "gauge"},
    "hbm_bw_frac_learn_k": {"kind": "gauge"},
    "device_ms_learn_k": {"kind": "gauge"},
    "mfu_train": {"kind": "gauge"},
    "hbm_bw_frac_train": {"kind": "gauge"},
    "device_ms_train": {"kind": "gauge"},
    # dist learner's fused dispatch: same roofline math,
    # own names so mesh runs never alias single-chip train history
    "mfu_train_dist": {"kind": "gauge"},
    "hbm_bw_frac_train_dist": {"kind": "gauge"},
    "device_ms_train_dist": {"kind": "gauge"},
    # dp-scaling plane (bench.py --multichip + dist driver runs):
    # "value_min" warn rows flag values BELOW the bound (efficiency
    # and fill are healthy when high, unlike every gauge above)
    "dp_scaling_efficiency": {
        "kind": "gauge",
        "warn": ("value_min", 0.5,
                 "scaling efficiency below ~0.5 means over half of "
                 "each added chip is lost to collectives/dispatch "
                 "overhead — on shared-host virtual devices that is "
                 "expected contention, on real chips it is a regression "
                 "(PERF.md 'Multi-chip scaling')")},
    "replay_shard_fill_min": {"kind": "gauge"},
    "replay_shard_fill_max": {"kind": "gauge"},
    "hbm_bw_frac_ingest": {"kind": "gauge"},
    "device_ms_ingest": {"kind": "gauge"},
    "ingest_ship_ms": {"kind": "gauge"},
    # compile telemetry: per-publish compile deltas + the monotonic
    # per-process executable count whose growth precedes the known XLA
    # teardown SIGSEGV (tests/run_chunked.sh exists because of it)
    "jit_compiles": {"kind": "ctr"},
    "jit_compile_ms": {"kind": "ctr"},
    # the port's counterpart: CUDA graph captures and their host ms
    "graph_captures": {"kind": "ctr"},
    "graph_capture_ms": {"kind": "ctr"},
    "compile_cache_entries": {
        "kind": "gauge",
        "warn": ("value", 2000,
                 "a long-lived process past ~2000 backend compiles is "
                 "in the XLA accumulation regime that has segfaulted "
                 "CPU clients at teardown — split the workload "
                 "(run_chunked.sh) or hunt the shape churn")},
    # perf-regression engine: EWMA throughput baselines + warn-only
    # degradation events (each event is an attributed JSONL record)
    "perf_degradations": {"kind": "ctr"},
    "ewma_grad_steps_per_s": {"kind": "gauge"},
    "ewma_env_fps": {"kind": "gauge"},
    "ewma_ingest_rows_per_s": {"kind": "gauge"},
    # learning-health plane (obs/learning.py): in-graph
    # diagnostics computed inside the learner jits, host-read only at
    # existing sync points. The four warn rows mirror LearnMonitor's
    # absolute rules exactly (Q_MAX_LIMIT / UPDATE_RATIO_MIN /
    # ESS_FRAC_MIN / TOP_FRAC_MAX) so the offline report flags the same
    # lines the online engine fires on. Per-tenant duplicates ride
    # dynamic `learn/<env_id>/<name>` keys (regrouped by summarize(),
    # invisible to lint by design — same policy as peer/ keys).
    "learn_td_abs_p50": {"kind": "gauge"},
    "learn_td_abs_p90": {"kind": "gauge"},
    "learn_td_abs_p99": {"kind": "gauge"},
    "learn_td_signed_mean": {"kind": "gauge"},
    "learn_q_mean": {"kind": "gauge"},
    "learn_q_max": {
        "kind": "gauge",
        "warn": ("value", 1_000.0,
                 "|q_max| beyond ~1e3 in clipped-reward units is Q "
                 "divergence — check lr, target sync cadence, and the "
                 "overestimation gap trend")},
    "learn_target_q_mean": {"kind": "gauge"},
    "learn_q_gap": {"kind": "gauge"},
    "learn_grad_norm": {"kind": "gauge"},
    "learn_update_ratio": {
        "kind": "gauge",
        "warn": ("value_min", 1e-9,
                 "||update||/||params|| below ~1e-9 means the optimizer "
                 "is effectively frozen — dead gradients or a crushed "
                 "lr schedule")},
    "learn_is_ess_frac": {
        "kind": "gauge",
        "warn": ("value_min", 0.05,
                 "IS effective sample size below 5% of the batch means "
                 "a handful of transitions dominate every update — "
                 "beta/alpha pathology")},
    "learn_priority_top_frac": {
        "kind": "gauge",
        "warn": ("value", 0.5,
                 "one transition holding over half the priority mass "
                 "means the sampler has collapsed onto a single "
                 "outlier")},
    "learn_sample_age_p50": {"kind": "gauge"},
    "learn_sample_age_p90": {"kind": "gauge"},
    "learn_prio_staleness_frac": {"kind": "gauge"},
    "learn_shard_td_mean_min": {"kind": "gauge"},
    "learn_shard_td_mean_max": {"kind": "gauge"},
    "learn_loss": {"kind": "hist"},
    "learning_degradations": {"kind": "ctr"},
    # tiered cold replay (replay/cold_store.py): host-RAM
    # compressed segments behind the device ring. cold_bytes /
    # cold_segments track resident footprint; the ratio's floor is 1.0
    # by construction (per-leaf never-inflate guard in
    # packing.cold_pack + the store's explicit clamp), so a reading
    # below it means the clamp was bypassed — a codec regression, not
    # a workload property.
    "cold_segments": {"kind": "gauge"},
    "cold_bytes": {"kind": "gauge"},
    "cold_compression_ratio": {
        "kind": "gauge",
        "warn": ("value_min", 1.0,
                 "cold compression ratio below 1.0 should be "
                 "impossible (never-inflate guard stores raw leaves) — "
                 "a reading here means the cold codec is inflating "
                 "data and its guard is broken")},
    "cold_evictions": {"kind": "ctr"},
    "cold_recalls": {"kind": "ctr"},
    # cold-door outcomes: every ring eviction either stores,
    # displaces a lighter resident segment, or drops at the door. Drops
    # persistently outrunning displacements means the door is rejecting
    # mass the store has no room to absorb — the thrashing signal the
    # disk rung exists to absorb (check_violations has a bespoke row).
    "cold_dropped": {"kind": "ctr"},
    "cold_displaced": {"kind": "ctr"},
    # disk spill rung (replay/disk_store.py): append-only
    # segment files below the host-RAM cold store. Spills ride an async
    # writeback queue off the ingest thread (queue_full counts offers
    # the full queue refused — never waited on); promotions re-enter
    # the RAM store during the idle refill tick. cold_disk_errors is
    # lost-segment IO failures (writeback append / promote read).
    "cold_disk_spills": {"kind": "ctr"},
    "cold_disk_promotions": {"kind": "ctr"},
    "cold_disk_queue_full": {"kind": "ctr"},
    "cold_disk_errors": {"kind": "ctr"},
    "cold_disk_segments": {"kind": "gauge"},
    "cold_disk_transitions": {"kind": "gauge"},
    "cold_disk_bytes": {"kind": "gauge"},
    # multi-tenant serving tier (parallel/inference_server.py):
    # admission-controller accounting closes by construction —
    # serve_offered == serve_admitted + serve_shed at quiescence (shed
    # includes deadline expiries; serve_expired counts those
    # separately). Per-tenant duplicates ride dynamic
    # `serve/<tenant>/<stat>` gauge keys (regrouped by summarize(),
    # invisible to lint by design — same policy as learn/ and peer/
    # keys); the per-tenant p99_ms rows are checked against
    # infer_latency_ms's healthy bound in check_violations.
    "serve_offered": {"kind": "ctr"},
    "serve_admitted": {"kind": "ctr"},
    "serve_shed": {"kind": "ctr"},
    "serve_expired": {"kind": "ctr"},
    "serve_tenants": {"kind": "gauge"},
    "serve_backpressure": {"kind": "gauge"},
    "serve_queue_items": {
        "kind": "gauge",
        "warn": ("value", 256,
                 "admission-queue depth beyond queue_slo_items means "
                 "offered load exceeds serving capacity — the "
                 "controller is shedding lower classes and "
                 "backpressuring the transport")},
    # fleet remediation plane (runtime/remediation.py): the
    # policy engine that closes the monitor→actuator loop. Outcome
    # counters partition every decision: applied (actuator ran) /
    # observed (dry-run mode) / suppressed (budget) / failed (actuator
    # raised). remediation_mode encodes the configured mode (1=observe,
    # 2=enforce; absent/0 = off). budget_headroom is the live token
    # count of the global actions/min bucket — below 1.0 the engine
    # cannot afford a single non-safety action, which is a health
    # violation only in enforce mode (check_violations gates on the
    # mode gauge).
    "remediation_actions": {"kind": "ctr"},
    "remediation_observed": {"kind": "ctr"},
    "remediation_suppressed": {"kind": "ctr"},
    "remediation_failed": {"kind": "ctr"},
    "remediation_budget_headroom": {
        "kind": "gauge",
        "warn": ("value_min", 1.0,
                 "action-budget headroom below one token means the "
                 "remediation engine is rate-limited out of acting — "
                 "faults are firing faster than "
                 "remediation.budget_per_min allows responses")},
    "remediation_mode": {"kind": "gauge"},
    # forensics plane (obs/blackbox.py + obs/postmortem.py):
    # flight-recorder activity counters. Healthy ranges are bespoke
    # rows in check_violations (ctr warns don't fit the single-value
    # rule shapes): a terminal stall/quarantine with no dump on disk
    # fails the check naming the missing peer, and a ring-drop
    # fraction above 1/2 (blackbox_dropped vs blackbox_records) warns
    # that most of the forensic window was overwritten before any dump.
    "blackbox_records": {"kind": "ctr"},
    "blackbox_dumps": {"kind": "ctr"},
    "blackbox_dropped": {"kind": "ctr"},
    "postmortem_bundles": {"kind": "ctr"},
    # shared-memory same-host transport: doorbells are
    # slot deliveries on the zero-copy ring; torn slots (crc/seq
    # mismatch — writer died mid-pack or wild write) are counted and
    # freed, NEVER delivered; fallbacks are batches a granted
    # connection still shipped over TCP (ring full / oversize batch).
    # A nonzero torn rate or a fallback-dominated mix means the ring
    # is mis-sized for the batch shape — see README "Shared-memory
    # same-host transport".
    "shm_doorbells": {"kind": "ctr"},
    "shm_torn_slots": {"kind": "ctr"},
    "shm_fallbacks": {"kind": "ctr"},
    "shm_slots_inflight": {"kind": "gauge"},
    # param-plane codec (comm/param_codec.py): weight
    # broadcast over TCP as quantized deltas against each subscriber's
    # acked version. bytes_out is the actual wire spend; the ratio is
    # raw-equivalent/wire (cumulative); resyncs count full-blob
    # fallbacks (missed version, epoch bump, window overrun); queue
    # drops count per-subscriber latest-wins supersedes — a steady
    # stream on one peer is a slow subscriber riding resyncs, not a
    # broadcast stall (README "Parameter-plane codec").
    "param_bytes_out": {"kind": "ctr"},
    "param_resyncs": {"kind": "ctr"},
    "param_push_queue_drops": {"kind": "ctr"},
    "param_compression_ratio": {
        "kind": "gauge",
        "warn": ("value_min", 1.0,
                 "param compression ratio below 1.0 should be "
                 "impossible (the codec never-inflates: every delta "
                 "segment and full blob is capped at the raw "
                 "versioned-blob cost) — a reading here means the "
                 "per-leaf or blob-level guard is broken")},
}

# healthy ranges, derived view kept under its historical name (the
# formatting path and PERF.md both refer to HEALTHY)
HEALTHY = {name: row["warn"] for name, row in INSTRUMENTS.items()
           if "warn" in row}


def load_records(path: str) -> list[dict]:
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail line of a killed run
    return records


def summarize(records: list[dict]) -> dict[str, Any]:
    """Fold a record stream into one summary dict. Scalar/snapshot keys
    are last-write-wins (each Obs.publish record carries cumulative
    state); stall events accumulate."""
    latest: dict[str, Any] = {}
    stalls: list[dict] = []
    disconnects: list[dict] = []
    perf_events: list[dict] = []
    learn_events: list[dict] = []
    remediation_events: list[dict] = []
    quarantines: list[dict] = []
    peer_stalls: list[dict] = []
    blackbox_dumps: list[dict] = []
    for rec in records:
        for k, v in rec.items():
            if v is not None:
                latest[k] = v
        if rec.get("learning_degradation") is not None:
            learn_events.append({"step": rec.get("step"),
                                 "rule": rec["learning_degradation"],
                                 "tenant": rec.get("learn_tenant"),
                                 "value": rec.get("learn_value"),
                                 "baseline": rec.get("learn_baseline")})
        if rec.get("stall_component") is not None:
            stalls.append({"step": rec.get("step"),
                           "component": rec["stall_component"],
                           "staleness_s": rec.get("stall_staleness_s"),
                           "note": rec.get("stall_note")})
        if rec.get("peer_disconnect") is not None:
            disconnects.append({"step": rec.get("step"),
                                "peer": rec["peer_disconnect"]})
        if rec.get("actor_quarantined") is not None:
            quarantines.append({"step": rec.get("step"),
                                "component":
                                    f"actor-{rec['actor_quarantined']}",
                                "staleness_s":
                                    rec.get("stall_staleness_s")})
        if rec.get("peer_stall") is not None:
            peer_stalls.append({"step": rec.get("step"),
                                "component": rec["peer_stall"],
                                "staleness_s":
                                    rec.get("stall_staleness_s")})
        if rec.get("blackbox_dump") is not None:
            blackbox_dumps.append({"step": rec.get("step"),
                                   "path": rec["blackbox_dump"],
                                   "reason": rec.get("blackbox_reason"),
                                   "peer": rec.get("blackbox_peer"),
                                   "component":
                                       rec.get("blackbox_component"),
                                   "recorded":
                                       rec.get("blackbox_ring_recorded"),
                                   "dropped":
                                       rec.get("blackbox_ring_dropped")})
        if rec.get("perf_degradation") is not None:
            perf_events.append({"step": rec.get("step"),
                                "name": rec["perf_degradation"],
                                "peer": rec.get("perf_peer"),
                                "value": rec.get("perf_value"),
                                "baseline": rec.get("perf_baseline"),
                                "frac": rec.get("perf_frac")})
        if rec.get("remediation") is not None:
            remediation_events.append({
                "step": rec.get("step"),
                "rule": rec["remediation"],
                "target": rec.get("remediation_target"),
                "action": rec.get("remediation_action"),
                "outcome": rec.get("remediation_outcome"),
                "value": rec.get("remediation_value"),
                "baseline": rec.get("remediation_baseline")})
    # fleet telemetry: `peer/<id>/<kind>/<name>` keys the aggregator
    # merges into the stream (obs/fleet.py) regroup into one dict per
    # peer — {"seq": n, "ctr": {...}, "gauge": {...}, "hist": {...},
    # "span": {...}, "hb": {...}}
    peers: dict[str, dict[str, Any]] = {}
    for k, v in latest.items():
        if not k.startswith("peer/"):
            continue
        parts = k.split("/", 3)
        if len(parts) == 3:  # peer/<id>/seq
            peers.setdefault(parts[1], {})[parts[2]] = v
        elif len(parts) == 4:
            peers.setdefault(parts[1], {}).setdefault(
                parts[2], {})[parts[3]] = v
    # multichip scaling lane: `multichip/dp<N>/<stat>` keys the bench
    # lane (bench.py --multichip) appends to the JSONL — one group per
    # dp point, same raw-key pattern as the fleet peer frames
    multichip: dict[int, dict[str, Any]] = {}
    for k, v in latest.items():
        if not k.startswith("multichip/dp"):
            continue
        parts = k.split("/", 2)
        if len(parts) != 3:
            continue
        try:
            dp = int(parts[1][2:])
        except ValueError:
            continue
        multichip.setdefault(dp, {})[parts[2]] = v
    spans = {k[len("span/"):]: v for k, v in latest.items()
             if k.startswith("span/") and isinstance(v, dict)}
    hists = {k[len("hist/"):]: v for k, v in latest.items()
             if k.startswith("hist/") and isinstance(v, dict)}
    gauges = {k[len("gauge/"):]: v for k, v in latest.items()
              if k.startswith("gauge/")}
    # per-tenant learning health: `gauge/learn/<env_id>/<name>` keys
    # (obs/learning.publish_learn) regroup into one dict per env family
    # — 57-game suite = 57 attributable tenants
    tenants: dict[str, dict[str, Any]] = {}
    for k, v in gauges.items():
        if not k.startswith("learn/"):
            continue
        parts = k.split("/", 2)
        if len(parts) == 3:
            tenants.setdefault(parts[1], {})[parts[2]] = v
    # per-tenant serving stats: `gauge/serve/<policy_id>/<stat>` keys
    # (parallel/inference_server._maybe_publish_stats) regroup into one
    # dict per tenant — the serving tier's equivalent of learn/ keys
    serving: dict[str, dict[str, Any]] = {}
    for k, v in gauges.items():
        if not k.startswith("serve/"):
            continue
        parts = k.split("/", 2)
        if len(parts) == 3:
            serving.setdefault(parts[1], {})[parts[2]] = v
    ctrs = {k[len("ctr/"):]: v for k, v in latest.items()
            if k.startswith("ctr/")}
    hbm = {k[len("hbm/"):]: v for k, v in latest.items()
           if k.startswith("hbm/")}
    header_keys = ("run_name", "version", "sample_chunk",
                   "sample_prefetch", "replay_kind", "replay_storage",
                   "replay_capacity", "batch_size", "train_chunk",
                   "dp", "tp")
    return {
        "header": {k: latest[k] for k in header_keys if k in latest},
        "throughput": {
            "final_step": latest.get("step", 0),
            "frames": latest.get("frames"),
            "frames_per_s": latest.get("frames_per_s"),
            "grad_steps_per_s": latest.get("grad_steps_per_s"),
            "loss": latest.get("loss"),
            "avg_return": latest.get("avg_return"),
        },
        "spans": spans,
        "hists": hists,
        "gauges": gauges,
        "ctrs": ctrs,
        "hbm": hbm,
        "peers": peers,
        "multichip": multichip,
        "tenants": tenants,
        "serving": serving,
        "virtual_devices": latest.get("virtual_devices"),
        "disconnects": disconnects,
        "stalls": stalls,
        "perf_events": perf_events,
        "learn_events": learn_events,
        "remediation_events": remediation_events,
        "quarantines": quarantines,
        "peer_stalls": peer_stalls,
        "blackbox_dumps": blackbox_dumps,
    }


def _fmt_spans(spans: dict[str, dict]) -> list[str]:
    lines = ["stage-time breakdown (host spans):",
             f"  {'stage':<28} {'count':>8} {'total_s':>9} "
             f"{'mean_ms':>9} {'max_ms':>9} {'share':>7}"]
    grand = sum(s.get("total_s", 0.0) for s in spans.values()) or 1.0
    order = sorted(spans.items(),
                   key=lambda kv: -kv[1].get("total_s", 0.0))
    for name, s in order:
        count = int(s.get("count", 0))
        total = float(s.get("total_s", 0.0))
        mean_ms = total / count * 1e3 if count else 0.0
        tag = " (fused)" if total == 0.0 and count else ""
        lines.append(
            f"  {name:<28} {count:>8} {total:>9.3f} {mean_ms:>9.3f} "
            f"{float(s.get('max_s', 0.0)) * 1e3:>9.3f} "
            f"{total / grand:>6.1%}{tag}")
    return lines


def _fmt_hist(name: str, h: dict) -> list[str]:
    count = int(h.get("count", 0))
    if not count:
        return [f"  {name:<22} (empty)"]
    mean = h.get("sum", 0.0) / count
    line = (f"  {name:<22} n={count:<9} mean={mean:<10.2f} "
            f"p50={_n(h.get('p50')):<8} p90={_n(h.get('p90')):<8} "
            f"p99={_n(h.get('p99')):<8} max={_n(h.get('max'))}")
    out = [line]
    if name in HEALTHY:
        pct, bound, why = HEALTHY[name]
        v = h.get(pct)
        if v is not None and v > bound:
            out.append(f"    ⚠ {pct}={_n(v)} exceeds healthy ~{bound}: "
                       f"{why}")
    return out


def _fmt_ingest(summary: dict[str, Any]) -> list[str]:
    """Ingest-pipeline health from the staging gauges (runtime/ingest.py
    zero-copy stager; PERF.md 'Ingest pipeline'). Gauges are last-write
    point samples, so read them as 'state at the final publish'."""
    gauges = summary.get("gauges", {})
    occ = gauges.get("ingest_staging_occupancy")
    width = gauges.get("ingest_coalesce_width")
    if occ is None and width is None:
        return []
    lines = ["ingest staging (zero-copy pipeline gauges):"]
    if occ is not None:
        lines.append(f"  staging occupancy      {float(occ):.1%} of the "
                     f"active buffer (point sample)")
    if width is not None:
        lines.append(f"  last coalesce width    {_n(width)} blocks/add "
                     f"dispatch (1 = idle-drain, >1 = full-buffer "
                     f"add_many)")
    ratio = gauges.get("wire_compression_ratio")
    if ratio is not None:
        lines.append(f"  wire compression       {float(ratio):.2f}x "
                     f"raw/wire (delta-deflate codec; healthy ≥2x on "
                     f"frame traffic, 1.0 = raw peer)")
        if float(ratio) < 1.5:
            lines.append("    ⚠ wire ratio <1.5x: peer negotiated raw "
                         "(old build / comm.wire_codec=raw) or traffic "
                         "is float-dominated — the ingest link runs "
                         "uncompressed")
    dec = gauges.get("ingest_decode_ms")
    if dec is not None:
        lines.append(f"  last put decode        {float(dec):.2f} ms "
                     f"(inflate + delta-undo + staging copy; healthy "
                     f"<10ms per message — beyond that decode eats the "
                     f"ingest thread's budget)")
    # ingest-bound flags: a persistently full staging buffer means
    # device adds can't keep up with actor arrivals; a replay.add span
    # eating a large share of host wall-clock means adds steal the
    # learner's dispatch window
    if occ is not None and float(occ) >= 0.5:
        lines.append("    ⚠ staging buffer ≥50% full at last publish: "
                     "ingest-bound — device adds lag actor arrivals "
                     "(raise replay.ingest_coalesce or check the h2d "
                     "link)")
    spans = summary.get("spans", {})
    add = spans.get("replay.add")
    if add:
        grand = sum(s.get("total_s", 0.0) for s in spans.values()) or 1.0
        share = float(add.get("total_s", 0.0)) / grand
        if share >= 0.25:
            lines.append(f"    ⚠ replay.add is {share:.0%} of host "
                         f"wall-clock: adds contend with the train "
                         f"dispatch loop — ingest-bound")
    return lines


def _fmt_slo(summary: dict[str, Any]) -> list[str]:
    """Live serving-SLO view: inference latency percentiles and every
    gauge with a healthy-range rule, each flagged when outside it."""
    hists = summary.get("hists", {})
    gauges = summary.get("gauges", {})
    lat = hists.get("infer_latency_ms")
    # learn_* warn rows render (and flag) in the learning-health
    # section, remediation_* rows in the remediation section — keep
    # the SLO block serving-scoped
    gauge_rows = [(name, gauges[name]) for name, row in INSTRUMENTS.items()
                  if row["kind"] == "gauge" and "warn" in row
                  and name in gauges
                  and not name.startswith(("learn_", "remediation_"))]
    if not lat and not gauge_rows:
        return []
    lines = ["serving SLOs:"]
    if lat and int(lat.get("count", 0)):
        lines.append(
            f"  infer latency (ms)     p50={_n(lat.get('p50'))} "
            f"p99={_n(lat.get('p99'))} max={_n(lat.get('max'))} "
            f"over n={int(lat['count'])} requests "
            f"(healthy p99 < {HEALTHY['infer_latency_ms'][1]})")
    for name, v in gauge_rows:
        kind, bound, why = HEALTHY[name]
        # "value_min" rows (e.g. dp_scaling_efficiency) are healthy
        # when HIGH: flag below the bound instead of above it
        low_side = kind == "value_min"
        flag = float(v) < bound if low_side else float(v) > bound
        rel = "≥" if low_side else "≤"
        lines.append(f"  {name:<22} {_n(v)} "
                     f"(healthy {rel} {_n(float(bound))})")
        if flag:
            verb = "falls below" if low_side else "exceeds"
            lines.append(f"    ⚠ value={_n(v)} {verb} healthy "
                         f"~{bound}: {why}")
    return lines


# stage -> (mfu gauge, bw gauge, ewma-ms gauge, host span carrying the
# stage's total wall time). The span totals give the honest device-time
# SHARE (every window is block_until_ready-bracketed by contract);
# the gauges give the per-dispatch roofline position.
_ROOFLINE_STAGES = (
    ("sample_k", "mfu_sample_k", "hbm_bw_frac_sample_k",
     "device_ms_sample_k", "replay.sample"),
    ("learn_k", "mfu_learn_k", "hbm_bw_frac_learn_k",
     "device_ms_learn_k", "learner.learn"),
    ("train", "mfu_train", "hbm_bw_frac_train",
     "device_ms_train", "learner.train"),
    ("train_dist", "mfu_train_dist", "hbm_bw_frac_train_dist",
     "device_ms_train_dist", "learner.train"),
    ("ingest", None, "hbm_bw_frac_ingest",
     "device_ms_ingest", "replay.add"),
)


def _fmt_roofline(summary: dict[str, Any]) -> list[str]:
    """Live roofline (obs/profiling.py): per-stage EWMA dispatch time,
    device-time share, and MFU / HBM-bandwidth fractions against the
    detected chip peaks — the continuous version of PERF.md's one-off
    roofline study. mfu_* are LOWER bounds (compiler FLOP counts omit
    most conv FLOPs on this backend)."""
    gauges = summary.get("gauges", {})
    spans = summary.get("spans", {})
    rows = []
    for stage, mfu_k, bw_k, ms_k, span_name in _ROOFLINE_STAGES:
        if ms_k not in gauges and (mfu_k is None
                                   or mfu_k not in gauges):
            continue
        rows.append((stage,
                     gauges.get(mfu_k) if mfu_k else None,
                     gauges.get(bw_k), gauges.get(ms_k),
                     float(spans.get(span_name, {}).get("total_s", 0.0))))
    if not rows:
        return []
    # single-process runs carry no host spans; their stages share one
    # dispatch cadence, so the EWMA-ms weights give the same share
    if not any(r[4] for r in rows):
        rows = [(st, mfu, bw, ms, float(ms or 0.0))
                for st, mfu, bw, ms, _ in rows]
    grand = sum(r[4] for r in rows) or 1.0
    lines = ["roofline (live gauges; mfu is a lower bound — see "
             "PERF.md):",
             f"  {'stage':<12} {'dev_ms(ewma)':>13} {'time_share':>11} "
             f"{'mfu':>8} {'hbm_bw':>8}"]
    for stage, mfu, bw, ms, total_s in rows:
        ms_s = f"{float(ms):.3f}" if ms is not None else "-"
        mfu_s = f"{float(mfu):.2%}" if mfu is not None else "-"
        bw_s = f"{float(bw):.2%}" if bw is not None else "-"
        lines.append(f"  {stage:<12} {ms_s:>13} "
                     f"{total_s / grand:>10.1%} {mfu_s:>8} {bw_s:>8}")
    ctrs = summary.get("ctrs", {})
    n = ctrs.get("jit_compiles")
    if n is not None:
        ms = ctrs.get("jit_compile_ms", 0.0)
        entries = gauges.get("compile_cache_entries")
        lines.append(
            f"  compile telemetry: {_n(n)} backend compiles, "
            f"{float(ms):.0f} ms total, process cache entries="
            f"{_n(entries)}")
    n = ctrs.get("graph_captures")
    if n is not None:
        ms = ctrs.get("graph_capture_ms", 0.0)
        lines.append(f"  graph captures: {_n(n)} CUDA graphs, "
                     f"{float(ms):.0f} ms total")
    return lines


def _fmt_multichip(summary: dict[str, Any]) -> list[str]:
    """dp-scaling curve from the multichip bench lane (bench.py
    --multichip): one row per dp point with throughput, efficiency vs
    dp=1, per-shard fill bounds, and the dist-dispatch roofline gauges.
    Efficiency on virtual devices (one shared host) is a correctness/
    overhead signal, not a speedup claim — see PERF.md."""
    points = summary.get("multichip", {})
    if not points:
        return []
    virt = summary.get("virtual_devices")
    tag = ("virtual devices — shared host, efficiency is an overhead "
           "signal" if virt else "real chips")
    lines = [f"multichip scaling ({tag}):",
             f"  {'dp':>4} {'grad_steps/s':>13} {'efficiency':>11} "
             f"{'shard_fill':>13} {'mfu':>8} {'dev_ms':>9} "
             f"{'ingest_rows/s':>14}"]
    for dp in sorted(points):
        p = points[dp]
        eff = p.get("efficiency")
        fmin, fmax = p.get("shard_fill_min"), p.get("shard_fill_max")
        fill = (f"{float(fmin):.2f}..{float(fmax):.2f}"
                if fmin is not None and fmax is not None else "-")
        mfu = p.get("mfu_train_dist")
        ms = p.get("device_ms_train_dist")
        lines.append(
            f"  {dp:>4} {_n(p.get('grad_steps_per_s')):>13} "
            f"{(f'{float(eff):.2f}x' if eff is not None else '-'):>11} "
            f"{fill:>13} "
            f"{(f'{float(mfu):.2%}' if mfu else '-'):>8} "
            f"{(f'{float(ms):.2f}' if ms is not None else '-'):>9} "
            f"{_n(p.get('ingest_rows_per_s')):>14}")
        if eff is not None and float(eff) < HEALTHY[
                "dp_scaling_efficiency"][1] and dp > 1:
            lines.append(f"    ⚠ dp={dp} efficiency {float(eff):.2f} "
                         f"below healthy ~"
                         f"{HEALTHY['dp_scaling_efficiency'][1]}: "
                         f"{HEALTHY['dp_scaling_efficiency'][2]}")
    return lines


# the four learn_* gauges with warn rows, i.e. the lines LearnMonitor's
# absolute rules fire on — flagged here with the same bounds
_LEARN_WARN_ROWS = ("learn_q_max", "learn_update_ratio",
                    "learn_is_ess_frac", "learn_priority_top_frac")


def _fmt_learning(summary: dict[str, Any]) -> list[str]:
    """Learning-health section (obs/learning.py): the in-graph training
    diagnostics at the last publish, healthy-range flags mirroring the
    LearnMonitor rules, and the per-tenant (per-env-family) view."""
    gauges = summary.get("gauges", {})
    if not any(k.startswith("learn_") for k in gauges):
        return []

    def g(name: str) -> str:
        v = gauges.get(name)
        return _n(float(v)) if v is not None else "-"

    lines = [
        "learning health (in-graph diagnostics, last publish):",
        f"  td |error|            p50={g('learn_td_abs_p50')} "
        f"p90={g('learn_td_abs_p90')} p99={g('learn_td_abs_p99')} "
        f"signed_mean={g('learn_td_signed_mean')}",
        f"  Q values              mean={g('learn_q_mean')} "
        f"max={g('learn_q_max')} target_mean={g('learn_target_q_mean')} "
        f"overestimation_gap={g('learn_q_gap')}",
        f"  optimizer             grad_norm={g('learn_grad_norm')} "
        f"update_ratio={g('learn_update_ratio')}",
        f"  sampling              is_ess_frac={g('learn_is_ess_frac')} "
        f"age_p50={g('learn_sample_age_p50')} "
        f"age_p90={g('learn_sample_age_p90')} "
        f"priority_top_frac={g('learn_priority_top_frac')} "
        f"prio_staleness={g('learn_prio_staleness_frac')}",
    ]
    if "learn_shard_td_mean_min" in gauges:
        lines.append(
            f"  shards (dp)           td_mean "
            f"min={g('learn_shard_td_mean_min')} "
            f"max={g('learn_shard_td_mean_max')}")
    for name in _LEARN_WARN_ROWS:
        if name not in gauges:
            continue
        kind, bound, why = HEALTHY[name]
        low_side = kind == "value_min"
        v = float(gauges[name])
        if (v < bound) if low_side else (abs(v) > bound):
            verb = "falls below" if low_side else "exceeds"
            lines.append(f"    ⚠ {name}={_n(v)} {verb} healthy "
                         f"~{_n(float(bound))}: {why}")
    tenants = summary.get("tenants", {})
    if tenants:
        lines.append(f"  tenants ({len(tenants)}):")
        for t in sorted(tenants):
            d = tenants[t]

            def tn(key: str, d=d) -> str:
                v = d.get(key)
                return _n(float(v)) if v is not None else "-"

            lines.append(
                f"    {t:<22} td_p90={tn('td_abs_p90')} "
                f"q_mean={tn('q_mean')} q_max={tn('q_max')} "
                f"ess={tn('is_ess_frac')} "
                f"update_ratio={tn('update_ratio')}")
    return lines


def _fmt_serving(summary: dict[str, Any]) -> list[str]:
    """Serving-tier section (multi-tenant inference): the
    admission controller's aggregate accounting plus a per-tenant table
    from the `serve/<tenant>/` gauges, each tenant's p99 flagged
    against the infer_latency_ms healthy bound."""
    ctrs = summary.get("ctrs", {})
    gauges = summary.get("gauges", {})
    serving = summary.get("serving", {})
    if "serve_offered" not in ctrs and not serving:
        return []
    offered = int(ctrs.get("serve_offered", 0))
    admitted = int(ctrs.get("serve_admitted", 0))
    shed = int(ctrs.get("serve_shed", 0))
    expired = int(ctrs.get("serve_expired", 0))
    bp = gauges.get("serve_backpressure")
    lines = [
        "serving tier (multi-tenant admission):",
        f"  offered={offered} admitted={admitted} shed={shed} "
        f"(of which expired={expired}) "
        f"tenants={_n(gauges.get('serve_tenants'))} "
        f"queue_depth={_n(gauges.get('serve_queue_items'))} "
        f"backpressure={'ENGAGED' if bp else 'off'}"]
    # the closure invariant the admission tests assert; a report over a
    # live (non-quiescent) stream may show a small in-flight gap
    if offered and offered != admitted + shed:
        lines.append(f"    (in-flight gap: offered - admitted - shed = "
                     f"{offered - admitted - shed} requests still "
                     f"queued at last publish)")
    if serving:
        p99_bound = HEALTHY["infer_latency_ms"][1]
        lines.append(f"  tenants ({len(serving)}):")
        for t in sorted(serving):
            d = serving[t]

            def tn(key: str, d=d) -> str:
                v = d.get(key)
                return _n(float(v)) if v is not None else "-"

            lines.append(
                f"    {t:<22} p50_ms={tn('p50_ms')} "
                f"p99_ms={tn('p99_ms')} depth={tn('queue_depth')} "
                f"offered={tn('offered')} admitted={tn('admitted')} "
                f"shed={tn('shed')}")
            p99 = d.get("p99_ms")
            if p99 is not None and float(p99) > p99_bound:
                lines.append(
                    f"      ⚠ p99={_n(float(p99))}ms exceeds healthy "
                    f"~{_n(float(p99_bound))}ms: "
                    f"{HEALTHY['infer_latency_ms'][2]}")
    return lines


def _fmt_learn_events(summary: dict[str, Any]) -> list[str]:
    """LearnMonitor `learning_degradation` events (warn-only; the run
    continued), attributed to the env family that tripped the rule."""
    events = summary.get("learn_events", [])
    if not events:
        return []
    lines = [f"learning-degradation events: {len(events)} (warn-only; "
             f"the run continued)"]
    for e in events:
        who = f" tenant={e['tenant']}" if e.get("tenant") else ""
        base = (f" baseline={_n(e['baseline'])}"
                if e.get("baseline") else "")
        lines.append(f"  step={_n(e['step'])} {e['rule']}{who}: "
                     f"value={_n(e['value'])}{base}")
    return lines


def _fmt_perf_events(summary: dict[str, Any]) -> list[str]:
    """PerfDegradation events (warn-only EWMA regression engine), with
    peer attribution when the baseline was a fleet peer's."""
    events = summary.get("perf_events", [])
    if not events:
        return []
    lines = [f"perf-degradation events: {len(events)} (warn-only; the "
             f"run continued)"]
    for e in events:
        who = f" peer={e['peer']}" if e.get("peer") else ""
        lines.append(
            f"  step={_n(e['step'])} {e['name']}{who}: "
            f"{_n(e['value'])} fell below {_n(e['frac'])}x baseline "
            f"{_n(e['baseline'])}")
    return lines


def _fmt_cold(summary: dict[str, Any]) -> list[str]:
    """Tiered-replay section (replay/cold_store.py +
    replay/disk_store.py): the host-RAM cold store's residency and
    door outcomes, and — when the disk rung is enabled — the spill /
    promotion / queue-refusal counters of the async writeback tier.
    Mirrors the bespoke cold-door thrash row in check_violations."""
    gauges = summary.get("gauges", {})
    ctrs = summary.get("ctrs", {})
    if "cold_segments" not in gauges \
            and "cold_evictions" not in ctrs:
        return []
    lines = [
        "tiered replay (host-RAM cold store):",
        f"  resident: segments={_n(gauges.get('cold_segments'))} "
        f"bytes={_n(gauges.get('cold_bytes'))} "
        f"compression={_n(gauges.get('cold_compression_ratio'))}x",
        f"  door: evictions={int(ctrs.get('cold_evictions', 0))} "
        f"recalls={int(ctrs.get('cold_recalls', 0))} "
        f"displaced={int(ctrs.get('cold_displaced', 0))} "
        f"dropped={int(ctrs.get('cold_dropped', 0))}"]
    drops = int(ctrs.get("cold_dropped", 0))
    displ = int(ctrs.get("cold_displaced", 0))
    disk_on = "cold_disk_transitions" in gauges \
        or "cold_disk_spills" in ctrs
    if disk_on:
        lines.append(
            f"  disk rung: segments="
            f"{_n(gauges.get('cold_disk_segments'))} "
            f"transitions={_n(gauges.get('cold_disk_transitions'))} "
            f"bytes={_n(gauges.get('cold_disk_bytes'))}")
        lines.append(
            f"    spills={int(ctrs.get('cold_disk_spills', 0))} "
            f"promotions={int(ctrs.get('cold_disk_promotions', 0))} "
            f"queue_full={int(ctrs.get('cold_disk_queue_full', 0))} "
            f"io_errors={int(ctrs.get('cold_disk_errors', 0))}")
    if drops > displ and int(ctrs.get("cold_disk_spills", 0)) < drops:
        lines.append("    ⚠ door drops outrun displacements and disk "
                     "spills did not absorb them — the store is "
                     "saturated with heavier segments and experience "
                     "is lost at the door (grow cold_tier_capacity or "
                     "enable cold_tier_disk_capacity)")
    return lines


def _fmt_params(summary: dict[str, Any]) -> list[str]:
    """Param-plane codec section (comm/param_codec.py): wire spend vs
    raw-equivalent cost for the weight broadcast, resync and
    queue-drop counters. The ratio is cumulative over the run; 1.0
    means every peer negotiated raw (old build or
    comm.param_codec=raw)."""
    gauges = summary.get("gauges", {})
    ctrs = summary.get("ctrs", {})
    ratio = gauges.get("param_compression_ratio")
    if ratio is None and "param_bytes_out" not in ctrs:
        return []
    lines = ["param plane (delta+quantized weight broadcast):"]
    lines.append(
        f"  wire bytes out={_n(ctrs.get('param_bytes_out'))} "
        f"compression={_n(ratio)}x raw-equivalent/wire")
    lines.append(
        f"  resyncs={int(ctrs.get('param_resyncs', 0))} "
        f"queue_drops={int(ctrs.get('param_push_queue_drops', 0))}")
    if ratio is not None and float(ratio) < 1.5:
        lines.append("    ⚠ param ratio <1.5x: peers negotiated raw "
                     "(old build / comm.param_codec=raw) or every "
                     "publish forced a full resync — the weight "
                     "broadcast runs (near-)uncompressed")
    return lines


def _fmt_remediation(summary: dict[str, Any]) -> list[str]:
    """Remediation-plane section (runtime/remediation.py): the policy
    engine's decisions grouped by rule/target/action/outcome, the
    outcome counters, and the live action-budget headroom — flagged
    when enforce mode has run out of tokens."""
    events = summary.get("remediation_events", [])
    gauges = summary.get("gauges", {})
    ctrs = summary.get("ctrs", {})
    mode_v = gauges.get("remediation_mode")
    if not events and mode_v is None \
            and "remediation_actions" not in ctrs:
        return []
    mode = {1.0: "observe", 2.0: "enforce"}.get(
        float(mode_v) if mode_v is not None else 0.0, "off")
    headroom = gauges.get("remediation_budget_headroom")
    lines = [
        f"remediation plane (mode={mode}):",
        f"  applied={int(ctrs.get('remediation_actions', 0))} "
        f"observed={int(ctrs.get('remediation_observed', 0))} "
        f"suppressed={int(ctrs.get('remediation_suppressed', 0))} "
        f"failed={int(ctrs.get('remediation_failed', 0))} "
        f"budget_headroom={_n(headroom)} tokens"]
    if events:
        by_key: dict[tuple, int] = {}
        for e in events:
            key = (str(e.get("rule")), str(e.get("target")),
                   str(e.get("action")), str(e.get("outcome")))
            by_key[key] = by_key.get(key, 0) + 1
        lines.append(f"  decisions ({len(events)}):")
        for (rule, target, action, outcome), n in sorted(
                by_key.items()):
            lines.append(f"    {rule:<16} target={target:<12} "
                         f"{action} -> {outcome} x{n}")
    if mode == "enforce" and headroom is not None \
            and float(headroom) < 1.0:
        lines.append("    ⚠ action budget exhausted at last publish: "
                     "enforce-mode decisions are being suppressed — "
                     "faults outpace remediation.budget_per_min")
    return lines


def _fmt_peers(summary: dict[str, Any]) -> list[str]:
    """Per-peer fleet telemetry: one block per remote actor host with
    its heartbeat ages, ingest rate, stage-time breakdown, and any
    histogram rows (healthy-range flags apply to remote instruments
    exactly as to local ones)."""
    peers = summary.get("peers", {})
    if not peers:
        return []
    lines = [f"fleet peers ({len(peers)}):"]
    for peer in sorted(peers):
        p = peers[peer]
        rate = p.get("gauge", {}).get("ingest_rate")
        head = f"  peer {peer}: frame seq={_n(p.get('seq'))}"
        if rate is not None:
            head += f", ingest rate={float(rate):.1f} rows/s"
        lines.append(head)
        hb = p.get("hb", {})
        if hb:
            ages = ", ".join(f"{name}={float(age):.1f}s"
                             for name, age in sorted(hb.items()))
            lines.append(f"    heartbeat ages: {ages}")
        spans = {k: v for k, v in p.get("span", {}).items()
                 if isinstance(v, dict)}
        if spans:
            lines.append(f"    stage-time breakdown ({peer}):")
            grand = sum(s.get("total_s", 0.0)
                        for s in spans.values()) or 1.0
            for name, s in sorted(spans.items(),
                                  key=lambda kv: -kv[1].get("total_s", 0.0)):
                count = int(s.get("count", 0))
                total = float(s.get("total_s", 0.0))
                mean_ms = total / count * 1e3 if count else 0.0
                lines.append(f"      {name:<24} {count:>8} "
                             f"{total:>9.3f}s {mean_ms:>8.3f}ms/ea "
                             f"{total / grand:>6.1%}")
        for name in sorted(p.get("hist", {})):
            h = p["hist"][name]
            if isinstance(h, dict) and int(h.get("count", 0)):
                lines.extend("    " + ln
                             for ln in _fmt_hist(name, h))
    disconnects = summary.get("disconnects", [])
    if disconnects:
        lines.append(f"  peer disconnects: {len(disconnects)}")
        for d in disconnects:
            lines.append(f"    step={_n(d['step'])} peer={d['peer']}")
    return lines


def _n(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float) and v == int(v):
        return str(int(v))
    return f"{v:.3g}" if isinstance(v, float) else str(v)


def format_report(summary: dict[str, Any]) -> str:
    lines: list[str] = []
    hdr = summary["header"]
    if hdr:
        lines.append("run: " + ", ".join(f"{k}={_n(v)}"
                                         for k, v in hdr.items()))
    tp = summary["throughput"]
    lines.append(
        f"throughput: step={_n(tp['final_step'])} "
        f"frames={_n(tp['frames'])} "
        f"frames/s={_n(tp['frames_per_s'])} "
        f"grad-steps/s={_n(tp['grad_steps_per_s'])} "
        f"loss={_n(tp['loss'])} avg_return={_n(tp['avg_return'])}")
    if summary["spans"]:
        lines.append("")
        lines.extend(_fmt_spans(summary["spans"]))
    roofline_lines = _fmt_roofline(summary)
    if roofline_lines:
        lines.append("")
        lines.extend(roofline_lines)
    multichip_lines = _fmt_multichip(summary)
    if multichip_lines:
        lines.append("")
        lines.extend(multichip_lines)
    if summary["hists"]:
        lines.append("")
        lines.append("staleness / distribution percentiles:")
        for name in sorted(summary["hists"]):
            lines.extend(_fmt_hist(name, summary["hists"][name]))
    learn_lines = _fmt_learning(summary)
    if learn_lines:
        lines.append("")
        lines.extend(learn_lines)
    learn_ev_lines = _fmt_learn_events(summary)
    if learn_ev_lines:
        lines.append("")
        lines.extend(learn_ev_lines)
    slo_lines = _fmt_slo(summary)
    if slo_lines:
        lines.append("")
        lines.extend(slo_lines)
    serving_lines = _fmt_serving(summary)
    if serving_lines:
        lines.append("")
        lines.extend(serving_lines)
    ingest_lines = _fmt_ingest(summary)
    if ingest_lines:
        lines.append("")
        lines.extend(ingest_lines)
    cold_lines = _fmt_cold(summary)
    if cold_lines:
        lines.append("")
        lines.extend(cold_lines)
    param_lines = _fmt_params(summary)
    if param_lines:
        lines.append("")
        lines.extend(param_lines)
    peer_lines = _fmt_peers(summary)
    if peer_lines:
        lines.append("")
        lines.extend(peer_lines)
    perf_lines = _fmt_perf_events(summary)
    if perf_lines:
        lines.append("")
        lines.extend(perf_lines)
    remediation_lines = _fmt_remediation(summary)
    if remediation_lines:
        lines.append("")
        lines.extend(remediation_lines)
    if summary["hbm"]:
        lines.append("")
        lines.append("compiled memory (per compiled or captured graph, "
                     "bytes):")
        for k in sorted(summary["hbm"]):
            lines.append(f"  {k:<40} {_n(summary['hbm'][k])}")
    lines.append("")
    if summary["stalls"]:
        lines.append(f"stall events: {len(summary['stalls'])}")
        for s in summary["stalls"]:
            lines.append(
                f"  step={_n(s['step'])} component={s['component']} "
                f"silent={_n(s['staleness_s'])}s note={s['note']!r}")
    else:
        lines.append("stall events: none")
    dumps = summary.get("blackbox_dumps", [])
    if dumps:
        lines.append(f"black-box dumps: {len(dumps)} "
                     "(obs/blackbox.py; bundle with obs/postmortem.py)")
        for d in dumps[-5:]:
            lines.append(
                f"  step={_n(d['step'])} reason={d.get('reason')} "
                f"peer={d.get('peer')} "
                f"component={d.get('component') or '-'} "
                f"path={d.get('path')}")
    return "\n".join(lines)


def check_violations(summary: dict[str, Any]) -> list[str]:
    """Every healthy-range row violated by the summary, one line each.
    This is the CI gate (`--check`): the online engines (PerfMonitor,
    LearnMonitor) stay warn-only by design; a lane that wants to FAIL
    on an unhealthy artifact runs the report over it and exits on the
    same rows the text report flags."""
    gauges = summary.get("gauges", {})
    hists = summary.get("hists", {})
    out: list[str] = []
    for name, (kind, bound, why) in HEALTHY.items():
        row_kind = INSTRUMENTS[name]["kind"]
        if row_kind == "gauge":
            raw = gauges.get(name)
            if raw is None:
                continue
            # budget exhaustion only gates enforce mode (mode gauge
            # 2.0): an observe-mode engine that runs dry is telemetry,
            # not an availability risk — no actuator was going to fire
            if name == "remediation_budget_headroom" and float(
                    gauges.get("remediation_mode", 0.0) or 0.0) < 2.0:
                continue
            v = float(raw)
            if kind == "value_min":
                bad = v < bound
                rel = "<"
            else:
                # q blowup is a magnitude rule (divergence to -inf is
                # just as dead as +inf) — mirror LearnMonitor exactly
                bad = (abs(v) if name == "learn_q_max" else v) > bound
                rel = ">"
            if bad:
                out.append(f"{name}: value={_n(v)} {rel} healthy "
                           f"{_n(float(bound))} — {why}")
        else:  # hist rows warn on a percentile
            h = hists.get(name)
            if not isinstance(h, dict) or not int(h.get("count", 0)):
                continue
            v = h.get(kind)
            if v is not None and float(v) > bound:
                out.append(f"{name}: {kind}={_n(float(v))} > healthy "
                           f"{_n(float(bound))} — {why}")
    # per-tenant serving latency: every serve/<tenant>/p99_ms gauge is
    # held to the same bound as the aggregate infer_latency_ms hist —
    # a single overloaded tenant must not hide inside a healthy mean
    _, lat_bound, lat_why = HEALTHY["infer_latency_ms"]
    for tenant, d in sorted(summary.get("serving", {}).items()):
        p99 = d.get("p99_ms")
        if p99 is not None and float(p99) > lat_bound:
            out.append(f"serve/{tenant}/p99_ms: value={_n(float(p99))} "
                       f"> healthy {_n(float(lat_bound))} — {lat_why}")
    # cold-door thrash: door drops outrunning displacements
    # means evicted mass is being rejected outright rather than
    # displacing lighter residents — the store is saturated with
    # heavier segments and experience is being lost at the door. The
    # disk rung (cold_tier_disk_capacity) exists to absorb exactly this
    # overflow; a run with spills active is exempt only if the drops
    # still found a disk slot (spills keep pace with drops).
    ctrs = summary.get("ctrs", {})
    drops = float(ctrs.get("cold_dropped", 0.0) or 0.0)
    displ = float(ctrs.get("cold_displaced", 0.0) or 0.0)
    spills = float(ctrs.get("cold_disk_spills", 0.0) or 0.0)
    if drops > displ and spills < drops:
        out.append(
            f"cold_dropped: value={_n(drops)} > cold_displaced "
            f"{_n(displ)} — door drops outrun displacements and disk "
            f"spills ({_n(spills)}) did not absorb them: the cold "
            f"store is thrashing; grow cold_tier_capacity or enable "
            f"the disk rung (cold_tier_disk_capacity)")
    # torn shm slots: validation catches them (crc+seq,
    # never delivered), but ANY tear means a writer died mid-pack or
    # something scribbled on the segment — one is an incident, a
    # stream is a crash-looping actor host. Zero is the healthy state.
    torn = float(ctrs.get("shm_torn_slots", 0.0) or 0.0)
    if torn > 0:
        out.append(
            f"shm_torn_slots: value={_n(torn)} > healthy 0 — torn "
            f"ring slots were caught (crc/seq mismatch, freed, never "
            f"delivered) but their writers died mid-pack or the "
            f"segment was corrupted; check actor-host crash loops")
    # forensics: evidence must survive the event it
    # documents. A terminal StallError / quarantine whose run left no
    # black-box dump on disk is silent loss of evidence — the same gap
    # the cold-door thrash row closed for silent spill lag.
    terminals = (
        [("stall", s.get("component")) for s in summary.get("stalls", [])]
        + [("quarantine", q.get("component"))
           for q in summary.get("quarantines", [])]
        + [("peer_stall", p.get("component"))
           for p in summary.get("peer_stalls", [])])
    if terminals:
        on_disk = [d for d in summary.get("blackbox_dumps", [])
                   if d.get("path") and os.path.exists(str(d["path"]))]
        if not on_disk:
            names = ", ".join(sorted({f"{k}:{c}" for k, c in terminals}))
            out.append(
                f"blackbox_dumps: {len(terminals)} terminal event(s) "
                f"({names}) but no black-box dump on disk — silent "
                f"loss of evidence; the flight recorder "
                f"(obs/blackbox.py, ObsConfig.blackbox) should have "
                f"archived the victim's ring as blackbox-<peer>.json")
    # ring-drop fraction, per dump: overwriting old records is the
    # ring's normal steady state, so the global ctr ratio is NOT a
    # health signal — what matters is whether a dump that was supposed
    # to explain an incident had already lost most of its window
    for d in summary.get("blackbox_dumps", []):
        rec_n = float(d.get("recorded") or 0.0)
        drop_n = float(d.get("dropped") or 0.0)
        if rec_n > 0 and drop_n > 0.5 * rec_n:
            out.append(
                f"blackbox_dropped: dump {d.get('path')} "
                f"(reason={d.get('reason')}) overwrote {_n(drop_n)} of "
                f"{_n(rec_n)} ring records before dumping — more than "
                f"half its forensic window was lost; grow "
                f"ObsConfig.blackbox_capacity")
    return out


# -- postmortem mode (obs/postmortem.py bundles) ---------------

# kinds that end a process/component's story — the root-cause walk
# starts from the LAST of these on the merged timeline
TERMINAL_KINDS = ("crash", "stall", "quarantine", "peer_stall",
                  "supervisor_restart", "actor_error", "kill")
# kinds that count as attributed anomalies when walking backwards
# (terminal kinds included: an earlier kill can be the cause of a
# later restart)
ANOMALY_KINDS = TERMINAL_KINDS + (
    "wedge", "perf_degradation", "learning_degradation", "remediation",
    "peer_disconnect", "wire_decode_error", "reconnect", "drop",
    "backpressure", "serve_error", "instrument_range")


def _instrument_anomalies(bundle: dict) -> list[dict]:
    """Each dump's instrument snapshot run through the INSTRUMENTS
    healthy-range table (the same predicate as --check): a violated
    row becomes an attributed anomaly at the dump's wall time."""
    out = []
    for d in bundle.get("dumps", []):
        pseudo = {"gauges": d.get("gauge", {}) or {},
                  "hists": d.get("hist", {}) or {},
                  "ctrs": d.get("ctr", {}) or {}}
        for v in check_violations(pseudo):
            out.append({"t": float(d.get("wall_unix", 0.0)),
                        "peer": d.get("peer", "?"),
                        "kind": "instrument_range",
                        "component": v.split(":", 1)[0],
                        "detail": {"violation": v}})
    return out


def postmortem_root_cause(bundle: dict) -> dict | None:
    """Walk the merged timeline backwards from the terminal event and
    name the first attributed anomaly preceding it. Returns
    ``{"terminal", "anomaly", "gap_s"}`` (anomaly None when the
    terminal event is the first recorded thing), or None for an empty
    bundle."""
    timeline = sorted(list(bundle.get("timeline", []))
                      + _instrument_anomalies(bundle),
                      key=lambda e: float(e.get("t", 0.0)))
    if not timeline:
        return None
    terminal = None
    for e in reversed(timeline):
        if e.get("kind") in TERMINAL_KINDS:
            terminal = e
            break
    if terminal is None:
        terminal = timeline[-1]
    t_key = (terminal.get("kind"), terminal.get("peer"),
             terminal.get("component"))
    anomaly = None
    for e in reversed(timeline):
        if float(e.get("t", 0.0)) > float(terminal.get("t", 0.0)):
            continue
        if e is terminal or e.get("kind") not in ANOMALY_KINDS:
            continue
        # the same incident often appears twice (ring record + JSONL
        # event): an echo of the terminal itself is not its cause
        if (e.get("kind"), e.get("peer"),
                e.get("component")) == t_key:
            continue
        anomaly = e
        break
    gap = (float(terminal.get("t", 0.0)) - float(anomaly.get("t", 0.0))
           if anomaly is not None else None)
    return {"terminal": terminal, "anomaly": anomaly, "gap_s": gap}


def _fmt_event(e: dict) -> str:
    comp = e.get("component")
    return (f"{e.get('kind')} peer={e.get('peer')}"
            + (f" component={comp}" if comp else ""))


def format_postmortem(bundle: dict, tail: int = 20) -> str:
    """Human postmortem: bundle inventory, the timeline tail, and the
    root-cause line the chaos lane asserts on."""
    lines = ["postmortem bundle:"]
    lines.append(f"  peers: {', '.join(bundle.get('peers', [])) or '-'}")
    lines.append(f"  dumps: {len(bundle.get('dumps', []))}")
    for s in bundle.get("skipped_dumps", []):
        lines.append(f"  skipped dump: {s.get('file')} "
                     f"({s.get('reason')})")
    lines.append(f"  frames retained: {len(bundle.get('frames', {}))}")
    lines.append(f"  jsonl tail: {len(bundle.get('jsonl_tail', []))} "
                 "records")
    timeline = bundle.get("timeline", [])
    rc = postmortem_root_cause(bundle)
    lines.append("")
    lines.append(f"timeline (last {min(tail, len(timeline))} of "
                 f"{len(timeline)} events):")
    t_end = float(timeline[-1]["t"]) if timeline else 0.0
    for e in timeline[-tail:]:
        dt = float(e.get("t", 0.0)) - t_end
        lines.append(f"  {dt:+9.3f}s  {_fmt_event(e)}")
    lines.append("")
    if rc is None:
        lines.append("root cause: no events in bundle")
        return "\n".join(lines)
    term = rc["terminal"]
    if rc["anomaly"] is None:
        lines.append(f"root cause: none attributed — terminal event "
                     f"{_fmt_event(term)} is the first recorded event")
    else:
        a = rc["anomaly"]
        detail = a.get("detail") or {}
        why = detail.get("violation") or detail.get("error") \
            or detail.get("reason") or ""
        lines.append(
            f"root cause: {_fmt_event(a)} at -{rc['gap_s']:.3f}s "
            f"before terminal {_fmt_event(term)}"
            + (f" — {why}" if why else ""))
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ape_x_dqn_tpu_torch.obs.report",
        description="Summarize a run's metrics JSONL: stage times, "
                    "staleness percentiles, throughput, stalls.")
    ap.add_argument("jsonl", help="metrics JSONL file (--metrics-file "
                                  "of a run with obs enabled), or a "
                                  "postmortem bundle with --postmortem")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as one JSON object instead "
                         "of the text report")
    ap.add_argument("--postmortem", action="store_true",
                    help="treat the positional argument as an "
                         "obs/postmortem.py bundle: print its merged "
                         "timeline and the root-cause line (walks "
                         "backwards from the terminal event to the "
                         "first attributed anomaly)")
    ap.add_argument("--check", action="store_true",
                    help="health-gate mode: print the report, then "
                         "exit 2 if any healthy-range row is violated "
                         "(the warn-only online engines never abort; "
                         "this is the CI-facing gate)")
    ap.add_argument("--follow", action="store_true",
                    help="live-tail mode: re-summarize and re-print "
                         "whenever the JSONL grows (the fleet "
                         "aggregator appends per-peer frames as they "
                         "arrive); stop with Ctrl-C")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="poll interval for --follow (seconds)")
    args = ap.parse_args(argv)
    if args.postmortem:
        try:
            with open(args.jsonl) as fh:
                bundle = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            print(f"cannot read bundle {args.jsonl}: {e}",
                  file=sys.stderr)
            return 1
        if args.json:
            rc = postmortem_root_cause(bundle)
            print(json.dumps({"root_cause": rc,
                              "peers": bundle.get("peers", []),
                              "dumps": len(bundle.get("dumps", [])),
                              "skipped_dumps":
                                  bundle.get("skipped_dumps", [])}))
        else:
            print(format_postmortem(bundle))
        return 0
    if not args.follow:
        records = load_records(args.jsonl)
        if not records:
            print(f"no records in {args.jsonl}", file=sys.stderr)
            return 1
        summary = summarize(records)
        print(json.dumps(summary) if args.json
              else format_report(summary))
        if args.check:
            violations = check_violations(summary)
            if violations:
                print("\nhealth check: FAILED "
                      f"({len(violations)} healthy-range violations)",
                      file=sys.stderr)
                for v in violations:
                    print(f"  ✗ {v}", file=sys.stderr)
                return 2
            print("\nhealth check: ok — all healthy-range rows pass")
        return 0
    return _follow(args.jsonl, args.interval, args.json)


def _follow(path: str, interval: float, as_json: bool) -> int:
    """Live tail: poll the JSONL's size, re-print the full report on
    growth. Re-summarizing from scratch keeps this trivially correct
    (last-write-wins folding is not incremental-friendly) and the files
    are small — one record per publish/frame, not per transition."""
    import os
    import time as _time

    last_size = -1
    try:
        while True:
            try:
                size = os.stat(path).st_size
            except OSError:
                size = -1  # not created yet; keep polling
            if size != last_size and size > 0:
                last_size = size
                records = load_records(path)
                if records:
                    summary = summarize(records)
                    out = (json.dumps(summary) if as_json
                           else format_report(summary))
                    print(f"--- {path} @ {size} bytes ---")
                    print(out, flush=True)
            _time.sleep(max(interval, 0.1))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
