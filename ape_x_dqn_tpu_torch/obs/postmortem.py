"""Fleet postmortem bundler — merge the black boxes into one story.

After a drill (or a real incident) the evidence is scattered: each
process left a ``blackbox-<peer>.json`` (obs/blackbox.py), the run's
metrics JSONL carries the learner-side attributed events, and the
learner's FleetAggregator retained the LAST telemetry frame from every
peer — for a process that died without managing a dump, that frame is
its black box of last resort. ``build_bundle`` collects all three,
normalizes everything into timeline entries ``{t, peer, kind,
component?, batch_id?, epoch?, detail}``, and writes one causally
ordered (wall-clock sorted, insertion-stable on ties) bundle that
``report --postmortem`` can walk backwards from the terminal event.

Torn dumps — a kill mid-``os.replace`` window, or a stray ``.tmp`` —
are skipped, counted, and NAMED in ``skipped_dumps`` rather than
aborting the bundle: forensics must degrade gracefully under exactly
the failures it documents.

Stdlib-only on purpose (like obs/report.py): postmortems run on
machines with no jax.

The PyTorch package's copy of ``ape_x_dqn_tpu/obs/postmortem.py``, the same
code (tests/test_torch_isolation.py pins it).
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Any

# JSONL keys that become attributed timeline entries; value is
# (kind, how-to-name-the-component)
_JSONL_EVENT_KEYS = (
    ("stall_component", "stall", lambda v, rec: str(v)),
    ("peer_disconnect", "peer_disconnect", lambda v, rec: str(v)),
    ("perf_degradation", "perf_degradation", lambda v, rec: str(v)),
    ("learning_degradation", "learning_degradation",
     lambda v, rec: str(v)),
    ("remediation", "remediation",
     lambda v, rec: str(rec.get("remediation_target", v))),
    ("actor_quarantined", "quarantine", lambda v, rec: f"actor-{v}"),
    ("supervisor_restart", "supervisor_restart",
     lambda v, rec: f"actor-{v}"),
    ("peer_stall", "peer_stall", lambda v, rec: str(v)),
    ("blackbox_dump", "dump",
     lambda v, rec: str(rec.get("blackbox_component", ""))),
)

_ATTR_KEYS = ("peer", "component", "batch_id", "epoch", "tenant")


def collect_dumps(blackbox_dir: str) -> tuple[list[dict], list[dict]]:
    """Parse every ``blackbox-*.json`` under ``blackbox_dir``. Returns
    (dumps, skipped) where each skipped entry names the file and why —
    truncation-safe partials must be counted, never fatal."""
    dumps: list[dict] = []
    skipped: list[dict] = []
    pattern = os.path.join(blackbox_dir, "blackbox-*.json")
    for path in sorted(glob.glob(pattern)):
        try:
            with open(path) as fh:
                d = json.load(fh)
            if not isinstance(d, dict) or "peer" not in d:
                skipped.append({"file": os.path.basename(path),
                                "reason": "not a blackbox dump"})
                continue
            d["_file"] = os.path.basename(path)
            dumps.append(d)
        except (json.JSONDecodeError, UnicodeDecodeError):
            skipped.append({"file": os.path.basename(path),
                            "reason": "truncated/unparseable"})
        except OSError as e:
            skipped.append({"file": os.path.basename(path),
                            "reason": f"unreadable: {e.__class__.__name__}"})
    # a stray .tmp is a dump that never completed its os.replace
    for path in sorted(glob.glob(pattern + ".tmp")):
        skipped.append({"file": os.path.basename(path),
                        "reason": "incomplete (tmp left behind)"})
    return dumps, skipped


def tail_jsonl(jsonl_path: str, n: int = 400) -> list[dict]:
    """Last n parseable records of the run JSONL (torn lines skipped,
    same tolerance as report.load_records)."""
    records: list[dict] = []
    try:
        with open(jsonl_path) as fh:
            lines = fh.readlines()
    except OSError:
        return records
    for line in lines[-n:]:
        line = line.strip()
        if not line:
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    return records


def _entry(t: float, peer: str, kind: str, component: str = "",
           detail: dict | None = None) -> dict:
    e: dict[str, Any] = {"t": round(float(t), 6), "peer": peer,
                         "kind": kind}
    if component:
        e["component"] = component
    if detail:
        for k in ("batch_id", "epoch", "tenant"):
            if k in detail:
                e[k] = detail[k]
        e["detail"] = detail
    return e


def _timeline_from_dump(dump: dict) -> list[dict]:
    peer = str(dump.get("peer", "?"))
    out = []
    for rec in dump.get("records", []):
        fields = {k: v for k, v in rec.items()
                  if k not in ("t", "kind")}
        rec_peer = str(fields.pop("peer", "")) or peer
        comp = str(fields.pop("component", ""))
        out.append(_entry(rec.get("t", 0.0), rec_peer,
                          str(rec.get("kind", "event")), comp, fields))
    out.append(_entry(dump.get("wall_unix", 0.0), peer, "dump",
                      str(dump.get("component", "")),
                      {"reason": dump.get("reason", ""),
                       "file": dump.get("_file", ""),
                       "dropped": dump.get("dropped", 0)}))
    return out


def _timeline_from_jsonl(records: list[dict]) -> list[dict]:
    out = []
    for rec in records:
        t = rec.get("time")
        if t is None:
            continue
        for key, kind, name in _JSONL_EVENT_KEYS:
            if rec.get(key) is None:
                continue
            peer = str(rec.get("perf_peer") or rec.get("blackbox_peer")
                       or rec.get("peer_disconnect") or "learner")
            detail = {k: v for k, v in rec.items()
                      if k not in ("time",) and v is not None}
            out.append(_entry(t, peer, kind, name(rec[key], rec),
                              detail))
    return out


def _timeline_from_frames(frames: dict) -> list[dict]:
    out = []
    for peer, st in (frames or {}).items():
        frame = st.get("frame") if isinstance(st, dict) else None
        if not isinstance(frame, dict):
            continue
        recv = float(st.get("recv_unix", 0.0))
        out.append(_entry(recv, str(peer), "telemetry_frame", "",
                          {"seq": frame.get("seq", -1),
                           "connected": bool(st.get("connected",
                                                    False))}))
        # correlation events ride the frame with ages relative to its
        # receive time: t ~= recv - age
        for ev in frame.get("events", []) or []:
            try:
                name, dur, age, args = ev
            except (TypeError, ValueError):
                continue
            detail = dict(args) if isinstance(args, dict) else {}
            detail["dur"] = dur
            out.append(_entry(recv - float(age), str(peer), str(name),
                              "", detail))
    return out


def build_bundle(blackbox_dir: str, jsonl_path: str | None = None,
                 frames: dict | None = None,
                 out_path: str | None = None, obs: Any = None,
                 tail_records: int = 400) -> dict:
    """Collect dumps + JSONL tail + retained telemetry frames into one
    causally-ordered timeline bundle; optionally write it atomically.

    ``frames`` is FleetAggregator.retained_frames() when bundling in
    the learner process; offline, the driver's own dump carries the
    same map under ``peer_frames`` and is merged from there.
    """
    dumps, skipped = collect_dumps(blackbox_dir)
    frames = dict(frames or {})
    for d in dumps:
        for peer, st in (d.get("peer_frames") or {}).items():
            frames.setdefault(peer, st)
    tail = tail_jsonl(jsonl_path, tail_records) if jsonl_path else []

    timeline: list[dict] = []
    for d in dumps:
        timeline.extend(_timeline_from_dump(d))
    timeline.extend(_timeline_from_jsonl(tail))
    timeline.extend(_timeline_from_frames(frames))
    timeline.sort(key=lambda e: e["t"])  # stable: ties keep source order

    bundle = {
        "postmortem": 1,
        "created_unix": time.time(),
        "blackbox_dir": os.path.abspath(blackbox_dir),
        "jsonl": os.path.abspath(jsonl_path) if jsonl_path else None,
        "peers": sorted({str(d.get("peer", "?")) for d in dumps}
                        | set(frames)),
        "dumps": dumps,
        "skipped_dumps": skipped,
        "frames": frames,
        "jsonl_tail": tail,
        "timeline": timeline,
    }
    if obs is not None:
        obs.count("postmortem_bundles")
    if out_path:
        tmp = out_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(bundle, fh)
        os.replace(tmp, out_path)
        bundle["path"] = os.path.abspath(out_path)
    return bundle
