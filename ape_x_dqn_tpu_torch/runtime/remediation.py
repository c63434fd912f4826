"""Fleet remediation plane: the policy engine that closes the
monitor -> actuator loop (ROADMAP item 4).

Every sensor and every actuator it drives exists on its own: the
driver's supervised restart / quarantine, the attributed
`perf_degradation` and `learning_degradation` events, and the
serve-SLO gauges plus priority shedding and `set_backpressure`. What
was missing is the connection — the monitors were warn-only and the
actuators manually or statically triggered. This engine runs inside
the driver's existing supervisor tick and maps attributed degradation
to BOUNDED actions:

    sensor                          rule              actuator
    ------------------------------  ----------------  -----------------
    stale local actor heartbeat     actor-wedge       restart_actor
    stale remote peer heartbeat     peer-stall        quarantine_peer
    perf_degradation events (peer)  peer-perf         quarantine_peer
    serve queue depth vs SLO        queue-slo         set_backpressure
    ingest drop pressure            ingest-pressure   pause/resume_actor
    learning_degradation events     learn-health      set_priority

Bounded means:
- hysteresis: gauge rules need `hysteresis_ticks` CONSECUTIVE
  agreeing supervisor ticks before an actuator moves, and again before
  it moves back — a sensor flapping breach/clear every tick holds a
  streak of +-1 forever and never trips anything;
- event windows: event rules need `event_threshold` attributed events
  on one target inside `event_window_s` — one noisy sample is not a
  policy decision;
- per-target cooldown: the same remedy is not re-applied to the same
  target within `cooldown_s` (a re-wedging actor falls back to the
  driver's own escalation ladder, which ends in quarantine);
- a global actions/minute token bucket for non-safety actions. SAFETY
  actions (restarting a wedged local slot, quarantining a stalled
  peer) bypass the bucket: suppressing them would leave a stale
  heartbeat for the watchdog to escalate into a run-fatal StallError —
  strictly worse than acting. They are still cooldown-limited and
  fully recorded.

Every decision is attributed in the run JSONL (`remediation` events
naming rule, target, action, outcome) and counted via remediation_*
instruments (obs/report.py INSTRUMENTS). Modes:
- "off": the driver never constructs the engine; the supervisor path
  is bitwise the pre-remediation one.
- "observe": the full decision pipeline runs and emits (outcome
  "observed"), but NO actuator is ever called — the dry run that
  builds trust before "enforce" is turned on.
- "enforce": actuators are called; outcome "applied" / "skipped"
  (actuator reported not-applicable) / "failed:<ExcName>" (actuator
  raised — never propagated into the supervisor tick).

The PyTorch package's copy of ``ape_x_dqn_tpu/runtime/remediation.py``, the same
code (tests/test_torch_isolation.py pins it).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable

from ape_x_dqn_tpu_torch.obs.health import make_lock


@dataclass
class Actuators:
    """The bounded actions the engine may take, as injected callables
    (the driver wires its own methods in; tests wire fakes). A missing
    callable makes the corresponding rules decide "unwired" — the
    engine degrades per-actuator, never crashes. A callable returning
    False means "looked, not applicable" (outcome "skipped")."""

    restart_actor: Callable[[int, float], Any] | None = None
    quarantine_peer: Callable[[str, float], Any] | None = None
    pause_actor: Callable[[int], Any] | None = None
    resume_actor: Callable[[int], Any] | None = None
    set_backpressure: Callable[[bool], Any] | None = None
    set_priority: Callable[[str, int], Any] | None = None


class RemediationEngine:
    """Declarative rule engine; one instance per driver, ticked from
    `_supervise_tick`. Thread-safe: `note_perf` / `note_learn` arrive
    from monitor fire paths on other threads. The engine lock is never
    held across an actuator call (actuators take the driver lock)."""

    def __init__(self, cfg, obs, metrics, actuators: Actuators,
                 default_class: int = 1,
                 clock: Callable[[], float] | None = None) -> None:
        self.cfg = cfg
        self.mode = cfg.mode
        self._obs = obs
        self._metrics = metrics
        self._act = actuators
        self._default_class = default_class
        self._clock = clock or time.monotonic
        self._lock = make_lock("remediation.engine")
        now = self._clock()
        # (target, label) -> time of last non-cooldown decision
        self._last_action: dict[tuple[str, str], float] = {}  # guarded-by: _lock
        # (target, label) -> time a budget-suppression was last EMITTED
        # (suppression repeats silently inside one cooldown window)
        self._last_suppress: dict[tuple[str, str], float] = {}  # guarded-by: _lock
        self._tokens = float(cfg.budget_per_min)  # guarded-by: _lock
        self._tokens_t = now  # guarded-by: _lock
        # (rule, target) -> recent event times, pruned to event_window_s
        self._events: dict[tuple[str, str], deque] = {}  # guarded-by: _lock
        # rule -> signed consecutive-tick streak (+breach / -clear)
        self._streaks: dict[str, int] = {}  # guarded-by: _lock
        self._bp_on = False  # guarded-by: _lock
        self._paused_at: dict[int, float] = {}  # guarded-by: _lock
        self._boosted: set[str] = set()  # guarded-by: _lock
        self._learn_last: dict[str, float] = {}  # guarded-by: _lock
        self._counts: dict[str, int] = {}  # guarded-by: _lock
        self._recent: deque = deque(maxlen=64)  # guarded-by: _lock

    # -- sensors: safety events (stale heartbeats) ----------------------

    def remediate_stale_actor(self, slot: int, staleness_s: float,
                              step: int = 0) -> bool:
        """A LOCAL actor thread went silent past the watchdog timeout.
        Returns True only when the restart actuator actually ran — the
        driver then skips its default path; any other outcome
        (observed / cooldown / failed / unwired) falls back to the
        pre-remediation supervisor, so a wedged slot is never left for
        check_stalled() to escalate."""
        out = self._decide("actor-wedge", f"actor-{slot}",
                           "restart_actor", step,
                           args=(slot, staleness_s), safety=True,
                           value=staleness_s)
        return out == "applied"

    def remediate_stale_peer(self, name: str, staleness_s: float,
                             step: int = 0) -> bool:
        """A REMOTE peer's re-beaten heartbeat went stale. Same
        True-means-handled contract as remediate_stale_actor."""
        out = self._decide("peer-stall", name, "quarantine_peer", step,
                           args=(name, staleness_s), safety=True,
                           value=staleness_s)
        return out == "applied"

    # -- sensors: attributed degradation events -------------------------

    def note_perf(self, name: str, value: float, baseline: float,
                  step: int = 0, peer: str = "") -> None:
        """PerfMonitor fire listener (obs/profiling.py). Only
        peer-attributed degradations have a bounded remedy (quarantine
        the degraded peer); local learner/ingest rate sags stay
        warn-only — there is no safe automatic action on the learner."""
        if self.mode == "off" or not peer:
            return
        if self._note_event("peer-perf", peer):
            self._decide("peer-perf", peer, "quarantine_peer", step,
                         args=(peer, 0.0), value=value,
                         baseline=baseline)

    def note_learn(self, rule: str, value: float, baseline: float,
                   step: int = 0, tenant: str = "") -> None:
        """LearnMonitor fire listener (obs/learning.py). Sustained
        learning-health sag on a tenant re-tempers its serving
        priority to the top class (its inference stops being shed
        first); tick() restores the default class after
        release_after_s of quiet."""
        if self.mode == "off" or not tenant:
            return
        now = self._clock()
        with self._lock:
            self._learn_last[tenant] = now
        if self._note_event("learn-health", tenant):
            out = self._decide("learn-health", tenant, "set_priority",
                               step, args=(tenant, 0),
                               label="boost_priority", value=value,
                               baseline=baseline)
            if out in ("applied", "observed"):
                with self._lock:
                    self._boosted.add(tenant)

    # -- the per-tick gauge rules ---------------------------------------

    def tick(self, sensors: dict, step: int = 0) -> None:
        """One supervisor-tick evaluation over gauge sensors. The
        driver builds `sensors` fresh each tick: queue_depth /
        queue_slo / backpressure (serving tier), ingest_dropped_delta,
        running_slots / paused_slots (local actor fleet)."""
        if self.mode == "off":
            return
        now = self._clock()
        self._tick_queue(sensors, step)
        self._tick_ingest(sensors, step, now)
        self._tick_releases(step, now)
        with self._lock:
            self._refill_locked(now)
            tokens = self._tokens
        self._obs.gauge("remediation_budget_headroom", round(tokens, 2))
        self._obs.gauge("remediation_mode",
                        2.0 if self.mode == "enforce" else 1.0)

    def _tick_queue(self, sensors: dict, step: int) -> None:
        depth = sensors.get("queue_depth")
        slo = sensors.get("queue_slo")
        if depth is None or not slo:
            return
        with self._lock:
            s = self._streak_locked("queue-slo", depth > slo)
            engaged = self._bp_on
        # in enforce mode trust the tier's real flag when reported (the
        # tier's own admission controller also moves it); the dry-run
        # state machine stands in everywhere else
        if self.mode == "enforce" and "backpressure" in sensors:
            engaged = bool(sensors["backpressure"])
        h = self.cfg.hysteresis_ticks
        if s >= h and not engaged:
            out = self._decide("queue-slo", "serving",
                               "set_backpressure", step, args=(True,),
                               label="engage_backpressure",
                               value=depth, baseline=slo)
            if out in ("applied", "observed"):
                with self._lock:
                    self._bp_on = True
        elif -s >= h and engaged:
            out = self._decide("queue-slo", "serving",
                               "set_backpressure", step, args=(False,),
                               label="release_backpressure",
                               value=depth, baseline=slo)
            if out in ("applied", "observed"):
                with self._lock:
                    self._bp_on = False

    def _tick_ingest(self, sensors: dict, step: int,
                     now: float) -> None:
        drops = sensors.get("ingest_dropped_delta")
        if drops is None:
            return
        running = sorted(sensors.get("running_slots") or ())
        paused = sorted(sensors.get("paused_slots") or ())
        with self._lock:
            s = self._streak_locked("ingest-pressure", drops > 0)
        h = self.cfg.hysteresis_ticks
        if s >= h and len(running) > max(self.cfg.min_actors, 0):
            slot = running[-1]  # downscale from the top of the schedule
            out = self._decide("ingest-pressure", f"actor-{slot}",
                               "pause_actor", step, args=(slot,),
                               value=drops)
            if out in ("applied", "observed"):
                with self._lock:
                    self._paused_at[slot] = now
        elif -s >= h and paused:
            slot = paused[0]
            out = self._decide("ingest-pressure", f"actor-{slot}",
                               "resume_actor", step, args=(slot,))
            if out in ("applied", "observed"):
                with self._lock:
                    self._paused_at.pop(slot, None)

    def _tick_releases(self, step: int, now: float) -> None:
        """Unwind engaged remedies after release_after_s of quiet:
        boosted tenant priorities revert to the default class, and a
        paused slot whose pressure signal went away (or stopped being
        reported) resumes on timeout even if the clear-streak path
        never fires."""
        rel = self.cfg.release_after_s
        with self._lock:
            restore = [t for t in self._boosted
                       if now - self._learn_last.get(t, now) >= rel]
            stale_pause = [i for i, t0 in self._paused_at.items()
                           if now - t0 >= rel]
        for tenant in restore:
            out = self._decide("learn-health", tenant, "set_priority",
                               step, args=(tenant, self._default_class),
                               label="restore_priority")
            if out in ("applied", "observed"):
                with self._lock:
                    self._boosted.discard(tenant)
        for slot in stale_pause:
            out = self._decide("ingest-pressure", f"actor-{slot}",
                               "resume_actor", step, args=(slot,))
            if out in ("applied", "observed"):
                with self._lock:
                    self._paused_at.pop(slot, None)

    # -- the decision core ----------------------------------------------

    def _decide(self, rule: str, target: str, action: str, step: int,
                args: tuple = (), label: str | None = None,
                safety: bool = False, value=None,
                baseline=None) -> str:
        """Gate one would-be action through mode, per-target cooldown
        and (non-safety) the global budget; emit the attributed event
        and counters; in enforce mode, run the actuator."""
        label = label or action
        now = self._clock()
        outcome: str | None
        emit = True
        with self._lock:
            key = (target, label)
            if now - self._last_action.get(key, float("-inf")) \
                    < self.cfg.cooldown_s:
                # the rate limiter doing its job is bookkept, not an
                # event — a persisting breach would otherwise spam one
                # JSONL line per supervisor tick
                self._bump_locked(rule, target, label, "cooldown")
                return "cooldown"
            self._refill_locked(now)
            if not safety and self._tokens < 1.0:
                outcome = "suppressed:budget"
                # visible at most once per cooldown window per target
                emit = now - self._last_suppress.get(
                    key, float("-inf")) >= self.cfg.cooldown_s
                if emit:
                    self._last_suppress[key] = now
            else:
                if not safety:
                    self._tokens -= 1.0
                self._last_action[key] = now
                outcome = ("observed" if self.mode == "observe"
                           else None)
        if outcome is None:  # enforce: act, outside the engine lock
            outcome = self._apply(action, args)
        self._emit(rule, target, label, outcome, step, value, baseline,
                   emit=emit)
        return outcome

    def _apply(self, action: str, args: tuple) -> str:
        """Enforce-mode actuator dispatch. The literal call sites here
        are what tools/apexlint's remediation-accounting checker
        audits: every actuator invocation is co-located with its
        remediation_* counter bump."""
        act = self._act
        try:
            if action == "restart_actor" \
                    and act.restart_actor is not None:
                out = act.restart_actor(*args)
            elif action == "quarantine_peer" \
                    and act.quarantine_peer is not None:
                out = act.quarantine_peer(*args)
            elif action == "pause_actor" \
                    and act.pause_actor is not None:
                out = act.pause_actor(*args)
            elif action == "resume_actor" \
                    and act.resume_actor is not None:
                out = act.resume_actor(*args)
            elif action == "set_backpressure" \
                    and act.set_backpressure is not None:
                out = act.set_backpressure(*args)
            elif action == "set_priority" \
                    and act.set_priority is not None:
                out = act.set_priority(*args)
            else:
                return "unwired"
        except Exception as e:  # noqa: BLE001 - never crash the tick
            self._obs.count("remediation_failed")
            return f"failed:{type(e).__name__}"
        if out is False:
            return "skipped"
        self._obs.count("remediation_actions")
        return "applied"

    def _emit(self, rule: str, target: str, label: str, outcome: str,
              step: int, value, baseline, emit: bool = True) -> None:
        with self._lock:
            self._bump_locked(rule, target, label, outcome)
        if not emit:
            return
        if outcome == "observed":
            self._obs.count("remediation_observed")
        elif outcome.startswith("suppressed"):
            self._obs.count("remediation_suppressed")
        # applied / failed counters are bumped at the actuator call
        # site in _apply (the accounting the lint checker pins there)
        if self._metrics is None:
            return
        kw: dict[str, Any] = {"remediation": rule,
                              "remediation_target": target,
                              "remediation_action": label,
                              "remediation_outcome": outcome}
        if value is not None:
            kw["remediation_value"] = round(float(value), 6)
        if baseline is not None:
            kw["remediation_baseline"] = round(float(baseline), 6)
        self._metrics.log(step, **kw)

    # -- internals -------------------------------------------------------

    def _note_event(self, rule: str, target: str) -> bool:
        """Record one attributed event; True when the (rule, target)
        pair crossed event_threshold inside the sliding window."""
        now = self._clock()
        with self._lock:
            dq = self._events.setdefault((rule, target),
                                         deque(maxlen=32))
            dq.append(now)
            while dq and now - dq[0] > self.cfg.event_window_s:
                dq.popleft()
            return len(dq) >= self.cfg.event_threshold

    def _streak_locked(self, rule: str, breach: bool) -> int:
        s = self._streaks.get(rule, 0)
        if breach:
            s = s + 1 if s > 0 else 1
        else:
            s = s - 1 if s < 0 else -1
        self._streaks[rule] = s  # apexlint: unguarded(caller holds _lock)
        return s

    def _refill_locked(self, now: float) -> None:
        rate = self.cfg.budget_per_min / 60.0
        self._tokens = min(float(self.cfg.budget_per_min),  # apexlint: unguarded(caller holds _lock)
                           self._tokens
                           + (now - self._tokens_t) * rate)
        self._tokens_t = now  # apexlint: unguarded(caller holds _lock)

    def _bump_locked(self, rule: str, target: str, label: str,
                     outcome: str) -> None:
        base = outcome.split(":", 1)[0]
        self._counts[base] = self._counts.get(base, 0) + 1  # apexlint: unguarded(caller holds _lock)
        self._recent.append((rule, target, label, outcome))

    def summary(self) -> dict:
        """Final accounting for the driver's result dict."""
        with self._lock:
            by_rule: dict[str, int] = {}
            for rule, _t, _l, out in self._recent:
                if out.split(":", 1)[0] in ("applied", "observed"):
                    by_rule[rule] = by_rule.get(rule, 0) + 1
            return {"mode": self.mode,
                    "counts": dict(self._counts),
                    "decided_by_rule": by_rule,
                    "budget_tokens": round(self._tokens, 2),
                    "recent": [list(r) for r in self._recent]}
