"""Obs facade: the disabled half.

Counterpart of ``ape_x_dqn_tpu/obs/core.py``. The runtime threads every
span, metric and heartbeat through one facade object, so the disabled
path is a method call on the `NullObs` singleton, with no conditionals
in runtime code. Observability is off in every preset
(``ObsConfig.enabled`` defaults to False), and that is the only path
ported so far: the enabled facade (span tracer, metric registry,
heartbeat watchdog, stage profiler, flight recorder) is the device
observability port, ROADMAP Queue A item 17. Until it lands,
`build_obs` refuses an enabled config rather than running without the
observability that was asked for.
"""

from __future__ import annotations

import contextlib
from typing import Any


class NullBlackBox:
    """Disabled flight recorder: installs no crash hooks and records
    nothing (counterpart of ``obs/blackbox.py: NullBlackBox``, with the
    methods the ported runtime calls)."""

    enabled = False

    def install(self, signals: bool = True) -> None:
        pass

    def record(self, kind: str, **fields: Any) -> None:
        pass

    def set_peer(self, peer: str) -> None:
        pass

    def add_context_provider(self, fn) -> None:
        pass

    def dump(self, reason: str, **fields: Any) -> None:
        pass


NULL_BLACKBOX = NullBlackBox()


class NullObs:
    """No-op facade: the runtime calls this when obs is disabled. It has
    the methods of the original's NullObs that the ported runtime calls;
    the rest of the surface arrives with the enabled facade."""

    enabled = False
    blackbox = NULL_BLACKBOX
    watchdog = None   # no stall watchdog: the driver's supervisor idles
    heartbeats = None

    def span(self, name: str, **args: Any):
        return contextlib.nullcontext()

    def stage_window(self, stage: str, steps: int = 1):
        return contextlib.nullcontext()

    def mark(self, name: str, **args: Any) -> None:
        pass

    def clear(self, name: str) -> None:
        pass

    def observe(self, name: str, value: float) -> None:
        pass

    def stage_attach(self, stage: str, steps: int, compiled=None) -> None:
        pass

    def log_compiled(self, name: str, compiled) -> None:
        pass

    def on_server_batch(self, items: int, params_version: int,
                        queue_depth: int) -> None:
        pass

    def set_learner_step(self, step: int) -> None:
        pass

    def maybe_profile(self, step: int) -> None:
        pass

    def perf_rate(self, name: str, value: float, step: int = 0) -> None:
        pass

    def publish(self, step: int) -> None:
        pass

    def learn_health(self, diag, loss: float, step: int = 0,
                     tenant: str = "") -> None:
        pass

    def register(self, name: str) -> None:
        pass

    def beat(self, name: str, note: str = "") -> None:
        pass

    def check_stalled(self) -> None:
        pass

    def gauge(self, name: str, value) -> None:
        pass

    def count(self, name: str, n: float = 1.0) -> None:
        pass

    def close(self, step: int = 0) -> None:
        pass


NULL_OBS = NullObs()


def build_obs(obs_cfg, metrics) -> NullObs:
    """NULL_OBS unless the config exists and is enabled. An enabled
    config raises: the observed facade is not ported yet."""
    if obs_cfg is None or not getattr(obs_cfg, "enabled", False):
        return NULL_OBS
    raise NotImplementedError(
        "obs.enabled=true asks for the observability layer (span tracer, "
        "metric registry, stall watchdog, stage profiler), which the "
        "PyTorch package does not have yet: it waits for the device "
        "observability port (ROADMAP Queue A item 17). Run with "
        "obs.enabled=false.")
