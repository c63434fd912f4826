"""Metrics / logging.

Counterpart of ``ape_x_dqn_tpu/utils/metrics.py``: learner grad-steps/s,
actor env-frames/s, the Atari-57 median human-normalized score, plus
episode returns, loss and replay occupancy. Output: a JSONL stream and
an in-memory latest snapshot; TensorBoard event files are optional.

Locks are plain ``threading.Lock``s: the original builds them through
``obs/health.py: make_lock``, whose lock-order witness belongs to the
observability port (ROADMAP Queue A item 17).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import IO, Any


class Throughput:
    """Windowed throughput counter (events/sec over a sliding window)."""

    def __init__(self, window_s: float = 10.0):
        self._window = window_s
        self._events: deque[tuple[float, float]] = deque()  # guarded-by: _lock
        self._total = 0.0  # guarded-by: _lock
        self._lock = threading.Lock()

    def add(self, n: float = 1.0, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._events.append((now, n))
            self._total += n
            self._trim(now)

    def _trim(self, now: float) -> None:
        cutoff = now - self._window
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()

    def rate(self, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._trim(now)
            if len(self._events) < 2:
                return 0.0
            span = max(now - self._events[0][0], 1e-3)
            return sum(n for _, n in self._events) / span

    @property
    def total(self) -> float:
        with self._lock:
            return self._total


class Metrics:
    """Thread-safe scalar metric sink: JSONL is canonical, TensorBoard
    event files optional.

    tensorboard_dir gates on a writer import (torch's bundled
    SummaryWriter; tensorboardX as a fallback): asking for event files
    without either installed is a loud error, not a silent no-op."""

    def __init__(self, log_path: str | None = None,
                 tensorboard_dir: str | None = None):
        self._latest: dict[str, Any] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._fh: IO[str] | None = None
        if log_path:
            os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
            self._fh = open(log_path, "a", buffering=1)
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                try:
                    from tensorboardX import SummaryWriter  # type: ignore
                except ImportError as e:
                    raise ImportError(
                        "tensorboard_dir needs an event-file writer: "
                        "install tensorboard (torch.utils.tensorboard) or "
                        "tensorboardX, or drop the flag — JSONL logging "
                        "works without either") from e
            self._tb = SummaryWriter(tensorboard_dir)

    def log(self, step: int, **scalars: Any) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            if isinstance(v, bool):
                pass  # JSON booleans stay booleans (flags in headers)
            elif hasattr(v, "__float__"):
                v = float(v)
                # keep the JSONL strictly parseable even when training
                # diverges (NaN/Inf are not valid JSON)
                if v != v or v in (float("inf"), float("-inf")):
                    v = None
            rec[k] = v
        with self._lock:
            self._latest.update(rec)
            if self._fh is not None:
                self._fh.write(json.dumps(rec) + "\n")
            if self._tb is not None:
                for k, v in rec.items():
                    if k not in ("step", "time") and isinstance(
                            v, (int, float)):
                        self._tb.add_scalar(k, v, int(step))

    def latest(self) -> dict[str, Any]:
        with self._lock:
            return dict(self._latest)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            if self._tb is not None:
                self._tb.close()
                self._tb = None


def log_run_header(metrics: Metrics, cfg: Any, step: int = 0) -> None:
    """First-record run description: the sampling semantics and storage
    layout that produced a run's numbers live IN the metrics stream, not
    only in the config dump. Every trainer calls this once before its
    first training record."""
    from ape_x_dqn_tpu_torch import __version__

    metrics.log(
        step,
        run_name=cfg.name,
        version=__version__,
        sample_chunk=max(getattr(cfg.learner, "sample_chunk", 1) or 1, 1),
        sample_prefetch=bool(getattr(cfg.learner, "sample_prefetch",
                                     False)),
        replay_kind=cfg.replay.kind,
        replay_storage=cfg.replay.storage,
        replay_capacity=cfg.replay.capacity,
        batch_size=cfg.learner.batch_size,
        train_chunk=cfg.learner.train_chunk,
        dp=cfg.parallel.dp, tp=cfg.parallel.tp)


# Atari-57 human / random score table for the human-normalized-score (HNS)
# metric. Values from Wang et al. 2016 (Dueling) appendix, the standard
# source.
ATARI_HUMAN_RANDOM: dict[str, tuple[float, float]] = {
    # game: (random, human)
    "alien": (227.8, 7127.7), "amidar": (5.8, 1719.5),
    "assault": (222.4, 742.0), "asterix": (210.0, 8503.3),
    "asteroids": (719.1, 47388.7), "atlantis": (12850.0, 29028.1),
    "bank_heist": (14.2, 753.1), "battle_zone": (2360.0, 37187.5),
    "beam_rider": (363.9, 16926.5), "berzerk": (123.7, 2630.4),
    "bowling": (23.1, 160.7), "boxing": (0.1, 12.1),
    "breakout": (1.7, 30.5), "centipede": (2090.9, 12017.0),
    "chopper_command": (811.0, 7387.8), "crazy_climber": (10780.5, 35829.4),
    "defender": (2874.5, 18688.9), "demon_attack": (152.1, 1971.0),
    "double_dunk": (-18.6, -16.4), "enduro": (0.0, 860.5),
    "fishing_derby": (-91.7, -38.7), "freeway": (0.0, 29.6),
    "frostbite": (65.2, 4334.7), "gopher": (257.6, 2412.5),
    "gravitar": (173.0, 3351.4), "hero": (1027.0, 30826.4),
    "ice_hockey": (-11.2, 0.9), "jamesbond": (29.0, 302.8),
    "kangaroo": (52.0, 3035.0), "krull": (1598.0, 2665.5),
    "kung_fu_master": (258.5, 22736.3), "montezuma_revenge": (0.0, 4753.3),
    "ms_pacman": (307.3, 6951.6), "name_this_game": (2292.3, 8049.0),
    "phoenix": (761.4, 7242.6), "pitfall": (-229.4, 6463.7),
    "pong": (-20.7, 14.6), "private_eye": (24.9, 69571.3),
    "qbert": (163.9, 13455.0), "riverraid": (1338.5, 17118.0),
    "road_runner": (11.5, 7845.0), "robotank": (2.2, 11.9),
    "seaquest": (68.4, 42054.7), "skiing": (-17098.1, -4336.9),
    "solaris": (1236.3, 12326.7), "space_invaders": (148.0, 1668.7),
    "star_gunner": (664.0, 10250.0), "surround": (-10.0, 6.5),
    "tennis": (-23.8, -8.3), "time_pilot": (3568.0, 5229.2),
    "tutankham": (11.4, 167.6), "up_n_down": (533.4, 11693.2),
    "venture": (0.0, 1187.5), "video_pinball": (16256.9, 17667.9),
    "wizard_of_wor": (563.5, 4756.5), "yars_revenge": (3092.9, 54576.9),
    "zaxxon": (32.5, 9173.3),
}


def human_normalized_score(game: str, score: float) -> float:
    if game not in ATARI_HUMAN_RANDOM:
        import difflib
        close = difflib.get_close_matches(game, ATARI_HUMAN_RANDOM,
                                          n=3, cutoff=0.4)
        hint = (f"; closest valid keys: {close}" if close
                else "; valid keys are snake_case ALE game names "
                     "(e.g. 'space_invaders')")
        raise ValueError(
            f"unknown Atari game {game!r} for the human-normalized "
            f"score table{hint}")
    rand, human = ATARI_HUMAN_RANDOM[game]
    return (score - rand) / (human - rand)


def median_hns(scores: dict[str, float]) -> float:
    """Median human-normalized score over a suite of games."""
    import statistics
    vals = [human_normalized_score(g, s) for g, s in scores.items()]
    return statistics.median(vals) if vals else 0.0
