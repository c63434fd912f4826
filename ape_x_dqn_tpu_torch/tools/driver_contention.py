"""How the learner's form shapes the Ape-X driver on the card.

Runs the driver through the default CLI mode on the card, once per arm:

- "graph": the driver as shipped: the learner replays captured CUDA
  graphs (runtime/step_graph.py) and the actors are not gated;
- "eager": the learner's bodies run eagerly (`capture` off), so the
  driver gates the actors while the learner dispatches
  (runtime/driver.py: ApexDriver._gated), as every driver before the
  graphs did;
- "eager_ungated": the eager learner with that gate removed, so the
  actor threads keep the interpreter busy while the learner issues its
  thousands of torch calls per macro-step.

`--config pong` runs the pong preset as `chip_smoke.py`'s apex phase
does; `--config r2d2` runs the r2d2 preset on one card as its r2d2
phase does (`--set parallel.dp=1 --set parallel.tp=1 --actors 8 --set
replay.min_fill=256`). For each run it prints one JSON line: the
seconds of every train_many call (host clock, the device synchronised
after each), the grad-steps and their rate over the training window
(first train_many call to the end of the last), the env frames that
reached replay, the transport's drops and the wall seconds. Usage,
from the repository root on a machine with a card:

    python -m ape_x_dqn_tpu_torch.tools.driver_contention \\
        [--config pong|r2d2] [--frames 60000] [--wall 180] \\
        [--arms graph,eager,eager_ungated]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import time

import torch

from ape_x_dqn_tpu_torch.runtime import train
from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
from ape_x_dqn_tpu_torch.runtime.learner import SingleChipLearner

# arm: (learner capture on, actors gated when the learner is eager)
ARMS = {"graph": (True, True), "eager": (False, True),
        "eager_ungated": (False, False)}
CONFIGS = {
    "pong": ["--config", "pong"],
    "r2d2": ["--config", "r2d2", "--set", "parallel.dp=1", "--set",
             "parallel.tp=1", "--actors", "8", "--set",
             "replay.min_fill=256"],
}


def run_once(config: str, label: str, frames: int, wall: float) -> dict:
    capture, gated = ARMS[label]
    calls: list[float] = []
    window: list[float] = []
    orig_tm, orig_gate = SingleChipLearner.train_many, ApexDriver._gated
    orig_capture = SingleChipLearner.capture

    def train_many(self, state, n, noise=None):
        t0 = time.perf_counter()
        out = orig_tm(self, state, n, noise)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        calls.append(t1 - t0)
        window[:] = [window[0] if window else t0, t1]
        return out

    SingleChipLearner.train_many = train_many
    SingleChipLearner.capture = capture
    if not gated:
        ApexDriver._gated = lambda self, query: query
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = train.main([*CONFIGS[config], "--total-env-frames",
                             str(frames), "--wall-clock-limit", str(wall),
                             "--device", "cuda"])
    finally:
        SingleChipLearner.train_many, ApexDriver._gated = orig_tm, orig_gate
        SingleChipLearner.capture = orig_capture
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    ms = sorted(calls)
    return {"config": config, "label": label, "rc": rc,
            "wall_s": time.perf_counter() - t0,
            "train_many_calls": len(calls),
            "train_many_s_median": ms[len(ms) // 2] if ms else None,
            "train_many_s": calls, "grad_steps": out["grad_steps"],
            "grad_steps_per_s_window": (out["grad_steps"]
                                        / (window[1] - window[0])
                                        if window else None),
            "frames_in_replay": out["frames"],
            "ingest_dropped": out["ingest_dropped"],
            "server": out["server"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="pong", choices=sorted(CONFIGS))
    ap.add_argument("--frames", type=int, default=60_000)
    ap.add_argument("--wall", type=float, default=180.0)
    ap.add_argument("--arms", default="graph,eager",
                    help="comma-separated, of: " + ", ".join(ARMS))
    args = ap.parse_args()
    arms = args.arms.split(",")
    unknown = set(arms) - set(ARMS)
    if unknown:
        ap.error(f"unknown arms {sorted(unknown)}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    for label in arms:
        print(json.dumps(run_once(args.config, label, args.frames,
                                  args.wall)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
