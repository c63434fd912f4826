"""How the actor threads slow the eager learner inside the Ape-X driver.

Runs the driver at the `pong` preset through the default CLI mode on
the card, once per arm:

- "gated": the driver as shipped, where actor queries wait while the
  learner dispatches (runtime/driver.py: ApexDriver._gated);
- "ungated": the same with that wait removed, so 8 actor threads keep
  the interpreter busy while the learner issues its thousands of torch
  calls per macro-step;
- "uncapped": the driver as shipped with `learner.steps_per_frame_cap`
  cleared, so the learner trains as fast as it can beside the actors.

For each run it prints one JSON line: the seconds of every train_many
call (host clock, the device synchronised after each), the grad-steps
and their rate over the training window (first train_many call to the
end of the last), the env frames that reached replay, the transport's
drops and the wall seconds. Usage, from the repository root on a
machine with a card:

    python -m ape_x_dqn_tpu_torch.tools.driver_contention \\
        [--frames 60000] [--wall 180] [--arms gated,ungated,uncapped]
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
from ape_x_dqn_tpu_torch.runtime.learner import DQNLearner


ARMS = {"gated": (True, []), "ungated": (False, []),
        "uncapped": (True, ["--set", "learner.steps_per_frame_cap=None"])}


def run_once(label: str, frames: int, wall: float) -> dict:
    gated, extra = ARMS[label]
    calls: list[float] = []
    window: list[float] = []
    orig_tm, orig_gate = DQNLearner.train_many, ApexDriver._gated

    def train_many(self, state, n, noise=None):
        t0 = time.perf_counter()
        out = orig_tm(self, state, n, noise)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        calls.append(t1 - t0)
        window[:] = [window[0] if window else t0, t1]
        return out

    DQNLearner.train_many = train_many
    if not gated:
        ApexDriver._gated = lambda self, query: query
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = train.main(["--config", "pong", "--total-env-frames",
                             str(frames), "--wall-clock-limit", str(wall),
                             "--device", "cuda", *extra])
    finally:
        DQNLearner.train_many, ApexDriver._gated = orig_tm, orig_gate
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    ms = sorted(calls)
    return {"label": label, "rc": rc, "wall_s": time.perf_counter() - t0,
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
    ap.add_argument("--frames", type=int, default=60_000)
    ap.add_argument("--wall", type=float, default=180.0)
    ap.add_argument("--arms", default="gated,ungated,uncapped",
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
        print(json.dumps(run_once(label, args.frames, args.wall)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
