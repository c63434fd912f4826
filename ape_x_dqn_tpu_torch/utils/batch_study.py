"""Batch-size / MFU scaling study of the learner on the card: grad-steps/s,
samples/s and MFU at batch 512/1024/2048 with a constant replay
capacity, in interleaved A-B-C-C-B-A order so the machine's drift
cancels.

Counterpart of ``ape_x_dqn_tpu/utils/batch_study.py``, with the port's
own means: the `pong` preset's frame-ring learner (the dueling
Nature CNN at full width over `FrameRingReplay`) built by
runtime/build.py, prefilled through `add_many`, its `train_many`
dispatches replaying captured CUDA graphs on the card
(runtime/step_graph.py) after one untimed dispatch (the eager warm-up
and the captures). FLOPs per step are the analytic count of
obs/profiling.py (`train_step_flops_analytic`), and the default peak is
the card's own dense bf16 peak (obs/profiling.py: `device_peaks`; the
original's 197 TFLOP/s is a TPU v5e's).

Usage:
    python -m ape_x_dqn_tpu_torch.utils.batch_study [--capacity 1048576]
    python -m ape_x_dqn_tpu_torch.utils.batch_study --device cpu \\
        --capacity 4096 --batches 32,64 --steps-per-dispatch 2 \\
        --dispatches 1

Prints one JSON line per measurement on stdout (the original's keys)
and a summary table on stderr. Rates are host-clock grad-steps/s over
`dispatches` dispatches, three times; the median is reported with the
spread.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time

import numpy as np
import torch

from ape_x_dqn_tpu_torch.configs import get_config
from ape_x_dqn_tpu_torch.envs.base import EnvSpec
from ape_x_dqn_tpu_torch.obs.profiling import (device_peaks,
                                               train_step_flops_analytic)
from ape_x_dqn_tpu_torch.runtime.build import build_learner
from ape_x_dqn_tpu_torch.utils.hbm import check_hbm_fits
from ape_x_dqn_tpu_torch.utils.misc import resolve_device

# the flagship net's observation and action set (the original's bench)
SPEC = EnvSpec(obs_shape=(84, 84, 4), obs_dtype=np.dtype(np.uint8),
               discrete=True, num_actions=18)
PREFILL = 1 << 15        # transitions in the replay before timing
REPEATS = 3              # timed sub-runs per measurement
SEGMENTS_PER_ADD = 256   # staged segments per add of the prefill


def build(batch_size: int, capacity: int, sample_chunk: int,
          device: torch.device):
    """The pong frame-ring learner at `batch_size` over a `capacity`
    ring, after the budget check. -> (learner, state)."""
    cfg = get_config("pong")
    cfg = cfg.replace(
        replay=dataclasses.replace(cfg.replay, capacity=capacity),
        learner=dataclasses.replace(cfg.learner, batch_size=batch_size,
                                    sample_chunk=sample_chunk))
    check_hbm_fits(cfg, SPEC.obs_shape, SPEC.obs_dtype,
                   param_count=1_700_000, device=device)
    return build_learner(cfg, SPEC, device=device)


def prefill(learner, state, n_items: int, rng):
    """`n_items` transitions (whole segments) into the ring through
    `add_many`: one block of synthetic segments made once on the host
    and landed again per add."""
    replay = learner.replay
    b, f = replay.B, replay.F
    g = max(min(SEGMENTS_PER_ADD, n_items // b), 1)
    shape = (1, g, b)
    items = {
        "seg_frames": torch.from_numpy(rng.integers(
            0, 255, (1, g, f, *SPEC.obs_shape[:2]), dtype=np.uint8)),
        "action": torch.from_numpy(
            rng.integers(0, SPEC.num_actions, shape).astype(np.int32)),
        "reward": torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)),
        "discount": torch.full(shape, 0.99 ** 3),
        "next_off": torch.full(shape, 3, dtype=torch.int32),
    }
    td = torch.from_numpy(rng.uniform(0.1, 2.0, shape).astype(np.float32))
    for _ in range(max(n_items // (g * b), 1)):
        state = learner.add_many(state, items, td)
    return state


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_learner(learner, state, steps: int, dispatches: int,
                 device: torch.device) -> tuple[list[float], object]:
    """One untimed `train_many` dispatch (the eager warm-up and the
    captures on the card), then REPEATS timed runs of `dispatches`
    dispatches of `steps` grad-steps. -> (grad-steps/s per run,
    state)."""
    state, m = learner.train_many(state, steps)
    float(m["loss"])
    rates = []
    for _ in range(REPEATS):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(dispatches):
            state, m = learner.train_many(state, steps)
        loss = float(m["loss"])
        rates.append(steps * dispatches / (time.perf_counter() - t0))
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss in steady state: {loss}")
    return rates, state


def measure_one(batch_size: int, capacity: int, steps: int,
                dispatches: int, sample_chunk: int, peak_tflops: float,
                device: torch.device, seed: int = 0) -> dict:
    """One batch size's measurement (the original's keys)."""
    learner, state = build(batch_size, capacity, sample_chunk, device)
    state = prefill(learner, state, min(PREFILL, capacity),
                    np.random.default_rng(seed))
    rates, state = time_learner(learner, state, steps, dispatches, device)
    del state, learner
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    gsps = float(np.median(rates))
    flops = train_step_flops_analytic(batch_size)
    return {
        "batch_size": batch_size,
        "grad_steps_per_s": round(gsps, 1),
        "spread": [round(float(np.min(rates)), 1),
                   round(float(np.max(rates)), 1)],
        "samples_per_s": round(gsps * batch_size),
        "achieved_tflops": round(gsps * flops / 1e12, 2),
        "mfu": round(gsps * flops / 1e12 / peak_tflops, 4),
    }


def interleaved(batches: list[int]) -> list[int]:
    """A-B-C-C-B-A: each batch size twice, mirrored, so a drift of the
    machine over the study weighs on every size alike."""
    return batches + batches[::-1]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ape_x_dqn_tpu_torch.utils.batch_study",
        description="Batch-size / MFU study of the pong learner.")
    p.add_argument("--capacity", type=int, default=1 << 20)
    p.add_argument("--batches", default="512,1024,2048")
    p.add_argument("--steps-per-dispatch", type=int, default=50)
    p.add_argument("--dispatches", type=int, default=8)
    p.add_argument("--sample-chunk", type=int, default=4)
    p.add_argument("--peak-tflops", type=float, default=None,
                   help="peak dense bf16 TFLOP/s of the device (default: "
                        "the card's own, obs/profiling.py; a CPU proxy "
                        "on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; a CUDA request "
                        "without a card raises)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    peak = (args.peak_tflops if args.peak_tflops is not None
            else device_peaks(device)[0] / 1e12)
    batches = [int(b) for b in args.batches.split(",")]
    runs: dict[int, list[dict]] = {b: [] for b in batches}
    order = interleaved(batches)
    for i, b in enumerate(order):
        t0 = time.monotonic()
        r = measure_one(b, args.capacity, args.steps_per_dispatch,
                        args.dispatches, args.sample_chunk, peak, device)
        r["order_pos"] = i
        runs[b].append(r)
        print(json.dumps(r), flush=True)
        print(f"[{i + 1}/{len(order)}] batch {b}: "
              f"{r['grad_steps_per_s']} steps/s, mfu {r['mfu']:.1%} "
              f"({time.monotonic() - t0:.0f}s)", file=sys.stderr,
              flush=True)
    print("batch  steps/s(two runs)  samples/s  MFU", file=sys.stderr)
    for b in batches:
        two = runs[b]
        print(f"{b:5}  {[r['grad_steps_per_s'] for r in two]}  "
              f"{[r['samples_per_s'] for r in two]}  "
              f"{[r['mfu'] for r in two]}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
