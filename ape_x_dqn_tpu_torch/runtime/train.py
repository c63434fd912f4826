"""CLI entry point: train a preset from a shell.

Counterpart of ``ape_x_dqn_tpu/runtime/train.py``. One CLI selects a
preset and overrides any field:

    python -m ape_x_dqn_tpu_torch.runtime.train --config pong  # on cuda
    python -m ape_x_dqn_tpu_torch.runtime.train --config cartpole_smoke \\
        --device cpu --total-env-frames 1200 --max-grad-steps 50 \\
        --wall-clock-limit 120
    python -m ape_x_dqn_tpu_torch.runtime.train --config cartpole_smoke \\
        --single-process --device cpu

The default mode runs the threaded Ape-X driver (`ApexDriver`: actors,
the batched inference server, ingest staging and the learner);
`--single-process` runs `train_single_process`. Either prints one
summary JSON line on stdout when the run ends; the driver's carries
`actor_errors` and `loop_errors` as strings, and the CLI exits 1 when
either is non-empty. `--device` (default cuda) is the device it runs
on. The original's other modes are not ported yet; each exits 2 naming
the ROADMAP Queue A item it waits for, rather than running without what
it asked for.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import sys
from typing import Any

from ape_x_dqn_tpu_torch.configs import PRESETS, RunConfig, get_config
from ape_x_dqn_tpu_torch.utils.metrics import Metrics


def _coerce(value: str, ref: Any) -> Any:
    """Parse a CLI string against the type of the value it replaces."""
    if value.lower() in ("none", "null"):
        return None  # optional fields can be cleared from the CLI
    if isinstance(ref, bool):  # before int: bool is an int subclass
        if value.lower() in ("1", "true", "yes", "on"):
            return True
        if value.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"not a bool: {value!r}")
    if isinstance(ref, int):
        return int(value)
    if isinstance(ref, float):
        return float(value)
    if isinstance(ref, tuple):
        parsed = ast.literal_eval(value)
        return tuple(parsed) if isinstance(parsed, (list, tuple)) \
            else (parsed,)
    if ref is None:
        # the current value carries no type (`float | None` fields such
        # as learner.steps_per_frame_cap): parse the literal itself
        try:
            return ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return value
    return value  # str fields


def _set_dotted(cfg: Any, path: list[str], value: str) -> Any:
    field_names = {f.name for f in dataclasses.fields(cfg)}
    head = path[0]
    if head not in field_names:
        raise KeyError(
            f"unknown config field {head!r}; known: {sorted(field_names)}")
    current = getattr(cfg, head)
    if len(path) == 1:
        return dataclasses.replace(cfg, **{head: _coerce(value, current)})
    return dataclasses.replace(
        cfg, **{head: _set_dotted(current, path[1:], value)})


def apply_overrides(cfg: RunConfig, sets: list[str]) -> RunConfig:
    """Apply 'dotted.path=value' overrides onto a (frozen) RunConfig."""
    for item in sets:
        if "=" not in item:
            raise ValueError(f"--set expects key=value, got {item!r}")
        key, value = item.split("=", 1)
        cfg = _set_dotted(cfg, key.split("."), value)
    return cfg


# the original's modes and options that have no port yet:
# (argparse dest, what it asks for, the ROADMAP Queue A item it waits for)
_NOT_PORTED = (
    ("listen", "--listen (remote actor hosts over TCP)", 11),
    ("coordinator", "--coordinator (the multi-host learner)", 14),
    ("num_processes", "--num-processes (the multi-host learner)", 14),
    ("process_id", "--process-id (the multi-host learner)", 14),
    ("eval_only", "--eval-only (greedy suite evaluation from a "
                  "checkpoint)", 11),
    ("games", "--games (greedy suite evaluation from a checkpoint)", 11),
    ("checkpoint_dir", "--checkpoint-dir (utils/checkpoint.py)", 11),
    ("profile_dir", "--profile-dir (the profiler capture)", 17),
    ("compilation_cache_dir", "--compilation-cache-dir", 17),
    ("param_wire_dtype", "--param-wire-dtype (the param broadcast)", 11),
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m ape_x_dqn_tpu_torch.runtime.train",
        description="Train an Ape-X config with the PyTorch package.")
    ap.add_argument("--config", required=True, choices=sorted(PRESETS),
                    help="preset name")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--actors", type=int, default=None,
                    help="override actors.num_actors")
    ap.add_argument("--total-env-frames", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; a CUDA "
                         "request without a card raises)")
    ap.add_argument("--metrics-file", default=None,
                    help="JSONL metrics sink")
    ap.add_argument("--tensorboard-dir", default=None,
                    help="also write TensorBoard event files here "
                         "(JSONL stays canonical)")
    ap.add_argument("--single-process", action="store_true",
                    help="config-1 style in-process loop (no threads)")
    ap.add_argument("--max-grad-steps", type=int, default=10**9,
                    help="stop the driver at this many grad-steps")
    ap.add_argument("--wall-clock-limit", type=float, default=None,
                    metavar="SECONDS",
                    help="stop the driver after this many seconds")
    # not ported yet: accepted so that a request for them fails loudly
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--profile-dir", default=None)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--games", default=None, metavar="G1,G2,...")
    ap.add_argument("--param-wire-dtype", default=None,
                    choices=("bfloat16", "float32"))
    ap.add_argument("--listen", default=None, metavar="HOST:PORT")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--compilation-cache-dir", default=None, metavar="DIR")
    ap.add_argument("--set", action="append", default=[],
                    metavar="dotted.key=value",
                    help="override any config field, e.g. "
                         "learner.batch_size=256 (repeatable)")
    return ap


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for dest, what, item in _NOT_PORTED:
        if getattr(args, dest) not in (None, False):
            print(f"{what} is not ported to the PyTorch package yet: it "
                  f"waits for ROADMAP Queue A item {item}",
                  file=sys.stderr)
            return 2
    cfg = get_config(args.config)
    if args.seed is not None:
        cfg = cfg.replace(seed=args.seed)
    if args.actors is not None:
        cfg = cfg.replace(
            actors=dataclasses.replace(cfg.actors, num_actors=args.actors))
    if args.total_env_frames is not None:
        cfg = cfg.replace(total_env_frames=args.total_env_frames)
    cfg = apply_overrides(cfg, args.set)

    metrics = Metrics(log_path=args.metrics_file,
                      tensorboard_dir=args.tensorboard_dir)
    try:
        if args.single_process:
            from ape_x_dqn_tpu_torch.runtime.single_process import (
                train_single_process)
            out = train_single_process(cfg, metrics=metrics,
                                       device=args.device)
        else:
            from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
            driver = ApexDriver(cfg, metrics=metrics, device=args.device)
            out = dict(driver.run(max_grad_steps=args.max_grad_steps,
                                  wall_clock_limit_s=args.wall_clock_limit))
            # the summary stays one parseable JSON line
            out["actor_errors"] = [f"{i}: {e!r}"
                                   for i, e in out["actor_errors"]]
            out["loop_errors"] = [f"{which}: {e!r}"
                                  for which, e in out["loop_errors"]]
    finally:
        metrics.close()
    print(json.dumps(out))
    failed = bool(out.get("actor_errors") or out.get("loop_errors"))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
