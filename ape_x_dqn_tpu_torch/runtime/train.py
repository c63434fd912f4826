"""CLI entry point: train a preset from a shell.

Counterpart of ``ape_x_dqn_tpu/runtime/train.py``. One CLI selects a
preset and overrides any field:

    python -m ape_x_dqn_tpu_torch.runtime.train --config pong  # on cuda
    python -m ape_x_dqn_tpu_torch.runtime.train --config cartpole_smoke \\
        --device cpu --total-env-frames 1200 --max-grad-steps 50 \\
        --wall-clock-limit 120
    python -m ape_x_dqn_tpu_torch.runtime.train --config cartpole_smoke \\
        --single-process --device cpu
    python -m ape_x_dqn_tpu_torch.runtime.train --config pong --actors 0 \\
        --listen 127.0.0.1:0 --checkpoint-dir runs/ckpt  # + actor hosts
    python -m ape_x_dqn_tpu_torch.runtime.train --config pong \\
        --eval-only --checkpoint-dir runs/ckpt --games Pong,Breakout
    python -m ape_x_dqn_tpu_torch.runtime.train --config cartpole_smoke \\
        --device cpu --set parallel.dp=8 --set replay.kind=prioritized \\
        --coordinator 127.0.0.1:29500 \\
        --num-processes 2 --process-id 0   # and --process-id 1

The default mode runs the threaded Ape-X driver (`ApexDriver`: actors,
the batched inference server, ingest staging and the learner);
`--single-process` runs `train_single_process`. Either prints one
summary JSON line on stdout when the run ends; the driver's carries
`actor_errors` and `loop_errors` as strings, and the CLI exits 1 when
either is non-empty. `--listen HOST:PORT` also accepts remote actor
hosts (runtime/actor_host.py) and prints the bound port on stderr (port
0 picks a free one); `--checkpoint-dir` saves and resumes the train
state; `--eval-only` restores the newest checkpoint's params and prints
one JSON line of greedy scores (the suite's median HNS for Atari
configs, over `--games`). `--profile-dir` captures a torch.profiler
trace of `profile_steps` grad-steps. `--device` (default cuda) is the
device it runs on. `--coordinator HOST:PORT --num-processes N
--process-id I` runs one process of the multi-host learner
(runtime/multihost_driver.py): every process joins one process group at
HOST:PORT (parallel/multihost.py) before anything is built on the
device, owns dp / N of the replay shards and trains in lockstep. On
the card the group carries CPU tensors over gloo and CUDA tensors over
NCCL; rank r takes card r % the visible cards. When every rank is alone
on its card (one rank per card), the gradient exchange is NCCL on the
device, inside each macro-step's graph; ranks that share a card (more
ranks than cards), and `--device cpu`, exchange over gloo through the
host. The summary's `multihost.backend` says which; an NCCL that is
missing or fails with one rank per card raises, with no fallback to
gloo. `--compilation-cache-dir` exits 2: the port
compiles nothing at run time. `--single-process` refuses `--listen` and
`--checkpoint-dir` (exit 2), which the one-process trainer has no use
for.
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
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save the train state here every "
                         "checkpoint_every grad-steps and at the end, and "
                         "resume from the newest checkpoint it holds")
    ap.add_argument("--eval-only", action="store_true",
                    help="no training: restore the newest checkpoint and "
                         "run greedy eval (the HNS suite for Atari "
                         "configs); prints one JSON line")
    ap.add_argument("--games", default=None, metavar="G1,G2,...",
                    help="with --eval-only: comma-separated ALE games "
                         "(default: all 57)")
    ap.add_argument("--param-wire-dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="dtype for float params on the wire with "
                         "--listen: bf16 halves the broadcast bytes "
                         "(receivers upcast; values carry bf16 rounding "
                         "only); float32 is bit-exact")
    ap.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="also accept remote actor hosts over TCP (port "
                         "0: a free one, printed on stderr)")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace (host and "
                         "device activity) of profile_steps grad-steps "
                         "into this directory")
    # multi-host learner (one process per host or card, in lockstep
    # over one process group: runtime/multihost_driver.py); all three
    # must be set
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="the process group's rendezvous address "
                         "(tcp://HOST:PORT)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    # accepted so that a request for it fails loudly
    ap.add_argument("--compilation-cache-dir", default=None, metavar="DIR")
    ap.add_argument("--set", action="append", default=[],
                    metavar="dotted.key=value",
                    help="override any config field, e.g. "
                         "learner.batch_size=256 (repeatable)")
    return ap


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.coordinator is not None:
        if args.num_processes is None or args.process_id is None:
            parser.error("--coordinator requires --num-processes and "
                         "--process-id")
        if args.wall_clock_limit is not None:
            # wall clocks differ across hosts (they would diverge the
            # lockstep call sequences): reject rather than ignore
            parser.error("--wall-clock-limit is not supported in "
                         "multihost mode (host clocks differ; use "
                         "--max-grad-steps / --total-env-frames)")
        if args.single_process:
            parser.error("--single-process and --coordinator conflict")
        if args.eval_only:
            parser.error("--eval-only is single-process (no learner "
                         "mesh); drop --coordinator")
    if args.compilation_cache_dir is not None:
        print("--compilation-cache-dir does not apply to the PyTorch "
              "package: nothing is jit-compiled (the CUDA graphs are "
              "captured in each process, and the kernels are built once "
              "into ape_x_dqn_tpu_torch/_build/)", file=sys.stderr)
        return 2
    if args.single_process:
        for flag, value in (("--listen", args.listen),
                            ("--checkpoint-dir", args.checkpoint_dir)):
            if value is not None:
                print(f"{flag} is not supported with --single-process: "
                      f"the one-process trainer takes no remote actor "
                      f"hosts and saves no checkpoints (ROADMAP Queue C); "
                      f"run the driver (drop --single-process)",
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
    if args.checkpoint_dir is not None:
        cfg = cfg.replace(checkpoint_dir=args.checkpoint_dir)
    if args.profile_dir is not None:
        cfg = cfg.replace(profile_dir=args.profile_dir)
    cfg = apply_overrides(cfg, args.set)

    if args.eval_only:
        from ape_x_dqn_tpu_torch.runtime.evaluation import run_suite_eval
        out = run_suite_eval(
            cfg, games=args.games.split(",") if args.games else None,
            checkpoint_dir=args.checkpoint_dir or cfg.checkpoint_dir
            or None, device=args.device)
        print(json.dumps(out))
        return 0

    if args.coordinator is not None:
        # before anything is built on the device
        from ape_x_dqn_tpu_torch.parallel.multihost import init_multihost
        init_multihost(args.coordinator, args.num_processes,
                       args.process_id, device=args.device)
    metrics = Metrics(log_path=args.metrics_file,
                      tensorboard_dir=args.tensorboard_dir)
    server = driver = None
    try:
        if args.listen and not args.single_process:
            from ape_x_dqn_tpu_torch.comm.socket_transport import (
                SocketIngestServer)
            host, port = args.listen.rsplit(":", 1)
            comm = cfg.comm
            server = SocketIngestServer(
                host, int(port), param_wire_dtype=args.param_wire_dtype,
                wire_codec=comm.wire_codec, param_codec=comm.param_codec,
                param_delta_window=comm.param_delta_window, shm=comm.shm,
                shm_slots=comm.shm_slots,
                shm_slot_bytes=comm.shm_slot_bytes,
                shm_param_bytes=comm.shm_param_bytes)
            print(f"ingest listening on {host}:{server.port}",
                  file=sys.stderr, flush=True)
        if args.coordinator is not None:
            from ape_x_dqn_tpu_torch.runtime.multihost_driver import (
                MultihostApexDriver)
            driver = MultihostApexDriver(cfg, metrics=metrics,
                                         transport=server,
                                         device=args.device)
            out = driver.run(max_grad_steps=args.max_grad_steps)
        elif args.single_process:
            from ape_x_dqn_tpu_torch.runtime.single_process import (
                train_single_process)
            out = train_single_process(cfg, metrics=metrics,
                                       device=args.device)
        else:
            from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
            driver = ApexDriver(cfg, metrics=metrics, transport=server,
                                device=args.device)
            if driver.cards:
                # the layout of a mesh over several cards, beside the
                # summary's mesh block (stdout stays one JSON line)
                lay = driver.learner.layout()
                print(f"mesh: dp={cfg.parallel.dp} x tp={cfg.parallel.tp} "
                      f"over cards {lay['cards']}; rows per card "
                      f"{lay['rows_per_card']}; tp partners "
                      f"{lay['tp_partners']}; tp splits "
                      f"{lay['split_layers'] or 'no layer'}",
                      file=sys.stderr, flush=True)
            out = dict(driver.run(max_grad_steps=args.max_grad_steps,
                                  wall_clock_limit_s=args.wall_clock_limit))
            # the summary stays one parseable JSON line
            out["actor_errors"] = [f"{i}: {e!r}"
                                   for i, e in out["actor_errors"]]
            out["loop_errors"] = [f"{which}: {e!r}"
                                  for which, e in out["loop_errors"]]
    finally:
        if server is not None:
            server.stop()
        metrics.close()
        if args.coordinator is not None:
            import torch.distributed as dist
            if driver is not None:   # a MultihostApexDriver
                # its graphs first: NCCL destroys no communicator that a
                # live CUDA graph's collective holds
                driver.close()
            if dist.is_initialized():
                dist.destroy_process_group()
    print(json.dumps(out))
    failed = bool(out.get("actor_errors") or out.get("loop_errors"))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
