"""Run one cell of the port's benchmark once, on the cards of this
machine, and print its result as the last line of standard output.

    python3 -m apex_bench.run --workload pong-learn --seed 7 \\
        --seconds 20 --trace 0

Run from the root of a checkout. Exits 2 without a card (or with fewer
than the cell asks for), 3 if JAX or the JAX package was loaded, and
non-zero on any other error, printing no result in each case. The
numbers compared with the reference close standard error and the
result line (its ``checks``), each beside its limit.
"""

from __future__ import annotations

import os
import time
from pathlib import Path


def _process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            boot = next(int(ln.split()[1]) for ln in fh
                        if ln.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


T_START = _process_start()
CHECKOUT = Path(__file__).resolve().parent.parent
# every compiler cache at a fixed place inside the checkout (the gather
# kernel's nvcc build already lives in ape_x_dqn_tpu_torch/_build/)
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(CHECKOUT / "apex_bench" / "_cache" / _sub)
os.environ.setdefault("USE_FLAX", "0")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m apex_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from apex_bench import harness

    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), T_START, CHECKOUT)
    except harness.NoCard as e:
        print(f"apex_bench: no card for this cell: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"apex_bench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, v in result["checks"].items():
        print(f"check {name}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
