"""Readings for the limits of ``correct``, on the card at a cell's own
size: the program's sound runs over many seeds, the control (the
reference computed in fp8, put in the program's place) and the planted
faults (the reference with half of each batch left out, or with the
written-back |TD| altered), each against the float32 reference.

    python3 -m apex_bench.calibrate --workload pong-learn \\
        --seeds 101,102,103 [--program 1] [--control 1] \\
        [--faults no_exchange,...]

`--faults` plants faults of ``faults.py`` in the program itself (the
exchange between cards left out, say) and reads it the same way. One
JSON line per seed and side on standard output. A state left unchanged
reads 1 on ``adam_mu`` and ``update`` by construction and is not run.
The readings need no measured window, so the set-up's settle is
skipped. PERF.md gives the readings each limit was set from.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time

import torch

from apex_bench import faults, harness

FAULTS = ("half_batch", "altered")


def program_readings(name: str, seed: int, devices, patch=None) -> dict:
    traffic, conf = harness.cell_files(name)
    traffic = dict(traffic, settle_s=0)
    adaptor = importlib.import_module(
        f"apex_bench.adaptors.{conf['adaptor']}")
    prog = adaptor.Program(conf, traffic, seed, devices)
    if patch is not None:
        patch(prog)
    prog.set_up(lambda name: None)
    readings = prog.readings
    prog.close()
    del prog
    gc.collect()
    for d in devices:
        torch.cuda.synchronize(d)
    torch.cuda.empty_cache()
    return readings


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m apex_bench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", type=int, default=1)
    p.add_argument("--control", type=int, default=1)
    p.add_argument("--faults", default="")
    args = p.parse_args(argv)
    traffic, conf = harness.cell_files(args.workload)
    devices = harness.check_cards(traffic["chips"])
    adaptor = importlib.import_module(
        f"apex_bench.adaptors.{conf['adaptor']}")
    reference = importlib.import_module(
        f"apex_bench.reference.{adaptor.REFERENCE}")
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        readings = (program_readings(args.workload, seed, devices)
                    if args.program else None)
        ref = reference.follow(conf, traffic, seed, devices[0])
        rows = []
        if readings is not None:
            rows.append(("program", reference.compare(readings, ref)))
        if args.control:
            ctrl = reference.follow(conf, traffic, seed, devices[0],
                                    precision="fp8")
            rows.append(("control_fp8", reference.compare(
                reference.as_readings(ctrl), ref)))
            for fault in FAULTS:
                rows.append((fault, reference.compare(reference.as_readings(
                    reference.follow(conf, traffic, seed, devices[0],
                                     fault=fault)), ref)))
        for name in filter(None, args.faults.split(",")):
            rows.append((f"program_{name}", reference.compare(
                program_readings(args.workload, seed, devices,
                                 faults.FAULTS[name]), ref)))
        for side, gaps in rows:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, **gaps}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
