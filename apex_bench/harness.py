"""One run of one cell: set-up, the measured window, the traced
stretch, the check against the reference, the result line.

The harness knows no cell, configuration, traffic or metric by name: it
reads ``BENCHMARK.json`` and the files named after them (see the
package docstring), so a new cell, configuration, traffic or per-layer
metric is new files plus entries in the manifest.

It times set-up (``setup_s``, from the process's start to the first
timed call) around the adaptor's ``set_up``; the adaptor's ``window``
measures the cell's other end-to-end metrics and its ``traced`` gives
the profiled stretch (``apex_bench/adaptors/base.py`` says what an
adaptor provides). The per-layer metrics are read from the window's
spans, its end-to-end numbers and the profiled stretch. After that the
program is freed, the reference module the adaptor names follows the
seed's inputs, and its ``compare`` with the limits of the cell's
workload file decides ``correct``.
"""

from __future__ import annotations

import collections
import gc
import importlib
import json
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from apex_bench.trace import DeviceTrace, Spans, sync, union_busy_us

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ape_x_dqn_tpu")


class NoCard(RuntimeError):
    """The cell asks for more cards than this machine shows."""


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def manifest(checkout: Path) -> dict:
    return load_json(checkout / "BENCHMARK.json")


def cell_files(name: str) -> tuple[dict, dict]:
    """(workload file, configuration file) of cell `name`."""
    traffic = load_json(ROOT / "workloads" / f"{name}.json")
    conf = load_json(ROOT / "configs" / f"{traffic['config']}.json")
    return traffic, conf


def metrics_of(bench: dict, cell: str, kind: str) -> list[dict]:
    """The manifest's `kind` metrics ("end_to_end", "per_layer") that
    cell `cell` reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


@dataclass
class Context:
    """What the per-layer readers read (apex_bench/metrics/): the
    window's spans ({name: [seconds]}), the profiled stretch, the run's
    end-to-end numbers ({metric: value}), the configuration file, its
    counts module (``apex_bench/costs/<config>.py``), the frozen peaks
    and the indices of the cards the cell uses."""
    spans: dict
    trace: DeviceTrace | None
    e2e: dict
    conf: dict
    costs: object
    peaks: dict
    device_indices: list


def check_cards(chips: int) -> list[torch.device]:
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    n = torch.cuda.device_count()
    if n < chips:
        raise NoCard(f"the cell needs {chips} cards, {n} visible")
    return [torch.device("cuda", i) for i in range(chips)]


def breakdown(trace: DeviceTrace, device_index: int) -> dict:
    """The ten device operations that took most time, and the ten
    longest idle gaps on the first card, each named by the benchmark's
    host span it falls in (or "other")."""
    total = collections.Counter()
    for name, s, e, _ in trace.ops:
        total[name] += (e - s) / 1e6
    _, gaps = union_busy_us([(s, e) for _, s, e, d in trace.ops
                             if d == device_index])
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        owner = "other"
        for name, hs, he in trace.host:
            if hs <= s < he:
                owner = name
                break
        named.append([f"{owner} at +{(s - trace.ops[0][1]) / 1e3:.3f} ms",
                      (e - s) / 1e6])
    return {"device_ops": [[n, v] for n, v in total.most_common(10)],
            "idle_gaps": named}


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().replace("\n", "; ") or None


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def verdict(gaps: dict, limits: dict, names) -> tuple[bool, dict]:
    """-> (every number the cell holds finite and within its limit,
    {name: {"value", "limit"}} of those numbers), `names` the numbers
    the reference module's ``compare`` reads."""
    unknown = set(limits) - set(names)
    if unknown:
        raise KeyError(f"limits for numbers the check does not read: "
                       f"{sorted(unknown)}")
    shown = {n: {"value": gaps[n], "limit": limits[n]}
             for n in names if n in limits}
    ok = all(v["value"] == v["value"] and v["value"] <= v["limit"]
             for v in shown.values())
    return ok, shown


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, checkout: Path, devices=None,
        traffic: dict | None = None, conf: dict | None = None,
        patch=None) -> dict:
    """One run. `devices`, `traffic`, `conf` and `patch` (a callable on
    the built program, which may break it) are for the tests, which
    drive the rest of a run on the CPU; the command line leaves them
    None and runs on the cards. -> the result object."""
    bench = manifest(checkout)
    if devices is None:
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        devices = check_cards(cells[workload]["chips"])
    file_traffic, file_conf = cell_files(workload)
    traffic = traffic or file_traffic
    conf = conf or file_conf
    adaptor = importlib.import_module(
        f"apex_bench.adaptors.{conf['adaptor']}")
    reference = importlib.import_module(
        f"apex_bench.reference.{adaptor.REFERENCE}")
    costs = importlib.import_module(f"apex_bench.costs.{conf['name']}")
    peaks = load_json(ROOT / "costs" / "peaks.json")

    marks = {"start": time.time() - t_start}

    def mark(name: str) -> None:
        marks[name] = time.time() - t_start

    prog = adaptor.Program(conf, traffic, seed, devices)
    if patch is not None:
        patch(prog)
    mark("built")
    prog.set_up(mark)
    sync(devices)
    setup_s = time.time() - t_start

    spans = Spans()
    win = prog.window(seconds, spans)
    dev_trace = prog.traced() if trace else None
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices
                if d.type == "cuda"), default=0)
    readings = prog.readings
    prog.close()
    del prog
    gc.collect()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()

    ref = reference.follow(conf, traffic, seed, devices[0])
    gaps = reference.compare(readings, ref)
    correct, shown = verdict(gaps, traffic["limits"], reference.NAMES)

    e2e = dict(win["metrics"], setup_s=setup_s)
    out_metrics = {}
    if trace:
        ctx = Context(spans=spans.seconds, trace=dev_trace, e2e=e2e,
                      conf=conf, costs=costs, peaks=peaks,
                      device_indices=[d.index for d in devices])
        for m in metrics_of(bench, workload, "per_layer"):
            reader = importlib.import_module(
                f"apex_bench.metrics.{m['name']}")
            v = reader.read(ctx)
            if v is not None:
                out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in metrics_of(bench, workload, "end_to_end"):
            if m["name"] not in e2e:
                raise KeyError(f"the window of {workload!r} measures no "
                               f"{m['name']!r}")
            out_metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    cuda = devices[0].type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": (torch.cuda.get_device_name(devices[0]) if cuda
                       else "cpu"),
              "count": len(devices), "memory_peak_bytes": int(peak)}
    if cuda:
        device["power_limit"] = power_limit()
    result = {"correct": correct, "attempted": win["attempted"],
              "failed": win["failed"], "metrics": out_metrics,
              "device": device}
    if trace:
        busy = [union_busy_us([(s, e) for _, s, e, d in dev_trace.ops
                               if d == dv.index])[0] / 1e6
                for dv in devices]
        device["busy_s"] = statistics.fmean(busy)
        device["window_s"] = dev_trace.window_s
        if dev_trace.ops:
            result["breakdown"] = breakdown(dev_trace, devices[0].index)
    result["detail"] = {"setup_marks_s": marks, **win["detail"],
                        "gaps": gaps}
    result["checks"] = shown
    return result
