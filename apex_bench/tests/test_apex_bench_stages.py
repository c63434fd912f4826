"""The stage reader (``apex_bench/stages.py``) and the seven per-stage
readers on synthetic device traces: each operation goes to the stage of
the last marker before it on its card, the stages, ``untagged`` and
``marks`` add up to the summed operation time exactly, and a trace with
no marker gives None."""

from __future__ import annotations

import importlib
import random

import pytest

from apex_bench.harness import Context
from apex_bench.stages import stage_seconds
from apex_bench.trace import DeviceTrace

STAGE_METRICS = ["sample_ms", "gather_ms", "loss_ms", "backward_ms",
                 "optimizer_ms", "diag_ms", "writeback_ms"]


def mark(stage, t, dev=0):
    return (f"apex_stage_{stage}", t, t + 1.0, dev)


def ctx(ops, macro_steps=2, devices=(0,)):
    trace = DeviceTrace(ops=ops, host=[], window_s=0.01,
                        counts={"macro_steps": macro_steps})
    return Context(spans={}, trace=trace, e2e={}, conf={}, costs=None,
                   peaks={}, device_indices=list(devices))


def read(name, c):
    return importlib.import_module(f"apex_bench.metrics.{name}").read(c)


# one macro-step on card 0 (times in us): the noise draw before the
# first marker, sample 10, gather 20 (two gather_rows launches), loss
# 30, backward 40, optimizer 50, diag 6 + 4, writeback 7, end, then a
# publication's copy
STEP = [("noise", 0.0, 5.0, 0),
        mark("sample", 10.0), ("descent", 11.0, 21.0, 0),
        mark("gather", 30.0),
        ("void gather_rows_bulk<long>(...)", 31.0, 41.0, 0),
        ("void gather_rows_bulk<long>(...)", 41.0, 51.0, 0),
        mark("loss", 60.0), ("fprop", 61.0, 91.0, 0),
        mark("backward", 100.0), ("bprop", 101.0, 141.0, 0),
        mark("optimizer", 150.0), ("adam", 151.0, 201.0, 0),
        mark("diag", 210.0), ("norms", 211.0, 217.0, 0),
        mark("diag", 220.0), ("health", 221.0, 225.0, 0),
        mark("writeback", 230.0), ("scatter", 231.0, 238.0, 0),
        mark("end", 240.0),
        ("Memcpy DtoH", 250.0, 262.0, 0)]


def test_each_op_goes_to_the_last_marker_before_it():
    t = stage_seconds(DeviceTrace(ops=list(reversed(STEP))), 0)
    want = {"sample": 10, "gather": 20, "loss": 30, "backward": 40,
            "optimizer": 50, "diag": 10, "writeback": 7,
            "untagged": 5 + 12, "marks": 9}
    assert t == pytest.approx({k: v / 1e6 for k, v in want.items()})


@pytest.mark.parametrize("seed", range(3))
def test_the_parts_add_up_to_the_summed_op_time(seed):
    rng = random.Random(seed)
    names = ["k1", "k2", "Memset", *(f"apex_stage_{s}" for s in (
        "sample", "gather", "loss", "backward", "exchange", "optimizer",
        "diag", "writeback", "end"))]
    ops = []
    for _ in range(500):
        s = rng.uniform(0, 1e5)
        ops.append((rng.choice(names), s, s + rng.uniform(0.5, 50.0),
                    rng.choice((0, 1))))
    for dev in (0, 1):
        total = sum(e - s for _, s, e, d in ops if d == dev) / 1e6
        assert sum(stage_seconds(DeviceTrace(ops=ops), dev).values()) == \
            pytest.approx(total, rel=1e-12)


def test_readers_divide_by_macro_steps_and_sum_cards():
    card1 = [(n, s, e, 1) for n, s, e, _ in STEP]
    for steps in (1, 4):
        c = ctx(STEP + card1, macro_steps=steps, devices=(0, 1))
        got = {m: read(m, c) for m in STAGE_METRICS}
        want = {"sample_ms": 10, "gather_ms": 20, "loss_ms": 30,
                "backward_ms": 40, "optimizer_ms": 50, "diag_ms": 10,
                "writeback_ms": 7}
        assert got == pytest.approx(
            {k: 2 * v / 1e3 / steps for k, v in want.items()})


def test_the_gather_stage_holds_every_gather_launch():
    t = stage_seconds(DeviceTrace(ops=STEP), 0)
    gathers = sum(e - s for n, s, e, _ in STEP if "gather_rows_" in n)
    assert t["gather"] >= gathers / 1e6


@pytest.mark.parametrize("name", STAGE_METRICS)
def test_no_marker_gives_none(name):
    plain = [op for op in STEP if not op[0].startswith("apex_stage_")]
    assert read(name, ctx(plain)) is None
    assert read(name, ctx([])) is None
    assert read(name, ctx(STEP, macro_steps=0)) is None
    trace_less = ctx(STEP)
    trace_less.trace = None
    assert read(name, trace_less) is None
