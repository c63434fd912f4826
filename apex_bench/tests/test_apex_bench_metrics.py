"""Each per-layer reader on a recorded synthetic trace: known kernel
intervals, spans and counts give known numbers; a trace with nothing to
read gives None (the metric is left out of the line)."""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import pytest

from apex_bench.harness import Context
from apex_bench.trace import DeviceTrace, union_busy_us

COSTS = SimpleNamespace(flops_per_grad_step=lambda conf: 44.5e9,
                        gather_bytes=lambda conf: [1.0e8, 1.0e8])
PEAKS = {"bf16_flops_per_s": 989.4e12, "hbm_bytes_per_s": 3.35e12}


def ctx(ops, window_s=0.010, macro_steps=2, spans=None, devices=(0,),
        e2e=None, costs=COSTS):
    trace = DeviceTrace(ops=ops, host=[], window_s=window_s,
                        counts={"macro_steps": macro_steps})
    return Context(spans=spans or {}, trace=trace,
                   e2e={"grad_steps_per_s": 300.0, "setup_s": 30.0}
                   if e2e is None else e2e,
                   conf={}, costs=costs, peaks=PEAKS,
                   device_indices=list(devices))


def read(name, c):
    return importlib.import_module(f"apex_bench.metrics.{name}").read(c)


OPS = [("void gather_rows_bulk<long>(...)", 0.0, 100.0, 0),
       ("sm80_xmma_fprop", 50.0, 2050.0, 0),       # overlaps the gather
       ("void gather_rows_bulk<long>(...)", 3000.0, 3100.0, 0),
       ("ncclDevKernel_AllGather_RING_LL", 4000.0, 4500.0, 0),
       ("ncclDevKernel_AllGather_RING_LL", 4000.0, 4600.0, 1),
       ("elementwise", 5000.0, 6000.0, 1)]


def test_union_and_gaps():
    busy, gaps = union_busy_us([(0, 10), (5, 20), (30, 40), (35, 36)])
    assert busy == 30 and gaps == [(20, 30)]


def test_device_idle_is_the_mean_over_cards():
    # card 0 busy 0..2050, 3000..3100, 4000..4500 = 2650 us of 10 ms;
    # card 1 busy 600 + 1000 = 1600 us
    v = read("device_idle", ctx(OPS, devices=(0, 1)))
    assert v == pytest.approx(100 * (1 - (0.265 + 0.16) / 2))


def test_gather_roofline():
    # 2 macro-steps x 2e8 bytes at 3.35 TB/s over 200 us of gather
    v = read("gather_roofline", ctx(OPS))
    assert v == pytest.approx(100 * 2 * 2e8 / 3.35e12 / 200e-6)


def test_exchange_ms_reads_the_first_card():
    assert read("exchange_ms", ctx(OPS, devices=(0, 1))) == \
        pytest.approx(0.5 / 2)


def test_step_mfu_and_spans():
    c = ctx(OPS, spans={"dispatch": [0.001, 0.003], "publish": [0.05]})
    assert read("step_mfu", c) == pytest.approx(
        100 * 44.5e9 * 300 / 989.4e12)
    assert read("dispatch_ms", c) == pytest.approx(2.0)
    assert read("publish_ms", c) == pytest.approx(50.0)


@pytest.mark.parametrize("name", ["device_idle", "gather_roofline",
                                  "exchange_ms", "dispatch_ms",
                                  "publish_ms"])
def test_nothing_to_read_gives_none(name):
    assert read(name, ctx([])) is None


@pytest.mark.parametrize("name", ["step_mfu", "gather_roofline"])
def test_a_cell_without_the_count_or_rate_gives_none(name):
    """A cell of another kind (no grad-step rate, no FLOP or byte
    count in its costs module) leaves these metrics out."""
    c = ctx(OPS, e2e={"setup_s": 30.0}, costs=SimpleNamespace())
    assert read(name, c) is None
