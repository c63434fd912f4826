"""The comparison that decides ``correct``, driven through the rest of
a run on the CPU at a test's size: the port's CPU path passes against
the plain reference; the control (the reference in fp8 put in the
program's place) fails; and every fault a training cell can have,
planted in the port underneath the harness, turns ``correct`` false."""

from __future__ import annotations

import importlib
import time
from pathlib import Path

import pytest
import torch

from apex_bench import faults, harness
from apex_bench.tests.conftest import tiny

ROOT = Path(__file__).resolve().parents[2]
CPU = [torch.device("cpu")]
# every workload file, also one the manifest does not list yet (its
# adaptor and reference stay held here)
CELLS = sorted(p.stem for p in (harness.ROOT / "workloads").glob("*.json"))
# cells over several cards run here over as many CPU devices (cpu:0 ..
# cpu:3 are distinct device objects, one memory: the per-card code runs)
CARD_CELLS = {c for c in CELLS
              if harness.load_json(harness.ROOT / "workloads"
                                   / f"{c}.json")["chips"] > 1}


def devices_for(cell: str) -> list:
    if cell in CARD_CELLS:
        return [torch.device("cpu", i) for i in range(4)]
    return CPU


def run_cpu(cell: str, seed: int, patch=None) -> dict:
    traffic, conf = tiny(cell)
    return harness.run(cell, seed, 0.5, False, time.time(), ROOT,
                       devices=devices_for(cell), traffic=traffic,
                       conf=conf, patch=patch)


def reference_of(conf: dict):
    adaptor = importlib.import_module(
        f"apex_bench.adaptors.{conf['adaptor']}")
    return importlib.import_module(
        f"apex_bench.reference.{adaptor.REFERENCE}")


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_passes_on_the_cpu(cell):
    res = run_cpu(cell, 2 ** 31 + 12345)
    assert res["correct"], res["checks"]
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_fp8_control_fails(cell):
    traffic, conf = tiny(cell)
    reference = reference_of(conf)
    for seed in (1, 2, 3):
        ref = reference.follow(conf, traffic, seed, CPU[0])
        ctrl = reference.follow(conf, traffic, seed, CPU[0],
                                precision="fp8")
        ok, shown = harness.verdict(
            reference.compare(reference.as_readings(ctrl), ref),
            traffic["limits"], reference.NAMES)
        assert not ok, shown


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in CELLS
    for fault in ("unchanged", "half_batch", "altered")
    + (("no_exchange",) if cell in CARD_CELLS else ())])
def test_a_broken_step_is_not_correct(cell, fault):
    res = run_cpu(cell, 77, patch=faults.FAULTS[fault])
    assert not res["correct"], res["checks"]
