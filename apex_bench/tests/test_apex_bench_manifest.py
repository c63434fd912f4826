"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == KEYS
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    assert len(BENCH["command"]) <= 32
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")


def test_names_and_units():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for e in entries:
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]


def test_entries_have_only_the_contract_keys():
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer",
                      "moves", "workloads"},
    }
    for kind, keys in allowed.items():
        for e in BENCH[kind]:
            assert set(e) <= keys, (kind, set(e) - keys)


def test_bounds_and_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(cell):
    from apex_bench import harness

    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    assert w["chips"] in (1, 4)
    traffic, conf = harness.cell_files(cell)
    assert traffic["config"] == w["config"] == conf["name"]
    assert w["traffic"] == cell
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert (ROOT / cfg["file"]).is_file()
    assert cfg["reduced"] == conf["reduced"]
    adaptor = importlib.import_module(
        f"apex_bench.adaptors.{conf['adaptor']}")
    reference = importlib.import_module(
        f"apex_bench.reference.{adaptor.REFERENCE}")
    costs = importlib.import_module(f"apex_bench.costs.{conf['name']}")
    assert costs.flops_per_grad_step(conf) > 0
    assert all(b > 0 for b in costs.gather_bytes(conf))
    # the cell holds numbers its reference's check reads, with finite
    # limits
    assert traffic["limits"] and set(traffic["limits"]) <= set(
        reference.NAMES)
    assert all(0 < v < 1 for v in traffic["limits"].values())
    # each cell reports setup_s, another end-to-end metric and a
    # per-layer one
    from apex_bench.harness import metrics_of
    e2e = [m["name"] for m in metrics_of(BENCH, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = metrics_of(BENCH, cell, "per_layer")
    assert per_layer and all(m["moves"] in e2e for m in per_layer)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_its_reader(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    reader = importlib.import_module(f"apex_bench.metrics.{metric}")
    assert callable(reader.read)
    for cell in m.get("workloads", []):
        assert cell in {w["name"] for w in BENCH["workloads"]}


def test_every_cell_and_config_is_used_once():
    used = [w["config"] for w in BENCH["workloads"]]
    assert {c["name"] for c in BENCH["configs"]} == set(used)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
