"""The command line: without a card it fails and prints no result; in a
checkout that holds only BENCHMARK.json and apex_bench/ it fails too."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "pong-learn", "--seed", "3000000001",
        "--seconds", "1", "--trace", "0"]


def _run(cwd: Path, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "apex_bench.run", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_fails_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    assert out.returncode == 2, out.stderr
    assert out.stdout.strip() == ""
    assert "no card" in out.stderr


def test_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "apex_bench", tmp_path / "apex_bench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    out = _run(tmp_path, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_one_short_run_on_the_card(cuda_device):
    out = _run(ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    import json
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
