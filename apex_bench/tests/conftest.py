"""Fixtures of the benchmark's own tests: each cell's files cut to a
size a CPU test holds (the widths stay, unless a test says otherwise)
and the card check for tests marked ``cuda``.

Run them from the repository's root:

    python -m pytest apex_bench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import copy

import pytest
import torch

from apex_bench import harness


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA CUDA card (skips without one)")


def tiny(cell: str) -> tuple[dict, dict]:
    """(workload file, configuration file) of `cell` at a CPU test's
    size: a small replay and batch, short sequences and a narrow LSTM."""
    traffic, conf = copy.deepcopy(harness.cell_files(cell))
    if conf["adaptor"] in ("dqn_ring", "dqn_cards"):
        conf["replay"]["capacity"] = 4096 * conf.get(
            "parallel", {}).get("dp", 1)
        conf["learner"]["batch_size"] = 32
        traffic["block_segments"] = 64
    else:
        conf["replay"].update(capacity=256, seq_length=16, burn_in=8)
        conf["learner"]["batch_size"] = 8
        conf["network"]["lstm_size"] = 32
        traffic["block_sequences"] = 16
    return traffic, conf


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)
