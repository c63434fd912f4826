"""The port's batch-size / MFU study (ape_x_dqn_tpu_torch/utils/
batch_study.py) against the original's (ape_x_dqn_tpu/utils/
batch_study.py): the analytic FLOPs per step at batch 512, 1024 and 2048
equal the original bench's count (root bench.py, which the port does not
import), the A-B-C-C-B-A order is kept, the default peak is the card's
own (an H100's dense bf16 989.4 TFLOP/s, not the original's TPU v5e
197), and a CPU run at capacity 4,096, batches 32 and 64, one dispatch
of 2 steps prints four JSON lines with the original's keys and the
summary table."""

import json

import pytest
import torch

from ape_x_dqn_tpu_torch.obs import profiling
from ape_x_dqn_tpu_torch.utils import batch_study

KEYS = {"batch_size", "grad_steps_per_s", "spread", "samples_per_s",
        "achieved_tflops", "mfu", "order_pos"}


@pytest.mark.parametrize("batch", [512, 1024, 2048])
def test_flops_per_step_equal_the_original_bench(batch):
    from bench import train_step_flops_analytic

    assert profiling.train_step_flops_analytic(batch) \
        == train_step_flops_analytic(batch)


def test_the_order_is_a_b_c_c_b_a():
    assert batch_study.interleaved([512, 1024, 2048]) == [
        512, 1024, 2048, 2048, 1024, 512]


def test_the_default_peak_is_the_cards_own(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert profiling.device_peaks(torch.device("cuda", 0))[0] == 989.4e12
    # a CPU device reads the host proxy, with or without a card
    assert profiling.device_peaks(torch.device("cpu"))[0] \
        < 989.4e12


def test_a_cpu_run_prints_the_originals_lines(capsys):
    assert batch_study.main(["--device", "cpu", "--capacity", "4096",
                             "--batches", "32,64",
                             "--steps-per-dispatch", "2",
                             "--dispatches", "1"]) == 0
    out, err = capsys.readouterr()
    lines = [json.loads(x) for x in out.strip().splitlines()]
    assert len(lines) == 4
    assert [r["batch_size"] for r in lines] == [32, 64, 64, 32]
    assert [r["order_pos"] for r in lines] == [0, 1, 2, 3]
    for r in lines:
        assert set(r) == KEYS
        assert r["grad_steps_per_s"] > 0 and r["mfu"] > 0
        lo, hi = r["spread"]
        assert lo <= r["grad_steps_per_s"] <= hi
        # the rate is rounded to 0.1 step/s, the samples from the
        # unrounded one
        assert abs(r["samples_per_s"] - r["grad_steps_per_s"]
                   * r["batch_size"]) <= 0.05 * r["batch_size"] + 1
    assert "batch  steps/s(two runs)  samples/s  MFU" in err
    assert "[4/4] batch 32" in err
