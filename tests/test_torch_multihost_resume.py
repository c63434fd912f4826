"""Checkpoint/resume over the port's lockstep loop, two gloo processes
on the CPU through the CLI (tests/test_multihost.py:285 with the
original's `_SETS` and budgets): run 1 trains 20 steps into a shared
checkpoint directory (a barrier, process 0 writes); run 2 restores on
construction (the min-agreement on the step) and continues the grad-step
counter to 30."""

import pytest

from tests.test_torch_multihost_cli import run_pair


def test_multihost_checkpoint_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    extra = ["--total-env-frames", "100000", "--checkpoint-dir", ckpt]
    outs = run_pair(extra + ["--max-grad-steps", "20"])
    assert outs[0]["grad_steps"] == outs[1]["grad_steps"] == 20
    assert outs[0]["restored_step"] is None  # run 1 started fresh
    crc = outs[0]["multihost"]["params_crc32"]

    outs = run_pair(extra + ["--max-grad-steps", "30"])
    # resumed at 20 (the marker proves the restore fired, not a silent
    # fresh 0 -> 30 run), trained on to 30, in lockstep
    assert outs[0]["restored_step"] == outs[1]["restored_step"] == 20
    assert outs[0]["grad_steps"] == outs[1]["grad_steps"] == 30
    assert outs[0]["loss"] == pytest.approx(outs[1]["loss"], rel=1e-5)
    assert outs[0]["multihost"]["params_crc32"] \
        == outs[1]["multihost"]["params_crc32"] != crc
