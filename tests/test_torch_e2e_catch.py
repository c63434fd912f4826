"""The catch learning bars for the port: the JAX package's three variants
of tests/test_e2e_catch.py (the plain per-step learner, the K-batch
relaxation with sample_chunk=4, and K=4 with the double-buffered
sample_prefetch), each with the same config, 20,000 frames,
train_every=4 and last20 >= 4.0, through the port's
train_single_process. The dueling Nature-CNN learns from 84x84x4 uint8
pixels of the synthetic catch game, stored as packed byte rows in flat
prioritized replay.

Each variant runs on the CPU (marked slow, as the JAX ones are) and on
the card (marked cuda). The file imports only the port, so on a machine
with the card and without JAX the card cases run with

    python -m pytest --noconftest -m cuda -s tests/test_torch_e2e_catch.py
"""

import dataclasses
import json

import pytest
import torch

from ape_x_dqn_tpu_torch.configs import (EnvConfig, LearnerConfig,
                                         NetworkConfig, ReplayConfig,
                                         get_config)
from ape_x_dqn_tpu_torch.runtime.single_process import train_single_process


def _catch_cfg(total_frames=20_000):
    return get_config("pong").replace(
        env=EnvConfig(id="catch", kind="synthetic_atari"),
        network=NetworkConfig(kind="nature_cnn", dueling=True,
                              compute_dtype="float32"),
        replay=ReplayConfig(kind="prioritized", capacity=32_768,
                            min_fill=1000),
        learner=LearnerConfig(batch_size=32, n_step=3, lr=2.5e-4,
                              target_sync_every=250),
        total_env_frames=total_frames,
    )


VARIANTS = {
    "plain": {},
    "kbatch": {"sample_chunk": 4},
    "prefetch": {"sample_chunk": 4, "sample_prefetch": True},
}
CASES = [pytest.param(v, d, id=f"{v}-{d}",
                      marks=pytest.mark.slow if d == "cpu"
                      else pytest.mark.cuda)
         for v in VARIANTS for d in ("cpu", "cuda")]


@pytest.mark.parametrize("variant,device", CASES)
def test_cnn_learns_catch(variant, device):
    """From the random plateau (~ -4.2 per 5-ball episode) the CNN agent
    must reach a clearly positive catch rate; the K-batch and prefetch
    relaxations must clear the same bar with the same frame budget and
    steps-per-frame ratio."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the card cases run the row-gather "
                    "kernel, which has no CPU mode")
    cfg = _catch_cfg()
    cfg = cfg.replace(learner=dataclasses.replace(cfg.learner,
                                                  **VARIANTS[variant]))
    out = train_single_process(cfg, train_every=4, solve_return=4.0,
                               device=device)
    print(json.dumps({"catch": variant, "device": device, **out}))
    assert out["episodes"] > 10
    assert out["last20_return"] >= 4.0, out
