"""The frozen FLOP counts of apex_bench/costs/ against
torch.utils.flop_counter.FlopCounterMode over the plain reference's
loss and gradient at a small batch (the same convolutions and matrix
products, at the configurations' own widths)."""

from __future__ import annotations

import copy
import importlib

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from apex_bench import harness, inputs
from apex_bench.reference import dqn, r2d2

CPU = torch.device("cpu")


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("cell", ["pong-learn", "atari57-learn-4card"])
def test_dqn_count_matches_the_flop_counter(cell):
    traffic, conf = copy.deepcopy(harness.cell_files(cell))
    conf["learner"]["batch_size"] = batch = 3
    costs = importlib.import_module(f"apex_bench.costs.{conf['name']}")
    net = conf["network"]
    spec = dqn.leaves(net, conf["env"]["obs_shape"],
                      conf["env"]["num_actions"])
    params = {n: v.requires_grad_(True) for n, v in
              inputs.make_weights(spec, 1, CPU, 0.01).items()}
    target = {n: v.detach() for n, v in params.items()}
    obs = torch.randint(0, 256, (batch, *conf["env"]["obs_shape"]),
                        dtype=torch.uint8)
    batch_ = {"obs": obs, "next_obs": obs.flip(0),
              "action": torch.zeros(batch, dtype=torch.int32),
              "reward": torch.ones(batch), "discount": torch.ones(batch)}

    def step():
        loss, _ = dqn.dqn_loss(params, target, batch_, torch.ones(batch),
                               conf, lambda x: x)
        torch.autograd.grad(loss, list(params.values()))

    assert _counted(step) == costs.flops_per_grad_step(conf)


def test_r2d2_count_matches_the_flop_counter():
    traffic, conf = copy.deepcopy(harness.cell_files("r2d2-learn"))
    conf["learner"]["batch_size"] = n = 2
    conf["replay"].update(seq_length=12, burn_in=5)
    costs = importlib.import_module("apex_bench.costs.r2d2")
    length = conf["replay"]["seq_length"]
    stack = conf["env"]["obs_shape"][2]
    params = {k: v.requires_grad_(True) for k, v in inputs.make_weights(
        r2d2.leaves(conf), 1, CPU, 0.01).items()}
    target = {k: v.detach() for k, v in params.items()}
    hid = conf["network"]["lstm_size"]
    batch = {"seq_frames": torch.randint(
        0, 256, (n, length + stack - 1, 84, 84), dtype=torch.uint8),
        "actions": torch.zeros((n, length), dtype=torch.int32),
        "rewards": torch.zeros((n, length)),
        "terminals": torch.zeros((n, length)),
        "mask": torch.ones((n, length)),
        "init_c": torch.zeros((n, hid)), "init_h": torch.zeros((n, hid))}

    def step():
        loss, _ = r2d2.r2d2_loss(params, target, batch, torch.ones(n), conf,
                                 lambda x: x)
        torch.autograd.grad(loss, list(params.values()))

    assert _counted(step) == costs.flops_per_grad_step(conf)


def test_gather_bytes_are_the_kernel_tables_bound():
    """pong's launch is the frame_ring site of PERF.md's kernel table:
    2 M row + 8 M bytes over 3.35 TB/s = 0.03508 ms."""
    _, conf = harness.cell_files("pong-learn")
    costs = importlib.import_module("apex_bench.costs.pong")
    b = costs.gather_bytes(conf)
    assert len(b) == 2
    assert round(b[0] / 3.35e12 * 1e3, 5) == 0.03508
