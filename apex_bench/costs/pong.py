"""Counts of the ``pong`` configuration (``configs/pong.json``)."""

from __future__ import annotations

from apex_bench.costs.nets import dqn_step_flops


def flops_per_grad_step(conf: dict) -> float:
    return dqn_step_flops(conf["network"], conf["env"]["obs_shape"],
                          conf["env"]["num_actions"],
                          conf["learner"]["batch_size"])


def gather_bytes(conf: dict) -> list[float]:
    """Bytes each gather launch of a macro-step must move: the obs and
    the next_obs stacks of K * batch transitions, stack frame rows each
    of pad128(h * w) bytes, read once and written once, with an 8-byte
    index per row."""
    h, w, stack = conf["env"]["obs_shape"]
    row = -(-h * w // 128) * 128
    m = conf["learner"]["sample_chunk"] * conf["learner"]["batch_size"] \
        * stack
    return [2.0 * m * row + 8.0 * m] * 2
