"""Counts of the ``atari57_apex`` configuration
(``configs/atari57_apex.json``): the pong net's count at the full
18-action set, over the whole global batch."""

from __future__ import annotations

from apex_bench.costs.nets import dqn_step_flops


def flops_per_grad_step(conf: dict) -> float:
    return dqn_step_flops(conf["network"], conf["env"]["obs_shape"],
                          conf["env"]["num_actions"],
                          conf["learner"]["batch_size"])


def gather_bytes(conf: dict) -> list[float]:
    """Per macro-step, two launches (obs, next_obs) on each owner card,
    each over its shards' K * batch / dp draws per shard, stack frame
    rows of pad128(h * w) bytes each, read and written once, with an
    8-byte index per row. The mesh lays the dp rows over
    ``mesh.owners`` owner cards alike."""
    h, w, stack = conf["env"]["obs_shape"]
    lc, dp = conf["learner"], conf["parallel"]["dp"]
    owners = conf["mesh"]["owners"]
    row = -(-h * w // 128) * 128
    m = lc["sample_chunk"] * lc["batch_size"] // owners * stack
    return [2.0 * m * row + 8.0 * m] * (2 * owners)
