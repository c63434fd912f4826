"""Counts of the ``r2d2`` configuration (``configs/r2d2.json``)."""

from __future__ import annotations

from apex_bench.costs.nets import dueling_head_macs, torso_macs


def flops_per_grad_step(conf: dict) -> float:
    """One R2D2 grad-step over `batch` sequences of L steps with burn-in
    B: per step the torso, the LSTM's input and recurrent products and
    the head. The online net runs forward over the B burn-in steps and
    with its gradient over the L - B trained steps (3 forwards less the
    first conv's input gradient, and less the recurrent product's input
    gradient at the first trained step, whose state comes from the
    burn-in without gradient); the target net runs forward over all L
    steps."""
    net, r = conf["network"], conf["replay"]
    torso, first = torso_macs(net, conf["env"]["obs_shape"])
    hid = net["lstm_size"]
    f = (torso + 4 * hid * (net["torso_dense"] + hid)
         + dueling_head_macs(hid, conf["env"]["num_actions"]))
    length, burn = r["seq_length"], r["burn_in"]
    trained = length - burn
    macs = (burn * f + trained * (3 * f - first) - 4 * hid * hid
            + length * f)
    return 2.0 * conf["learner"]["batch_size"] * macs


def gather_bytes(conf: dict) -> list[float]:
    """One launch a draw: the K * batch drawn sequences (over all
    shards), each one packed row of pad128((L + stack - 1) h w) bytes,
    read once and written once, with an 8-byte index per row."""
    h, w, stack = conf["env"]["obs_shape"]
    r = conf["replay"]
    row = -(-(r["seq_length"] + stack - 1) * h * w // 128) * 128
    m = conf["learner"]["sample_chunk"] * conf["learner"]["batch_size"]
    return [2.0 * m * row + 8.0 * m]
