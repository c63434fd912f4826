"""FLOP counts of the nets the configurations run (the convention is in
``__init__.py``)."""

from __future__ import annotations


def _conv_side(side: int, kernels, strides) -> list[int]:
    out = []
    for k, s in zip(kernels, strides):
        side = (side - k) // s + 1
        out.append(side)
    return out


def torso_macs(net: dict, obs_shape) -> tuple[int, int]:
    """-> (MACs of one frame stack through the Nature-CNN torso, MACs of
    its first conv)."""
    h, _, stack = obs_shape
    sides = _conv_side(h, net["cnn_kernels"], net["cnn_strides"])
    macs, c_in, first = 0, stack, None
    for side, c, k in zip(sides, net["cnn_channels"], net["cnn_kernels"]):
        m = side * side * c * k * k * c_in
        first = m if first is None else first
        macs += m
        c_in = c
    macs += sides[-1] * sides[-1] * c_in * net["torso_dense"]
    return macs, first


def dueling_head_macs(width: int, num_actions: int) -> int:
    return width * (num_actions + 1)


def dqn_step_flops(net: dict, obs_shape, num_actions: int,
                   batch: int) -> float:
    """One double-DQN grad-step: the online net with its gradient over
    obs (3 forwards less the first conv's input gradient), the online and
    the target net over next_obs (a forward each)."""
    torso, first = torso_macs(net, obs_shape)
    f = torso + dueling_head_macs(net["torso_dense"], num_actions)
    return 2.0 * batch * (5 * f - first)
