"""Network factory + model helpers."""

import math

from ape_x_dqn_tpu_torch.models.base import (
    hard_update, init_params, param_count, preprocess_obs)
from ape_x_dqn_tpu_torch.models.lstm_q import ApeXLSTMQNet, LSTMState
from ape_x_dqn_tpu_torch.models.qnets import DuelingHead, MLPQNet, NatureDQN

__all__ = ["ApeXLSTMQNet", "DuelingHead", "LSTMState", "MLPQNet",
           "NatureDQN", "build_network", "hard_update", "init_params",
           "param_count", "preprocess_obs"]


def build_network(net_cfg, spec):
    """Build the module matching a NetworkConfig for an EnvSpec (the
    ``mlp``, ``nature_cnn`` and ``lstm_q`` kinds; ``dpg`` waits for its
    slice). Parameters are float32 on the CPU with torch's default
    init: move the module and draw seeded weights with ``init_params``
    or load converted ones."""
    if net_cfg.kind == "mlp":
        return MLPQNet(in_features=math.prod(spec.obs_shape),
                       num_actions=spec.num_actions,
                       hidden=tuple(net_cfg.mlp_hidden),
                       dueling=net_cfg.dueling,
                       compute_dtype=net_cfg.compute_dtype)
    if net_cfg.kind == "nature_cnn":
        return NatureDQN(obs_shape=tuple(spec.obs_shape),
                         num_actions=spec.num_actions,
                         channels=tuple(net_cfg.cnn_channels),
                         kernels=tuple(net_cfg.cnn_kernels),
                         strides=tuple(net_cfg.cnn_strides),
                         dense=net_cfg.torso_dense,
                         dueling=net_cfg.dueling,
                         compute_dtype=net_cfg.compute_dtype)
    if net_cfg.kind == "lstm_q":
        return ApeXLSTMQNet(obs_shape=tuple(spec.obs_shape),
                            num_actions=spec.num_actions,
                            lstm_size=net_cfg.lstm_size,
                            dense=net_cfg.torso_dense,
                            dueling=net_cfg.dueling,
                            compute_dtype=net_cfg.compute_dtype,
                            mlp_torso=len(spec.obs_shape) == 1)
    raise ValueError(
        f"network kind {net_cfg.kind!r} is not ported to the PyTorch "
        f"package yet (ported: 'mlp', 'nature_cnn', 'lstm_q')")
