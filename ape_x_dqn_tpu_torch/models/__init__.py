"""Network factory + model helpers."""

import math

from ape_x_dqn_tpu_torch.models.base import (
    hard_update, init_params, param_count, preprocess_obs, soft_update)
from ape_x_dqn_tpu_torch.models.dpg import DPGActor, DPGCritic
from ape_x_dqn_tpu_torch.models.lstm_q import ApeXLSTMQNet, LSTMState
from ape_x_dqn_tpu_torch.models.qnets import DuelingHead, MLPQNet, NatureDQN

__all__ = ["ApeXLSTMQNet", "DPGActor", "DPGCritic", "DuelingHead",
           "LSTMState", "MLPQNet", "NatureDQN", "build_network",
           "hard_update", "init_params", "param_count", "preprocess_obs",
           "soft_update"]


def build_network(net_cfg, spec):
    """Build the module matching a NetworkConfig for an EnvSpec; for
    kind ``dpg`` the pair (actor, critic), as the original returns.
    Parameters are float32 on the CPU with torch's default init: move
    the module and draw seeded weights with ``init_params`` or load
    converted ones."""
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
    if net_cfg.kind == "dpg":
        obs_dim = math.prod(spec.obs_shape)
        actor = DPGActor(obs_dim, spec.action_dim,
                         action_low=spec.action_low,
                         action_high=spec.action_high,
                         hidden=tuple(net_cfg.dpg_hidden),
                         compute_dtype=net_cfg.compute_dtype)
        critic = DPGCritic(obs_dim, spec.action_dim,
                           hidden=tuple(net_cfg.dpg_hidden),
                           compute_dtype=net_cfg.compute_dtype)
        return actor, critic
    raise ValueError(f"unknown network kind {net_cfg.kind!r}")
