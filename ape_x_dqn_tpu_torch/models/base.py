"""Model-layer helpers.

Networks are ``nn.Module``s with float32 parameters. The compute dtype
of the forward/backward pass is bfloat16 by default
(NetworkConfig.compute_dtype): each layer casts its input and its
weights to that dtype, as flax's ``dtype=`` does, and the Q values come
back in float32 for the loss.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def preprocess_obs(obs: torch.Tensor, compute_dtype: torch.dtype
                   ) -> torch.Tensor:
    """uint8 image obs -> scaled float in compute dtype; float obs -> cast.

    Scaling to [0,1] happens on the device so replay stores uint8. The
    divisor is made by a fill on the device, not copied from the host,
    so a captured CUDA graph can replay this.
    """
    if obs.dtype == torch.uint8:
        return obs.to(compute_dtype) / torch.full(
            (), 255.0, dtype=compute_dtype, device=obs.device)
    return obs.to(compute_dtype)


def _lecun_normal(shape, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """A normal truncated at two standard deviations, with variance
    1/fan_in (flax's variance_scaling)."""
    # std of a unit normal truncated to [-2, 2]
    trunc_std = 0.87962566103423978
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w * (math.sqrt(1.0 / fan_in) / trunc_std)


def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's default initialisation, drawn from `generator`: LeCun
    normal weights and zero biases; an LSTM's recurrent kernels are
    orthogonal per gate, as flax's ``OptimizedLSTMCell`` draws them. In
    place; returns `module`."""
    from ape_x_dqn_tpu_torch.models.lstm_q import LSTMCell

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.weight.copy_(_lecun_normal(m.weight.shape,
                                             m.weight[0].numel(), generator))
                m.bias.zero_()
            elif isinstance(m, LSTMCell):
                m.weight_ih.copy_(_lecun_normal(
                    m.weight_ih.shape, m.weight_ih.shape[1], generator))
                for gate in m.weight_hh.view(4, m.hidden, m.hidden):
                    w = torch.empty(m.hidden, m.hidden)
                    gate.copy_(nn.init.orthogonal_(w, generator=generator))
                m.bias_hh.zero_()
    return module


def hard_update(target: nn.Module, online: nn.Module,
                where: torch.Tensor | None = None) -> nn.Module:
    """Target-network hard sync (every K learner steps). In place on
    `target`'s parameters; returns `target`. `where`, a 0-dim bool
    tensor, makes it a masked copy that keeps the target unless it is
    true: the decision stays on the device, so a captured CUDA graph
    can replay it."""
    with torch.no_grad():
        for t, p in zip(target.parameters(), online.parameters()):
            t.copy_(p if where is None else torch.where(where, p, t))
    return target


def soft_update(target: nn.Module, online: nn.Module,
                tau: float) -> nn.Module:
    """Polyak averaging for the DPG target nets, t <- t + tau (p - t),
    in place on `target`'s parameters (``lerp_``; the original computes
    (1 - tau) t + tau p, the same up to float32 rounding); returns
    `target`."""
    with torch.no_grad():
        for t, p in zip(target.parameters(), online.parameters()):
            t.lerp_(p, tau)
    return target


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
