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

    Scaling to [0,1] happens on the device so replay stores uint8.
    """
    if obs.dtype == torch.uint8:
        return obs.to(compute_dtype) / torch.tensor(
            255.0, dtype=compute_dtype, device=obs.device)
    return obs.to(compute_dtype)


def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's default initialisation, drawn from `generator`: LeCun
    normal weights (a normal truncated at two standard deviations, with
    variance 1/fan_in) and zero biases. In place; returns `module`."""
    # std of a unit normal truncated to [-2, 2] (flax's variance_scaling)
    trunc_std = 0.87962566103423978
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / trunc_std
                w = torch.empty(m.weight.shape, dtype=m.weight.dtype)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                m.weight.copy_(w * std)
                m.bias.zero_()
    return module


def hard_update(target: nn.Module, online: nn.Module) -> nn.Module:
    """Target-network hard sync (every K learner steps). In place on
    `target`'s parameters; returns `target`."""
    with torch.no_grad():
        for t, p in zip(target.parameters(), online.parameters()):
            t.copy_(p)
    return target


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
