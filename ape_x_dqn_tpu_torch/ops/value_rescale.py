"""R2D2 value-function rescaling (Kapturowski et al. 2019).

h(x) = sign(x) * (sqrt(|x| + 1) - 1) + eps * x
"""

from __future__ import annotations

import torch

EPS = 1e-3


def h(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    return torch.sign(x) * (torch.sqrt(torch.abs(x) + 1.0) - 1.0) + eps * x


def h_inv(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Exact closed-form inverse of h."""
    return torch.sign(x) * (
        ((torch.sqrt(1.0 + 4.0 * eps * (torch.abs(x) + 1.0 + eps)) - 1.0)
         / (2.0 * eps)) ** 2 - 1.0)
