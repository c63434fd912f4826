"""Small shared helpers."""

from __future__ import annotations

import torch


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << (n - 1).bit_length()


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on. Asking for CUDA on a machine
    without it raises: there is no silent fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but CUDA is not "
            f"available; pass device='cpu' to run the plain PyTorch path")
    return dev
