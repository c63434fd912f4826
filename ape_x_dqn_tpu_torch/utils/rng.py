"""Deterministic RNG threading.

Every component (actor i, learner, replay, eval) derives its generator
from the run seed by folding in a stable component tag, so runs are
reproducible regardless of process/thread scheduling — the same seeding
discipline as the JAX package's ``component_key``. The bits differ from
JAX's threefry; tests that compare the two packages feed both the same
numpy-made noise instead.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch


def component_seed(seed: int, component: str, index: int = 0) -> int:
    """Stable 63-bit seed for (run seed, component tag, index)."""
    tag = zlib.crc32(component.encode()) & 0x7FFFFFFF
    ss = np.random.SeedSequence([int(seed), tag, int(index)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def component_generator(seed: int, component: str, index: int = 0,
                        device: str | torch.device = "cpu"
                        ) -> torch.Generator:
    """A ``torch.Generator`` on `device` seeded per component."""
    g = torch.Generator(device=device)
    g.manual_seed(component_seed(seed, component, index))
    return g
