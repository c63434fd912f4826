"""Device milliseconds of the gradient exchange between the card groups
per macro-step: the NCCL kernels (names starting ``nccl``) on the first
owner card in the traced stretch, over its macro-steps."""

from __future__ import annotations


def read(ctx) -> float | None:
    trace = ctx.trace
    steps = trace.counts.get("macro_steps") if trace is not None else None
    if not steps:
        return None
    first = ctx.device_indices[0]
    us = sum(e - s for name, s, e, d in trace.ops
             if d == first and name.startswith("nccl"))
    if us <= 0:
        return None
    return us / 1e3 / steps
