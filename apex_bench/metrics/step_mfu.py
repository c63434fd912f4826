"""The whole learner step's share of the cards' peak: the model FLOPs
of a grad-step (``apex_bench/costs/<config>.py``) times the window's
grad-steps per second, over the data-sheet dense bf16 peak
(``apex_bench/costs/peaks.json``) times the cards the cell uses, in
percent."""

from __future__ import annotations


def read(ctx) -> float | None:
    rate = ctx.e2e.get("grad_steps_per_s")
    count = getattr(ctx.costs, "flops_per_grad_step", None)
    if not rate or count is None:
        return None
    return 100.0 * count(ctx.conf) * rate / (
        ctx.peaks["bf16_flops_per_s"] * len(ctx.device_indices))
