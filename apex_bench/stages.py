"""Device time by stage of the learner's step, from the stage markers
the program launches inside its captured step bodies.

A marker is an empty kernel named ``apex_stage_<stage>`` (the prefix is
all this module knows of the program). It opens its stage on its card,
and the stage runs until the next marker there; ``end`` closes the body,
so what runs after it (the next draw's noise, a publication's copies)
and before a card's first marker counts as ``untagged``. The markers'
own time is ``marks``. So the stages, ``untagged`` and ``marks`` add up
to the card's summed operation time in the traced stretch.
"""

from __future__ import annotations

import collections

PREFIX = "apex_stage_"


def stage_seconds(trace, device_index: int) -> dict[str, float]:
    """{stage: device seconds} of card `device_index` in `trace` (an
    ``apex_bench.trace.DeviceTrace``), its operations walked in start
    order; with ``untagged`` and ``marks``. Empty when the card ran no
    marker."""
    ops = sorted((s, e, name) for name, s, e, d in trace.ops
                 if d == device_index)
    if not any(name.startswith(PREFIX) for _, _, name in ops):
        return {}
    total = collections.defaultdict(float)
    stage = "untagged"
    for s, e, name in ops:
        if name.startswith(PREFIX):
            total["marks"] += (e - s) / 1e6
            stage = name[len(PREFIX):]
            if stage == "end":
                stage = "untagged"
        else:
            total[stage] += (e - s) / 1e6
    return dict(total)


def read_stage_ms(ctx, stage: str) -> float | None:
    """Device milliseconds of `stage` per macro-step: its time summed
    over the cell's cards, over the traced stretch's macro-steps. None
    when the trace holds no marker (the CPU, a program without them) or
    no such stage."""
    trace = ctx.trace
    steps = trace.counts.get("macro_steps") if trace is not None else None
    if not steps:
        return None
    per_card = [stage_seconds(trace, d) for d in ctx.device_indices]
    if not any(stage in t for t in per_card):
        return None
    return sum(t.get(stage, 0.0) for t in per_card) * 1e3 / steps
