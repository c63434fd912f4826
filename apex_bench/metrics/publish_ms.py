"""Host milliseconds of one parameter publication in the measured
window: the device copy of the params, their copy into pinned host
buffers and the wait for the stream (which drains the dispatches in
flight), as the benchmark's span around it; the mean per
publication."""

from __future__ import annotations

import statistics


def read(ctx) -> float | None:
    spans = ctx.spans.get("publish")
    return statistics.fmean(spans) * 1e3 if spans else None
