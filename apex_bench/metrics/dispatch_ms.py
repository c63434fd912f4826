"""Host milliseconds of one ``train_many`` call in the measured window:
the benchmark's span around each dispatch, the mean over the window. It
is the host's launch cost of a dispatch's captured graphs (and, with two
dispatches in flight, nothing of the device's time)."""

from __future__ import annotations

import statistics


def read(ctx) -> float | None:
    spans = ctx.spans.get("dispatch")
    return statistics.fmean(spans) * 1e3 if spans else None
