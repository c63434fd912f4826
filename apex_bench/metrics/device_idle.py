"""The share of the traced stretch in which no operation runs on a
card (the union of its kernels' and copies' intervals), the mean over
the cards the cell uses: every card is paid for. In percent."""

from __future__ import annotations

from apex_bench.trace import union_busy_us


def read(ctx) -> float | None:
    trace = ctx.trace
    if trace is None or trace.window_s <= 0 or not trace.ops:
        return None
    shares = []
    for dev in ctx.device_indices:
        busy, _ = union_busy_us([(s, e) for _, s, e, d in trace.ops
                                 if d == dev])
        shares.append(1.0 - busy / 1e6 / trace.window_s)
    return 100.0 * sum(shares) / len(shares)
