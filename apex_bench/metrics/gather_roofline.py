"""The frame-gather kernel's share of its roofline: the least time the
card needs for a macro-step's gather launches (each reads and writes its
M rows once and reads M 8-byte indices, 2 M row + 8 M bytes over the
peak bandwidth; ``apex_bench/costs/``) over the kernel's device time per
macro-step in the traced stretch (kernels named ``gather_rows_*``), in
percent."""

from __future__ import annotations


def read(ctx) -> float | None:
    trace = ctx.trace
    count = getattr(ctx.costs, "gather_bytes", None)
    if trace is None or count is None:
        return None
    steps = trace.counts.get("macro_steps")
    dev_s = sum(e - s for name, s, e, _ in trace.ops
                if "gather_rows_" in name) / 1e6
    if not steps or dev_s <= 0:
        return None
    bound_s = sum(count(ctx.conf)) / ctx.peaks["hbm_bytes_per_s"] * steps
    return 100.0 * bound_s / dev_s
