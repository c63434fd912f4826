"""Per-layer metric readers, one module per metric of BENCHMARK.json,
named as the metric; the manifest gives each its layer, unit and the
end-to-end metric it moves.

Each module has ``read(ctx) -> float | None``: the number from the run's
spans, end-to-end numbers, counts and device trace
(``apex_bench/harness.py: Context``), or None where the run has nothing
for it to read, and the harness then leaves the metric out of the line.
"""
