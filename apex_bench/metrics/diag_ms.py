"""Device milliseconds per macro-step of the learner step's ``diag`` stage:
the step's metrics and learning diagnostics (global norms, TD
percentiles, replay health), computed whether or not observability reads
them. Read from the stage markers in the traced stretch, summed over the
cell's cards (``apex_bench/stages.py``)."""

from __future__ import annotations

from apex_bench.stages import read_stage_ms


def read(ctx) -> float | None:
    return read_stage_ms(ctx, "diag")
