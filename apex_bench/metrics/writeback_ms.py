"""Device milliseconds per macro-step of the learner step's ``writeback``
stage: the priority write-back into the sum-tree. Read from the stage
markers in the traced stretch, summed over the cell's cards
(``apex_bench/stages.py``)."""

from __future__ import annotations

from apex_bench.stages import read_stage_ms


def read(ctx) -> float | None:
    return read_stage_ms(ctx, "writeback")
