"""Device milliseconds per macro-step of the learner step's ``optimizer``
stage: the clipped Adam update and the masked hard target sync. Read
from the stage markers in the traced stretch, summed over the cell's
cards (``apex_bench/stages.py``)."""

from __future__ import annotations

from apex_bench.stages import read_stage_ms


def read(ctx) -> float | None:
    return read_stage_ms(ctx, "optimizer")
