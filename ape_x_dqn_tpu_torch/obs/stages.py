"""Stage markers inside the learner's step bodies.

On the card every learner step is a captured CUDA graph
(runtime/step_graph.py): a host-side span inside it runs once, at
capture, and a device trace shows the step only as kernels by name.
`mark_stage(name, device)` launches an empty one-thread kernel named
``apex_stage_<name>`` (``csrc/stage_marks.cu``) on the current stream
of `device`. Inside a capture the launch is recorded like any kernel,
so every replay carries the marker and the host does nothing for it;
in a ``torch.profiler`` trace (``--profile-dir``, or the benchmark's
traced stretch) a stage is every operation on that card from its
marker to the next one. On the CPU it returns at once.

The vocabulary is fixed (`STAGES`): ``sample`` (the sum-tree descent,
the IS weights, the chunking), ``gather`` (the frame-gather launches),
``loss`` (the batch, the forward passes, R2D2's burn-in), ``backward``
(the gradients), ``exchange`` (packing, the collective and unpacking of
the gradient exchange), ``optimizer`` (clip, Adam, the target update),
``diag`` (the metrics and learning diagnostics), ``writeback`` (the
priority write-back) and ``end`` (after the body: what follows is no
stage). A marker touches no memory, so the work and its order are
unchanged.
"""

from __future__ import annotations

import torch

STAGES = ("sample", "gather", "loss", "backward", "optimizer", "diag",
          "writeback", "exchange", "end")
_INDEX = {name: i for i, name in enumerate(STAGES)}


def mark_stage(name: str, device: torch.device) -> None:
    """Open stage `name` (one of `STAGES`) on `device`."""
    _launch(_INDEX[name], device)


def _launch(stage: int, device: torch.device) -> None:
    """Launch marker number `stage` on `device`'s current stream (a
    CUDA device only)."""
    if device.type != "cuda":
        return
    from ape_x_dqn_tpu_torch.ops import frame_gather

    lib = frame_gather.library()
    with torch.cuda.device(device):
        rc = lib.stage_mark_launch(
            stage, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stage marker {STAGES[stage]!r} launch "
                           f"failed: CUDA error {rc}")
