"""The multi-host learner's host-side control reductions, for one process.

Counterpart of part of ``ape_x_dqn_tpu/parallel/multihost.py``. There,
every learner process owns contiguous dp rows of one global mesh and
each round's control scalars (ingest readiness, idleness, frame counts)
ride ONE packed collective, so every process branches on the same
values. The port runs one process: `process_rows` is every row, and
`global_stats` is the same packed reduction over the rows on the mesh's
device. Joining processes (`init_multihost`), the cross-process
reduction over NCCL and the multi-host driver wait for a machine with
more than one card (ROADMAP Queue A item 14).
"""

from __future__ import annotations

import numpy as np
import torch

from ape_x_dqn_tpu_torch.parallel.mesh import Mesh


def process_rows(mesh: Mesh) -> tuple[int, int]:
    """The dp rows [start, stop) this process owns: all of them."""
    return 0, mesh.dp


def global_stats(mesh: Mesh, ready: float, idle: float,
                 frames: float) -> tuple[bool, bool, float]:
    """One packed per-round reduction: (all_ready, all_idle,
    frames_total). Int32 lanes: the process's frame count rides as
    three base-2^16 limbs on ONE of its rows (zeros on the others, so
    limb sums scale with process count, not dp), exact to 2^48 and
    recombined in Python ints; the flags tile across its rows (min is
    idempotent over copies)."""
    v = int(frames)
    limbs = [(v >> 32) & 0xFFFF, (v >> 16) & 0xFFFF, v & 0xFFFF]
    start, stop = process_rows(mesh)
    block = np.zeros((stop - start, 5), np.int32)
    block[:, :2] = [int(ready), int(idle)]
    block[0, 2:] = limbs
    arr = torch.from_numpy(block).to(mesh.device)
    mins = arr.min(dim=0).values.cpu().numpy()
    sums = arr.sum(dim=0, dtype=torch.int64).cpu().numpy()
    l2, l1, l0 = (int(s) for s in sums[2:])
    total = float((l2 << 32) + (l1 << 16) + l0)
    return bool(mins[0] >= 1), bool(mins[1] >= 1), total
