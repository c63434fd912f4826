"""Parameter sharding rules (tensor parallelism for dense layers).

Counterpart of ``ape_x_dqn_tpu/parallel/sharding.py``. The Nature-CNN's
FLOPs concentrate in the flatten->512 dense layer (3136x512) and the
LSTM kernels; those split over the "tp" mesh axis (column-parallel:
output features split), conv kernels and small heads replicate.

A spec is data here: one axis name (or None) per dimension of the
parameter as the original's flax tree holds it, () for a replicated
parameter, keyed by the flax path that models/convert.py maps from
("torso/torso_out/kernel"). On a mesh whose tp devices are one card,
the layers stay whole: a column split changes no number (the
original's GSPMD inserts the gathers), so the learner computes on the
whole parameters and the specs say what a per-card placement would
split (the learner's `shard_stats`).
"""

from __future__ import annotations

from torch import nn

from ape_x_dqn_tpu_torch.models.convert import flax_shapes
from ape_x_dqn_tpu_torch.parallel.mesh import Mesh


def param_pspec(path: str, shape: tuple[int, ...], tp: int,
                min_dim: int = 256) -> tuple:
    """The spec of one parameter of flax shape `shape`: column-split a
    2D dense kernel whose output dim is large and divisible by tp, and
    its matching bias; replicate everything else."""
    if tp <= 1:
        return ()
    if len(shape) == 2 and shape[1] % tp == 0 and shape[1] >= min_dim:
        return (None, "tp")
    if len(shape) == 1 and shape[0] % tp == 0 and shape[0] >= min_dim:
        return ("tp",)
    return ()


def make_param_shardings(net: nn.Module, mesh: Mesh,
                         min_dim: int = 256) -> dict[str, tuple]:
    """{flax path: spec} for every parameter of `net`."""
    return {path: param_pspec(path, shape, mesh.tp, min_dim)
            for path, shape in flax_shapes(net).items()}
