"""Parameter sharding rules (tensor parallelism for dense layers).

Counterpart of ``ape_x_dqn_tpu/parallel/sharding.py``. The Nature-CNN's
FLOPs concentrate in the flatten->512 dense layer (3136x512) and the
LSTM kernels; those split over the "tp" mesh axis (column-parallel:
output features split), conv kernels and small heads replicate.

A spec is data here: one axis name (or None) per dimension of the
parameter as the original's flax tree holds it, () for a replicated
parameter, keyed by the flax path that models/convert.py maps from
("torso/torso_out/kernel"). On a row whose tp devices are one card,
the layers stay whole: a column split changes no number (the
original's GSPMD inserts the gathers). On a row whose tp devices are
distinct cards, `shard_params` gives each card its pieces and
parallel/tensor_parallel.py computes the split layers from them;
`unshard_params` makes the whole params again (checkpoints,
publication, `from_flax`).
"""

from __future__ import annotations

import torch
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


# -- the port's pieces --------------------------------------------------------
#
# The port's modules keep a dense layer as torch's [out, in] weight and
# the LSTM's four gates concatenated ([4H, F] and [4H, H] weights, a
# [4H] bias; models/lstm_q.py). The original's column split of a flax
# [in, out] kernel (spec (None, "tp")) and of its bias ("tp",) is then a
# split of dim 0: in tp contiguous blocks for a dense layer ("rows"),
# and for the LSTM in four strided blocks per device, one per gate
# ("gates"), since device t holds hidden units [t*H/tp, (t+1)*H/tp) of
# every gate. `torch_split` agrees with `param_pspec`
# (tests/test_torch_mesh_cards.py holds it against the original's
# `shard_params` on its emulated devices).

GATE_KEYS = ("weight_ih", "weight_hh", "bias_hh")


def torch_split(key: str, shape: tuple[int, ...], tp: int,
                min_dim: int = 256) -> str | None:
    """How the state_dict entry `key` of torch shape `shape` splits over
    tp devices: "rows", "gates" or None (replicated); `param_pspec`'s
    rule in the port's layout."""
    if tp <= 1:
        return None
    if key.startswith("lstm.") and key.rsplit(".", 1)[-1] in GATE_KEYS:
        hidden = shape[0] // 4
        return "gates" if hidden % tp == 0 and hidden >= min_dim else None
    if len(shape) in (1, 2) and shape[0] % tp == 0 and shape[0] >= min_dim:
        return "rows"
    return None


def piece(x: torch.Tensor, kind: str, t: int, tp: int) -> torch.Tensor:
    """Device t's piece of `x` split by `kind` (a view for "rows")."""
    if kind == "rows":
        return x.chunk(tp, dim=0)[t]
    h = x.shape[0] // 4
    w = h // tp
    return torch.cat([x[g * h + t * w:g * h + (t + 1) * w]
                      for g in range(4)])


def join(pieces: list[torch.Tensor], kind: str) -> torch.Tensor:
    """The inverse of `piece` over t = 0 .. tp-1, on pieces[0]'s
    device."""
    dev = pieces[0].device
    pieces = [p.to(dev) for p in pieces]
    if kind == "rows":
        return torch.cat(pieces, dim=0)
    w = pieces[0].shape[0] // 4
    return torch.cat([p[g * w:(g + 1) * w] for g in range(4)
                      for p in pieces])


def shard_params(params: dict[str, torch.Tensor], devices: list,
                 min_dim: int = 256) -> dict[torch.device, dict]:
    """The counterpart of the original's `shard_params` for one row's
    tp `devices`: {device: {key: its piece, on it}}. A split entry
    gives every device its piece; a replicated one stays whole, on the
    row's owner (devices[0]) only, as the replay shard does
    (parallel/mesh.py)."""
    devices = [torch.device(d) for d in devices]
    tp = len(devices)
    out: dict[torch.device, dict] = {d: {} for d in devices}
    for key, v in params.items():
        kind = torch_split(key, tuple(v.shape), tp, min_dim)
        if kind is None:
            out[devices[0]][key] = v.to(devices[0])
            continue
        for t, dev in enumerate(devices):
            out[dev][key] = piece(v, kind, t, tp).to(dev)
    return out


def unshard_params(pieces: dict[torch.device, dict]
                   ) -> dict[str, torch.Tensor]:
    """The inverse of `shard_params`: whole params in the flax-shaped
    layout `from_flax` gives (for checkpoints and publication), on the
    owner (the first device)."""
    devices = list(pieces)
    owner = pieces[devices[0]]
    out = {}
    for key, v in owner.items():
        if not any(key in pieces[d] for d in devices[1:]):
            out[key] = v
            continue
        kind = "gates" if (key.startswith("lstm.") and key.rsplit(
            ".", 1)[-1] in GATE_KEYS) else "rows"
        out[key] = join([pieces[d][key] for d in devices], kind)
    return out
